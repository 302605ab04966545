"""The port's persistence and training utilities against the JAX
package's: the serde zip read both ways, ``FrozenLayer``, transfer
learning, early stopping, the step checkpointer, the line-search solvers
and the zoo's cache-first pretrained restore.

Networks are built from the JAX configuration's JSON and take the JAX
network's state through ``bridge``; inputs come from
``np.random.RandomState``. Every port call runs on the CPU.

Tolerances, each with its reason (those of ``tests/test_torch_graph.py``):
- f32 outputs and losses: the same ops summed in another order, atol
  1e-5 on O(1) values (``F32``);
- bf16 compute: both sides round activations to bf16 at other places;
  softmax outputs within 1e-2 (``BF16``);
- params and updater leaves read from a zip: bit-exact (the file holds
  the values);
- early-stopping scores: means of f32 losses over the same batches after
  the same Sgd steps, within rtol 1e-5 (``LOSS_RTOL``);
- a solver's losses after 10 iterations: the same full-batch f32 loss and
  gradient, with line searches that branch on comparisons of f32 values,
  within rtol 1e-4 (``SOLVER_RTOL``), one f32 ulp amplified by ten steps.
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.graph as JG
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn import earlystopping as jes
from deeplearning4j_tpu.nn import serde as jserde
from deeplearning4j_tpu.nn import solvers as jsolvers
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.transferlearning import (
    FineTuneConfiguration as JFTC, TransferLearning as JTL)

import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.iterators import \
    ListDataSetIterator as TListIt
from deeplearning4j_tpu_torch.nn import earlystopping as tes
from deeplearning4j_tpu_torch.nn import serde as tserde
from deeplearning4j_tpu_torch.nn import solvers as tsolvers
from deeplearning4j_tpu_torch.nn.checkpoint import (ShardedCheckpointer,
                                                    ShardedCheckpointListener)
from deeplearning4j_tpu_torch.nn.conf.config import \
    MultiLayerConfiguration as TMLC
from deeplearning4j_tpu_torch.nn.listeners import CheckpointListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration as TFTC, TransferLearning as TTL)
from deeplearning4j_tpu_torch.zoo import base as tzoo_base
from deeplearning4j_tpu_torch.zoo import LeNet as TLeNet

F32 = 1e-5
BF16 = 1e-2
LOSS_RTOL = 1e-5
SOLVER_RTOL = 1e-4

JAX_NS = (JNNC, JL, JG, jlearn, JInputType)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(NNC, L, G, learning, InputType, dtype="float32",
         updater="adam"):
    u = learning.Adam(1e-2) if updater == "adam" else learning.Sgd(0.1)
    return (NNC.builder().seed(5).updater(u).data_type(dtype).list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.BatchNormalization())
            .layer(L.DenseLayer(n_out=6, activation="relu"))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())


def _graph(NNC, L, G, learning, InputType, dtype="float32"):
    return (NNC.builder().seed(11).updater(learning.Nesterovs(0.1, 0.9))
            .data_type(dtype).graph_builder()
            .add_inputs("img")
            .set_input_types(InputType.convolutional(6, 6, 2))
            .add_layer("c1", L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                padding=(1, 1)), "img")
            .add_layer("bn1", L.BatchNormalization(), "c1")
            .add_layer("a1", L.ActivationLayer(activation="relu"), "bn1")
            .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"),
                       "a1")
            .add_layer("d", L.DenseLayer(n_out=5, activation="tanh"), "pool")
            .add_layer("out", L.OutputLayer(n_out=3), "d")
            .set_outputs("out").build())


def _data(kind, n=8, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n, 4) if kind == "mlp" else (n, 2, 6, 6)
    x = rng.randn(*shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def _jax_net(kind, dtype="float32", steps=1):
    """A JAX network of ``kind`` after ``steps`` fit steps (so its updater
    state and running stats are not their initial values)."""
    if kind == "mlp":
        net = JMLN(_mlp(*JAX_NS[:2], None, *JAX_NS[3:], dtype=dtype)).init()
    else:
        net = JG.ComputationGraph(_graph(*JAX_NS, dtype=dtype)).init()
    x, y = _data(kind)
    for _ in range(steps):
        net.fit(JDataSet(x, y))
    return net


def _port_twin(jnet):
    """The port's network over ``jnet``'s state."""
    if isinstance(jnet, JMLN):
        tnet = TMLN(TMLC.from_json(jnet.conf.to_json()), device="cpu")
        return bridge.load_multilayer(tnet, _np_tree(jnet._params),
                                      _np_tree(jnet._updater_state),
                                      jnet._iteration)
    tnet = TG.ComputationGraph(TG.ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu")
    return bridge.load_graph(tnet, _np_tree(jnet._params),
                             _np_tree(jnet._updater_state), jnet._iteration)


def _out(net, x):
    o = net.output(x)
    o = o[0] if isinstance(o, list) else o
    return o.numpy() if hasattr(o, "numpy") and not isinstance(
        o, np.ndarray) else np.asarray(o)


def _jout(net, x):
    o = net.output(x)
    o = o[0] if isinstance(o, list) else o
    return np.asarray(o.jax() if hasattr(o, "jax") else o)


# -- serde --------------------------------------------------------------

SERDE_CASES = [(k, d, u) for k in ("mlp", "graph")
               for d in ("float32", "bfloat16") for u in (False, True)]


@pytest.mark.parametrize("kind,dtype,updater", SERDE_CASES)
def test_jax_zip_loads_in_the_port(tmp_path, kind, dtype, updater):
    jnet = _jax_net(kind, dtype)
    path = str(tmp_path / "j.zip")
    jnet.save(path, save_updater=updater)
    tnet = tserde.restore_model(path, load_updater=updater, device="cpu")
    x, _ = _data(kind, seed=1)
    np.testing.assert_allclose(_out(tnet, x), _jout(jnet, x),
                               atol=F32 if dtype == "float32" else BF16,
                               rtol=0)
    assert (tnet._iteration, tnet._epoch) == (jnet._iteration, jnet._epoch)
    jleaves = jax.tree_util.tree_leaves(jnet._updater_state)
    if updater:
        tl = tserde._leaves(tnet._updater_state)
        assert len(tl) == len(jleaves)
        for a, b in zip(tl, jleaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:   # a fresh updater state
        assert all(float(abs(v).max()) == 0.0
                   for v in tserde._leaves(tnet._updater_state))


@pytest.mark.parametrize("kind,dtype,updater", SERDE_CASES)
def test_port_zip_loads_in_jax(tmp_path, kind, dtype, updater):
    jnet = _jax_net(kind, dtype)
    tnet = _port_twin(jnet)
    x, y = _data(kind, seed=2)
    tnet.fit(TDataSet(x, y))     # the port's own step, then its zip
    path = str(tmp_path / "t.zip")
    tnet.save(path, save_updater=updater)
    back = jserde.restore_model(path, load_updater=updater)
    assert type(back).__name__ == type(jnet).__name__
    xo, _ = _data(kind, seed=3)
    np.testing.assert_allclose(_jout(back, xo), _out(tnet, xo),
                               atol=F32 if dtype == "float32" else BF16,
                               rtol=0)
    assert back._iteration == tnet._iteration == jnet._iteration + 1
    if updater:
        jl = jax.tree_util.tree_leaves(back._updater_state)
        tl = tserde._leaves(tnet._updater_state)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        assert all(i.compress_type == zipfile.ZIP_DEFLATED
                   for i in z.infolist())
    assert ("paramManifest.json" in names) == (kind == "graph")
    assert ("updaterState.npz" in names) == updater


def test_bf16_leaves_round_trip_bit_exact(tmp_path):
    tnet = _port_twin(_jax_net("mlp"))
    tnet._params[0]["W"] = tnet._params[0]["W"].to(torch.bfloat16)
    path = str(tmp_path / "bf16.zip")
    tnet.save(path, save_updater=True)
    back = TMLN.load(path, load_updater=True, device="cpu")
    w = back._params[0]["W"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w.view(torch.int16),
                       tnet._params[0]["W"].view(torch.int16))
    with zipfile.ZipFile(path) as z, z.open("coefficients.npz") as f:
        assert np.load(f)["layer0__W"].dtype == np.dtype("V2")


def test_updater_leaf_count_mismatch_raises(tmp_path):
    tnet = _port_twin(_jax_net("mlp"))
    path = str(tmp_path / "m.zip")
    tnet.save(path, save_updater=True)
    conf = json.loads(zipfile.ZipFile(path).read("configuration.json"))
    conf["updater"] = tlearn.Nesterovs(0.1, 0.9).to_dict()
    with zipfile.ZipFile(path) as z:
        items = {n: z.read(n) for n in z.namelist()}
    items["configuration.json"] = json.dumps(conf).encode()
    with zipfile.ZipFile(path, "w") as z:
        for n, b in items.items():
            z.writestr(n, b)
    with pytest.raises(ValueError, match="leaves"):
        tserde.restore_multilayer(path, load_updater=True, device="cpu")


def test_checkpoint_listener_saves_and_retains(tmp_path):
    tnet = _port_twin(_jax_net("graph"))
    tnet.set_listeners(CheckpointListener(str(tmp_path), keep_last=2,
                                          save_every_n_epochs=1))
    x, y = _data("graph")
    tnet.fit([TDataSet(x, y)], num_epochs=3)
    left = sorted(os.listdir(tmp_path))
    assert left == ["checkpoint_epoch2.zip", "checkpoint_epoch3.zip"]
    back = TG.ComputationGraph.load(str(tmp_path / left[-1]),
                                    load_updater=True, device="cpu")
    assert np.array_equal(_out(back, x), _out(tnet, x))


# -- FrozenLayer --------------------------------------------------------

def _frozen_bn(NNC, L, G, learning, InputType):
    return (NNC.builder().seed(2).updater(learning.Sgd(0.5)).list()
            .layer(L.DenseLayer(n_out=6, activation="tanh"))
            .layer(L.FrozenLayer(underlying=L.BatchNormalization()))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())


def test_frozen_layer_forward_and_batch_norm_not_updating():
    jnet = JMLN(_frozen_bn(*JAX_NS)).init()
    tnet = _port_twin(jnet)
    assert sorted(tnet._params[1]) == sorted(jnet._params[1]) == [
        "state_frozen__beta", "state_frozen__gamma",
        "state_frozen__state_mean", "state_frozen__state_var"]
    x, y = _data("mlp")
    np.testing.assert_allclose(_out(tnet, x), _jout(jnet, x), atol=F32)
    before = {k: v.clone() for k, v in tnet._params[1].items()}
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    for k, v in before.items():
        assert torch.equal(tnet._params[1][k], v), k
        np.testing.assert_array_equal(np.asarray(jnet._params[1][k]),
                                      v.numpy())
    assert not torch.equal(tnet._params[0]["W"],
                           bridge.tensor_from_numpy(
                               np.asarray(JMLN(_frozen_bn(*JAX_NS)).init()
                                          ._params[0]["W"]), "cpu"))
    np.testing.assert_allclose(_out(tnet, x), _jout(jnet, x), atol=F32)


def test_frozen_layer_casts_to_a_bf16_body():
    """The port runs a frozen convolution in a bf16 body; the JAX package
    leaves the frozen params f32 and its convolution refuses the mix
    (reference fault 6)."""
    jconf = _graph(*JAX_NS, dtype="bfloat16")
    jnet = JG.ComputationGraph(jconf).init()
    jtl = JTL.GraphBuilder(jnet).set_feature_extractor("pool").build()
    x, _ = _data("graph")
    with pytest.raises(TypeError, match="same dtypes"):
        jtl.output(x)
    ttl = TTL.GraphBuilder(_port_twin(jnet)).set_feature_extractor(
        "pool").build()
    np.testing.assert_allclose(_out(ttl, x), _jout(jnet, x), atol=BF16)


def test_frozen_multilayer_zip_keys(tmp_path):
    """A frozen layer's ``state_frozen__W`` holds ``__``: the JAX reader
    splits the npz key at every ``__`` and loses it (reference fault 6);
    the port splits at the first and restores the network whole."""
    jnet = JTL.Builder(_jax_net("mlp")).set_feature_extractor(0).build()
    path = str(tmp_path / "frozen.zip")
    jnet.save(path)
    back = jserde.restore_multilayer(path)
    assert "state_frozen/W" in back._params[0]
    tnet = tserde.restore_multilayer(path, device="cpu")
    assert sorted(tnet._params[0]) == sorted(jnet._params[0])
    x, _ = _data("mlp", seed=4)
    np.testing.assert_allclose(_out(tnet, x), _jout(jnet, x), atol=F32)


# -- transfer learning --------------------------------------------------

def _bridge_params(tnet, jnet, names):
    """Copy the JAX network's (re-initialised) params of ``names`` into
    the port's."""
    for n in names:
        tnet._params[n] = bridge.params_from_numpy(
            _np_tree(jnet._params[n]), "cpu")
    tnet._updater_state = tnet.conf.updater.init(
        tnet._trainable(tnet._params))


def _key_layout(params):
    items = params.items() if isinstance(params, dict) else \
        enumerate(params)
    return {n: sorted(p) for n, p in items}


def test_multilayer_builder_matches_jax():
    jsrc = _jax_net("mlp")
    tsrc = _port_twin(jsrc)

    def build(TLn, FTC, learning, src):
        return (TLn.Builder(src)
                .fine_tune_configuration(FTC(updater=learning.Sgd(0.05)))
                .set_feature_extractor(1).n_out_replace(2, 7)
                .build())
    jnet = build(JTL, JFTC, jlearn, jsrc)
    tnet = build(TTL, TFTC, tlearn, tsrc)
    assert _key_layout(tnet._params) == _key_layout(jnet._params)
    assert [type(la).__name__ for la in tnet.layers] == \
        [type(la).__name__ for la in jnet.layers]
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _bridge_params(tnet, jnet, [2, 3])
    x, y = _data("mlp", seed=5)
    tff, jff = tnet.feed_forward(x), jnet.feed_forward(x)
    for a, b in zip(tff, jff):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.jax()), atol=F32)
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    for i in range(4):
        for k, v in tnet._params[i].items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jnet._params[i][k]),
                                       atol=F32, err_msg=f"{i} {k}")
    # the source network is left as it was
    assert _key_layout(tsrc._params) == _key_layout(jsrc._params)


def test_multilayer_builder_remove_and_add_layers():
    jsrc = _jax_net("mlp")
    tnet = (TTL.Builder(_port_twin(jsrc)).remove_output_layer()
            .add_layer(TL.OutputLayer(n_in=6, n_out=2)).build())
    jnet = (JTL.Builder(jsrc).remove_output_layer()
            .add_layer(JL.OutputLayer(n_in=6, n_out=2)).build())
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert _key_layout(tnet._params) == _key_layout(jnet._params)
    assert tnet.output(_data("mlp")[0]).shape == (8, 2)


def test_graph_builder_matches_jax():
    jsrc = _jax_net("graph")
    tsrc = _port_twin(jsrc)

    def build(TLn, FTC, learning, src):
        return (TLn.GraphBuilder(src)
                .fine_tune_configuration(FTC(updater=learning.Adam(1e-2),
                                             l2=1e-3))
                .set_feature_extractor("pool").n_out_replace("d", 4)
                .build())
    jnet = build(JTL, JFTC, jlearn, jsrc)
    tnet = build(TTL, TFTC, tlearn, tsrc)
    assert _key_layout(tnet._params) == _key_layout(jnet._params)
    assert _key_layout(tnet._params)["c1"] == ["state_frozen__W",
                                               "state_frozen__b"]
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _bridge_params(tnet, jnet, ["d", "out"])
    x, y = _data("graph", seed=6)
    tff, jff = tnet.feed_forward(x), jnet.feed_forward(x)
    assert sorted(tff) == sorted(jff)
    for k in jff:
        np.testing.assert_allclose(tff[k].numpy(), np.asarray(jff[k].jax()),
                                   atol=F32, err_msg=k)
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    for n in tnet._params:
        for k, v in tnet._params[n].items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jnet._params[n][k]),
                                       atol=F32, err_msg=f"{n} {k}")
    # the frozen body and its running stats did not move
    for k, v in tsrc._params["bn1"].items():
        assert torch.equal(tnet._params["bn1"]["state_frozen__" + k], v)


# -- early stopping -----------------------------------------------------

def _es_run(side, net, train, score_data, tmp):
    mods = {"t": (tes, TListIt, TDataSet), "j": (jes, JListIt, JDataSet)}
    es, ListIt, DS = mods[side]
    score = ListIt([DS(*d) for d in score_data])
    cfg = (es.EarlyStoppingConfiguration.builder()
           .score_calculator(es.DataSetLossCalculator(score))
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(6),
               es.ScoreImprovementEpochTerminationCondition(1, 1e-3))
           .model_saver(es.InMemoryModelSaver() if side == "j" else
                        es.LocalFileModelSaver(str(tmp), device="cpu"))
           .build())
    return es.EarlyStoppingTrainer(cfg, net).fit(
        ListIt([DS(*d) for d in train]))


def test_early_stopping_matches_jax(tmp_path):
    jnet = JMLN(_mlp(*JAX_NS[:2], None, *JAX_NS[3:], updater="sgd")).init()
    tnet = _port_twin(jnet)
    train = [_data("mlp", seed=s) for s in range(3)]
    score_data = [_data("mlp", seed=10 + s) for s in range(2)]
    jr = _es_run("j", jnet, train, score_data, tmp_path)
    tr = _es_run("t", tnet, train, score_data, tmp_path)
    assert (tr.termination_reason, tr.termination_details,
            tr.best_model_epoch, tr.total_epochs) == \
        (jr.termination_reason, jr.termination_details,
         jr.best_model_epoch, jr.total_epochs)
    np.testing.assert_allclose(tr.best_model_score, jr.best_model_score,
                               rtol=LOSS_RTOL)
    x, _ = _data("mlp", seed=20)
    np.testing.assert_allclose(_out(tr.get_best_model(), x),
                               _jout(jr.get_best_model(), x), atol=F32)
    assert os.path.exists(tmp_path / "bestModel.zip")


def test_termination_conditions_match_jax():
    for es in (tes, jes):
        c = es.ScoreImprovementEpochTerminationCondition(2, minimize=False)
        seq = [c.terminate(i, s) for i, s in
               enumerate([0.5, 0.6, None, 0.55, 0.58, 0.59])]
        assert seq == [False, False, False, False, False, True]
        assert es.MaxEpochsTerminationCondition(3).terminate(2, 0.0)
        t = es.MaxTimeIterationTerminationCondition(0.0)
        assert not t.terminate()
        t.start()
    with pytest.raises(ValueError, match="termination condition"):
        tes.EarlyStoppingTrainer(tes.EarlyStoppingConfiguration(),
                                 None).fit([])


# -- the step checkpointer ----------------------------------------------

def test_sharded_checkpointer_retention_and_restore(tmp_path):
    tnet = _port_twin(_jax_net("graph", steps=2))
    ck = ShardedCheckpointer(str(tmp_path), keep_last=2)
    x, y = _data("graph")
    outs = {}
    for step in (1, 2, 3):
        tnet.fit(TDataSet(x, y))
        ck.save(step, tnet)
        outs[step] = _out(tnet, x)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]
    fresh = TG.ComputationGraph(tnet.conf, device="cpu").init()
    ck.restore(fresh, step=2)
    assert np.array_equal(_out(fresh, x), outs[2])
    assert (fresh._iteration, fresh._epoch) == (4, 2)
    ck.restore(fresh)
    assert np.array_equal(_out(fresh, x), outs[3])
    assert all(torch.equal(a, b) for a, b in zip(
        tserde._leaves(fresh._updater_state),
        tserde._leaves(tnet._updater_state)))
    tree = ck.restore_tree(3)
    assert tree["iteration"] == 5 and isinstance(
        tree["params"]["c1"]["W"], torch.Tensor)
    ck.close()
    os.makedirs(tmp_path / "7")
    with pytest.raises(ValueError, match="orbax"):
        ck.restore_tree(7)
    with pytest.raises(FileNotFoundError):
        ShardedCheckpointer(str(tmp_path / "empty")).restore_tree()


def test_sharded_checkpoint_listener(tmp_path):
    tnet = _port_twin(_jax_net("mlp"))
    lst = ShardedCheckpointListener(str(tmp_path), save_every_n_epochs=1,
                                    keep_last=1)
    tnet.set_listeners(lst)
    tnet.fit([TDataSet(*_data("mlp"))], num_epochs=2)
    assert lst.ckpt.all_steps() == [tnet._iteration]


# -- solvers ------------------------------------------------------------

SOLVERS = ["LineGradientDescent", "ConjugateGradient", "LBFGS",
           "StochasticGradientDescent"]


@pytest.mark.parametrize("name", SOLVERS)
def test_solver_loss_after_10_iterations_matches_jax(name):
    jnet = JMLN(_mlp(*JAX_NS[:2], None, *JAX_NS[3:], updater="sgd")).init()
    tnet = _port_twin(jnet)
    x, y = _data("mlp", n=16, seed=3)
    js = getattr(jsolvers, name)(max_iterations=10)
    ts = getattr(tsolvers, name)(max_iterations=10)
    jloss = js.optimize(jnet, JDataSet(x, y))
    tloss = ts.optimize(tnet, TDataSet(x, y))
    assert len(ts.scores) == len(js.scores)
    np.testing.assert_allclose(ts.scores, js.scores, rtol=SOLVER_RTOL)
    np.testing.assert_allclose(tloss, jloss, rtol=SOLVER_RTOL)
    assert ts.scores[-1] < ts.scores[0]
    np.testing.assert_allclose(_out(tnet, x), _jout(jnet, x), atol=1e-4)


def test_backtrack_line_search_matches_jax():
    def t_vg(v):
        return (v * v).sum(), 2 * v

    def j_vg(v):
        return (v * v).sum(), 2 * v
    x0 = np.array([1.5, -2.0], np.float32)
    t0 = torch.from_numpy(x0)
    d = np.array([-1.0, 0.5], np.float32)
    ts = tsolvers.backtrack_line_search(t_vg, t0, *t_vg(t0),
                                        torch.from_numpy(d))
    js = jsolvers.backtrack_line_search(j_vg, jax.numpy.asarray(x0),
                                        *j_vg(jax.numpy.asarray(x0)),
                                        jax.numpy.asarray(d))
    assert ts == js
    assert tsolvers.backtrack_line_search(t_vg, t0, *t_vg(t0), t0) == 0.0


# -- the zoo's pretrained restore ---------------------------------------

@pytest.fixture
def zoo_home(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_HOME", str(tmp_path / "home"))
    tzoo_base.set_weights_fetcher(None)
    yield tmp_path
    tzoo_base.set_weights_fetcher(None)


def _lenet_zip(tmp_path):
    net = TLeNet(num_classes=4).init_model(device="cpu")
    path = tmp_path / "lenet.zip"
    net.save(str(path))
    return net, path


def test_init_pretrained_from_a_path_and_a_file_url(zoo_home):
    net, path = _lenet_zip(zoo_home)
    x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
    a = TLeNet(num_classes=4).init_pretrained(path=str(path), device="cpu")
    assert np.array_equal(_out(a, x), _out(net, x))
    url = path.as_uri()
    adler = tzoo_base.adler32_file(str(path))
    zoo = TLeNet(num_classes=4, pretrained_urls={"mnist": url},
                 pretrained_adler32={"mnist": adler})
    assert zoo.pretrained_available("mnist")
    monkey_base = tzoo_base.get_url_string
    tzoo_base.get_url_string = lambda rel: rel
    try:
        b = zoo.init_pretrained("mnist", device="cpu")
    finally:
        tzoo_base.get_url_string = monkey_base
    assert np.array_equal(_out(b, x), _out(net, x))
    cached = os.path.join(tzoo_base.cache_dir(), "LeNet", "lenet.zip")
    assert tzoo_base.adler32_file(cached) == adler
    # cache first: the copy in the cache serves without the source
    os.remove(path)
    assert tzoo_base.download_to_cache(url, "LeNet", "lenet.zip",
                                       expected_adler32=adler) == cached
    tzoo_base.set_weights_fetcher(lambda name, ptype: cached)
    c = TLeNet(num_classes=4).init_pretrained("mnist", device="cpu")
    assert np.array_equal(_out(c, x), _out(net, x))


def test_init_pretrained_checksums(zoo_home):
    net, path = _lenet_zip(zoo_home)
    with pytest.raises(ValueError, match="failed checksum"):
        tzoo_base.download_to_cache(path.as_uri(), "LeNet", "x.zip",
                                    expected_adler32=1)
    assert not os.path.exists(os.path.join(tzoo_base.cache_dir(), "LeNet",
                                           "x.zip"))
    zoo = TLeNet(num_classes=4,
                 pretrained_checksums={"mnist": "0" * 32})
    with pytest.raises(ValueError, match="checksum mismatch"):
        zoo.init_pretrained("mnist", path=str(path), device="cpu")
    assert tzoo_base._md5(str(path)) == __import__("hashlib").md5(
        path.read_bytes()).hexdigest()


def test_init_pretrained_fails_cleanly_without_network(zoo_home):
    """No copy in the cache and an https URL: the port reads no network
    and says where to put the file."""
    zoo = TLeNet()
    assert zoo.pretrained_url("mnist").startswith("https://")
    with pytest.raises(FileNotFoundError, match="fetches nothing"):
        zoo.init_pretrained("mnist", device="cpu")
    with pytest.raises(RuntimeError, match="path="):
        TLeNet().init_pretrained("imagenet", device="cpu")
    with pytest.raises(FileNotFoundError):
        TLeNet().init_pretrained(path=str(zoo_home / "none.zip"),
                                 device="cpu")


def test_dl4j_zip_restores_through_init_pretrained(zoo_home):
    """A DL4J ModelSerializer zip (``coefficients.bin``) restores through
    ``zoo/dl4j_import.py`` onto the device asked for, as the JAX
    ``init_pretrained`` does (the zoo's LeNet, written from a seed)."""
    import torch_keras_cases as kc
    path = str(zoo_home / "dl4j.zip")
    want = kc.write_dl4j_lenet_zip(path, seed=4)
    net = TLeNet().init_pretrained(path=path, device="cpu")
    assert type(net).__name__ == "MultiLayerNetwork"
    for i, p in enumerate(want):
        for k, v in p.items():
            assert np.array_equal(net._params[i][k].numpy(), v), (i, k)
    from deeplearning4j_tpu.zoo import LeNet as JLeNet
    jnet = JLeNet().init_pretrained(path=path)
    for i, p in enumerate(jnet._params):
        for k, v in p.items():
            assert np.array_equal(net._params[i][k].numpy(), np.asarray(v))


def test_registry_matches_jax():
    from deeplearning4j_tpu.zoo import base as jbase
    assert tzoo_base.PRETRAINED_REGISTRY == jbase.PRETRAINED_REGISTRY
    assert tzoo_base.get_url_string("/a/b") == jbase.get_url_string("/a/b")
