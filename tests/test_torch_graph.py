"""The port's ComputationGraph (``nn/graph/``) against the JAX package's,
on the same weights.

A port graph is built from the JAX configuration's JSON and takes the JAX
graph's params, running stats and updater state through
``bridge.load_graph``; inputs come from ``np.random.RandomState``. Every
port call runs on the CPU (``device="cpu"``).

Tolerances, each with its reason:
- f32 forwards, vertex outputs and losses: the same ops summed in
  another order; atol 1e-5 on O(1) values (``F32``), losses rtol 1e-5
  (``LOSS_RTOL``).
- SGD and Nesterov steps (learning rate 0.1): params and batch-norm
  running stats within atol 1e-5 after 1 and 3 steps (``F32``): each
  step moves a weight by lr times an f32 gradient that differs by ~1e-7.
- Adam steps (learning rate 1e-2): Adam divides each gradient by its own
  magnitude, so a weight whose gradient is ~0 on both sides may move by
  up to lr a step either way; on these batches none does, and params
  are held to atol 0.1 * lr (``ADAM_ATOL``).
- bf16 compute (``conf.dtype``): both sides round activations to bf16
  at other places; softmax outputs held to atol 1e-2, a few bf16 ulps of
  the O(1) logits they come from; losses within 2e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.graph as JG
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import config as JC
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)

import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.dataset import \
    MultiDataSet as TMultiDataSet
from deeplearning4j_tpu_torch.nn.conf import config as TC
from deeplearning4j_tpu_torch.nn.conf.config import (InputType as TInputType,
                                                     NeuralNetConfiguration
                                                     as TNNC)
from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener

F32 = 1e-5
LOSS_RTOL = 1e-5
ADAM_LR = 1e-2
ADAM_ATOL = 0.1 * ADAM_LR
BF16_ATOL = 1e-2

JAX_NS = (JNNC, JL, JG, jlearn, JInputType)
TORCH_NS = (TNNC, TL, TG, tlearn, TInputType)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _onehot(rng, n, classes):
    return np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]


def _pair(jconf, dtype=None):
    """(JAX graph, port graph on the CPU) over one set of weights."""
    if dtype is not None:
        jconf.dtype = dtype
    jnet = JG.ComputationGraph(jconf).init()
    tnet = TG.ComputationGraph(
        TG.ComputationGraphConfiguration.from_json(jconf.to_json()),
        device="cpu")
    bridge.load_graph(tnet, _np_tree(jnet._params),
                      _np_tree(jnet._updater_state), jnet._iteration)
    return jnet, tnet


def _close_params(tnet, jnet, atol):
    ref = _np_tree(jnet._params)
    assert sorted(tnet._params) == sorted(ref)
    for n, p in tnet._params.items():
        assert sorted(p) == sorted(ref[n]), n
        for k, v in p.items():
            np.testing.assert_allclose(v.detach().float().numpy(),
                                       np.asarray(ref[n][k], np.float32),
                                       atol=atol, rtol=0,
                                       err_msg=f"{n} {k}")


def _close_outputs(touts, jouts, atol=F32):
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.jax()), atol=atol,
                                   rtol=0)


# -- configurations -----------------------------------------------------------

def _simple(NNC, L, G, learning, InputType):
    """``tests/test_computation_graph.py``'s simple_graph."""
    return (NNC.builder().seed(7).updater(learning.Adam(ADAM_LR))
            .graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.feed_forward(4))
            .add_layer("d1", L.DenseLayer(n_in=4, n_out=8,
                                          activation="relu"), "in")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3), "d1")
            .set_outputs("out")
            .build())


def _merge_two_heads(NNC, L, G, learning, InputType):
    """Two inputs merged, a shared trunk with batch norm, and two output
    vertices: one after the batch norm, one fed by a second merge (the
    mixed-precision cases of the JAX package's forward)."""
    return (NNC.builder().seed(3).updater(learning.Nesterovs(0.1, 0.9))
            .graph_builder()
            .add_inputs("a", "b")
            .set_input_types(InputType.feed_forward(3),
                             InputType.feed_forward(5))
            .add_vertex("merge", G.MergeVertex(), "a", "b")
            .add_layer("d", L.DenseLayer(n_in=8, n_out=6,
                                         activation="tanh"), "merge")
            .add_layer("bn", L.BatchNormalization(n_out=6), "d")
            .add_layer("e", L.DenseLayer(n_in=8, n_out=4,
                                         activation="relu"), "merge")
            .add_vertex("cat", G.MergeVertex(), "bn", "e")
            .add_layer("out1", L.OutputLayer(n_in=6, n_out=2), "bn")
            .add_layer("out2", L.OutputLayer(n_in=10, n_out=3), "cat")
            .set_outputs("out1", "out2")
            .build())


def _cnn_residual(NNC, L, G, learning, InputType, **kw):
    """A residual CNN block (conv-bn-relu, add, global pool) with the fit
    variants the train step supports."""
    b = NNC.builder().seed(11).updater(learning.Sgd(0.1))
    if kw.get("grad_accum"):
        b = b.grad_accum(kw["grad_accum"])
    if kw.get("remat"):
        b = b.remat(kw["remat"])
    if kw.get("clip"):
        b = b.gradient_normalization("clip_l2", 0.5)
    if kw.get("l2"):
        b = b.l2(1e-2).weight_decay(1e-3)
    return (b.graph_builder()
            .add_inputs("img")
            .set_input_types(InputType.convolutional(6, 6, 2))
            .add_layer("c1", L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                padding=(1, 1),
                                                has_bias=False), "img")
            .add_layer("bn1", L.BatchNormalization(), "c1")
            .add_layer("a1", L.ActivationLayer(activation="relu"), "bn1")
            .add_layer("sc", L.ConvolutionLayer(n_out=4, kernel_size=(1, 1)),
                       "img")
            .add_vertex("add", G.ElementWiseVertex(op="add"), "a1", "sc")
            .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"),
                       "add")
            .add_layer("out", L.OutputLayer(n_out=3), "pool")
            .set_outputs("out")
            .build())


CONFS = {"simple": _simple, "merge_two_heads": _merge_two_heads,
         "cnn_residual": _cnn_residual}


def _merge_data(n, seed):
    rng = np.random.RandomState(seed)
    return ([rng.randn(n, 3).astype(np.float32),
             rng.randn(n, 5).astype(np.float32)],
            [_onehot(rng, n, 2), _onehot(rng, n, 3)])


# -- construction and JSON ----------------------------------------------------

class TestConstruction:
    @pytest.mark.parametrize("name", sorted(CONFS))
    def test_order_types_params_and_json_match(self, name):
        jconf, tconf = CONFS[name](*JAX_NS), CONFS[name](*TORCH_NS)
        assert tconf.topological_order() == jconf.topological_order()
        assert tconf.vertex_output_types() == jconf.vertex_output_types()
        assert tconf.to_json() == jconf.to_json()
        jnet, tnet = _pair(jconf)
        assert tnet.num_params() == jnet.num_params()
        assert tnet.summary() == jnet.summary()
        np.testing.assert_array_equal(tnet.params().numpy(),
                                      np.asarray(jnet.params().jax()))

    def test_topological_order(self):
        order = _simple(*TORCH_NS).topological_order()
        assert order.index("in") < order.index("d1") < order.index("out")

    def test_cycle_detection(self):
        conf = _simple(*TORCH_NS)
        conf.vertex_inputs["d1"] = ["out"]
        with pytest.raises(ValueError, match="cycle"):
            conf.topological_order()

    def test_output_types_and_num_params(self):
        conf = _simple(*TORCH_NS)
        types = conf.vertex_output_types()
        assert types["d1"] == (8,) and types["out"] == (3,)
        net = TG.ComputationGraph(conf, device="cpu").init()
        assert net.num_params() == 4 * 8 + 8 + 8 * 3 + 3

    @pytest.mark.parametrize("name", sorted(CONFS))
    def test_json_from_either_side_loads_on_the_other(self, name):
        jjson, tjson = CONFS[name](*JAX_NS).to_json(), \
            CONFS[name](*TORCH_NS).to_json()
        t_from_j = TG.ComputationGraphConfiguration.from_json(jjson)
        j_from_t = JG.ComputationGraphConfiguration.from_json(tjson)
        assert t_from_j.to_json() == j_from_t.to_json() == jjson
        assert t_from_j.vertex_inputs == j_from_t.vertex_inputs
        assert {n: type(v.preprocessor).__name__
                for n, v in t_from_j.vertices.items()
                if isinstance(v, TG.LayerVertex)} == \
            {n: type(v.preprocessor).__name__
             for n, v in j_from_t.vertices.items()
             if isinstance(v, JG.LayerVertex)}

    def test_preprocessor_serde_keeps_args(self):
        def conf(NNC, L, C):
            return (NNC.builder().graph_builder()
                    .add_inputs("in")
                    .add_layer("c", L.ConvolutionLayer(n_in=3, n_out=4,
                                                       kernel_size=(3, 3)),
                               "in", preprocessor=C.FeedForwardToCnnPreProcessor(
                                   3, 4, 4))
                    .add_layer("out", L.OutputLayer(n_in=4 * 2 * 2, n_out=2),
                               "c")
                    .set_outputs("out").build())
        tjson = conf(TNNC, TL, TC).to_json()
        assert tjson == conf(JNNC, JL, JC).to_json()
        pre = TG.ComputationGraphConfiguration.from_json(tjson).vertices[
            "c"].preprocessor
        assert (pre.channels, pre.height, pre.width) == (3, 4, 4)

    def test_preprocessor_vertex_serde(self):
        def conf(NNC, L, G, C):
            return (NNC.builder().graph_builder()
                    .add_inputs("in")
                    .add_vertex("flat", G.PreprocessorVertex(
                        preprocessor=C.CnnToFeedForwardPreProcessor()), "in")
                    .add_layer("out", L.OutputLayer(n_in=12, n_out=2), "flat")
                    .set_outputs("out").build())
        tjson = conf(TNNC, TL, TG, TC).to_json()
        assert tjson == conf(JNNC, JL, JG, JC).to_json()
        v = TG.ComputationGraphConfiguration.from_json(tjson).vertices["flat"]
        assert v.forward({}, [torch.ones(2, 3, 2, 2)]).shape == (2, 12)

    def test_graph_needs_a_device_it_can_use(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TG.ComputationGraph(_simple(*TORCH_NS))

    def test_unported_entry_points_name_their_item(self, tmp_path):
        net = TG.ComputationGraph(_simple(*TORCH_NS), device="cpu").init()
        assert net.warm_buckets(None) == []
        # distribute is ported (item 10a): a one-rank mesh keeps outputs
        from deeplearning4j_tpu_torch.common.mesh import (MeshConfig,
                                                           make_mesh)
        x0 = np.ones((2, 4), np.float32)
        before = net.output(x0)[0].numpy()
        assert net.distribute(make_mesh(MeshConfig(), device="cpu")) is net
        assert np.array_equal(net.output(x0)[0].numpy(), before)
        # save / load are ported (nn/serde.py, queue 1 item 9f)
        path = str(tmp_path / "g.zip")
        net.save(path, save_updater=True)
        back = TG.ComputationGraph.load(path, load_updater=True,
                                        device="cpu")
        x = np.ones((2, 4), np.float32)
        assert np.array_equal(back.output(x)[0].numpy(),
                              net.output(x)[0].numpy())

    def test_uninitialized_graph_refuses(self):
        net = TG.ComputationGraph(_simple(*TORCH_NS), device="cpu")
        with pytest.raises(RuntimeError, match="init"):
            net.output(np.ones((2, 4), np.float32))


# -- vertices -----------------------------------------------------------------

def _vertex_cases():
    """(vertex class, kwargs, input shapes)."""
    two = [(3, 5), (3, 5)]
    return [
        ("MergeVertex", {}, [(3, 2), (3, 4)]),
        ("MergeVertex", {"axis": 1}, [(2, 3, 4, 4), (2, 5, 4, 4)]),
        ("ElementWiseVertex", {"op": "add"}, [(3, 5)] * 3),
        ("ElementWiseVertex", {"op": "subtract"}, two),
        ("ElementWiseVertex", {"op": "product"}, [(3, 5)] * 3),
        ("ElementWiseVertex", {"op": "average"}, [(3, 5)] * 3),
        ("ElementWiseVertex", {"op": "max"}, two),
        ("ElementWiseVertex", {"op": "min"}, two),
        ("StackVertex", {}, two),
        ("UnstackVertex", {"from_index": 1, "stack_size": 2}, [(6, 5)]),
        ("SubsetVertex", {"from_idx": 1, "to_idx": 3}, [(3, 6)]),
        ("L2NormalizeVertex", {}, [(3, 2, 4)]),
        ("L2Vertex", {}, two),
        ("ScaleVertex", {"scale": 3.0}, [(3, 5)]),
        ("ShiftVertex", {"shift": 1.5}, [(3, 5)]),
        ("ReshapeVertex", {"shape": (2, 4)}, [(3, 8)]),
        ("AttentionVertex", {"n_in": 8, "n_out": 6, "n_heads": 2,
                             "head_size": 4}, [(3, 8, 5)] * 3),
        ("AttentionVertex", {"n_in": 8, "n_out": 6, "n_heads": 2},
         [(3, 8, 5)] * 3 + ["mask"]),
        ("AttentionVertex", {"project_input": False}, [(2, 4, 6)] * 3),
        ("AttentionVertex", {"project_input": False},
         [(2, 4, 6)] * 3 + ["mask"]),
    ]


@pytest.mark.parametrize("name,kw,shapes", _vertex_cases(),
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(_vertex_cases())])
def test_vertex_matches_jax(name, kw, shapes):
    jv, tv = getattr(JG, name)(**kw), getattr(TG, name)(**kw)
    rng = np.random.RandomState(5)
    xs = []
    for s in shapes:
        if s == "mask":   # one row fully masked, one partly
            m = np.ones((xs[0].shape[0], xs[0].shape[2]), np.float32)
            m[0, :] = 0
            m[1, -2:] = 0
            xs.append(m)
        else:
            xs.append(rng.randn(*s).astype(np.float32))
    types = [tuple(x.shape[1:]) for x in xs]
    jp = jv.init_params(jax.random.key(2), types) if jv.has_params() else {}
    tp = bridge.params_from_numpy(_np_tree(jp), "cpu")
    ref = np.asarray(jv.forward(jp, [jnp.asarray(x) for x in xs]))
    got = tv.forward(tp, [_t(x) for x in xs]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=F32, rtol=0)
    assert tv.has_params() == jv.has_params()
    if name not in ("StackVertex", "UnstackVertex"):
        assert tv.output_type(types) == jv.output_type(types)


def test_vertex_classes_match_jax():
    assert sorted(TG.vertices.VERTEX_CLASSES) == \
        sorted(JG.vertices.VERTEX_CLASSES)


# -- forward, loss, fit -------------------------------------------------------

def test_simple_output_score_and_feed_forward():
    jnet, tnet = _pair(_simple(*JAX_NS))
    rng = np.random.RandomState(0)
    x, y = rng.randn(5, 4).astype(np.float32), _onehot(rng, 5, 3)
    _close_outputs(tnet.output(x), jnet.output(x))
    np.testing.assert_allclose(tnet.output(x)[0].numpy().sum(-1), np.ones(5),
                               rtol=1e-5)
    np.testing.assert_allclose(tnet.output_single(x).numpy(),
                               np.asarray(jnet.output_single(x).jax()),
                               atol=F32, rtol=0)
    np.testing.assert_allclose(tnet.score(TDataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=LOSS_RTOL)
    tacts, jacts = tnet.feed_forward(x), jnet.feed_forward(x)
    assert list(tacts) == list(jacts) == ["in", "d1", "out"]
    for k in tacts:
        np.testing.assert_allclose(tacts[k].numpy(), np.asarray(jacts[k].jax()),
                                   atol=F32, rtol=0)


@pytest.mark.parametrize("steps", [1, 3])
def test_simple_adam_steps_match_jax(steps):
    jnet, tnet = _pair(_simple(*JAX_NS))
    rng = np.random.RandomState(1)
    data = [(rng.randn(8, 4).astype(np.float32), _onehot(rng, 8, 3))
            for _ in range(steps)]
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([TDataSet(x, y) for x, y in data])
    assert tnet._iteration == jnet._iteration == steps
    _close_params(tnet, jnet, ADAM_ATOL)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_multi_input_multi_output_fit_matches_jax(steps):
    """Two inputs merged, two output vertices summed into one loss: output,
    score, params and batch-norm running stats after ``steps`` Nesterov
    steps (the device-staged path) against the JAX graph's."""
    jnet, tnet = _pair(_merge_two_heads(*JAX_NS))
    feats, labs = _merge_data(12, 2)
    _close_outputs(tnet.output(feats), jnet.output(feats))
    _close_outputs(tnet.output({"a": feats[0], "b": feats[1]}),
                   jnet.output({"a": feats[0], "b": feats[1]}))
    np.testing.assert_allclose(tnet.score(TMultiDataSet(feats, labs)),
                               jnet.score(JMultiDataSet(feats, labs)),
                               rtol=LOSS_RTOL)
    batches = [_merge_data(12, 10 + s) for s in range(steps)]
    jnet.fit([JMultiDataSet(f, l) for f, l in batches])
    tnet.fit([TMultiDataSet(f, l) for f, l in batches])
    _close_params(tnet, jnet, F32)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    _close_outputs(tnet.output(feats), jnet.output(feats))
    mean = tnet._params["bn"]["state_mean"].numpy()
    assert not np.allclose(mean, 0.0)


def test_per_step_path_with_a_listener_matches_jax():
    """A listener overriding iteration_done takes the per-step path; the
    steps are the staged path's."""
    jnet, tnet = _pair(_merge_two_heads(*JAX_NS))
    batches = [_merge_data(12, 20 + s) for s in range(2)]
    scores = CollectScoresListener()
    tnet.set_listeners(scores)
    jnet.fit([JMultiDataSet(f, l) for f, l in batches])
    tnet.fit([TMultiDataSet(f, l) for f, l in batches])
    assert scores.iterations == [0, 1]
    _close_params(tnet, jnet, F32)
    np.testing.assert_allclose(scores.scores[-1], jnet.score_value,
                               rtol=LOSS_RTOL)


def test_bf16_two_heads_match_jax():
    """conf.dtype bfloat16: the body in bf16, the inputs of both output
    vertices (one fed by a merge) in f32, f32 masters; one step."""
    jnet, tnet = _pair(_merge_two_heads(*JAX_NS), dtype="bfloat16")
    feats, labs = _merge_data(12, 3)
    outs = tnet.output(feats)
    assert all(o.torch().dtype == torch.float32 for o in outs)
    _close_outputs(outs, jnet.output(feats), atol=BF16_ATOL)
    acts = tnet.feed_forward(feats)
    assert acts["d"].torch().dtype == torch.bfloat16
    assert acts["out2"].torch().dtype == torch.float32
    jnet.fit(JMultiDataSet(feats, labs))
    tnet.fit(TMultiDataSet(feats, labs))
    assert all(v.dtype == torch.float32 for p in tnet._params.values()
               for v in p.values())
    np.testing.assert_allclose(tnet.score_value, jnet.score_value, atol=2e-2)
    _close_params(tnet, jnet, BF16_ATOL)


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}, {"remat": "layer"},
                                {"clip": True}, {"l2": True}],
                         ids=["plain", "grad_accum2", "remat_layer",
                              "clip_l2", "l2_decay"])
def test_fit_variants_match_jax(kw):
    jconf = _cnn_residual(*JAX_NS, **kw)
    assert jconf.to_json() == _cnn_residual(*TORCH_NS, **kw).to_json()
    jnet, tnet = _pair(jconf)
    rng = np.random.RandomState(30)
    data = [(rng.randn(8, 2, 6, 6).astype(np.float32), _onehot(rng, 8, 3))
            for _ in range(2)]
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([TDataSet(x, y) for x, y in data])
    _close_params(tnet, jnet, F32)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)


def test_batchnorm_state_updates_match_jax():
    """``TestReviewRegressions::test_cg_batchnorm_state_updates``: fit
    refreshes the running stats, to the JAX graph's values. SGD where the
    JAX test takes Adam: the batch norm cancels the dense bias ahead of
    it, whose gradient is f32 noise that Adam would scale up to steps of
    lr either way on each side."""
    def conf(NNC, L, G, learning, InputType):
        return (NNC.builder().updater(learning.Sgd(0.1))
                .graph_builder()
                .add_inputs("in")
                .add_layer("d", L.DenseLayer(n_in=4, n_out=6,
                                             activation="identity"), "in")
                .add_layer("bn", L.BatchNormalization(n_out=6), "d")
                .add_layer("out", L.OutputLayer(n_in=6, n_out=2), "bn")
                .set_outputs("out").build())
    jnet, tnet = _pair(conf(*JAX_NS))
    rng = np.random.RandomState(5)
    x = (rng.randn(32, 4) * 5 + 3).astype(np.float32)
    y = _onehot(rng, 32, 2)
    jnet.fit(JDataSet(x, y), num_epochs=10)
    tnet.fit(TDataSet(x, y), num_epochs=10)
    mean = tnet._params["bn"]["state_mean"].numpy()
    var = tnet._params["bn"]["state_var"].numpy()
    assert not np.allclose(mean, 0.0) and not np.allclose(var, 1.0)
    _close_params(tnet, jnet, F32)


def test_multi_dataset_and_fit_from_arrays():
    mds = TMultiDataSet(*_merge_data(6, 4))
    assert mds.num_examples() == 6
    assert [f.shape for f in mds.features] == [(6, 3), (6, 5)]
    assert mds.features_masks is None
    net = TG.ComputationGraph(_simple(*TORCH_NS), device="cpu").init()
    rng = np.random.RandomState(6)
    x, y = rng.randn(16, 4).astype(np.float32), _onehot(rng, 16, 3)
    before = net.score(TDataSet(x, y))
    net.fit(x, y, num_epochs=30)
    assert net.score(TDataSet(x, y)) < before * 0.7


def test_clone_is_independent():
    jnet, tnet = _pair(_simple(*JAX_NS))
    twin = tnet.clone()
    rng = np.random.RandomState(4)
    x, y = rng.randn(4, 4).astype(np.float32), _onehot(rng, 4, 3)
    tnet.fit(TDataSet(x, y), num_epochs=3)
    assert not np.allclose(tnet.output(x)[0].numpy(),
                           twin.output(x)[0].numpy())
    _close_outputs(twin.output(x), jnet.output(x))


def test_evaluate_matches_jax():
    jnet, tnet = _pair(_simple(*JAX_NS))
    rng = np.random.RandomState(7)
    x, y = rng.randn(10, 4).astype(np.float32), _onehot(rng, 10, 3)
    te = tnet.evaluate(tit.ArrayDataSetIterator(x, y, batch_size=4))
    from deeplearning4j_tpu.datasets import iterators as jit_
    je = jnet.evaluate(jit_.ArrayDataSetIterator(x, y, 4))
    np.testing.assert_array_equal(te.confusion, je.confusion)
    assert te.stats() == je.stats()


def test_params_round_trip_across_the_bridge():
    jnet, tnet = _pair(_merge_two_heads(*JAX_NS))
    flat = np.asarray(jnet.params().jax())
    new = np.random.RandomState(8).randn(flat.size).astype(np.float32)
    tnet.set_params(new)
    jnet.set_params(jnp.asarray(new))
    _close_params(tnet, jnet, 0)
    np.testing.assert_array_equal(tnet.params().numpy(), new)
    assert set(tnet.get_param_table("bn")) == {"gamma", "beta", "state_mean",
                                               "state_var"}
    assert tnet.get_updater_state() is tnet._updater_state


def test_attention_graph_fit_matches_jax():
    """Gradients reach an AttentionVertex's projections: two SGD steps of
    a graph with self-attention over RNN-format input, a pooled head and
    a mask input, against the JAX graph's params."""
    def conf(NNC, L, G, learning, InputType):
        return (NNC.builder().seed(5).updater(learning.Sgd(0.1))
                .graph_builder()
                .add_inputs("seq", "mask")
                .add_vertex("att", G.AttentionVertex(n_in=6, n_out=6,
                                                     n_heads=2), "seq",
                            "seq", "seq", "mask")
                .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"),
                           "att")
                .add_layer("out", L.OutputLayer(n_in=6, n_out=3), "pool")
                .set_outputs("out").build())
    jnet, tnet = _pair(conf(*JAX_NS))
    rng = np.random.RandomState(40)
    data = []
    for _ in range(2):
        seq = rng.randn(4, 6, 5).astype(np.float32)
        mask = np.ones((4, 5), np.float32)
        mask[0, 3:] = 0
        data.append(([seq, mask], [_onehot(rng, 4, 3)]))
    jnet.fit([JMultiDataSet(f, l) for f, l in data])
    tnet.fit([TMultiDataSet(f, l) for f, l in data])
    _close_params(tnet, jnet, F32)
    assert not np.allclose(tnet._params["att"]["Wq"].numpy(),
                           np.asarray(JG.ComputationGraph(conf(*JAX_NS))
                                      .init()._params["att"]["Wq"]))
    _close_outputs(tnet.output(data[0][0]), jnet.output(data[0][0]))


def test_dropout_graph_trains_and_infers_deterministically():
    """A graph with a dropout layer (SqueezeNet's ``drop9``): training
    steps draw masks from the host key stream and stay finite; inference
    draws nothing, so two ``output()`` calls agree bit for bit, and a
    clone with the same seed takes the same steps."""
    from deeplearning4j_tpu_torch import zoo as tzoo
    kw = dict(num_classes=4, input_shape=(3, 48, 48))
    net = tzoo.SqueezeNet(**kw).init_model(device="cpu")
    twin = net.clone()
    rng = np.random.RandomState(41)
    ds = TDataSet(rng.randn(4, 3, 48, 48).astype(np.float32),
                  _onehot(rng, 4, 4))
    net.fit(ds, num_epochs=2)
    twin.fit(ds, num_epochs=2)
    assert np.isfinite(net.score_value)
    assert net.score_value == twin.score_value
    x = ds.features.numpy()
    np.testing.assert_array_equal(net.output(x)[0].numpy(),
                                  net.output(x)[0].numpy())
