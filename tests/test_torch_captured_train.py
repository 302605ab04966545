"""The captured training steps of the layer API (``nn/fit_fastpath.py``
over ``runtime/cuda_graphs.py``) against the JAX package's ``fit``, on
the CPU.

On a CPU network every step signature runs eagerly on its static
buffers (the network's own params, layer states and updater state, and
x, y, the iteration and the step key as tensors filled before each run),
so these cases exercise everything a CUDA network captures but the
replay itself (``tests/test_torch_captured_train_cuda.py``):

- (a) ``fit`` of a narrow LeNet and of a small residual
  ``ComputationGraph`` against the JAX package's after 3 Adam steps, on
  the epoch path and on the per-step path;
- (b) every schedule of ``learning.py`` with Adam's bias correction over
  steps where the rate changes each step; a step that froze the
  iteration would land outside the tolerance (held in the case);
- (c) dropout and weight-noise masks: new on every step, the same for an
  equal key (an int or a device tensor), the same on a remat recompute,
  and distinct between a step's grad-accum micro-batches;
- (d) the census per kind as the JAX package's, each signature listed
  once in ``train_graphs_report()``;
- (e) params replaced from outside release the steps and the next ``fit``
  captures again on the new params; a dropped network is freed without
  a collection; the eager reasons of a 2-rank gloo mesh and of a solver.

Tolerances: Adam steps as ``tests/test_torch_multilayer.py``'s
``test_lenet_three_adam_steps_match_jax`` and ``tests/test_torch_graph.py``'s
Adam fits: params within atol 0.1 * lr (Adam divides each gradient by its
own magnitude, so an f32 difference of ~1e-7 in a small gradient moves a
weight by up to a fraction of lr), losses within rtol 1e-5.
"""
import gc
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.graph as JG
from deeplearning4j_tpu.common.environment import environment as jenv
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common import rng
from deeplearning4j_tpu_torch.common.environment import environment as tenv
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import solvers as tsolvers
from deeplearning4j_tpu_torch.nn.conf.config import (InputType as TInputType,
                                                     NeuralNetConfiguration
                                                     as TNNC)
from deeplearning4j_tpu_torch.nn.conf.weightnoise import DropConnect
from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN

LR = 1e-2
ADAM_ATOL = 0.1 * LR
LOSS_RTOL = 1e-5
JAX_NS = (JNNC, JL, JG, jlearn, JInputType)
TORCH_NS = (TNNC, TL, TG, tlearn, TInputType)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _onehot(rs, n, classes):
    return np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]


def _close(got, ref, atol, what=""):
    """Every tensor of ``got`` against the matching array of ``ref``
    (nested lists and dicts)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(ref), what
        for k in got:
            _close(got[k], ref[k], atol, f"{what}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, atol, f"{what}/{i}")
    else:
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=atol, rtol=0, err_msg=what)


# -- configurations -----------------------------------------------------------

def _lenet(NNC, L, G, learning, InputType, updater=None):
    """LeNet at narrow widths (4 and 6 filters, 32 hidden units)."""
    return (NNC.builder().seed(7).updater(updater or learning.Adam(LR))
            .list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=6, kernel_size=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2)))
            .layer(L.DenseLayer(n_out=32, activation="relu"))
            .layer(L.OutputLayer(n_out=10))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())


def _residual(NNC, L, G, learning, InputType):
    """A residual block (conv-bn-relu beside a 1x1 shortcut, added, pooled)
    under Adam."""
    return (NNC.builder().seed(11).updater(learning.Adam(LR))
            .graph_builder()
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


def _mlp(NNC, L, G, learning, InputType, updater=None, **layer_kw):
    return (NNC.builder().seed(5).updater(updater or learning.Adam(LR))
            .list()
            .layer(L.DenseLayer(n_in=5, n_out=8, activation="tanh",
                                **layer_kw))
            .layer(L.OutputLayer(n_in=8, n_out=3))
            .build())


def _mlp_pair(jupdater=None, tupdater=None):
    """(JAX network, port network on the CPU) over the JAX network's
    weights, each with its own updater (a schedule does not cross JSON)."""
    jnet = JMLN(_mlp(*JAX_NS, updater=jupdater)).init()
    tnet = TMLN(_mlp(*TORCH_NS, updater=tupdater), device="cpu")
    bridge.load_multilayer(tnet, _np_tree(jnet._params),
                           _np_tree(jnet._updater_state), jnet._iteration)
    return jnet, tnet


def _batches(n_batches, rows, shape, classes, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(rows, *shape).astype(np.float32),
             _onehot(rs, rows, classes)) for _ in range(n_batches)]


# -- (a) fit against the JAX package's ------------------------------------------

@pytest.mark.parametrize("per_step", [False, True], ids=["epoch", "step"])
def test_lenet_three_adam_steps_match_jax(per_step):
    from deeplearning4j_tpu_torch.nn.conf.config import \
        MultiLayerConfiguration
    jconf = _lenet(*JAX_NS)
    jnet = JMLN(jconf).init()
    tnet = TMLN(MultiLayerConfiguration.from_json(jconf.to_json()),
                device="cpu")
    bridge.load_multilayer(tnet, _np_tree(jnet._params),
                           _np_tree(jnet._updater_state))
    if per_step:
        tnet.set_listeners(CollectScoresListener())
    data = _batches(3, 8, (1, 28, 28), 10, seed=1)
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([TDataSet(x, y) for x, y in data])
    assert tnet._iteration == jnet._iteration == 3
    _close(tnet._params, _np_tree(jnet._params), ADAM_ATOL, "params")
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    report = tnet.train_graphs_report()
    assert [(g["tag"].split(":")[0], g["cache"], g["captures"], g["replays"])
            for g in report] == [("train" if per_step else "epoch", "eager",
                                  1, 2)]


def test_residual_graph_three_adam_steps_match_jax():
    jconf = _residual(*JAX_NS)
    jnet = JG.ComputationGraph(jconf).init()
    tnet = TG.ComputationGraph(
        TG.ComputationGraphConfiguration.from_json(jconf.to_json()),
        device="cpu")
    bridge.load_graph(tnet, _np_tree(jnet._params),
                      _np_tree(jnet._updater_state))
    data = _batches(3, 8, (2, 6, 6), 3, seed=2)
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([TDataSet(x, y) for x, y in data])
    _close(tnet._params, _np_tree(jnet._params), ADAM_ATOL, "params")
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    assert not np.allclose(tnet._params["bn1"]["state_mean"].numpy(), 0.0)


# -- (b) schedules and the bias correction ------------------------------------

SCHEDULES = {
    "step": lambda L: L.step_schedule(5 * LR, 0.5, 1),
    "exponential": lambda L: L.exponential_schedule(5 * LR, 0.6),
    "inverse": lambda L: L.inverse_schedule(5 * LR, 1.0, 2.0),
    "poly": lambda L: L.poly_schedule(5 * LR, 2.0, 5),
    "cosine": lambda L: L.cosine_schedule(5 * LR, 4, 0.0),
    "warmup_linear": lambda L: L.warmup_linear_schedule(5 * LR, 2, 6),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_and_bias_correction_advance_every_step(name):
    """Four Adam steps on the epoch path at a rate that changes every
    step. The JAX network run again with its iteration reset to 0
    before each step (what a graph that baked in the first step's
    iteration would compute) lands far outside the tolerance, so a
    frozen iteration fails this case."""
    make = SCHEDULES[name]
    jnet, tnet = _mlp_pair(jlearn.Adam(make(jlearn)),
                           tlearn.Adam(make(tlearn)))
    frozen = JMLN(_mlp(*JAX_NS, updater=jlearn.Adam(make(jlearn)))).init(
        params=jax.tree_util.tree_map(jnp.asarray, _np_tree(jnet._params)))
    data = _batches(4, 6, (5,), 3, seed=3)
    rates = [float(make(jlearn)(i)) for i in range(4)]
    assert len(set(rates)) == 4, rates
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([TDataSet(x, y) for x, y in data])
    for x, y in data:
        frozen._iteration = 0
        frozen.fit(JDataSet(x, y))
    ref = _np_tree(jnet._params)
    _close(tnet._params, ref, ADAM_ATOL, "params")
    drift = max(float(np.abs(np.asarray(f) - np.asarray(r)).max())
                for f, r in zip(jax.tree_util.tree_leaves(
                    _np_tree(frozen._params)),
                    jax.tree_util.tree_leaves(ref)))
    assert drift > 3 * ADAM_ATOL, drift
    assert tnet.train_graphs_report()[0]["cache"] == "eager"


def test_a_schedule_answering_with_a_host_number_stays_eager():
    """A user schedule that branches on the iteration in Python returns a
    float for a tensor: its step is never captured (``eager:host_value``)
    and still takes the rate of its own step."""
    def sched(it):
        return 0.05 if it < 2 else 0.01

    net = TMLN(_mlp(*TORCH_NS, updater=tlearn.Sgd(sched)), device="cpu")
    net.init()
    ref = net.clone()
    data = _batches(3, 6, (5,), 3, seed=4)
    net.fit([TDataSet(x, y) for x, y in data])
    assert tlearn.host_schedules(net.conf.updater) == ["learning_rate"]
    assert {g["cache"] for g in net.train_graphs_report()} == \
        {"eager:host_value"}
    for i, (x, y) in enumerate(data):
        loss, states, grads = ref._micro_grads(
            ref._trainable(ref._params), ref._states(ref._params),
            torch.from_numpy(x), torch.from_numpy(y), None)
        ref._params = [{k: v - sched(i) * grads[j][k] for k, v in p.items()}
                       for j, p in enumerate(ref._params)]
    _close(net._params, _np_tree([{k: v.numpy() for k, v in p.items()}
                                  for p in ref._params]), 1e-6, "params")


# -- (c) dropout and weight-noise masks -----------------------------------------

class _Recording:
    """Records what a layer's forward or a weight noise drew, call by
    call."""

    def __init__(self):
        self.masks = []


def _dropout_net(remat="none", grad_accum=1):
    conf = (TNNC.builder().seed(2).updater(tlearn.Sgd(0.1))
            .remat(remat).grad_accum(grad_accum).list()
            .layer(TL.DenseLayer(n_in=6, n_out=32, activation="relu",
                                 weight_noise=DropConnect(0.7)))
            .layer(TL.DropoutLayer(rate=0.3))
            .layer(TL.OutputLayer(n_in=32, n_out=3)).build())
    net = TMLN(conf, device="cpu").init()
    rec = _Recording()
    drop = net.layers[1]
    forward = drop.forward

    def recorded(params, x, training=False, key=None):
        out = forward(params, x, training=training, key=key)
        if training:
            rec.masks.append(("drop", (out != 0).clone()))
        return out
    drop.forward = recorded
    wn = net.layers[0].weight_noise
    apply_tree = wn.apply_tree

    def noised(key, p):
        out = apply_tree(key, p)
        rec.masks.append(("noise", (out["W"] != 0).clone()))
        return out
    wn.apply_tree = noised
    return net, rec


def test_masks_are_new_every_step_and_a_function_of_the_key():
    net, rec = _dropout_net()
    data = _batches(3, 16, (6,), 3, seed=31)
    net.fit([TDataSet(x, y) for x, y in data])
    for kind in ("drop", "noise"):
        masks = [m for k, m in rec.masks if k == kind]
        assert len(masks) == 3, kind
        assert not any(torch.equal(masks[i], masks[j])
                       for i in range(3) for j in range(i + 1, 3)), kind
    # a draw is a function of the key's value, an int or a device tensor
    x = torch.ones(64, 32)
    layer = TL.DropoutLayer(rate=0.5)
    a = layer.forward({}, x, training=True, key=11)
    assert torch.equal(a, layer.forward({}, x, training=True,
                                        key=torch.tensor(11)))
    assert not torch.equal(a, layer.forward({}, x, training=True, key=12))
    u = rng.uniform(rng.fold(torch.tensor(7), 3, 1), (4, 5), "cpu")
    assert torch.equal(u, rng.uniform(rng.fold(7, 3, 1), (4, 5), "cpu"))


def test_remat_recompute_draws_the_same_mask():
    net, rec = _dropout_net(remat="layer")
    x, y = _batches(1, 16, (6,), 3, seed=32)[0]
    # the whole recompute runs (no early stop once the saved tensors are
    # back), so the recorder sees its mask
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        net.fit(TDataSet(x, y))
    drops = [m for k, m in rec.masks if k == "drop"]
    assert len(drops) == 2             # the forward, then its recompute
    assert torch.equal(drops[0], drops[1])


def test_grad_accum_micro_batches_draw_distinct_masks():
    net, rec = _dropout_net(grad_accum=2)
    x, y = _batches(1, 16, (6,), 3, seed=33)[0]
    net.fit(TDataSet(x, y))
    for kind in ("drop", "noise"):
        masks = [m for k, m in rec.masks if k == kind]
        assert len(masks) == 2, kind
        assert not torch.equal(masks[0], masks[1]), kind


# -- (d) the census -----------------------------------------------------------

def test_census_per_kind_matches_jax_and_lists_each_signature_once():
    jnet, tnet = _mlp_pair()
    got = {"jax": Counter(), "port": Counter()}

    def listener(side):
        return lambda key: got[side].update([str(key[0]).split(":")[0]])
    on = {"jax": listener("jax"), "port": listener("port")}
    jenv().add_compile_listener(on["jax"])
    tenv().add_compile_listener(on["port"])
    try:
        for sizes in ((4, 4), (4, 4), (4, 6, 4), (6, 4)):
            rs = np.random.RandomState(len(sizes))
            batches = [(rs.randn(n, 5).astype(np.float32),
                        _onehot(rs, n, 3)) for n in sizes]
            jnet.fit([JDataSet(x, y) for x, y in batches])
            tnet.fit([TDataSet(x, y) for x, y in batches])
    finally:
        jenv().remove_compile_listener(on["jax"])
        tenv().remove_compile_listener(on["port"])
    assert got["port"] == got["jax"] == Counter({"epoch": 1, "train": 2})
    report = tnet.train_graphs_report()
    assert sorted(g["tag"].split(":")[0] for g in report) == \
        ["epoch", "train", "train"]
    assert all(g["cache"] == "eager" and g["captures"] == 1
               for g in report)


# -- (e) lifetimes and eager reasons ------------------------------------------

def test_params_replaced_from_outside_are_stepped_on():
    """``set_params`` releases the steps; the next ``fit`` binds its step
    to the new params (a second capture) and steps from them, as a fresh
    network given the same params does."""
    net = TMLN(_mlp(*TORCH_NS), device="cpu").init()
    data = _batches(2, 4, (5,), 3, seed=5)
    net.fit([TDataSet(x, y) for x, y in data])
    flat = np.random.RandomState(6).randn(net.num_params()).astype(
        np.float32)
    net.set_params(flat)
    twin = net.clone()      # a network of its own, from the same state
    net.fit([TDataSet(x, y) for x, y in data])
    twin.fit([TDataSet(x, y) for x, y in data])
    step, = net.train_graphs_report()
    assert step["captures"] == 2 and step["replays"] == 2
    for p, q in zip(net._params, twin._params):
        for k in p:
            assert torch.equal(p[k], q[k]), k


def test_fit_writes_in_place_and_predict_follows():
    """``fit`` steps the network's own tensors (after one clone at the
    first fit, the params may be shared): a param table read before a
    second ``fit`` sees its steps, and ``output()`` reads them."""
    shared = TMLN(_mlp(*TORCH_NS), device="cpu").init()
    net = TMLN(_mlp(*TORCH_NS), device="cpu").init(params=shared._params)
    x, y = _batches(1, 4, (5,), 3, seed=7)[0]
    before = net._params[0]["W"].clone()
    net.fit(TDataSet(x, y))
    assert torch.equal(shared._params[0]["W"], before)   # not written
    w = net._params[0]["W"]
    out0 = net.output(x).numpy()
    net.fit(TDataSet(x, y))
    assert net._params[0]["W"] is w and not torch.equal(w, before)
    from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32
    with torch.no_grad(), full_f32():
        want = net._forward(net._params, torch.from_numpy(x), False)
    np.testing.assert_array_equal(net.output(x).numpy(), want.numpy())
    assert not np.array_equal(out0, want.numpy())


def test_a_dropped_network_goes_without_a_collection():
    net = TMLN(_mlp(*TORCH_NS, dropout=0.2), device="cpu").init()
    data = _batches(2, 4, (5,), 3, seed=8)
    net.fit([TDataSet(x, y) for x, y in data])
    net.fit(iter([TDataSet(x, y) for x, y in data]))
    net.output(data[0][0])
    refs = [weakref.ref(net), weakref.ref(net._train_graphs()),
            weakref.ref(net._params[0]["W"])]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del net
        assert [r() for r in refs] == [None, None, None]
    finally:
        if collecting:
            gc.enable()


def test_solver_and_two_rank_gloo_mesh_report_their_eager_reasons():
    from deeplearning4j_tpu_torch.parallel.launch import RankPool
    net = TMLN(_mlp(*TORCH_NS), device="cpu").init()
    x, y = _batches(1, 8, (5,), 3, seed=9)[0]
    tsolvers.LineGradientDescent(max_iterations=1).optimize(net, x, y)
    assert [(g["tag"].split(":")[0], g["cache"])
            for g in net.train_graphs_report()] == \
        [("solver", "eager:host_decision")]
    with RankPool(2, "cpu") as pool:
        reports = pool.run("torch_parallel_cases:mesh_fit_report",
                           _mlp(*TORCH_NS).to_json(), [x, x], [y, y])
    for report in reports:
        assert sorted((g["tag"].split(":")[0], g["cache"])
                      for g in report) == [("epoch", "eager:gloo"),
                                           ("parallel", "eager:gloo")]
