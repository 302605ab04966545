"""The port's layer API (``nn/``, ``ops/``, ``learning.py``, ``ndarray/``,
``datasets/``, ``zoo/``) against the JAX package's, on the same weights.

A port network is built from the JAX configuration's JSON and takes the
JAX network's params, running stats and updater state through
``bridge.load_multilayer``; inputs come from ``np.random.RandomState``.
Every port call runs on the CPU (``device="cpu"``).

Tolerances, each with its reason:
- f32 layer forwards and activations: the same ops summed in another
  order; atol 1e-5 on O(1) values (``F32``).
- losses (``LOSS_RTOL``) and updater steps (``UPD_RTOL``): the same f32
  elementwise formulas; rtol 1e-5, plus atol 1e-7 near 0.
- LeNet at full width (1x28x28, B=8, f32): probabilities atol 1e-6 and
  the loss rtol 1e-5 (convolutions summed in another order, ~1e-7
  relative); gradients, and Adam's first moments built from them,
  within 1e-4 of each leaf's largest entry (sums over the batch and the
  windows).
- after 3 Adam steps at lr 1e-3: Adam divides each gradient by its own
  magnitude, so a weight whose gradient is ~0 on both sides could move
  by up to lr a step either way; on these batches none does, and params
  are held to atol 0.1 * lr (``ADAM_ATOL``), the step losses to rtol
  1e-5.
- SGD fits of the small CNN (``grad_accum``, ``remat``, ``clip_l2``,
  L1/L2 and weight decay, constraints, batch norm): atol 1e-5 on params
  and running stats after 2 steps.
- bf16 compute (``conf.dtype``): both sides round activations to bf16
  at other places; LeNet's probabilities (about 0.1 each) held to atol
  1e-2, a few bf16 ulps of the logits they come from.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.constraints as jconstraints
import deeplearning4j_tpu.nn.conf.layers as JL
from deeplearning4j_tpu.datasets import iterators as jit_
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import losses as jloss
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.nn.evaluation import \
    RegressionEvaluation as JRegressionEvaluation
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ndarray.ndarray import NDArray as JNDArray
import deeplearning4j_tpu.zoo as jzoo

import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.nn.conf.constraints as tconstraints
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.zoo as tzoo
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common.dtype import DataType
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import losses as tloss
from deeplearning4j_tpu_torch.nn.conf.config import (
    InputType as TInputType, MultiLayerConfiguration as TConf,
    NeuralNetConfiguration as TNNC)
from deeplearning4j_tpu_torch.nn.evaluation import Evaluation as TEvaluation
from deeplearning4j_tpu_torch.nn.evaluation import \
    RegressionEvaluation as TRegressionEvaluation
from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray as TNDArray
from deeplearning4j_tpu_torch.quant.transforms import quantize_tensor

F32 = 1e-5
LOSS_RTOL = UPD_RTOL = 1e-5
LR = 1e-3
ADAM_ATOL = 0.1 * LR


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_INIT_CACHE = {}


def _jax_net(jconf):
    """A JAX network over ``jconf``'s seeded initial params, drawn once
    per configuration in this module (JAX's eager init dominates)."""
    key = jconf.to_json()
    if key not in _INIT_CACHE:
        _INIT_CACHE[key] = _np_tree(JMLN(jconf).init()._params)
    return JMLN(jconf).init(params=jax.tree_util.tree_map(
        jnp.asarray, _INIT_CACHE[key]))


def _pair(jconf):
    """(JAX network, port network on the CPU) over one set of weights."""
    jnet = _jax_net(jconf)
    tnet = TMLN(TConf.from_json(jconf.to_json()), device="cpu")
    bridge.load_multilayer(tnet, _np_tree(jnet._params),
                           _np_tree(jnet._updater_state), jnet._iteration)
    return jnet, tnet


def _close_tree(got, ref, atol, rtol=0.0, rel_to_max=False):
    """Every tensor of ``got`` (list of dicts) against ``ref``'s array."""
    for i, (g, r) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(r), i
        for k in g:
            r_ = np.asarray(r[k], np.float32)
            tol = atol * max(float(np.abs(r_).max()), 1e-30) \
                if rel_to_max else atol
            np.testing.assert_allclose(g[k].detach().float().numpy(), r_,
                                       atol=tol, rtol=rtol,
                                       err_msg=f"layer {i} {k}")


def _batch(n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    y = np.zeros((n, classes), np.float32)
    y[np.arange(n), rng.randint(0, classes, n)] = 1.0
    return x, y


# -- configurations -----------------------------------------------------------

def _lenet(NNC, L, learning, InputType, dtype="float32"):
    b = (NNC.builder().seed(7).updater(learning.Adam(LR)).data_type(dtype)
         .list()
         .layer(L.ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                   activation="relu"))
         .layer(L.SubsamplingLayer(kernel_size=(2, 2)))
         .layer(L.ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                   activation="relu"))
         .layer(L.SubsamplingLayer(kernel_size=(2, 2)))
         .layer(L.DenseLayer(n_out=500, activation="relu"))
         .layer(L.OutputLayer(n_out=10))
         .set_input_type(InputType.convolutional(28, 28, 1)))
    return b.build()


def _same_stride2(NNC, L, learning, InputType):
    """A CNN with SAME padding at stride 2 (the odd pixel at the end), a
    SAME max pool, batch norm and an explicit-padding conv."""
    return (NNC.builder().seed(3).updater(learning.Sgd(0.1)).list()
            .layer(L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                      stride=(2, 2), convolution_mode="same",
                                      activation="relu"))
            .layer(L.BatchNormalization())
            .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                      padding="SAME"))
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(2, 2),
                                      padding=(1, 1), activation="tanh"))
            .layer(L.DenseLayer(n_out=16, activation="gelu"))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(9, 9, 2))
            .build())


JAX_NS = (JNNC, JL, jlearn, JInputType)
TORCH_NS = (TNNC, TL, tlearn, TInputType)
CONFS = {"lenet": _lenet, "same_stride2": _same_stride2}


class TestConfig:
    @pytest.mark.parametrize("name", sorted(CONFS))
    def test_types_params_preprocessors_and_json_match(self, name):
        jconf = CONFS[name](*JAX_NS)
        tconf = CONFS[name](*TORCH_NS)
        assert tconf.layer_input_types() == jconf.layer_input_types()
        assert {i: type(p).__name__ for i, p in tconf.preprocessors.items()} \
            == {i: type(p).__name__ for i, p in jconf.preprocessors.items()}
        assert tconf.to_json() == jconf.to_json()
        tnet, jnet = TMLN(tconf, device="cpu").init(), _jax_net(jconf)
        assert tnet.num_params() == jnet.num_params()
        assert tnet.summary().splitlines()[-2] == \
            jnet.summary().splitlines()[-2]

    def test_json_round_trip(self):
        tconf = _same_stride2(*TORCH_NS)
        again = TConf.from_json(tconf.to_json())
        assert again.to_json() == tconf.to_json()
        assert again.preprocessors.keys() == tconf.preprocessors.keys()

    @pytest.mark.parametrize("model", ["LeNet", "SimpleCNN", "AlexNet",
                                       "VGG16", "VGG19", "Darknet19",
                                       "TinyYOLO", "TextGenerationLSTM"])
    def test_zoo_confs_match_jax(self, model):
        t = getattr(tzoo, model)(dtype="bfloat16").build_conf()
        j = getattr(jzoo, model)(dtype="bfloat16").build_conf()
        assert t.to_json() == j.to_json()

    def test_tiny_yolo_forward_matches_jax_and_fit_refuses_alike(self):
        """TinyYOLO at the JAX zoo test's size: the 45-channel 2x2 head
        against the JAX network on the same weights; ``fit`` refuses its
        ``Yolo2OutputLayer`` head on both sides (reference fault 7)."""
        kw = dict(num_classes=4, input_shape=(3, 64, 64))
        jnet = JMLN(jzoo.TinyYOLO(**kw).build_conf()).init()
        tnet = tzoo.TinyYOLO(**kw).init_model(device="cpu")
        bridge.load_multilayer(tnet, _np_tree(jnet._params))
        x = np.random.RandomState(3).randn(2, 3, 64, 64).astype(np.float32)
        got = tnet.output(x).numpy()
        assert got.shape == (2, 5 * 9, 2, 2)
        np.testing.assert_allclose(got, np.asarray(jnet.output(x).jax()),
                                   atol=F32, rtol=F32)
        assert tnet.num_params() == jnet.num_params()
        y = np.zeros((2, 8, 2, 2), np.float32)
        msg = "last layer must be an output/loss layer"
        with pytest.raises(ValueError, match=msg):
            jnet.fit(JDataSet(x, y))
        with pytest.raises(ValueError, match=msg):
            tnet.fit(TDataSet(x, y))

    def test_network_needs_a_device_it_can_use(self):
        """No ``device=`` means the card; without one it raises rather
        than falling back to the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TMLN(_lenet(*TORCH_NS))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tzoo.LeNet().init_model()

    def test_unported_entry_points_name_their_item(self, tmp_path):
        net = TMLN(_lenet(*TORCH_NS), device="cpu").init()
        # warm_buckets is ported (item 7): with no example and no
        # manifest it has nothing to replay, as the JAX package's
        assert net.warm_buckets(None) == []
        with pytest.raises(NotImplementedError, match="item 12"):
            net.warm_compile(None)
        # distribute is ported (item 10a): on a one-rank mesh it places
        # every leaf whole and the network keeps its outputs
        from deeplearning4j_tpu_torch.common.mesh import (MeshConfig,
                                                           make_mesh)
        x0 = np.ones((2, 1, 28, 28), np.float32)
        before = net.output(x0).numpy()
        assert net.distribute(make_mesh(MeshConfig(), device="cpu")) is net
        assert np.array_equal(net.output(x0).numpy(), before)
        # save / load and the pretrained restore are ported (nn/serde.py
        # and zoo/base.py, queue 1 item 9f)
        path = str(tmp_path / "lenet.zip")
        net.save(path)
        x = np.ones((2, 1, 28, 28), np.float32)
        for back in (TMLN.load(path, device="cpu"),
                     tzoo.LeNet().init_pretrained(path=path, device="cpu")):
            assert np.array_equal(back.output(x).numpy(),
                                  net.output(x).numpy())
        with pytest.raises(RuntimeError, match="path="):
            tzoo.LeNet().init_pretrained()


# -- layers -------------------------------------------------------------------

def _layer_cases():
    """(layer ctor kwargs per side, input shape, input type, training)."""
    c = [
        ("DenseLayer", dict(n_in=12, n_out=7, activation="gelu"), (5, 12),
         (12,)),
        ("OutputLayer", dict(n_in=12, n_out=4), (5, 12), (12,)),
        ("LossLayer", dict(activation="softmax"), (5, 6), (6,)),
        ("ConvolutionLayer", dict(n_out=5, kernel_size=(3, 2), stride=(2, 1),
                                  padding=(1, 2), dilation=(1, 2),
                                  activation="relu"), (2, 3, 9, 8),
         (3, 9, 8)),
        ("ConvolutionLayer", dict(n_out=4, kernel_size=(3, 3), stride=(2, 2),
                                  convolution_mode="same"), (2, 3, 8, 7),
         (3, 8, 7)),
        ("ConvolutionLayer", dict(n_out=4, kernel_size=(4, 4), stride=(3, 3),
                                  padding="SAME"), (2, 2, 10, 11),
         (2, 10, 11)),
        ("SubsamplingLayer", dict(kernel_size=(2, 2)), (2, 3, 8, 8),
         (3, 8, 8)),
        ("SubsamplingLayer", dict(kernel_size=(3, 3), stride=(2, 2),
                                  padding="SAME"), (2, 3, 8, 7), (3, 8, 7)),
        ("SubsamplingLayer", dict(pooling_type="avg", kernel_size=(3, 3),
                                  stride=(2, 2), padding="SAME"),
         (2, 3, 8, 7), (3, 8, 7)),
        ("SubsamplingLayer", dict(pooling_type="avg", kernel_size=(3, 3),
                                  stride=(2, 2), padding="SAME",
                                  avg_include_pad=False), (2, 3, 8, 7),
         (3, 8, 7)),
        ("SubsamplingLayer", dict(pooling_type="max", kernel_size=(2, 2),
                                  padding=(1, 1)), (2, 3, 7, 7), (3, 7, 7)),
        ("SubsamplingLayer", dict(pooling_type="pnorm", kernel_size=(2, 3),
                                  stride=(2, 2), pnorm=3), (2, 3, 8, 9),
         (3, 8, 9)),
        ("BatchNormalization", dict(), (4, 3, 5, 5), (3, 5, 5)),
        ("BatchNormalization", dict(decay=0.8), (6, 7), (7,)),
        ("LocalResponseNormalization", dict(), (2, 8, 4, 4), (8, 4, 4)),
        ("DropoutLayer", dict(rate=0.5), (4, 6), (6,)),
        ("ActivationLayer", dict(activation="elu"), (4, 6), (6,)),
        ("GlobalPoolingLayer", dict(pooling_type="max"), (2, 3, 4, 5),
         (3, 4, 5)),
        ("GlobalPoolingLayer", dict(pooling_type="avg"), (2, 3, 4, 5),
         (3, 4, 5)),
        ("GlobalPoolingLayer", dict(pooling_type="sum"), (2, 3, 4), (3, 4)),
        ("GlobalPoolingLayer", dict(pooling_type="pnorm", pnorm=3),
         (2, 3, 4, 5), (3, 4, 5)),
        ("EmbeddingLayer", dict(n_in=11, n_out=6), (5, 1), (1,)),
    ]
    return [pytest.param(*case, training, id=f"{i}-{case[0]}-"
                         f"{'train' if training else 'infer'}")
            for i, case in enumerate(c) for training in (False, True)]


@pytest.mark.parametrize("name,kw,xshape,itype,training", _layer_cases())
def test_layer_forward_matches_jax(name, kw, xshape, itype, training):
    jl, tl = getattr(JL, name)(**kw), getattr(TL, name)(**kw)
    jp = jl.init_params(jax.random.key(1), itype) if jl.has_params() else {}
    if name == "BatchNormalization":  # non-trivial running stats and affine
        rng = np.random.RandomState(2)
        jp = {k: jnp.asarray(rng.rand(*v.shape).astype(np.float32) + 0.5)
              for k, v in jp.items()}
    tp = bridge.params_from_numpy(_np_tree(jp), "cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(*xshape).astype(np.float32)
    if name == "EmbeddingLayer":
        x = rng.randint(0, 11, xshape).astype(np.float32)
    # training-mode forwards without a key draw nothing on either side
    ref = np.asarray(jl.forward(jp, jnp.asarray(x), training=training))
    got = tl.forward(tp, _t(x), training=training).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=F32, rtol=0)
    assert tl.output_type(itype) == jl.output_type(itype)


def test_quantized_weights_reach_dense_and_conv():
    """A dense or conv layer over a QuantizedTensor weight computes what
    it computes over the dequantized weight."""
    rng = np.random.RandomState(4)
    dense = TL.DenseLayer(n_in=32, n_out=16)
    w = _t(rng.randn(32, 16).astype(np.float32))
    x = _t(rng.randn(3, 32).astype(np.float32))
    q = quantize_tensor(w)
    deq = (q.q.float() * q.scale)
    torch.testing.assert_close(dense.forward({"W": q, "b": torch.zeros(16)}, x),
                               x @ deq, atol=F32, rtol=0)
    conv = TL.ConvolutionLayer(n_out=8, kernel_size=(3, 3))
    wc = _t(rng.randn(3, 3, 4, 8).astype(np.float32))
    xc = _t(rng.randn(2, 4, 6, 6).astype(np.float32))
    qc = quantize_tensor(wc)
    torch.testing.assert_close(
        conv.forward({"W": qc, "b": torch.zeros(8)}, xc),
        conv.forward({"W": qc.q.float() * qc.scale, "b": torch.zeros(8)}, xc),
        atol=F32, rtol=0)


@pytest.mark.parametrize("name", sorted(jact._ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.RandomState(5).randn(4, 9).astype(np.float32) * 3
    np.testing.assert_allclose(
        tact.get_activation(name)(_t(x)).numpy(),
        np.asarray(jact.get_activation(name)(jnp.asarray(x))),
        atol=F32, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(jloss._LOSSES))
def test_loss_matches_jax(name):
    rng = np.random.RandomState(6)
    out = rng.rand(6, 5).astype(np.float32) * 0.9 + 0.05
    if name == "sparse_mcxent":
        lab = rng.randint(0, 5, 6).astype(np.int32)
    else:
        lab = rng.rand(6, 5).astype(np.float32)
    mask = (rng.rand(6) > 0.3).astype(np.float32)
    for m in (None, mask):
        ref = float(jloss.get_loss(name)(
            jnp.asarray(lab), jnp.asarray(out),
            None if m is None else jnp.asarray(m)))
        got = float(tloss.get_loss(name)(
            _t(lab), _t(out), None if m is None else _t(m)))
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=1e-7)


# -- updaters -----------------------------------------------------------------

UPDATERS = [("Sgd", {}), ("NoOp", {}), ("Nesterovs", {}), ("Adam", {}),
            ("AdaMax", {}), ("AdaBelief", {}), ("Nadam", {}),
            ("AMSGrad", {}), ("AdaGrad", {}), ("AdaDelta", {}),
            ("RmsProp", {}),
            ("Adam", {"learning_rate": "step"}),
            ("Sgd", {"learning_rate": "cosine"})]


@pytest.mark.parametrize("name,kw", UPDATERS,
                         ids=[f"{n}-{k.get('learning_rate', 'const')}"
                              for n, k in UPDATERS])
def test_updater_matches_jax(name, kw):
    """Four applications over a two-layer params tree: every update and
    the final state."""
    sched = {"step": ("step_schedule", (0.01, 0.5, 2)),
             "cosine": ("cosine_schedule", (0.1, 5))}
    if "learning_rate" in kw:
        fn, args = sched[kw["learning_rate"]]
        ju = getattr(jlearn, name)(learning_rate=getattr(jlearn, fn)(*args))
        tu = getattr(tlearn, name)(learning_rate=getattr(tlearn, fn)(*args))
    else:
        ju, tu = getattr(jlearn, name)(), getattr(tlearn, name)()
    rng = np.random.RandomState(7)
    params = [{"W": rng.randn(4, 3).astype(np.float32),
               "b": rng.randn(3).astype(np.float32)}, {},
              {"W": rng.randn(3, 2).astype(np.float32)}]
    jstate = ju.init(jax.tree_util.tree_map(jnp.asarray, params))
    tstate = tu.init(bridge.params_from_numpy(params, "cpu"))
    for it in range(4):
        g = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        jupd, jstate = ju.apply(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, it)
        tupd, tstate = tu.apply(bridge.params_from_numpy(g, "cpu"), tstate,
                                it)
        jl = jax.tree_util.tree_leaves(jupd)
        tl_ = tlearn.tree_map(lambda t: t, tupd)
        tflat = [v for p in tl_ for _, v in sorted(p.items())]
        assert len(jl) == len(tflat)
        for a, b in zip(tflat, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=UPD_RTOL, atol=1e-7)
    if jstate is not None:
        jflat = jax.tree_util.tree_leaves(jstate)
        tflat = [v for k in sorted(tstate) for p in tstate[k]
                 for _, v in sorted(p.items())]
        for a, b in zip(tflat, jflat):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=UPD_RTOL, atol=1e-7)


@pytest.mark.parametrize("fn,args", [
    ("step_schedule", (0.1, 0.5, 3)), ("exponential_schedule", (0.1, 0.9)),
    ("inverse_schedule", (0.1, 0.2, 2.0)), ("poly_schedule", (0.1, 2.0, 7)),
    ("cosine_schedule", (0.1, 7, 0.01)),
    ("warmup_linear_schedule", (0.1, 3, 9))])
def test_schedule_matches_jax(fn, args):
    jf, tf = getattr(jlearn, fn)(*args), getattr(tlearn, fn)(*args)
    for it in range(12):
        np.testing.assert_allclose(float(tf(it)), float(jf(it)), rtol=1e-6)


# -- LeNet at full width ------------------------------------------------------

@pytest.fixture(scope="module")
def lenet_batches():
    return [_batch(8, (1, 28, 28), 10, seed) for seed in range(3)]


def test_lenet_output_score_and_gradients(lenet_batches):
    jnet, tnet = _pair(_lenet(*JAX_NS))
    x, y = lenet_batches[0]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x).jax()),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tnet.predict(x).numpy(),
                                  np.asarray(jnet.predict(x).jax()))
    np.testing.assert_allclose(tnet.score(TDataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=LOSS_RTOL)
    jl, _, jg = jnet._micro_grads(jnet._trainable(jnet._params),
                                  jnet._states(jnet._params),
                                  jnp.asarray(x), jnp.asarray(y), None)
    tloss_, _, tg = tnet._micro_grads(tnet._trainable(tnet._params),
                                      tnet._states(tnet._params),
                                      _t(x), _t(y), None)
    np.testing.assert_allclose(float(tloss_), float(jl), rtol=LOSS_RTOL)
    _close_tree(tg, _np_tree(jg), atol=1e-4, rel_to_max=True)
    acts_t, acts_j = tnet.feed_forward(x), jnet.feed_forward(x)
    assert len(acts_t) == len(acts_j) == 7
    for a, b in zip(acts_t, acts_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.jax()),
                                   atol=1e-4, rtol=1e-5)


def test_lenet_three_adam_steps_match_jax(lenet_batches):
    jnet, tnet = _pair(_lenet(*JAX_NS))
    jnet.fit([JDataSet(x, y) for x, y in lenet_batches])
    scores = CollectScoresListener()
    tnet.fit([TDataSet(x, y) for x, y in lenet_batches])
    _close_tree(tnet._params, _np_tree(jnet._params), atol=ADAM_ATOL)
    _close_tree([tnet._updater_state["m"][i] for i in range(6)],
                _np_tree(jnet._updater_state["m"]), atol=1e-4,
                rel_to_max=True)
    assert tnet._iteration == jnet._iteration == 3
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    # the per-step path (a listener overriding iteration_done) takes the
    # same steps: one more epoch on both sides
    tnet.set_listeners(scores)
    tnet.fit([TDataSet(x, y) for x, y in lenet_batches])
    jnet.fit([JDataSet(x, y) for x, y in lenet_batches])
    assert scores.iterations == [3, 4, 5]
    _close_tree(tnet._params, _np_tree(jnet._params), atol=ADAM_ATOL)
    np.testing.assert_allclose(scores.scores[-1], jnet.score_value,
                               rtol=LOSS_RTOL)


def test_lenet_bf16_output_and_fit_match_jax(lenet_batches):
    """conf.dtype bfloat16: bf16 body, f32 masters and loss head."""
    jnet, tnet = _pair(_lenet(*JAX_NS, dtype="bfloat16"))
    x, y = lenet_batches[0]
    out = tnet.output(x).torch()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x).jax()),
                               atol=1e-2, rtol=0)
    tnet.fit([TDataSet(x, y)])
    assert all(v.dtype == torch.float32 for p in tnet._params
               for v in p.values())
    assert np.isfinite(tnet.score_value)


# -- the fit variants on a small CNN --------------------------------------------

def _small_cnn(NNC, L, learning, InputType, **kw):
    b = NNC.builder().seed(11).updater(learning.Sgd(0.1))
    if kw.get("grad_accum"):
        b = b.grad_accum(kw["grad_accum"])
    if kw.get("remat"):
        b = b.remat(kw["remat"])
    if kw.get("clip"):
        b = b.gradient_normalization("clip_l2", 0.5)
    if kw.get("l2"):
        b = b.l2(1e-2).weight_decay(1e-3)
    if kw.get("constraints"):
        c = tconstraints if L is TL else jconstraints
        b = (b.constrain_weights(c.MaxNormConstraint(max_norm=0.5))
             .constrain_bias(c.NonNegativeConstraint()))
    return (b.list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      activation="identity"))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer(activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2)))
            .layer(L.DenseLayer(n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(8, 8, 2))
            .build())


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}, {"remat": "layer"},
                                {"clip": True}, {"l2": True},
                                {"constraints": True}],
                         ids=["plain", "grad_accum2", "remat_layer",
                              "clip_l2", "l2_decay", "constraints"])
def test_fit_variants_match_jax(kw):
    jconf = _small_cnn(*JAX_NS, **kw)
    assert jconf.to_json() == _small_cnn(*TORCH_NS, **kw).to_json()
    jnet, tnet = _pair(jconf)
    data = [_batch(8, (2, 8, 8), 3, seed) for seed in (20, 21)]
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([TDataSet(x, y) for x, y in data])
    # params and batch-norm running stats after 2 steps
    _close_tree(tnet._params, _np_tree(jnet._params), atol=F32)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)


def test_dots_saveable_gives_the_plain_gradients():
    """Selective checkpointing keeps products and recomputes the rest:
    the gradients equal the un-checkpointed ones."""
    conf = _small_cnn(*TORCH_NS)
    net = TMLN(conf, device="cpu").init()
    x, y = (_t(a) for a in _batch(8, (2, 8, 8), 3, 30))
    args = (net._trainable(net._params), net._states(net._params), x, y, 5)
    _, _, plain = net._micro_grads(*args)
    conf.remat = "dots_saveable"
    _, _, sac = net._micro_grads(*args)
    _close_tree(sac, [{k: v.numpy() for k, v in p.items()} for p in plain],
                atol=1e-7)


def test_dropout_masks_and_remat_replay():
    """Dropout keeps ~(1 - rate) of the entries, scaled by 1/(1 - rate),
    and a layer recomputed under remat="layer" redraws the same mask: the
    gradients with and without it agree."""
    layer = TL.DropoutLayer(rate=0.25)
    x = torch.ones(200, 50)
    out = layer.forward({}, x, training=True, key=123)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    torch.testing.assert_close(out[out != 0],
                               torch.full_like(out[out != 0], 1 / 0.75))
    torch.testing.assert_close(layer.forward({}, x, training=True, key=123),
                               out)
    assert layer.forward({}, x, training=False, key=123) is x
    conf = (TNNC.builder().seed(2).list()
            .layer(TL.DenseLayer(n_in=6, n_out=32, activation="relu",
                                 dropout=0.5))
            .layer(TL.DropoutLayer(rate=0.3))
            .layer(TL.OutputLayer(n_in=32, n_out=3)).build())
    net = TMLN(conf, device="cpu").init()
    x, y = (_t(a) for a in _batch(16, (6,), 3, 31))
    args = (net._trainable(net._params), net._states(net._params), x, y, 77)
    _, _, plain = net._micro_grads(*args)
    conf.remat = "layer"
    _, _, remat = net._micro_grads(*args)
    _close_tree(remat, [{k: v.numpy() for k, v in p.items()} for p in plain],
                atol=1e-7)


def test_weight_noise_statistics():
    from deeplearning4j_tpu_torch.nn.conf.weightnoise import (DropConnect,
                                                              WeightNoise)
    p = {"W": torch.ones(100, 100), "b": torch.ones(100)}
    dc = DropConnect(weight_retain_prob=0.8).apply_tree(9, p)
    assert abs((dc["W"] != 0).float().mean().item() - 0.8) < 0.02
    assert torch.equal(dc["b"], p["b"])
    wn = WeightNoise(stddev=0.1).apply_tree(9, p)
    assert abs((wn["W"] - 1).std().item() - 0.1) < 0.01
    assert torch.equal(WeightNoise(stddev=0.1).apply_tree(9, p)["W"],
                       wn["W"])


# -- params, evaluation, arrays, datasets -------------------------------------

def test_params_round_trip_across_the_bridge():
    jnet, tnet = _pair(_same_stride2(*JAX_NS))
    flat = np.asarray(jnet.params().jax())
    np.testing.assert_array_equal(tnet.params().numpy(), flat)
    new = np.random.RandomState(8).randn(flat.size).astype(np.float32)
    tnet.set_params(new)
    jnet.set_params(jnp.asarray(new))
    _close_tree(tnet._params, _np_tree(jnet._params), atol=0)
    np.testing.assert_array_equal(tnet.params().numpy(), new)
    assert set(tnet.get_param_table(1)) == {"gamma", "beta", "state_mean",
                                            "state_var"}
    twin = tnet.clone()
    twin.set_params(np.zeros_like(new))
    np.testing.assert_array_equal(tnet.params().numpy(), new)


def test_evaluation_matches_jax():
    rng = np.random.RandomState(9)
    labels = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 50)]
    preds = rng.rand(50, 4).astype(np.float32)
    je, te = JEvaluation(top_n=2), TEvaluation(top_n=2)
    je.eval(labels, preds)
    te.eval(TNDArray(labels), torch.from_numpy(preds))
    np.testing.assert_array_equal(te.confusion, je.confusion)
    assert te.stats() == je.stats()
    assert te.top_n_accuracy() == je.top_n_accuracy()
    jr, tr = JRegressionEvaluation(), TRegressionEvaluation()
    jr.eval(labels, preds)
    tr.eval(_t(labels), _t(preds))
    for col in range(4):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "r_squared"):
            assert getattr(tr, m)(col) == getattr(jr, m)(col)


def test_network_evaluate_and_iterators():
    _, tnet = _pair(_same_stride2(*JAX_NS))
    x, y = _batch(10, (2, 9, 9), 3, 12)
    it = tit.ArrayDataSetIterator(x, y, batch_size=4)
    e = tnet.evaluate(it)
    assert e.confusion.sum() == 10
    ref = np.argmax(tnet.output(x).numpy(), -1)
    assert e.accuracy() == float(np.mean(ref == y.argmax(-1)))
    jbatches = list(jit_.ArrayDataSetIterator(x, y, 4, shuffle=True, seed=3))
    tbatches = list(tit.ArrayDataSetIterator(x, y, 4, shuffle=True, seed=3))
    assert [b.features.shape for b in tbatches] == \
        [b.features.shape for b in jbatches] == [(4, 2, 9, 9),
                                                 (4, 2, 9, 9), (2, 2, 9, 9)]
    for tb, jb in zip(tbatches, jbatches):
        np.testing.assert_array_equal(tb.features.numpy(),
                                      np.asarray(jb.features.jax()))
    async_it = tit.AsyncDataSetIterator(tit.ListDataSetIterator(tbatches),
                                        device="cpu")
    got = list(async_it)
    assert len(got) == 3 and got[0].features.device.type == "cpu"
    np.testing.assert_array_equal(got[2].labels.numpy(),
                                  tbatches[2].labels.numpy())
    if not torch.cuda.is_available():   # a worker failure reaches us
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            list(tit.AsyncDataSetIterator(tit.ListDataSetIterator(tbatches)))
    # a streamed source trains through the per-step path
    tnet.fit(tit.ArrayDataSetIterator(x, y, batch_size=5), num_epochs=2)
    assert tnet._iteration == 4 and tnet._epoch == 2


def test_ndarray_matches_jax_semantics():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t, j = TNDArray(a.copy()), JNDArray(a)
    for fn in (lambda n: n.sum(), lambda n: n.mean(1), lambda n: n.max(0),
               lambda n: n.std(), lambda n: n.norm2(1),
               lambda n: n.transpose(), lambda n: n.reshape(2, 6),
               lambda n: (n + 1) * n - 2, lambda n: n.mmul(n.T),
               lambda n: n.argmax(1), lambda n: n.cumsum(0),
               lambda n: n.get_rows([0, 2]), lambda n: n.prod(1)):
        np.testing.assert_allclose(fn(t).numpy(), np.asarray(fn(j).jax()),
                                   rtol=1e-6)
    # views write through to the parent, basic and fancy alike
    for n in (t, j):
        n.get_row(1).addi(5)
        n[:, [0, 3]] = 0
        n.put_scalar((2, 1), -1.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.jax()))
    assert t.dtype == DataType.FLOAT and t.shape == j.shape
    assert t.equals(j.jax().__array__()) and t.is_matrix()
    assert DataType.from_any(torch.bfloat16) is DataType.BFLOAT16
    ds = TDataSet(a, a[:, :2]).shuffle(seed=1)
    jd = JDataSet(a, a[:, :2]).shuffle(seed=1)
    np.testing.assert_array_equal(ds.features.numpy(),
                                  np.asarray(jd.features.jax()))
    assert json.dumps(ds.labels.to_list()) == \
        json.dumps(np.asarray(jd.labels.jax()).tolist())
