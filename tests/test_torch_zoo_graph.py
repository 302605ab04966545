"""The port's graph zoo (``zoo/models_graph.py``) against the JAX
package's.

Each model's configuration is built on both sides and its JSON compared;
weights are drawn once by the port (its init is fast on the CPU) and
carried into the JAX graph (``ComputationGraph.init(params=...)``), so
both run the same numbers. Every port call runs on the CPU.

Tolerances, each with its reason:
- f32 forwards: convolutions and products summed in another order
  through 10-70 layers; softmax probabilities within atol 1e-5
  (``F32``), and the detection, segmentation and depthwise-separable
  models' outputs within atol plus rtol 1e-5.
- f32 fit steps of YOLO2 and UNet (Adam, batch norm over 2x2 maps):
  the loss before the step and the step's loss within rtol 1e-4
  (``FIT_RTOL``), sums over every output cell in another order.
- ResNet-50's bf16 train step (``conf.dtype = "bfloat16"``): both sides
  round activations to bf16, at other places (XLA keeps some fused
  intermediates in f32); the loss (about ln 7 = 1.9, a mean over the
  batch) within 2e-2, and a batch-norm running mean, a mean of
  bf16-rounded activations of magnitude ~1, within 2e-2.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.zoo as jzoo
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

import deeplearning4j_tpu_torch.zoo as tzoo
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet

F32 = 1e-5
FIT_RTOL = 1e-4
BF16_LOSS_ATOL = BF16_STAT_ATOL = 2e-2

TINY_RESNET = dict(num_classes=7, stages=(1, 1, 1, 1), input_shape=(3, 32, 32))
# the JAX zoo tests' sizes (tests/test_zoo.py::TestGraphZoo)
PORTED = {
    "ResNet50": TINY_RESNET,
    "SqueezeNet": dict(num_classes=6, input_shape=(3, 48, 48)),
    "InceptionResNetV1": dict(num_classes=5, blocks=(1, 1, 1),
                              input_shape=(3, 96, 96)),
    "FaceNetNN4Small2": dict(num_classes=5, input_shape=(3, 64, 64)),
}


def _pair(name, **kw):
    """(JAX graph, port graph on the CPU) over the port's initial
    weights."""
    tnet = getattr(tzoo, name)(**kw).init_model(device="cpu")
    jconf = getattr(jzoo, name)(**kw).build_conf()
    assert tnet.conf.to_json() == jconf.to_json()
    params = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()}
              for n, p in tnet._params.items()}
    return JGraph(jconf).init(params=params), tnet


def _batch(n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]
    return x, y


@pytest.mark.parametrize("name", sorted(PORTED))
def test_forward_matches_jax(name):
    kw = PORTED[name]
    jnet, tnet = _pair(name, **kw)
    x, _ = _batch(2, kw["input_shape"], kw["num_classes"], 1)
    got = tnet.output(x)
    ref = jnet.output(x)
    assert len(got) == len(ref) == 1
    assert got[0].shape == (2, kw["num_classes"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0].jax()),
                               atol=F32, rtol=0)
    assert tnet.num_params() == jnet.num_params()


def test_resnet50_tiny_bf16_fit_step_matches_jax():
    """One bf16 Nesterov step (the zoo's updater) of the tiny ResNet-50:
    the step's loss and a batch-norm running mean against the JAX
    graph's."""
    kw = dict(TINY_RESNET, dtype="bfloat16")
    jnet, tnet = _pair("ResNet50", **kw)
    x, y = _batch(8, kw["input_shape"], kw["num_classes"], 2)
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    assert math.isfinite(tnet.score_value)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               atol=BF16_LOSS_ATOL, rtol=0)
    for vertex in ("stem_bn", "s3b0_c_bn"):
        got = tnet._params[vertex]["state_mean"]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnet._params[vertex]["state_mean"]),
            atol=BF16_STAT_ATOL, rtol=0)
        assert not np.allclose(got.numpy(), 0.0)
    assert tnet._params["output"]["W"].dtype == torch.float32


def test_resnet50_full_width_types_and_params():
    """BASELINE config 2's network: the JAX zoo test's output types, and
    the JAX package's parameter count (its shapes from ``eval_shape``,
    without drawing 25.6 M weights eagerly)."""
    tconf = tzoo.ResNet50().conf()
    jconf = jzoo.ResNet50().conf()
    assert tconf.to_json() == jconf.to_json()
    types = tconf.vertex_output_types()
    assert types["avgpool"] == (2048,) and types["output"] == (1000,)
    assert types == jconf.vertex_output_types()
    shapes = jax.eval_shape(lambda: JGraph(jconf).init()._params)
    want = sum(math.prod(s.shape) for p in shapes.values()
               for k, s in p.items() if not k.startswith("state_"))
    net = tzoo.ResNet50().init_model(device="cpu")
    assert net.num_params() == want == 25_557_032
    assert sum(1 for p in net._params.values() for k in p
               if not k.startswith("state_")) == 53 + 2 * 53 + 2


# the detection, segmentation and depthwise-separable models, at the JAX
# zoo tests' sizes, with their output shapes
DETECTION = {
    "UNet": (dict(input_shape=(3, 32, 32), base_filters=4), (1, 32, 32)),
    "Xception": (dict(num_classes=5, middle_blocks=1,
                      input_shape=(3, 64, 64)), (5,)),
    "NASNet": (dict(num_classes=5, num_blocks=1, penultimate_filters=48,
                    input_shape=(3, 32, 32)), (5,)),
    "YOLO2": (dict(num_classes=4, input_shape=(3, 64, 64)), (5 * 9, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(DETECTION))
def test_detection_and_separable_forward_matches_jax(name):
    kw, out_shape = DETECTION[name]
    jnet, tnet = _pair(name, **kw)
    x, _ = _batch(2, kw["input_shape"], 2, 1)
    got, ref = tnet.output(x), jnet.output(x)
    assert len(got) == len(ref) == 1
    assert got[0].shape == (2,) + out_shape == tuple(ref[0].shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0].jax()),
                               atol=F32, rtol=F32)
    assert tnet.num_params() == jnet.num_params()


def yolo_labels(B, classes, grid, seed):
    """[B, 4 + classes, grid, grid]: one or two boxes an image in the
    corner format, each at the cell that holds its centre."""
    rng = np.random.RandomState(seed)
    y = np.zeros((B, 4 + classes, grid, grid), np.float32)
    for b in range(B):
        for _ in range(rng.randint(1, 3)):
            x1, y1 = rng.uniform(0, 0.6, 2)
            x2, y2 = x1 + rng.uniform(0.1, 0.4), y1 + rng.uniform(0.1, 0.4)
            cx = min(int((x1 + x2) / 2 * grid), grid - 1)
            cy = min(int((y1 + y2) / 2 * grid), grid - 1)
            y[b, :4, cy, cx] = (x1, y1, x2, y2)
            y[b, 4:, cy, cx] = 0.0
            y[b, 4 + rng.randint(classes), cy, cx] = 1.0
    return y


def _fit_step_matches(jnet, tnet, x, y):
    before = tnet.score(TDataSet(x, y))
    np.testing.assert_allclose(before, jnet.score(JDataSet(x, y)),
                               rtol=FIT_RTOL)
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    assert math.isfinite(tnet.score_value)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=FIT_RTOL)
    # after the step only that it moved: Adam steps each weight by about
    # lr whatever its gradient's size, so a weight whose gradient is ~0 on
    # both sides may step either way
    after = tnet.score(TDataSet(x, y))
    assert math.isfinite(after) and after != before


def test_yolo2_tiny_fit_step_matches_jax():
    """One Adam step (the zoo's updater) of the tiny YOLO2 on a batch
    with one or two boxes an image: the loss before the step and the
    step's loss against the JAX graph's."""
    kw, _ = DETECTION["YOLO2"]
    jnet, tnet = _pair("YOLO2", **kw)
    x, _ = _batch(2, kw["input_shape"], 2, 3)
    _fit_step_matches(jnet, tnet, x, yolo_labels(2, 4, 2, 4))


def test_unet_tiny_fit_step_matches_jax():
    """One Adam step of the tiny UNet on binary masks, the per-pixel
    sigmoid cross-entropy against the JAX graph's. The bottom dropout's
    draws cannot match ``jax.random``'s, so the step runs with its rate
    set to 0 on both sides."""
    kw, _ = DETECTION["UNet"]
    jnet, tnet = _pair("UNet", **kw)
    for net in (jnet, tnet):
        net.conf.vertices["bottom_drop"].layer.rate = 0.0
    x, _ = _batch(2, kw["input_shape"], 2, 5)
    y = (np.random.RandomState(6).rand(2, 1, 32, 32) > 0.5) \
        .astype(np.float32)
    _fit_step_matches(jnet, tnet, x, y)
