"""The port's graph zoo (``zoo/models_graph.py``) against the JAX
package's.

Each model's configuration is built on both sides and its JSON compared;
weights are drawn once by the port (its init is fast on the CPU) and
carried into the JAX graph (``ComputationGraph.init(params=...)``), so
both run the same numbers. Every port call runs on the CPU.

Tolerances, each with its reason:
- f32 forwards: convolutions and products summed in another order
  through 10-70 layers; softmax probabilities within atol 1e-5
  (``F32``).
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


@pytest.mark.parametrize("name", ["UNet", "Xception", "NASNet", "YOLO2"])
def test_unported_graph_models_name_their_item(name):
    model = getattr(tzoo, name)()
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        model.init_model(device="cpu")
