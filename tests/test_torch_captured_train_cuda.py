"""The captured training steps of the layer API on the card: ``fit``
replaying one CUDA graph a step signature (``nn/fit_fastpath.py`` over
``runtime/cuda_graphs.py``) against the same step bodies run eagerly by
a twin network kept eager (``_eager_reason``). Every test here carries
the ``cuda`` marker and skips where there is no CUDA device; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_captured_train_cuda.py -q

Each case takes 16 steps on both networks (12 on the epoch path, 4 on
the per-step path with a listener) and holds, bit for bit, the params,
the updater state, the running statistics, every per-step loss and the
last one: the same kernels on the same inputs in the same order give the
same bits, and the schedule, the bias correction, the dropout and
weight-noise masks and the grad-accum micro-batch keys advance on every
replay as they do eagerly. cuDNN runs its deterministic algorithms here,
so the two networks' convolutions sum alike.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import learning
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.weightnoise import WeightNoise
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.conf.config import InputType
from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.zoo import LeNet

pytestmark = pytest.mark.cuda

EPOCHS, BATCHES, PER_STEP = 3, 4, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _batches(shape, classes, rows=32, seed=0):
    rs = np.random.RandomState(seed)
    return [DataSet(torch.from_numpy(
        rs.randn(rows, *shape).astype(np.float32)).cuda(),
        torch.from_numpy(np.eye(classes, dtype=np.float32)[
            rs.randint(0, classes, rows)]).cuda())
        for _ in range(BATCHES)]


def _fit_both(make, batches):
    """Both networks through the same 16 steps; returns them and each
    one's per-step losses."""
    nets = {"replayed": make(), "eager": make()}
    nets["eager"]._eager_reason = "check"
    scores = {}
    for label, net in nets.items():
        net.fit(batches, num_epochs=EPOCHS)
        rec = CollectScoresListener()
        net.set_listeners(rec)
        net.fit(batches[:PER_STEP])
        net.set_listeners()
        scores[label] = rec.scores
    return nets, scores


def _assert_same_bits(nets, scores):
    rep, eag = nets["replayed"], nets["eager"]
    assert rep._iteration == eag._iteration == EPOCHS * BATCHES + PER_STEP
    a, b = rep._state_leaves(), eag._state_leaves()
    assert len(a) == len(b) > 0
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    assert scores["replayed"] == scores["eager"]
    assert len(set(scores["replayed"])) == PER_STEP
    assert rep.score_value == eag.score_value
    caches = {label: {(g["tag"].split(":")[0], g["cache"])
                      for g in n.train_graphs_report()}
              for label, n in nets.items()}
    assert caches == {"replayed": {("epoch", "captured"),
                                   ("train", "captured")},
                      "eager": {("epoch", "eager:check"),
                                ("train", "eager:check")}}
    assert sum(g["replays"] for g in rep.train_graphs_report()) > 0


def test_lenet_bf16_adam(cuda):
    _assert_same_bits(*_fit_both(
        lambda: LeNet(dtype="bfloat16").init_model(device="cuda"),
        _batches((1, 28, 28), 10)))


def test_dropout_noise_schedule_clip_accum_remat(cuda):
    """Dropout, weight noise, a rate that changes every step, ``clip_l2``,
    two micro-batches a step and remat "layer" in one network."""
    def make():
        conf = (NeuralNetConfiguration.builder().seed(4)
                .updater(learning.Adam(learning.exponential_schedule(
                    1e-2, 0.9)))
                .gradient_normalization("clip_l2", 0.5)
                .grad_accum(2).remat("layer").list()
                .layer(L.DenseLayer(n_in=20, n_out=64, activation="relu",
                                    dropout=0.3,
                                    weight_noise=WeightNoise(stddev=0.05)))
                .layer(L.DropoutLayer(rate=0.2))
                .layer(L.DenseLayer(n_in=64, n_out=32, activation="gelu"))
                .layer(L.OutputLayer(n_in=32, n_out=5)).build())
        return MultiLayerNetwork(conf, device="cuda").init()
    _assert_same_bits(*_fit_both(make, _batches((20,), 5, seed=1)))


def test_graph_with_batch_norm(cuda):
    def make():
        conf = (NeuralNetConfiguration.builder().seed(11)
                .updater(learning.Nesterovs(0.05, 0.9))
                .graph_builder()
                .add_inputs("img")
                .set_input_types(InputType.convolutional(12, 12, 3))
                .add_layer("c1", L.ConvolutionLayer(
                    n_out=8, kernel_size=(3, 3), padding=(1, 1),
                    has_bias=False), "img")
                .add_layer("bn1", L.BatchNormalization(), "c1")
                .add_layer("a1", L.ActivationLayer(activation="relu"),
                           "bn1")
                .add_layer("sc", L.ConvolutionLayer(n_out=8,
                                                    kernel_size=(1, 1)),
                           "img")
                .add_vertex("add", ElementWiseVertex(op="add"), "a1", "sc")
                .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"),
                           "add")
                .add_layer("out", L.OutputLayer(n_out=4), "pool")
                .set_outputs("out")
                .build())
        return ComputationGraph(conf, device="cuda").init()
    nets, scores = _fit_both(make, _batches((3, 12, 12), 4, seed=2))
    _assert_same_bits(nets, scores)
    mean = nets["replayed"]._params["bn1"]["state_mean"]
    assert not torch.equal(mean, torch.zeros_like(mean))
