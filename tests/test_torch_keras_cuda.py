"""The Keras importer, the TFLite runner and the training UI's listener on
the card against the same inputs on the CPU. Every test here carries the
``cuda`` marker and skips where there is no CUDA device; the file imports
neither JAX, the JAX package, h5py nor Keras:

    python -m pytest --noconftest tests/test_torch_keras_cuda.py -q

- The committed tiny Keras CNN (``tests/torch_data/keras_tiny_cnn.h5``)
  imported with ``device="cuda"`` against ``device="cpu"`` and against
  Keras's committed golden.
- The committed TFLite CNN through ``TfliteRunner(device="cuda")``: its
  signature captured and replayed, against the CPU and the TF
  Interpreter's committed golden.
- One ``StatsListener`` update of LeNet on the card against the same
  params on the CPU, with the card's memory in the record.

Tolerances: f32 products and convolutions summed in another order on the
card, TF32 off: ``CARD_VS_CPU``; against the goldens, the JAX package's
tests' own (1e-5 for the Keras CNN, 1e-4 for the TFLite CNN).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_keras_cases as kc  # noqa: E402
from deeplearning4j_tpu_torch.interop import TfliteRunner  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import \
    import_keras_sequential_model_and_weights  # noqa: E402
from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage,  # noqa: E402
                                         StatsListener)
from deeplearning4j_tpu_torch.zoo import LeNet  # noqa: E402

pytestmark = pytest.mark.cuda

CARD_VS_CPU = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def test_tiny_keras_import_on_the_card(card):
    x = kc.keras_tiny_input().transpose(0, 3, 1, 2).copy()
    outs = {}
    for device in ("cuda", "cpu"):
        net = import_keras_sequential_model_and_weights(kc.KERAS_TINY,
                                                        device=device)
        assert next(iter(net._params[0].values())).device.type == device
        outs[device] = net.output(x).numpy()
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], **CARD_VS_CPU)
    np.testing.assert_allclose(outs["cuda"], kc.keras_tiny_golden(),
                               atol=1e-5)


def test_tflite_cnn_on_the_card(card):
    x = kc.tflite_inputs()["cnn"]
    card_runner = TfliteRunner(kc.TFLITE["cnn"], device="cuda")
    first = card_runner.run([x])[card_runner.output_names[0]].numpy()
    again = card_runner.run([x])[card_runner.output_names[0]].numpy()
    report = card_runner._run.graphs.report()
    assert [g["cache"] for g in report] == ["captured"]
    assert report[0]["replays"] >= 1
    assert np.array_equal(first, again)
    host = TfliteRunner(kc.TFLITE["cnn"], device="cpu")
    ref = host.run([x])[host.output_names[0]].numpy()
    np.testing.assert_allclose(first, ref, **CARD_VS_CPU)
    np.testing.assert_allclose(first, kc.tflite_goldens()["cnn"], atol=1e-4,
                               rtol=1e-4)


def test_stats_listener_update_on_the_card(card):
    net = LeNet().init_model(device="cuda")
    host = LeNet().init_model(device="cpu")
    host.init(params=[{k: v.cpu().clone() for k, v in p.items()}
                      for p in net._params])
    records = {}
    for name, model in (("cuda", net), ("cpu", host)):
        st = InMemoryStatsStorage()
        StatsListener(st, session_id=name, histogram_frequency=1) \
            .iteration_done(model, 0, loss=1.0)
        records[name] = st
    card_rec = records["cuda"].get_latest_update("cuda")
    host_rec = records["cpu"].get_latest_update("cpu")
    assert records["cuda"].get_static_info("cuda")["backend"] == "cuda"
    mem = card_rec["memory"]
    assert mem["bytes_in_use"] > 0
    assert mem["peak_bytes_in_use"] >= mem["bytes_in_use"]
    assert "memory" not in host_rec
    for name, s in host_rec["params"].items():
        c = card_rec["params"][name]
        for k in ("l2", "mean_mag"):
            np.testing.assert_allclose(c[k], s[k], **CARD_VS_CPU)
        assert sum(c["histogram"]["counts"]) == sum(s["histogram"]["counts"])
        np.testing.assert_allclose(c["histogram"]["edges"],
                                   s["histogram"]["edges"], **CARD_VS_CPU)
