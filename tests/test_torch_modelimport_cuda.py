"""The port's model import on the card against the same bytes imported
on the CPU. Every test here carries the ``cuda`` marker and skips where
there is no CUDA device; the file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_modelimport_cuda.py -q

- The tiny BERT GraphDef (``tests/torch_data``, filled from a seed)
  imported with ``device="cuda"`` against ``device="cpu"``; and through
  ``GraphRunner(backend="native")``.
- The ONNX residual block through ``OnnxRunner`` on the card against
  the CPU.
- A ``.fb`` written from the CPU import loads onto the card
  (``load_samediff_fb(device="cuda")``) and gives the card import's
  output bits.

Tolerance: f32 products and convolutions summed in another order on the
card, TF32 off: atol 2e-5 (the JAX package's tiny-BERT golden tolerance).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_import_cases as cases  # noqa: E402
from deeplearning4j_tpu_torch.interop import (GraphRunner,  # noqa: E402
                                              OnnxRunner)
from deeplearning4j_tpu_torch.modelimport import import_tf_graph  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.samediff_fb import \
    load_samediff_fb  # noqa: E402

pytestmark = pytest.mark.cuda

CARD_VS_CPU = dict(atol=2e-5)
OUTS = list(cases.OUTPUTS)


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


def _tiny():
    pb = cases.bert_graph("tiny", seed=5)
    feeds = cases.bert_feeds("tiny", batch=3, masked=6)
    return pb, feeds, {k: v.shape for k, v in feeds.items()}


def test_tiny_bert_on_the_card_matches_the_cpu(card):
    pb, feeds, shapes = _tiny()
    res = {d: import_tf_graph(pb, shapes, OUTS, device=d).output(feeds, OUTS)
           for d in ("cuda", "cpu")}
    for o in OUTS:
        assert res["cuda"][o].torch().is_cuda
        np.testing.assert_allclose(res["cuda"][o].numpy(),
                                   res["cpu"][o].numpy(), **CARD_VS_CPU)
    runs = [GraphRunner(pb, list(feeds), OUTS, shapes, backend="native",
                        device=d).run(feeds) for d in ("cuda", "cpu")]
    for o in OUTS:
        np.testing.assert_allclose(runs[0][o].numpy(), runs[1][o].numpy(),
                                   **CARD_VS_CPU)


def test_onnx_residual_block_on_the_card(card):
    data, _ = cases.onnx_residual_block(np.random.RandomState(0))
    x = np.random.RandomState(1).randn(2, 8, 12, 12).astype(np.float32)
    got = OnnxRunner(data, device="cuda").run({"x": x})["y"]
    want = OnnxRunner(data, device="cpu").run({"x": x})["y"]
    assert got.torch().is_cuda
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CARD_VS_CPU)


def test_fb_round_trip_loads_onto_the_card(card, tmp_path):
    pb, feeds, shapes = _tiny()
    cpu = import_tf_graph(pb, shapes, OUTS, device="cpu")
    path = str(tmp_path / "bert.fb")
    cpu.sd.save_flatbuffers(path)
    loaded = load_samediff_fb(path, device="cuda")
    imp = import_tf_graph(pb, shapes, OUTS, device="cuda")
    names = [imp.outputs[o + ":0"] for o in OUTS]
    ph = {imp.inputs[k + ":0"]: v for k, v in feeds.items()}
    a, b = imp.sd.output(ph, names), loaded.output(ph, names)
    for n in names:
        assert b[n].torch().is_cuda
        assert torch.equal(a[n].torch(), b[n].torch())
