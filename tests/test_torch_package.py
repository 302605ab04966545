"""Package-level rules of the PyTorch port.

- No file of ``deeplearning4j_tpu_torch/`` and not ``chip_smoke.py``
  imports JAX or the JAX package (an AST scan of every import).
- Every public entry point runs on the card unless the caller passes
  ``device="cpu"``: the default is ``"cuda"``, and nothing falls back
  to the CPU.
- The paged decode read of a CPU pool, and the flash attention of a CPU
  tensor, take the plain path and say so in the dispatch counters.
"""
import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff.validation import TestCase
from deeplearning4j_tpu_torch.common.metrics import registry
from deeplearning4j_tpu_torch.kernels import (attention_dispatch,
                                              dispatch_snapshot,
                                              flash_attention,
                                              flash_attention_plain)
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, BenchmarkDataSetIterator)
from deeplearning4j_tpu_torch.models import bert, causal_lm
from deeplearning4j_tpu_torch.nn import serde
from deeplearning4j_tpu_torch.nn.earlystopping import LocalFileModelSaver
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.quant import transforms
from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.models_graph import YOLO2

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


#: the modules of the common/ and training-utility slice, of the
#: convolution slice and of the op tail with the per-op sweep, imported
#: in a fresh interpreter that must load neither JAX nor the JAX package
SLICE_MODULES = [
    "deeplearning4j_tpu_torch", "deeplearning4j_tpu_torch.common",
    "deeplearning4j_tpu_torch.common.config",
    "deeplearning4j_tpu_torch.common.faults",
    "deeplearning4j_tpu_torch.common.profile_analyzer",
    "deeplearning4j_tpu_torch.common.rng",
    "deeplearning4j_tpu_torch.datasets",
    "deeplearning4j_tpu_torch.datasets.fetchers",
    "deeplearning4j_tpu_torch.datasets.normalizers",
    "deeplearning4j_tpu_torch.datasets.record_iterator",
    "deeplearning4j_tpu_torch.nn.checkpoint",
    "deeplearning4j_tpu_torch.nn.earlystopping",
    "deeplearning4j_tpu_torch.nn.serde",
    "deeplearning4j_tpu_torch.nn.solvers",
    "deeplearning4j_tpu_torch.nn.transferlearning",
    "deeplearning4j_tpu_torch.zoo.base",
    "deeplearning4j_tpu_torch.ops.conv_ops",
    "deeplearning4j_tpu_torch.ops.image_ops",
    "deeplearning4j_tpu_torch.nn.conf.layers_extra",
    "deeplearning4j_tpu_torch.zoo.models_graph",
    "deeplearning4j_tpu_torch.ops.bitwise_ops",
    "deeplearning4j_tpu_torch.ops.compression",
    "deeplearning4j_tpu_torch.ops.segment_ops",
    "deeplearning4j_tpu_torch.ops.string_ops",
    "deeplearning4j_tpu_torch.ops.list_ops",
    "deeplearning4j_tpu_torch.ops.linalg_ops",
    "deeplearning4j_tpu_torch.ops.parity_extra",
    "deeplearning4j_tpu_torch.ops.descriptors",
    "deeplearning4j_tpu_torch.benchmarks.opbench",
]


def test_slice_modules_load_no_jax_at_run_time():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


ENTRY_POINTS = [
    causal_lm.CausalLM.__init__,
    causal_lm.init_params,
    causal_lm.init_kv_cache,
    causal_lm.init_paged_kv_cache,
    DecodeEngine.__init__,
    transforms.quantize_model,
    bridge.params_from_numpy,
    bridge.tensor_from_numpy,
    bert.init_params,
    bert.init_qa_params,
    MultiLayerNetwork.__init__,
    ZooModel.init_model,
    AsyncDataSetIterator.__init__,
    SameDiff.__init__,
    SameDiff.create,
    SameDiff.load,
    TestCase.__init__,
    MultiLayerNetwork.load,
    ComputationGraph.load,
    serde.restore_multilayer,
    serde.restore_computation_graph,
    serde.restore_model,
    ZooModel.init_pretrained,
    BenchmarkDataSetIterator.__init__,
    LocalFileModelSaver.__init__,
    YOLO2.init_model,
]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_no_silent_cpu_fallback_without_a_card():
    """Without ``device=`` the model is made on the card; where there is
    none, that fails instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds")
    with pytest.raises((RuntimeError, AssertionError)):
        causal_lm.CausalLM(causal_lm.CausalLMConfig.tiny())


def test_cpu_pool_dispatches_to_the_plain_paged_read():
    fam = registry().counter(
        "dl4j_kernel_dispatch_total",
        "Hand-written-kernel vs plain-version path decisions per "
        "kernel family, one per call", labels=("kernel", "path"))
    child = fam.labels(kernel="paged_decode", path="paged")
    before = child.value()
    pool = torch.zeros(3, 2, 4, 2, 8)
    for q_len in (1, 4):        # the decision never reads Q
        assert attention_dispatch(q_len, paged=True, pool=pool) == "paged"
    assert child.value() == before + 2
    snap = dispatch_snapshot()["paged_decode"]
    assert snap["path"] == "paged" and "cpu" in snap["reason"]


def test_cpu_tensor_dispatches_to_the_plain_flash_version():
    """``flash_attention`` on CPU tensors takes the plain version, with
    no sequence-length threshold, and records that choice itself; the
    decode pin is the only dense decision left to ``attention_dispatch``."""
    fam = registry().counter(
        "dl4j_kernel_dispatch_total",
        "Hand-written-kernel vs plain-version path decisions per "
        "kernel family, one per call", labels=("kernel", "path"))
    child = fam.labels(kernel="attention", path="plain")
    before = child.value()
    for seq_len in (2, 128, 1000):
        q = torch.randn((1, seq_len, 1, 8))
        assert torch.equal(flash_attention(q, q, q),
                           flash_attention_plain(q, q, q))
    assert child.value() == before + 3
    snap = dispatch_snapshot()["attention"]
    assert snap["path"] == "plain" and "cpu" in snap["reason"]
    assert attention_dispatch(1) == "xla"
    with pytest.raises(ValueError):
        attention_dispatch(128)
    # the BERT forward records its choice once per layer
    cfg = bert.BertConfig.tiny()
    params = bert.init_params(cfg, device="cpu")
    before = child.value()
    bert.encode(params, torch.zeros((1, 8), dtype=torch.long), config=cfg,
                use_flash=True)
    assert child.value() == before + cfg.num_layers
