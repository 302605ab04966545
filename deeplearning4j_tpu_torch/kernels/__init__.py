"""Hand-written Hopper kernels and the dispatch record.

Counterpart of ``deeplearning4j_tpu/kernels/__init__.py``. Each kernel is
CUDA C++ under ``csrc/`` (built at first use by ``_build``) with a wrapper
that launches it for CUDA tensors and a ``*_plain`` PyTorch version that
runs for CPU tensors:

- ``flash_attention`` / ``flash_attention_with_lse``: the forward kernel
  (``csrc/flash_attention_fwd.cu``) and the dq and dk/dv backward kernels
  (``csrc/flash_attention_bwd.cu``) behind ``torch.autograd.Function``s
  — BERT attention with ``use_flash`` and the CausalLM's
  ``forward(use_flash=True)``;
- ``paged_flash_decode``: the paged-KV attention read of every decode and
  speculative-verify step (``models.causal_lm.paged_decode``);
- ``quant.transforms.dequant_matmul``'s fused int8 branch
  (``csrc/dequant_matmul.cu``), the MLP matmuls of an int8 twin.

There the path was decided once per traced executable; here every eager
call decides, so the counters tick once per call. A captured CUDA graph
(``runtime/cuda_graphs.py``) decides once, at capture, and each replay
repeats the decision's records and the launch counts (``_counts``).
"""
from typing import Dict, Optional

from ..common.metrics import registry
from ._counts import deferred
from .flash_attention import (flash_attention, flash_attention_plain,
                              flash_attention_with_lse,
                              flash_attention_with_lse_plain)
from .paged_flash_decode import paged_flash_decode, paged_flash_decode_plain

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_with_lse", "flash_attention_with_lse_plain",
           "paged_flash_decode", "paged_flash_decode_plain",
           "attention_dispatch", "record_attention", "kernel_dispatch",
           "dispatch_snapshot"]

#: last path decision per kernel family — what
#: ``DecodeEngine.debug_snapshot`` reports
_last_dispatch: Dict[str, Dict[str, Optional[str]]] = {}


def kernel_dispatch(kernel: str, path: str, reason: str = "") -> str:
    """Record one kernel-vs-plain decision: ticks
    ``dl4j_kernel_dispatch_total{kernel,path}`` and updates the
    last-dispatch snapshot. ``reason`` says why the kernel was not taken
    (empty for the kernel path). Returns ``path``."""
    if deferred(kernel_dispatch, kernel, path, reason):
        return path       # a capture: each replay records it
    _last_dispatch[kernel] = {"kernel": kernel, "path": path,
                              "reason": reason or None}
    registry().counter(
        "dl4j_kernel_dispatch_total",
        "Hand-written-kernel vs plain-version path decisions per "
        "kernel family, one per call",
        labels=("kernel", "path")).labels(kernel=kernel, path=path).inc()
    return path


def dispatch_snapshot() -> Dict[str, Dict[str, Optional[str]]]:
    """Copy of the last decision per kernel family:
    ``{kernel: {"kernel", "path", "reason"}}``."""
    return {k: dict(v) for k, v in _last_dispatch.items()}


def _paged_path(pool):
    """"paged_flash" (the CUDA kernel) or "paged" (the gather read) plus
    the reason. Reads only the pool — never the query length — so the
    Q=1 decode step and the Q=k+1 speculative verify always share a
    path."""
    if pool is None:
        # gather-view callers (paged_prefill) hand over no pool
        return "paged", "caller provides no pool (gather-view path)"
    if pool.is_cuda:
        return "paged_flash", ""
    return "paged", f"{pool.device.type} pool (the kernel runs on CUDA)"


def record_attention(path: str, reason: str = "",
                     kernel: str = "attention") -> str:
    """Record one attention path decision: ticks
    ``dl4j_attn_dispatch_total{path}`` and
    ``dl4j_kernel_dispatch_total{kernel,path}``. Returns ``path``."""
    if deferred(record_attention, path, reason, kernel):
        return path       # a capture: each replay records it
    registry().counter(
        "dl4j_attn_dispatch_total",
        "Attention path decisions, one per call",
        labels=("path",)).labels(path=path).inc()
    return kernel_dispatch(kernel, path, reason)


def attention_dispatch(seq_len: int, paged: bool = False, *,
                       pool=None) -> str:
    """Attention path for one call that is not ``flash_attention``'s:
    "paged_flash" or "paged" for the paged-KV read (``paged=True``;
    decided by the pool's device, see :func:`_paged_path`), or "xla" for a
    query of fewer than 2 rows (the decode pin, which keeps a caller's own
    branch). A ``use_flash`` caller's dense attention over 2 or more rows
    is recorded by ``flash_attention`` itself, which alone chooses between
    the kernels and the plain version; asking here raises."""
    if paged:
        path, reason = _paged_path(pool)
    elif int(seq_len) < 2:
        path, reason = "xla", "seq_len<2 decode pin"
    else:
        raise ValueError(f"attention_dispatch: dense attention over "
                         f"{seq_len} rows is decided by flash_attention")
    return record_attention(path, reason,
                            "paged_decode" if paged else "attention")
