"""Op executioner config: profiling modes and the OpProfiler aggregate.

Counterpart of ``deeplearning4j_tpu/ops/executioner.py`` (the reference's
``DefaultOpExecutioner`` profiling hooks, ``OpExecutioner.ProfilingMode``
and ``OpProfiler``). The hooks apply to eager execution by name
(``exec_op``): the debugging path, where a panic mode checks every
output (one host sync an op, by design) and ``OPERATIONS`` times each op
to its end on the card.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

import torch


class ProfilingMode:
    DISABLED = "DISABLED"
    NAN_PANIC = "NAN_PANIC"
    INF_PANIC = "INF_PANIC"
    ANY_PANIC = "ANY_PANIC"
    OPERATIONS = "OPERATIONS"   # timing aggregation


class OpProfiler:
    """Per-op-name timing aggregation (reference OpProfiler.getInstance)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._times: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @classmethod
    def get_instance(cls) -> "OpProfiler":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = OpProfiler()
        return cls._instance

    def record(self, op_name: str, seconds: float):
        with self._lock:
            self._times[op_name] += seconds
            self._counts[op_name] += 1

    def reset(self):
        with self._lock:
            self._times.clear()
            self._counts.clear()

    def stats(self):
        with self._lock:
            return sorted(
                ({"op": n, "total_seconds": self._times[n],
                  "invocations": self._counts[n],
                  "avg_us": 1e6 * self._times[n] / self._counts[n]}
                 for n in self._times),
                key=lambda d: -d["total_seconds"])

    def print_out_dashboard(self, log_fn=print):
        log_fn(f"{'op':<30} {'calls':>8} {'total ms':>10} {'avg us':>10}")
        for s in self.stats():
            log_fn(f"{s['op']:<30} {s['invocations']:>8} "
                   f"{1e3 * s['total_seconds']:>10.2f} {s['avg_us']:>10.1f}")


_mode = ProfilingMode.DISABLED


def set_profiling_mode(mode: str):
    """Reference Nd4j.getExecutioner().setProfilingMode(...)."""
    global _mode
    _mode = mode


def get_profiling_mode() -> str:
    return _mode


def _tensors(result):
    if isinstance(result, (tuple, list)):
        return [r for r in result if isinstance(r, torch.Tensor)]
    return [result] if isinstance(result, torch.Tensor) else []


def check_result(op_name: str, result):
    """Panic-mode output validation (DefaultOpExecutioner NaN/Inf checks)."""
    for x in _tensors(result):
        if not (x.is_floating_point() or x.is_complex()):
            continue
        if _mode in (ProfilingMode.NAN_PANIC, ProfilingMode.ANY_PANIC) \
                and bool(torch.isnan(x).any()):
            raise FloatingPointError(f"NaN detected in output of {op_name!r}")
        if _mode in (ProfilingMode.INF_PANIC, ProfilingMode.ANY_PANIC) \
                and bool(torch.isinf(x).any()):
            raise FloatingPointError(f"Inf detected in output of {op_name!r}")


def wrap_execution(op_name: str, fn, args, kwargs):
    """exec_op hook: timing and panic checks per the active mode."""
    if _mode == ProfilingMode.DISABLED:
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    if _mode == ProfilingMode.OPERATIONS:
        if any(t.is_cuda for t in _tensors(result)):
            torch.cuda.synchronize()
        OpProfiler.get_instance().record(op_name, time.perf_counter() - t0)
    else:
        check_result(op_name, result)
    return result
