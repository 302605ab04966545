"""The process-wide environment object ``get_environment()`` returns.

Counterpart of ``deeplearning4j_tpu/common/config.py`` (the reference's
``Nd4j.getEnvironment()``): one singleton whose attributes are snapshots
of the layered properties (``common/environment.py``: override >
environment variable > default), taken once and runtime-mutable as plain
attributes. Attributes it does not set resolve on the layered
``Environment``, so the serving knobs and the dispatch census are reached
through it too.
"""
from __future__ import annotations

import threading


class Environment:
    """Process-wide knobs (``Nd4j.getEnvironment()`` analog)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        from .environment import Environment as _Layered
        lay = _Layered.get()
        self.debug = lay.is_debug()
        self.verbose = lay.is_verbose()
        self.default_float_dtype = lay.default_float_dtype()
        self.matmul_precision = lay.matmul_precision()
        self.nan_panic = lay.nan_panic()
        self.inf_panic = lay.inf_panic()
        self.profiling = lay.profiling_enabled()
        self.max_threads = lay.max_threads()
        self.eager_jit = lay.eager_jit()

    @classmethod
    def get(cls) -> "Environment":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = Environment()
        return cls._instance

    def __getattr__(self, name):
        # only reached for names __init__ did not set
        from .environment import Environment as _Layered
        try:
            return getattr(_Layered.get(), name)
        except AttributeError:
            raise AttributeError(
                f"{type(self).__name__!r} object has no attribute {name!r}")


def get_environment() -> Environment:
    return Environment.get()
