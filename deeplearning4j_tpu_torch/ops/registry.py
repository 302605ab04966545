"""Op registry: name -> op lookup with coverage accounting.

Counterpart of ``deeplearning4j_tpu/ops/registry.py`` (the reference's
``OpRegistrator``). An op is a plain function over tensors; the registry
exists for name-parity accounting against the reference's declarable ops,
for the define-then-run graph (``autodiff.SameDiff`` records ops by name)
and for eager dispatch by name (``exec_op``).

Every op is registered under the JAX package's name, category,
``differentiable`` flag and aliases, and every name of the JAX registry
is registered here. An unknown name raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Sequence


@dataclasses.dataclass(frozen=True)
class OpDef:
    name: str
    fn: Callable
    category: str
    differentiable: bool = True
    aliases: tuple = ()


class OpRegistry:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._ops: Dict[str, OpDef] = {}
        self._executed: set = set()  # coverage accounting

    @classmethod
    def get(cls) -> "OpRegistry":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = OpRegistry()
        return cls._instance

    def register(self, opdef: OpDef):
        for key in (opdef.name, *opdef.aliases):
            if key in self._ops:
                raise ValueError(f"op already registered: {key}")
            self._ops[key] = opdef

    def lookup(self, name: str) -> OpDef:
        try:
            return self._ops[name]
        except KeyError:
            raise KeyError(f"unknown op: {name!r}") from None

    def has(self, name: str) -> bool:
        return name in self._ops

    def names(self) -> Sequence[str]:
        return sorted({d.name for d in self._ops.values()})

    def by_category(self, category: str):
        return sorted({d.name for d in self._ops.values()
                       if d.category == category})

    def categories(self):
        return sorted({d.category for d in self._ops.values()})

    def mark_executed(self, name: str):
        self._executed.add(name)

    def coverage(self):
        """(executed, total): OpValidation-style coverage accounting."""
        all_names = set(self.names())
        return sorted(self._executed & all_names), sorted(all_names)

    def __len__(self):
        return len({d.name for d in self._ops.values()})


def op(name: str, category: str, differentiable: bool = True,
       aliases: Sequence[str] = ()):
    """Decorator registering a plain tensor function as a named op."""
    def deco(fn: Callable):
        OpRegistry.get().register(OpDef(name=name, fn=fn, category=category,
                                        differentiable=differentiable,
                                        aliases=tuple(aliases)))
        return fn
    return deco


def exec_op(name: str, *args, **kwargs):
    """Eager execution by name (the reference's ``Nd4j.exec(CustomOp)``).

    Takes NDArrays or tensors; returns the raw tensor result(s). Honours
    the executioner's profiling mode (timing, NaN / Inf panics)."""
    from ..ndarray.ndarray import NDArray
    from . import executioner
    reg = OpRegistry.get()
    d = reg.lookup(name)
    reg.mark_executed(d.name)
    args = [a.torch() if isinstance(a, NDArray) else a for a in args]
    kwargs = {k: (v.torch() if isinstance(v, NDArray) else v)
              for k, v in kwargs.items()}
    return executioner.wrap_execution(d.name, d.fn, args, kwargs)
