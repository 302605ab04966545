"""Op registry: name -> op lookup with coverage accounting.

Counterpart of ``deeplearning4j_tpu/ops/registry.py`` (the reference's
``OpRegistrator``). An op is a plain function over tensors; the registry
exists for name-parity accounting against the reference's declarable ops,
for the define-then-run graph (``autodiff.SameDiff`` records ops by name)
and for eager dispatch by name (``exec_op``).

Every op is registered under the JAX package's name, category,
``differentiable`` flag and aliases. The op families the port has not
reached yet are listed in ``ops/pending.py``: :meth:`OpRegistry.has` is
true for such a name (so the ``sd.math`` / ``sd.nn`` namespaces resolve
it), and :meth:`OpRegistry.lookup` raises ``NotImplementedError`` naming
the ``ROADMAP.md`` item it waits for. An unknown name raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Sequence

from .pending import pending_item


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
        self._pending: Dict[str, str] = {}   # name -> family module
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

    def add_pending(self, name: str, family: str):
        """List ``name`` as an op of ``family`` still to be ported."""
        if name not in self._ops:
            self._pending[name] = family

    def lookup(self, name: str) -> OpDef:
        d = self._ops.get(name)
        if d is not None:
            return d
        family = self._pending.get(name)
        if family is not None:
            raise NotImplementedError(
                f"op {name!r} ({family}) is not ported yet; it waits for "
                f"ROADMAP.md queue 1 item {pending_item(family)}")
        raise KeyError(f"unknown op: {name!r}")

    def has(self, name: str) -> bool:
        return name in self._ops or name in self._pending

    def is_pending(self, name: str) -> bool:
        return name in self._pending

    def pending(self) -> Dict[str, str]:
        """name -> family of every op still to be ported."""
        return dict(self._pending)

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
