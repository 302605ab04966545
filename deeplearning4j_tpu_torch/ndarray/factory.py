"""Array factory: the ``Nd4j`` static-factory analog.

Counterpart of ``deeplearning4j_tpu/ndarray/factory.py`` (the reference's
``Nd4j.java``). Arrays are made on the CPU, as the port's ``NDArray``
makes host data; a SameDiff graph or a network moves them to its own
device. As in the JAX package (64-bit types off), a float or int array
made without a dtype is float32 or int32.

The process-global RNG is a CPU ``torch.Generator`` (the reference's
``Nd4j.getRandom()``): the random constructors draw from it, or from
``key`` (an int seed, ``common/rng.py``) when one is given, so that eager
creation is convenient and deterministic under ``set_seed``.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.dtype import DataType
from .ndarray import NDArray, _unwrap, as_tensor

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


class _GlobalRng:
    """Stateful RNG facade (the reference's NativeRandom)."""

    def __init__(self, seed: int = 119):  # reference default seed
        self._lock = threading.Lock()
        self._gen = torch.Generator()
        self.set_seed(seed)

    def set_seed(self, seed: int):
        with self._lock:
            self._gen.manual_seed(int(seed))
            self._seed = int(seed)

    def get_seed(self) -> int:
        return self._seed

    def generator(self) -> torch.Generator:
        return self._gen


_rng = _GlobalRng()


def get_random() -> _GlobalRng:
    return _rng


def set_seed(seed: int):
    _rng.set_seed(seed)


def _dt(dtype) -> Optional[torch.dtype]:
    return DataType.from_any(dtype).torch if dtype is not None else None


def _shape(args) -> tuple:
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        return tuple(int(s) for s in args[0])
    return tuple(int(s) for s in args)


def _gen(key) -> torch.Generator:
    if key is None:
        return _rng.generator()
    return torch.Generator().manual_seed(int(key))


def _t(a) -> torch.Tensor:
    """An NDArray, tensor or array-like as a tensor (host data narrowed
    to 32 bits)."""
    t = _unwrap(a)
    if isinstance(t, torch.Tensor):
        return t
    t = as_tensor(t)
    return t.to(_NARROW.get(t.dtype, t.dtype))


# -- creation -----------------------------------------------------------

def create(data, dtype=None) -> NDArray:
    if dtype is not None:
        return NDArray(data, dtype=dtype)
    return NDArray(_t(data))


def zeros(*shape, dtype="float32") -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=_dt(dtype)))


def ones(*shape, dtype="float32") -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=_dt(dtype)))


def full(shape, value, dtype="float32") -> NDArray:
    return NDArray(torch.full(_shape((shape,)), value, dtype=_dt(dtype)))


def value_array_of(shape, value, dtype="float32") -> NDArray:
    return full(shape, value, dtype)


def zeros_like(a) -> NDArray:
    return NDArray(torch.zeros_like(_t(a)))


def ones_like(a) -> NDArray:
    return NDArray(torch.ones_like(_t(a)))


def eye(n, m=None, dtype="float32") -> NDArray:
    return NDArray(torch.eye(n, m if m is not None else n, dtype=_dt(dtype)))


def arange(*args, dtype=None) -> NDArray:
    dt = _dt(dtype)
    if dt is None:
        dt = torch.int32 if all(isinstance(a, (int, np.integer))
                                for a in args) else torch.float32
    return NDArray(torch.arange(*args, dtype=dt))


def linspace(start, stop, num, dtype="float32") -> NDArray:
    return NDArray(torch.linspace(start, stop, num, dtype=_dt(dtype)))


def scalar(value, dtype=None) -> NDArray:
    return create(value, dtype)


def empty(dtype="float32") -> NDArray:
    """Zero-length array (reference empty-shape semantics)."""
    return NDArray(torch.zeros((0,), dtype=_dt(dtype)))


def from_numpy(a: np.ndarray) -> NDArray:
    return create(a)


# -- random -------------------------------------------------------------

def rand(*shape, dtype="float32", key=None) -> NDArray:
    return NDArray(torch.rand(_shape(shape), generator=_gen(key),
                              dtype=_dt(dtype)))


def randn(*shape, dtype="float32", key=None) -> NDArray:
    return NDArray(torch.randn(_shape(shape), generator=_gen(key),
                               dtype=_dt(dtype)))


def randint(low, high, shape, dtype="int32", key=None) -> NDArray:
    return NDArray(torch.randint(low, high, _shape((shape,)),
                                 generator=_gen(key), dtype=_dt(dtype)))


def bernoulli(p, shape, dtype="float32", key=None) -> NDArray:
    u = torch.rand(_shape((shape,)), generator=_gen(key))
    return NDArray((u < p).to(_dt(dtype)))


def shuffle(a, key=None) -> NDArray:
    t = _t(a)
    perm = torch.randperm(t.shape[0], generator=_gen(key)).to(t.device)
    return NDArray(t[perm])


# -- combining ----------------------------------------------------------

def concat(arrays: Sequence, axis: int = 0) -> NDArray:
    return NDArray(torch.cat([_t(a) for a in arrays], dim=axis))


def hstack(arrays) -> NDArray:
    return NDArray(torch.hstack([_t(a) for a in arrays]))


def vstack(arrays) -> NDArray:
    return NDArray(torch.vstack([_t(a) for a in arrays]))


def stack(arrays, axis: int = 0) -> NDArray:
    return NDArray(torch.stack([_t(a) for a in arrays], dim=axis))


def pile(arrays) -> NDArray:
    return stack(arrays, axis=0)


def tear(a, axis: int = 0):
    arr = _t(a)
    return [NDArray(x) for x in torch.split(arr, 1, dim=axis)]


def split(a, n_or_sections, axis: int = 0):
    arr = _t(a)
    if isinstance(n_or_sections, int) and arr.shape[axis] % n_or_sections:
        raise ValueError(f"array split does not result in an equal division"
                         f" ({arr.shape[axis]} by {n_or_sections})")
    sections = n_or_sections if isinstance(n_or_sections, int) \
        else list(n_or_sections)
    return [NDArray(x) for x in torch.tensor_split(arr, sections, dim=axis)]


def where(cond, x=None, y=None):
    c = _t(cond)
    c = c if c.dtype == torch.bool else c != 0
    if x is None:
        return tuple(NDArray(i.to(torch.int32)) for i in torch.where(c))
    return NDArray(torch.where(c, _t(x), _t(y)))


def sort(a, axis: int = -1, descending: bool = False) -> NDArray:
    r = torch.sort(_t(a), dim=axis, stable=True).values
    if descending:
        r = torch.flip(r, dims=(axis,))
    return NDArray(r)


def argsort(a, axis: int = -1, descending: bool = False) -> NDArray:
    r = torch.argsort(_t(a), dim=axis, stable=True).to(torch.int32)
    if descending:
        r = torch.flip(r, dims=(axis,))
    return NDArray(r)


def diag(a) -> NDArray:
    return NDArray(torch.diag(_t(a)))


def pad(a, pad_width, mode="constant", constant_values=0) -> NDArray:
    from ..ops.shape_ops import pad as pad_op
    t = _t(a)
    if isinstance(pad_width, int):
        pad_width = [(pad_width, pad_width)] * t.dim()
    return NDArray(pad_op(t, pad_width, mode=mode.upper(),
                          constant_values=constant_values))


def flip(a, *axes) -> NDArray:
    t = _t(a)
    return NDArray(torch.flip(t, dims=tuple(axes) if axes
                              else tuple(range(t.dim()))))


def roll(a, shift, axis=None) -> NDArray:
    return NDArray(torch.roll(_t(a), shift, dims=axis))


def gather(a, indices, axis: int = 0) -> NDArray:
    from ..ops.shape_ops import take
    return NDArray(take(_t(a), _t(indices), axis=axis))


def one_hot(indices, depth: int, dtype="float32") -> NDArray:
    from ..ops.shape_ops import onehot
    return NDArray(onehot(_t(indices), depth, dtype=dtype))
