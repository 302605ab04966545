"""NDArray: the eager tensor type of the layer API.

Counterpart of ``deeplearning4j_tpu/ndarray/ndarray.py`` (the reference's
INDArray / BaseNDArray), over a ``torch.Tensor``. ``.torch()`` hands back
the tensor where the JAX package's ``.jax()`` hands back its array, and
``.numpy()`` a host copy (bf16 widened to float32).

The reference's views write through to their parent. A torch tensor is
mutable, so the JAX package's copy-on-write machinery and its host
staging of element writes are not needed here:

- an NDArray owns a tensor; "in-place" methods (``addi``, ``assign``,
  ``put_scalar`` ...) write into it, or rebind it when the result's
  shape or dtype differs;
- a *view* records ``(parent, index)``: reads index the parent lazily,
  writes go through ``parent[index] = value``, so basic and fancy
  indices write through alike.

Host data (numpy arrays, lists, scalars) lands on ``device``, the CPU
unless the caller names another; a tensor stays where it lives.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..common.dtype import DataType

Index = Any


def _unwrap(x):
    return x.torch() if isinstance(x, NDArray) else x


def as_tensor(data, dtype=None, device=None) -> torch.Tensor:
    """``data`` as a tensor: tensors keep their device (cast to
    ``dtype`` if given), host data goes to ``device`` (default CPU)."""
    dt = DataType.from_any(dtype).torch if dtype is not None else None
    if isinstance(data, NDArray):
        data = data.torch()
    if isinstance(data, torch.Tensor):
        out = data if device is None else data.to(device)
        return out if dt is None or out.dtype == dt else out.to(dt)
    # a copy, as the JAX package's: the array never aliases host data
    return torch.tensor(np.asarray(data), dtype=dt, device=device or "cpu")


def _other(o, like: torch.Tensor):
    """A binary operand: NDArrays and numpy arrays as tensors on
    ``like``'s device; Python scalars pass through."""
    o = _unwrap(o)
    if isinstance(o, np.ndarray):
        return torch.tensor(o, device=like.device)
    if isinstance(o, torch.Tensor) and o.device != like.device:
        return o.to(like.device)
    return o


class NDArray:
    """Dense tensor wrapper with write-through views."""

    __slots__ = ("_buf", "_parent", "_index", "__weakref__")

    def __init__(self, data, dtype=None, *, device=None,
                 _parent: "NDArray" = None, _index: Index = None):
        if _parent is not None:
            self._buf = None  # read from the parent on access
            self._parent = _parent
            self._index = _index
        else:
            self._buf = as_tensor(data, dtype, device)
            self._parent = None
            self._index = None

    # -- buffer access --------------------------------------------------
    def torch(self) -> torch.Tensor:
        """The current tensor (a view indexes its parent's)."""
        if self._parent is not None:
            return self._parent.torch()[self._index]
        return self._buf

    def _set_buf(self, new: torch.Tensor) -> "NDArray":
        """Write-through: replace this array's contents. A view writes
        into its parent; a root writes in place when shape and dtype
        allow, else rebinds."""
        if self._parent is not None:
            self._parent.torch()[self._index] = new
        elif (new.shape == self._buf.shape and new.dtype == self._buf.dtype
              and new.device == self._buf.device):
            self._buf.copy_(new)
        else:
            self._buf = new
        return self

    # -- shape metadata (shapeInfo analog) -------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.torch().shape)

    @property
    def rank(self) -> int:
        return self.torch().dim()

    @property
    def ndim(self) -> int:
        return self.torch().dim()

    def length(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def size(self) -> int:
        return self.length()

    @property
    def dtype(self) -> DataType:
        return DataType.from_any(self.torch().dtype)

    @property
    def device(self) -> torch.device:
        return self.torch().device

    def data_type(self) -> DataType:
        return self.dtype

    def is_view(self) -> bool:
        return self._parent is not None

    def is_scalar(self) -> bool:
        return self.rank == 0 or self.length() == 1

    def is_vector(self) -> bool:
        return self.rank == 1 or (self.rank == 2 and 1 in self.shape)

    def is_matrix(self) -> bool:
        return self.rank == 2

    def rows(self) -> int:
        return self.shape[0]

    def columns(self) -> int:
        return self.shape[1]

    def size_at(self, dim: int) -> int:
        return self.shape[dim]

    # -- conversion ------------------------------------------------------
    def numpy(self) -> np.ndarray:
        t = self.torch().detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def to_list(self):
        return self.numpy().tolist()

    def item(self):
        return self.torch().item()

    def get_double(self, *indices) -> float:
        t = self.torch()
        return float(t[tuple(indices)] if indices else t)

    def get_int(self, *indices) -> int:
        t = self.torch()
        return int(t[tuple(indices)] if indices else t)

    def cast_to(self, dtype) -> "NDArray":
        return NDArray(self.torch().to(DataType.from_any(dtype).torch))

    astype = cast_to

    # -- copies / views --------------------------------------------------
    def dup(self) -> "NDArray":
        """Detached copy (reference ``INDArray.dup()``)."""
        return NDArray(self.torch().clone())

    def detach(self) -> "NDArray":
        return self.dup()

    def __getitem__(self, index) -> "NDArray":
        """Strided view; writes through to this array."""
        return NDArray(None, _parent=self, _index=_index_on(index,
                                                            self.device))

    def __setitem__(self, index, value):
        t = self.torch()
        v = _other(value, t)
        index = _index_on(index, t.device)
        if self._parent is None:
            t[index] = v
        else:
            t = t.clone()
            t[index] = v
            self._set_buf(t)

    def get(self, *indices) -> "NDArray":
        return self[tuple(indices)]

    def put(self, index, value) -> "NDArray":
        self[index] = value
        return self

    def put_scalar(self, indices, value) -> "NDArray":
        if not isinstance(indices, (tuple, list)):
            indices = (indices,)
        self[tuple(indices)] = value
        return self

    putScalar = put_scalar

    def assign(self, other) -> "NDArray":
        """In-place overwrite (broadcasts), reference ``INDArray.assign``."""
        t = self.torch()
        v = torch.as_tensor(_other(other, t), dtype=t.dtype, device=t.device)
        return self._set_buf(torch.broadcast_to(v, t.shape).clone())

    # -- shape ops -------------------------------------------------------
    def reshape(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(self.torch().reshape(shape))

    def ravel(self) -> "NDArray":
        return NDArray(self.torch().reshape(-1))

    def flatten(self) -> "NDArray":
        return self.ravel()

    def transpose(self, *axes) -> "NDArray":
        t = self.torch()
        if not axes:
            return NDArray(t.permute(*reversed(range(t.dim()))))
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return NDArray(t.permute(*axes))

    def permute(self, *axes) -> "NDArray":
        return self.transpose(*axes)

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def swap_axes(self, a: int, b: int) -> "NDArray":
        return NDArray(torch.swapaxes(self.torch(), a, b))

    def broadcast_to(self, shape) -> "NDArray":
        return NDArray(torch.broadcast_to(self.torch(), tuple(shape)))

    def repeat(self, repeats, axis=None) -> "NDArray":
        t = self.torch()
        if axis is None:
            t = t.reshape(-1)
            axis = 0
        return NDArray(torch.repeat_interleave(t, repeats, dim=axis))

    def tile(self, reps) -> "NDArray":
        reps = (reps,) if isinstance(reps, int) else tuple(reps)
        return NDArray(torch.tile(self.torch(), reps))

    def squeeze(self, axis=None) -> "NDArray":
        t = self.torch()
        return NDArray(t.squeeze() if axis is None else t.squeeze(axis))

    def expand_dims(self, axis: int) -> "NDArray":
        return NDArray(self.torch().unsqueeze(axis))

    # -- arithmetic (functional) ----------------------------------------
    def _binary(self, other, fn) -> "NDArray":
        t = self.torch()
        return NDArray(fn(t, _other(other, t)))

    def __add__(self, o): return self._binary(o, torch.add)
    def __radd__(self, o): return self._binary(o, lambda a, b: b + a)
    def __sub__(self, o): return self._binary(o, torch.sub)
    def __rsub__(self, o): return self._binary(o, lambda a, b: b - a)
    def __mul__(self, o): return self._binary(o, torch.mul)
    def __rmul__(self, o): return self._binary(o, lambda a, b: b * a)
    def __truediv__(self, o): return self._binary(o, torch.true_divide)
    def __rtruediv__(self, o): return self._binary(o, lambda a, b: b / a)
    def __pow__(self, o): return self._binary(o, torch.pow)
    def __mod__(self, o): return self._binary(o, torch.remainder)
    def __neg__(self): return NDArray(-self.torch())
    def __abs__(self): return NDArray(torch.abs(self.torch()))
    def __matmul__(self, o): return self.mmul(o)

    # reference-style names
    def add(self, o): return self.__add__(o)
    def sub(self, o): return self.__sub__(o)
    def mul(self, o): return self.__mul__(o)
    def div(self, o): return self.__truediv__(o)
    def rsub(self, o): return self.__rsub__(o)
    def rdiv(self, o): return self.__rtruediv__(o)
    def neg(self): return self.__neg__()

    # in-place variants (addi/subi/muli/divi/rsubi/rdivi/negi)
    def _inplace(self, o, fn):
        t = self.torch()
        return self._set_buf(fn(t, _other(o, t)))

    def addi(self, o): return self._inplace(o, lambda a, b: a + b)
    def subi(self, o): return self._inplace(o, lambda a, b: a - b)
    def muli(self, o): return self._inplace(o, lambda a, b: a * b)
    def divi(self, o): return self._inplace(o, lambda a, b: a / b)
    def rsubi(self, o): return self._inplace(o, lambda a, b: b - a)
    def rdivi(self, o): return self._inplace(o, lambda a, b: b / a)
    def negi(self): return self._set_buf(-self.torch())

    # -- comparisons -----------------------------------------------------
    def __lt__(self, o): return self._binary(o, torch.lt)
    def __le__(self, o): return self._binary(o, torch.le)
    def __gt__(self, o): return self._binary(o, torch.gt)
    def __ge__(self, o): return self._binary(o, torch.ge)

    def eq(self, o): return self._binary(o, torch.eq)
    def neq(self, o): return self._binary(o, torch.ne)
    def lt(self, o): return self.__lt__(o)
    def gt(self, o): return self.__gt__(o)
    def lte(self, o): return self.__le__(o)
    def gte(self, o): return self.__ge__(o)

    def __eq__(self, o):  # noqa: D105 - numpy-style elementwise equality
        if isinstance(o, (NDArray, torch.Tensor, np.ndarray, int, float,
                          bool)):
            return self.eq(o)
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (NDArray, torch.Tensor, np.ndarray, int, float,
                          bool)):
            return self.neq(o)
        return NotImplemented

    __hash__ = None  # mutable wrapper

    def equals(self, o, eps: float = 1e-5) -> bool:
        """Value equality with tolerance (reference ``INDArray.equals``)."""
        a = self.torch()
        o = torch.as_tensor(_other(o, a), device=a.device)
        if tuple(o.shape) != self.shape:
            return False
        if a.is_floating_point():
            return bool(torch.all(torch.abs(a - o.to(a.dtype)) <= eps))
        return bool(torch.all(a == o))

    # -- linalg ----------------------------------------------------------
    def mmul(self, other) -> "NDArray":
        return self._binary(other, torch.matmul)

    def dot(self, other) -> "NDArray":
        a = self.torch()
        b = _other(other, a)
        if a.dim() == 1 and b.dim() == 1:
            return NDArray(torch.dot(a, b))
        return NDArray(torch.matmul(a, b))

    def mmuli(self, other) -> "NDArray":
        t = self.torch()
        return self._set_buf(torch.matmul(t, _other(other, t)))

    # -- reductions ------------------------------------------------------
    def _axes(self, dims):
        if not dims:
            return None
        return tuple(d if d >= 0 else d + self.rank for d in dims)

    def _reduce(self, fn, dims, keepdims=False) -> "NDArray":
        t = self.torch()
        axis = self._axes(dims)
        if axis is None:
            out = fn(t, dim=tuple(range(t.dim())), keepdim=keepdims) \
                if t.dim() else t
        else:
            out = fn(t, dim=axis, keepdim=keepdims)
        return NDArray(out)

    def sum(self, *dims, keepdims=False): return self._reduce(torch.sum, dims, keepdims)
    def mean(self, *dims, keepdims=False): return self._reduce(torch.mean, dims, keepdims)
    def max(self, *dims, keepdims=False): return self._reduce(torch.amax, dims, keepdims)
    def min(self, *dims, keepdims=False): return self._reduce(torch.amin, dims, keepdims)

    def prod(self, *dims, keepdims=False):
        t = self.torch()
        axes = self._axes(dims) or tuple(range(t.dim()))
        for a in sorted(axes, reverse=True):
            t = torch.prod(t, dim=a, keepdim=keepdims)
        return NDArray(t)

    def std(self, *dims, bias_corrected: bool = True, keepdims=False):
        return NDArray(torch.std(self.torch(), dim=self._axes(dims),
                                 correction=1 if bias_corrected else 0,
                                 keepdim=keepdims))

    def var(self, *dims, bias_corrected: bool = True, keepdims=False):
        return NDArray(torch.var(self.torch(), dim=self._axes(dims),
                                 correction=1 if bias_corrected else 0,
                                 keepdim=keepdims))

    def argmax(self, *dims):
        return NDArray(torch.argmax(self.torch(),
                                    dim=dims[0] if dims else None))

    def argmin(self, *dims):
        return NDArray(torch.argmin(self.torch(),
                                    dim=dims[0] if dims else None))

    def cumsum(self, axis=None):
        t = self.torch()
        return NDArray(torch.cumsum(t.reshape(-1) if axis is None else t,
                                    dim=0 if axis is None else axis))

    def cumprod(self, axis=None):
        t = self.torch()
        return NDArray(torch.cumprod(t.reshape(-1) if axis is None else t,
                                     dim=0 if axis is None else axis))

    def norm1(self, *dims):
        return NDArray(torch.sum(torch.abs(self.torch()),
                                 dim=self._axes(dims)))

    def norm2(self, *dims):
        t = self.torch()
        return NDArray(torch.sqrt(torch.sum(t * t, dim=self._axes(dims))))

    def norm_max(self, *dims):
        t = torch.abs(self.torch())
        axes = self._axes(dims)
        return NDArray(torch.amax(t) if axes is None
                       else torch.amax(t, dim=axes))

    normmax = norm_max

    def sum_number(self) -> float: return float(torch.sum(self.torch()))
    def mean_number(self) -> float: return float(torch.mean(self.torch()))
    def max_number(self) -> float: return float(torch.max(self.torch()))
    def min_number(self) -> float: return float(torch.min(self.torch()))

    def std_number(self, bias_corrected: bool = True) -> float:
        return float(torch.std(self.torch(),
                               correction=1 if bias_corrected else 0))

    def norm2_number(self) -> float:
        return float(torch.sqrt(torch.sum(self.torch() ** 2)))

    def norm1_number(self) -> float:
        return float(torch.sum(torch.abs(self.torch())))

    # -- rows/cols (reference getRow/getColumn etc.) ---------------------
    def get_row(self, i: int) -> "NDArray":
        return self[i]

    def get_column(self, i: int) -> "NDArray":
        return self[:, i]

    def get_rows(self, idx) -> "NDArray":
        t = self.torch()
        return NDArray(t[torch.as_tensor(idx, device=t.device)])

    def get_columns(self, idx) -> "NDArray":
        t = self.torch()
        return NDArray(t[:, torch.as_tensor(idx, device=t.device)])

    def put_row(self, i: int, row) -> "NDArray":
        self[i] = row
        return self

    def put_column(self, i: int, col) -> "NDArray":
        self[:, i] = col
        return self

    def add_row_vector(self, v): return self._binary(v, lambda a, b: a + b)

    def add_column_vector(self, v):
        t = self.torch()
        return NDArray(t + _other(v, t).reshape(-1, 1))

    def mul_row_vector(self, v): return self._binary(v, lambda a, b: a * b)

    def mul_column_vector(self, v):
        t = self.torch()
        return NDArray(t * _other(v, t).reshape(-1, 1))

    def sub_row_vector(self, v): return self._binary(v, lambda a, b: a - b)
    def div_row_vector(self, v): return self._binary(v, lambda a, b: a / b)

    # -- misc ------------------------------------------------------------
    def is_nan(self) -> "NDArray": return NDArray(torch.isnan(self.torch()))
    def is_inf(self) -> "NDArray": return NDArray(torch.isinf(self.torch()))

    def any_nan(self) -> bool: return bool(torch.any(torch.isnan(self.torch())))
    def any_inf(self) -> bool: return bool(torch.any(torch.isinf(self.torch())))

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 1

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.length() != 1:
            raise ValueError("truth value of multi-element NDArray is ambiguous")
        return bool(self.torch())

    def __float__(self): return float(self.torch())
    def __int__(self): return int(self.torch())

    def __repr__(self):
        return (f"NDArray(shape={self.shape}, "
                f"dtype={self.dtype.name.lower()})\n{self.numpy()}")

    def __str__(self):
        return str(self.numpy())


def _index_on(index, device):
    """An index whose array parts (numpy arrays, lists of ints, NDArrays)
    are tensors on ``device``, as torch's advanced indexing wants."""
    def one(p):
        p = _unwrap(p)
        if isinstance(p, np.ndarray) or (isinstance(p, list) and p and
                                         not isinstance(p[0], slice)):
            return torch.as_tensor(np.asarray(p), device=device)
        if isinstance(p, torch.Tensor) and p.device != device:
            return p.to(device)
        return p
    if isinstance(index, tuple):
        return tuple(one(p) for p in index)
    return one(index)
