"""String and compat ops (the reference's ``headers/strings.h`` and
``headers/compat.h``, with ``hashcode`` from ``transforms.h``).

Counterpart of ``deeplearning4j_tpu/ops/string_ops.py``. Torch has no
string type, so string tensors are host numpy object arrays, as they are
in the JAX package (and in libnd4j, whose utf8 ops run on the CPU
whatever the backend); numeric tensors are read from any device. All
results are host numpy values. ``hashcode`` keeps the JAX op's result,
including its use of Python's ``hash()`` on strings, which is salted by
``PYTHONHASHSEED`` and so differs from one interpreter to the next.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import op


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_str_array(x):
    return np.asarray(x, dtype=object)


def _split(s, delimiter):
    return str(s).split(delimiter) if delimiter else str(s).split()


@op("split_string", "strings", differentiable=False)
def split_string(x, delimiter=" "):
    """Splits each string; returns ``(values, row_lengths)``."""
    values, lengths = [], []
    for s in _as_str_array(x).ravel():
        parts = _split(s, delimiter)
        values.extend(parts)
        lengths.append(len(parts))
    return (np.asarray(values, object), np.asarray(lengths, np.int64))


@op("compat_string_split", "strings", differentiable=False)
def compat_string_split(x, delimiter=" "):
    """TF's StringSplit: ``(indices [N, 2], values, dense_shape)``."""
    arr = _as_str_array(x).ravel()
    indices, values = [], []
    max_cols = 0
    for r, s in enumerate(arr):
        parts = _split(s, delimiter)
        max_cols = max(max_cols, len(parts))
        for c, p in enumerate(parts):
            indices.append([r, c])
            values.append(p)
    return (np.asarray(indices, np.int64).reshape(-1, 2),
            np.asarray(values, object),
            np.asarray([len(arr), max_cols], np.int64))


@op("compat_sparse_to_dense", "strings", differentiable=False)
def compat_sparse_to_dense(indices, dense_shape, values, default_value=0):
    """Densifies COO ``indices`` [N, rank] of string or numeric values."""
    vals = _host(values)
    shape = tuple(int(s) for s in _host(dense_shape).reshape(-1))
    if vals.dtype == object:
        out = np.full(shape, default_value if isinstance(default_value, str)
                      else "", object)
    else:
        out = np.full(shape, default_value, vals.dtype)
    idx = _host(indices).reshape(-1, len(shape))
    for i, v in zip(idx, vals.ravel()):
        out[tuple(int(j) for j in i)] = v
    return out


@op("hashcode", "transforms", differentiable=False)
def hashcode(x):
    """The reference's Java-style content hash, as a host ``np.int64``:
    over the bytes of a numeric array, over ``hash(str(s))`` of each
    string of an object array."""
    data = _host(x).ravel()
    h = 1
    if data.dtype == object:
        for s in data:
            h = (31 * h + (hash(str(s)) & 0xFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
    else:
        for b in data.tobytes():
            h = (31 * h + b) & 0xFFFFFFFFFFFFFFFF
    if h >= 1 << 63:
        h -= 1 << 64
    return np.int64(h)
