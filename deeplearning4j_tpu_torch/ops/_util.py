"""Small helpers shared by the op families.

The JAX package runs with 64-bit types off: an op asked for float64,
int64 or uint64 gives float32, int32 or uint32, and integer results
(indices, counts, shapes) are int32. :func:`dtype_of` and :func:`i32`
give the port's ops the same result types.
"""
from __future__ import annotations

import numpy as np
import torch

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _NARROW[torch.uint64] = torch.uint32


def narrow(dt: torch.dtype) -> torch.dtype:
    """``dt`` with 64-bit types narrowed to 32 bits."""
    return _NARROW.get(dt, dt)


def dtype_of(d):
    """A dtype argument (a name, a ``DataType``, a torch or numpy dtype,
    a JAX-style dtype class, or a tensor or array standing for its own
    dtype, as ``jnp.dtype`` reads one) as a torch dtype, 64-bit types
    narrowed; None stays None."""
    if d is None:
        return None
    if isinstance(d, (torch.Tensor, np.ndarray)):
        d = d.dtype
    if isinstance(d, torch.dtype):
        return narrow(d)
    from ..common.dtype import DataType
    name = getattr(d, "__name__", None) if isinstance(d, type) else None
    return narrow(DataType.from_any(name or str(d)).torch)


def i32(t: torch.Tensor) -> torch.Tensor:
    """An int64 result as int32 (the JAX package's index type)."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def axes(dims):
    """A reduction's ``dims`` as a tuple of ints, or None for all."""
    if dims is None or dims == () or dims == []:
        return None
    if isinstance(dims, int):
        return (dims,)
    if isinstance(dims, torch.Tensor):
        return tuple(int(d) for d in dims.reshape(-1).tolist())
    return tuple(int(d) for d in dims)


def all_dims(x: torch.Tensor, ax):
    return tuple(range(x.dim())) if ax is None else ax


def tensor_like(v, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar or array-like as a tensor on ``like``'s device (a
    tensor stays as it is)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=like.device)


def ints(v):
    """A shape-like (list, tuple, tensor, int) as a tuple of ints."""
    if isinstance(v, torch.Tensor):
        return tuple(int(s) for s in v.reshape(-1).tolist())
    if isinstance(v, (list, tuple)):
        return tuple(int(s) for s in v)
    return (int(v),)


def generator(key, device=None) -> torch.Generator:
    """A generator for an op's ``key``: a ``torch.Generator`` as it is,
    an int (or 0-d tensor) seed on ``device`` (else the key tensor's
    device, else the default device)."""
    if isinstance(key, torch.Generator):
        return key
    if device is None and isinstance(key, torch.Tensor):
        device = key.device
    dev = torch.device(device) if device is not None \
        else torch.get_default_device()
    return torch.Generator(device=dev).manual_seed(int(key))


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [tree_map(fn, v) for v in tree]
        return seq if isinstance(tree, list) else tuple(seq)
    return fn(tree)
