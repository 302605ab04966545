"""Shape, gather / scatter and layout ops.

Counterpart of ``deeplearning4j_tpu/ops/shape_ops.py`` (the reference's
``headers/shape.h`` and the gather / scatter / slice / stack families of
``parity_ops.h``). Index arguments may arrive as int32 (the JAX
package's index type) and are widened where PyTorch needs int64; shape
and index results are int32. ``scatter_*`` write out of place (the
``.at[]`` semantics): duplicate indices accumulate for add / subtract /
multiply / divide / max / min.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ._util import dtype_of, i32, ints
from .registry import op


def _long(idx, device):
    t = torch.as_tensor(idx, device=device)
    return t if t.dtype == torch.int64 else t.long()


def _norm_axis(axis, ndim):
    return axis + ndim if axis < 0 else axis


def _shape_tensor(shape, like=None):
    dev = like.device if like is not None else None
    return torch.tensor(list(shape), dtype=torch.int32, device=dev)


op("reshape", "shape")(lambda x, shape: torch.reshape(x, ints(shape)))
op("reshapeas", "shape")(lambda x, y: torch.reshape(x, y.shape))
op("flatten", "shape")(lambda *xs: torch.cat([x.reshape(-1) for x in xs]))
op("flatten_2d", "shape")(lambda x, axis=1: torch.reshape(
    x, (math.prod(x.shape[:axis]), -1)))


@op("transpose", "shape")
def transpose(x, axes=None):
    if axes is None:
        return x.permute(tuple(reversed(range(x.dim()))))
    return x.permute(ints(axes))


op("permute", "shape")(lambda x, axes: x.permute(ints(axes)))


@op("squeeze", "shape")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=ints(axis))


@op("expand_dims", "shape")
def expand_dims(x, axis):
    ax = ints(axis)
    nd = x.dim() + len(ax)
    for a in sorted(_norm_axis(a, nd) for a in ax):
        x = x.unsqueeze(a)
    return x


op("broadcast_to", "shape")(
    lambda x, shape: torch.broadcast_to(x, ints(shape)))
op("tile", "shape")(lambda x, reps: torch.tile(x, ints(reps)))
op("tile_to_shape", "shape")(
    lambda x, shape: torch.broadcast_to(x, ints(shape)))


@op("repeat", "shape")
def repeat(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor) and repeats.dim() > 0:
        repeats = repeats.to(x.device).long()
    elif not isinstance(repeats, int):
        repeats = torch.as_tensor(repeats, device=x.device).long()
        if repeats.dim() == 0:
            repeats = int(repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


op("concat", "shape")(lambda *xs, axis=0: torch.cat(xs, dim=axis))
op("stack", "shape", aliases=("parallel_stack",))(
    lambda *xs, axis=0: torch.stack(xs, dim=axis))
op("unstack", "shape")(lambda x, axis=0: list(torch.unbind(x, dim=axis)))


@op("split", "shape")
def split(x, num, axis=0):
    if isinstance(num, int):
        if x.shape[axis] % num:
            raise ValueError(f"array split does not result in an equal "
                             f"division ({x.shape[axis]} by {num})")
        return list(torch.tensor_split(x, num, dim=axis))
    return list(torch.tensor_split(x, list(ints(num)), dim=axis))


op("split_v", "shape")(
    lambda x, sizes, axis=0: list(torch.split(x, list(ints(sizes)),
                                              dim=axis)))
op("tear", "shape")(lambda x, axis=0: list(torch.unbind(x, dim=axis)))
op("reverse", "shape")(lambda x, dims=None: torch.flip(
    x, dims=ints(dims) if dims is not None else tuple(range(x.dim()))))
op("roll", "shape")(lambda x, shift, axis=None: torch.roll(
    x, ints(shift) if axis is not None else int(ints(shift)[0]),
    dims=ints(axis) if axis is not None else None))
op("order", "shape", differentiable=False)(lambda x, order="c": x)

op("rank", "shape", differentiable=False)(
    lambda x: torch.tensor(x.dim(), dtype=torch.int32, device=x.device))
op("shape_of", "shape", differentiable=False, aliases=("shape",))(
    lambda x: _shape_tensor(x.shape, x))
op("shapes_of", "shape", differentiable=False)(
    lambda *xs: [_shape_tensor(x.shape, x) for x in xs])
op("size", "shape", differentiable=False)(
    lambda x: torch.tensor(x.numel(), dtype=torch.int32, device=x.device))
op("size_at", "shape", differentiable=False)(
    lambda x, dim: torch.tensor(x.shape[int(dim)], dtype=torch.int32,
                                device=x.device))
op("set_shape", "shape", differentiable=False)(
    lambda x, shape: torch.reshape(x, ints(shape)))


@op("evaluate_reduction_shape", "shape", differentiable=False)
def evaluate_reduction_shape(shape, dims, keep_dims=False):
    dims = set(ints(dims))
    s = ints(shape)
    out = ([1 if i in dims else v for i, v in enumerate(s)] if keep_dims
           else [v for i, v in enumerate(s) if i not in dims])
    return _shape_tensor(out, shape if isinstance(shape, torch.Tensor)
                         else None)


@op("broadcast_dynamic_shape", "shape", differentiable=False)
def broadcast_dynamic_shape(a, b):
    return _shape_tensor(torch.broadcast_shapes(ints(a), ints(b)),
                         a if isinstance(a, torch.Tensor) else None)


@op("eye", "shape", differentiable=False)
def eye(rows, cols=None, batch_shape=None, dtype="float32"):
    rows = int(rows)
    cols = int(cols) if cols is not None else rows
    e = torch.eye(rows, cols, dtype=dtype_of(dtype))
    return torch.broadcast_to(e, tuple(ints(batch_shape or ())) + (rows, cols))


def _value_dtype(value, dtype):
    if dtype is not None:
        return dtype_of(dtype)
    if isinstance(value, torch.Tensor):
        return value.dtype
    if isinstance(value, bool):
        return torch.bool
    return torch.int32 if isinstance(value, int) else torch.float32


op("fill", "shape", differentiable=False)(
    lambda shape, value, dtype=None: torch.full(
        ints(shape), value.item() if isinstance(value, torch.Tensor)
        else value, dtype=_value_dtype(value, dtype)))
op("create", "shape", differentiable=False)(
    lambda shape, dtype="float32": torch.zeros(ints(shape),
                                               dtype=dtype_of(dtype)))


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@op("range", "shape", differentiable=False)
def range_op(start, limit=None, delta=1, dtype=None):
    start, limit, delta = _scalar(start), _scalar(limit), _scalar(delta)
    if limit is None:
        start, limit = 0, start
    if dtype is None:
        ints_only = all(isinstance(v, int) for v in (start, limit, delta))
        dt = torch.int32 if ints_only else torch.float32
    else:
        dt = dtype_of(dtype)
    return torch.arange(start, limit, delta, dtype=dt)


op("lin_space", "shape", differentiable=False)(
    lambda start, stop, num: torch.linspace(float(_scalar(start)),
                                            float(_scalar(stop)),
                                            int(_scalar(num))))
op("meshgrid", "shape")(
    lambda *xs, indexing="xy": list(torch.meshgrid(*xs, indexing=indexing)))


@op("onehot", "shape", differentiable=False)
def onehot(indices, depth, on_value=1.0, off_value=0.0, axis=-1,
           dtype="float32"):
    depth = int(depth)
    hot = (indices.unsqueeze(-1).long()
           == torch.arange(depth, device=indices.device)).to(dtype_of(dtype))
    if axis != -1 and axis != indices.dim():
        hot = torch.movedim(hot, -1, axis)
    return hot * (on_value - off_value) + off_value


@op("sequence_mask", "shape", differentiable=False)
def sequence_mask(lengths, maxlen=None, dtype="bool"):
    maxlen = int(maxlen) if maxlen is not None else int(lengths.max())
    ar = torch.arange(maxlen, device=lengths.device)
    return (ar[None, :] < lengths[..., None]).to(dtype_of(dtype))


@op("reverse_sequence", "shape")
def reverse_sequence(x, seq_lengths, seq_axis=1, batch_axis=0):
    xm = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
    t = xm.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    n = seq_lengths.to(x.device).long()[:, None]
    src = torch.where(idx < n, n - 1 - idx, idx)
    src = src.reshape(src.shape + (1,) * (xm.dim() - 2)).expand(xm.shape)
    return torch.movedim(torch.gather(xm, 1, src), (0, 1),
                         (batch_axis, seq_axis))


# -- gather / scatter ---------------------------------------------------
def take(x, indices, axis=0):
    """``jnp.take`` along ``axis``: out-of-line indices of any shape,
    negative ones counted from the end."""
    idx = _long(indices, x.device)
    axis = _norm_axis(int(axis), x.dim())
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


op("gather", "gather")(take)


def _nd_index(indices, device):
    idx = _long(indices, device)
    return tuple(idx.unbind(-1))


op("gather_nd", "gather")(lambda x, indices: x[_nd_index(indices, x.device)])
op("embedding_lookup", "gather")(
    lambda params, ids, *a, **k: take(params, ids, axis=0))


@op("invert_permutation", "gather", differentiable=False)
def invert_permutation(p):
    out = torch.empty_like(p)
    return out.scatter_(0, p.long(), torch.arange(p.shape[0], dtype=p.dtype,
                                                  device=p.device))


_REDUCE = {"multiply": "prod", "max": "amax", "min": "amin"}


def _scatter_rows(ref, idx, updates, method):
    """``ref.at[idx].<method>(updates)`` with ``idx`` indexing axis 0."""
    idx = _long(idx, ref.device)
    target_shape = idx.shape + ref.shape[1:]
    upd = torch.broadcast_to(torch.as_tensor(updates, device=ref.device)
                             .to(ref.dtype), target_shape)
    flat_idx = idx.reshape(-1)
    flat_upd = upd.reshape((-1,) + ref.shape[1:])
    flat_idx = torch.where(flat_idx < 0, flat_idx + ref.shape[0], flat_idx)
    if method == "set":
        return ref.index_put((flat_idx,), flat_upd, accumulate=False)
    if method == "add":
        return ref.index_put((flat_idx,), flat_upd, accumulate=True)
    if method == "subtract":
        return ref.index_put((flat_idx,), -flat_upd, accumulate=True)
    if method == "divide":
        method, flat_upd = "multiply", 1.0 / flat_upd
    return ref.index_reduce(0, flat_idx, flat_upd, _REDUCE[method],
                            include_self=True)


def _scatter(method):
    def f(ref, indices, updates):
        return _scatter_rows(ref, indices, updates, method)
    return f


op("scatter_add", "scatter")(_scatter("add"))
op("scatter_sub", "scatter")(_scatter("subtract"))
op("scatter_mul", "scatter")(_scatter("multiply"))
op("scatter_div", "scatter")(_scatter("divide"))
op("scatter_max", "scatter")(_scatter("max"))
op("scatter_min", "scatter")(_scatter("min"))
op("scatter_upd", "scatter", aliases=("scatter_update",))(_scatter("set"))


def _scatter_nd_into(ref, indices, updates, method):
    idx = _long(indices, ref.device)
    k = idx.shape[-1]
    lead = ref.shape[:k]
    strides = torch.tensor([math.prod(lead[i + 1:]) for i in range(k)],
                           dtype=torch.int64, device=ref.device)
    lin = (idx * strides).sum(-1)
    flat = ref.reshape((math.prod(lead),) + ref.shape[k:])
    out = _scatter_rows(flat, lin, updates, method)
    return out.reshape(ref.shape)


@op("scatter_nd", "scatter")
def scatter_nd(indices, updates, shape):
    ref = torch.zeros(ints(shape), dtype=updates.dtype, device=updates.device)
    return _scatter_nd_into(ref, indices, updates, "add")


@op("scatter_nd_add", "scatter")
def scatter_nd_add(ref, indices, updates):
    return _scatter_nd_into(ref, indices, updates, "add")


@op("scatter_nd_sub", "scatter")
def scatter_nd_sub(ref, indices, updates):
    return _scatter_nd_into(ref, indices, updates, "subtract")


@op("scatter_nd_update", "scatter")
def scatter_nd_update(ref, indices, updates):
    return _scatter_nd_into(ref, indices, updates, "set")


@op("scatter_nd_max", "scatter")
def scatter_nd_max(ref, indices, updates):
    return _scatter_nd_into(ref, indices, updates, "max")


@op("scatter_nd_min", "scatter")
def scatter_nd_min(ref, indices, updates):
    return _scatter_nd_into(ref, indices, updates, "min")


# -- slicing ------------------------------------------------------------
@op("slice", "shape")
def slice_op(x, begin, size):
    begin = ints(begin)
    size = [x.shape[i] - begin[i] if int(s) == -1 else int(s)
            for i, s in enumerate(ints(size))]
    return x[tuple(slice(b, b + s) for b, s in zip(begin, size))]


def _slice_dim(x, d, sl: slice):
    """``x`` sliced along axis ``d`` by a Python slice (negative steps
    included, which tensor indexing refuses)."""
    step = 1 if sl.step is None else int(sl.step)
    if step > 0:
        return x[(slice(None),) * d + (slice(sl.start, sl.stop, step),)]
    rng = range(*slice(sl.start, sl.stop, step).indices(x.shape[d]))
    return torch.index_select(x, d, torch.tensor(list(rng), dtype=torch.long,
                                                 device=x.device))


def _index(x, idx):
    """Numpy basic indexing (ints, slices of any step, None, Ellipsis)."""
    consuming = sum(1 for e in idx if e is not None and e is not Ellipsis)
    full = []
    for e in idx:
        if e is Ellipsis:
            full += [slice(None)] * (x.dim() - consuming)
        else:
            full.append(e)
    if Ellipsis not in idx:
        full += [slice(None)] * (x.dim() - consuming)
    d = 0
    for e in full:
        if e is None:
            x = x.unsqueeze(d)
            d += 1
        elif isinstance(e, slice):
            if (e.start, e.stop, e.step) not in ((None, None, None),
                                                 (None, None, 1)):
                x = _slice_dim(x, d, e)
            d += 1
        else:
            x = x.select(d, int(e))
    return x


@op("strided_slice", "shape")
def strided_slice(x, begin, end, strides=None):
    begin, end = ints(begin), ints(end)
    strides = ints(strides) if strides else (1,) * len(begin)
    return _index(x, tuple(slice(b, e, s)
                           for b, e, s in zip(begin, end, strides)))


@op("dynamic_partition", "shape", differentiable=False)
def dynamic_partition(x, partitions, num_partitions):
    return [x[partitions == i] for i in range(int(num_partitions))]


@op("dynamic_stitch", "shape")
def dynamic_stitch(indices, data):
    n = sum(int(i.numel()) for i in indices)
    tail = data[0].shape[indices[0].dim():]
    out = torch.zeros((n,) + tuple(tail), dtype=data[0].dtype,
                      device=data[0].device)
    for idx, d in zip(indices, data):
        out = out.index_put((idx.reshape(-1).long(),),
                            d.reshape((-1,) + tuple(tail)))
    return out


# -- space/depth layout -------------------------------------------------
@op("space_to_depth", "shape")
def space_to_depth(x, block_size, data_format="NHWC"):
    bs = int(block_size)
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    b, h, w, c = x.shape
    x = x.reshape(b, h // bs, bs, w // bs, bs, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // bs, w // bs, c * bs * bs)
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x


@op("depth_to_space", "shape")
def depth_to_space(x, block_size, data_format="NHWC"):
    bs = int(block_size)
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    b, h, w, c = x.shape
    oc = c // (bs * bs)
    x = x.reshape(b, h, w, bs, bs, oc)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * bs, w * bs, oc)
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x


def _block(block_shape):
    if isinstance(block_shape, int):
        return [block_shape] * 2
    return list(ints(block_shape))


def _pairs(v):
    rows = v.tolist() if isinstance(v, torch.Tensor) else v
    return [[int(c) for c in row] for row in rows]


@op("batch_to_space", "shape", aliases=("batch_to_space_nd",))
def batch_to_space(x, block_shape, crops):
    block_shape = _block(block_shape)
    crops = _pairs(crops)
    nblk = len(block_shape)
    nb = x.shape[0] // math.prod(block_shape)
    spatial = list(x.shape[1:1 + nblk])
    rem = list(x.shape[1 + nblk:])
    x = x.reshape(block_shape + [nb] + spatial + rem)
    perm = [nblk]
    for i in range(nblk):
        perm += [nblk + 1 + i, i]
    perm += list(range(2 * nblk + 1, x.dim()))
    x = x.permute(perm)
    new_spatial = [spatial[i] * block_shape[i] for i in range(nblk)]
    x = x.reshape([nb] + new_spatial + rem)
    idx = (slice(None),) + tuple(slice(c[0], x.shape[i + 1] - c[1])
                                 for i, c in enumerate(crops))
    return x[idx]


@op("space_to_batch", "shape", aliases=("space_to_batch_nd",))
def space_to_batch(x, block_shape, paddings):
    block_shape = _block(block_shape)
    paddings = _pairs(paddings)
    nblk = len(block_shape)
    x = pad(x, [(0, 0)] + [tuple(p) for p in paddings]
            + [(0, 0)] * (x.dim() - 1 - len(paddings)))
    b = x.shape[0]
    spatial = list(x.shape[1:1 + nblk])
    rem = list(x.shape[1 + nblk:])
    shape = [b]
    for i, s in enumerate(spatial):
        shape += [s // block_shape[i], block_shape[i]]
    x = x.reshape(shape + rem)
    perm = [2 + 2 * i for i in range(nblk)] + [0] \
        + [1 + 2 * i for i in range(nblk)] \
        + list(range(1 + 2 * nblk, x.dim()))
    x = x.permute(perm)
    return x.reshape([b * math.prod(block_shape)]
                     + [spatial[i] // block_shape[i] for i in range(nblk)]
                     + rem)


_PAD_MODES = {0: "CONSTANT", 1: "REFLECT", 2: "SYMMETRIC"}


@op("pad", "shape")
def pad(x, paddings, mode="CONSTANT", constant_values=0):
    pairs = [tuple(int(c) for c in row) for row in _pairs(paddings)]
    mode = mode.upper() if isinstance(mode, str) else _PAD_MODES[int(mode)]
    if mode == "CONSTANT":
        flat = []
        for lo, hi in reversed(pairs):  # F.pad takes the last axis first
            flat += [lo, hi]
        return F.pad(x, flat, value=_scalar(constant_values))
    # reflect / symmetric / edge: gather each axis by numpy's padded index
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            src = np.pad(np.arange(x.shape[d]), (lo, hi), mode=mode.lower())
            x = torch.index_select(x, d, torch.as_tensor(src,
                                                         device=x.device))
    return x


@op("mirror_pad", "shape")
def mirror_pad(x, paddings, mode="REFLECT"):
    return pad(x, paddings, mode=mode)


@op("unique", "shape", differentiable=False)
def unique(x):
    vals, inv = torch.unique(x.reshape(-1), sorted=True, return_inverse=True)
    fill = vals[:1].expand(x.numel() - vals.numel())
    return torch.cat([vals, fill]), i32(inv.reshape(x.shape))


@op("unique_with_counts", "shape", differentiable=False)
def unique_with_counts(x):
    vals, inv, counts = torch.unique(x.reshape(-1), sorted=True,
                                     return_inverse=True, return_counts=True)
    n = x.numel() - vals.numel()
    return (torch.cat([vals, vals[:1].expand(n)]), i32(inv.reshape(x.shape)),
            i32(torch.cat([counts, counts.new_zeros(n)])))


@op("listdiff", "shape", differentiable=False)
def listdiff(x, y):
    mask = ~torch.isin(x, y)
    return x[mask], i32(torch.nonzero(mask).reshape(-1))


op("diag", "shape")(lambda x: torch.diag(x) if x.dim() <= 1
                    else torch.diagflat(x))
op("diag_part", "shape")(lambda x: torch.diagonal(x, dim1=-2, dim2=-1))
op("matrix_diag", "shape")(lambda x: torch.diag_embed(x) if x.dim() > 1
                           else torch.diag(x))
op("matrix_diag_part", "shape")(lambda x: torch.diagonal(x, dim1=-2, dim2=-1))


@op("matrix_set_diag", "shape")
def matrix_set_diag(x, diagonal):
    n = min(x.shape[-2], x.shape[-1])
    return torch.diagonal_scatter(x, diagonal[..., :n].to(x.dtype),
                                  dim1=-2, dim2=-1)


op("tri", "shape", differentiable=False)(
    lambda rows, cols=None, k=0, dtype="float32": torch.tril(
        torch.ones(int(rows), int(cols if cols is not None else rows),
                   dtype=dtype_of(dtype)), int(k)))
op("triu", "shape")(lambda x, k=0: torch.triu(x, int(k)))
op("trace", "shape")(
    lambda x: torch.diagonal(x, dim1=-2, dim2=-1).sum(-1))


@op("bitcast", "shape", differentiable=False)
def bitcast(x, dtype):
    dt = dtype_of(dtype)
    src, dst = x.element_size(), torch.empty((), dtype=dt).element_size()
    if src == dst:
        return x.view(dt)
    if dst < src:   # a trailing axis of src / dst parts
        return x.unsqueeze(-1).view(dt).reshape(x.shape + (src // dst,))
    return x.contiguous().view(dt).squeeze(-1)


@op("assign", "shape")
def assign(x, y):
    y = torch.as_tensor(y, device=x.device)
    return torch.broadcast_to(y, x.shape).to(x.dtype)


@op("identity_n", "shape")
def identity_n(*xs):
    return list(xs)


@op("tf_strided_slice", "shape")
def tf_strided_slice(x, spec):
    """Strided slice with a pre-resolved static index spec: the lowering
    target of ``SDVariable.__getitem__`` (serializable, unlike a recorded
    function).

    spec: a sequence of ("slice", b, e, s) | ("int", i) | ("newaxis",) |
    ("ellipsis",) | ("all",) entries."""
    idx = []
    for entry in spec:
        kind = entry[0]
        if kind == "slice":
            b, e, s = entry[1:]
            idx.append(slice(b, e, s))
        elif kind == "int":
            idx.append(int(entry[1]))
        elif kind == "newaxis":
            idx.append(None)
        elif kind == "ellipsis":
            idx.append(Ellipsis)
        else:
            idx.append(slice(None))
    return _index(x, tuple(idx))
