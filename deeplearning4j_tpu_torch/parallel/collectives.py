"""Collective communication over the axes of a :class:`~..common.mesh.Mesh`.

Counterpart of ``deeplearning4j_tpu/parallel/collectives.py``: the same
names (``all_reduce_sum``, ``all_reduce_mean``, ``all_gather``,
``reduce_scatter``, ``ppermute_next``, ``all_to_all``, ``axis_index``,
``axis_size``, ``broadcast_from``), each over the process group of one
mesh axis (or a tuple of axes, the first major); ``broadcast_raw`` is
the plain broadcast the sharded serving engines send their steps with. The mesh is the
``mesh=`` argument or the innermost ``with mesh:``; outside both they
raise, as the JAX ones do outside ``shard_map``.

**Gradients.** Each is differentiable through a
``torch.autograd.Function`` whose backward is the transpose that JAX
gives it inside ``shard_map`` with ``check_vma=False``: ``psum`` <->
``psum``, ``all_gather`` <-> ``psum_scatter``, ``ppermute`` <-> the
reverse ``ppermute``, ``all_to_all`` <-> the swapped ``all_to_all``.
That transpose assumes every rank's loss is its *part* of the global
loss (JAX divides a replicated output's cotangent among the devices):
a rank that backpropagates a replicated global loss gets its gradients
scaled by the size of the axes the loss was reduced over, which the
callers divide out. ``parallel/pipeline.py``'s ``tp_copy`` /
``tp_reduce`` are the Megatron pair for a loss replicated over
``tensor``.

**Transport.** Under NCCL the tensors go as they are. Under gloo a
CUDA tensor is staged through host memory (and bf16 / f16 travel as
f32: gloo's reductions do not take them); :func:`transport` names the
route a group takes, and :data:`issued` counts each collective by op and
backend. The staging is chosen by the backend and the tensor's device,
never by catching an error, and never runs under NCCL.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from ..common.mesh import Mesh, current_mesh

#: collectives issued, by ``(op, backend)`` (identity calls on a
#: one-rank axis without a group are not counted)
issued: collections.Counter = collections.Counter()


def _dist():
    import torch.distributed as dist
    return dist


def _resolve(axis, mesh: Optional[Mesh]):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("collectives run over a mesh: pass mesh= or "
                           "call inside `with mesh:`")
    return mesh, mesh.group(axis), mesh.group_ranks(axis)


def backend_of(group) -> Optional[str]:
    return None if group is None else str(_dist().get_backend(group))


def transport(group, device) -> str:
    """``"local"`` (no group), ``"nccl"``, ``"gloo"`` (CPU tensors) or
    ``"gloo-host-staged"`` (CUDA tensors through host memory)."""
    b = backend_of(group)
    if b is None:
        return "local"
    if b == "gloo" and torch.device(device).type == "cuda":
        return "gloo-host-staged"
    return b


def _stage(x: torch.Tensor, group):
    """A fresh buffer of ``x`` the backend takes, and how to undo it."""
    if backend_of(group) == "gloo":
        dt = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
            else x.dtype
        return (x.detach().to("cpu", dt, copy=True).contiguous(),
                (x.device, x.dtype))
    return x.detach().clone(memory_format=torch.contiguous_format), None


def _unstage(t: torch.Tensor, info):
    return t if info is None else t.to(info[0], info[1])


def _count(op, group):
    issued[(op, backend_of(group))] += 1


def _group_order(ranks):
    """Position in the backend's (sorted-rank) order of each rank in
    axis-index order."""
    srt = sorted(ranks)
    return [srt.index(r) for r in ranks]


# -- raw collectives (no autograd) ------------------------------------------

def all_reduce_raw(x, axis, mesh=None):
    mesh, g, ranks = _resolve(axis, mesh)
    if g is None:
        return x
    t, info = _stage(x, g)
    _dist().all_reduce(t, group=g)
    _count("all_reduce", g)
    return _unstage(t, info)


def broadcast_raw(x, axis, mesh=None, root: int = 0):
    """Axis index ``root``'s ``x`` on every member of ``axis`` (one
    ``broadcast``); every member passes a tensor of the same shape and
    dtype, the others' values are not read."""
    mesh, g, ranks = _resolve(axis, mesh)
    if g is None:
        return x
    t, info = _stage(x, g)
    _dist().broadcast(t, src=ranks[root], group=g)
    _count("broadcast", g)
    return _unstage(t, info)


def all_gather_raw(x, axis, mesh=None, dim: int = 0, tiled: bool = True):
    """The shards of ``axis`` concatenated along ``dim`` in axis-index
    order (``tiled=False``: stacked on a new ``dim``)."""
    mesh, g, ranks = _resolve(axis, mesh)
    if g is None:
        return x if tiled else x.unsqueeze(dim)
    t, info = _stage(x, g)
    parts = [torch.empty_like(t) for _ in ranks]
    _dist().all_gather(parts, t, group=g)
    _count("all_gather", g)
    order = _group_order(ranks)
    parts = [parts[i] for i in order]
    out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
    return _unstage(out, info)


def reduce_scatter_raw(x, axis, mesh=None, dim: int = 0):
    """``psum_scatter``: the sum over ``axis``, this rank's chunk of
    ``dim`` (an all-reduce, then the chunk)."""
    mesh, g, ranks = _resolve(axis, mesh)
    n = len(ranks)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    s = all_reduce_raw(x, axis, mesh)
    return s.chunk(n, dim)[mesh.axis_index(axis)].contiguous()


def ppermute_raw(x, axis, mesh=None, shift: int = 1):
    """Axis index ``i`` sends ``x`` to ``(i + shift) % n`` and receives
    from ``(i - shift) % n``."""
    mesh, g, ranks = _resolve(axis, mesh)
    n = len(ranks)
    if g is None or n == 1 or shift % n == 0:
        return x
    d = _dist()
    i = mesh.axis_index(axis)
    t, info = _stage(x, g)
    out = torch.empty_like(t)
    ops = [d.P2POp(d.isend, t, ranks[(i + shift) % n], g),
           d.P2POp(d.irecv, out, ranks[(i - shift) % n], g)]
    for req in d.batch_isend_irecv(ops):
        req.wait()
    _count("ppermute", g)
    return _unstage(out, info)


def all_to_all_raw(x, axis, mesh=None, split_axis: int = 0,
                   concat_axis: int = 0):
    """Tiled ``all_to_all``: chunk ``j`` of ``split_axis`` goes to axis
    index ``j``; the received chunks concatenate along ``concat_axis``
    in axis-index order (through an all-gather of the chunks)."""
    mesh, g, ranks = _resolve(axis, mesh)
    n = len(ranks)
    if g is None:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide over {n} ranks")
    every = all_gather_raw(x, axis, mesh, dim=0, tiled=False)
    i = mesh.axis_index(axis)
    mine = [every[j].chunk(n, split_axis)[i] for j in range(n)]
    return torch.cat(mine, concat_axis).contiguous()


def all_reduce_tree(tensors, axis, mesh=None):
    """The sum over ``axis`` of a list of tensors, in one all-reduce per
    dtype (the flattened tensors concatenated)."""
    mesh, g, _ = _resolve(axis, mesh)
    if g is None:
        return list(tensors)
    out = list(tensors)
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = all_reduce_raw(flat, axis, mesh)
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


# -- differentiable collectives -----------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return all_reduce_raw(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.axis, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim, tiled):
        ctx.axis, ctx.mesh, ctx.dim, ctx.tiled = axis, mesh, dim, tiled
        return all_gather_raw(x, axis, mesh, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        if not ctx.tiled:
            s = all_reduce_raw(g, ctx.axis, ctx.mesh)
            gx = s.select(ctx.dim, ctx.mesh.axis_index(ctx.axis))
        else:
            gx = reduce_scatter_raw(g, ctx.axis, ctx.mesh, ctx.dim)
        return gx, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.axis, ctx.mesh, ctx.dim = axis, mesh, dim
        return reduce_scatter_raw(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.axis, ctx.mesh, ctx.dim), None, None, \
            None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, shift):
        ctx.axis, ctx.mesh, ctx.shift = axis, mesh, shift
        return ppermute_raw(x, axis, mesh, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw(g, ctx.axis, ctx.mesh, -ctx.shift), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_axis, concat_axis):
        ctx.args = (axis, mesh, concat_axis, split_axis)
        return all_to_all_raw(x, axis, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, *ctx.args), None, None, None, None


def _mesh(axis, mesh):
    return _resolve(axis, mesh)[0]


def all_reduce_sum(x, axis, mesh: Optional[Mesh] = None):
    """Dense all-reduce (``lax.psum``)."""
    return _AllReduce.apply(x, axis, _mesh(axis, mesh))


def all_reduce_mean(x, axis, mesh: Optional[Mesh] = None):
    m = _mesh(axis, mesh)
    return all_reduce_sum(x, axis, m) / m.axis_size(axis)


def all_gather(x, axis, *, gather_axis: int = 0, tiled: bool = True,
               mesh: Optional[Mesh] = None):
    return _AllGather.apply(x, axis, _mesh(axis, mesh), gather_axis, tiled)


def reduce_scatter(x, axis, *, scatter_axis: int = 0,
                   mesh: Optional[Mesh] = None):
    return _ReduceScatter.apply(x, axis, _mesh(axis, mesh), scatter_axis)


def ppermute_next(x, axis, shift: int = 1, mesh: Optional[Mesh] = None):
    """Rotate shards around the ring (ring attention's K/V rotation)."""
    return _Ppermute.apply(x, axis, _mesh(axis, mesh), shift)


def all_to_all(x, axis, split_axis: int, concat_axis: int,
               mesh: Optional[Mesh] = None):
    """DeepSpeed-Ulysses style sequence<->head exchange (tiled)."""
    return _AllToAll.apply(x, axis, _mesh(axis, mesh), split_axis,
                           concat_axis)


def axis_index(axis, mesh: Optional[Mesh] = None) -> int:
    return _mesh(axis, mesh).axis_index(axis)


def axis_size(axis, mesh: Optional[Mesh] = None) -> int:
    return _mesh(axis, mesh).axis_size(axis)


def broadcast_from(x, axis, root: int = 0, mesh: Optional[Mesh] = None):
    """Root's shard on every member of ``axis`` (``psum`` of the masked
    shard, as the JAX package writes it, so its gradient is the psum's
    on the root and 0 elsewhere)."""
    m = _mesh(axis, mesh)
    # a product, not a fresh zeros tensor: every rank keeps x in its
    # graph, so every rank runs the backward's all-reduce
    masked = x * float(m.axis_index(axis) == root)
    return all_reduce_sum(masked, axis, m)
