"""Pipeline parallelism over the mesh's ``pipe`` axis, and Megatron's
tensor-parallel f/g pair.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. Stages lie
along ``pipe``: rank ``s`` of a pipe group holds stage ``s``'s params
(the stage-stacked leaves' slice, leading dim 1) and activations hop
stage to stage as a send/recv pair on the pipe group
(``collectives.ppermute_raw``, ``batch_isend_irecv``).

- :func:`pipeline_apply` — a pipelined forward (GPipe schedule,
  ``n_micro + S - 1`` steps), the outputs broadcast from the last stage.
- :func:`make_pipeline_loss` (GPipe) and :func:`make_pipeline_loss_1f1b`
  build ``loss(stage_params, head_params, x, aux) -> (global loss sum,
  global weight)``, differentiable in the stage params (this rank's
  stage), the head params and ``x``. ``x`` and ``aux`` are global (every
  rank the same); each microbatch is sharded over the data axes as the
  JAX package's ``P(None, (data, fsdp))`` shards it, and the returned
  sums are over every microbatch and data rank. The gradients come back
  as the JAX package's custom VJP gives them: the stage grads summed
  over the data axes, the head grads over pipe and data, ``dx`` global.
- Both backwards are hand-scheduled (a ``torch.autograd.Function``, no
  autograd across ranks): GPipe runs every forward, keeping each stage
  input, then every backward in reverse (stash grows with ``n_micro``);
  1F1B interleaves, forward of microbatch j at t = j + s and backward
  of u at t = u + 2(S-1) - s, recomputing each stage forward from its
  stashed input and keeping at most 2(S-1-s) + 1 of them on stage s.
  The forward pass itself is a loss-only GPipe run that keeps nothing.
  Both give the same numbers.
- :func:`tp_copy` / :func:`tp_reduce` — identity forward with a psum
  backward, and psum forward with an identity backward: the pair that
  makes a loss replicated over ``tensor`` differentiate right inside a
  stage (a plain psum's transpose would count the cotangent ``tp``
  times).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..common.mesh import DATA, FSDP, PIPE, current_mesh
from ..models._optim import tree_leaves, tree_unflatten
from . import collectives as C


# -- Megatron's f and g ---------------------------------------------------------

class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce_raw(g, ctx.axis, ctx.mesh), None, None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return C.all_reduce_raw(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _mesh_of(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("pass mesh= or call inside `with mesh:`")
    return mesh


def tp_copy(x, axis: str, mesh=None):
    """Megatron's *f*: identity forward, psum backward — where a
    replicated activation fans out into per-shard tensor-parallel
    compute."""
    return _TpCopy.apply(x, axis, _mesh_of(mesh))


def tp_reduce(x, axis: str, mesh=None):
    """Megatron's *g*: psum forward, identity backward — the row-parallel
    matmul's reduction."""
    return _TpReduce.apply(x, axis, _mesh_of(mesh))


# -- helpers ----------------------------------------------------------------------

def stack_stage_params(per_stage_params: Sequence):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim."""
    leaves = [tree_leaves(t) for t in per_stage_params]
    return tree_unflatten(per_stage_params[0],
                          [torch.stack(xs) for xs in zip(*leaves)])


def split_stages(items: Sequence, n_stages: int):
    """Split a layer list into n_stages contiguous groups (must divide)."""
    if len(items) % n_stages != 0:
        raise ValueError(f"{len(items)} layers not divisible into "
                         f"{n_stages} stages")
    per = len(items) // n_stages
    return [list(items[i * per:(i + 1) * per]) for i in range(n_stages)]


def _unstack(tree):
    """This rank's stage params without the leading (size 1) stage dim."""
    return tree_unflatten(tree, [x[0] for x in tree_leaves(tree)])


def _data_axes(mesh, batch_axes):
    return tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)


def _microbatch(x, n_micro, mesh, data_axes):
    """Global [B, ...] -> this rank's [n_micro, mb/dp, ...]: microbatch j
    is rows j*mb:(j+1)*mb, sharded over the data axes."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not divide into {n_micro} "
                         "microbatches")
    xm = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    if data_axes:
        n = mesh.axis_size(data_axes)
        if xm.shape[1] % n:
            raise ValueError(f"microbatch of {xm.shape[1]} rows does not "
                             f"divide over {n} data ranks")
        w = xm.shape[1] // n
        i = mesh.axis_index(data_axes)
        xm = xm[:, i * w:(i + 1) * w]
    return xm


def _tree_micro(tree, n_micro, mesh, data_axes):
    if isinstance(tree, dict):
        return {k: _tree_micro(v, n_micro, mesh, data_axes)
                for k, v in tree.items()}
    return _microbatch(tree, n_micro, mesh, data_axes)


def _tree_index(tree, j):
    if isinstance(tree, dict):
        return {k: _tree_index(v, j) for k, v in tree.items()}
    return tree[j]


def _send_next(y, axis, mesh):
    return C.ppermute_raw(y, axis, mesh, 1)


def _send_prev(g, axis, mesh):
    return C.ppermute_raw(g, axis, mesh, -1)


# -- the forward-only pipeline ---------------------------------------------------------

def pipeline_apply(stage_fn: Callable, stacked_params, inputs, mesh,
                   n_microbatches: int, axis: str = PIPE):
    """A pipelined forward: ``stage_fn(stage_params, x) -> y`` (shape
    kept), ``stacked_params`` this rank's stage (leading dim 1),
    ``inputs`` global ``[B, ...]`` (every rank the same). Returns the
    last stage's ``[B, ...]`` on every rank. No gradient."""
    S, s = mesh.axis_size(axis), mesh.axis_index(axis)
    params = _unstack(stacked_params)
    B = inputs.shape[0]
    if B % n_microbatches:
        raise ValueError("batch must divide into microbatches")
    xm = inputs.reshape((n_microbatches, B // n_microbatches)
                        + tuple(inputs.shape[1:]))
    outputs = torch.zeros_like(xm)
    incoming = torch.zeros_like(xm[0])
    with torch.no_grad():
        for t in range(n_microbatches + S - 1):
            j = t - s
            x = xm[min(max(t, 0), n_microbatches - 1)] if s == 0 \
                else incoming
            y = stage_fn(params, x)
            if s == S - 1 and 0 <= j < n_microbatches:
                outputs[j] = y
            incoming = _send_next(y, axis, mesh)
        mask = float(s == S - 1)
        out = C.all_reduce_raw(outputs * mask, axis, mesh)
    return out.reshape((B,) + tuple(out.shape[2:]))


# -- the differentiable pipeline losses -------------------------------------------------

def _detached(leaves):
    return [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]


class _Schedule:
    """One rank's view of a pipeline loss: its stage, its microbatches
    and the two passes."""

    def __init__(self, stage_fn, head_fn, mesh, n_micro, axis, batch_axes,
                 stage_tree, head_tree, x, aux):
        self.stage_fn, self.head_fn = stage_fn, head_fn
        self.mesh, self.axis, self.n_micro = mesh, axis, n_micro
        self.data_axes = _data_axes(mesh, batch_axes)
        self.S, self.s = mesh.axis_size(axis), mesh.axis_index(axis)
        self.stage_tree, self.head_tree = stage_tree, head_tree
        self.xm = _microbatch(x.detach(), n_micro, mesh, self.data_axes)
        self.auxm = _tree_micro(aux, n_micro, mesh, self.data_axes)

    def stage(self, leaves, x):
        return self.stage_fn(_unstack(tree_unflatten(self.stage_tree,
                                                     leaves)), x)

    def head(self, leaves, y, j):
        return self.head_fn(tree_unflatten(self.head_tree, leaves), y,
                            _tree_index(self.auxm, j))

    def reduce_sums(self, loss_sum, wsum):
        pair = torch.stack([loss_sum, wsum])
        pair = C.all_reduce_raw(pair, (self.axis,) + self.data_axes,
                                self.mesh)
        return pair[0], pair[1]

    def forward(self, sp, hp):
        """The loss-only GPipe run: (global loss sum, global weight)."""
        S, s, n = self.S, self.s, self.n_micro
        dev = self.xm.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        wsum = torch.zeros((), dtype=torch.float32, device=dev)
        incoming = torch.zeros_like(self.xm[0])
        with torch.no_grad():
            for t in range(n + S - 1):
                x = self.xm[min(t, n - 1)] if s == 0 else incoming
                y = self.stage(sp, x)
                j = t - (S - 1)
                if s == S - 1 and 0 <= j < n:
                    l, w = self.head(hp, y, j)
                    loss_sum = loss_sum + l.float()
                    wsum = wsum + w.float()
                incoming = _send_next(y, self.axis, self.mesh)
        return self.reduce_sums(loss_sum, wsum)

    def _vjp_head(self, hp, y, j, gl, gw):
        hl = _detached(hp)
        yy = y.detach().requires_grad_(True)
        with torch.enable_grad():
            l, w = self.head(hl, yy, j)
            outs = [o for o in (l, w) if o.requires_grad]
            cots = [c for o, c in zip((l, w), (gl, gw)) if o.requires_grad]
            grads = torch.autograd.grad(outs, hl + [yy], cots,
                                        allow_unused=True)
        return l.detach(), w.detach(), grads[:-1], grads[-1]

    def _vjp_stage(self, sp, x, g):
        sl = _detached(sp)
        xx = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.stage(sl, xx)
            grads = torch.autograd.grad(y, sl + [xx], g, allow_unused=True)
        return grads[:-1], grads[-1]

    @staticmethod
    def _acc(acc, grads):
        for a, g in zip(acc, grads):
            if g is not None:
                a += g.float()

    def backward(self, sp, hp, gl, gw, schedule):
        """(stage grads, head grads, this rank's dx microbatches), all
        unreduced, by the 1F1B or the GPipe schedule."""
        S, s, n = self.S, self.s, self.n_micro
        sg = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for p in sp]
        hg = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for p in hp]
        dxm = torch.zeros_like(self.xm)
        stash = {}
        last = s == S - 1

        def fwd(j, inc):
            x = self.xm[j] if s == 0 else inc
            stash[j] = x
            with torch.no_grad():
                return self.stage(sp, x)

        def bwd(u, g_in, y_out=None):
            """Backward of microbatch u on this stage; on the last stage
            the head's cotangent is made here from y."""
            if last:
                _, _, dh, g_in = self._vjp_head(hp, y_out, u, gl, gw)
                self._acc(hg, dh)
            dsp, dx = self._vjp_stage(sp, stash.pop(u), g_in)
            self._acc(sg, dsp)
            if s == 0:
                dxm[u] = dx.to(dxm.dtype)
            return dx

        if schedule == "1f1b":
            inc_f = torch.zeros_like(self.xm[0])
            inc_b = torch.zeros_like(self.xm[0])
            for t in range(n + 2 * (S - 1)):
                jf, ju = t - s, t - 2 * (S - 1) + s
                y = fwd(jf, inc_f) if 0 <= jf < n else \
                    torch.zeros_like(self.xm[0])
                dx = bwd(ju, inc_b, y) if 0 <= ju < n else \
                    torch.zeros_like(self.xm[0])
                inc_f = _send_next(y, self.axis, self.mesh)
                inc_b = _send_prev(dx, self.axis, self.mesh)
        else:
            ys = {}
            inc = torch.zeros_like(self.xm[0])
            for t in range(n + S - 1):
                j = t - s
                y = fwd(j, inc) if 0 <= j < n else torch.zeros_like(inc)
                if last and 0 <= j < n:
                    ys[j] = y
                inc = _send_next(y, self.axis, self.mesh)
            inc = torch.zeros_like(self.xm[0])
            for t in range(n + S - 1):
                u = n - 1 - (t - (S - 1 - s))
                dx = bwd(u, inc, ys.pop(u, None)) if 0 <= u < n and \
                    t >= S - 1 - s else torch.zeros_like(inc)
                inc = _send_prev(dx, self.axis, self.mesh)
        return sg, hg, dxm


class _PipelineLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, schedule, n_stage, n_head, x, *leaves):
        sp, hp = list(leaves[:n_stage]), list(leaves[n_stage:])
        ctx.sched, ctx.schedule, ctx.n_stage = sched, schedule, n_stage
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.save_for_backward(*leaves)
        ctx.set_materialize_grads(True)
        loss_sum, wsum = sched.forward(sp, hp)
        return loss_sum, wsum

    @staticmethod
    def backward(ctx, gl, gw):
        sched = ctx.sched
        leaves = ctx.saved_tensors
        sp, hp = list(leaves[:ctx.n_stage]), list(leaves[ctx.n_stage:])
        sg, hg, dxm = sched.backward(sp, hp, gl.float(), gw.float(),
                                     ctx.schedule)
        mesh, axis, data_axes = sched.mesh, sched.axis, sched.data_axes
        # stage grads sum over the data ranks; head grads live on the last
        # stage and dx on stage 0, so their sums over pipe broadcast them
        sg = C.all_reduce_tree(sg, data_axes, mesh) if data_axes else sg
        hg = C.all_reduce_tree(hg, (axis,) + data_axes, mesh)
        dxm = C.all_reduce_raw(dxm, axis, mesh)
        if data_axes:
            dxm = C.all_gather_raw(dxm, data_axes, mesh, dim=1)
        dx = dxm.reshape(ctx.x_shape).to(ctx.x_dtype)
        grads = [g.to(p.dtype) for g, p in zip(sg + hg, leaves)]
        return (None, None, None, None, dx, *grads)


def _make_loss(stage_fn, head_fn, mesh, n_microbatches, axis, batch_axes,
               schedule):
    def loss(stage_params, head_params, x, aux):
        sched = _Schedule(stage_fn, head_fn, mesh, n_microbatches, axis,
                          batch_axes, stage_params, head_params, x, aux)
        sp, hp = tree_leaves(stage_params), tree_leaves(head_params)
        return _PipelineLoss.apply(sched, schedule, len(sp), len(hp), x,
                                   *sp, *hp)
    return loss


def make_pipeline_loss(stage_fn: Callable, head_fn: Callable, mesh,
                       n_microbatches: int, axis: str = PIPE,
                       batch_axes=(DATA, FSDP), remat: bool = True,
                       param_specs=None):
    """``loss(stage_params, head_params, x, aux) -> (sum, weight)``, GPipe
    schedule. ``stage_fn(stage_params, x) -> y`` is the repeated block,
    ``head_fn(head_params, y_mb, aux_mb) -> (loss_sum, weight)`` runs on
    the last stage. The backward recomputes each stage forward from its
    stashed input (``remat`` is always on); ``param_specs`` is accepted
    for the JAX signature: this rank's stage params come as they are
    placed."""
    return _make_loss(stage_fn, head_fn, mesh, n_microbatches, axis,
                      batch_axes, "gpipe")


def make_pipeline_loss_1f1b(stage_fn: Callable, head_fn: Callable, mesh,
                            n_microbatches: int, axis: str = PIPE,
                            batch_axes=(DATA, FSDP), param_specs=None):
    """:func:`make_pipeline_loss` with the 1F1B backward (activation
    memory bounded by the stage count)."""
    return _make_loss(stage_fn, head_fn, mesh, n_microbatches, axis,
                      batch_axes, "1f1b")
