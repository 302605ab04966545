"""Ring attention: sequence parallelism over the mesh's ``seq`` axis.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``. Q, K
and V are sharded along the sequence over ``seq``; each rank keeps its Q
block and walks the K/V ring: attention against the K/V block it holds,
merged into an online-softmax accumulator, then the block (and its key
mask) moves to the next rank. After ``n`` steps every Q block has seen
every K/V block.

- :func:`ring_attention_local` is the per-rank body (the JAX package's
  ``_ring_attention_local`` / ``_ring_flash_local`` under
  ``shard_map``). Each block is ``(o, lse)``: with ``use_flash`` from
  ``kernels.flash_attention_with_lse`` (the forward kernel on CUDA
  tensors), else from its plain version; blocks fold in through the
  flash-merge (:func:`_merge_block`). Under ``causal`` a block below the
  diagonal runs whole, the diagonal block the kernel's causal path (the
  local offsets align), and a block above it is skipped.
- Its backward is written out, as one ``torch.autograd.Function`` over
  the whole ring, where JAX differentiates its ``scan``: the ring runs
  again with the final output and its lse, each held block gives its
  dq, dk and dv (``_flash_bwd``'s dq and dk/dv kernels on CUDA under
  ``use_flash``, with that global lse and ``delta = rowsum(o * g)``:
  the block's share of the softmax), dq stays, and dk/dv accumulators
  travel with their K/V block and come home after ``n`` shifts. Every
  send and receive is issued in this fixed order on every rank.
- A query row that sees no live key anywhere on the ring outputs zeros
  (and gets zero gradients) on both paths: a block whose lse sits at
  :data:`_MASKED_LSE_FLOOR` merges with weight 0 (the kernel and the
  plain version give about ``-1e30 + log Tk`` for a row they mask
  whole), and a row whose merged weight is 0 is written as 0.
- :func:`ring_attention` / :func:`ulysses_attention` take global
  ``[B, T, H, D]`` tensors (every rank the same), shard them
  ``[B/dp, T/sp, H/tp, D]`` and gather the output back (differentiable,
  under the collectives' convention that each rank's loss is its part of
  the global loss). :func:`blockwise_attention` is the one-device
  online-softmax scan.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common.mesh import DATA, FSDP, SEQ, TENSOR, P, local_slice, \
    valid_spec
from ..kernels.flash_attention import (_check_kernel_args, _flash_bwd,
                                       flash_attention_with_lse,
                                       flash_attention_with_lse_plain)
from . import collectives as C

#: an lse at or below this marks a block with no live key for the row
_MASKED_LSE_FLOOR = -1e29
#: the lse given to a row with no live key, so its softmax share is 0
_DEAD_ROW_LSE = 1e30
_NEG = -1e30


def _online_softmax_step(o, l, m, logits, v_cur):
    """Fold one K/V block into the (o, l, m) accumulator. o: [B, H, Tq,
    D]; l, m: [B, H, Tq]; logits: [B, H, Tq, Tk] (-inf = hidden);
    v_cur: [B, Tk, H, D]."""
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_new,
                                 torch.full_like(m, float("-inf"))))
    corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_cur.float())
    return o_new, l_new, m_new


def _merge_block(o, l, m, o_blk, lse_blk):
    """Fold a normalised block (o_blk [B, Tq, H, D], lse_blk [B, H, Tq])
    into (o [B, Tq, H, D], l, m [B, H, Tq]): the block weighs exp(lse);
    a block at the masked floor weighs 0."""
    m_new = torch.maximum(m, lse_blk)
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_new,
                                 torch.full_like(m, float("-inf"))))
    corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
    w = torch.exp(torch.where(lse_blk > _MASKED_LSE_FLOOR, lse_blk - m_new,
                              torch.full_like(m, float("-inf"))))
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    l_new = l * corr + w
    cT = corr.transpose(1, 2)[..., None]
    wT = w.transpose(1, 2)[..., None]
    return o * cT + o_blk.float() * wT, l_new, m_new


def _block_bwd_plain(q, k, v, mask, o, lse, g, causal, scale):
    """dq, dk, dv of one block given the final output ``o`` and its lse
    (``[B, H, Tq]``), in f32: p = exp(s - lse) is the block's share."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = mask[:, None, None, :] != 0
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        keep = keep & torch.ones((Tq, Tk), dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.where(keep, s, _NEG)
    p = torch.exp(s - lse[..., None])
    gf = g.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    delta = torch.einsum("bqhd,bqhd->bhq", o.float(), gf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq, dk, dv


def _blocks(n, my, causal):
    """(step, held block's owner, kind) over the ring: kind is "full",
    "diag" or "skip"."""
    for step in range(n):
        src = (my - step) % n
        kind = "full"
        if causal:
            kind = "diag" if src == my else ("skip" if src > my else "full")
        yield step, kind


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, mesh, axis, causal, scale, use_flash):
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        B, Tq, H, D = q.shape
        o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, Tq), float("-inf"), device=q.device)
        block = flash_attention_with_lse if use_flash \
            else flash_attention_with_lse_plain
        k_cur, v_cur, mask_cur = k, v, mask
        with torch.no_grad():
            for step, kind in _blocks(n, my, causal):
                if kind != "skip":
                    o_b, lse_b = block(q, k_cur, v_cur, mask_cur,
                                       causal=kind == "diag", scale=scale)
                    o, l, m = _merge_block(o, l, m, o_b, lse_b)
                if step < n - 1:
                    k_cur, v_cur, mask_cur = (
                        C.ppermute_raw(t, axis, mesh)
                        for t in (k_cur, v_cur, mask_cur))
            live = l > 1e-30
            lT = l.transpose(1, 2)[..., None]
            out = torch.where(lT > 1e-30, o / torch.clamp_min(lT, 1e-30),
                              torch.zeros_like(o)).to(q.dtype)
            lse = torch.where(live, m + torch.log(torch.clamp_min(l, 1e-30)),
                              torch.full_like(l, _DEAD_ROW_LSE))
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.cfg = (mesh, axis, causal, scale, use_flash)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale, use_flash = ctx.cfg
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        kernel = use_flash and q.is_cuda
        g = g.contiguous()
        if kernel:
            g = g.to(q.dtype)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur, mask_cur = k, v, mask
        for step, kind in _blocks(n, my, causal):
            if kind != "skip":
                if kernel:
                    dq_b, dk_b, dv_b = _flash_bwd(
                        q, k_cur, v_cur, mask_cur, out, lse, g,
                        kind == "diag", scale)
                else:
                    dq_b, dk_b, dv_b = _block_bwd_plain(
                        q, k_cur, v_cur, mask_cur, out, lse, g,
                        kind == "diag", scale)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            if step < n - 1:
                k_cur, v_cur, mask_cur = (C.ppermute_raw(t, axis, mesh)
                                          for t in (k_cur, v_cur, mask_cur))
            # the accumulators travel with their block: n shifts home
            dk, dv = (C.ppermute_raw(t, axis, mesh) for t in (dk, dv))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def ring_attention_local(q, k, v, kv_mask, mesh, *, axis: str = SEQ,
                         causal: bool = False, scale: Optional[float] = None,
                         use_flash: bool = False):
    """The per-rank ring body: q, k, v this rank's ``[B, T/sp, H, D]``
    blocks, ``kv_mask`` its ``[B, T/sp]`` key mask (nonzero = attend,
    None = all); returns this rank's output block."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[:2], dtype=torch.int32,
                             device=q.device)
    kv_mask = kv_mask.to(torch.int32).contiguous()
    if use_flash and q.is_cuda:
        _check_kernel_args(q, k, v)
    return _Ring.apply(q, k, v, kv_mask, mesh, axis, bool(causal), scale,
                       bool(use_flash))


def _shard(x, mesh, spec):
    return local_slice(x, mesh, valid_spec(mesh, spec, x.shape))


def _unshard(x, mesh, spec, shape):
    spec = valid_spec(mesh, spec, shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            x = C.all_gather(x, entry, gather_axis=d, mesh=mesh)
    return x


def ring_attention(q, k, v, mesh, *, mask=None, causal: bool = False,
                   scale: Optional[float] = None, axis: str = SEQ,
                   batch_axes=(DATA, FSDP), head_axis: str = TENSOR,
                   use_flash: bool = False):
    """Sequence-parallel attention over ``mesh``: q, k, v global ``[B, T,
    H, D]`` (the same on every rank), ``mask`` an optional ``[B, T]`` key
    mask; each rank computes its ``[B/dp, T/sp, H/tp, D]`` block on the
    ring and the global ``[B, T, H, D]`` output comes back."""
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    spec = P(tuple(batch_axes), axis, head_axis, None)
    ql, kl, vl = (_shard(t, mesh, spec) for t in (q, k, v))
    ml = _shard(mask, mesh, P(tuple(batch_axes), axis))
    out = ring_attention_local(ql, kl, vl, ml, mesh, axis=axis,
                               causal=causal, scale=scale,
                               use_flash=use_flash)
    return _unshard(out, mesh, spec, q.shape)


def blockwise_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        block_size: int = 512):
    """One-device blockwise attention: the online softmax over K/V
    blocks of ``block_size``. q/k/v: [B, T, H, D]."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, T, H, D = q.shape
    bs = min(block_size, T)
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), float("-inf"), device=q.device)
    q_pos = torch.arange(T, device=q.device)
    for start in range(0, T, bs):
        k_cur, v_cur = k[:, start:start + bs], v[:, start:start + bs]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k_cur.float()) * scale
        if causal:
            k_pos = start + torch.arange(k_cur.shape[1], device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(keep[None, None], logits,
                                 torch.full_like(logits, float("-inf")))
        o, l, m = _online_softmax_step(o, l, m, logits, v_cur)
    lb = l[..., None]
    out = torch.where(lb > 1e-30, o / torch.clamp_min(lb, 1e-30),
                      torch.zeros_like(o))
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ulysses_local(q, k, v, mesh, *, causal: bool = False,
                  scale: Optional[float] = None, axis: str = SEQ):
    """The per-rank Ulysses body: [B, T/n, H, D] -> all_to_all -> [B, T,
    H/n, D], attention per head group, and back."""
    qh, kh, vh = (C.all_to_all(t, axis, 2, 1, mesh=mesh) for t in (q, k, v))
    out = blockwise_attention(qh, kh, vh, causal=causal, scale=scale)
    return C.all_to_all(out, axis, 1, 2, mesh=mesh)


def ulysses_attention(q, k, v, mesh, *, causal: bool = False,
                      scale: Optional[float] = None, axis: str = SEQ):
    """DeepSpeed-Ulysses sequence parallelism over global ``[B, T, H,
    D]`` tensors sharded on T (and the batch over ``(data, fsdp)``)."""
    spec = P((DATA, FSDP), axis, None, None)
    ql, kl, vl = (_shard(t, mesh, spec) for t in (q, k, v))
    out = ulysses_local(ql, kl, vl, mesh, causal=causal, scale=scale,
                        axis=axis)
    return _unshard(out, mesh, spec, q.shape)
