"""Decoder-only causal language model: the generative serving workload.

Counterpart of ``deeplearning4j_tpu/models/causal_lm.py``, with the same
parameter layout (so weights bridged from the JAX package load 1:1) and
the same call shapes:

- ``forward``  — full-sequence causal forward ``[B, T] -> [B, T, V]``;
- ``prefill`` / ``decode`` — the slab KV cache
  ``{"k"/"v": [slots, layers, max_ctx, heads, head_dim]}`` (reference
  path);
- ``paged_prefill`` / ``paged_decode`` — the paged pool
  ``{"k"/"v": [num_blocks, layers, block_size, heads, head_dim]}`` plus a
  per-slot block table, which ``DecodeEngine`` serves from. Block 0 is
  scratch: table entries past a slot's allocation point at it, and every
  read of it is masked by the slot's length.

Post-LN residual blocks, f32 layer-norm statistics and softmax, tanh GELU
(``jax.nn.gelu``'s default), a tied word-embedding head with f32 logits.

**Head-parallel decode.** Under a serving mesh (``runtime/sharded.py``)
each rank holds the Megatron layout of the params: ``wq``/``wk``/``wv``
and their [H, Dh] biases split on H, ``wo`` on H, ``w1``/``b1`` on F,
``w2`` on F; ``bo``, ``b2``, the layer norms, the embeddings and the
head whole. The functions here read the split from the params: the
heads from the local ``wq`` (and the pool's heads dim), and a ``wo`` or
``w2`` placed split on its dim 0 sums its product over that mesh axis
(one all-reduce each, two a layer) before its bias enters. Whole params
run the single-process code unchanged.

Where the JAX package donates the cache buffers to its jitted steps, the
port writes the caches IN PLACE (``index_put_`` through the block table)
and returns the same dict: the pool is never copied per step.
``paged_decode`` reads attention through ``kernels.paged_flash_decode``,
which runs the Hopper kernel for a CUDA pool and the gather read for a
CPU pool; ``forward(use_flash=True)`` runs its causal attention through
``kernels.flash_attention``; the other matmuls stay
``torch.einsum``/``torch.matmul``, as the JAX package leaves them to
XLA, except the int8 twin's MLP contractions
(``quant.transforms.dequant_matmul``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..common.mesh import placement
from ..kernels import (attention_dispatch, flash_attention,
                       paged_flash_decode)
from ..quant.transforms import (QuantizedTensor, _leaves, dequant_matmul,
                                dequantize, take_rows, tied_logits)
from .bert import _ln


@dataclasses.dataclass
class CausalLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny() -> "CausalLMConfig":
        """For tests: f32 so the cached decode path is numerically
        interchangeable with the full-recompute forward."""
        return CausalLMConfig(vocab_size=97, hidden_size=64, num_layers=2,
                              num_heads=4, intermediate_size=128,
                              max_position_embeddings=256,
                              dtype=torch.float32)


# -- parameters ----------------------------------------------------------

def init_params(config: CausalLMConfig, seed: int = 0, *,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict:
    """Random weights (normal, std 0.02; layer-norm gains 1, biases 0)
    in the JAX package's layout, drawn from ``generator`` or from a fresh
    one on ``device`` seeded with ``seed``."""
    c = config
    dt = c.dtype
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))

    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=generator,
                                   device=device)).to(dt)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    H, Dh, E, Fi = c.num_heads, c.head_dim, c.hidden_size, \
        c.intermediate_size
    params = {
        "embeddings": {
            "word": dense(c.vocab_size, E),
            "position": dense(c.max_position_embeddings, E),
            "ln_g": ones(E),
            "ln_b": zeros(E, dtype=torch.float32),
        },
        "layers": [],
    }
    for _ in range(c.num_layers):
        params["layers"].append({
            "attn": {
                "wq": dense(E, H, Dh), "wk": dense(E, H, Dh),
                "wv": dense(E, H, Dh), "wo": dense(H, Dh, E),
                "bq": zeros(H, Dh), "bk": zeros(H, Dh),
                "bv": zeros(H, Dh), "bo": zeros(E),
            },
            "mlp": {"w1": dense(E, Fi), "b1": zeros(Fi),
                    "w2": dense(Fi, E), "b2": zeros(E)},
            "ln1_g": ones(E), "ln1_b": zeros(E, dtype=torch.float32),
            "ln2_g": ones(E), "ln2_b": zeros(E, dtype=torch.float32),
        })
    return params


def init_kv_cache(config: CausalLMConfig, slots: int, max_ctx: int,
                  device="cuda") -> Dict:
    """Preallocated per-slot slab KV cache."""
    c = config
    if max_ctx > c.max_position_embeddings:
        raise ValueError(
            f"max_ctx {max_ctx} exceeds max_position_embeddings "
            f"{c.max_position_embeddings}")
    shape = (int(slots), c.num_layers, int(max_ctx), c.num_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


# -- shared block pieces -------------------------------------------------

_BIG_NEG = torch.finfo(torch.float32).min


def _bias(b, dtype):
    # quantize_params also quantizes the 2-D attention biases [H, Dh] once
    # they reach min_size (768 elements at full width); dequantize those
    # at use. Plain biases add as they are, with the usual promotion.
    return dequantize(b, dtype) if isinstance(b, QuantizedTensor) else b


def _proj(eq, h, w, b):
    return torch.einsum(eq, h, dequantize(w, h.dtype)) + _bias(b, h.dtype)


def _tp_sum(x, w):
    """``x``, a product contracted over ``w``'s dim 0, summed over the
    mesh axis that splits that dim (the Megatron row-parallel ``wo`` and
    ``w2``: one all-reduce of this rank's partial product); ``x`` itself
    for a whole weight."""
    pl = placement(w.q if isinstance(w, QuantizedTensor) else w)
    if pl is None or not pl[1] or pl[1][0] is None:
        return x
    from ..parallel.collectives import all_reduce_raw
    return all_reduce_raw(x, pl[1][0], pl[0])


def _attn_out(eq, ctx, a):
    """The output projection; a head-parallel ``wo``'s partial products
    are summed over the mesh before ``bo`` enters, once."""
    out = torch.einsum(eq, ctx, dequantize(a["wo"], ctx.dtype))
    return _tp_sum(out, a["wo"]) + _bias(a["bo"], ctx.dtype)


def _mlp_ln(layer, h, attn_out, c: CausalLMConfig):
    """The post-attention half of a block: residual+LN, MLP, residual+LN.
    Under the Megatron layout ``w1``/``b1`` hold this rank's columns of
    F and ``w2`` its rows; the partial sums meet in one all-reduce
    before ``b2``."""
    h = _ln(h + attn_out, layer["ln1_g"], layer["ln1_b"], c.layer_norm_eps)
    mlp = layer["mlp"]
    # dequant_matmul == matmul for plain weights, and the int8-at-rest
    # contraction (the fused kernel on CUDA) for a quantized twin
    inter = F.gelu(dequant_matmul(h, mlp["w1"]) + mlp["b1"],
                   approximate="tanh")
    mlp_out = _tp_sum(dequant_matmul(inter, mlp["w2"]), mlp["w2"]) \
        + mlp["b2"]
    return _ln(h + mlp_out, layer["ln2_g"], layer["ln2_b"], c.layer_norm_eps)


def _embed(params, input_ids, positions, c: CausalLMConfig):
    e = params["embeddings"]
    h = take_rows(e["word"], input_ids, dtype=c.dtype)
    h = h + e["position"][positions.long()]
    return _ln(h, e["ln_g"], e["ln_b"], c.layer_norm_eps)


def _lm_logits(params, h):
    """Tied word-embedding head, f32 logits."""
    return tied_logits(h, params["embeddings"]["word"])


def _causal_block(layer, h, c: CausalLMConfig, use_flash: bool = False):
    """Full-sequence causal attention block. With ``use_flash`` the
    attention goes through ``kernels.flash_attention(causal=True)`` (the
    Hopper kernels on CUDA, the plain version on the CPU); without it,
    through the plain masked softmax. Returns (h, (k, v)) with k/v
    [B, T, H, Dh]."""
    a = layer["attn"]
    T = h.shape[1]
    q = _proj("bte,ehd->bthd", h, a["wq"], a["bq"])
    k = _proj("bte,ehd->bthd", h, a["wk"], a["bk"])
    v = _proj("bte,ehd->bthd", h, a["wv"], a["bv"])
    if use_flash and T >= 2:        # a 1-row query keeps the plain branch
        ctx = flash_attention(q, k, v, causal=True)
    else:
        scale = q.shape[-1] ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * scale
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=h.device))
        logits = torch.where(causal[None, None], logits, _BIG_NEG)
        probs = torch.softmax(logits, dim=-1).to(h.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = _attn_out("bqhd,hde->bqe", ctx, a)
    return _mlp_ln(layer, h, out, c), (k, v)


# -- full forward and the slab cache ---------------------------------------

def forward(params, input_ids, config: CausalLMConfig,
            use_flash: bool = False):
    """Full causal forward: token ids [B, T] -> next-token logits
    [B, T, V] (f32); ``use_flash`` routes attention through the flash
    kernels."""
    T = input_ids.shape[1]
    h = _embed(params, input_ids,
               torch.arange(T, device=input_ids.device)[None, :], config)
    for layer in params["layers"]:
        h, _ = _causal_block(layer, h, config, use_flash)
    return _lm_logits(params, h)


def prefill(params, cache, input_ids, slot, length, config: CausalLMConfig):
    """Fill ``slot`` of the slab cache from a padded prompt ``[1, T]``
    (written in place); returns ``(cache, logits[V])`` at position
    ``length-1``."""
    c = config
    T = input_ids.shape[1]
    h = _embed(params, input_ids,
               torch.arange(T, device=input_ids.device)[None, :], c)
    ks, vs = [], []
    for layer in params["layers"]:
        h, (k, v) = _causal_block(layer, h, c)
        ks.append(k[0])            # [T, H, Dh]
        vs.append(v[0])
    slot = int(slot)
    cache["k"][slot, :, :T] = torch.stack(ks).to(cache["k"].dtype)
    cache["v"][slot, :, :T] = torch.stack(vs).to(cache["v"].dtype)
    return cache, _lm_logits(params, h[0, int(length) - 1])


def decode(params, cache, tokens, lengths, config: CausalLMConfig):
    """One slab-cache decode step over every slot: writes each token's
    K/V at ``lengths[s]`` in place (a slot whose length is already
    ``max_ctx`` writes nothing, as JAX's ``mode="drop"``) and attends over
    rows ``0..lengths[s]``. Returns ``(cache, logits[S, V])``."""
    c = config
    S = tokens.shape[0]
    C = cache["k"].shape[2]
    dev = tokens.device
    lengths = lengths.long()
    positions = torch.clamp(lengths, 0, c.max_position_embeddings - 1)
    h = _embed(params, tokens, positions, c)            # [S, E]
    attention_dispatch(1)
    key_mask = torch.arange(C, device=dev)[None, :] <= lengths[:, None]
    scale = c.head_dim ** -0.5
    fits = lengths < C
    rows, at = torch.arange(S, device=dev)[fits], lengths[fits]
    cache_k, cache_v = cache["k"], cache["v"]
    for i, layer in enumerate(params["layers"]):
        a = layer["attn"]
        q = _proj("se,ehd->shd", h, a["wq"], a["bq"])
        k = _proj("se,ehd->shd", h, a["wk"], a["bk"])
        v = _proj("se,ehd->shd", h, a["wv"], a["bv"])
        cache_k[rows, i, at] = k[fits].to(cache_k.dtype)
        cache_v[rows, i, at] = v[fits].to(cache_v.dtype)
        att = torch.einsum("shd,schd->shc", q.float(),
                           cache_k[:, i].float()) * scale
        att = torch.where(key_mask[:, None, :], att, _BIG_NEG)
        probs = torch.softmax(att, dim=-1).to(h.dtype)
        ctx = torch.einsum("shc,schd->shd", probs, cache_v[:, i])
        out = _attn_out("shd,hde->se", ctx, a)
        h = _mlp_ln(layer, h, out, c)
    return cache, _lm_logits(params, h)


# -- paged (block-granular) KV cache -------------------------------------

def init_paged_kv_cache(config: CausalLMConfig, num_blocks: int,
                        block_size: int, device="cuda") -> Dict:
    """Block pool ``[num_blocks, layers, block_size, heads, head_dim]``.
    Block 0 is the scratch block the engine's allocator never hands
    out."""
    c = config
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is scratch), got "
            f"{num_blocks}")
    shape = (int(num_blocks), c.num_layers, int(block_size), c.num_heads,
             c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


def _block_coords(tables, positions, block_size):
    """(block ids, in-block offsets) for token ``positions`` under the
    per-row block ``tables`` — both [R, T] for tables [R, MB]. Positions
    whose block-table column exceeds MB clip to the last column; the
    engine never lets a live position get there."""
    mb = tables.shape[1]
    col = torch.clamp(positions // block_size, 0, mb - 1)
    blk = torch.gather(tables.long(), 1, col)
    return blk, positions % block_size


def paged_prefill(params, cache, input_ids, tables, lengths,
                  config: CausalLMConfig, start_pos=None):
    """Batched (optionally partial) prefill into the paged cache.

    ``input_ids`` [B, T] are each row's uncached *tail* zero-padded to
    the bucket, ``tables`` [B, MB] the rows' block tables, ``lengths``
    [B] the real total prompt lengths, ``start_pos`` [B] the rows already
    committed in the row's (attached, possibly shared) blocks (0 = cold).
    Tail row ``j`` sits at position ``start_pos[b]+j``; rows past the real
    tail go to scratch block 0 so padding never clobbers a committed
    block. Attention runs over the gathered block view, masked causally
    at each row's absolute position. Writes the pool in place; returns
    ``(cache, logits[B, V])`` at each row's last real tail position."""
    c = config
    B, T = input_ids.shape
    dev = input_ids.device
    MB = tables.shape[1]
    Bs = cache["k"].shape[2]
    C = MB * Bs
    lengths = lengths.long()
    start_pos = (torch.zeros(B, dtype=torch.long, device=dev)
                 if start_pos is None else start_pos.long())
    pos = start_pos[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    h = _embed(params, input_ids,
               torch.clamp(pos, 0, c.max_position_embeddings - 1), c)
    attention_dispatch(T, paged=True)
    valid = torch.arange(T, device=dev)[None, :] < \
        (lengths - start_pos)[:, None]
    blk, off = _block_coords(tables, pos, Bs)
    blk = torch.where(valid, blk, 0)       # padding rows -> scratch block
    key_mask = torch.arange(C, device=dev)[None, None, :] <= pos[:, :, None]
    scale = c.head_dim ** -0.5
    gather = tables.long()
    cache_k, cache_v = cache["k"], cache["v"]
    H = cache_k.shape[3]               # this rank's heads under a mesh
    for i, layer in enumerate(params["layers"]):
        a = layer["attn"]
        q = _proj("bte,ehd->bthd", h, a["wq"], a["bq"])
        k = _proj("bte,ehd->bthd", h, a["wk"], a["bk"])
        v = _proj("bte,ehd->bthd", h, a["wv"], a["bv"])
        # in place through the block table (JAX donates the pool instead)
        cache_k[blk, i, off] = k.to(cache_k.dtype)
        cache_v[blk, i, off] = v.to(cache_v.dtype)
        # gather each row's blocks into its contiguous [C] key view: the
        # cached prefix rows plus the tail rows written just above
        ks = cache_k[:, i][gather].reshape(B, C, H, c.head_dim)
        vs = cache_v[:, i][gather].reshape(B, C, H, c.head_dim)
        att = torch.einsum("bqhd,bchd->bhqc", q.float(), ks.float()) * scale
        att = torch.where(key_mask[:, None], att, _BIG_NEG)
        probs = torch.softmax(att, dim=-1).to(h.dtype)
        ctx = torch.einsum("bhqc,bchd->bqhd", probs, vs)
        out = _attn_out("bqhd,hde->bqe", ctx, a)
        h = _mlp_ln(layer, h, out, c)
    last = h[torch.arange(B, device=dev),
             torch.clamp(lengths - start_pos - 1, 0, T - 1)]
    return cache, _lm_logits(params, last)


def paged_decode(params, cache, tables, tokens, lengths,
                 config: CausalLMConfig):
    """Cache-aware step over every slot against the paged pool: ``Q=1``
    is the single-token decode, ``Q=k+1`` the speculative verify.

    ``tokens`` [S, Q] are each slot's next Q tokens (positions
    ``lengths[s]+q``), ``lengths`` [S] the committed rows per slot. Writes
    each token's K/V through the block table (in place), then reads
    attention through ``kernels.paged_flash_decode`` on the strided
    per-layer view of the pool: the Hopper kernel for a CUDA pool, the
    gather read for a CPU pool. Returns ``(cache, logits[S, Q, V])``."""
    c = config
    S, Q = tokens.shape
    dev = tokens.device
    Bs = cache["k"].shape[2]
    tables = tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    pos = lengths.long()[:, None] + torch.arange(Q, device=dev)[None, :]
    h = _embed(params, tokens,
               torch.clamp(pos, 0, c.max_position_embeddings - 1), c)
    attention_dispatch(Q, paged=True, pool=cache["k"])
    blk, off = _block_coords(tables, pos, Bs)
    scale = c.head_dim ** -0.5
    cache_k, cache_v = cache["k"], cache["v"]
    for i, layer in enumerate(params["layers"]):
        a = layer["attn"]
        q = _proj("sqe,ehd->sqhd", h, a["wq"], a["bq"])
        k = _proj("sqe,ehd->sqhd", h, a["wk"], a["bk"])
        v = _proj("sqe,ehd->sqhd", h, a["wv"], a["bv"])
        # in place through the block table (JAX donates the pool instead)
        cache_k[blk, i, off] = k.to(cache_k.dtype)
        cache_v[blk, i, off] = v.to(cache_v.dtype)
        # cache_k[:, i] is a strided view of the layer's pool: the kernel
        # takes its strides, so the pool is never copied
        ctx = paged_flash_decode(q.contiguous(), cache_k[:, i],
                                 cache_v[:, i], tables, lengths, scale=scale)
        out = _attn_out("sqhd,hde->sqe", ctx, a)
        h = _mlp_ln(layer, h, out, c)
    return cache, _lm_logits(params, h)


def count_params(params) -> int:
    """Elements in a params tree. A ``QuantizedTensor`` counts its ``q``
    and its ``scale``, as the JAX package's ``tree_leaves`` sees them."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.q.numel() + leaf.scale.numel()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel()
    return total


class CausalLM:
    """Config + params behind the generative-model protocol that
    ``DecodeEngine`` duck-types on (the paged trio, the slab trio,
    ``forward``). Inference-only: the params stay a plain nested dict in
    the JAX package's layout rather than ``nn.Module`` parameters, because
    bridged and quantized leaves (``QuantizedTensor``) must keep that
    layout 1:1."""

    def __init__(self, config: Optional[CausalLMConfig] = None,
                 params: Optional[Dict] = None, seed: int = 0,
                 device="cuda"):
        self.config = config or CausalLMConfig.tiny()
        self.device = torch.device(device)
        self.params = (params if params is not None
                       else init_params(self.config, seed, device=device))

    def init_kv_cache(self, slots: int, max_ctx: int) -> Dict:
        return init_kv_cache(self.config, slots, max_ctx, self.device)

    def prefill(self, params, cache, input_ids, slot, length):
        return prefill(params, cache, input_ids, slot, length, self.config)

    def decode(self, params, cache, tokens, lengths):
        return decode(params, cache, tokens, lengths, self.config)

    # paged protocol (what DecodeEngine serves from)
    def init_paged_kv_cache(self, num_blocks: int, block_size: int) -> Dict:
        return init_paged_kv_cache(self.config, num_blocks, block_size,
                                   self.device)

    def paged_prefill(self, params, cache, input_ids, tables, lengths,
                      start_pos=None):
        return paged_prefill(params, cache, input_ids, tables, lengths,
                             self.config, start_pos)

    def paged_decode(self, params, cache, tables, tokens, lengths):
        return paged_decode(params, cache, tables, tokens, lengths,
                            self.config)

    def forward(self, input_ids):
        return forward(self.params, input_ids, self.config)
