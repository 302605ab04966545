"""BERT: masked-LM pre-training and the SQuAD-style QA head.

Counterpart of ``deeplearning4j_tpu/models/bert.py``, unsharded: the
same params layout (so weights bridged from the JAX package load 1:1),
the same call shapes, post-LN blocks with f32 layer-norm statistics,
tanh GELU and a tied word-embedding MLM head with f32 logits.

- ``encode`` / ``mlm_logits`` / ``pooled`` — the forward;
- ``mlm_loss`` — masked-LM cross entropy (labels ``-100`` = unmasked);
  the vocab softmax-xent stays plain PyTorch, as the JAX package leaves
  it to XLA;
- ``make_train_step`` / ``make_scanned_train_step`` — forward, loss,
  backward and Adam; ``remat=True`` checkpoints the loss with
  ``torch.utils.checkpoint``;
- ``init_qa_params`` / ``qa_logits`` / ``qa_loss`` / ``make_qa_train_step``.

With ``use_flash`` attention goes through ``kernels.flash_attention``:
the Hopper kernels (forward, dq, dk/dv) for CUDA tensors, the plain
version for CPU tensors. Without it, attention is the plain
einsum/softmax branch of the JAX package.

Params and the Adam state are updated IN PLACE by the train steps,
where the JAX package donates them to its jitted step.
Every step goes through the dispatch census
(``runtime.inference.captured_train_step``) with the JAX package's tags
(``bert_train``, ``bert_qa``, ``bert_pipeline``): one
``dl4j_compiles_total`` event per new signature, as its ``counted_jit``.
On the card each signature of an unsharded step is captured once as a
CUDA graph (the flash kernels inside it) and replayed; the caller's
params and state are its static buffers, so a call on other tensors
captures again. ``step.graphs`` reports each signature and
``step.graphs.release()`` frees the graphs' memory; a mesh step runs
eagerly (``eager:<backend>``).

**On a mesh** (``mesh=``, a ``common.mesh.Mesh``): ``place_params`` /
``place_opt_state`` keep each rank's shard per :func:`param_specs`
(Megatron tensor parallelism over ``tensor``: QKV, ``wo``'s heads and
``w1``'s columns / ``w2``'s rows; FSDP over ``fsdp`` on dim 0 or 2).
Every rank calls a step with the same global batch; it keeps its rows
over ``(data, fsdp)`` and, under ``seq_parallel``, its positions over
``seq``. The body is Megatron's: ``tp_copy`` before the column-parallel
products, ``tp_reduce`` after the row-parallel ones; an FSDP leaf is
all-gathered at use (its gradient reduce-scattered back); attention is
the ring of ``parallel/ring_attention.py`` under ``seq_parallel``
(``use_flash``: the flash kernels for every block, forward and
backward). The loss is the global masked mean (sums and counts over the
batch and sequence ranks), each rank differentiates its part of it, and
the gradients are summed over those ranks before Adam updates the
shards in place; the returned loss is the global one. With a mesh the
encoder is not rematerialised (``remat`` only saves memory; the numbers
are the same).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common.mesh import (DATA, FSDP, PIPE, SEQ, TENSOR, Mesh, P,
                           _spec_leaves, place, placement, shard_slices,
                           tree_map_specs, valid_spec)
from ..kernels import flash_attention
from ..quant.transforms import (dequant_matmul, dequantize, take_rows,
                                tied_logits)
from . import _optim


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)

    @staticmethod
    def tiny() -> "BertConfig":
        """For tests."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position_embeddings=128)


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a deeplearning4j_tpu_torch "
                        f"common.mesh.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")


# -- parameter init -----------------------------------------------------

def _generator(seed, generator, device):
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    return generator


def init_params(config: BertConfig, seed: int = 0, *,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict:
    """Random weights in the JAX package's layout: dense weights normal
    with std 0.02 in ``config.dtype``, dense biases zero in
    ``config.dtype``, layer-norm gains 1 and biases 0 in f32, the MLM
    bias zero in f32. Drawn from ``generator`` or from a fresh one on
    ``device`` seeded with ``seed``."""
    c = config
    dt = c.dtype
    gen = _generator(seed, generator, device)

    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=gen,
                                   device=device)).to(dt)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    f32 = torch.float32
    E = c.hidden_size
    params = {
        "embeddings": {
            "word": dense(c.vocab_size, E),
            "position": dense(c.max_position_embeddings, E),
            "token_type": dense(c.type_vocab_size, E),
            "ln_g": ones(E),
            "ln_b": zeros(E, dtype=f32),
        },
        "layers": [],
        "mlm": {
            "dense": dense(E, E),
            "dense_b": zeros(E),
            "ln_g": ones(E),
            "ln_b": zeros(E, dtype=f32),
            "bias": zeros(c.vocab_size, dtype=f32),
        },
        "pooler": {"w": dense(E, E), "b": zeros(E)},
    }
    H, Dh, Fi = c.num_heads, c.head_dim, c.intermediate_size
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
            "ln1_g": ones(E), "ln1_b": zeros(E, dtype=f32),
            "ln2_g": ones(E), "ln2_b": zeros(E, dtype=f32),
        })
    return params


def _ln(x, g, b, eps):
    """Layer norm with its statistics in f32 (population variance), the
    result cast back to ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


# -- sharding rules (Megatron TP + optional FSDP) ------------------------

def param_specs(config: BertConfig) -> Dict:
    """PartitionSpec tree matching init_params' structure."""
    layer = {
        "attn": {
            "wq": P(FSDP, TENSOR, None), "wk": P(FSDP, TENSOR, None),
            "wv": P(FSDP, TENSOR, None), "wo": P(TENSOR, None, FSDP),
            "bq": P(TENSOR, None), "bk": P(TENSOR, None),
            "bv": P(TENSOR, None), "bo": P(),
        },
        "mlp": {
            "w1": P(FSDP, TENSOR), "b1": P(TENSOR),
            "w2": P(TENSOR, FSDP), "b2": P(),
        },
        "ln1_g": P(), "ln1_b": P(), "ln2_g": P(), "ln2_b": P(),
    }
    return {
        "embeddings": {"word": P(FSDP, None), "position": P(),
                       "token_type": P(), "ln_g": P(), "ln_b": P()},
        "layers": [layer] * config.num_layers,
        "mlm": {"dense": P(FSDP, None), "dense_b": P(), "ln_g": P(),
                "ln_b": P(), "bias": P()},
        "pooler": {"w": P(FSDP, None), "b": P()},
    }


def place_params(params, config: BertConfig, mesh: Mesh):
    """This rank's shards of a global param tree, per :func:`param_specs`
    (a spec that does not divide falls back to replicated)."""
    _check_mesh(mesh)
    return tree_map_specs(lambda p, sp: place(p, mesh, sp), params,
                          param_specs(config))


def place_opt_state(opt_state, config: BertConfig, mesh: Mesh):
    """This rank's shards of a global Adam state ``(u_list, m_list)``,
    each leaf placed as its parameter."""
    _check_mesh(mesh)
    specs = _spec_leaves(param_specs(config))
    u, m = opt_state
    return ([place(a, mesh, sp) for a, sp in zip(u, specs)],
            [place(a, mesh, sp) for a, sp in zip(m, specs)])


def _specs_of(params):
    """The placed spec of every leaf (P() for an unplaced one)."""
    return _optim.tree_unflatten(params, [
        placement(p)[1] if placement(p) is not None else P()
        for p in _optim.tree_leaves(params)])


def _gather_fsdp(p, spec, mesh):
    """A leaf with its FSDP dims all-gathered (tensor dims stay local)."""
    from ..parallel import collectives as C
    for d, entry in enumerate(spec):
        if entry == FSDP:
            p = C.all_gather(p, FSDP, gather_axis=d, mesh=mesh)
    return p


class _Shard:
    """One rank's view of a mesh step: its mesh, the axes its loss and
    gradients are summed over, its tensor axis and position offset."""

    def __init__(self, mesh, seq_parallel):
        self.mesh = mesh
        self.seq_parallel = bool(seq_parallel) and mesh.shape[SEQ] > 1
        self.red_axes = tuple(a for a in (DATA, FSDP) + (
            (SEQ,) if self.seq_parallel else ())
            if mesh.shape[a] > 1)
        self.tp_axis = TENSOR if mesh.shape[TENSOR] > 1 else None

    def batch(self, batch):
        """This rank's rows of every batch entry (and, under sequence
        parallelism, its positions), and the first position's index."""
        out, off = {}, 0
        for k, v in batch.items():
            spec = valid_spec(self.mesh, P((DATA, FSDP), SEQ if (
                self.seq_parallel and v.dim() >= 2) else None), v.shape)
            idx = shard_slices(self.mesh, spec, v.shape)
            out[k] = v[idx]
            if len(spec) > 1:
                off = idx[1].start
            self.rows_sharded = bool(spec) and spec[0] is not None
        return out, off

    def params(self, params, specs):
        return tree_map_specs(lambda p, sp: _gather_fsdp(p, sp, self.mesh),
                              params, specs)

    def sum(self, x):
        from ..parallel import collectives as C
        return C.all_reduce_raw(x, self.red_axes, self.mesh) \
            if self.red_axes else x

    def reduce_grads(self, grads, specs):
        """Sum each leaf's gradient over the loss's axes (an FSDP leaf's
        was already summed over ``fsdp`` by its all-gather's backward)."""
        from ..parallel import collectives as C
        leaves = _optim.tree_leaves(grads)
        spec_l = _spec_leaves(specs)
        groups: Dict = {}
        for i, sp in enumerate(spec_l):
            axes = tuple(a for a in self.red_axes
                         if not (a == FSDP and FSDP in sp))
            groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            if axes:
                summed = C.all_reduce_tree([leaves[i] for i in idx], axes,
                                           self.mesh)
                for i, g in zip(idx, summed):
                    leaves[i] = g
        return _optim.tree_unflatten(grads, leaves)


# -- forward ------------------------------------------------------------

def _attention(layer_params, h, attention_mask, config: BertConfig,
               use_flash: bool = False, shard: Optional[_Shard] = None):
    """Multi-head self-attention of one layer, [B, T, E] -> [B, T, E].
    With ``shard`` the heads are this rank's ``tensor`` shard (tp_copy in,
    tp_reduce out) and, under sequence parallelism, the ring attends over
    every rank's positions."""
    a = layer_params["attn"]
    tp = shard.tp_axis if shard is not None else None
    h_in = h
    if tp is not None:
        from ..parallel.pipeline import tp_copy
        h_in = tp_copy(h, tp, shard.mesh)
    q = torch.einsum("bte,ehd->bthd", h_in, dequantize(a["wq"], h.dtype)) \
        + a["bq"]
    k = torch.einsum("bte,ehd->bthd", h_in, dequantize(a["wk"], h.dtype)) \
        + a["bk"]
    v = torch.einsum("bte,ehd->bthd", h_in, dequantize(a["wv"], h.dtype)) \
        + a["bv"]
    if shard is not None and shard.seq_parallel:
        from ..parallel.ring_attention import ring_attention_local
        ctx = ring_attention_local(q, k, v, attention_mask, shard.mesh,
                                   scale=config.head_dim ** -0.5,
                                   use_flash=use_flash)
    elif use_flash and q.shape[1] >= 2:  # a 1-row query keeps this branch
        ctx = flash_attention(q, k, v, mask=attention_mask)
    else:
        scale = config.head_dim ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * scale
        if attention_mask is not None:
            big_neg = torch.finfo(torch.float32).min
            logits = torch.where(attention_mask[:, None, None, :].bool(),
                                 logits, big_neg)
        probs = torch.softmax(logits, dim=-1).to(h.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = torch.einsum("bqhd,hde->bqe", ctx, dequantize(a["wo"], ctx.dtype))
    if tp is not None:
        from ..parallel.pipeline import tp_reduce
        out = tp_reduce(out, tp, shard.mesh)
    return out + a["bo"]


def _encode(params, input_ids, token_type_ids, attention_mask, c,
            use_flash, shard: Optional[_Shard] = None, pos_offset: int = 0):
    """The encoder over this rank's rows (and positions from
    ``pos_offset``), params as this rank uses them."""
    e = params["embeddings"]
    T = input_ids.shape[1]
    h = take_rows(e["word"], input_ids, dtype=c.dtype)
    h = h + e["position"][None, pos_offset:pos_offset + T]
    if token_type_ids is not None:
        h = h + e["token_type"][token_type_ids.long()]
    else:
        h = h + e["token_type"][0]
    h = _ln(h, e["ln_g"], e["ln_b"], c.layer_norm_eps)
    tp = shard.tp_axis if shard is not None else None
    for layer in params["layers"]:
        attn_out = _attention(layer, h, attention_mask, c, use_flash, shard)
        h = _ln(h + attn_out, layer["ln1_g"], layer["ln1_b"],
                c.layer_norm_eps)
        mlp = layer["mlp"]
        h_in = h
        if tp is not None:
            from ..parallel.pipeline import tp_copy
            h_in = tp_copy(h, tp, shard.mesh)
        inter = _gelu(dequant_matmul(h_in, mlp["w1"]) + mlp["b1"])
        part = dequant_matmul(inter, mlp["w2"])
        if tp is not None:
            from ..parallel.pipeline import tp_reduce
            part = tp_reduce(part, tp, shard.mesh)
        h = _ln(h + part + mlp["b2"], layer["ln2_g"], layer["ln2_b"],
                c.layer_norm_eps)
    return h


def _unshard_rows(x, shard: _Shard):
    """The global [B, T, ...] of this rank's rows (and positions)."""
    from ..parallel import collectives as C
    if shard.seq_parallel:
        x = C.all_gather(x, SEQ, gather_axis=1, mesh=shard.mesh)
    if shard.rows_sharded:
        x = C.all_gather(x, (DATA, FSDP), gather_axis=0, mesh=shard.mesh)
    return x


def encode(params, input_ids, token_type_ids=None, attention_mask=None, *,
           config: BertConfig, mesh=None, seq_parallel: bool = False,
           use_flash: bool = False):
    """Token ids [B, T] -> contextual encodings [B, T, E]. On a mesh the
    params are placed (:func:`place_params`), the inputs and the result
    global."""
    _check_mesh(mesh)
    if mesh is None:
        return _encode(params, input_ids, token_type_ids, attention_mask,
                       config, use_flash)
    shard = _Shard(mesh, seq_parallel)
    local, off = shard.batch(_batch_dict(input_ids, token_type_ids,
                                         attention_mask))
    h = _encode(shard.params(params, _specs_of(params)), local["ids"],
                local.get("tt"), local.get("mask"), config, use_flash,
                shard, off)
    return _unshard_rows(h, shard)


def _batch_dict(ids, tt, mask):
    out = {"ids": ids}
    if tt is not None:
        out["tt"] = tt
    if mask is not None:
        out["mask"] = mask
    return out


def mlm_logits(params, encodings, config: BertConfig):
    """Masked-LM head with tied decoder weights: f32 logits [B, T, V]."""
    m = params["mlm"]
    h = _gelu(dequant_matmul(encodings, m["dense"]) + m["dense_b"])
    h = _ln(h, m["ln_g"], m["ln_b"], config.layer_norm_eps)
    return tied_logits(h, params["embeddings"]["word"]) + m["bias"]


def pooled(params, encodings):
    return torch.tanh(dequant_matmul(encodings[:, 0], params["pooler"]["w"])
                      + params["pooler"]["b"])


def _mlm_sums(params, batch, config, use_flash, shard=None, off=0):
    """(sum of the masked positions' cross entropy, their count) over
    the rows (and positions) of ``batch``."""
    enc = _encode(params, batch["input_ids"], batch.get("token_type_ids"),
                  batch.get("attention_mask"), config, use_flash, shard,
                  off)
    logits = mlm_logits(params, enc, config)
    labels = batch["labels"].long()
    valid = labels >= 0
    per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              torch.where(valid, labels, 0).reshape(-1),
                              reduction="none").reshape(labels.shape)
    per_tok = torch.where(valid, per_tok, 0.0)
    return per_tok.sum(), valid.sum()


def mlm_loss(params, batch, config: BertConfig, mesh=None,
             seq_parallel=False, use_flash=False):
    """Masked-LM cross entropy. batch: input_ids, labels (negative =
    unmasked), attention_mask and optionally token_type_ids; the mean
    over the masked positions (0 when there are none). On a mesh: the
    global mean, params placed, the batch global."""
    _check_mesh(mesh)
    if mesh is None:
        s, n = _mlm_sums(params, batch, config, use_flash)
        return s / torch.clamp(n, min=1)
    return _sharded_objective(params, batch, config, mesh, seq_parallel,
                              use_flash)[1]


def _sharded_objective(params, batch, config, mesh, seq_parallel,
                       use_flash, sums=_mlm_sums, specs=None):
    """(this rank's part of the global loss, the global loss): the
    part's gradients, summed over the loss's axes, are the global
    loss's."""
    shard = _Shard(mesh, seq_parallel)
    local, off = shard.batch(batch)
    specs = _specs_of(params) if specs is None else specs
    s, n = sums(shard.params(params, specs), local, config, use_flash,
                shard, off)
    total = shard.sum(torch.stack([s.detach().float(),
                                   n.detach().float()]))
    count = torch.clamp(total[1], min=1)
    return s / count, total[0] / count


# -- training step ------------------------------------------------------

def _make_loss_fn(config, mesh, seq_parallel, remat, use_flash):
    def loss_fn(params, batch):
        return mlm_loss(params, batch, config, use_flash=use_flash)

    if not remat:
        return loss_fn

    def remat_loss_fn(params, batch):
        # keep only the inputs; the encoder is recomputed in the backward.
        # The loss draws nothing at random, so there is no generator state
        # to save and restore around the recompute (a host read of it
        # would stop the step's capture).
        return checkpoint(loss_fn, params, batch, use_reentrant=False,
                          preserve_rng_state=False)
    return remat_loss_fn


def _counted(step, kind, mesh=None, n_steps=None):
    """``step`` under the census with the JAX package's tag (one
    ``dl4j_compiles_total`` event per new signature of its opt_state,
    batch and iteration), captured as one CUDA graph a signature
    (``runtime.inference.captured_train_step``; ``n_steps`` replays of
    one step per call); on a mesh it runs eagerly, as
    ``eager:<backend>`` (``eager:mesh`` at one rank)."""
    from ..runtime.cuda_graphs import mesh_reason
    from ..runtime.inference import captured_train_step
    reason = None if mesh is None else mesh_reason(mesh) or "mesh"
    return captured_train_step(step, f"{kind}:{id(step)}", n_steps, reason)


def make_train_step(config: BertConfig, mesh=None,
                    learning_rate: float = 1e-4, seq_parallel: bool = False,
                    remat: bool = True, use_flash: bool = False):
    """One train step ``(params, opt_state, batch, iteration) ->
    (params, opt_state, loss)``: forward, masked-LM loss, backward and
    Adam, with params and state updated in place. On a mesh: params and
    state placed (``place_params``, ``init_opt_state`` of them), the
    batch global; this rank's shards are updated."""
    return _counted(_train_step(config, mesh, learning_rate, seq_parallel,
                                remat, use_flash), "bert_train", mesh)


def _train_step(config, mesh, learning_rate, seq_parallel, remat,
                use_flash):
    _check_mesh(mesh)
    if mesh is not None:
        return _make_sharded_step(config, mesh, learning_rate, seq_parallel,
                                  use_flash, _mlm_sums)
    loss_fn = _make_loss_fn(config, mesh, seq_parallel, remat, use_flash)

    def step(params, opt_state, batch, iteration):
        loss, grads = _optim.value_and_grad(loss_fn, params, batch)
        _optim.adam_apply(params, grads, opt_state, learning_rate,
                          iteration)
        return params, opt_state, loss

    return step


def make_scanned_train_step(config: BertConfig, n_steps: int, mesh=None,
                            learning_rate: float = 1e-4,
                            seq_parallel: bool = False, remat: bool = True,
                            use_flash: bool = False):
    """``n_steps`` chained train steps in one call: ``(params, opt_state,
    batch, start_iteration) -> (params, opt_state, losses[n_steps])``.
    One step is captured and replayed ``n_steps`` times, back to back on
    the device; the losses stay there (no host sync per step), so the
    caller's one synchronisation covers all ``n_steps`` and the
    trajectory shows that training stepped. One census event per
    signature, as the JAX package's one scanned executable."""
    return _counted(_train_step(config, mesh, learning_rate, seq_parallel,
                                remat, use_flash), "bert_train", mesh,
                    n_steps)


def _make_sharded_step(config, mesh, learning_rate, seq_parallel, use_flash,
                       sums, tree_key=None):
    """The mesh train step over ``sums`` (the loss's sum and count on
    this rank's rows); ``tree_key`` names the BERT subtree of the params
    (the QA step's ``"bert"``)."""
    shard = _Shard(mesh, seq_parallel)

    def step(params, opt_state, batch, iteration):
        specs = _specs_of(params)
        seen = {}

        def objective(p, b):
            part, seen["loss"] = _sharded_objective(
                p, b, config, mesh, seq_parallel, use_flash, sums, specs)
            return part
        _, grads = _optim.value_and_grad(objective, params, batch)
        grads = shard.reduce_grads(grads, specs)
        _optim.adam_apply(params, grads, opt_state, learning_rate,
                          iteration)
        return params, opt_state, seen["loss"]

    return step


# -- SQuAD-style QA fine-tune head -----------------------------------------

def init_qa_params(config: BertConfig, seed: int = 0, *,
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> Dict:
    """Span-extraction head: start/end logits per token."""
    gen = _generator(seed, generator, device)
    w = 0.02 * torch.randn((config.hidden_size, 2), generator=gen,
                           device=device)
    return {"w": w.to(config.dtype),
            "b": torch.zeros((2,), dtype=torch.float32, device=device)}


def qa_logits(params, qa_params, batch, config: BertConfig, mesh=None):
    enc = encode(params, batch["input_ids"], batch.get("token_type_ids"),
                 batch.get("attention_mask"), config=config, mesh=mesh)
    return _qa_head(qa_params, enc)


def _qa_head(qa_params, enc):
    logits = torch.einsum("bte,ek->btk", enc, qa_params["w"]).float() \
        + qa_params["b"]
    return logits[..., 0], logits[..., 1]      # start, end [B, T]


def _qa_ce_sum(start_logits, end_logits, batch):
    """The sum over rows of the span cross entropy's two halves, halved."""
    mask = batch.get("attention_mask")
    if mask is not None:
        big_neg = torch.finfo(torch.float32).min
        start_logits = torch.where(mask.bool(), start_logits, big_neg)
        end_logits = torch.where(mask.bool(), end_logits, big_neg)

    def ce(logits, positions):
        lsm = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lsm, -1, positions.long()[:, None])[:, 0].sum()

    return 0.5 * (ce(start_logits, batch["start_positions"]) +
                  ce(end_logits, batch["end_positions"]))


def _qa_sums(all_params, batch, config, use_flash, shard=None, off=0):
    """(the QA loss summed over this rank's rows, their count)."""
    enc = _encode(all_params["bert"], batch["input_ids"],
                  batch.get("token_type_ids"), batch.get("attention_mask"),
                  config, use_flash, shard, off)
    s, e = _qa_head(all_params["qa"], enc)
    n = torch.tensor(batch["input_ids"].shape[0], device=enc.device)
    return _qa_ce_sum(s, e, batch), n


def qa_loss(params, qa_params, batch, config: BertConfig, mesh=None):
    """Cross entropy over start/end positions (the SQuAD objective)."""
    start_logits, end_logits = qa_logits(params, qa_params, batch, config,
                                         mesh)
    return _qa_ce_sum(start_logits, end_logits, batch) \
        / batch["input_ids"].shape[0]


def make_qa_train_step(config: BertConfig, mesh=None,
                       learning_rate: float = 3e-5):
    """Fine-tune step over ``{"bert": params, "qa": qa_params}``: encoder
    and QA head trained jointly, updated in place. On a mesh the params
    are placed (``place_params`` for ``"bert"``, the head replicated)
    and the batch global."""
    _check_mesh(mesh)
    if mesh is not None:
        return _counted(_make_sharded_step(config, mesh, learning_rate,
                                           False, False, _qa_sums),
                        "bert_qa", mesh)

    def loss_fn(all_params, batch):
        return qa_loss(all_params["bert"], all_params["qa"], batch, config)

    def step(all_params, opt_state, batch, iteration):
        loss, grads = _optim.value_and_grad(loss_fn, all_params, batch)
        _optim.adam_apply(all_params, grads, opt_state, learning_rate,
                          iteration)
        return all_params, opt_state, loss

    return _counted(step, "bert_qa")


# -- pipeline parallelism (dp x pp, with tp inside the stages) ---------------

def to_pipeline_params(params, n_stages: int):
    """Encoder layers grouped into ``n_stages`` stages and stacked (a
    leading stage dim); embeddings and heads unchanged."""
    from ..parallel.pipeline import split_stages, stack_stage_params
    groups = split_stages(params["layers"], n_stages)
    return {"embeddings": params["embeddings"],
            "stages": stack_stage_params(groups),
            "mlm": params["mlm"], "pooler": params["pooler"]}


def from_pipeline_params(pp_params):
    """Inverse of :func:`to_pipeline_params` over global arrays (gather
    placed ones first: ``common.mesh.gather_tree``)."""
    stages = pp_params["stages"]
    n_stages = _optim.tree_leaves(stages)[0].shape[0]
    layers = []
    for s in range(n_stages):
        layers.extend(_optim.tree_unflatten(
            stages, [x[s] for x in _optim.tree_leaves(stages)]))
    return {"embeddings": pp_params["embeddings"], "layers": layers,
            "mlm": pp_params["mlm"], "pooler": pp_params["pooler"]}


def pipeline_stage_specs(stages, tensor_parallel: bool = False):
    """Specs of the stage-stacked leaves: the stage dim over ``pipe``;
    with ``tensor_parallel`` the heads and the MLP's intermediate dim over
    ``tensor`` too (Megatron's layout)."""
    if not tensor_parallel:
        return _optim.tree_unflatten(
            stages, [P(PIPE)] * len(_optim.tree_leaves(stages)))
    attn = {"wq": P(PIPE, None, TENSOR, None),
            "wk": P(PIPE, None, TENSOR, None),
            "wv": P(PIPE, None, TENSOR, None),
            "bq": P(PIPE, TENSOR, None), "bk": P(PIPE, TENSOR, None),
            "bv": P(PIPE, TENSOR, None),
            "wo": P(PIPE, TENSOR, None, None), "bo": P(PIPE)}
    mlp = {"w1": P(PIPE, None, TENSOR), "b1": P(PIPE, TENSOR),
           "w2": P(PIPE, TENSOR, None), "b2": P(PIPE)}
    layer = {"attn": attn, "mlp": mlp, "ln1_g": P(PIPE), "ln1_b": P(PIPE),
             "ln2_g": P(PIPE), "ln2_b": P(PIPE)}
    return [layer for _ in stages]


def place_pipeline_params(pipe_params, mesh: Mesh,
                          tensor_parallel: bool = False):
    """This rank's stage (and, with ``tensor_parallel``, its tensor
    shard) of global stage-stacked params; embeddings and heads
    replicated."""
    _check_mesh(mesh)

    def repl(tree):
        return _optim.tree_unflatten(tree, [
            place(x, mesh, P()) for x in _optim.tree_leaves(tree)])
    specs = pipeline_stage_specs(pipe_params["stages"], tensor_parallel)
    return {"embeddings": repl(pipe_params["embeddings"]),
            "stages": tree_map_specs(lambda x, sp: place(x, mesh, sp),
                                     pipe_params["stages"], specs),
            "mlm": repl(pipe_params["mlm"]),
            "pooler": repl(pipe_params["pooler"])}


def make_pipeline_train_step(config: BertConfig, mesh: Mesh,
                             n_microbatches: int,
                             learning_rate: float = 1e-4,
                             remat: bool = True, schedule: str = "1f1b",
                             tensor_parallel: bool = False):
    """BERT training with the encoder pipelined over ``pipe``, data
    parallel over ``(data, fsdp)`` and, with ``tensor_parallel``,
    Megatron TP over ``tensor`` inside each stage. The embedding and the
    MLM head are the pipeline's ends; the loss is scored on the last
    stage. ``schedule``: ``"1f1b"`` (the default) or ``"gpipe"``. Use with
    ``place_pipeline_params(to_pipeline_params(init_params(...), S),
    mesh, tensor_parallel)``; every rank passes the global batch (its
    rows divide by ``n_microbatches`` x dp)."""
    _check_mesh(mesh)
    from ..parallel.pipeline import (make_pipeline_loss,
                                     make_pipeline_loss_1f1b)
    c = config
    shard = _Shard(mesh, False)
    if not tensor_parallel:
        shard.tp_axis = None

    def stage_fn(stage_layers, h):
        for layer in stage_layers:
            attn_out = _attention(layer, h, None, c, shard=shard)
            h = _ln(h + attn_out, layer["ln1_g"], layer["ln1_b"],
                    c.layer_norm_eps)
            mlp = layer["mlp"]
            h_in = h
            if shard.tp_axis is not None:
                from ..parallel.pipeline import tp_copy
                h_in = tp_copy(h, TENSOR, mesh)
            inter = _gelu(torch.einsum("bte,ef->btf", h_in, mlp["w1"])
                          + mlp["b1"])
            part = torch.einsum("btf,fe->bte", inter, mlp["w2"])
            if shard.tp_axis is not None:
                from ..parallel.pipeline import tp_reduce
                part = tp_reduce(part, TENSOR, mesh)
            h = _ln(h + part + mlp["b2"], layer["ln2_g"], layer["ln2_b"],
                    c.layer_norm_eps)
        return h

    def head_fn(head_params, y, aux):
        m = head_params["mlm"]
        h = _gelu(torch.einsum("bte,ef->btf", y, m["dense"]) + m["dense_b"])
        h = _ln(h, m["ln_g"], m["ln_b"], c.layer_norm_eps)
        logits = torch.einsum("bte,ve->btv", h, head_params["word"])
        logits = logits.float() + m["bias"]
        labels = aux["labels"].long()
        valid = labels >= 0
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  torch.where(valid, labels, 0).reshape(-1),
                                  reduction="none").reshape(labels.shape)
        per_tok = torch.where(valid, per_tok, 0.0)
        return per_tok.sum(), valid.sum().float()

    if schedule == "1f1b":
        pipe_loss = make_pipeline_loss_1f1b(stage_fn, head_fn, mesh,
                                            n_microbatches)
    elif schedule == "gpipe":
        pipe_loss = make_pipeline_loss(stage_fn, head_fn, mesh,
                                       n_microbatches, remat=remat)
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         "(expected '1f1b' or 'gpipe')")

    def loss_fn(params, batch):
        e = params["embeddings"]
        ids = batch["input_ids"]
        T = ids.shape[1]
        h = e["word"][ids.long()] + e["position"][None, :T]
        tt = batch.get("token_type_ids")
        h = h + (e["token_type"][tt.long()] if tt is not None
                 else e["token_type"][0])
        h = _ln(h, e["ln_g"], e["ln_b"], c.layer_norm_eps)
        head_params = {"mlm": params["mlm"], "word": e["word"]}
        loss_sum, wsum = pipe_loss(params["stages"], head_params, h,
                                   {"labels": batch["labels"]})
        return loss_sum / torch.clamp(wsum, min=1.0)

    def step(params, opt_state, batch, iteration):
        loss, grads = _optim.value_and_grad(loss_fn, params, batch)
        _optim.adam_apply(params, grads, opt_state, learning_rate,
                          iteration)
        return params, opt_state, loss

    step = _counted(step, "bert_pipeline", mesh)
    step.loss_fn = loss_fn  # exposed for gradient-level parity tests
    return step


# -- optimizer state and accounting -----------------------------------------

def init_opt_state(params):
    """Zero Adam moments ``(u_list, m_list)``, f32, one per params leaf."""
    return _optim.adam_init(params)


def flops_per_token(config: BertConfig) -> float:
    """Training FLOPs/token ~ 6 * matmul params (for MFU)."""
    c = config
    E, Fi, L = c.hidden_size, c.intermediate_size, c.num_layers
    per_layer = 4 * E * E + 2 * E * Fi  # qkv+o projections + mlp matmuls
    embed_head = c.vocab_size * E       # tied mlm decoder matmul
    matmul_params = L * per_layer + embed_head + E * E
    return 6.0 * matmul_params


def count_params(params) -> int:
    return sum(int(p.numel()) for p in _optim.tree_leaves(params))
