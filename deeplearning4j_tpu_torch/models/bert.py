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
where the JAX package donates them to its jitted step. ``mesh=`` and
``seq_parallel=True`` (tensor, FSDP and sequence parallelism) are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import flash_attention
from ..quant.transforms import (dequant_matmul, dequantize, take_rows,
                                tied_logits)
from . import _optim

_NOT_PORTED = ("BERT's mesh= and seq_parallel= branches (tensor, FSDP and "
               "sequence parallelism) are not ported yet: ROADMAP.md "
               "queue 1 #10")


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


def _no_mesh(mesh, seq_parallel=False):
    if mesh is not None or seq_parallel:
        raise NotImplementedError(_NOT_PORTED)


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


# -- forward ------------------------------------------------------------

def _attention(layer_params, h, attention_mask, config: BertConfig,
               use_flash: bool = False):
    """Multi-head self-attention of one layer, [B, T, E] -> [B, T, E]."""
    a = layer_params["attn"]
    q = torch.einsum("bte,ehd->bthd", h, dequantize(a["wq"], h.dtype)) \
        + a["bq"]
    k = torch.einsum("bte,ehd->bthd", h, dequantize(a["wk"], h.dtype)) \
        + a["bk"]
    v = torch.einsum("bte,ehd->bthd", h, dequantize(a["wv"], h.dtype)) \
        + a["bv"]
    if use_flash and q.shape[1] >= 2:    # a 1-row query keeps this branch
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
    return out + a["bo"]


def encode(params, input_ids, token_type_ids=None, attention_mask=None, *,
           config: BertConfig, mesh=None, seq_parallel: bool = False,
           use_flash: bool = False):
    """Token ids [B, T] -> contextual encodings [B, T, E]."""
    _no_mesh(mesh, seq_parallel)
    c = config
    e = params["embeddings"]
    T = input_ids.shape[1]
    h = take_rows(e["word"], input_ids, dtype=c.dtype)
    h = h + e["position"][None, :T]
    if token_type_ids is not None:
        h = h + e["token_type"][token_type_ids.long()]
    else:
        h = h + e["token_type"][0]
    h = _ln(h, e["ln_g"], e["ln_b"], c.layer_norm_eps)
    for layer in params["layers"]:
        attn_out = _attention(layer, h, attention_mask, c, use_flash)
        h = _ln(h + attn_out, layer["ln1_g"], layer["ln1_b"],
                c.layer_norm_eps)
        mlp = layer["mlp"]
        inter = _gelu(dequant_matmul(h, mlp["w1"]) + mlp["b1"])
        mlp_out = dequant_matmul(inter, mlp["w2"]) + mlp["b2"]
        h = _ln(h + mlp_out, layer["ln2_g"], layer["ln2_b"],
                c.layer_norm_eps)
    return h


def mlm_logits(params, encodings, config: BertConfig):
    """Masked-LM head with tied decoder weights: f32 logits [B, T, V]."""
    m = params["mlm"]
    h = _gelu(dequant_matmul(encodings, m["dense"]) + m["dense_b"])
    h = _ln(h, m["ln_g"], m["ln_b"], config.layer_norm_eps)
    return tied_logits(h, params["embeddings"]["word"]) + m["bias"]


def pooled(params, encodings):
    return torch.tanh(dequant_matmul(encodings[:, 0], params["pooler"]["w"])
                      + params["pooler"]["b"])


def mlm_loss(params, batch, config: BertConfig, mesh=None,
             seq_parallel=False, use_flash=False):
    """Masked-LM cross entropy. batch: input_ids, labels (negative =
    unmasked), attention_mask and optionally token_type_ids; the mean
    over the masked positions (0 when there are none)."""
    enc = encode(params, batch["input_ids"], batch.get("token_type_ids"),
                 batch.get("attention_mask"), config=config, mesh=mesh,
                 seq_parallel=seq_parallel, use_flash=use_flash)
    logits = mlm_logits(params, enc, config)
    labels = batch["labels"].long()
    valid = labels >= 0
    per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              torch.where(valid, labels, 0).reshape(-1),
                              reduction="none").reshape(labels.shape)
    per_tok = torch.where(valid, per_tok, 0.0)
    return per_tok.sum() / torch.clamp(valid.sum(), min=1)


# -- training step ------------------------------------------------------

def _make_loss_fn(config, mesh, seq_parallel, remat, use_flash):
    _no_mesh(mesh, seq_parallel)

    def loss_fn(params, batch):
        return mlm_loss(params, batch, config, use_flash=use_flash)

    if not remat:
        return loss_fn

    def remat_loss_fn(params, batch):
        # keep only the inputs; the encoder is recomputed in the backward
        return checkpoint(loss_fn, params, batch, use_reentrant=False)
    return remat_loss_fn


def make_train_step(config: BertConfig, mesh=None,
                    learning_rate: float = 1e-4, seq_parallel: bool = False,
                    remat: bool = True, use_flash: bool = False):
    """One train step ``(params, opt_state, batch, iteration) ->
    (params, opt_state, loss)``: forward, masked-LM loss, backward and
    Adam, with params and state updated in place."""
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
    The steps are queued on the device back to back; the losses stay
    there (no host sync per step), so the caller's one synchronisation
    covers all ``n_steps`` and the trajectory shows that training
    stepped."""
    step = make_train_step(config, mesh, learning_rate, seq_parallel,
                           remat, use_flash)

    def scanned(params, opt_state, batch, start_iteration):
        losses = []
        for i in range(n_steps):
            params, opt_state, loss = step(params, opt_state, batch,
                                           start_iteration + i)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return scanned


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
    logits = torch.einsum("bte,ek->btk", enc, qa_params["w"]).float() \
        + qa_params["b"]
    return logits[..., 0], logits[..., 1]      # start, end [B, T]


def qa_loss(params, qa_params, batch, config: BertConfig, mesh=None):
    """Cross entropy over start/end positions (the SQuAD objective)."""
    start_logits, end_logits = qa_logits(params, qa_params, batch, config,
                                         mesh)
    mask = batch.get("attention_mask")
    if mask is not None:
        big_neg = torch.finfo(torch.float32).min
        start_logits = torch.where(mask.bool(), start_logits, big_neg)
        end_logits = torch.where(mask.bool(), end_logits, big_neg)

    def ce(logits, positions):
        lsm = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lsm, -1, positions.long()[:, None])[:, 0].mean()

    return 0.5 * (ce(start_logits, batch["start_positions"]) +
                  ce(end_logits, batch["end_positions"]))


def make_qa_train_step(config: BertConfig, mesh=None,
                       learning_rate: float = 3e-5):
    """Fine-tune step over ``{"bert": params, "qa": qa_params}``: encoder
    and QA head trained jointly, updated in place."""
    _no_mesh(mesh)

    def loss_fn(all_params, batch):
        return qa_loss(all_params["bert"], all_params["qa"], batch, config)

    def step(all_params, opt_state, batch, iteration):
        loss, grads = _optim.value_and_grad(loss_fn, all_params, batch)
        _optim.adam_apply(all_params, grads, opt_state, learning_rate,
                          iteration)
        return all_params, opt_state, loss

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
