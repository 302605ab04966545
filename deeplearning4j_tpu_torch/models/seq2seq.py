"""Seq2Seq LSTM: an encoder-decoder trained with teacher forcing, with a
cached greedy decode.

Counterpart of ``deeplearning4j_tpu/models/seq2seq.py`` (BASELINE config
4's Seq2Seq LSTM): the same params layout (so weights bridged from the
JAX package load 1:1), the same loss and the same decode. A train step
is forward, loss, autograd backward and the shared flat Adam, with
params and the Adam state updated IN PLACE where the JAX package donates
them to its jitted step; the step is counted in the dispatch census and,
on the card, captured as one CUDA graph a signature and replayed
(``runtime.inference.captured_train_step``).

``decode_step`` carries the recurrent state ``(h, c)`` — the LSTM's
analog of a KV cache — so ``greedy_decode`` costs one ``lstm_cell`` a
token; ``greedy_decode_recompute`` re-runs the decoder over the whole
prefix a token (O(T²)) and is the reference the cached loop must match
token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import recurrent
from . import _optim


@dataclasses.dataclass
class Seq2SeqConfig:
    vocab_size: int = 64          # shared source / target vocab
    embed_dim: int = 64
    hidden: int = 128
    bos_token: int = 1
    pad_token: int = 0

    @staticmethod
    def tiny() -> "Seq2SeqConfig":
        return Seq2SeqConfig(vocab_size=16, embed_dim=16, hidden=32)


def init_params(c: Seq2SeqConfig, seed: int = 0, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random weights in the JAX package's layout: normal with std 0.1,
    biases zero, f32, drawn from ``generator`` or from a fresh one on
    ``device`` seeded with ``seed``."""
    from ..nn.multilayer import resolve_device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))

    def w(*shape):
        return 0.1 * torch.randn(shape, generator=generator, device=device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    E, H, V = c.embed_dim, c.hidden, c.vocab_size
    return {
        "embed": w(V, E),
        "enc": {"Wx": w(E, 4 * H), "Wh": w(H, 4 * H), "b": zeros(4 * H)},
        "dec": {"Wx": w(E, 4 * H), "Wh": w(H, 4 * H), "b": zeros(4 * H)},
        "out": {"W": w(H, V), "b": zeros(V)},
    }


def _ids(params, ids):
    return torch.as_tensor(ids, device=params["embed"].device).long()


def _encode(params, src_ids):
    """src_ids [B, S] -> (h_T, c_T)."""
    emb = params["embed"][_ids(params, src_ids)]          # [B, S, E]
    _, h, cell = recurrent.lstm_layer(emb, params["enc"]["Wx"],
                                      params["enc"]["Wh"],
                                      params["enc"]["b"])
    return h, cell


def teacher_forcing_logits(params, src_ids, tgt_in_ids):
    """The training forward: the decoder consumes the gold tokens."""
    h0, c0 = _encode(params, src_ids)
    emb = params["embed"][_ids(params, tgt_in_ids)]
    h_seq, _, _ = recurrent.lstm_layer(emb, params["dec"]["Wx"],
                                       params["dec"]["Wh"],
                                       params["dec"]["b"], h0=h0, c0=c0)
    return torch.matmul(h_seq, params["out"]["W"]) + params["out"]["b"]


def loss_fn(params, batch, c: Seq2SeqConfig):
    """batch: src [B, S], tgt_in [B, T] (BOS-shifted), tgt_out [B, T]; the
    mean token cross entropy over non-pad targets, divided by
    max(#valid, 1)."""
    logits = teacher_forcing_logits(params, batch["src"], batch["tgt_in"])
    labels = _ids(params, batch["tgt_out"])
    valid = labels != c.pad_token
    lsm = F.log_softmax(logits, dim=-1)
    per_tok = -torch.gather(lsm, -1, labels[..., None])[..., 0]
    per_tok = torch.where(valid, per_tok, torch.zeros_like(per_tok))
    return torch.sum(per_tok) / torch.clamp_min(valid.sum(), 1)


def make_train_step(c: Seq2SeqConfig, learning_rate: float = 1e-2):
    """One train step ``(params, opt_state, batch, iteration) -> (params,
    opt_state, loss)``: forward, loss, backward and Adam, params and state
    updated in place, counted in the dispatch census and captured on the
    card (``step.graphs``, as BERT's steps)."""
    def loss(params, batch):
        return loss_fn(params, batch, c)

    def step(params, opt_state, batch, iteration):
        loss_value, grads = _optim.value_and_grad(loss, params, batch)
        _optim.adam_apply(params, grads, opt_state, learning_rate,
                          iteration)
        return params, opt_state, loss_value

    from ..runtime.inference import captured_train_step
    return captured_train_step(step, f"seq2seq_train:{id(step)}")


def init_opt_state(params):
    """Zero Adam moments ``(u_list, m_list)``, f32, one per params leaf."""
    return _optim.adam_init(params)


def decode_step(params, cache, tok):
    """ONE cached decode step. ``cache`` is the carried recurrent state
    ``(h, cell)``, the whole summary of the prefix. Returns ``(new_cache,
    logits [B, V])``."""
    h, cell = cache
    emb = params["embed"][_ids(params, tok)]              # [B, E]
    h, cell = recurrent.lstm_cell(emb, h, cell, params["dec"]["Wx"],
                                  params["dec"]["Wh"], params["dec"]["b"])
    logits = torch.matmul(h, params["out"]["W"]) + params["out"]["b"]
    return (h, cell), logits


@torch.no_grad()
def greedy_decode(params, src_ids, max_len: int, c: Seq2SeqConfig):
    """Argmax decode, one ``decode_step`` a token with the cache carried:
    O(T) work. Returns [B, max_len] int32 tokens, left on the device."""
    cache = _encode(params, src_ids)
    tok = torch.full((cache[0].shape[0],), c.bos_token, dtype=torch.int32,
                     device=cache[0].device)
    toks = []
    for _ in range(max_len):
        cache, logits = decode_step(params, cache, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def greedy_decode_recompute(params, src_ids, max_len: int,
                            c: Seq2SeqConfig):
    """The naive O(T²) reference: every token re-runs the decoder LSTM
    over the whole generated prefix from the encoder state. The cached
    ``greedy_decode`` must match it token for token."""
    h0, c0 = _encode(params, src_ids)
    B = h0.shape[0]
    toks = np.full((B, 1), c.bos_token, np.int32)         # BOS + prefix
    out = []
    for _ in range(max_len):
        emb = params["embed"][_ids(params, toks)]
        _, h_last, _ = recurrent.lstm_layer(emb, params["dec"]["Wx"],
                                            params["dec"]["Wh"],
                                            params["dec"]["b"], h0=h0, c0=c0)
        logits = torch.matmul(h_last, params["out"]["W"]) \
            + params["out"]["b"]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        out.append(nxt)
        toks = np.concatenate([toks, nxt[:, None]], axis=1)
    return torch.as_tensor(np.stack(out, axis=1))          # [B, max_len]


def fit_copy_task(c: Seq2SeqConfig = None, steps: int = 300, B: int = 32,
                  S: int = 8, seed: int = 0, task: str = "reverse", *,
                  device="cuda"):
    """Train on a synthetic sequence task (``"reverse"`` or copy); returns
    (params, losses)."""
    c = c or Seq2SeqConfig.tiny()
    rs = np.random.RandomState(seed)
    params = init_params(c, seed, device=device)
    opt = init_opt_state(params)
    step = make_train_step(c)
    losses = []
    for i in range(steps):
        src = rs.randint(2, c.vocab_size, (B, S)).astype(np.int32)
        tgt = src[:, ::-1] if task == "reverse" else src
        tgt_in = np.concatenate(
            [np.full((B, 1), c.bos_token, np.int32), tgt[:, :-1]], axis=1)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            params["embed"].device)
                 for k, v in (("src", src), ("tgt_in", tgt_in),
                              ("tgt_out", tgt))}
        params, opt, loss = step(params, opt, batch, i)
        losses.append(float(loss))
    return params, losses
