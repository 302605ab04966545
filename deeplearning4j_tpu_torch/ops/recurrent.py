"""Recurrent ops: LSTM / GRU / SRU cells and the layers over them.

Counterpart of ``deeplearning4j_tpu/ops/recurrent.py`` (the reference's
``headers/recurrent.h``: lstmLayer / lstmLayerCell, gru / gruCell,
sru / sru_bi, static / dynamic rnn), under the same names, gate layouts
and arguments. Each time loop is a Python loop over the op's step
function that carries the state as the JAX ``lax.scan`` does; the
sequence output is the steps' states stacked.

Each op keeps its products per step as the JAX op has them: no input
projection is hoisted out of the loop, so a step of ``lstm_layer`` runs
the same two GEMM shapes as ``lstm_cell`` and the cached seq2seq decode
stays token-identical to the recompute loop on the card.

A ``mask`` is a ``[B, T]`` keep-mask (Keras Masking): a masked step
carries ``h`` (and ``c``) through unchanged, so the output repeats the
last valid step's and the returned final state is the last valid one.
"""
from __future__ import annotations

import torch

from .registry import op


def _time_major(x, time_major):
    """``x`` as a contiguous ``[T, B, ...]`` tensor (each step's rows
    contiguous, as the cell's products see them in a decode step)."""
    return x.contiguous() if time_major else x.transpose(0, 1).contiguous()


def _batch_major(seq, time_major):
    return seq if time_major else seq.transpose(0, 1)


def _activation(act):
    """A torch callable as it is; a name through the layer API's table."""
    if callable(act):
        return act
    from ..nn.activations import get_activation
    return get_activation(act)


@op("lstmLayerCell", "recurrent", aliases=("lstmCell",))
def lstm_cell(x, h_prev, c_prev, w_x, w_h, b=None, forget_bias=0.0):
    """One LSTM step. Gate blocks ordered [i, f, g(cell), o] along -1.

    x: [B, In]; h_prev / c_prev: [B, H]; w_x: [In, 4H]; w_h: [H, 4H];
    b: [4H]."""
    z = torch.matmul(x, w_x) + torch.matmul(h_prev, w_h)
    if b is not None:
        z = z + b
    H = h_prev.shape[-1]
    i, f, g, o = (z[..., :H], z[..., H:2 * H], z[..., 2 * H:3 * H],
                  z[..., 3 * H:])
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


def _mask_tm(mask, x_tm):
    """[B, T] keep-mask -> [T, B, 1] bool aligned with time-major x."""
    if tuple(mask.shape[::-1]) != tuple(x_tm.shape[:2]):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} does not match sequence "
            f"[B, T] = {tuple(x_tm.shape[:2][::-1])}")
    return mask.transpose(0, 1)[..., None].bool()


def _scan(step, carry, xs, mask):
    """Run ``step(carry, x_t) -> (carry, out_t)`` over the time axis of
    ``xs`` ([T, B, ...]); with a mask, a masked step keeps the previous
    carry (each state tensor of it) and emits it. Returns (carry, [T, ...]
    stacked outputs)."""
    outs = []
    for t in range(xs.shape[0]):
        new, out = step(carry, xs[t])
        if mask is not None:
            m = mask[t]
            if isinstance(new, tuple):
                new = tuple(torch.where(m, n, c) for n, c in zip(new, carry))
                out = new[0]
            else:
                new = torch.where(m, new, carry)
                out = new
        carry = new
        outs.append(out)
    return carry, torch.stack(outs)


@op("lstmLayer", "recurrent", aliases=("lstm",))
def lstm_layer(x, w_x, w_h, b=None, h0=None, c0=None, forget_bias=0.0,
               time_major=False, return_sequence=True, mask=None):
    """Full-sequence LSTM.

    x: [B, T, In] (or [T, B, In] when time_major); returns (h_seq, h_T,
    c_T), or (h_T, c_T) without ``return_sequence``. ``mask``: optional
    [B, T] keep-mask (see the module docstring)."""
    x = _time_major(x, time_major)
    B = x.shape[1]
    H = w_h.shape[0]
    h0 = h0 if h0 is not None else x.new_zeros((B, H))
    c0 = c0 if c0 is not None else x.new_zeros((B, H))
    m = _mask_tm(mask, x) if mask is not None else None

    def step(carry, x_t):
        h, c = lstm_cell(x_t, carry[0], carry[1], w_x, w_h, b, forget_bias)
        return (h, c), h

    (h_last, c_last), h_seq = _scan(step, (h0, c0), x, m)
    if return_sequence:
        return _batch_major(h_seq, time_major), h_last, c_last
    return h_last, c_last


def _merge(fwd, bwd, mode):
    if mode == "concat":
        return torch.cat([fwd, bwd], dim=-1)
    if mode == "add":
        return fwd + bwd
    if mode == "mul":
        return fwd * bwd
    return (fwd + bwd) / 2


@op("lstmLayer_bidirectional", "recurrent")
def lstm_layer_bidirectional(x, w_x_f, w_h_f, b_f, w_x_b, w_h_b, b_b,
                             mode="concat"):
    """Bidirectional LSTM over [B, T, In]; merge modes of the reference's
    Bidirectional.Mode: concat | add | mul | ave."""
    fwd, hf, cf = lstm_layer(x, w_x_f, w_h_f, b_f)
    bwd, hb, cb = lstm_layer(torch.flip(x, dims=(1,)), w_x_b, w_h_b, b_b)
    bwd = torch.flip(bwd, dims=(1,))
    return _merge(fwd, bwd, mode), (hf, cf), (hb, cb)


def _gru_gates(x, h_prev, w_ru, w_c, b_ru, b_c):
    xh = torch.cat([x, h_prev], dim=-1)
    ru = torch.matmul(xh, w_ru)
    if b_ru is not None:
        ru = ru + b_ru
    H = h_prev.shape[-1]
    r = torch.sigmoid(ru[..., :H])
    u = torch.sigmoid(ru[..., H:])
    xrh = torch.cat([x, r * h_prev], dim=-1)
    c = torch.matmul(xrh, w_c)
    if b_c is not None:
        c = c + b_c
    c = torch.tanh(c)
    return r, u, c, u * h_prev + (1.0 - u) * c


@op("gruCell", "recurrent")
def gru_cell(x, h_prev, w_ru, w_c, b_ru=None, b_c=None):
    """GRU step, the reference gruCell layout: [r, u] fused, then the
    candidate over [x, r * h].

    x: [B, In]; h_prev: [B, H]; w_ru: [In+H, 2H]; w_c: [In+H, H]."""
    return _gru_gates(x, h_prev, w_ru, w_c, b_ru, b_c)[3]


@op("gru_block_cell", "recurrent")
def gru_block_cell(x, h_prev, w_ru, w_c, b_ru=None, b_c=None):
    """gruCell with all four reference outputs (r, u, c, h): the TF
    GRUBlockCell layout."""
    return _gru_gates(x, h_prev, w_ru, w_c, b_ru, b_c)


@op("gru", "recurrent")
def gru(x, h0, w_ru, w_c, b_ru=None, b_c=None, time_major=False, mask=None):
    """Full-sequence GRU over gruCell; returns (h_seq, h_T)."""
    x = _time_major(x, time_major)
    m = _mask_tm(mask, x) if mask is not None else None

    def step(h, x_t):
        h = gru_cell(x_t, h, w_ru, w_c, b_ru, b_c)
        return h, h

    h_last, h_seq = _scan(step, h0, x, m)
    return _batch_major(h_seq, time_major), h_last


@op("gru_onnx", "recurrent")
def gru_onnx(x, w, r, b=None, h0=None, linear_before_reset=0,
             time_major=True, mask=None):
    """GRU with the ONNX weight layout and both candidate conventions
    (``linear_before_reset=1`` is torch's and Keras' ``reset_after``,
    which the fused [x, r*h] gruCell cannot express).

    x [T, B, In]; w [3H, In] gate rows (z, r, h); r [3H, H]; b [6H] (Wb
    z, r, h then Rb z, r, h). Returns (h_seq [T, B, H], h_last [B, H])."""
    H = r.shape[-1]
    if b is None:
        b = x.new_zeros((6 * H,))
    wz, wr, wh = w[:H], w[H:2 * H], w[2 * H:]
    rz, rr, rh = r[:H], r[H:2 * H], r[2 * H:]
    wbz, wbr, wbh = b[:H], b[H:2 * H], b[2 * H:3 * H]
    rbz, rbr, rbh = b[3 * H:4 * H], b[4 * H:5 * H], b[5 * H:]
    x = _time_major(x, time_major)
    if h0 is None:
        h0 = x.new_zeros((x.shape[1], H))
    m = _mask_tm(mask, x) if mask is not None else None

    def step(h, x_t):
        z = torch.sigmoid(x_t @ wz.T + h @ rz.T + wbz + rbz)
        g = torch.sigmoid(x_t @ wr.T + h @ rr.T + wbr + rbr)
        if linear_before_reset:
            hh = torch.tanh(x_t @ wh.T + g * (h @ rh.T + rbh) + wbh)
        else:
            hh = torch.tanh(x_t @ wh.T + (g * h) @ rh.T + rbh + wbh)
        h = z * h + (1.0 - z) * hh
        return h, h

    h_last, h_seq = _scan(step, h0, x, m)
    return _batch_major(h_seq, time_major), h_last


@op("sruCell", "recurrent")
def sru_cell(x_t, c_prev, w, b):
    """Simple Recurrent Unit step (the reference sru family).

    w: [In, 3H] giving [x_tilde, f, r]; b: [2H]."""
    z = torch.matmul(x_t, w)
    H = c_prev.shape[-1]
    x_tilde, f_in, r_in = z[..., :H], z[..., H:2 * H], z[..., 2 * H:]
    f = torch.sigmoid(f_in + b[..., :H])
    r = torch.sigmoid(r_in + b[..., H:])
    c = f * c_prev + (1 - f) * x_tilde
    h = r * torch.tanh(c) + (1 - r) * x_t[..., :H]
    return h, c


@op("sru", "recurrent")
def sru(x, c0, w, b, time_major=False):
    """Full-sequence SRU; returns (h_seq, c_T)."""
    x = _time_major(x, time_major)

    def step(c, x_t):
        h, c = sru_cell(x_t, c, w, b)
        return c, h

    c_last, h_seq = _scan(step, c0, x, None)
    return _batch_major(h_seq, time_major), c_last


@op("static_rnn", "recurrent", aliases=("dynamic_rnn",))
def simple_rnn(x, w_x, w_h, b=None, h0=None, activation=torch.tanh,
               time_major=False, mask=None):
    """Elman RNN, ``h = act(x W_x + h W_h + b)``; returns (h_seq, h_T).
    ``activation`` is a torch callable or a name of the layer API's
    activation table (``nn/activations.py``)."""
    act = _activation(activation)
    x = _time_major(x, time_major)
    B = x.shape[1]
    H = w_h.shape[0]
    h0 = h0 if h0 is not None else x.new_zeros((B, H))
    m = _mask_tm(mask, x) if mask is not None else None

    def step(h, x_t):
        z = torch.matmul(x_t, w_x) + torch.matmul(h, w_h)
        if b is not None:
            z = z + b
        h = act(z)
        return h, h

    h_last, h_seq = _scan(step, h0, x, m)
    return _batch_major(h_seq, time_major), h_last


@op("lstmBlockCell", "recurrent")
def lstm_block_cell(x, h_prev, c_prev, w, b, wci=None, wcf=None, wco=None,
                    forget_bias=1.0, clip_value=0.0):
    """TF-style LSTMBlockCell: fused weights w [In+H, 4H] ordered [i,
    c(g), f, o], optional peepholes, the cell clipped to ``clip_value``
    where it is > 0. Returns (i, c, f, o, g, tanh(c), h)."""
    z = torch.matmul(torch.cat([x, h_prev], dim=-1), w) + b
    H = h_prev.shape[-1]
    i, g, f, o = (z[..., :H], z[..., H:2 * H], z[..., 2 * H:3 * H],
                  z[..., 3 * H:])
    if wci is not None:
        i = i + c_prev * wci
    if wcf is not None:
        f = f + c_prev * wcf
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    c = f * c_prev + i * g
    if clip_value > 0:
        c = torch.clamp(c, -clip_value, clip_value)
    if wco is not None:
        o = o + c * wco
    o = torch.sigmoid(o)
    h = o * torch.tanh(c)
    return i, c, f, o, g, torch.tanh(c), h


@op("lstmBlock", "recurrent")
def lstm_block(x, h0, c0, w, b, wci=None, wcf=None, wco=None,
               forget_bias=1.0, clip_value=0.0, time_major=True):
    """Full-sequence TF-style block LSTM; returns (h_seq, h_T, c_T)."""
    x = _time_major(x, time_major)

    def step(carry, x_t):
        outs = lstm_block_cell(x_t, carry[0], carry[1], w, b, wci, wcf,
                               wco, forget_bias, clip_value)
        return (outs[6], outs[1]), outs[6]

    (h_last, c_last), h_seq = _scan(step, (h0, c0), x, None)
    return _batch_major(h_seq, time_major), h_last, c_last


@op("sru_bi", "recurrent")
def sru_bi(x, w_f, b_f, w_b, b_b, c0_f=None, c0_b=None, time_major=False):
    """Bidirectional SRU: forward plus the reversed backward, concat."""
    B = x.shape[1] if time_major else x.shape[0]
    H = w_f.shape[1] // 3
    if c0_f is None:
        c0_f = x.new_zeros((B, H))
    if c0_b is None:
        c0_b = x.new_zeros((B, H))
    fwd, cf = sru(x, c0_f, w_f, b_f, time_major=time_major)
    axis = 0 if time_major else 1
    bwd, cb = sru(torch.flip(x, dims=(axis,)), c0_b, w_b, b_b,
                  time_major=time_major)
    bwd = torch.flip(bwd, dims=(axis,))
    return torch.cat([fwd, bwd], dim=-1), cf, cb


@op("static_bidirectional_rnn", "recurrent",
    aliases=("dynamic_bidirectional_rnn",))
def bidirectional_rnn(x, w_x_f, w_h_f, b_f, w_x_b, w_h_b, b_b, h0_f=None,
                      h0_b=None, activation=torch.tanh, time_major=False):
    """Bidirectional Elman RNN (static and dynamic are one op here, as in
    the JAX package)."""
    fwd_seq, hf = simple_rnn(x, w_x_f, w_h_f, b_f, h0_f, activation,
                             time_major)
    axis = 0 if time_major else 1
    bwd_seq, hb = simple_rnn(torch.flip(x, dims=(axis,)), w_x_b, w_h_b, b_b,
                             h0_b, activation, time_major)
    bwd_seq = torch.flip(bwd_seq, dims=(axis,))
    return torch.cat([fwd_seq, bwd_seq], dim=-1), hf, hb
