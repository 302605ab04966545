"""Convolution and pooling ops.

Counterpart of the part of ``deeplearning4j_tpu/ops/conv_ops.py`` the
ported layers call: ``conv2d`` and the 2-D max / average / p-norm pools.
The JAX package lowers them to ``lax.conv_general_dilated`` and
``lax.reduce_window`` (XLA, no Pallas kernel); here they are
``torch.nn.functional`` calls (cuDNN on the card), registered under the
JAX package's names. The rest of the file (1-D/3-D, transposed,
depthwise, separable, dilation-2D, upsampling) is listed as pending
(``ops/pending.py``) and waits for ``ROADMAP.md`` queue 1 item 9.

Conventions kept from the reference: ``data_format`` "NCHW" (default) or
"NHWC"; weights HWIO ``[kH, kW, inC, outC]``, permuted to torch's OIHW at
the call. Padding is "SAME", "VALID", one int or pair per spatial axis,
or per-side pairs. SAME follows XLA: output ``ceil(in / stride)``, the
odd padded pixel at the end. An asymmetric padding goes through
``F.pad`` (``F.conv2d(padding="same")`` refuses strides above 1); max
pooling pads with ``-inf``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .registry import op

IntOrPair = Union[int, Sequence[int]]


def _pair(v: IntOrPair, n=2) -> Tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pads(size, k, s, d):
    """XLA's SAME padding of one axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _padding(padding, spatial, kernel, strides, dilation) -> List[tuple]:
    """Per-axis (low, high) pads for ``padding``."""
    n = len(spatial)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [_same_pads(spatial[i], kernel[i], strides[i], dilation[i])
                for i in range(n)]
    if isinstance(padding, (list, tuple)) and padding and \
            isinstance(padding[0], (list, tuple)):
        return [tuple(int(x) for x in p) for p in padding]
    return [(p, p) for p in _pair(padding, n)]


def _pad_input(x, pads, value=0.0):
    """``x`` (NC + spatial) padded per axis; returns (x, symmetric pads
    for the op or None when ``x`` was padded here)."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = []
    for lo, hi in reversed(pads):  # F.pad takes the last axis first
        flat += [lo, hi]
    return F.pad(x, flat, value=value), None


def _to_nchw(x, data_format):
    return x if data_format == "NCHW" else x.permute(0, 3, 1, 2)


def _from_nchw(x, data_format):
    return x if data_format == "NCHW" else x.permute(0, 2, 3, 1)


@op("conv2d", "conv")
def conv2d(x, weights, bias=None, strides=(1, 1), padding="SAME",
           dilation=(1, 1), data_format="NCHW", groups=1):
    """2-D convolution; ``weights`` HWIO ``[kh, kw, inC/groups, outC]``."""
    xn = _to_nchw(x, data_format)
    s, d = _pair(strides), _pair(dilation)
    k = tuple(weights.shape[:2])
    pads = _padding(padding, xn.shape[2:], k, s, d)
    xn, sym = _pad_input(xn, pads)
    w = weights.permute(3, 2, 0, 1)
    out = F.conv2d(xn, w, bias, stride=s, padding=sym or 0, dilation=d,
                   groups=int(groups))
    return _from_nchw(out, data_format)


def _pool_input(x, kernel, strides, padding, data_format, value):
    xn = _to_nchw(x, data_format)
    k, s = _pair(kernel), _pair(strides)
    pads = _padding(padding, xn.shape[2:], k, s, (1, 1))
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if any(flat):
        xn = F.pad(xn, flat, value=value)
    return xn, k, s


@op("maxpool2d", "pooling")
def maxpool2d(x, kernel=(2, 2), strides=None, padding="VALID",
              data_format="NCHW"):
    strides = strides if strides is not None else kernel
    xn, k, s = _pool_input(x, kernel, strides, padding, data_format,
                           float("-inf"))
    return _from_nchw(F.max_pool2d(xn, k, s), data_format)


def _window_sum(xn, k, s):
    return F.avg_pool2d(xn, k, s) * (k[0] * k[1])


@op("avgpool2d", "pooling")
def avgpool2d(x, kernel=(2, 2), strides=None, padding="VALID",
              data_format="NCHW", include_pad=True):
    """Average pool; with ``include_pad`` False the divisor counts only
    the window's real cells (keras / TF SAME pooling)."""
    strides = strides if strides is not None else kernel
    xn, k, s = _pool_input(x, kernel, strides, padding, data_format, 0.0)
    out = F.avg_pool2d(xn, k, s)
    if not include_pad and not (isinstance(padding, str)
                                and padding.upper() == "VALID"):
        ones, _, _ = _pool_input(torch.ones_like(_to_nchw(x, data_format)),
                                 kernel, strides, padding, "NCHW", 0.0)
        out = _window_sum(xn, k, s) / _window_sum(ones, k, s)
    return _from_nchw(out, data_format)


@op("pnormpool2d", "pooling")
def pnormpool2d(x, kernel=(2, 2), strides=None, padding="VALID", p=2,
                data_format="NCHW"):
    """``(sum |x|^p) ** (1/p)`` over each window."""
    strides = strides if strides is not None else kernel
    xn, k, s = _pool_input(torch.abs(x) ** p, kernel, strides, padding,
                           data_format, 0.0)
    return _from_nchw(_window_sum(xn, k, s) ** (1.0 / p), data_format)
