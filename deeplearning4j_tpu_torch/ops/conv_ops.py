"""Convolution and pooling ops.

Counterpart of ``deeplearning4j_tpu/ops/conv_ops.py``: the 1-D, 2-D and
3-D convolutions, the transposed, depthwise, separable and pointwise
ones, morphological dilation, the 2-D and 3-D pools (max pooling also
with its argmax), upsampling, ``im2col`` / ``col2im`` and
``extract_image_patches``. The JAX package lowers them to
``lax.conv_general_dilated``, ``lax.conv_transpose`` and
``lax.reduce_window`` (XLA, no Pallas kernel); here they are
``torch.nn.functional`` calls (cuDNN on the card) or slices, registered
under the JAX package's names.

Conventions kept from the reference: ``data_format`` channels first
("NCW", "NCHW", "NCDHW", the defaults) or last; weights spatial dims
first, then in, then out (``[kH, kW, inC, outC]``), permuted to torch's
``[out, in, *k]`` at the call. Padding is "SAME", "VALID", one int or
pair per spatial axis, or per-side pairs. SAME follows XLA: output
``ceil(in / stride)``, the odd padded pixel at the end. An asymmetric
padding goes through ``F.pad`` (``F.conv2d(padding="same")`` refuses
strides above 1); max pooling pads with ``-inf``.

The transposed convolutions are ``lax.conv_transpose(...,
transpose_kernel=True)``: weights ``[*k, outC, inC]``; explicit pads are
lax's own, the pads of the stride-dilated input, not torch's
``padding`` (which crops ``d(k-1) - p``); "SAME" and "VALID" are lax's
``_conv_transpose_padding`` ("SAME" gives ``in * stride``). They run as
``F.conv_transposeNd``, the crop both sides of an axis share given as
torch's ``padding`` and the rest cropped (or zero-padded) after.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ._util import i32
from .registry import op

IntOrPair = Union[int, Sequence[int]]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


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


def _flat_pads(pads):
    """Per-axis (low, high) pads in ``F.pad``'s order (last axis first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return flat


def _pad_input(x, pads, value=0.0):
    """``x`` (NC + spatial) padded per axis; returns (x, symmetric pads
    for the op or None when ``x`` was padded here)."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    return F.pad(x, _flat_pads(pads), value=value), None


def _channels_first(data_format: str) -> bool:
    return data_format.upper().startswith("NC")


def _to_cf(x, data_format):
    """Channels-last ``x`` moved to channels first."""
    if _channels_first(data_format):
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _from_cf(x, data_format):
    if _channels_first(data_format):
        return x
    return x.permute(0, *range(2, x.dim()), 1)


def _torch_weights(w, n):
    """``[*k, a, b]`` weights as torch's ``[b, a, *k]``: a convolution's
    ``[*k, in, out]`` as ``[out, in, *k]``, a transposed one's
    ``[*k, out, in]`` as ``[in, out, *k]``."""
    return w.permute(n + 1, n, *range(n))


def _convnd(x, weights, bias, strides, padding, dilation, data_format, n,
            groups=1):
    xc = _to_cf(x, data_format)
    s, d = _pair(strides, n), _pair(dilation, n)
    k = tuple(weights.shape[:n])
    xc, sym = _pad_input(xc, _padding(padding, xc.shape[2:], k, s, d))
    out = _CONV[n](xc, _torch_weights(weights, n), bias, stride=s,
                   padding=sym or 0, dilation=d, groups=int(groups))
    return _from_cf(out, data_format)


def _add_bias(out, bias, data_format):
    if bias is None:
        return out
    if _channels_first(data_format):
        return out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))
    return out + bias


@op("conv2d", "conv")
def conv2d(x, weights, bias=None, strides=(1, 1), padding="SAME",
           dilation=(1, 1), data_format="NCHW", groups=1):
    """2-D convolution; ``weights`` HWIO ``[kh, kw, inC/groups, outC]``."""
    return _convnd(x, weights, bias, strides, padding, dilation,
                   data_format, 2, groups)


@op("conv1d", "conv")
def conv1d(x, weights, bias=None, strides=1, padding="SAME", dilation=1,
           data_format="NCW"):
    """1-D convolution; ``weights`` WIO ``[k, inC, outC]``."""
    return _convnd(x, weights, bias, strides, padding, dilation,
                   data_format, 1)


@op("conv3dnew", "conv", aliases=("conv3d",))
def conv3d(x, weights, bias=None, strides=(1, 1, 1), padding="SAME",
           dilation=(1, 1, 1), data_format="NCDHW"):
    """3-D convolution; ``weights`` DHWIO ``[kd, kh, kw, inC, outC]``."""
    return _convnd(x, weights, bias, strides, padding, dilation,
                   data_format, 3)


@op("depthwise_conv2d", "conv")
def depthwise_conv2d(x, weights, bias=None, strides=(1, 1), padding="SAME",
                     dilation=(1, 1), data_format="NCHW"):
    """weights ``[kH, kW, inC, depthMultiplier]``: output channel
    ``c * mult + m`` is input channel ``c`` through filter ``m``
    (``groups=inC``)."""
    kh, kw, in_c, mult = weights.shape
    w = weights.reshape(kh, kw, 1, in_c * mult)
    out = _convnd(x, w, None, strides, padding, dilation, data_format, 2,
                  groups=in_c)
    return _add_bias(out, bias, data_format)


@op("sconv2d", "conv", aliases=("separable_conv2d",))
def sconv2d(x, depth_weights, point_weights=None, bias=None, strides=(1, 1),
            padding="SAME", dilation=(1, 1), data_format="NCHW"):
    """Depthwise, then a 1x1 convolution, then the bias."""
    out = depthwise_conv2d(x, depth_weights, None, strides, padding,
                           dilation, data_format)
    if point_weights is not None:
        out = conv2d(out, point_weights, None, (1, 1), "SAME", (1, 1),
                     data_format)
    return _add_bias(out, bias, data_format)


@op("pointwise_conv2d", "conv")
def pointwise_conv2d(x, weights, bias=None, data_format="NCHW"):
    return conv2d(x, weights, bias, (1, 1), "VALID", (1, 1), data_format)


def _transpose_pads(padding, kernel, strides, dilation):
    """lax.conv_transpose's (low, high) pads of the dilated input."""
    n = len(kernel)
    if isinstance(padding, str):
        mode = padding.upper()
        pads = []
        for k, s, d in zip(kernel, strides, dilation):
            k = (k - 1) * d + 1
            if mode == "SAME":
                total = k + s - 2
                lo = k - 1 if s > k - 1 else int(math.ceil(total / 2))
            elif mode == "VALID":
                total = k + s - 2 + max(k - s, 0)
                lo = k - 1
            else:
                raise ValueError(f"unknown padding {padding!r}")
            pads.append((lo, total - lo))
        return pads
    if isinstance(padding, (list, tuple)) and padding and \
            isinstance(padding[0], (list, tuple)):
        return [tuple(int(x) for x in p) for p in padding]
    return [(p, p) for p in _pair(padding, n)]


def _deconvnd(x, weights, bias, strides, padding, dilation, data_format, n):
    """``lax.conv_transpose(..., transpose_kernel=True)`` with weights
    ``[*k, outC, inC]``: ``F.conv_transposeNd`` over the whole window
    (each side padded ``d(k-1)``), cropped or zero-padded to lax's."""
    xc = _to_cf(x, data_format)
    s, d = _pair(strides, n), _pair(dilation, n)
    k = tuple(weights.shape[:n])
    pads = _transpose_pads(padding, k, s, d)
    # crop of each side from the full window; the part both sides share
    # goes to torch's symmetric ``padding``
    crops = [((kk - 1) * dd - lo, (kk - 1) * dd - hi)
             for kk, dd, (lo, hi) in zip(k, d, pads)]
    sym = tuple(max(min(a, b), 0) for a, b in crops)
    out = _CONV_T[n](xc, _torch_weights(weights, n), stride=s, padding=sym,
                     dilation=d)
    rest = [(sy - a, sy - b) for (a, b), sy in zip(crops, sym)]
    if any(lo or hi for lo, hi in rest):
        out = F.pad(out, _flat_pads(rest))   # negative pads crop
    return _add_bias(_from_cf(out, data_format), bias, data_format)


@op("deconv2d", "conv")
def deconv2d(x, weights, bias=None, strides=(1, 1), padding="SAME",
             dilation=(1, 1), data_format="NCHW"):
    """Transposed convolution; weights ``[kH, kW, outC, inC]``."""
    return _deconvnd(x, weights, bias, strides, padding, dilation,
                     data_format, 2)


@op("deconv3d", "conv")
def deconv3d(x, weights, bias=None, strides=(1, 1, 1), padding="SAME",
             dilation=(1, 1, 1), data_format="NCDHW"):
    """3-D transposed convolution; weights ``[kD, kH, kW, outC, inC]``."""
    return _deconvnd(x, weights, bias, strides, padding, dilation,
                     data_format, 3)


@op("dilation2d", "conv")
def dilation2d(x, weights, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """Grayscale morphological dilation (NHWC, weights ``[kH, kW, C]``):
    the max over the window of ``x + w``, as a max over shifted slices.

    TF SAME padding with strides: out = ceil(in/s), pad_total =
    max((out-1)*s + effective_k - in, 0), pad_lo = pad_total // 2, where
    effective_k = (k-1)*rate + 1; the padding is ``-inf``."""
    kh, kw, _ = weights.shape
    sh, sw = strides
    ekh = (kh - 1) * rates[0] + 1
    ekw = (kw - 1) * rates[1] + 1
    H, W = x.shape[1], x.shape[2]
    if padding.upper() == "SAME":
        oh, ow = -(-H // sh), -(-W // sw)
        pth = max((oh - 1) * sh + ekh - H, 0)
        ptw = max((ow - 1) * sw + ekw - W, 0)
        padded = F.pad(x, (0, 0, ptw // 2, ptw - ptw // 2,
                           pth // 2, pth - pth // 2), value=-math.inf)
    else:
        oh, ow = (H - ekh) // sh + 1, (W - ekw) // sw + 1
        padded = x
    out = None
    for i in range(kh):
        for j in range(kw):
            r0, c0 = i * rates[0], j * rates[1]
            sl = padded[:, r0:r0 + (oh - 1) * sh + 1:sh,
                        c0:c0 + (ow - 1) * sw + 1:sw, :] + weights[i, j]
            out = sl if out is None else torch.maximum(out, sl)
    return out


# -- pooling ------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_input(x, kernel, strides, padding, data_format, value, n=2):
    xc = _to_cf(x, data_format)
    k, s = _pair(kernel, n), _pair(strides, n)
    flat = _flat_pads(_padding(padding, xc.shape[2:], k, s, (1,) * n))
    if any(flat):
        xc = F.pad(xc, flat, value=value)
    return xc, k, s


def _max_pool(x, kernel, strides, padding, data_format, n):
    strides = strides if strides is not None else kernel
    xc, k, s = _pool_input(x, kernel, strides, padding, data_format,
                           -math.inf, n)
    return _from_cf(_MAX_POOL[n](xc, k, s), data_format)


def _window_sum(xc, k, s):
    return _AVG_POOL[len(k)](xc, k, s) * math.prod(k)


def _avg_pool(x, kernel, strides, padding, data_format, include_pad, n):
    """Average pool; with ``include_pad`` False the divisor counts only
    the window's real cells (keras / TF SAME pooling)."""
    strides = strides if strides is not None else kernel
    xc, k, s = _pool_input(x, kernel, strides, padding, data_format, 0.0, n)
    out = _AVG_POOL[n](xc, k, s)
    if not include_pad and not (isinstance(padding, str)
                                and padding.upper() == "VALID"):
        ones, _, _ = _pool_input(torch.ones_like(_to_cf(x, data_format)),
                                 kernel, strides, padding, "NC", 0.0, n)
        out = _window_sum(xc, k, s) / _window_sum(ones, k, s)
    return _from_cf(out, data_format)


@op("maxpool2d", "pooling")
def maxpool2d(x, kernel=(2, 2), strides=None, padding="VALID",
              data_format="NCHW"):
    return _max_pool(x, kernel, strides, padding, data_format, 2)


@op("avgpool2d", "pooling")
def avgpool2d(x, kernel=(2, 2), strides=None, padding="VALID",
              data_format="NCHW", include_pad=True):
    return _avg_pool(x, kernel, strides, padding, data_format, include_pad,
                     2)


@op("pnormpool2d", "pooling")
def pnormpool2d(x, kernel=(2, 2), strides=None, padding="VALID", p=2,
                data_format="NCHW"):
    """``(sum |x|^p) ** (1/p)`` over each window."""
    strides = strides if strides is not None else kernel
    xc, k, s = _pool_input(torch.abs(x) ** p, kernel, strides, padding,
                           data_format, 0.0)
    return _from_cf(_window_sum(xc, k, s) ** (1.0 / p), data_format)


@op("maxpool3dnew", "pooling", aliases=("maxpool3d",))
def maxpool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID",
              data_format="NCDHW"):
    return _max_pool(x, kernel, strides, padding, data_format, 3)


@op("avgpool3dnew", "pooling", aliases=("avgpool3d",))
def avgpool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID",
              data_format="NCDHW", include_pad=True):
    return _avg_pool(x, kernel, strides, padding, data_format, include_pad,
                     3)


@op("max_pool_with_argmax", "pooling", differentiable=False)
def max_pool_with_argmax(x, kernel=(2, 2), strides=None, padding="VALID",
                         data_format="NHWC"):
    """Max pool of an NHWC input with TF-style flat argmax indices into
    it (``(h * W + w) * C + c``, int32). "SAME" pads only at the end, as
    the JAX op does; a tie goes to the first window offset."""
    strides = strides if strides is not None else kernel
    kh, kw = _pair(kernel)
    sh, sw = _pair(strides)
    b, h, w, c = x.shape
    if isinstance(padding, str) and padding.upper() == "SAME":
        out_h, out_w = -(-h // sh), -(-w // sw)
        ph = max((out_h - 1) * sh + kh - h, 0)
        pw = max((out_w - 1) * sw + kw - w, 0)
    else:
        out_h = (h - kh) // sh + 1
        out_w = (w - kw) // sw + 1
        ph = pw = 0
    flat_idx = torch.arange(h * w * c, dtype=torch.int32,
                            device=x.device).reshape(1, h, w, c)
    xp = F.pad(x, (0, 0, 0, pw, 0, ph), value=-math.inf)
    ip = F.pad(flat_idx, (0, 0, 0, pw, 0, ph))
    vals, idxs = [], []
    for i in range(kh):
        for j in range(kw):
            vals.append(xp[:, i:i + out_h * sh:sh, j:j + out_w * sw:sw, :])
            idxs.append(ip[:, i:i + out_h * sh:sh, j:j + out_w * sw:sw, :]
                        .expand(b, -1, -1, -1))
    vstack = torch.stack(vals)           # [kh*kw, B, oh, ow, C]
    win = torch.argmax(vstack, dim=0, keepdim=True)
    out = torch.gather(vstack, 0, win)[0]
    arg = torch.gather(torch.stack(idxs), 0, win)[0]
    return out, i32(arg)


@op("upsampling2d", "conv")
def upsampling2d(x, factor_h=2, factor_w=2, data_format="NCHW"):
    ax = (2, 3) if data_format == "NCHW" else (1, 2)
    x = torch.repeat_interleave(x, factor_h, dim=ax[0])
    return torch.repeat_interleave(x, factor_w, dim=ax[1])


@op("upsampling3d", "conv")
def upsampling3d(x, fd=2, fh=2, fw=2, data_format="NCDHW"):
    ax = (2, 3, 4) if data_format == "NCDHW" else (1, 2, 3)
    for a, f in zip(ax, (fd, fh, fw)):
        x = torch.repeat_interleave(x, f, dim=a)
    return x


@op("im2col", "conv")
def im2col(x, kh, kw, sh=1, sw=1, ph=0, pw=0, dh=1, dw=1):
    """``[B, C, H, W]`` -> ``[B, C, kh, kw, outH, outW]``."""
    b, c, h, w = x.shape
    x = F.pad(x, (pw, pw, ph, ph))
    out_h = (h + 2 * ph - (kh - 1) * dh - 1) // sh + 1
    out_w = (w + 2 * pw - (kw - 1) * dw - 1) // sw + 1
    rows = []
    for i in range(kh):
        rows.append(torch.stack(
            [x[:, :, i * dh:i * dh + out_h * sh:sh,
               j * dw:j * dw + out_w * sw:sw] for j in range(kw)], dim=2))
    return torch.stack(rows, dim=2)


@op("col2im", "conv")
def col2im(cols, sh=1, sw=1, ph=0, pw=0, h=None, w=None, dh=1, dw=1):
    """The adjoint of :func:`im2col`: each column added back at its
    window position, the padding cropped."""
    b, c, kh, kw, out_h, out_w = cols.shape
    img = cols.new_zeros((b, c, h + 2 * ph, w + 2 * pw))
    for i in range(kh):
        for j in range(kw):
            img[:, :, i * dh:i * dh + out_h * sh:sh,
                j * dw:j * dw + out_w * sw:sw] += cols[:, :, i, j]
    return img[:, :, ph:ph + h, pw:pw + w]


@op("extract_image_patches", "conv", differentiable=False)
def extract_image_patches(x, ksizes, strides, rates, padding="VALID"):
    """NHWC patches, ``[B, oh, ow, kh * kw * C]``. "SAME" pads ``k // 2``
    on both sides, as the JAX op does (a 5x5 input with a 2x2 kernel
    gives 6x6, where TF gives 5x5)."""
    kh, kw = ksizes
    same = padding.upper() == "SAME"
    cols = im2col(x.permute(0, 3, 1, 2), kh, kw, strides[0], strides[1],
                  kh // 2 if same else 0, kw // 2 if same else 0,
                  rates[0], rates[1])
    b, c, _, _, oh, ow = cols.shape
    return cols.permute(0, 4, 5, 2, 3, 1).reshape(b, oh, ow, kh * kw * c)
