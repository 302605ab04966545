"""Neural-network ops: the softmax family, normalization, attention,
dropout.

Counterpart of ``deeplearning4j_tpu/ops/nn_ops.py`` (the reference's
``headers/nn.h`` and its attention helpers). Attention is the JAX op's
plain product form, as there: the logits of a masked key are filled with
``finfo(dtype).min`` (not ``-inf``), so a fully masked query row gives
the uniform softmax, where ``scaled_dot_product_attention`` gives NaN.
The dropouts take a ``key`` where the JAX ops take a ``jax.random`` key:
an int or a 0-d int64 tensor on the input's device, drawn from by the
counter-based hash of ``common/rng.py`` (so a CUDA graph can hold the
draw, its key read from a static buffer), or a ``torch.Generator`` the
caller seeds. The masks differ from JAX's, only their statistics
compare.
"""
from __future__ import annotations

import math

import torch

from ..common import rng
from ..common.mesh import rows_draw
from ._util import axes
from .registry import op

op("softmax", "nn")(lambda x, axis=-1: torch.softmax(x, dim=axis))
op("log_softmax", "nn")(lambda x, axis=-1: torch.log_softmax(x, dim=axis))


@op("softmax_with_temperature", "nn")
def softmax_with_temperature(x, temperature=1.0, axis=-1):
    return torch.softmax(x / temperature, dim=axis)


@op("biasadd", "nn")
def biasadd(x, bias, nchw=False):
    if nchw:
        return x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return x + bias


@op("xw_plus_b", "nn")
def xw_plus_b(x, w, b, transpose_w=False):
    if transpose_w:
        w = w.T
    return torch.matmul(x, w) + b


@op("relu_layer", "nn")
def relu_layer(x, w, b):
    return torch.clamp(torch.matmul(x, w) + b, min=0.0)


@op("layer_norm", "nn")
def layer_norm(x, gain, bias=None, axis=-1, eps=1e-5):
    """(x - mean) / sqrt(var + eps) * gain + bias over ``axis``, with the
    biased (ddof 0) variance."""
    ax = axes(axis)
    mean = torch.mean(x, dim=ax, keepdim=True)
    var = torch.var(x, dim=ax, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps) * gain
    return y + bias if bias is not None else y


@op("batchnorm", "nn")
def batchnorm(x, mean, variance, gamma=None, beta=None, eps=1e-5, axis=-1):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    y = (x - mean.reshape(shape)) * torch.rsqrt(variance.reshape(shape) + eps)
    if gamma is not None:
        y = y * gamma.reshape(shape)
    if beta is not None:
        y = y + beta.reshape(shape)
    return y


@op("fused_batch_norm", "nn")
def fused_batch_norm(x, scale, offset, mean=None, variance=None, eps=1e-3,
                     training=True, data_format="NHWC"):
    axis = 1 if data_format == "NCHW" else -1
    reduce_axes = tuple(i for i in range(x.dim()) if i != (axis % x.dim()))
    if training or mean is None:
        mean = torch.mean(x, dim=reduce_axes)
        variance = torch.var(x, dim=reduce_axes, correction=0)
    return batchnorm(x, mean, variance, scale, offset, eps, axis), mean, \
        variance


@op("lrn", "nn")
def lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    """Local response normalization over the channel (last) axis."""
    sq = torch.square(x)
    c = x.shape[-1]
    padded = torch.nn.functional.pad(sq, (depth_radius, depth_radius))
    win = sum(padded[..., i:i + c] for i in range(2 * depth_radius + 1))
    return x / torch.pow(bias + alpha * win, beta)


def uniform_like(x, key, shape=None):
    """float32 uniform draws in [0, 1) shaped like ``x`` (or ``shape``)
    from ``key``; a sharded rank's rows of the global batch's draw
    (``rows_draw``)."""
    if isinstance(key, torch.Generator):
        def draw(s):
            return torch.rand(s, generator=key, device=x.device)
    else:
        def draw(s):
            return rng.uniform(key, s, x.device)
    return rows_draw(draw, x.shape if shape is None else shape, x.device)


def _keep_mask(x, keep, key):
    return uniform_like(x, key) < keep


@op("dropout", "nn")
def dropout(x, rate, key, training=True):
    """Inverted dropout: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(_keep_mask(x, keep, key), x / keep,
                       torch.zeros_like(x))


@op("alpha_dropout", "nn")
def alpha_dropout(x, rate, key, training=True):
    if not training or rate == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - rate
    mask = _keep_mask(x, keep, key)
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    return a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b


def _normal_like(x, key):
    if isinstance(key, torch.Generator):
        def draw(s):
            return torch.randn(s, generator=key, device=x.device,
                               dtype=x.dtype)
    else:
        def draw(s):
            return rng.normal(key, s, x.device, x.dtype)
    return rows_draw(draw, x.shape, x.device)


@op("gaussian_dropout", "nn")
def gaussian_dropout(x, rate, key, training=True):
    if not training or rate == 0.0:
        return x
    stddev = math.sqrt(rate / (1.0 - rate))
    return x * (1.0 + stddev * _normal_like(x, key))


@op("gaussian_noise", "nn")
def gaussian_noise(x, stddev, key, training=True):
    if not training:
        return x
    return x + stddev * _normal_like(x, key)


# -- attention ----------------------------------------------------------
@op("dot_product_attention", "attention")
def dot_product_attention(queries, keys, values, mask=None, scale=True,
                          with_weights=False):
    """Scaled dot-product attention over [..., T, dim] (the reference's
    ``dot_product_attention``, trailing contraction); a masked key's
    logit is ``finfo(dtype).min``."""
    d = queries.shape[-1]
    logits = torch.matmul(queries, keys.transpose(-1, -2))
    if scale:
        # sqrt(d) in the logits' dtype, as a host scalar: no copy to the
        # card, so a CUDA graph can hold the step
        logits = logits / torch.sqrt(torch.tensor(d, dtype=logits.dtype))
    if mask is not None:
        big_neg = torch.finfo(logits.dtype).min
        m = mask if mask.dtype == torch.bool else mask != 0
        logits = torch.where(m, logits, torch.full_like(logits, big_neg))
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights, values)
    if with_weights:
        return out, weights
    return out


@op("multi_head_dot_product_attention", "attention")
def multi_head_dot_product_attention(queries, keys, values, wq, wk, wv, wo,
                                     mask=None, scale=True):
    """MHA with projection weights (the reference's
    ``multi_head_dot_product_attention``).

    queries/keys/values: [B, T, E]; wq/wk/wv: [E, H, P]; wo: [H*P, E]."""
    q = torch.einsum("bte,ehp->bhtp", queries, wq)
    k = torch.einsum("bte,ehp->bhtp", keys, wk)
    v = torch.einsum("bte,ehp->bhtp", values, wv)
    if mask is not None and mask.dim() == 2:
        mask = mask[:, None, None, :]
    attn = dot_product_attention(q, k, v, mask=mask, scale=scale)
    b, h, t, p = attn.shape
    out = attn.transpose(1, 2).reshape(b, t, h * p)
    return torch.matmul(out, wo)


@op("l2_normalize", "nn")
def l2_normalize(x, axis=-1, eps=1e-12):
    return x * torch.rsqrt(torch.clamp(
        torch.sum(x * x, dim=axes(axis), keepdim=True), min=eps))
