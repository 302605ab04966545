"""Neural-network ops the ported layers call: ``dropout``, ``batchnorm``
and ``lrn``.

Counterpart of that part of ``deeplearning4j_tpu/ops/nn_ops.py``; the
rest of the file (softmax variants, layer norm, attention, the other
dropouts) is ``ROADMAP.md`` queue 1 item 9. Dropout draws its mask from
a ``torch.Generator`` the caller seeds (where the JAX package takes a
key), so the masks differ from JAX's; only their statistics compare.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def batchnorm(x, mean, variance, gamma=None, beta=None, eps=1e-5, axis=-1):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    y = (x - mean.reshape(shape)) * torch.rsqrt(variance.reshape(shape) + eps)
    if gamma is not None:
        y = y * gamma.reshape(shape)
    if beta is not None:
        y = y + beta.reshape(shape)
    return y


def lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    """Local response normalization over the channel (last) axis."""
    sq = torch.square(x)
    c = x.shape[-1]
    padded = F.pad(sq, (depth_radius, depth_radius))
    win = sum(padded[..., i:i + c] for i in range(2 * depth_radius + 1))
    return x / torch.pow(bias + alpha * win, beta)


def dropout(x, rate, generator: torch.Generator, training=True):
    """Inverted dropout: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
