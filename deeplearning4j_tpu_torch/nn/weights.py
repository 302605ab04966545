"""Weight initialization.

Counterpart of ``deeplearning4j_tpu/nn/weights.py`` (the reference's
``WeightInit``): the same names, fans and scales, each drawn from the
caller's ``torch.Generator`` on its device. The values differ from the
JAX package's (another generator); tests carry weights across instead.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 4:  # [kH,kW,in,out] HWIO
        rf = shape[0] * shape[1]
        return shape[2] * rf, shape[3] * rf
    if len(shape) == 1:
        return shape[0], shape[0]
    n = 1
    for s in shape[:-1]:
        n *= s
    return n, shape[-1]


def init_weights(generator: torch.Generator, shape,
                 weight_init: Union[str, Callable] = "xavier",
                 dtype=torch.float32):
    """A weight of ``shape`` on ``generator``'s device."""
    if callable(weight_init):
        return weight_init(generator, shape, dtype)
    shape = tuple(int(s) for s in shape)
    dev = generator.device
    wi = weight_init.lower()
    fan_in, fan_out = _fans(shape)

    def normal():
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    def uniform(a):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
        return (2 * u - 1) * a

    if wi == "zero":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if wi == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if wi == "normal":
        return normal() / math.sqrt(fan_in)
    if wi == "uniform":
        return uniform(1.0 / math.sqrt(fan_in))
    if wi in ("xavier", "glorot_normal"):
        return math.sqrt(2.0 / (fan_in + fan_out)) * normal()
    if wi in ("xavier_uniform", "glorot_uniform"):
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if wi in ("relu", "he_normal", "kaiming"):
        return math.sqrt(2.0 / fan_in) * normal()
    if wi in ("relu_uniform", "he_uniform"):
        return uniform(math.sqrt(6.0 / fan_in))
    if wi == "lecun_normal":
        return math.sqrt(1.0 / fan_in) * normal()
    if wi == "lecun_uniform":
        return uniform(math.sqrt(3.0 / fan_in))
    if wi == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError(f"identity init needs a square 2-D shape, "
                             f"got {shape}")
        return torch.eye(shape[0], dtype=dtype, device=dev)
    raise ValueError(f"unknown weight init {weight_init!r}")
