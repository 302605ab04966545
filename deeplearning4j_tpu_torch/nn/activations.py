"""Activation functions for the layer API.

Counterpart of ``deeplearning4j_tpu/nn/activations.py`` (the reference's
``Activation`` enum). Names match the reference so configurations
serialize alike; each function is the JAX package's on torch ops (gelu
is the tanh approximation, as ``jax.nn.gelu``'s default).
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "lrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": F.hardsigmoid,
    "tanh": torch.tanh,
    "hardtanh": F.hardtanh,
    "rationaltanh": lambda x: 1.7159 * (0.6666667 * x) / (1.0 + torch.abs(0.6666667 * x)),
    "rectifiedtanh": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x ** 3,
    "swish": F.silu,
    "mish": F.mish,
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)),
}


def get_activation(act: Union[str, Callable]) -> Callable:
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; "
                         f"known: {sorted(_ACTIVATIONS)}") from None


def activation_names():
    return sorted(_ACTIVATIONS)
