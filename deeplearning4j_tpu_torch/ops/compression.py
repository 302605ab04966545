"""Gradient compression ops.

Counterpart of ``deeplearning4j_tpu/ops/compression.py`` (the
reference's ``encode_threshold`` / ``decode_threshold``,
``encode_bitmap`` / ``decode_bitmap``, ``headers/compression.h``). The
encoding is the JAX package's dense one, not the reference's
variable-length index list: an int8 sign field {-1, 0, +1} beside the
residual update, which keeps the update's dtype.
"""
from __future__ import annotations

import torch

from ._util import dtype_of
from .registry import op


@op("encode_threshold", "compression", differentiable=False)
def encode_threshold(updates, threshold=1e-3):
    """``(residual, encoded)``: +1 where the update is above
    ``threshold``, -1 where it is below ``-threshold``; the applied
    quantity is ``threshold * sign``."""
    encoded = ((updates > threshold).to(torch.int8)
               - (updates < -threshold).to(torch.int8))
    residual = updates - encoded.to(updates.dtype) * threshold
    return residual, encoded


@op("decode_threshold", "compression", differentiable=False)
def decode_threshold(encoded, threshold=1e-3, dtype=torch.float32):
    return encoded.to(dtype_of(dtype)) * threshold


@op("encode_bitmap", "compression", differentiable=False)
def encode_bitmap(updates, threshold=1e-3):
    """The reference's 2-bit bitmap: the same dense sign field here."""
    return encode_threshold(updates, threshold)


@op("decode_bitmap", "compression", differentiable=False)
def decode_bitmap(encoded, threshold=1e-3, dtype=torch.float32):
    return encoded.to(dtype_of(dtype)) * threshold
