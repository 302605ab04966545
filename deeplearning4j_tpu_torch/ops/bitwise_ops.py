"""Bitwise ops.

Counterpart of ``deeplearning4j_tpu/ops/bitwise_ops.py`` (the
reference's ``headers/bitwise.h``). Shift counts follow XLA, not C++: a
count outside ``[0, bits)`` shifts every bit out (0 for a left or a
logical right shift, the sign for an arithmetic right shift), where C++
and x86 leave it undefined or take it modulo the width. The logical
right shift (``lax.shift_right_logical``) is an arithmetic shift with
the sign bits masked off, so it needs no unsigned type on the card.
"""
from __future__ import annotations

import torch

from ._util import tensor_like
from .registry import op

_UNSIGNED = {torch.uint8, torch.bool}
for _n in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _n):
        _UNSIGNED.add(getattr(torch, _n))


def _bits(x: torch.Tensor) -> int:
    return x.element_size() * 8


def _operands(x, s):
    if not isinstance(x, torch.Tensor):
        x = tensor_like(x, s)
    return x, tensor_like(s, x)


def _in_range(s, bits):
    return (s >= 0) & (s < bits)


def _shl(x, s):
    bits = _bits(x)
    ok = _in_range(s, bits)
    out = x << torch.where(ok, s, torch.zeros_like(s))
    return torch.where(ok, out, torch.zeros_like(out))


def _sra(x, s):
    """Arithmetic right shift (a logical one on an unsigned type)."""
    bits = _bits(x)
    ok = _in_range(s, bits)
    out = x >> torch.where(ok, s, torch.zeros_like(s))
    fill = x >> (bits - 1) if x.dtype not in _UNSIGNED else \
        torch.zeros_like(x)
    return torch.where(ok, out, fill)


def _srl(x, s):
    """Logical right shift: the arithmetic one with its sign-filled top
    ``s`` bits cleared (mask ``~(-1 << (bits - s))``, s in [1, bits))."""
    if x.dtype in _UNSIGNED:
        return _sra(x, s)
    bits = _bits(x)
    ok = _in_range(s, bits)
    sc = torch.where(ok, s, torch.zeros_like(s))
    top = torch.clamp(bits - sc, max=bits - 1)
    mask = torch.bitwise_not(torch.full_like(x, -1) << top)
    out = torch.where(sc == 0, x, (x >> sc) & mask)
    return torch.where(ok, out, torch.zeros_like(out))


def _binary(fn):
    def f(x, y):
        x, y = _operands(x, y)
        return fn(x, y)
    return f


op("bitwise_and", "bitwise", differentiable=False)(
    _binary(torch.bitwise_and))
op("bitwise_or", "bitwise", differentiable=False)(_binary(torch.bitwise_or))
op("bitwise_xor", "bitwise", differentiable=False)(
    _binary(torch.bitwise_xor))
op("toggle_bits", "bitwise", differentiable=False)(
    lambda x: torch.bitwise_not(x))
op("shift_bits", "bitwise", differentiable=False)(_binary(_shl))
op("rshift_bits", "bitwise", differentiable=False)(_binary(_sra))


@op("cyclic_shift_bits", "bitwise", differentiable=False)
def cyclic_shift_bits(x, shift):
    x, shift = _operands(x, shift)
    return _shl(x, shift) | _srl(x, _bits(x) - shift)


@op("cyclic_rshift_bits", "bitwise", differentiable=False)
def cyclic_rshift_bits(x, shift):
    x, shift = _operands(x, shift)
    return _srl(x, shift) | _shl(x, _bits(x) - shift)


@op("bits_hamming_distance", "bitwise", differentiable=False)
def bits_hamming_distance(x, y):
    """Set bits of ``x ^ y`` in all, as int32 (``lax.population_count``
    then a sum): a SWAR count over the bytes of the difference."""
    x, y = _operands(x, y)
    b = torch.bitwise_xor(x, y).reshape(-1).view(torch.uint8).to(torch.int32)
    b = b - ((b >> 1) & 0x55)
    b = (b & 0x33) + ((b >> 2) & 0x33)
    return ((b + (b >> 4)) & 0x0F).sum(dtype=torch.int32)
