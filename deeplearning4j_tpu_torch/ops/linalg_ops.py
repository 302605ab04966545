"""Matrix products: the "blas" half of the linear-algebra ops.

Counterpart of the ``matmul`` / ``batched_gemm`` / ``tensormmul`` /
``einsum`` ops of ``deeplearning4j_tpu/ops/linalg_ops.py`` (the
reference's ``headers/blas.h``): ``SDVariable.mmul`` and ``@`` record
``matmul``. On the card an f32 product computes in f32 under the
callers' ``full_f32()`` (SameDiff's ``output`` / ``fit`` /
``calculate_gradients``). The decompositions of that file (cholesky, qr,
svd, lu, solve, ...) are pending (``ops/pending.py``).
"""
from __future__ import annotations

import torch

from ._util import ints
from .registry import op


@op("matmul", "blas", aliases=("mmul", "gemm"))
def matmul(a, b, transpose_a=False, transpose_b=False, alpha=1.0, beta=0.0,
           c=None):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    out = torch.matmul(a, b)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


@op("batched_gemm", "blas")
def batched_gemm(a, b, transpose_a=False, transpose_b=False):
    return matmul(a, b, transpose_a, transpose_b)


@op("tensormmul", "blas", aliases=("tensordot",))
def tensormmul(a, b, axes_a, axes_b):
    return torch.tensordot(a, b, dims=(list(ints(axes_a)),
                                       list(ints(axes_b))))


@op("einsum", "blas")
def einsum(*operands, equation):
    """General contraction (the TF / ONNX Einsum import target)."""
    return torch.einsum(equation, *operands)
