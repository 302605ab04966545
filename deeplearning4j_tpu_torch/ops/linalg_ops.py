"""Linear-algebra ops.

Counterpart of ``deeplearning4j_tpu/ops/linalg_ops.py`` (the reference's
``headers/blas.h`` and its parity decompositions): the products on
``torch.matmul`` (``SDVariable.mmul`` and ``@`` record ``matmul``; on
the card an f32 product computes in f32 under the callers'
``full_f32()``), the decompositions on ``torch.linalg`` (cuSOLVER on the
card), with ``jnp.linalg``'s conventions where the two libraries part:
- ``cholesky``, ``self_adjoint_eig`` and ``logdet`` use ``(a + aᴴ) / 2``
  (``symmetrize_input=True``), where ``torch.linalg`` reads one triangle;
- a singular or indefinite input gives NaN or inf, as XLA's kernels do,
  not an error (the ``*_ex`` forms, which neither raise nor sync);
- ``lu`` returns ``(lu, perm)`` with ``a[perm] = L @ U`` and ``perm``
  int32, where LAPACK gives 1-based row swaps;
- ``lstsq`` is the SVD's minimum-norm solution with ``jnp.linalg``'s
  default cut-off, ``eps * max(M, N)``, on both devices (on the card
  ``torch.linalg.lstsq`` has only ``gels``, which assumes full rank);
- ``eig`` is complex64; its order and scale, like the column signs of
  ``qr``, ``svd`` and ``self_adjoint_eig``, neither library fixes.
"""
from __future__ import annotations

import torch

from ._util import ints, tensor_like
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


def _inexact(x):
    """``x`` as a tensor of a floating or complex type (float32 for an
    integer one), as ``jnp.linalg`` promotes its inputs."""
    x = torch.as_tensor(x)
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _hermitian(a):
    return (a + a.mH) / 2


@op("cholesky", "linalg")
def cholesky(a, *, upper=False, symmetrize_input=True):
    """The Cholesky factor; where ``a`` is not positive definite, NaN in
    the factor's triangle (zeros in the other), as XLA gives."""
    a = _inexact(a)
    if symmetrize_input:
        a = _hermitian(a)
    low, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0).reshape(info.shape + (1, 1))
    low = torch.where(ok, low, torch.full_like(low, float("nan")).tril())
    return low.mH if upper else low


@op("qr", "linalg")
def qr(x, full_matrices=False):
    q, r = torch.linalg.qr(_inexact(x),
                           mode="complete" if full_matrices else "reduced")
    return q, r


@op("svd", "linalg")
def svd(x, full_matrices=False, compute_uv=True):
    x = _inexact(x)
    if not compute_uv:
        return torch.linalg.svdvals(x)
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@op("matrix_inverse", "linalg")
def matrix_inverse(a):
    return torch.linalg.inv_ex(_inexact(a))[0]


@op("matrix_determinant", "linalg")
def matrix_determinant(a):
    return torch.linalg.det(_inexact(a))


@op("log_matrix_determinant", "linalg")
def log_matrix_determinant(x):
    return torch.linalg.slogdet(_inexact(x))[1]


@op("logdet", "linalg")
def logdet(x):
    low = cholesky(x)
    return 2.0 * torch.sum(torch.log(torch.diagonal(low, dim1=-2, dim2=-1)),
                           dim=-1)


@op("eig", "linalg")
def eig(a):
    w, v = torch.linalg.eig(_inexact(a))
    return w, v


@op("self_adjoint_eig", "linalg")
def self_adjoint_eig(a, UPLO=None, symmetrize_input=True):
    a = _inexact(a)
    if UPLO not in (None, "L", "U"):
        raise ValueError(f"UPLO must be one of None, 'L', or 'U', got {UPLO}")
    if symmetrize_input:
        a = _hermitian(a)
    w, v = torch.linalg.eigh(a, UPLO="U" if UPLO == "U" else "L")
    return w, v


@op("lu", "linalg")
def lu(x):
    """``(lu, perm)``: L below the diagonal (unit diagonal implied), U on
    and above it, and ``x[perm] = L @ U``."""
    lu_mat, pivots, _ = torch.linalg.lu_factor_ex(_inexact(x))
    p, _, _ = torch.lu_unpack(lu_mat, pivots, unpack_data=False)
    # x = P L U, so (Pᵀ x)[i] = x[perm[i]] with P[perm[i], i] = 1
    return lu_mat, torch.argmax(p, dim=-2).to(torch.int32)


@op("solve", "linalg")
def solve(a, b, adjoint=False):
    a, b = _inexact(a), _inexact(b)
    if adjoint:
        a = a.transpose(-1, -2)
    if b.dim() == 1:
        return torch.linalg.solve_ex(a, b.unsqueeze(-1))[0].squeeze(-1)
    # b is a (batch of) matrices, never torch's batch of vectors
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.linalg.solve_ex(a.expand(batch + a.shape[-2:]),
                                 b.expand(batch + b.shape[-2:]))[0]


@op("triangular_solve", "linalg")
def triangular_solve(a, b, lower=True, adjoint=False):
    """``op(a) @ x = b`` for ``x``, reading one triangle of ``a``
    (``op`` the transpose when ``adjoint``)."""
    a, b = _inexact(a), _inexact(b)
    if adjoint:
        return torch.linalg.solve_triangular(a.transpose(-1, -2), b,
                                             upper=lower)
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def _min_norm_lstsq(a, b):
    """``jnp.linalg.lstsq(a, b)[0]``: through the SVD, singular values
    under ``eps * max(M, N) * s[0]`` treated as zero."""
    if a.dim() != 2:
        raise TypeError(f"{a.dim()}-dimensional array given. Array must be "
                        "two-dimensional")
    vector = b.dim() == 1
    if vector:
        b = b.unsqueeze(-1)
    m, n = a.shape
    rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[:1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    x = vh.mH @ (s_inv.unsqueeze(-1) * (u.mH @ b))
    return x.squeeze(-1) if vector else x


@op("lstsq", "linalg", aliases=("solve_ls",))
def lstsq(a, b, l2_regularizer=0.0, fast=True):
    a, b = _inexact(a), _inexact(b)
    if l2_regularizer > 0.0:
        at = a.transpose(-1, -2)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        return solve(at @ a + l2_regularizer * eye, at @ b)
    return _min_norm_lstsq(a, b)


@op("sqrtm", "linalg")
def sqrtm(x):
    """Matrix square root: 20 Denman-Beavers steps, each with two
    inverses, as the JAX op's ``lax.scan``."""
    y = _inexact(x)
    z = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    for _ in range(20):
        y, z = (0.5 * (y + matrix_inverse(z)),
                0.5 * (z + matrix_inverse(y)))
    return y


@op("cross_batched", "linalg")
def cross_batched(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, tensor_like(b, a)),
                              dim=-1)


@op("knn_mindistance", "linalg", differentiable=False)
def knn_mindistance(point, lowest, highest):
    closest = torch.clamp(point, tensor_like(lowest, point),
                          tensor_like(highest, point))
    return torch.sqrt(torch.sum(torch.square(point - closest), dim=-1))
