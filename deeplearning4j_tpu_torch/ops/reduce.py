"""Reduction, index-reduction and distance ops.

Counterpart of ``deeplearning4j_tpu/ops/reduce.py`` (the reference's
reduce, indexreduce, summarystats and reduce3 families). ``dims=None``
reduces every axis. Kept from the JAX ops: ``moments`` and
``reduce_stdev`` / ``reduce_variance`` with ``bias_corrected=False`` use
ddof 0 (PyTorch's default is unbiased), the mean of an integer array is
float32, and sums, counts and indices of integer or boolean inputs are
int32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ._util import all_dims, axes, i32, ints
from .registry import op


def _sum(x, ax, keep):
    r = torch.sum(x, dim=ax, keepdim=keep)
    return i32(r) if x.dtype in (torch.int32, torch.bool) else r


def _mean(x, ax, keep):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=ax, keepdim=keep)


def _amax(x, ax, keep):
    return torch.amax(x, dim=all_dims(x, ax), keepdim=keep)


def _amin(x, ax, keep):
    return torch.amin(x, dim=all_dims(x, ax), keepdim=keep)


def _each_axis(fn, x, ax, keep):
    """A one-axis torch reduction applied over several axes."""
    for a in sorted((d % x.dim() for d in all_dims(x, ax)), reverse=True):
        x = fn(x, dim=a, keepdim=keep)
    return x


def _prod(x, ax, keep):
    if x.dim() == 0:
        return x.clone()
    r = _each_axis(torch.prod, x, ax, keep)
    return i32(r) if x.dtype in (torch.int32, torch.bool) else r


def _any(x, ax, keep):
    return _each_axis(torch.any, x.bool(), ax, keep) if x.dim() else x.bool()


def _all(x, ax, keep):
    return _each_axis(torch.all, x.bool(), ax, keep) if x.dim() else x.bool()


def _logsumexp(x, ax, keep):
    return torch.logsumexp(x, dim=all_dims(x, ax), keepdim=keep)


def _make_reduce(name, fn, differentiable=True):
    @op(name, "reduce", differentiable=differentiable)
    def _r(x, dims=None, keep_dims=False):
        return fn(x, axes(dims), bool(keep_dims))
    return _r


_make_reduce("reduce_sum", _sum)
_make_reduce("reduce_mean", _mean)
_make_reduce("reduce_max", _amax)
_make_reduce("reduce_min", _amin)
_make_reduce("reduce_prod", _prod)
_make_reduce("reduce_norm1", lambda x, a, k: _sum(torch.abs(x), a, k))
_make_reduce("reduce_norm2", lambda x, a, k: torch.sqrt(_sum(x * x, a, k)))
_make_reduce("reduce_sqnorm", lambda x, a, k: _sum(x * x, a, k))
_make_reduce("reduce_norm_max", lambda x, a, k: _amax(torch.abs(x), a, k))
_make_reduce("reduce_logsumexp", _logsumexp)
_make_reduce("amax", lambda x, a, k: _amax(torch.abs(x), a, k))
_make_reduce("amin", lambda x, a, k: _amin(torch.abs(x), a, k))
_make_reduce("amean", lambda x, a, k: _mean(torch.abs(x), a, k))
_make_reduce("reduce_any", _any, differentiable=False)
_make_reduce("reduce_all", _all, differentiable=False)
_make_reduce("countNonZero", lambda x, a, k: _sum(x != 0, a, k),
             differentiable=False)
_make_reduce("countZero", lambda x, a, k: _sum(x == 0, a, k),
             differentiable=False)


@op("reduce_stdev", "reduce")
def reduce_stdev(x, dims=None, keep_dims=False, bias_corrected=True):
    return torch.std(x, dim=axes(dims), keepdim=bool(keep_dims),
                     correction=1 if bias_corrected else 0)


@op("reduce_variance", "reduce")
def reduce_variance(x, dims=None, keep_dims=False, bias_corrected=True):
    return torch.var(x, dim=axes(dims), keepdim=bool(keep_dims),
                     correction=1 if bias_corrected else 0)


@op("reduce_dot", "reduce")
def reduce_dot(x, y, dims=None, keep_dims=False):
    return _sum(x * y, axes(dims), bool(keep_dims))


@op("moments", "reduce")
def moments(x, dims=None, keep_dims=False):
    ax = axes(dims)
    return (torch.mean(x, dim=ax, keepdim=bool(keep_dims)),
            torch.var(x, dim=ax, keepdim=bool(keep_dims), correction=0))


@op("normalize_moments", "reduce")
def normalize_moments(count, mean_ss, var_ss, shift=0.0):
    mean = mean_ss / count + shift
    variance = var_ss / count - torch.square(mean - shift)
    return mean, variance


@op("sufficient_statistics", "reduce")
def sufficient_statistics(x, dims=None, shift=None):
    ax = axes(dims)
    n = math.prod(x.shape[a] for a in all_dims(x, ax))
    count = torch.tensor(n, dtype=x.dtype, device=x.device)
    xs = x - shift if shift is not None else x
    return count, torch.sum(xs, dim=ax), torch.sum(xs * xs, dim=ax)


# -- index reductions ---------------------------------------------------
def _index_reduce(fn, x, dims, keep_dims):
    axis = None if dims is None else (
        dims if isinstance(dims, int) else int(ints(dims)[0]))
    r = fn(x, dim=axis)
    if keep_dims and axis is not None:
        r = r.unsqueeze(axis)
    return i32(r)


@op("argmax", "indexreduce", differentiable=False, aliases=("argamax",))
def argmax(x, dims=None, keep_dims=False):
    return _index_reduce(torch.argmax, x, dims, keep_dims)


@op("argmin", "indexreduce", differentiable=False, aliases=("argamin",))
def argmin(x, dims=None, keep_dims=False):
    return _index_reduce(torch.argmin, x, dims, keep_dims)


@op("top_k", "indexreduce", differentiable=False)
def top_k(x, k, sorted=True):
    vals, idx = torch.topk(x, int(k), dim=-1, largest=True, sorted=True)
    return vals, i32(idx)


@op("in_top_k", "indexreduce", differentiable=False)
def in_top_k(predictions, targets, k):
    _, idx = torch.topk(predictions, int(k), dim=-1)
    return torch.any(idx == targets[:, None].to(idx.dtype), dim=-1)


@op("nth_element", "indexreduce", differentiable=False)
def nth_element(x, n, reverse=False):
    """The ``n``-th value of the last axis in sorted order; a sequence
    ``n`` picks several (a trailing axis), as jax indexing does."""
    s = torch.sort(x, dim=-1).values
    if reverse:
        s = torch.flip(s, dims=(-1,))
    if isinstance(n, (list, tuple)) or (isinstance(n, torch.Tensor)
                                        and n.dim() > 0):
        return s[..., torch.as_tensor(n, device=s.device).long()]
    return s[..., int(n)]


@op("percentile", "reduce", differentiable=False)
def percentile(x, q, dims=None, interpolation="linear"):
    ax = axes(dims)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device) / 100.0
    if ax is None:
        return torch.quantile(x.reshape(-1), q, interpolation=interpolation)
    ax = tuple(a % x.dim() for a in ax)
    keep = [d for d in range(x.dim()) if d not in ax]
    moved = x.permute(keep + list(ax)).reshape(
        [x.shape[d] for d in keep] + [-1])
    return torch.quantile(moved, q, dim=-1, interpolation=interpolation)


@op("bincount", "reduce", differentiable=False)
def bincount(x, weights=None, minlength=0, maxlength=None):
    length = minlength if maxlength is None else maxlength
    length = max(int(length), 1)
    # a scatter-add of static length (no boolean mask, no host read):
    # values outside [0, length) add nothing
    flat = x.reshape(-1).long()
    keep = (flat >= 0) & (flat < length)
    idx = torch.where(keep, flat, 0)
    w = keep.to(torch.int32) if weights is None else \
        torch.where(keep, weights.reshape(-1), 0)
    return torch.zeros(length, dtype=w.dtype, device=x.device) \
        .scatter_add_(0, idx, w)


@op("histogram", "reduce", differentiable=False)
def histogram(x, bins):
    xf = x.to(torch.float32)
    lo, hi = float(xf.min()), float(xf.max())
    return torch.histc(xf, bins=int(bins), min=lo, max=hi)


@op("histogram_fixed_width", "reduce", differentiable=False)
def histogram_fixed_width(x, value_range, nbins=100):
    # TF semantics: out-of-range values clamp into the edge bins
    vr = value_range.tolist() if isinstance(value_range, torch.Tensor) \
        else value_range
    lo, hi = float(vr[0]), float(vr[1])
    nbins = int(nbins)
    idx = torch.floor((x.reshape(-1) - lo) / (hi - lo) * nbins).to(torch.int64)
    idx = torch.clamp(idx, 0, nbins - 1)
    return i32(torch.bincount(idx, minlength=nbins)[:nbins])


# -- reduce3 (pairwise distance reductions) -----------------------------
@op("cosine_similarity", "reduce3")
def cosine_similarity(x, y, dims=None, keep_dims=False):
    ax, k = axes(dims), bool(keep_dims)
    num = torch.sum(x * y, dim=ax, keepdim=k)
    nx = torch.sqrt(torch.sum(x * x, dim=ax, keepdim=k))
    ny = torch.sqrt(torch.sum(y * y, dim=ax, keepdim=k))
    return num / torch.clamp(nx * ny, min=1e-12)


@op("cosine_distance", "reduce3")
def cosine_distance(x, y, dims=None, keep_dims=False):
    return 1.0 - cosine_similarity(x, y, dims, keep_dims)


@op("euclidean_distance", "reduce3")
def euclidean_distance(x, y, dims=None, keep_dims=False):
    return torch.sqrt(torch.sum((x - y) ** 2, dim=axes(dims),
                                keepdim=bool(keep_dims)))


@op("manhattan_distance", "reduce3")
def manhattan_distance(x, y, dims=None, keep_dims=False):
    return torch.sum(torch.abs(x - y), dim=axes(dims),
                     keepdim=bool(keep_dims))


@op("jaccard_distance", "reduce3")
def jaccard_distance(x, y, dims=None, keep_dims=False):
    ax, k = axes(dims), bool(keep_dims)
    mins = torch.sum(torch.minimum(x, y), dim=ax, keepdim=k)
    maxs = torch.sum(torch.maximum(x, y), dim=ax, keepdim=k)
    return 1.0 - mins / torch.clamp(maxs, min=1e-12)


@op("hamming_distance", "reduce3", differentiable=False)
def hamming_distance(x, y, dims=None, keep_dims=False):
    return _sum(x != y, axes(dims), bool(keep_dims))


@op("dot", "reduce3")
def dot(x, y, dims=None, keep_dims=False):
    if dims is None:
        return torch.sum(x * y)
    return torch.sum(x * y, dim=axes(dims), keepdim=bool(keep_dims))


@op("matrix_band_part", "transforms")
def matrix_band_part(x, num_lower, num_upper):
    m, n = x.shape[-2], x.shape[-1]
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    keep = np.ones((m, n), bool)
    if int(num_lower) >= 0:
        keep &= (i - j) <= int(num_lower)
    if int(num_upper) >= 0:
        keep &= (j - i) <= int(num_upper)
    return torch.where(torch.as_tensor(keep, device=x.device), x,
                       torch.zeros_like(x))
