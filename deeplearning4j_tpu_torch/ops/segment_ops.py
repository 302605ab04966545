"""Segment reduction ops.

Counterpart of ``deeplearning4j_tpu/ops/segment_ops.py`` (the
reference's ``segment_*`` / ``unsorted_segment_*``,
``headers/parity_ops.h``), with ``jax.ops.segment_*``'s semantics:
- an id that is negative or ``>= num_segments`` is dropped. Such ids go
  to one spare segment past the end that is cut off after the scatter,
  since ``scatter_reduce`` / ``index_add_`` reject them (on the card, a
  device-side assert that ends the process);
- an empty segment holds the reduction's identity: 0 for sum, 1 for
  prod, ``-inf`` / the type's least value for max, ``+inf`` / its
  greatest for min;
- the mean and ``sqrt_n`` divide by float32 counts, so bfloat16 or
  integer data gives float32.
``num_segments=None`` takes ``max(ids) + 1`` on the host, a sync on the
card.
"""
from __future__ import annotations

import torch

from .registry import op


def _num(segment_ids, num_segments):
    if num_segments is not None:
        return int(num_segments)
    return int(torch.as_tensor(segment_ids).max()) + 1


def _identity(dtype, reduce):
    if reduce == "sum":
        return 0
    if reduce == "prod":
        return 1
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _segment(data, segment_ids, num_segments, reduce):
    n = _num(segment_ids, num_segments)
    ids = torch.as_tensor(segment_ids, device=data.device).long()
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    shape = (n + 1,) + tuple(data.shape[ids.dim():])
    if reduce == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return out.index_add_(0, ids.reshape(-1),
                              data.reshape((-1,) + shape[1:]))[:n]
    out = torch.full(shape, _identity(data.dtype, reduce), dtype=data.dtype,
                     device=data.device)
    flat = data.reshape((-1,) + shape[1:])
    index = ids.reshape((-1,) + (1,) * (flat.dim() - 1)).expand_as(flat)
    return out.scatter_reduce(0, index, flat, reduce,
                              include_self=False)[:n]


def _counts(data, segment_ids, n):
    return _segment(torch.ones_like(data, dtype=torch.float32), segment_ids,
                    n, "sum")


@op("segment_sum", "segment", aliases=("unsorted_segment_sum",))
def segment_sum(data, segment_ids, num_segments=None):
    return _segment(data, segment_ids, num_segments, "sum")


@op("segment_max", "segment", aliases=("unsorted_segment_max",))
def segment_max(data, segment_ids, num_segments=None):
    return _segment(data, segment_ids, num_segments, "amax")


@op("segment_min", "segment", aliases=("unsorted_segment_min",))
def segment_min(data, segment_ids, num_segments=None):
    return _segment(data, segment_ids, num_segments, "amin")


@op("segment_prod", "segment", aliases=("unsorted_segment_prod",))
def segment_prod(data, segment_ids, num_segments=None):
    return _segment(data, segment_ids, num_segments, "prod")


@op("segment_mean", "segment", aliases=("unsorted_segment_mean",))
def segment_mean(data, segment_ids, num_segments=None):
    n = _num(segment_ids, num_segments)
    sums = _segment(data, segment_ids, n, "sum")
    return sums / torch.clamp(_counts(data, segment_ids, n), min=1.0)


@op("unsorted_segment_sqrt_n", "segment")
def unsorted_segment_sqrt_n(data, segment_ids, num_segments=None):
    n = _num(segment_ids, num_segments)
    sums = _segment(data, segment_ids, n, "sum")
    return sums / torch.sqrt(torch.clamp(_counts(data, segment_ids, n),
                                         min=1.0))
