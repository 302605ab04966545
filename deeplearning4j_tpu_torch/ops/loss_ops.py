"""Loss ops.

Counterpart of ``deeplearning4j_tpu/ops/loss_ops.py`` (the reference's
``headers/loss.h``): each loss takes optional weights and a
``reduction``: 0 = NONE, 1 = SUM, 2 = MEAN_BY_WEIGHT (sum / sum of
weights), 3 = MEAN_BY_NONZERO_WEIGHT. ``ctc_loss`` is
``torch.nn.functional.ctc_loss`` per sequence (the JAX op calls optax's).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import op

NONE, SUM, MEAN_BY_WEIGHT, MEAN_BY_NONZERO = 0, 1, 2, 3


def _reduce(per_elem, weights, reduction):
    if weights is None:
        weights = torch.ones((), dtype=per_elem.dtype, device=per_elem.device)
    weighted = per_elem * weights
    if reduction == NONE:
        return weighted
    if reduction == SUM:
        return torch.sum(weighted)
    full_w = torch.broadcast_to(weights, per_elem.shape)
    if reduction == MEAN_BY_WEIGHT:
        return torch.sum(weighted) / torch.clamp(torch.sum(full_w), min=1e-12)
    nz = torch.sum(full_w != 0).to(weighted.dtype)
    return torch.sum(weighted) / torch.clamp(nz, min=1.0)


@op("mean_sqerr_loss", "loss")
def mean_sqerr_loss(predictions, weights=None, labels=None,
                    reduction=MEAN_BY_WEIGHT):
    return _reduce(torch.square(predictions - labels), weights, reduction)


@op("absolute_difference_loss", "loss")
def absolute_difference_loss(predictions, weights=None, labels=None,
                             reduction=MEAN_BY_WEIGHT):
    return _reduce(torch.abs(predictions - labels), weights, reduction)


@op("huber_loss", "loss")
def huber_loss(predictions, weights=None, labels=None, delta=1.0,
               reduction=MEAN_BY_WEIGHT):
    err = torch.abs(predictions - labels)
    quad = torch.clamp(err, max=delta)
    per = 0.5 * quad * quad + delta * (err - quad)
    return _reduce(per, weights, reduction)


@op("log_loss", "loss")
def log_loss(predictions, weights=None, labels=None, eps=1e-7,
             reduction=MEAN_BY_WEIGHT):
    per = -(labels * torch.log(predictions + eps)
            + (1 - labels) * torch.log(1 - predictions + eps))
    return _reduce(per, weights, reduction)


@op("log_poisson_loss", "loss")
def log_poisson_loss(log_predictions, weights=None, labels=None, full=False,
                     reduction=MEAN_BY_WEIGHT):
    per = torch.exp(log_predictions) - labels * log_predictions
    if full:
        lab = torch.clamp(labels, min=1e-12)
        per = per + labels * torch.log(lab) - labels \
            + 0.5 * torch.log(2 * math.pi * lab)
    return _reduce(per, weights, reduction)


@op("hinge_loss", "loss")
def hinge_loss(logits, weights=None, labels=None, reduction=MEAN_BY_WEIGHT):
    signed = 2.0 * labels - 1.0
    return _reduce(torch.clamp(1.0 - signed * logits, min=0.0), weights,
                   reduction)


@op("squared_hinge_loss", "loss")
def squared_hinge_loss(logits, weights=None, labels=None,
                       reduction=MEAN_BY_WEIGHT):
    signed = 2.0 * labels - 1.0
    return _reduce(torch.square(torch.clamp(1.0 - signed * logits, min=0.0)),
                   weights, reduction)


@op("cosine_distance_loss", "loss")
def cosine_distance_loss(predictions, weights=None, labels=None, axis=-1,
                         reduction=MEAN_BY_WEIGHT):
    per = 1.0 - torch.sum(predictions * labels, dim=axis, keepdim=True)
    return _reduce(per, weights, reduction)


@op("mean_pairwssqerr_loss", "loss")
def mean_pairwssqerr_loss(predictions, weights=None, labels=None,
                          reduction=MEAN_BY_WEIGHT):
    d = predictions - labels
    n = d.shape[-1]
    sum_sq = torch.sum(d * d, dim=-1, keepdim=True)
    sq_sum = torch.square(torch.sum(d, dim=-1, keepdim=True))
    per = (2.0 * (n * sum_sq - sq_sum) / max(n * (n - 1), 1) if n > 1
           else torch.zeros_like(sum_sq))
    return _reduce(per, weights, reduction)


@op("sigm_cross_entropy_loss", "loss")
def sigm_cross_entropy_loss(logits, weights=None, labels=None,
                            label_smoothing=0.0, reduction=MEAN_BY_WEIGHT):
    if label_smoothing > 0:
        labels = labels * (1 - label_smoothing) + 0.5 * label_smoothing
    per = torch.clamp(logits, min=0) - logits * labels \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    return _reduce(per, weights, reduction)


@op("softmax_cross_entropy_loss", "loss")
def softmax_cross_entropy_loss(logits, weights=None, labels=None,
                               label_smoothing=0.0, reduction=MEAN_BY_WEIGHT):
    if label_smoothing > 0:
        n = labels.shape[-1]
        labels = labels * (1 - label_smoothing) + label_smoothing / n
    per = -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)
    return _reduce(per, weights, reduction)


@op("softmax_cross_entropy_loss_with_logits", "loss")
def softmax_cross_entropy_loss_with_logits(logits, labels, axis=-1):
    return -torch.sum(labels * torch.log_softmax(logits, dim=axis), dim=axis)


@op("sparse_softmax_cross_entropy_loss_with_logits", "loss")
def sparse_softmax_cross_entropy_loss_with_logits(labels, logits):
    lsm = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lsm, -1, labels[..., None].long())[..., 0]


@op("weighted_cross_entropy_with_logits", "loss")
def weighted_cross_entropy_with_logits(targets, logits, pos_weight):
    log_weight = 1 + (pos_weight - 1) * targets
    return (1 - targets) * logits + log_weight * (
        torch.log1p(torch.exp(-torch.abs(logits)))
        + torch.clamp(-logits, min=0))


@op("l2_loss", "loss")
def l2_loss(x):
    return torch.sum(x * x) / 2


@op("ctc_loss", "loss")
def ctc_loss(labels, logits, label_lengths, logit_lengths, blank_index=0):
    """Per-sequence CTC negative log likelihood; logits [B, T, C], labels
    [B, S] (the JAX op's optax layout)."""
    log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    return F.ctc_loss(log_probs, labels.long(), logit_lengths.long(),
                      label_lengths.long(), blank=int(blank_index),
                      reduction="none", zero_infinity=False)
