"""Loss functions for the layer API.

Counterpart of ``deeplearning4j_tpu/nn/losses.py`` (the reference's
``LossFunctions``). Each loss is ``f(labels, output_after_activation,
mask) -> scalar mean loss``, computed on the activation's output as the
reference does: ``mcxent`` is ``-sum(y * log(p + 1e-7))`` on the softmax
probabilities, not a cross entropy on logits.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from ..common.mesh import batch_mean, batch_sum


def _masked_mean(per_example, mask):
    """The mean over the batch (over the global batch inside a
    ``common.mesh.batch_context``: sums and counts over the group)."""
    if mask is None:
        return batch_mean(per_example)
    while mask.dim() < per_example.dim():
        mask = mask[..., None]
    mask = torch.broadcast_to(mask, per_example.shape).to(per_example.dtype)
    return batch_sum(torch.sum(per_example * mask)) / torch.clamp_min(
        batch_sum(torch.sum(mask)), 1e-12)


def mcxent(labels, output, mask=None, eps=1e-7):
    """Multi-class cross entropy on softmax output (reference LossMCXENT)."""
    per = -torch.sum(labels * torch.log(output + eps), dim=-1)
    return _masked_mean(per, mask)


def xent(labels, output, mask=None, eps=1e-7):
    """Binary cross entropy on sigmoid output (reference LossBinaryXENT)."""
    per = -(labels * torch.log(output + eps)
            + (1 - labels) * torch.log(1 - output + eps))
    return _masked_mean(per, mask)


def mse(labels, output, mask=None):
    per = torch.mean(torch.square(labels - output), dim=-1)
    return _masked_mean(per, mask)


def l1(labels, output, mask=None):
    per = torch.mean(torch.abs(labels - output), dim=-1)
    return _masked_mean(per, mask)


def l2(labels, output, mask=None):
    per = torch.sum(torch.square(labels - output), dim=-1)
    return _masked_mean(per, mask)


def hinge(labels, output, mask=None):
    signed = 2 * labels - 1
    per = torch.mean(torch.clamp_min(1.0 - signed * output, 0.0), dim=-1)
    return _masked_mean(per, mask)


def squared_hinge(labels, output, mask=None):
    signed = 2 * labels - 1
    per = torch.mean(torch.square(torch.clamp_min(1.0 - signed * output,
                                                  0.0)), dim=-1)
    return _masked_mean(per, mask)


def poisson(labels, output, mask=None, eps=1e-7):
    per = torch.mean(output - labels * torch.log(output + eps), dim=-1)
    return _masked_mean(per, mask)


def cosine_proximity(labels, output, mask=None):
    num = torch.sum(labels * output, dim=-1)
    den = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(output, dim=-1)
    return _masked_mean(-num / torch.clamp_min(den, 1e-12), mask)


def kld(labels, output, mask=None, eps=1e-7):
    per = torch.sum(labels * (torch.log(labels + eps)
                              - torch.log(output + eps)), dim=-1)
    return _masked_mean(per, mask)


def mean_absolute_percentage_error(labels, output, mask=None, eps=1e-7):
    per = torch.mean(torch.abs((labels - output) / (torch.abs(labels) + eps)),
                     dim=-1) * 100
    return _masked_mean(per, mask)


def mean_squared_logarithmic_error(labels, output, mask=None):
    per = torch.mean(torch.square(torch.log1p(labels) - torch.log1p(output)),
                     dim=-1)
    return _masked_mean(per, mask)


def negative_log_likelihood(labels, output, mask=None, eps=1e-7):
    return mcxent(labels, output, mask, eps)


def wasserstein(labels, output, mask=None):
    return _masked_mean(torch.mean(labels * output, dim=-1), mask)


def sparse_mcxent(labels, output, mask=None, eps=1e-7):
    """labels are int class indices (reference LossSparseMCXENT)."""
    lp = torch.log(output + eps)
    per = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    return _masked_mean(per, mask)


_LOSSES = {
    "mcxent": mcxent,
    "negativeloglikelihood": negative_log_likelihood,
    "xent": xent,
    "mse": mse,
    "squared_loss": mse,
    "l1": l1,
    "mae": l1,
    "l2": l2,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "kl_divergence": kld,
    "reconstruction_crossentropy": xent,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "wasserstein": wasserstein,
    "sparse_mcxent": sparse_mcxent,
}


def get_loss(loss: Union[str, Callable]) -> Callable:
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(_LOSSES)}") \
            from None
