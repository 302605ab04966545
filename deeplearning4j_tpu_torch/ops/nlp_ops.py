"""NLP training-round ops: ``skipgram`` and ``cbow``.

Counterpart of ``deeplearning4j_tpu/ops/nlp_ops.py`` (the reference's
``headers/nlp.h``: SkipGramRound / CbowRound, one negative-sampling SGD
round on syn0 / syn1neg). The ops are functional, as the JAX ones are:
they return new tables and never write into their inputs. A row named
more than once in a batch gets the sum of its updates (out-of-place
``index_add``, as ``.at[ids].add`` sums). ``nlp/sequence_vectors.py``
trains with its own step; these exist for op parity and recorded graphs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import op


def _round(syn0, syn1neg, v, ids, labels, lr):
    """The shared half of a round: logits of ``v`` [B, D] against the
    ``ids`` [B, 1+K] rows of syn1neg, the output rows' update and the
    mean loss. Returns (dv [B, D], new syn1neg, loss). ``lr`` may be a
    Python number (no host-to-device copy a round) or a tensor."""
    u = syn1neg[ids]                               # [B, 1+K, D]
    logits = torch.einsum("bkd,bd->bk", u, v)
    g = (labels - torch.sigmoid(logits)) * lr      # [B, 1+K]
    dv = torch.einsum("bk,bkd->bd", g, u)
    du = torch.einsum("bk,bd->bkd", g, v)
    loss = -torch.mean(labels * F.logsigmoid(logits)
                       + (1 - labels) * F.logsigmoid(-logits))
    syn1neg = syn1neg.index_add(0, ids.reshape(-1),
                                du.reshape(-1, du.shape[-1]))
    return dv, syn1neg, loss


def _labels(first, neg_ids, dtype):
    return torch.cat([torch.ones_like(first[:, None]),
                      torch.zeros_like(neg_ids)], dim=1).to(dtype)


@op("skipgram", "nlp", differentiable=False)
def skipgram(syn0, syn1neg, target, context, neg_ids, lr=0.025):
    """Batched SkipGramRound. target / context: [B] ids; neg_ids: [B, K].
    Returns (new_syn0, new_syn1neg, loss)."""
    target = torch.atleast_1d(torch.as_tensor(target, device=syn0.device))
    context = torch.atleast_1d(torch.as_tensor(context, device=syn0.device))
    neg_ids = torch.atleast_2d(torch.as_tensor(neg_ids, device=syn0.device))
    v = syn0[target]                               # [B, D]
    ids = torch.cat([context[:, None], neg_ids], dim=1)
    dv, syn1neg, loss = _round(syn0, syn1neg, v, ids,
                               _labels(context, neg_ids, syn0.dtype), lr)
    return syn0.index_add(0, target, dv), syn1neg, loss


@op("cbow", "nlp", differentiable=False)
def cbow(syn0, syn1neg, context_ids, context_mask, target, neg_ids,
         lr=0.025):
    """Batched CbowRound: the mean of the context vectors predicts the
    target. context_ids: [B, C] (padded), context_mask: [B, C] 0/1,
    target: [B], neg_ids: [B, K]. Returns (new_syn0, new_syn1neg, loss)."""
    target = torch.atleast_1d(torch.as_tensor(target, device=syn0.device))
    mask = context_mask.to(syn0.dtype)
    counts = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
    h = (syn0[context_ids] * mask[..., None]).sum(dim=1) / counts  # [B, D]
    ids = torch.cat([target[:, None], neg_ids], dim=1)
    dh, syn1neg, loss = _round(syn0, syn1neg, h, ids,
                               _labels(target, neg_ids, syn0.dtype), lr)
    # the mean's gradient spread over the rows that made it
    per_row = (dh[:, None, :] / counts[..., None]) * mask[..., None]
    syn0 = syn0.index_add(0, context_ids.reshape(-1),
                          per_row.reshape(-1, per_row.shape[-1]))
    return syn0, syn1neg, loss
