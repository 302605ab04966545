"""Updater (optimizer step) ops.

Counterpart of ``deeplearning4j_tpu/ops/updater_ops.py``; only the Adam
updater is ported, the one the model train steps use. A pure function
``(grad, state_u, state_m, hyper) -> (update, u, m)`` with the
reference's bias correction and epsilon placement, so that convergence
matches DL4J's.
"""
from __future__ import annotations

import torch


def adam_updater(grad, state_u, state_m, lr=1e-3, beta1=0.9, beta2=0.999,
                 eps=1e-8, iteration=0):
    """state_u = 2nd moment (v), state_m = 1st moment (m) — the
    reference's argument order. ``iteration`` is a Python int or a
    0-d tensor (step t = iteration + 1); the returned update is
    subtracted from the parameter."""
    t = iteration + 1
    m = beta1 * state_m + (1 - beta1) * grad
    u = beta2 * state_u + (1 - beta2) * torch.square(grad)
    alpha = lr * (1 - beta2 ** t) ** 0.5 / (1 - beta1 ** t)
    update = alpha * m / (torch.sqrt(u) + eps)
    return update, u, m
