"""Updater (optimizer step) ops.

Counterpart of ``deeplearning4j_tpu/ops/updater_ops.py``: one pure
function per optimizer, ``(grad, *state, hyper) -> (update, *state')``,
with the reference's bias correction and epsilon placement so that
convergence matches DL4J's. The returned update is subtracted from the
parameter. ``iteration`` is a Python int or a 0-d tensor (step t =
iteration + 1).
"""
from __future__ import annotations

import torch

from .registry import op


@op("sgd_updater", "updater", aliases=("apply_sgd",))
def sgd_updater(grad, lr=0.1):
    return grad * lr


@op("momentum_updater", "updater")
def momentum_updater(grad, v, lr=0.1, momentum=0.9):
    v = momentum * v + grad
    return lr * v, v


@op("nesterovs_updater", "updater")
def nesterovs_updater(grad, v, lr=0.1, momentum=0.9):
    """Nesterov momentum, reference NesterovsUpdater semantics:
    v' = mu*v - lr*g; param step = -mu*v + (1+mu)*v'. With p_new = p -
    update, update = mu*v - (1+mu)*v' (the first step gives
    (1+mu)*lr*g)."""
    v_new = momentum * v - lr * grad
    update = momentum * v - (1.0 + momentum) * v_new
    return update, v_new


@op("adam_updater", "updater")
def adam_updater(grad, state_u, state_m, lr=1e-3, beta1=0.9, beta2=0.999,
                 eps=1e-8, iteration=0):
    """state_u = 2nd moment (v), state_m = 1st moment (m) — the
    reference's argument order."""
    t = iteration + 1
    m = beta1 * state_m + (1 - beta1) * grad
    u = beta2 * state_u + (1 - beta2) * torch.square(grad)
    alpha = lr * (1 - beta2 ** t) ** 0.5 / (1 - beta1 ** t)
    update = alpha * m / (torch.sqrt(u) + eps)
    return update, u, m


@op("ada_max_updater", "updater")
def ada_max_updater(grad, state_u, state_m, lr=1e-3, beta1=0.9, beta2=0.999,
                    eps=1e-8, iteration=0):
    t = iteration + 1
    m = beta1 * state_m + (1 - beta1) * grad
    u = torch.maximum(beta2 * state_u, torch.abs(grad))
    update = lr / (1 - beta1 ** t) * m / (u + eps)
    return update, u, m


@op("adabelief_updater", "updater")
def adabelief_updater(grad, state_u, state_m, lr=1e-3, beta1=0.9,
                      beta2=0.999, eps=1e-14, iteration=0):
    t = iteration + 1
    m = beta1 * state_m + (1 - beta1) * grad
    u = beta2 * state_u + (1 - beta2) * torch.square(grad - m) + eps
    alpha = lr * (1 - beta2 ** t) ** 0.5 / (1 - beta1 ** t)
    update = alpha * m / (torch.sqrt(u) + eps)
    return update, u, m


@op("nadam_updater", "updater")
def nadam_updater(grad, state_u, state_m, lr=1e-3, beta1=0.9, beta2=0.999,
                  eps=1e-8, iteration=0):
    t = iteration + 1
    m = beta1 * state_m + (1 - beta1) * grad
    u = beta2 * state_u + (1 - beta2) * torch.square(grad)
    m_hat = m / (1 - beta1 ** t)
    u_hat = u / (1 - beta2 ** t)
    update = lr * (beta1 * m_hat + (1 - beta1) / (1 - beta1 ** t) * grad) \
        / (torch.sqrt(u_hat) + eps)
    return update, u, m


@op("ams_grad_updater", "updater")
def ams_grad_updater(grad, state_v, state_m, state_h, lr=1e-3, beta1=0.9,
                     beta2=0.999, eps=1e-8, iteration=0):
    t = iteration + 1
    m = beta1 * state_m + (1 - beta1) * grad
    v = beta2 * state_v + (1 - beta2) * torch.square(grad)
    h = torch.maximum(state_h, v)
    alpha = lr * (1 - beta2 ** t) ** 0.5 / (1 - beta1 ** t)
    update = alpha * m / (torch.sqrt(h) + eps)
    return update, v, m, h


@op("ada_grad_updater", "updater")
def ada_grad_updater(grad, state_h, lr=1e-1, eps=1e-6):
    h = state_h + torch.square(grad)
    update = lr * grad / (torch.sqrt(h) + eps)
    return update, h


@op("ada_delta_updater", "updater")
def ada_delta_updater(grad, state_msg, state_msdx, rho=0.95, eps=1e-6):
    msg = rho * state_msg + (1 - rho) * torch.square(grad)
    update = grad * torch.sqrt(state_msdx + eps) / torch.sqrt(msg + eps)
    msdx = rho * state_msdx + (1 - rho) * torch.square(update)
    return update, msg, msdx


@op("rms_prop_updater", "updater")
def rms_prop_updater(grad, state_g, lr=1e-1, decay=0.95, eps=1e-8):
    g = decay * state_g + (1 - decay) * torch.square(grad)
    update = lr * grad / (torch.sqrt(g) + eps)
    return update, g
