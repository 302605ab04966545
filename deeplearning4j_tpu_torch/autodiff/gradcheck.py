"""Gradient checking.

Counterpart of ``deeplearning4j_tpu/autodiff/gradcheck.py`` (the
reference's ``GradCheckUtil``): central differences against the analytic
gradient, here autograd's. As in the JAX harness, the analytic side is
f32, the perturbation is made in f64 and each perturbed point is
evaluated in f32 (an f32 function's rounding error, ~6e-8 * |f| / eps,
limits the numeric side to ~1e-3), so the tolerances are the JAX
harness's: wrong gradients are off by O(1) and still fail.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32))


def check_gradients(fn: Callable, args: Sequence, eps: float = 1e-3,
                    rtol: float = 5e-3, atol: float = 2e-3,
                    argnums: Sequence[int] = None) -> bool:
    """Central-difference check of autograd's gradient of a scalar-output
    ``fn`` over tensors."""
    args = [_f32(a) for a in args]
    argnums = tuple(argnums) if argnums is not None \
        else tuple(range(len(args)))
    with torch.enable_grad():
        leaves = [a.clone().requires_grad_(True) if i in argnums else a
                  for i, a in enumerate(args)]
        out = fn(*leaves)
        analytic = torch.autograd.grad(out, [leaves[i] for i in argnums],
                                       allow_unused=True)
    with torch.no_grad():
        for k, argnum in enumerate(argnums):
            a = args[argnum].cpu().numpy().astype(np.float64)
            flat = a.ravel()
            num = np.zeros_like(flat)
            for i in range(flat.size):
                plus, minus = flat.copy(), flat.copy()
                plus[i] += eps
                minus[i] -= eps
                args_p = list(args)
                args_m = list(args)
                dev = args[argnum].device
                args_p[argnum] = torch.as_tensor(
                    plus.reshape(a.shape), dtype=torch.float32, device=dev)
                args_m[argnum] = torch.as_tensor(
                    minus.reshape(a.shape), dtype=torch.float32, device=dev)
                num[i] = (float(fn(*args_p)) - float(fn(*args_m))) / (2 * eps)
            g = analytic[k]
            ana = (np.zeros_like(flat) if g is None
                   else g.detach().cpu().numpy().astype(np.float64).ravel())
            if not np.allclose(ana, num, rtol=rtol, atol=max(atol, eps)):
                max_err = np.max(np.abs(ana - num))
                raise AssertionError(
                    f"gradient mismatch on arg {argnum}: max abs err "
                    f"{max_err:.3e}\nanalytic: {ana}\nnumeric:  {num}")
    return True


def check_samediff_gradients(sd, placeholders: Dict, loss_name: str,
                             wrt: Sequence[str] = None, eps: float = 1e-3,
                             rtol: float = 5e-3, atol: float = 2e-3) -> bool:
    """Gradient-check a recorded SameDiff graph's loss with respect to its
    VARIABLEs."""
    wrt = list(wrt) if wrt is not None else \
        [v.name for v in sd.trainable_variables()]
    ph = {k: sd._tensor(v) for k, v in placeholders.items()}

    for name in wrt:
        base = sd._arrays[name]

        def loss_of(x, _name=name):
            variables = dict(sd._arrays)
            variables[_name] = x
            out = sd._trace(variables, ph, [loss_name])[0]
            return torch.sum(out)

        check_gradients(loss_of, [base], eps=eps, rtol=rtol, atol=atol)
    return True
