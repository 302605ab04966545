"""Line-search solvers beside the SGD-family updaters.

Counterpart of ``deeplearning4j_tpu/nn/solvers.py`` (the reference's
``optimize/solvers/``: ``BaseOptimizer``, ``StochasticGradientDescent``,
``LineGradientDescent``, ``ConjugateGradient``, ``LBFGS``, each driving
``BackTrackLineSearch``). The loss and its gradient over the flattened
trainable vector (the reference's gradientAndScore) is one autograd call
on the network's device, in full f32; the solver iterations are host
control flow around it. Full-batch methods, as in the reference, for
small models, fine-tuning and verification.
"""
from __future__ import annotations

import math
from typing import Callable, List

import torch

from ..datasets.dataset import DataSet
from .fit_fastpath import full_f32


def _flatten_spec(trainable):
    spec = []
    for i, p in enumerate(trainable):
        for k in sorted(p):
            spec.append((i, k, tuple(p[k].shape),
                         max(math.prod(p[k].shape), 1)))
    return spec


def _make_flat_loss(net, x, y):
    """(loss + gradient of the flattened trainable vector, that vector,
    its unflatten)."""
    trainable = net._trainable(net._params)
    states = net._states(net._params)
    spec = _flatten_spec(trainable)

    def unflatten(flat):
        out = [dict() for _ in trainable]
        offset = 0
        for i, k, shape, n in spec:
            out[i][k] = flat[offset:offset + n].reshape(shape)
            offset += n
        return out

    def vg(flat):
        leaf = flat.detach().requires_grad_(True)
        with torch.enable_grad(), full_f32():
            loss, _ = net._loss_with_bn(unflatten(leaf), states, x, y, None)
            (g,) = torch.autograd.grad(loss, leaf)
        return loss.detach(), g

    flat0 = torch.cat([trainable[i][k].reshape(-1).float()
                       for i, k, _, _ in spec]) if spec else \
        torch.zeros((0,), device=net.device)
    # the census: one event per solver entry, as the JAX package's
    # counted_jit records for its jitted loss; eager, since the solver's
    # host control flow reads every loss
    from ..runtime.inference import eager_dispatch
    return eager_dispatch(vg, f"solver:{id(net)}", net._train_graphs(),
                          "host_decision"), flat0, unflatten


def backtrack_line_search(vg: Callable, x0, f0, g0, direction,
                          initial_step: float = 1.0, c1: float = 1e-4,
                          rho: float = 0.5, max_steps: int = 20) -> float:
    """Armijo backtracking (reference BackTrackLineSearch.optimize)."""
    slope = float(torch.dot(g0, direction))
    if slope >= 0:  # not a descent direction
        return 0.0
    step = initial_step
    for _ in range(max_steps):
        f_new, _ = vg(x0 + step * direction)
        if float(f_new) <= float(f0) + c1 * step * slope:
            return step
        step *= rho
    return 0.0


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class BaseSolver:
    """Common full-batch driver (reference BaseOptimizer)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.scores: List[float] = []

    def optimize(self, net, data, labels=None) -> float:
        if labels is not None:
            data = DataSet(data, labels)
        vg, flat, unflatten = _make_flat_loss(
            net, net._stage(data.features), net._stage(data.labels))
        flat = self._run(vg, flat)
        net._params = net._merge_states(unflatten(flat.detach()),
                                        net._states(net._params))
        net.score_value = self.scores[-1] if self.scores else float("nan")
        return net.score_value

    def _run(self, vg, flat):
        raise NotImplementedError


class LineGradientDescent(BaseSolver):
    """Steepest descent + line search (reference LineGradientDescent)."""

    def _run(self, vg, flat):
        for _ in range(self.max_iterations):
            f, g = vg(flat)
            self.scores.append(float(f))
            step = backtrack_line_search(vg, flat, f, g, -g)
            if step == 0.0 or float(torch.linalg.norm(g)) < self.tolerance:
                break
            flat = flat + step * (-g)
        return flat


class ConjugateGradient(BaseSolver):
    """Polak-Ribiere nonlinear CG (reference ConjugateGradient)."""

    def _run(self, vg, flat):
        f, g = vg(flat)
        d = -g
        for _ in range(self.max_iterations):
            self.scores.append(float(f))
            if float(torch.linalg.norm(g)) < self.tolerance:
                break
            step = backtrack_line_search(vg, flat, f, g, d)
            if step == 0.0:
                d = -g  # restart with steepest descent
                step = backtrack_line_search(vg, flat, f, g, d)
                if step == 0.0:
                    break
            flat = flat + step * d
            f_new, g_new = vg(flat)
            beta = _dot(g_new, g_new - g) / max(_dot(g, g), 1e-20)
            beta = max(beta, 0.0)  # PR+ restart rule
            d = -g_new + beta * d
            f, g = f_new, g_new
        return flat


class LBFGS(BaseSolver):
    """Limited-memory BFGS, two-loop recursion (reference LBFGS, m=4)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6,
                 m: int = 4):
        super().__init__(max_iterations, tolerance)
        self.m = m

    def _run(self, vg, flat):
        s_hist: List = []
        y_hist: List = []
        f, g = vg(flat)
        for _ in range(self.max_iterations):
            self.scores.append(float(f))
            if float(torch.linalg.norm(g)) < self.tolerance:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, yv in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / max(_dot(yv, s), 1e-20)
                a = rho * _dot(s, q)
                alphas.append((a, rho, s, yv))
                q = q - a * yv
            if y_hist:
                s_last, y_last = s_hist[-1], y_hist[-1]
                q = q * (_dot(s_last, y_last)
                         / max(_dot(y_last, y_last), 1e-20))
            for a, rho, s, yv in reversed(alphas):
                b = rho * _dot(yv, q)
                q = q + (a - b) * s
            d = -q
            step = backtrack_line_search(vg, flat, f, g, d)
            if step == 0.0:
                d = -g
                step = backtrack_line_search(vg, flat, f, g, d)
                if step == 0.0:
                    break
            flat_new = flat + step * d
            f_new, g_new = vg(flat_new)
            s_hist.append(flat_new - flat)
            y_hist.append(g_new - g)
            if len(s_hist) > self.m:
                s_hist.pop(0)
                y_hist.pop(0)
            flat, f, g = flat_new, f_new, g_new
        return flat


class StochasticGradientDescent(BaseSolver):
    """Delegates to the network's fit step (reference
    StochasticGradientDescent.optimize, the production path)."""

    def __init__(self, max_iterations: int = 100):
        super().__init__(max_iterations)

    def optimize(self, net, data, labels=None) -> float:
        if labels is not None:
            data = DataSet(data, labels)
        for _ in range(self.max_iterations):
            net.fit(data)
            self.scores.append(net.score_value)
        return net.score_value
