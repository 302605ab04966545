"""Updater (optimizer) configurations and learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/learning.py`` (the reference's
``org/nd4j/linalg/learning/config/`` IUpdaters). Each config builds
``init(params) -> state`` and ``apply(grads, state, iteration) ->
(update, state')`` over a params tree (nested dicts and lists of
tensors), on the ``ops.updater_ops`` functions; the state has the JAX
package's layout (``{"u": tree, "m": tree}`` for Adam, ...), so a state
bridged from it lines up. Schedules are callables ``f(iteration) -> lr``;
the fit loop passes ``iteration`` as a 0-d int64 tensor on the network's
device (what a captured step reads from its static inputs), as the JAX
package's are functions of the traced int, so the schedules here are
tensor functions of it (an int gives a 0-d CPU tensor). A schedule that
returns a Python number for a tensor cannot be captured
(:func:`host_schedules`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import torch

from .ops import updater_ops

Schedule = Union[float, Callable[[Any], Any]]


def _lr_at(lr: Schedule, iteration):
    return lr(iteration) if callable(lr) else lr


def host_schedules(updater) -> list:
    """The names of ``updater``'s schedules that answer a tensor
    iteration with a host value (a Python number): a CUDA graph would
    bake that value in, so a step using them runs eagerly."""
    probe = torch.zeros((), dtype=torch.int64)
    return [f.name for f in dataclasses.fields(updater)
            if callable(getattr(updater, f.name))
            and not isinstance(getattr(updater, f.name)(probe),
                               torch.Tensor)]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (nested dicts/lists/tuples),
    with the matching leaves of ``rest``; the result has ``tree``'s
    structure. A leaf result that is a tuple stays a tuple (see
    :func:`unzip`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return seq if isinstance(tree, list) else tuple(seq)
    return fn(tree, *rest)


def unzip(tree, n):
    """A tree of n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in tree} for i in range(n))
    if isinstance(tree, list):
        parts = [unzip(v, n) for v in tree]
        return tuple([p[i] for p in parts] for i in range(n))
    return tuple(tree)


def _zeros(params):
    return tree_map(torch.zeros_like, params)


class IUpdater:
    """Base updater config. Subclasses define state init and per-leaf apply."""

    def init(self, params):
        return None

    def apply(self, grads, state, iteration):
        raise NotImplementedError

    # JSON-ish serde (the reference's ModelSerializer)
    def to_dict(self):
        d = {"@class": type(self).__name__}
        d.update(dataclasses.asdict(self))
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _UPDATERS[d.pop("@class")]
        return cls(**d)


def _stateful(op_fn, names, grads, state, **hyper):
    """Apply ``op_fn(g, *state leaves, **hyper) -> (update, *state')``
    leaf by leaf; ``names`` are the state's keys in ``op_fn``'s order."""
    out = tree_map(lambda g, *s: op_fn(g, *s, **hyper), grads,
                   *(state[n] for n in names))
    parts = unzip(out, 1 + len(names))
    return parts[0], dict(zip(names, parts[1:]))


@dataclasses.dataclass
class NoOp(IUpdater):
    def apply(self, grads, state, iteration):
        return tree_map(torch.zeros_like, grads), state


@dataclasses.dataclass
class Sgd(IUpdater):
    learning_rate: Schedule = 1e-1

    def apply(self, grads, state, iteration):
        lr = _lr_at(self.learning_rate, iteration)
        return tree_map(lambda g: updater_ops.sgd_updater(g, lr), grads), \
            state


@dataclasses.dataclass
class Nesterovs(IUpdater):
    learning_rate: Schedule = 1e-1
    momentum: float = 0.9

    def init(self, params):
        return {"v": _zeros(params)}

    def apply(self, grads, state, iteration):
        return _stateful(updater_ops.nesterovs_updater, ("v",), grads, state,
                         lr=_lr_at(self.learning_rate, iteration),
                         momentum=self.momentum)


@dataclasses.dataclass
class Adam(IUpdater):
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    _op = staticmethod(updater_ops.adam_updater)

    def init(self, params):
        return {"u": _zeros(params), "m": _zeros(params)}

    def apply(self, grads, state, iteration):
        return _stateful(self._op, ("u", "m"), grads, state,
                         lr=_lr_at(self.learning_rate, iteration),
                         beta1=self.beta1, beta2=self.beta2,
                         eps=self.epsilon, iteration=iteration)


@dataclasses.dataclass
class AdaMax(Adam):
    _op = staticmethod(updater_ops.ada_max_updater)


@dataclasses.dataclass
class AdaBelief(Adam):
    epsilon: float = 1e-14

    _op = staticmethod(updater_ops.adabelief_updater)


@dataclasses.dataclass
class Nadam(Adam):
    _op = staticmethod(updater_ops.nadam_updater)


@dataclasses.dataclass
class AMSGrad(Adam):
    def init(self, params):
        return {"v": _zeros(params), "m": _zeros(params),
                "h": _zeros(params)}

    def apply(self, grads, state, iteration):
        return _stateful(updater_ops.ams_grad_updater, ("v", "m", "h"),
                         grads, state,
                         lr=_lr_at(self.learning_rate, iteration),
                         beta1=self.beta1, beta2=self.beta2,
                         eps=self.epsilon, iteration=iteration)


@dataclasses.dataclass
class AdaGrad(IUpdater):
    learning_rate: Schedule = 1e-1
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": _zeros(params)}

    def apply(self, grads, state, iteration):
        return _stateful(updater_ops.ada_grad_updater, ("h",), grads, state,
                         lr=_lr_at(self.learning_rate, iteration),
                         eps=self.epsilon)


@dataclasses.dataclass
class AdaDelta(IUpdater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, params):
        return {"msg": _zeros(params), "msdx": _zeros(params)}

    def apply(self, grads, state, iteration):
        return _stateful(updater_ops.ada_delta_updater, ("msg", "msdx"),
                         grads, state, rho=self.rho, eps=self.epsilon)


@dataclasses.dataclass
class RmsProp(IUpdater):
    learning_rate: Schedule = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"g": _zeros(params)}

    def apply(self, grads, state, iteration):
        return _stateful(updater_ops.rms_prop_updater, ("g",), grads, state,
                         lr=_lr_at(self.learning_rate, iteration),
                         decay=self.rms_decay, eps=self.epsilon)


_UPDATERS = {c.__name__: c for c in
             [NoOp, Sgd, Nesterovs, Adam, AdaMax, AdaBelief, Nadam, AMSGrad,
              AdaGrad, AdaDelta, RmsProp]}


# -- learning-rate schedules (the reference's ISchedule) -------------------
def step_schedule(initial: float, decay_rate: float, step: int):
    def f(iteration):
        return initial * (decay_rate ** (iteration // step))
    return f


def exponential_schedule(initial: float, gamma: float):
    def f(iteration):
        return initial * (gamma ** iteration)
    return f


def inverse_schedule(initial: float, gamma: float, power: float = 1.0):
    def f(iteration):
        return initial / (1 + gamma * iteration) ** power
    return f


def poly_schedule(initial: float, power: float, max_iter: int):
    def f(iteration):
        frac = torch.clamp(torch.as_tensor(iteration) / max_iter, max=1.0)
        return initial * (1 - frac) ** power
    return f


def cosine_schedule(initial: float, max_iter: int, final: float = 0.0):
    def f(iteration):
        frac = torch.clamp(torch.as_tensor(iteration) / max_iter, max=1.0)
        return final + 0.5 * (initial - final) * (
            1 + torch.cos(math.pi * frac))
    return f


def warmup_linear_schedule(peak: float, warmup_iters: int, total_iters: int):
    def f(iteration):
        it = torch.as_tensor(iteration).float()
        warm = peak * it / max(warmup_iters, 1)
        decay = peak * torch.clamp(
            (total_iters - it) / max(total_iters - warmup_iters, 1), min=0.0)
        return torch.where(it < warmup_iters, warm, decay)
    return f
