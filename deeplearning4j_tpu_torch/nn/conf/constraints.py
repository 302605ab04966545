"""Layer parameter constraints, applied after each parameter update.

Counterpart of ``deeplearning4j_tpu/nn/conf/constraints.py`` (the
reference's ``nn/conf/constraint/``: MaxNorm, MinMaxNorm, NonNegative,
UnitNorm, and the builder's ``constrainWeights`` / ``constrainBias`` /
``constrainAllParameters``). Pure tree transforms run right after the
updater. Rank >= 2 params are weights, rank <= 1 biases; ``state_*``
running stats are never touched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class BaseConstraint:
    """Shared config (reference BaseConstraint.java).

    ``dimensions``: dims the norm is reduced over. ``None`` means "all dims
    except the last" — per-output-unit norms for every catalog layout
    (Dense W [nIn,nOut] → dim 0; conv HWIO kernels → dims 0,1,2).
    ``param_names``: restrict to specific keys (empty = classification-based).
    """
    param_names: Tuple[str, ...] = ()
    dimensions: Optional[Tuple[int, ...]] = None
    epsilon: float = 1e-6

    def _dims(self, rank: int) -> Tuple[int, ...]:
        if self.dimensions is not None:
            return tuple(d for d in self.dimensions if d < rank)
        return tuple(range(max(rank - 1, 0)))

    def _norm(self, p):
        dims = self._dims(p.dim())
        if not dims:
            return torch.abs(p)
        return torch.sqrt(torch.sum(p * p, dim=dims, keepdim=True))

    def apply(self, param):
        raise NotImplementedError

    def applies_to(self, key: str, param) -> bool:
        if key.startswith("state_"):
            return False
        if self.param_names:
            return key in self.param_names
        return True

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d


@dataclasses.dataclass
class MaxNormConstraint(BaseConstraint):
    """Rescale params whose L2 norm exceeds ``max_norm``
    (reference MaxNormConstraint.java)."""
    max_norm: float = 1.0

    def apply(self, param):
        norm = self._norm(param)
        clipped = torch.clamp_max(norm, self.max_norm)
        return param * (clipped / (norm + self.epsilon))


@dataclasses.dataclass
class MinMaxNormConstraint(BaseConstraint):
    """Constrain norms into [min_norm, max_norm], moving at ``rate``
    (reference MinMaxNormConstraint.java; rate=1.0 projects fully)."""
    min_norm: float = 0.0
    max_norm: float = 1.0
    rate: float = 1.0

    def apply(self, param):
        norm = self._norm(param)
        clipped = torch.clamp(norm, self.min_norm, self.max_norm)
        scale = 1.0 - self.rate + self.rate * clipped / (norm + self.epsilon)
        return param * scale


@dataclasses.dataclass
class NonNegativeConstraint(BaseConstraint):
    """Clamp params at zero (reference NonNegativeConstraint.java)."""

    def apply(self, param):
        return torch.clamp_min(param, 0.0)


@dataclasses.dataclass
class UnitNormConstraint(BaseConstraint):
    """Project params onto the unit L2 sphere
    (reference UnitNormConstraint.java)."""

    def apply(self, param):
        return param / (self._norm(param) + self.epsilon)


_CLASSES = {c.__name__: c for c in
            (MaxNormConstraint, MinMaxNormConstraint, NonNegativeConstraint,
             UnitNormConstraint)}


def constraint_from_dict(d: dict) -> BaseConstraint:
    d = dict(d)
    cls = _CLASSES[d.pop("@class")]
    for k in ("param_names", "dimensions"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return cls(**d)


def is_weight_param(key: str, param) -> bool:
    return not key.startswith("state_") and getattr(param, "ndim", 0) >= 2


def is_bias_param(key: str, param) -> bool:
    return not key.startswith("state_") and getattr(param, "ndim", 0) <= 1


#: target selectors for the builder-level hooks
_TARGETS = {
    "weights": is_weight_param,
    "bias": is_bias_param,
    "all": lambda k, p: not k.startswith("state_"),
}


def apply_constraints(specs, trainable):
    """Apply ``[(target, constraint)]`` to a list (or name -> dict) of
    per-layer param dicts; returns the projected copy."""
    if not specs:
        return trainable

    def project(pdict):
        out = {}
        for k, p in pdict.items():
            for target, c in specs:
                if _TARGETS[target](k, p) and c.applies_to(k, p):
                    p = c.apply(p)
            out[k] = p
        return out

    if isinstance(trainable, dict):
        return {n: project(p) for n, p in trainable.items()}
    return [project(p) for p in trainable]


def specs_to_json(specs):
    return [[t, c.to_dict()] for t, c in specs or []]


def specs_from_json(data):
    return [(t, constraint_from_dict(d)) for t, d in data or []]
