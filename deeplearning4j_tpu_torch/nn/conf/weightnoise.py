"""Weight noise: stochastic parameter perturbation applied pre-forward.

Counterpart of ``deeplearning4j_tpu/nn/conf/weightnoise.py`` (the
reference's ``IWeightNoise``: DropConnect, WeightNoise). Train-time
only. Noise is a function of (key, params): the i-th param drawn for (in
sorted name order) draws from ``rng.fold(key, i)`` through the
counter-based hash of ``common/rng.py`` on the params' device, so a key
tensor inside a CUDA graph draws fresh noise on every replay. The draws
differ from the JAX package's; only their statistics compare.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ...common import rng
from .constraints import is_bias_param, is_weight_param


@dataclasses.dataclass
class DropConnect:
    """Randomly drop individual weights each forward pass
    (reference weightnoise/DropConnect.java).

    ``weight_retain_prob``: probability a weight is kept. Kept weights are
    scaled by 1/p (inverted form) so activation expectations match the
    noise-free inference path.
    """
    weight_retain_prob: float = 0.5
    apply_to_biases: bool = False

    def _hits(self, key, param):
        return (is_weight_param(key, param)
                or (self.apply_to_biases and is_bias_param(key, param)))

    def apply_tree(self, key: rng.Key, pdict: dict) -> dict:
        out = {}
        for i, k in enumerate(sorted(pdict)):
            p = pdict[k]
            if self._hits(k, p):
                keep = rng.uniform(rng.fold(key, i), p.shape, p.device) \
                    < self.weight_retain_prob
                out[k] = p * keep.to(p.dtype) / self.weight_retain_prob
            else:
                out[k] = p
        return out

    def to_dict(self):
        return {"@class": "DropConnect", **dataclasses.asdict(self)}


@dataclasses.dataclass
class WeightNoise:
    """Additive or multiplicative gaussian noise on weights
    (reference weightnoise/WeightNoise.java with a NormalDistribution).
    """
    mean: float = 0.0
    stddev: float = 0.1
    additive: bool = True
    apply_to_bias: bool = False

    def _hits(self, key, param):
        return (is_weight_param(key, param)
                or (self.apply_to_bias and is_bias_param(key, param)))

    def apply_tree(self, key: rng.Key, pdict: dict) -> dict:
        out = {}
        for i, k in enumerate(sorted(pdict)):
            p = pdict[k]
            if self._hits(k, p):
                noise = (self.mean + self.stddev * rng.normal(
                    rng.fold(key, i), p.shape, p.device)).to(p.dtype)
                out[k] = p + noise if self.additive else p * noise
            else:
                out[k] = p
        return out

    def to_dict(self):
        return {"@class": "WeightNoise", **dataclasses.asdict(self)}


_CLASSES = {"DropConnect": DropConnect, "WeightNoise": WeightNoise}


def weight_noise_from_dict(d: Optional[dict]):
    if not d:
        return None
    d = dict(d)
    return _CLASSES[d.pop("@class")](**d)
