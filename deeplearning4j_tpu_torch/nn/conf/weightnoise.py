"""Weight noise: stochastic parameter perturbation applied pre-forward.

Counterpart of ``deeplearning4j_tpu/nn/conf/weightnoise.py`` (the
reference's ``IWeightNoise``: DropConnect, WeightNoise). Train-time
only. Noise is a function of (key, params): the key seeds a generator on
the params' device (``common/rng.py``), so the draws differ from the JAX
package's and only their statistics compare.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...common import rng
from .constraints import is_bias_param, is_weight_param


def _device(pdict):
    return next(iter(pdict.values())).device


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

    def apply_tree(self, key: int, pdict: dict) -> dict:
        gen = rng.generator(key, _device(pdict))
        out = {}
        for k in sorted(pdict):
            p = pdict[k]
            if self._hits(k, p):
                keep = torch.rand(p.shape, generator=gen, device=p.device) \
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

    def apply_tree(self, key: int, pdict: dict) -> dict:
        gen = rng.generator(key, _device(pdict))
        out = {}
        for k in sorted(pdict):
            p = pdict[k]
            if self._hits(k, p):
                noise = (self.mean + self.stddev * torch.randn(
                    p.shape, generator=gen, device=p.device)).to(p.dtype)
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
