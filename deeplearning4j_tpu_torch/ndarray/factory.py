"""Array factory: the part of the ``Nd4j`` static factory the ported
modules call.

Counterpart of ``deeplearning4j_tpu/ndarray/factory.py``. Only what
``datasets/`` calls is here (``concat`` and the global RNG's seed); the
rest of the factory is ``ROADMAP.md`` queue 1 item 9. The process-global
RNG is a CPU ``torch.Generator`` (the reference's ``Nd4j.getRandom()``).
"""
from __future__ import annotations

import threading
from typing import Sequence

import torch

from .ndarray import NDArray, _unwrap


class _GlobalRng:
    """Stateful RNG facade (the reference's NativeRandom)."""

    def __init__(self, seed: int = 119):  # reference default seed
        self._lock = threading.Lock()
        self._gen = torch.Generator()
        self.set_seed(seed)

    def set_seed(self, seed: int):
        with self._lock:
            self._gen.manual_seed(int(seed))
            self._seed = int(seed)

    def get_seed(self) -> int:
        return self._seed

    def generator(self) -> torch.Generator:
        return self._gen


_rng = _GlobalRng()


def get_random() -> _GlobalRng:
    return _rng


def set_seed(seed: int):
    _rng.set_seed(seed)


def concat(arrays: Sequence, axis: int = 0) -> NDArray:
    return NDArray(torch.cat([_unwrap(a) for a in arrays], dim=axis))

