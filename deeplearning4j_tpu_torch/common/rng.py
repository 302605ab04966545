"""Keys for the layer API's random draws, and the stateful RNG facade.

Where the JAX package splits ``jax.random`` keys, the port's key is an
int seed: :func:`split` draws one from a host (CPU) ``torch.Generator``
without touching the device, and :func:`generator` builds a generator on
the device the draw happens on. The same key gives the same draws, so a
layer recomputed under activation checkpointing draws the same dropout
mask on its second run, and nothing waits on the card to make a key.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch

_KEY_BOUND = 2 ** 62


def split(host_gen: torch.Generator) -> int:
    """The next key of ``host_gen``'s stream."""
    return int(torch.randint(_KEY_BOUND, (1,), generator=host_gen))


def generator(key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(int(key))


class NativeRandom:
    """Stateful random facade (the reference's ``Nd4j.getRandom()`` /
    ``DefaultRandom``), counterpart of the JAX package's over threefry
    keys: here one ``torch.Generator`` on ``device``, seeded by
    :meth:`set_seed`. A seed and a sequence of draws give the same values
    on every run; the values are Philox's, not the JAX package's.
    ``position`` counts the draws since the last seed."""

    def __init__(self, seed: int = 0, device="cpu"):
        self._lock = threading.Lock()
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)
        self.set_seed(seed)

    def set_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
            self._gen.manual_seed(self._seed)
            self._counter = 0

    def get_seed(self) -> int:
        return self._seed

    @property
    def position(self) -> int:
        """Draws taken since the last seed (reference getPosition)."""
        return self._counter

    def _draw(self, fn, *args, **kw) -> torch.Tensor:
        with self._lock:
            self._counter += 1
            return fn(*args, generator=self._gen, device=self.device, **kw)

    # -- typed draws (the reference next* surface) -----------------------
    def next_int(self, bound: Optional[int] = None,
                 shape: Tuple[int, ...] = ()) -> torch.Tensor:
        hi = bound if bound is not None else 2 ** 31 - 1
        return self._draw(torch.randint, 0, hi, tuple(shape),
                          dtype=torch.int32)

    def next_long(self, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self._draw(torch.randint, 0, 2 ** 31 - 1, tuple(shape),
                          dtype=torch.int64)

    def next_double(self, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self._draw(torch.rand, tuple(shape), dtype=torch.float32)

    def next_float(self, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self._draw(torch.rand, tuple(shape), dtype=torch.float32)

    def next_gaussian(self, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self._draw(torch.randn, tuple(shape), dtype=torch.float32)

    def next_boolean(self, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self._draw(torch.rand, tuple(shape),
                          dtype=torch.float32) < 0.5

    # -- array factories (reference Nd4j.rand / randn with an rng) -------
    def uniform(self, shape: Sequence[int], minval=0.0, maxval=1.0
                ) -> torch.Tensor:
        u = self._draw(torch.rand, tuple(shape), dtype=torch.float32)
        return minval + (maxval - minval) * u

    def normal(self, shape: Sequence[int], mean=0.0, std=1.0
               ) -> torch.Tensor:
        return mean + std * self._draw(torch.randn, tuple(shape),
                                       dtype=torch.float32)


_default = NativeRandom(seed=0)


def get_random() -> NativeRandom:
    """The process's default :class:`NativeRandom` (reference
    ``Nd4j.getRandom()``), on the CPU."""
    return _default


def set_default_seed(seed: int):
    _default.set_seed(seed)
