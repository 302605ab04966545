"""Keys for the layer API's random draws, and the stateful RNG facade.

Where the JAX package splits ``jax.random`` keys, the port's step key is
an int drawn from a host (CPU) ``torch.Generator`` (:func:`split`); the
layer API turns it into a 0-d int64 tensor on the network's device
(:func:`as_key`) and derives everything from there on that device:

- :func:`fold` hashes (key, layer or vertex index, purpose) into the key
  of one draw;
- :func:`uniform` and :func:`normal` draw from a counter-based hash of
  (key, element index) in plain integer ops (the design of the decode
  engine's sampling noise, ``runtime/generation.py::step_uniforms``).

A draw is a function of the key's value alone, whether the key is an int
or a tensor, so the eager step, its CUDA-graph replay (which reads the
key from a static buffer filled before each replay), a layer recomputed
under activation checkpointing and a rank drawing the global batch's
mask (``common/mesh.py::rows_draw``) all see the same masks. The values
are not ``jax.random``'s; only their statistics compare.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

_KEY_BOUND = 2 ** 62
_M32 = 0xFFFFFFFF

#: a step key: an int, or a 0-d int64 tensor on the draw's device
Key = Union[int, torch.Tensor]

#: the purposes a layer's key is folded with (:func:`fold`)
WEIGHT_NOISE, LAYER_DRAW = 0, 1


def split(host_gen: torch.Generator) -> int:
    """The next key of ``host_gen``'s stream."""
    return int(torch.randint(_KEY_BOUND, (1,), generator=host_gen))


def _mix32(x):
    """A 32-bit integer finaliser (two multiply-xorshift rounds) on ints
    or int64 tensors holding values below 2**32; every product stays
    below 2**59, so the arithmetic is exact on every device."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def as_key(key: Key, device) -> torch.Tensor:
    """``key`` as a 0-d int64 tensor on ``device`` (a tensor already
    there is returned as it is)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    return torch.tensor(int(key) & _M32, dtype=torch.int64, device=device)


def fold(key: Key, *data: int) -> Key:
    """The key derived from ``key`` and the ints ``data`` (a layer or
    vertex index, a purpose), on ``key``'s device; an int for an int."""
    if isinstance(key, torch.Tensor):
        key = key & _M32
    else:
        key = int(key) & _M32
    for d in data:
        key = _mix32(key ^ _mix32((int(d) + 0x9E3779B9) & _M32))
    return key


def uniform(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """float32 draws in (0, 1) of ``shape``: element i is a hash of
    (key, i), 24 bits of it."""
    k = fold(key)
    if isinstance(k, torch.Tensor):
        k = k.to(device)
    idx = torch.arange(math.prod(shape), device=device,
                       dtype=torch.int64).view(tuple(shape))
    h = _mix32((_mix32(idx ^ k) + k) & _M32)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def normal(key: Key, shape: Sequence[int], device,
           dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape`` (Box-Muller over two
    :func:`uniform` draws of one key), computed in float32."""
    u = uniform(key, (2,) + tuple(shape), device)
    z = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(
        (2.0 * math.pi) * u[1])
    return z.to(dtype)


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
