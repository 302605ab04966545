"""Keys for the layer API's random draws.

Where the JAX package splits ``jax.random`` keys, the port's key is an
int seed: :func:`split` draws one from a host (CPU) ``torch.Generator``
without touching the device, and :func:`generator` builds a generator on
the device the draw happens on. The same key gives the same draws, so a
layer recomputed under activation checkpointing draws the same dropout
mask on its second run, and nothing waits on the card to make a key.
"""
from __future__ import annotations

import torch

_KEY_BOUND = 2 ** 62


def split(host_gen: torch.Generator) -> int:
    """The next key of ``host_gen``'s stream."""
    return int(torch.randint(_KEY_BOUND, (1,), generator=host_gen))


def generator(key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(int(key))
