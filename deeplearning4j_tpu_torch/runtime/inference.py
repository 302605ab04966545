"""The bucket-ladder helpers and the two request errors that
``runtime/generation.py`` and ``serving/`` use, from the JAX package's
``runtime/inference.py``.

The JAX package's ``counted_jit`` has no counterpart: the port calls its
step functions eagerly, so there is no executable cache to count.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def bucket_ladder(max_batch: int,
                  buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The sorted bucket set: explicit ``buckets`` if given, else powers
    of two up to (and always including) ``max_batch``."""
    if buckets:
        out = sorted({int(b) for b in buckets if int(b) > 0})
        if not out:
            raise ValueError("bucket ladder is empty")
        return tuple(out)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


def bucket_for(n: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds the ladder."""
    for b in ladder:
        if b >= n:
            return b
    return None


class EngineClosedError(RuntimeError):
    """Raised by ``generate()`` once the engine is draining or closed:
    late requests fail fast with a signal the caller can act on."""


class PoisonRequestError(RuntimeError):
    """A request that failed its coalesced dispatch AND its one isolated
    re-dispatch: the failure follows the request, not the batch, so it is
    quarantined (HTTP 422 with trace id). Carries the underlying dispatch
    error as ``cause``."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause
