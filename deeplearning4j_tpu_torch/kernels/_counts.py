"""Launch counts that stay true under CUDA-graph replay.

Each kernel wrapper counts its launches on a plain integer beside it
(``paged_flash_decode.launches``, ``_fused_dequant_matmul.launches``, the
flash kernels'), and the dispatch records (``kernels.kernel_dispatch``,
``kernels.record_attention``) tick their metrics once a call. A replayed
CUDA graph (``runtime/cuda_graphs.py``) calls no Python wrapper, and a
capture launches nothing. So while a thread captures, what its wrappers
would count goes into that capture's :class:`LaunchRecord` instead, and
every replay of the graph adds the record: a count still counts the
launches the card ran.

Each wrapper also names its library (``wrapper.library``), which
:func:`libraries_used` collects for ``runtime/warm_image.py``.

Nothing here imports torch: the kernel modules import it at load.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Tuple

_local = threading.local()
#: the sets of the open :func:`libraries_used` blocks
_uses: List[set] = []


class LaunchRecord:
    """What one captured graph launches and records each time it
    replays."""

    def __init__(self):
        self.launches: Dict[Callable, int] = {}
        self.notes: List[Tuple[Callable, tuple]] = []

    def replay(self):
        """Add one replay's launches to the wrappers' counts and repeat
        its dispatch records."""
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        for fn, args in self.notes:
            fn(*args)

    def counts(self) -> Dict[str, int]:
        """Launches a replay makes, by wrapper name."""
        return {w.__name__: n for w, n in self.launches.items()}


def _record():
    return getattr(_local, "record", None)


def count_launch(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel: on its count, or on the record
    of the capture this thread runs (the launch happens at each
    replay)."""
    for names in _uses:
        names.add(wrapper.library)
    rec = _record()
    if rec is None:
        wrapper.launches += 1
    else:
        rec.launches[wrapper] = rec.launches.get(wrapper, 0) + 1


def deferred(fn: Callable, *args) -> bool:
    """True when this thread captures: ``fn(*args)`` is then kept for the
    capture's replays instead of running now."""
    rec = _record()
    if rec is None:
        return False
    rec.notes.append((fn, args))
    return True


@contextmanager
def recording(rec: LaunchRecord):
    """Route this thread's counts into ``rec`` for the block (a
    capture)."""
    prev = _record()
    _local.record = rec
    try:
        yield rec
    finally:
        _local.record = prev


@contextmanager
def libraries_used():
    """The set of kernel libraries (``wrapper.library``, a
    ``kernels/_build.py`` name) that any thread launches or captures in
    the block: what a warm image must hold for the work run there."""
    names: set = set()
    _uses.append(names)
    try:
        yield names
    finally:
        _uses.remove(names)
