"""Runtime lock-order tracking (a copy of the JAX package's
``common/locks.py``; the port imports nothing from that package).

This module watches lock order at run time: cross-object call chains,
callback-driven acquisition, and whatever order the scheduler actually
produces under load. Every lock in the serving stack is an
:class:`OrderedLock` (or an :func:`ordered_condition` wrapping one); when
``DL4J_TPU_LOCK_CHECK`` is on, each *blocking* acquisition records the
edge ``held → acquiring`` into a process-wide acquisition graph keyed by
lock *name* (class-level identity — the granularity an ordering
discipline is defined at). The first time both ``A → B`` and ``B → A``
appear, a violation is recorded with both witness stacks: two code paths
take the same pair of locks in opposite orders, which is a deadlock
waiting for the right interleaving — found the first time the orders
*diverge*, not the first time they *collide*.

Cost model:

- **off (default)** — ``acquire`` pays one module-global ``bool`` read
  on top of the raw lock; nothing allocates.
- **on** — per acquisition: a thread-local stack push plus, per *held*
  lock, one dict probe; the meta-lock is only taken when a brand-new
  edge appears (the edge set converges within seconds of steady state).

Edges are recorded *before* blocking on the raw lock, so an inversion
that actually deadlocks still gets its second witness recorded first —
the report survives the hang.
"""
from __future__ import annotations

import logging
import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

__all__ = [
    "OrderedLock", "ordered_lock", "ordered_rlock", "ordered_condition",
    "lock_check_enabled", "set_lock_check", "refresh_lock_check",
    "violations", "clear_violations", "acquisition_edges",
]

# meta-state. _META guards the edge/violation tables and is itself a raw
# lock, never tracked (it is only ever the innermost acquisition).
_META = threading.Lock()
_EDGES: Dict[Tuple[str, str], Tuple[str, Tuple[str, ...], str]] = {}
_REPORTED: set = set()
_VIOLATIONS: List[dict] = []
_HELD = threading.local()  # .stack: List[Tuple[OrderedLock, str]]


def _env_enabled() -> bool:
    # bootstrap read: the tracker must not depend on Environment
    return os.environ.get("DL4J_TPU_LOCK_CHECK", "0").lower() in (
        "1", "true", "yes", "on")


_ENABLED = _env_enabled()


def lock_check_enabled() -> bool:
    return _ENABLED


def set_lock_check(enabled: bool) -> bool:
    """Arm/disarm the tracker; returns the PREVIOUS state (so scopes can
    restore it)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def refresh_lock_check() -> bool:
    """Re-read ``DL4J_TPU_LOCK_CHECK`` (for tests that set it late)."""
    set_lock_check(_env_enabled())
    return _ENABLED


def violations() -> List[dict]:
    """Recorded order inversions: ``{locks: (a, b), first: {thread,
    held, where}, second: {...}}`` — empty is the healthy state."""
    with _META:
        return list(_VIOLATIONS)


def clear_violations(edges: bool = True):
    """Reset the violation list (and by default the learned edge set, so
    a test starts from a clean graph)."""
    with _META:
        _VIOLATIONS.clear()
        _REPORTED.clear()
        if edges:
            _EDGES.clear()


def acquisition_edges() -> Dict[Tuple[str, str], Tuple[str, ...]]:
    """Snapshot of the observed order graph: ``{(held, acquired): held
    stack at first observation}``."""
    with _META:
        return {k: v[1] for k, v in _EDGES.items()}


def _where() -> str:
    # innermost non-locks frame, cheap enough for the armed path only
    for frame in reversed(traceback.extract_stack(limit=8)[:-3]):
        if not frame.filename.endswith("locks.py"):
            return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown>"


class OrderedLock:
    """Drop-in ``threading.Lock``/``RLock`` replacement with order
    tracking. ``name`` is the ordering identity — instances sharing a
    name share a node (one name per class-level lock attribute)."""

    __slots__ = ("name", "reentrant", "_raw")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = str(name)
        self.reentrant = bool(reentrant)
        self._raw = threading.RLock() if reentrant else threading.Lock()

    def __repr__(self):
        return (f"<OrderedLock {self.name!r} "
                f"{'reentrant ' if self.reentrant else ''}at {id(self):#x}>")

    # -- tracking ---------------------------------------------------------
    def _record(self, held: list):
        """Slow path: this acquisition nests under ``held`` locks."""
        me = threading.current_thread().name
        held_names = tuple(l.name for l in held)
        where = _where()
        for hl in held:
            hname = hl.name
            if hl is self or hname == self.name:
                if not self.reentrant and hl is self:
                    self._violate((self.name, self.name), me, held_names,
                                  where, me, held_names, where,
                                  kind="self_deadlock")
                continue
            edge = (hname, self.name)
            inverse = (self.name, hname)
            # lock-free fast path: once both probes are steady-state the
            # meta-lock is never touched again for this edge
            inv = _EDGES.get(inverse)
            if edge not in _EDGES:
                with _META:
                    if edge not in _EDGES:
                        _EDGES[edge] = (me, held_names, where)
                    inv = _EDGES.get(inverse)
            if inv is not None:
                self._violate(edge, me, held_names, where, *inv,
                              kind="order_inversion")

    def _violate(self, edge, thread2, held2, where2,
                 thread1, held1, where1, *, kind):
        pair = frozenset(edge) if kind == "order_inversion" else edge
        with _META:
            if pair in _REPORTED:
                return
            _REPORTED.add(pair)
            v = {"kind": kind, "locks": tuple(sorted(set(edge))),
                 "first": {"thread": thread1, "held": held1,
                           "where": where1},
                 "second": {"thread": thread2, "held": held2 + (self.name,),
                            "where": where2}}
            _VIOLATIONS.append(v)
        log.warning(
            "lock-order %s on %s: %s (held %s at %s) vs %s (held %s at "
            "%s) — two paths acquire these locks in opposite orders",
            kind, v["locks"], thread1, held1, where1, thread2, held2,
            where2)

    # -- the lock protocol -------------------------------------------------
    # The armed fast path is deliberately minimal: a thread-local list
    # append/remove around the raw acquire. All analysis (thread name,
    # stack summary, edge probes) lives in _record and only runs when the
    # acquisition actually NESTS under other tracked locks — un-nested
    # acquisitions (the overwhelming steady state) pay list ops only.
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _ENABLED and blocking:
            try:
                held = _HELD.stack
            except AttributeError:
                held = _HELD.stack = []
            if held and not (self.reentrant and self in held):
                self._record(held)
            got = self._raw.acquire(True, timeout)
            if got:
                held.append(self)
            return got
        return self._raw.acquire(blocking, timeout)

    def release(self):
        s = _HELD.__dict__.get("stack")
        if s:
            # drop one entry for this lock — Condition.wait() releases a
            # lock that is not necessarily top-of-stack, and identical
            # reentrant entries are interchangeable
            try:
                s.remove(self)
            except ValueError:
                pass
        self._raw.release()

    __enter__ = acquire

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    # -- threading.Condition integration -----------------------------------
    # Condition(lock) copies these when present. The held-stack entry is
    # deliberately NOT popped across wait(): the waiter still "owns" the
    # cv lock in ordering terms (it re-acquires before returning), which
    # matches the static pass's conservative treatment.
    def _is_owned(self) -> bool:
        raw = self._raw
        if hasattr(raw, "_is_owned"):
            return raw._is_owned()
        if raw.acquire(False):
            raw.release()
            return False
        return True

    def _release_save(self):
        raw = self._raw
        if hasattr(raw, "_release_save"):
            return raw._release_save()
        raw.release()
        return None

    def _acquire_restore(self, state):
        raw = self._raw
        if hasattr(raw, "_acquire_restore"):
            raw._acquire_restore(state)
        else:
            raw.acquire()

    def locked(self) -> bool:
        raw = self._raw
        if hasattr(raw, "locked"):
            return raw.locked()
        if raw.acquire(False):  # RLock has no locked(); probe
            raw.release()
            return False
        return True


def ordered_lock(name: str) -> OrderedLock:
    """A non-reentrant tracked lock (``threading.Lock`` semantics)."""
    return OrderedLock(name, reentrant=False)


def ordered_rlock(name: str) -> OrderedLock:
    """A reentrant tracked lock (``threading.RLock`` semantics)."""
    return OrderedLock(name, reentrant=True)


def ordered_condition(name: str) -> threading.Condition:
    """``threading.Condition`` over a tracked reentrant lock.
    ``wait()`` releases through the wrapper (the generic
    ``_release_save`` fallback), so the held-stack stays truthful across
    waits — re-acquisition on wakeup re-records its edges."""
    return threading.Condition(OrderedLock(name, reentrant=True))
