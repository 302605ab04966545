"""Deterministic fault injection + the shared retry/backoff policy.

Counterpart of the JAX package's ``common/faults.py`` (the port imports
nothing from that package). Injection sites are string names on the hot
paths (``decode.prefill``, ``decode.step``, ``decode.loop``,
``http.handler``, ...); every call site guards with
``if faults.active():`` — one module-global bool read — so a process
with no armed rule pays nothing.

Rules are armed from ``DL4J_TPU_FAULTS="site:kind:rate:seed,..."`` at
import (:func:`load_env`), from such a string (:func:`configure`), or
programmatically (:func:`inject` / :func:`injected`, which add a bounded
``times`` budget and a ``predicate`` over the call-site context). ``kind``
is ``error`` (raise :class:`InjectedFault`) or ``delayNNN`` (sleep NNN
ms); ``rate`` is drawn from a per-rule ``random.Random(seed)``, so one
spec gives the same fault sequence on every run, in either package.
:func:`stats` describes the armed rules.

The module also owns the one exponential-backoff-with-jitter policy
(:class:`ExponentialBackoff`, :class:`RetryPolicy`, :func:`retry_call`)
the engine supervisors share.
"""
from __future__ import annotations

import logging
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional

from .locks import ordered_lock

log = logging.getLogger(__name__)


class InjectedFault(RuntimeError):
    """Raised by an armed ``error`` rule. A plain RuntimeError subclass:
    recovery paths treat it exactly like the real faults it stands in
    for."""

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at site '{site}'")
        self.site = site


class _FaultRule:
    """One armed rule at one site."""

    __slots__ = ("site", "kind", "rate", "seed", "delay_s", "times",
                 "predicate", "_rng", "triggered", "checked", "_lock")

    def __init__(self, site: str, kind: str = "error", rate: float = 1.0,
                 seed: int = 0, delay_s: float = 0.0,
                 times: Optional[int] = None,
                 predicate: Optional[Callable[[Dict[str, Any]], bool]] = None):
        if kind not in ("error", "delay"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self.site = str(site)
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self.delay_s = float(delay_s)
        self.times = times if times is None else int(times)
        self.predicate = predicate
        self._rng = random.Random(int(seed))
        self.triggered = 0
        self.checked = 0
        self._lock = ordered_lock("faults.registry")

    def fire(self, ctx: Dict[str, Any]) -> Optional[str]:
        """The kind to apply for this call, or None. The draw is taken
        under a lock so the seeded stream stays one sequence."""
        if self.predicate is not None:
            try:
                if not self.predicate(ctx):
                    return None
            except Exception:
                return None  # a broken predicate must never inject
        with self._lock:
            self.checked += 1
            if self.times is not None and self.triggered >= self.times:
                return None
            if self.rate < 1.0 and self._rng.random() >= self.rate:
                return None
            self.triggered += 1
        return self.kind

    def describe(self) -> Dict[str, Any]:
        return {"site": self.site, "kind": self.kind, "rate": self.rate,
                "seed": self.seed, "times": self.times,
                "checked": self.checked, "triggered": self.triggered}


#: site -> armed rules. `_active` mirrors bool(_RULES).
_RULES: Dict[str, List[_FaultRule]] = {}
_RULES_LOCK = ordered_lock("faults.rules")
_active = False


def active() -> bool:
    """True when any fault rule is armed — THE hot-path guard."""
    return _active


def inject(site: str, kind: str = "error", rate: float = 1.0,
           seed: int = 0, delay_s: float = 0.05,
           times: Optional[int] = None,
           predicate: Optional[Callable[[Dict[str, Any]], bool]] = None
           ) -> _FaultRule:
    """Arm one rule; returns it (pass it to :func:`remove`)."""
    global _active
    rule = _FaultRule(site, kind, rate, seed, delay_s, times, predicate)
    with _RULES_LOCK:
        _RULES.setdefault(rule.site, []).append(rule)
        _active = True
    return rule


def remove(rule: _FaultRule):
    global _active
    with _RULES_LOCK:
        rules = _RULES.get(rule.site)
        if rules and rule in rules:
            rules.remove(rule)
            if not rules:
                _RULES.pop(rule.site, None)
        _active = bool(_RULES)


def clear(site: Optional[str] = None):
    """Disarm every rule (or just ``site``'s)."""
    global _active
    with _RULES_LOCK:
        if site is None:
            _RULES.clear()
        else:
            _RULES.pop(site, None)
        _active = bool(_RULES)


def configure(spec: Optional[str]) -> int:
    """Replace the armed rules with a ``DL4J_TPU_FAULTS``-format string
    (``site:kind:rate:seed,...``; rate and seed optional). A malformed
    entry is skipped with a warning, so a typo'd spec degrades to "no
    injection" and never stops a server starting. Returns the number of
    rules armed."""
    clear()
    if not spec:
        return 0
    n = 0
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        try:
            site = fields[0]
            kind = fields[1] if len(fields) > 1 and fields[1] else "error"
            rate = float(fields[2]) if len(fields) > 2 and fields[2] else 1.0
            seed = int(fields[3]) if len(fields) > 3 and fields[3] else 0
            delay_s = 0.05
            if kind.startswith("delay"):
                ms = kind[len("delay"):]
                delay_s = (float(ms) / 1e3) if ms else 0.05
                kind = "delay"
            elif kind != "error":
                raise ValueError(f"unknown fault kind '{kind}'")
            if not site:
                raise ValueError("empty site")
            inject(site, kind=kind, rate=rate, seed=seed, delay_s=delay_s)
            n += 1
        except (ValueError, IndexError) as e:
            log.warning("ignoring malformed DL4J_TPU_FAULTS entry %r (%s)",
                        part, e)
    return n


def load_env() -> int:
    """(Re)arm the rules from the ``faults`` property
    (``DL4J_TPU_FAULTS``)."""
    from .environment import environment
    return configure(environment().faults_spec())


class injected:
    """Scoped injection: ``with faults.injected("decode.step", times=1):``
    arms on entry, disarms on exit (exception-safe)."""

    def __init__(self, site: str, **kw):
        self._args = (site, kw)
        self.rule: Optional[_FaultRule] = None

    def __enter__(self) -> _FaultRule:
        site, kw = self._args
        self.rule = inject(site, **kw)
        return self.rule

    def __exit__(self, *exc):
        if self.rule is not None:
            remove(self.rule)
        return False


def check(site: str, **ctx):
    """Evaluate ``site``'s armed rules; raises :class:`InjectedFault` (or
    sleeps, for delay rules) when one fires. Call sites guard with
    :func:`active`."""
    for rule in list(_RULES.get(site, ())):
        kind = rule.fire(ctx)
        if kind is None:
            continue
        from .metrics import registry
        registry().counter(
            "dl4j_faults_injected_total",
            "Faults fired by the injection registry, by site",
            labels=("site",)).labels(site=site).inc()
        if kind == "delay":
            time.sleep(rule.delay_s)
        else:
            raise InjectedFault(site)


def stats() -> List[Dict[str, Any]]:
    """Describe every armed rule (checked/triggered counts included): the
    ``/debug/resilience`` and flight-recorder view."""
    with _RULES_LOCK:
        return [r.describe() for rules in _RULES.values() for r in rules]


class ExponentialBackoff:
    """Exponential backoff with deterministic full jitter:
    ``min(base * factor**attempt, max_s)`` scaled by a seeded draw in
    ``[1-jitter, 1]``."""

    def __init__(self, base_s: float = 0.05, factor: float = 2.0,
                 max_s: float = 5.0, jitter: float = 0.5,
                 seed: Optional[int] = 0):
        if base_s <= 0 or factor < 1.0:
            raise ValueError("base_s must be > 0 and factor >= 1")
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.attempt = 0
        self._rng = random.Random(seed)

    def peek(self) -> float:
        """The next delay before jitter, without advancing."""
        return min(self.base_s * (self.factor ** self.attempt), self.max_s)

    def next_delay(self) -> float:
        d = self.peek()
        self.attempt += 1
        if self.jitter > 0.0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def reset(self):
        """Re-arm after a healthy period."""
        self.attempt = 0
        return self


class RetryBudgetExceeded(RuntimeError):
    """A supervised retry loop exhausted its max-restart budget; carries
    the last underlying failure as ``__cause__``."""


class RetryPolicy:
    """Max-restart budget + backoff for a supervised loop. A
    ``healthy_reset_s`` window (default 60 s) zeroes the budget after the
    loop ran that long without failing, so the budget bounds crash
    *bursts*, not a long-lived worker's lifetime restart count."""

    def __init__(self, max_restarts: int = 5, *, base_s: float = 0.05,
                 factor: float = 2.0, max_s: float = 5.0,
                 jitter: float = 0.5, seed: Optional[int] = 0,
                 healthy_reset_s: float = 60.0, clock=time.monotonic,
                 sleep=time.sleep):
        self.max_restarts = int(max_restarts)
        self.backoff = ExponentialBackoff(base_s, factor, max_s, jitter,
                                          seed)
        self.healthy_reset_s = float(healthy_reset_s)
        self._clock = clock
        self._sleep = sleep
        self._restarts = 0
        self._last_failure: Optional[float] = None

    @property
    def restarts(self) -> int:
        return self._restarts

    def note_failure(self) -> int:
        """Record one failure; returns the restart ordinal (1-based)."""
        now = self._clock()
        if (self._last_failure is not None
                and now - self._last_failure > self.healthy_reset_s):
            self._restarts = 0
            self.backoff.reset()
        self._last_failure = now
        self._restarts += 1
        return self._restarts

    def exhausted(self) -> bool:
        return self.max_restarts > 0 and self._restarts > self.max_restarts

    def sleep(self):
        """Sleep the next backoff delay."""
        self._sleep(self.backoff.next_delay())

    def reset(self):
        self._restarts = 0
        self._last_failure = None
        self.backoff.reset()
        return self


def retry_call(fn: Callable, *, policy: Optional[RetryPolicy] = None,
               retry_on=Exception,
               on_retry: Optional[Callable[[BaseException, int], None]] = None):
    """Call ``fn()`` under a :class:`RetryPolicy`: retried with backoff on
    ``retry_on`` until the budget runs out, then
    :class:`RetryBudgetExceeded` chained to the last failure."""
    policy = policy if policy is not None else RetryPolicy()
    while True:
        try:
            return fn()
        except retry_on as e:
            n = policy.note_failure()
            if policy.exhausted():
                raise RetryBudgetExceeded(
                    f"retry budget ({policy.max_restarts}) exhausted"
                ) from e
            if on_retry is not None:
                on_retry(e, n)
            policy.sleep()


# arm the rules DL4J_TPU_FAULTS names at import (off, and free, when it is
# unset, the default)
if os.environ.get("DL4J_TPU_FAULTS"):
    load_env()
