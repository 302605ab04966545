"""Deterministic fault injection + the retry/backoff policy of the decode
loop's supervisor.

A copy of what the decode engine uses from the JAX package's
``common/faults.py`` (the port imports nothing from that package).
Injection sites are string names on the hot paths (``decode.prefill``,
``decode.step``, ``decode.loop``); every call site guards with
``if faults.active():`` — one module-global bool read — so a process
with no armed rule pays nothing. Rules are armed with :func:`inject` /
:func:`injected`; a ``times`` budget and a ``predicate`` over the
call-site context bound when one fires; :func:`stats` describes the armed
rules. The HTTP handler's site is ``http.handler``.
"""
from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List, Optional

from .locks import ordered_lock


class InjectedFault(RuntimeError):
    """Raised by an armed ``error`` rule. A plain RuntimeError subclass:
    recovery paths treat it exactly like the real faults it stands in
    for."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site '{site}'")
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

    def fire(self, ctx: Dict[str, Any]) -> bool:
        """Whether the rule fires for this call. The draw is taken under a
        lock so the seeded stream stays one sequence."""
        if self.predicate is not None and not self.predicate(ctx):
            return False
        with self._lock:
            self.checked += 1
            if self.times is not None and self.triggered >= self.times:
                return False
            if self.rate < 1.0 and self._rng.random() >= self.rate:
                return False
            self.triggered += 1
        return True

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
        if not rule.fire(ctx):
            continue
        from .metrics import registry
        registry().counter(
            "dl4j_faults_injected_total",
            "Faults fired by the injection registry, by site",
            labels=("site",)).labels(site=site).inc()
        if rule.kind == "delay":
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

    def next_delay(self) -> float:
        d = min(self.base_s * (self.factor ** self.attempt), self.max_s)
        self.attempt += 1
        if self.jitter > 0.0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d


class RetryPolicy:
    """Max-restart budget + backoff for a supervised loop. A
    ``healthy_reset_s`` window (default 60 s) zeroes the budget after the
    loop ran that long without failing, so the budget bounds crash
    *bursts*, not a long-lived worker's lifetime restart count."""

    def __init__(self, max_restarts: int = 5, *, base_s: float = 0.05,
                 factor: float = 2.0, max_s: float = 5.0,
                 jitter: float = 0.5, seed: Optional[int] = 0,
                 healthy_reset_s: float = 60.0, clock=time.monotonic):
        self.max_restarts = int(max_restarts)
        self.backoff = ExponentialBackoff(base_s, factor, max_s, jitter,
                                          seed)
        self.healthy_reset_s = float(healthy_reset_s)
        self._clock = clock
        self._restarts = 0
        self._last_failure: Optional[float] = None

    def note_failure(self) -> int:
        """Record one failure; returns the restart ordinal (1-based)."""
        now = self._clock()
        if (self._last_failure is not None
                and now - self._last_failure > self.healthy_reset_s):
            self._restarts = 0
            self.backoff.attempt = 0
        self._last_failure = now
        self._restarts += 1
        return self._restarts

    def exhausted(self) -> bool:
        return self.max_restarts > 0 and self._restarts > self.max_restarts
