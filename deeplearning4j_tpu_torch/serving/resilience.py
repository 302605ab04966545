"""Self-healing serving: circuit breakers, engine health, dispatch
watchdog.

A copy of the JAX package's ``serving/resilience.py`` (the port imports
nothing from that package). Reference: the Clipper (NSDI '17) practice of isolating a misbehaving
model container behind a fallback, and the Clockwork (OSDI '20) rule
that predictable serving requires actively refusing work that cannot be
served well. The engine-level half of the story lives in the engines
themselves (supervised worker restart and poison-request quarantine in
``runtime/inference.py`` / ``runtime/generation.py``, backed by
``common.faults``); this module is the *serving-layer* half:

- :class:`CircuitBreaker` — per model *version*. Consecutive dispatch
  failures open it; open fails fast (:class:`BreakerOpenError` → HTTP
  503 + ``Retry-After``) instead of queueing doomed work behind a sick
  executable; after ``DL4J_TPU_BREAKER_PROBE_S`` one half-open probe is
  let through — success re-closes, failure re-opens. A breaker that
  re-opens ``DL4J_TPU_AUTO_ROLLBACK_OPENS`` times in a row is
  *persistently* open: with ``DL4J_TPU_AUTO_ROLLBACK=1`` and a warm
  parked previous version, ``ModelRegistry`` rolls back to it —
  degraded service beats no service.
- :class:`HealthRegistry` (module singleton :func:`health`) — the
  aggregated engine-health signal ``/readyz`` gates on, fed by the
  watchdog and by engine-supervisor permadeath.
- :class:`EngineWatchdog` (module singleton :func:`watchdog`) — polls
  registered engines' in-flight dispatch age; a dispatch stuck past
  ``deadline × DL4J_TPU_WATCHDOG_FACTOR`` (or a worker thread whose
  restart budget is exhausted) marks the engine unhealthy so the load
  balancer stops routing here; recovery clears the mark.

Metrics: ``dl4j_breaker_state{model,version}`` (0 closed / 1 half-open /
2 open), ``dl4j_breaker_transitions_total{model,state}``,
``dl4j_engine_healthy{engine}``, ``dl4j_auto_rollbacks_total{model}``
(in the registry).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from ..common.environment import environment
from ..common.locks import ordered_lock
from ..common.metrics import registry as metrics_registry

log = logging.getLogger(__name__)

#: breaker states (also the gauge values)
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}


class BreakerOpenError(RuntimeError):
    """Fail-fast refusal: the model version's breaker is open. Carries
    the time until the next half-open probe as ``retry_after_s`` (the
    HTTP layer merges it with the admission EWMA hint)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.001)


class CircuitBreaker:
    """Consecutive-failure breaker for one (model, version) pair."""

    def __init__(self, model: str, version: str, *,
                 threshold: Optional[int] = None,
                 probe_s: Optional[float] = None,
                 clock=time.monotonic):
        env = environment()
        self.model = str(model)
        self.version = str(version)
        self.threshold = (env.breaker_threshold() if threshold is None
                          else max(int(threshold), 1))
        self.probe_s = (env.breaker_probe_s() if probe_s is None
                        else float(probe_s))
        self._clock = clock
        self._lock = ordered_lock("breaker")
        self._state = CLOSED
        self._failures = 0          # consecutive, reset on success
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self.consecutive_opens = 0  # opens without a success between
        reg = metrics_registry()
        self._m_state = reg.gauge(
            "dl4j_breaker_state",
            "Circuit-breaker state per served model version "
            "(0 closed, 1 half-open, 2 open)",
            labels=("model", "version")).labels(model=self.model,
                                                version=self.version)
        self._m_state.set(CLOSED)
        self._m_transitions = reg.counter(
            "dl4j_breaker_transitions_total",
            "Circuit-breaker state transitions, by resulting state",
            labels=("model", "state"))
        self._m_rejected = reg.counter(
            "dl4j_breaker_rejections_total",
            "Requests failed fast by an open circuit breaker",
            labels=("model", "version")).labels(model=self.model,
                                                version=self.version)

    # -- introspection ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return _STATE_NAMES[self._state]

    def snapshot(self) -> Dict:
        with self._lock:
            return {"model": self.model, "version": self.version,
                    "state": _STATE_NAMES[self._state],
                    "consecutive_failures": self._failures,
                    "consecutive_opens": self.consecutive_opens,
                    "threshold": self.threshold, "probe_s": self.probe_s}

    def _transition(self, state: int):
        self._state = state
        self._m_state.set(state)
        self._m_transitions.labels(model=self.model,
                                   state=_STATE_NAMES[state]).inc()

    # -- the contract ------------------------------------------------------
    def preflight(self):
        """Gate one dispatch attempt. Open: raise
        :class:`BreakerOpenError` until the probe window elapses, then
        let exactly ONE caller through half-open (concurrent callers
        keep failing fast until the probe resolves)."""
        with self._lock:
            if self._state == CLOSED:
                return
            now = self._clock()
            if self._state == OPEN and \
                    now - self._opened_at >= self.probe_s:
                self._transition(HALF_OPEN)
                self._probe_inflight = False
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True  # this caller IS the probe
                return
            remaining = (max(self._opened_at + self.probe_s - now, 0.0)
                         if self._opened_at is not None else self.probe_s)
            self._m_rejected.inc()
            raise BreakerOpenError(
                f"model '{self.model}' version '{self.version}' breaker "
                f"is {_STATE_NAMES[self._state]} "
                f"({self._failures} consecutive dispatch failures); "
                "failing fast", retry_after_s=remaining or self.probe_s)

    def record_success(self):
        with self._lock:
            if self._state != CLOSED:
                log.info("breaker %s:%s re-closed after probe success",
                         self.model, self.version)
                self._transition(CLOSED)
            self._failures = 0
            self.consecutive_opens = 0
            self._probe_inflight = False

    def record_failure(self) -> bool:
        """Count one dispatch failure; returns True when this failure
        opened (or re-opened) the breaker."""
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open
                self._transition(OPEN)
                self._opened_at = self._clock()
                self._probe_inflight = False
                self.consecutive_opens += 1
                log.warning("breaker %s:%s probe failed; re-opened "
                            "(%d consecutive opens)", self.model,
                            self.version, self.consecutive_opens)
                return True
            if self._state == CLOSED and self._failures >= self.threshold:
                self._transition(OPEN)
                self._opened_at = self._clock()
                self.consecutive_opens += 1
                log.warning(
                    "breaker %s:%s opened after %d consecutive dispatch "
                    "failures", self.model, self.version, self._failures)
                return True
            return False


# ---------------------------------------------------------------------------
# engine health (the /readyz signal)
# ---------------------------------------------------------------------------

class HealthRegistry:
    """Aggregated engine-health flags. Empty = healthy. Keys are
    ``model:version`` (or any engine identity); each carries a reason
    so ``/readyz`` and the flight recorder can say *why*."""

    def __init__(self):
        self._lock = ordered_lock("health")
        self._unhealthy: Dict[str, str] = {}
        self._m = metrics_registry().gauge(
            "dl4j_engine_healthy",
            "1 while the engine's dispatch path is healthy, else 0",
            labels=("engine",))

    def set_unhealthy(self, key: str, reason: str):
        with self._lock:
            known = key in self._unhealthy
            self._unhealthy[key] = reason
        self._m.labels(engine=key).set(0)
        if not known:
            log.warning("engine %s marked unhealthy: %s", key, reason)

    def clear(self, key: str):
        with self._lock:
            was = self._unhealthy.pop(key, None)
        self._m.labels(engine=key).set(1)
        if was is not None:
            log.info("engine %s healthy again (was: %s)", key, was)

    def healthy(self) -> bool:
        with self._lock:
            return not self._unhealthy

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._unhealthy)

    def reset(self):
        """Forget every unhealthy mark."""
        with self._lock:
            self._unhealthy.clear()


_HEALTH: Optional[HealthRegistry] = None
_HEALTH_LOCK = ordered_lock("resilience.health_singleton")


def health() -> HealthRegistry:
    global _HEALTH
    if _HEALTH is None:
        with _HEALTH_LOCK:
            if _HEALTH is None:
                _HEALTH = HealthRegistry()
    return _HEALTH


# ---------------------------------------------------------------------------
# dispatch watchdog
# ---------------------------------------------------------------------------

class EngineWatchdog:
    """Polls registered engines for stuck dispatches and dead workers.

    Engines expose two cheap fields the watchdog reads from outside —
    ``_dispatch_started_at`` (monotonic instant of the in-flight device
    dispatch, or None) and ``worker_dead`` (the supervised worker
    thread exhausted its restart budget) — so the runtime layer stays
    free of serving imports and the hot path pays two attribute stores
    per dispatch. An overdue dispatch or a dead worker flips the engine
    unhealthy in :func:`health`; recovery clears it."""

    def __init__(self, poll_s: float = 0.25):
        self.poll_s = float(poll_s)
        self._lock = ordered_lock("watchdog")
        self._watched: Dict[str, Tuple[object, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, key: str, engine, budget_s: float):
        """Watch ``engine`` under ``key``; dispatches older than
        ``budget_s`` mark it unhealthy."""
        with self._lock:
            self._watched[str(key)] = (engine, float(budget_s))
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="dl4j-torch-engine-watchdog",
                    daemon=True)
                self._thread.start()

    def unregister(self, key: str):
        with self._lock:
            self._watched.pop(str(key), None)
        health().clear(str(key))

    def watched(self) -> Dict[str, float]:
        with self._lock:
            return {k: b for k, (_, b) in self._watched.items()}

    def check_now(self):
        """One evaluation pass (tests call this instead of sleeping)."""
        now = time.monotonic()
        with self._lock:
            watched = dict(self._watched)
        h = health()
        for key, (engine, budget) in watched.items():
            if getattr(engine, "worker_dead", False):
                h.set_unhealthy(key, "worker thread permanently failed "
                                     "(restart budget exhausted)")
                continue
            started = getattr(engine, "_dispatch_started_at", None)
            if started is not None and now - started > budget:
                h.set_unhealthy(
                    key, f"dispatch in flight for {now - started:.2f}s "
                         f"(budget {budget:.2f}s)")
            else:
                h.clear(key)

    def _loop(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if not self._watched:
                    self._thread = None
                    return
            try:
                self.check_now()
            except Exception:
                log.exception("engine watchdog pass failed")

    def stop(self):
        self._stop.set()
        with self._lock:
            self._watched.clear()
            t = self._thread
        if t is not None:
            t.join(timeout=5)


_WATCHDOG: Optional[EngineWatchdog] = None
_WATCHDOG_LOCK = ordered_lock("resilience.watchdog_singleton")


def watchdog() -> EngineWatchdog:
    global _WATCHDOG
    if _WATCHDOG is None:
        with _WATCHDOG_LOCK:
            if _WATCHDOG is None:
                _WATCHDOG = EngineWatchdog()
    return _WATCHDOG


def watchdog_budget_s() -> Optional[float]:
    """The dispatch budget engines are watched against: default serving
    deadline × ``DL4J_TPU_WATCHDOG_FACTOR``; None = watchdog disabled
    (factor <= 0)."""
    env = environment()
    factor = env.watchdog_factor()
    if factor <= 0:
        return None
    deadline = env.serving_default_timeout_s() or 30.0
    return deadline * factor


# ---------------------------------------------------------------------------
# rolling dispatch outcomes (outlier detection substrate)
# ---------------------------------------------------------------------------

class DispatchStats:
    """Rolling window over actual dispatch outcomes of one upstream —
    the Envoy-style outlier-detection substrate. ``/readyz`` polls only
    prove a replica can answer its health endpoint; a *zombie* answers
    those and fails traffic, so ejection decisions must come from the
    outcomes of real dispatches. Deliberately unsynchronized: the owner
    (``FleetRouter``) already serializes access under its own lock."""

    __slots__ = ("window", "_outcomes")

    def __init__(self, window: int = 20):
        self.window = max(int(window), 1)
        self._outcomes: deque = deque(maxlen=self.window)

    def record(self, ok: bool, latency_s: Optional[float] = None):
        self._outcomes.append((bool(ok), latency_s))

    def __len__(self) -> int:
        return len(self._outcomes)

    def error_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        errors = sum(1 for ok, _ in self._outcomes if not ok)
        return errors / len(self._outcomes)

    def mean_latency_s(self) -> Optional[float]:
        """Mean over outcomes that carry a latency (errors usually
        don't); None until one does."""
        vals = [lat for _, lat in self._outcomes if lat is not None]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def reset(self):
        """Forget history (probe re-admission: the replica restarts its
        audition from a clean slate)."""
        self._outcomes.clear()

    def snapshot(self) -> Dict[str, object]:
        mean = self.mean_latency_s()
        return {"samples": len(self._outcomes),
                "error_rate": round(self.error_rate(), 4),
                "mean_latency_s": None if mean is None else round(mean, 6)}


def latency_zscore(mean_s: float, peer_means_s: "list[float]",
                   min_peers: int = 2, min_ratio: float = 2.0) -> float:
    """How many standard deviations ``mean_s`` sits above its peers'
    mean latencies. Too few peers → 0 (no basis to call an outlier).
    Statistical significance alone is not enough: when peers agree to
    the microsecond the std collapses and a replica 0.2 ms slower would
    score z > 3, so the candidate must ALSO be at least ``min_ratio``
    times the peer mean before any non-zero score is returned.
    Degenerate peer spread (std ~ 0, the common case on a quiet fleet)
    then falls back to that ratio test alone: past it reads as +inf —
    a lone slow replica must not hide behind zero variance."""
    peers = [m for m in peer_means_s if m is not None]
    if len(peers) < max(int(min_peers), 1):
        return 0.0
    pmean = sum(peers) / len(peers)
    if pmean <= 0 or mean_s <= min_ratio * pmean:
        return 0.0
    var = sum((m - pmean) ** 2 for m in peers) / len(peers)
    std = var ** 0.5
    if std < 1e-9:
        return float("inf")
    return (mean_s - pmean) / std
