"""Front-of-fleet replica router: tail-tolerant scale-out over N
``ModelServer``\\ s.

A copy of the JAX package's ``serving/fleet/router.py`` (the port imports
nothing from that package; the router needs no JAX there either): host
code over HTTP, on the port's ``common/*`` and ``serving/resilience.py``.

One :class:`FleetRouter` fronts N independent serving replicas (each a
``serving.ModelServer``, typically one process per card or host),
addressed by base URL. The router is deliberately *stateless* about
models: replicas own deployment, warmup, admission, and SLOs; the router
only decides **which** replica answers a request and what happens when a
replica-level failure or a slow tail threatens it.

Routing policy — least loaded, admission-aware:

- A background poller refreshes every replica's ``/readyz`` (is it
  allowed to take traffic at all?) and ``/metrics.json`` (the admission
  controller's live gauges: ``dl4j_serving_ewma_service_seconds``,
  ``dl4j_serving_queue_depth``, ``dl4j_serving_active``,
  ``dl4j_serving_waiters``) every ``DL4J_TPU_FLEET_POLL_S`` seconds.
  Malformed poll payloads degrade that replica to a *neutral* score and
  count a ``poll_error`` — junk JSON must never wedge scoring.
- A request for model M goes to the READY replica with the lowest
  expected drain time: ``(waiters + router-side in-flight) x EWMA
  service seconds``. Router-side in-flight counts dispatches the poller
  has not seen yet, so a burst does not pile onto one replica between
  polls.

Tail tolerance (Dean & Barroso, *The Tail at Scale*; the same shapes
Envoy ships as retry budgets + outlier detection):

- **Retry budget** (:class:`RetryBudget`): one fleet-wide token bucket
  (``DL4J_TPU_FLEET_RETRY_BUDGET``, default 0.2) that every failover
  AND every hedge draws from. Tokens accrue per primary dispatch, so
  extra attempts are bounded to ~20% of recent offered load (plus a
  small burst) — a sick fleet degrades to pass-through instead of
  amplifying its own overload with a retry storm. Budget exhausted ⇒
  dispatch count == request count.
- **Hedged requests**: an *idempotent* request (predict; never
  generate) still unanswered past the per-model hedge delay — the
  ``DL4J_TPU_FLEET_HEDGE_PCTL`` percentile of the router's own observed
  dispatch latencies — gets a second, budgeted attempt on a different
  replica. First non-503 answer wins; the loser is abandoned and
  counted (``outcome="abandoned"``).
- **Outlier ejection**: per-replica error-rate + latency-z-score over
  *actual dispatch outcomes* (``serving.resilience.DispatchStats``),
  not just ``/readyz`` polls — a zombie that polls healthy but fails
  traffic is caught here. An ejected replica leaves rotation with
  exponential backoff and re-admits via a single probe request; a
  max-ejection fraction stops the router from ejecting itself to zero,
  and when nothing scores as routable the router *panics* open (routes
  to any known non-ejected replica) rather than failing the request.
- **Failover** still retries replica-level failures — connection
  refused/reset, timeout, HTTP 503 — on a *different* replica, up to
  ``DL4J_TPU_FLEET_RETRIES`` (budget permitting); the failed replica is
  marked not-ready until a poll succeeds. Request-level outcomes
  (2xx/4xx/429) are the replica's answer and are returned as-is. A 503
  that cannot be retried is *passed through* with its ``Retry-After``
  intact instead of being flattened into :class:`NoReplicaError`.
- **Non-retryable mid-stream failures**: once a non-idempotent request
  (generate) has started consuming its response body, a connection
  reset surfaces as :class:`MidStreamError` carrying the trace id —
  never a silent duplicate generation.

Brownout (:class:`FleetServer`): when the fleet's ready fraction falls
below ``DL4J_TPU_FLEET_BROWNOUT_FRAC``, the front door sheds
lowest-priority traffic first (``X-Priority`` header 0–9, default
``DL4J_TPU_FLEET_DEFAULT_PRIORITY``) with 503 + ``Retry-After``, and
tightens forwarded deadlines in proportion to the capacity deficit.

Session affinity (prefix-cache locality): a request carrying a session
key — the ``X-Session-Id`` header, or for generates without one a
fingerprint of the prompt's leading tokens — is pinned to the replica
that owns the key on a consistent-hash ring (``affinity_vnodes``
virtual nodes per replica, so membership churn only remaps ~1/N of
sessions). Follow-up turns of a chat session therefore land on the
replica whose decode engine already holds the session's KV blocks in
its radix prefix cache (``runtime.generation``). Affinity is strictly
an *optimization*: when the ring owner is ejected, not ready, no
longer serving the model, or the fleet is browned out, the request
degrades to the normal least-loaded pick
(``dl4j_fleet_affinity_total{outcome="fallback"}``), and a failed
affine attempt fails over to least-loaded exactly like any other.
Generates are never hedged (they are non-idempotent), so an affine
generate never races a cold replica against the warm one.

Fault sites for drills (``common.faults``): ``fleet.dispatch`` (ctx
``url``/``model``/``phase``: ``connect`` = connection failure or slow
replica, ``body`` = truncated response / mid-stream reset) and
``fleet.poll`` (ctx ``url``).

Scale-out elasticity rides the warmup manifests of the serving layer: a
joining replica pointed at the shared manifest directory
(``DL4J_TPU_SERVING_MANIFEST_DIR``) runs the fleet's observed bucket
ladder during ``deploy()``; its ``/readyz`` stays false until the ladder
is warm, so ``add_replica()`` can be called *before* warmup finishes and
the router will not route to it until it is actually ready. With a
shared artifact store (``DL4J_TPU_REMOTE_CACHE``, a fleet bucket or a
baked warm image) the joiner's ``lifecycle.restore_on_boot`` also pulls
the kernel libraries, so it serves without running ``nvcc``.

Poll scheduling is jittered: each replica is polled on its own
deterministic phase within ``DL4J_TPU_FLEET_POLL_S`` (see
``poll_offset``) so N replicas don't all get probed on the same tick.

Telemetry: ``dl4j_fleet_replicas{model}``,
``dl4j_router_dispatch_total{replica,outcome}`` with outcome
``ok|failover|failed|passthrough|abandoned|no_replica``,
``dl4j_fleet_hedges_total{model,outcome}`` (``launched|won|suppressed``),
``dl4j_fleet_retry_tokens``, ``dl4j_fleet_budget_denials_total{reason}``,
``dl4j_fleet_ejections_total{replica,reason}``,
``dl4j_fleet_readmissions_total{replica}``, ``dl4j_fleet_ejected``,
``dl4j_fleet_poll_errors_total{replica,reason}``,
``dl4j_fleet_shed_total{model,priority}``, ``dl4j_fleet_brownout``,
``dl4j_fleet_ready_fraction``,
``dl4j_fleet_affinity_total{outcome}`` (``hit|fallback``).
"""
from __future__ import annotations

import json
import logging
import math
import queue
import re
import threading
import time
import bisect
import hashlib
import urllib.error
import urllib.request
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ...common import faults
from ...common.environment import environment
from ...common.locks import ordered_lock
from ...common.metrics import registry as metrics_registry
from ...common.tracing import (TraceContext, context_from_traceparent,
                               format_traceparent, new_span_id, span_tree,
                               tracer)
from ..resilience import DispatchStats, latency_zscore
from .aggregator import FleetAggregator

log = logging.getLogger(__name__)

#: admission gauges polled off every replica's /metrics.json; missing
#: series (a replica that has not served yet) default to 0.0
_POLLED_GAUGES = ("dl4j_serving_ewma_service_seconds",
                  "dl4j_serving_queue_depth",
                  "dl4j_serving_active",
                  "dl4j_serving_waiters")


class NoReplicaError(RuntimeError):
    """No ready replica could take the request (none ready, or every
    attempt hit a replica-level failure with the retry budget spent)."""


class MidStreamError(RuntimeError):
    """A non-idempotent request (generate) lost its connection AFTER the
    response body started streaming. Retrying would silently run the
    generation twice, so the failure surfaces instead, carrying the
    replica's trace id for correlation."""

    def __init__(self, replica_url: str, trace_id: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(
            f"mid-stream failure from {replica_url}"
            + (f" (trace {trace_id})" if trace_id else "")
            + (f": {cause!r}" if cause else "")
            + "; not retried — the generation may have run")
        self.replica_url = replica_url
        self.trace_id = trace_id
        self.cause = cause


class RetryBudget:
    """Fleet-wide token bucket that every extra dispatch — failover
    retry or hedge — must draw from. Tokens accrue at ``ratio`` per
    *primary* dispatch up to a small ``burst`` cap, so extra attempts
    are bounded to ``ratio`` of recent offered load: under a fleet-wide
    failure the router degrades to pass-through instead of amplifying
    the overload. ``ratio`` 0 disables every extra dispatch. Not
    self-locking — the owning router serializes access."""

    def __init__(self, ratio: float, burst: Optional[float] = None):
        self.ratio = min(max(float(ratio), 0.0), 1.0)
        if burst is None:
            burst = max(1.0, self.ratio * 50.0)
        self.burst = float(burst) if self.ratio > 0 else 0.0
        self.tokens = self.burst

    def record_dispatch(self):
        self.tokens = min(self.tokens + self.ratio, self.burst)

    def try_spend(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def snapshot(self) -> Dict[str, float]:
        return {"ratio": self.ratio, "burst": self.burst,
                "tokens": round(self.tokens, 3)}


class Replica:
    """One fleet member: its URL, the last polled view of it, and its
    rolling dispatch-outcome window (the ejection evidence)."""

    def __init__(self, url: str, stats_window: int = 20):
        self.url = url.rstrip("/")
        self.ready = False
        self.models: List[str] = []          # models the replica serves
        #: per-model admission view: model -> {ewma_s, queue_depth,
        #: active, waiters}
        self.load: Dict[str, Dict[str, float]] = {}
        self.inflight = 0                    # router-side, un-polled yet
        self.dispatched = 0                  # lifetime routed attempts
        self.last_poll_s: Optional[float] = None
        self.consecutive_failures = 0
        # outlier-ejection state
        self.stats = DispatchStats(stats_window)
        self.ejected = False
        self.ejected_until = 0.0             # monotonic; probation opens
        self.eject_backoff_s = 0.0           # current backoff (0 = base)
        self.ejections = 0                   # lifetime ejection count
        self.probe_inflight = False          # the single re-admit probe

    def score(self, model: str) -> float:
        """Expected drain time of one more request on this replica:
        (admission backlog + router-side in-flight) x EWMA service
        seconds. Lower is better. A replica with no admission history
        yet (a fresh joiner) takes only the 1e-4 floor — routing to it
        is how the fleet learns its real EWMA."""
        view = self.load.get(model, {})
        ewma = float(view.get("ewma_s") or 0.0)
        backlog = float(view.get("waiters") or 0.0) + self.inflight
        return (backlog + 1.0) * max(ewma, 1e-4)

    def snapshot(self) -> Dict[str, Any]:
        return {"url": self.url, "ready": self.ready,
                "models": list(self.models),
                "load": {m: dict(v) for m, v in sorted(self.load.items())},
                "inflight": self.inflight,
                "dispatched": self.dispatched,
                "last_poll_s": self.last_poll_s,
                "consecutive_failures": self.consecutive_failures,
                "ejected": self.ejected,
                "ejections": self.ejections,
                "outcomes": self.stats.snapshot()}


def _parse_metrics_json(doc) -> Tuple[Dict[str, Dict[str, float]], int]:
    """``/metrics.json`` -> (model -> admission view, malformed-entry
    count). Tolerates missing families (a replica that has not admitted
    a request yet) and degrades junk entries — non-dict series,
    non-dict labels, unparseable or non-finite values — to neutral 0.0
    while counting them, so a garbage payload can never wedge scoring.
    A payload that is not a JSON object at all raises ValueError."""
    if not isinstance(doc, dict):
        raise ValueError(
            f"/metrics.json answered non-object JSON "
            f"({type(doc).__name__})")
    out: Dict[str, Dict[str, float]] = {}
    malformed = 0
    short = {"dl4j_serving_ewma_service_seconds": "ewma_s",
             "dl4j_serving_queue_depth": "queue_depth",
             "dl4j_serving_active": "active",
             "dl4j_serving_waiters": "waiters"}
    for fam in _POLLED_GAUGES:
        entry = doc.get(fam)
        if entry is None:
            continue
        if not isinstance(entry, dict):
            malformed += 1
            continue
        series_list = entry.get("series", ())
        if not isinstance(series_list, (list, tuple)):
            malformed += 1
            continue
        for series in series_list:
            if not isinstance(series, dict):
                malformed += 1
                continue
            labels = series.get("labels")
            if not isinstance(labels, dict):
                malformed += 1
                continue
            model = labels.get("model")
            if model is None:
                continue
            try:
                value = float(series.get("value") or 0.0)
            except (TypeError, ValueError):
                malformed += 1
                value = 0.0
            if not math.isfinite(value):
                malformed += 1
                value = 0.0
            out.setdefault(str(model), {})[short[fam]] = value
    return out, malformed


class FleetRouter:
    """Least-loaded, readyz-aware, tail-tolerant request router over
    serving replicas.

    ``replicas`` are base URLs (``http://host:port``). Poll cadence,
    failover retries, per-attempt timeout, retry-budget ratio, hedge
    percentile, and brownout fraction default to the
    ``DL4J_TPU_FLEET_*`` env knobs; the ejection thresholds and
    ``affinity_vnodes`` (virtual nodes per replica on the session ring)
    are constructor-only (they are operator tuning, not deployment
    config).
    ``start_polling()`` runs the background refresh; tests can drive
    ``poll_once()`` directly."""

    def __init__(self, replicas: Sequence[str] = (), *,
                 poll_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 retry_budget: Optional[float] = None,
                 retry_burst: Optional[float] = None,
                 hedge_pctl: Optional[float] = None,
                 hedge_min_samples: int = 8,
                 brownout_frac: Optional[float] = None,
                 eject_window: int = 20,
                 eject_min_samples: int = 8,
                 eject_error_rate: float = 0.5,
                 eject_latency_z: float = 3.0,
                 eject_backoff_s: float = 5.0,
                 eject_max_backoff_s: float = 60.0,
                 eject_max_frac: float = 0.5,
                 affinity_vnodes: int = 64):
        env = environment()
        self.poll_s = env.fleet_poll_s() if poll_s is None else float(poll_s)
        self.retries = env.fleet_retries() if retries is None \
            else max(int(retries), 0)
        self.timeout_s = env.fleet_timeout_s() if timeout_s is None \
            else float(timeout_s)
        self.hedge_pctl = env.fleet_hedge_pctl() if hedge_pctl is None \
            else min(float(hedge_pctl), 100.0)
        self.hedge_min_samples = max(int(hedge_min_samples), 2)
        self.brownout_frac = env.fleet_brownout_frac() \
            if brownout_frac is None else min(max(float(brownout_frac),
                                                  0.0), 1.0)
        self.default_priority = env.fleet_default_priority()
        self.eject_window = max(int(eject_window), 1)
        self.eject_min_samples = max(int(eject_min_samples), 1)
        self.eject_error_rate = float(eject_error_rate)
        self.eject_latency_z = float(eject_latency_z)
        self.eject_backoff_s = max(float(eject_backoff_s), 0.01)
        self.eject_max_backoff_s = max(float(eject_max_backoff_s),
                                       self.eject_backoff_s)
        self.eject_max_frac = min(max(float(eject_max_frac), 0.0), 1.0)
        self._budget = RetryBudget(
            env.fleet_retry_budget() if retry_budget is None
            else retry_budget, retry_burst)
        #: fleet metrics aggregation rides the poll loop: every
        #: /metrics.json the poller fetches is folded into this
        self.aggregator = FleetAggregator()
        self._lock = ordered_lock("fleet.router")
        self._replicas: Dict[str, Replica] = {}
        self.affinity_vnodes = max(int(affinity_vnodes), 1)
        #: consistent-hash ring for session affinity: sorted
        #: ``(hash, url)`` vnode entries, rebuilt on membership change
        self._ring: List[Tuple[int, str]] = []
        #: per-model recent winner latencies (the hedge-delay basis)
        self._latencies: Dict[str, "list[float]"] = {}
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = metrics_registry()
        self._m_replicas = reg.gauge(
            "dl4j_fleet_replicas",
            "Ready replicas currently serving each model",
            labels=("model",))
        self._m_dispatch = reg.counter(
            "dl4j_router_dispatch_total",
            "Routed dispatch attempts by replica and outcome (ok|"
            "failover|failed|passthrough|abandoned|no_replica)",
            labels=("replica", "outcome"))
        self._m_hedges = reg.counter(
            "dl4j_fleet_hedges_total",
            "Hedged second attempts by outcome "
            "(launched|won|suppressed)",
            labels=("model", "outcome"))
        self._m_tokens = reg.gauge(
            "dl4j_fleet_retry_tokens",
            "Retry-budget tokens currently available to failovers "
            "and hedges")
        self._m_denials = reg.counter(
            "dl4j_fleet_budget_denials_total",
            "Extra dispatches refused by the retry budget (reason "
            "retry|hedge)",
            labels=("reason",))
        self._m_ejections = reg.counter(
            "dl4j_fleet_ejections_total",
            "Replica ejections by reason "
            "(error_rate|latency|probe_failed)",
            labels=("replica", "reason"))
        self._m_readmissions = reg.counter(
            "dl4j_fleet_readmissions_total",
            "Replicas re-admitted after a successful probe request",
            labels=("replica",))
        self._m_ejected = reg.gauge(
            "dl4j_fleet_ejected",
            "Replicas currently ejected from rotation")
        self._m_poll_errors = reg.counter(
            "dl4j_fleet_poll_errors_total",
            "Replica polls that failed or carried malformed payloads "
            "(reason unreachable|malformed)",
            labels=("replica", "reason"))
        self._m_shed = reg.counter(
            "dl4j_fleet_shed_total",
            "Requests shed by the brownout front door, by priority",
            labels=("model", "priority"))
        self._m_brownout = reg.gauge(
            "dl4j_fleet_brownout",
            "1 while the fleet front door is in brownout")
        self._m_ready_frac = reg.gauge(
            "dl4j_fleet_ready_fraction",
            "Fraction of known replicas ready and not ejected")
        self._m_affinity = reg.counter(
            "dl4j_fleet_affinity_total",
            "Session-affine routing decisions: hit = dispatched to the "
            "ring owner, fallback = owner unusable, degraded to "
            "least-loaded",
            labels=("outcome",))
        self._m_tokens.set(self._budget.tokens)
        for url in replicas:
            self.add_replica(url, poll=False)

    # -- membership -------------------------------------------------------
    def add_replica(self, url: str, *, poll: bool = True) -> Replica:
        """Register one replica. It takes traffic only once a poll sees
        its ``/readyz`` true — safe to call while the replica is still
        warming its bucket ladder from the shared manifest."""
        rep = Replica(url, stats_window=self.eject_window)
        with self._lock:
            existing = self._replicas.get(rep.url)
            if existing is not None:
                return existing
            self._replicas[rep.url] = rep
            self._rebuild_ring_locked()
        if poll:
            self._poll_replica(rep)
            self._update_fleet_gauge()
        return rep

    def remove_replica(self, url: str) -> bool:
        with self._lock:
            gone = self._replicas.pop(url.rstrip("/"), None) is not None
            if gone:
                self._rebuild_ring_locked()
        if gone:
            self.aggregator.forget(url)
            self._update_fleet_gauge()
        return gone

    def _rebuild_ring_locked(self):
        """Recompute the consistent-hash ring from current membership.
        Caller holds the lock. ``affinity_vnodes`` virtual nodes per
        replica keep the key space evenly spread and bound remap churn
        on membership change to ~1/N of sessions."""
        ring: List[Tuple[int, str]] = []
        for url in self._replicas:
            for v in range(self.affinity_vnodes):
                ring.append((zlib.crc32(f"{url}#{v}".encode()), url))
        ring.sort()
        self._ring = ring

    @staticmethod
    def session_hash(session_key: str) -> int:
        return zlib.crc32(session_key.encode())

    def affine_url(self, session_key: str) -> Optional[str]:
        """The ring owner for ``session_key`` — health-blind; routing
        applies the usability checks on top. Exposed for tests and the
        ``/fleet`` debug view."""
        h = self.session_hash(session_key)
        with self._lock:
            ring = self._ring
            if not ring:
                return None
            idx = bisect.bisect_left(ring, (h, ""))
            return ring[idx % len(ring)][1]

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def snapshot(self) -> Dict[str, Any]:
        """``/fleet`` debug view: every replica's polled state plus the
        budget and brownout posture."""
        with self._lock:
            budget = self._budget.snapshot()
        return {"poll_s": self.poll_s, "retries": self.retries,
                "budget": budget,
                "brownout": self.brownout_state(),
                "affinity": {"vnodes": self.affinity_vnodes,
                             "ring_size": len(self._ring)},
                "replicas": [r.snapshot() for r in self.replicas()]}

    # -- polling ----------------------------------------------------------
    def _fetch_json(self, url: str, timeout: float):
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")

    def _poll_replica(self, rep: Replica):
        timeout = min(self.timeout_s, max(self.poll_s * 2, 1.0))
        try:
            if faults.active():
                faults.check("fleet.poll", url=rep.url)
            try:
                status, ready_doc = self._fetch_json(
                    rep.url + "/readyz", timeout)
            except urllib.error.HTTPError as e:
                # /readyz answers 503 with the same JSON body when unready
                status, ready_doc = e.code, json.loads(e.read() or b"{}")
            _, metrics_doc = self._fetch_json(
                rep.url + "/metrics.json", timeout)
            if not isinstance(ready_doc, dict):
                raise ValueError(
                    f"/readyz answered non-object JSON "
                    f"({type(ready_doc).__name__})")
        except (OSError, ValueError, faults.InjectedFault) as e:
            with self._lock:
                rep.ready = False
                rep.consecutive_failures += 1
                rep.last_poll_s = time.time()
            self._m_poll_errors.labels(replica=rep.url,
                                       reason="unreachable").inc()
            log.debug("poll of %s failed: %r", rep.url, e)
            return
        # the replica is reachable and its readiness is known; a junk
        # /metrics.json only costs it its load view (neutral score),
        # never its place in rotation
        try:
            load, malformed = _parse_metrics_json(metrics_doc)
        except ValueError as e:
            load, malformed = {}, 1
            log.debug("junk /metrics.json from %s: %r", rep.url, e)
        self.aggregator.ingest(rep.url, metrics_doc)
        if malformed:
            self._m_poll_errors.labels(replica=rep.url,
                                       reason="malformed").inc()
        models = ready_doc.get("models")
        with self._lock:
            rep.ready = status == 200 and bool(ready_doc.get("ready"))
            rep.models = sorted(models.keys()) \
                if isinstance(models, dict) else []
            rep.load = load
            rep.consecutive_failures = 0
            rep.last_poll_s = time.time()

    def poll_once(self):
        """One synchronous refresh of every replica (tests; the poll
        thread spreads the same work across the period instead)."""
        for rep in self.replicas():
            self._poll_replica(rep)
        self._update_fleet_gauge()

    def poll_offset(self, url: str) -> float:
        """Deterministic per-replica phase within the poll period,
        ``[0, poll_s)``: each replica's first scheduled poll is delayed
        by this much so N replicas spread over the window instead of
        being probed in one thundering-herd tick (and, fleet-wide, N
        routers hash the same replica to the same phase rather than all
        re-synchronizing on their own start times). Hash, not index, so
        an offset never changes as membership churns."""
        return (zlib.crc32(url.rstrip("/").encode("utf-8")) % 9973) \
            / 9973.0 * self.poll_s

    def _update_fleet_gauge(self):
        counts: Dict[str, int] = {}
        with self._lock:
            reps = list(self._replicas.values())
            ejected = sum(1 for r in reps if r.ejected)
            for rep in reps:
                if not rep.ready or rep.ejected:
                    continue
                for model in rep.models:
                    counts[model] = counts.get(model, 0) + 1
            known = set()
            for rep in reps:
                known.update(rep.models)
        for model in known:
            self._m_replicas.labels(model=model).set(counts.get(model, 0))
        self._m_ejected.set(ejected)

    def start_polling(self) -> "FleetRouter":
        if self._poll_thread is not None:
            return self
        self._stop.clear()

        def loop():
            # each replica keeps its own next-poll deadline, first seen
            # at now + poll_offset(url): distinct phases per replica,
            # full poll_s cadence each thereafter
            due: Dict[str, float] = {}
            while not self._stop.is_set():
                now = time.monotonic()
                polled = False
                for rep in self.replicas():
                    when = due.get(rep.url)
                    if when is None:
                        when = now + self.poll_offset(rep.url)
                        due[rep.url] = when
                    if when > now:
                        continue
                    try:
                        self._poll_replica(rep)
                    except Exception:
                        log.exception("fleet poll of %s failed", rep.url)
                    due[rep.url] = now + self.poll_s
                    polled = True
                if polled:
                    self._update_fleet_gauge()
                with self._lock:
                    live = set(self._replicas)
                for url in list(due):
                    if url not in live:
                        del due[url]
                now = time.monotonic()
                next_due = min(due.values(), default=now + self.poll_s)
                self._stop.wait(max(min(next_due - now, self.poll_s), 0.01))

        self._poll_thread = threading.Thread(
            target=loop, name="dl4j-torch-fleet-poll", daemon=True)
        self._poll_thread.start()
        return self

    def stop_polling(self):
        self._stop.set()
        t = self._poll_thread
        if t is not None:
            t.join(timeout=max(self.poll_s * 2, 2.0))
            self._poll_thread = None

    # -- hedge-delay basis ------------------------------------------------
    def _note_latency(self, model: str, latency_s: float):
        with self._lock:
            samples = self._latencies.setdefault(model, [])
            samples.append(latency_s)
            if len(samples) > 64:
                del samples[:len(samples) - 64]

    def _hedge_delay(self, model: Optional[str]) -> Optional[float]:
        """The per-model hedge delay: the ``hedge_pctl`` percentile of
        observed winner latencies. None (no hedging) until enough
        samples exist or when hedging is disabled."""
        if model is None or self.hedge_pctl <= 0:
            return None
        with self._lock:
            samples = sorted(self._latencies.get(model, ()))
        if len(samples) < self.hedge_min_samples:
            return None
        idx = min(len(samples) - 1,
                  max(0, math.ceil(self.hedge_pctl / 100.0
                                   * len(samples)) - 1))
        return max(samples[idx], 0.001)

    # -- outlier ejection -------------------------------------------------
    def _settle_attempt(self, rep: Replica, *, ok: bool,
                        latency_s: Optional[float], probe: bool):
        """Book one finished dispatch attempt against the replica's
        rolling outcome window; resolve a probe; evaluate ejection.
        Metric writes happen after the lock drops."""
        events: List[Tuple[str, str]] = []
        with self._lock:
            rep.inflight = max(rep.inflight - 1, 0)
            rep.stats.record(ok, latency_s)
            if probe:
                rep.probe_inflight = False
                if ok:
                    rep.ejected = False
                    rep.eject_backoff_s = 0.0
                    rep.stats.reset()
                    events.append(("readmitted", ""))
                else:
                    self._eject_locked(rep, "probe_failed")
                    events.append(("ejected", "probe_failed"))
            elif not rep.ejected:
                reason = self._eject_reason_locked(rep)
                if reason is not None:
                    self._eject_locked(rep, reason)
                    events.append(("ejected", reason))
        for what, reason in events:
            if what == "readmitted":
                self._m_readmissions.labels(replica=rep.url).inc()
                log.info("replica %s re-admitted after probe", rep.url)
            else:
                self._m_ejections.labels(replica=rep.url,
                                         reason=reason).inc()
                log.warning("replica %s ejected (%s), backoff %.2fs",
                            rep.url, reason, rep.eject_backoff_s)
        if events:
            self._update_fleet_gauge()

    def _eject_reason_locked(self, rep: Replica) -> Optional[str]:
        """Why ``rep`` should be ejected right now, or None. Caller
        holds the lock. Honors the max-ejection fraction: the router
        must never eject itself to zero."""
        if len(rep.stats) < self.eject_min_samples:
            return None
        reason = None
        if rep.stats.error_rate() >= self.eject_error_rate:
            reason = "error_rate"
        else:
            mean = rep.stats.mean_latency_s()
            if mean is not None:
                peers = [r.stats.mean_latency_s()
                         for r in self._replicas.values()
                         if r is not rep and not r.ejected
                         and len(r.stats) >= self.eject_min_samples]
                if latency_zscore(mean, peers) >= self.eject_latency_z:
                    reason = "latency"
        if reason is None:
            return None
        total = len(self._replicas)
        already = sum(1 for r in self._replicas.values() if r.ejected)
        if total and (already + 1) / total > self.eject_max_frac:
            log.warning("replica %s looks like an outlier (%s) but the "
                        "max-ejection fraction %.2f is spent",
                        rep.url, reason, self.eject_max_frac)
            return None
        return reason

    def _eject_locked(self, rep: Replica, reason: str):
        rep.ejected = True
        rep.ejections += 1
        rep.eject_backoff_s = min(
            self.eject_backoff_s if rep.eject_backoff_s <= 0
            else rep.eject_backoff_s * 2.0,
            self.eject_max_backoff_s)
        rep.ejected_until = time.monotonic() + rep.eject_backoff_s

    # -- routing ----------------------------------------------------------
    def _candidates(self, model: Optional[str]) -> List[Replica]:
        """READY, non-ejected replicas (serving ``model``, when known),
        best score first."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.ready and not r.ejected]
        if model is not None:
            serving = [r for r in reps if model in r.models]
            # a replica whose model list is unknown yet (no successful
            # poll since deploy) still counts — the attempt will 404
            # and surface the truth
            reps = serving or reps
        if model is not None:
            # dispatched count breaks score ties: equally loaded
            # replicas round-robin instead of piling onto the first
            reps.sort(key=lambda r: (r.score(model), r.dispatched, r.url))
        return reps

    def _affine_replica(self, model: Optional[str],
                        session_key: str) -> Optional[Replica]:
        """The ring owner for ``session_key`` iff it is usable right
        now: ready, not ejected, serving ``model`` (an unknown model
        list still counts, mirroring ``_candidates``), and the fleet
        not browned out — a browned-out fleet routes for capacity, not
        cache locality. None means: degrade to least-loaded."""
        if self.brownout_state()["active"]:
            return None
        url = self.affine_url(session_key)
        if url is None:
            return None
        with self._lock:
            rep = self._replicas.get(url)
            if rep is None or not rep.ready or rep.ejected:
                return None
            if model is not None and rep.models and model not in rep.models:
                return None
            return rep

    def _pick(self, model: Optional[str], exclude: Sequence[str],
              strict: bool = False) -> Tuple[Optional[Replica], bool]:
        """Next replica for an attempt, ``(replica, is_probe)``. An
        ejected replica whose backoff expired gets exactly one probe
        request — this one. When nothing scores as routable, panic
        open: any known non-ejected replica beats failing the request
        outright (the attempt will surface the truth), and — unless
        ``strict`` — a failover may even re-try an already-tried
        replica as a last resort (a transient connect fault draws
        independently on the second attempt). Hedges are ``strict``:
        a hedge on the same replica measures nothing."""
        now = time.monotonic()
        with self._lock:
            probe = next(
                (r for r in self._replicas.values()
                 if r.ejected and not r.probe_inflight
                 and now >= r.ejected_until and r.url not in exclude),
                None)
            if probe is not None:
                probe.probe_inflight = True
                return probe, True
        rep = next((r for r in self._candidates(model)
                    if r.url not in exclude), None)
        if rep is not None:
            return rep, False
        with self._lock:
            panic = [r for r in self._replicas.values()
                     if not r.ejected and r.url not in exclude]
            if not panic and not strict:
                panic = [r for r in self._replicas.values()
                         if not r.ejected]
        panic.sort(key=lambda r: (r.consecutive_failures, r.dispatched,
                                  r.url))
        return (panic[0] if panic else None), False

    def _do_http(self, rep: Replica, method: str, path: str,
                 body: Optional[bytes], headers: Sequence[Tuple[str, str]],
                 timeout: float, model: Optional[str]):
        """One HTTP attempt. Returns ``(kind, payload)``:
        ``("response", (status, hdrs, body))``, ``("conn_error", exc)``
        (nothing consumed — retryable), or
        ``("mid_stream", (hdrs, exc))`` (response body partially
        consumed — retryable only for idempotent requests)."""
        resp = None
        try:
            if faults.active():
                faults.check("fleet.dispatch", url=rep.url, model=model,
                             phase="connect")
            req = urllib.request.Request(
                rep.url + path, data=body, method=method,
                headers=dict(headers))
            try:
                resp = urllib.request.urlopen(req, timeout=timeout)
                status = resp.status
            except urllib.error.HTTPError as e:
                resp, status = e, e.code
            hdrs = dict(resp.headers)
        except (OSError, urllib.error.URLError, faults.InjectedFault) as e:
            return "conn_error", e
        try:
            if faults.active():
                faults.check("fleet.dispatch", url=rep.url, model=model,
                             phase="body")
            payload = resp.read()
        except (OSError, faults.InjectedFault) as e:
            return "mid_stream", (hdrs, e)
        finally:
            try:
                resp.close()
            except Exception:
                pass
        return "response", (status, hdrs, payload)

    def _attempt(self, rep: Replica, method: str, path: str,
                 body: Optional[bytes], headers: Sequence[Tuple[str, str]],
                 timeout: float, model: Optional[str], meta: Dict[str, Any],
                 resq: "queue.Queue", race: Dict[str, bool],
                 race_lock: threading.Lock):
        kind, res = self._do_http(rep, method, path, body, headers,
                                  timeout, model)
        with race_lock:
            if not race["done"]:
                resq.put((rep, kind, res, meta))
                return
        # the race already settled while this attempt was in flight:
        # the loser accounts for itself
        self._account_abandoned(rep, kind, res, meta)

    def _record_attempt(self, rep: Replica, meta: Dict[str, Any],
                        outcome: str):
        """Record this attempt's ``fleet/attempt`` span cross-thread
        into the front door's trace ring, under the request's
        :class:`TraceContext` — with the SAME span id the attempt
        announced downstream in ``traceparent``, so the replica's
        server-side subtree parents under the exact attempt that
        reached it when :meth:`stitched_trace` joins the two rings.
        Runs on whatever thread settles the attempt (the route loop for
        the winner, the attempt worker itself for an abandoned hedge
        loser) — ``record(context=)`` is the cross-thread-safe path."""
        ctx = meta.get("ctx")
        if ctx is None:
            return
        tracer().record("fleet/attempt", meta.get("pt0", 0.0),
                        time.perf_counter(), context=ctx,
                        span_id=meta.get("span_id"), replica=rep.url,
                        kind=meta.get("kind", ""), outcome=outcome)

    def _account_abandoned(self, rep: Replica, kind: str, res,
                           meta: Dict[str, Any]):
        latency = time.monotonic() - meta["t0"]
        ok = kind == "response" and res[0] != 503
        self._settle_attempt(rep, ok=ok,
                             latency_s=latency if ok else None,
                             probe=meta["probe"])
        if not ok:
            why = "503" if kind == "response" else kind
            self._note_replica_failure(rep, why)
        self._record_attempt(rep, meta, "abandoned")
        self._m_dispatch.labels(replica=rep.url, outcome="abandoned").inc()

    def _note_replica_failure(self, rep: Replica, why: str):
        with self._lock:
            rep.ready = False
            rep.consecutive_failures += 1
        log.warning("replica %s failed (%s)", rep.url, why)
        self._update_fleet_gauge()

    def route(self, method: str, path: str, body: Optional[bytes] = None,
              headers: Sequence[Tuple[str, str]] = (),
              model: Optional[str] = None,
              timeout_s: Optional[float] = None,
              idempotent: Optional[bool] = None,
              session_key: Optional[str] = None
              ) -> Tuple[int, Dict[str, str], bytes, str]:
        """Route one HTTP request to the best replica with budgeted
        failover and (for idempotent requests) a budgeted hedge.
        Returns ``(status, headers, body, replica_url)``. A 503 that
        cannot be retried is returned as-is (``Retry-After``
        preserved); :class:`NoReplicaError` is raised only when no
        replica produced an HTTP answer at all; a mid-stream failure on
        a non-idempotent request raises :class:`MidStreamError` instead
        of retrying. ``idempotent`` defaults from the path: generate is
        not, everything else is. ``session_key`` requests prefix-cache
        affinity: the first attempt goes to the key's consistent-hash
        ring owner when that replica is usable
        (``dl4j_fleet_affinity_total{outcome="hit"}``), else — or on
        failover after the affine attempt fails — the normal
        least-loaded pick applies (``outcome="fallback"``)."""
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        if idempotent is None:
            idempotent = not path.split("?", 1)[0].endswith("/generate")
        # the request's trace context: the client's traceparent when one
        # arrived, else a fresh root minted here — either way every
        # attempt records a fleet/attempt span under it, and forwards
        # its OWN span id downstream so the replica's subtree nests
        ctx = context_from_traceparent(
            next((v for k, v in headers
                  if str(k).lower() == "traceparent"), None))
        base_headers = [(k, v) for k, v in headers
                        if str(k).lower() not in ("traceparent",
                                                  "x-fleet-replica",
                                                  "x-fleet-attempt")]
        resq: "queue.Queue" = queue.Queue()
        race = {"done": False}
        race_lock = threading.Lock()
        tried: List[str] = []
        inflight = 0
        failovers = 0
        hedged = False
        hedge_blocked = not idempotent
        first_kind = "primary"
        last_503: Optional[Tuple[int, Dict[str, str], bytes, str]] = None
        last_err: Optional[BaseException] = None

        def start(rep: Replica, probe: bool, hedge: bool):
            nonlocal inflight
            kind = "hedge" if hedge else ("retry" if tried else first_kind)
            tried.append(rep.url)
            with self._lock:
                rep.inflight += 1
                rep.dispatched += 1
            sid = new_span_id()
            hdrs = list(base_headers)
            hdrs.append(("traceparent", format_traceparent(
                TraceContext(ctx.trace_id, sid))))
            hdrs.append(("X-Fleet-Replica", rep.url))
            hdrs.append(("X-Fleet-Attempt", kind))
            meta = {"probe": probe, "hedge": hedge, "t0": time.monotonic(),
                    "pt0": time.perf_counter(), "ctx": ctx,
                    "span_id": sid, "kind": kind}
            threading.Thread(
                target=self._attempt,
                args=(rep, method, path, body, hdrs, timeout, model,
                      meta, resq, race, race_lock),
                name="dl4j-torch-fleet-attempt", daemon=True).start()
            inflight += 1

        def finish():
            with race_lock:
                race["done"] = True
            # drain results that were queued before the race settled
            while True:
                try:
                    orep, okind, ores, ometa = resq.get_nowait()
                except queue.Empty:
                    return
                self._account_abandoned(orep, okind, ores, ometa)

        rep, probe = None, False
        if session_key is not None:
            rep = self._affine_replica(model, session_key)
            self._m_affinity.labels(
                outcome="hit" if rep is not None else "fallback").inc()
            if rep is None:
                first_kind = "affinity_fallback"
        if rep is None:
            rep, probe = self._pick(model, tried)
        if rep is None:
            self._m_dispatch.labels(replica="", outcome="no_replica").inc()
            raise NoReplicaError(
                "no ready replica"
                + (f" for model '{model}'" if model else ""))
        with self._lock:
            self._budget.record_dispatch()
            tokens = self._budget.tokens
        self._m_tokens.set(tokens)
        start(rep, probe, hedge=False)
        hedge_delay = self._hedge_delay(model) if idempotent else None
        hedge_at = None if hedge_delay is None \
            else time.monotonic() + hedge_delay

        while inflight:
            wait = None
            if hedge_at is not None and not hedged and not hedge_blocked \
                    and inflight == 1:
                wait = max(hedge_at - time.monotonic(), 0.0)
            try:
                rep, kind, res, meta = resq.get(timeout=wait)
            except queue.Empty:
                # hedge timer fired with the primary still unanswered
                cand, cprobe = self._pick(model, tried, strict=True)
                if cand is None:
                    hedge_blocked = True
                    continue
                with self._lock:
                    granted = self._budget.try_spend()
                    tokens = self._budget.tokens
                    if not granted and cprobe:
                        cand.probe_inflight = False  # return the slot
                self._m_tokens.set(tokens)
                if not granted:
                    hedge_blocked = True
                    self._m_denials.labels(reason="hedge").inc()
                    self._m_hedges.labels(model=model or "",
                                          outcome="suppressed").inc()
                    continue
                hedged = True
                self._m_hedges.labels(model=model or "",
                                      outcome="launched").inc()
                start(cand, cprobe, hedge=True)
                continue
            inflight -= 1
            latency = time.monotonic() - meta["t0"]

            if kind == "response":
                status, hdrs, payload = res
                if status != 503:
                    # the replica's answer — the race winner
                    self._settle_attempt(
                        rep, ok=True,
                        latency_s=latency if status < 300 else None,
                        probe=meta["probe"])
                    if status < 300 and model is not None:
                        self._note_latency(model, latency)
                    self._record_attempt(rep, meta, "ok")
                    finish()
                    self._m_dispatch.labels(replica=rep.url,
                                            outcome="ok").inc()
                    if meta["hedge"]:
                        self._m_hedges.labels(model=model or "",
                                              outcome="won").inc()
                    return status, hdrs, payload, rep.url
                # 503 is replica-level (draining / breaker / unready):
                # keep its Retry-After in hand for pass-through
                last_503 = (status, hdrs, payload, rep.url)
                last_err = None
                self._settle_attempt(rep, ok=False, latency_s=None,
                                     probe=meta["probe"])
                self._note_replica_failure(rep, "503")
                self._record_attempt(rep, meta, "503")
            elif kind == "mid_stream":
                hdrs, err = res
                self._settle_attempt(rep, ok=False, latency_s=None,
                                     probe=meta["probe"])
                self._note_replica_failure(rep, "mid_stream")
                self._record_attempt(rep, meta, "mid_stream")
                if not idempotent:
                    # the response body started; a retry could run the
                    # generation twice — surface instead
                    finish()
                    self._m_dispatch.labels(replica=rep.url,
                                            outcome="failed").inc()
                    raise MidStreamError(
                        rep.url,
                        trace_id=hdrs.get("X-Trace-Id")
                        or hdrs.get("x-trace-id"),
                        cause=err)
                last_err = err
            else:  # conn_error: nothing reached the replica's handler
                last_err = res
                self._settle_attempt(rep, ok=False, latency_s=None,
                                     probe=meta["probe"])
                self._note_replica_failure(rep, "connect")
                self._record_attempt(rep, meta, "conn_error")

            # a sibling attempt may still win the race
            if inflight:
                self._m_dispatch.labels(replica=rep.url,
                                        outcome="failover").inc()
                continue
            # failover, budget and candidates permitting
            if failovers < self.retries:
                cand, cprobe = self._pick(model, tried)
                if cand is not None:
                    with self._lock:
                        granted = self._budget.try_spend()
                        tokens = self._budget.tokens
                        if not granted and cprobe:
                            cand.probe_inflight = False  # return the slot
                    self._m_tokens.set(tokens)
                    if granted:
                        failovers += 1
                        self._m_dispatch.labels(replica=rep.url,
                                                outcome="failover").inc()
                        start(cand, cprobe, hedge=False)
                        continue
                    self._m_denials.labels(reason="retry").inc()
            # terminal: no retry possible for this failed attempt
            finish()
            if last_503 is not None:
                # degrade to pass-through: the replica's own 503 (with
                # its Retry-After) beats a synthesized error
                self._m_dispatch.labels(
                    replica=rep.url,
                    outcome="passthrough" if kind == "response"
                    else "failed").inc()
                return last_503
            self._m_dispatch.labels(replica=rep.url,
                                    outcome="failed").inc()
            raise NoReplicaError(
                f"all routed attempts failed (tried {tried})"
                + (f": {last_err!r}" if last_err else ""))
        raise NoReplicaError(  # pragma: no cover — loop always resolves
            f"all routed attempts failed (tried {tried})")

    # -- brownout ---------------------------------------------------------
    def brownout_state(self) -> Dict[str, Any]:
        """The front door's degradation posture. Brownout turns on when
        the fraction of known replicas that are ready and not ejected
        drops below ``brownout_frac``; the priority cutoff and the
        forwarded-deadline scale both deepen with the capacity
        deficit."""
        with self._lock:
            reps = list(self._replicas.values())
        known = len(reps)
        ready = sum(1 for r in reps if r.ready and not r.ejected)
        frac = (ready / known) if known else 0.0
        limit = self.brownout_frac
        active = limit > 0 and frac < limit
        if active:
            ratio = frac / limit                      # [0, 1)
            cutoff = min(math.ceil(10.0 * (1.0 - ratio)), 10)
            timeout_scale = max(ratio, 0.25)
        else:
            cutoff = 0
            timeout_scale = 1.0
        self._m_brownout.set(1.0 if active else 0.0)
        self._m_ready_frac.set(frac)
        return {"active": active, "ready_fraction": round(frac, 4),
                "cutoff": cutoff, "timeout_scale": round(timeout_scale, 4),
                "retry_after_s": max(int(math.ceil(self.poll_s)), 1),
                "default_priority": self.default_priority}

    def count_shed(self, model: Optional[str], priority: int):
        self._m_shed.labels(model=model or "",
                            priority=str(priority)).inc()

    # -- cross-replica trace stitching ------------------------------------
    def stitched_trace(self, trace_id: str) -> Dict[str, Any]:
        """One cross-process span tree for ``trace_id``: the front
        door's own ``fleet/attempt`` spans plus every involved
        replica's ``/debug/trace/<id>`` events, nested by span ids.
        Each attempt forwarded its OWN span id downstream in
        ``traceparent``, so a replica's server-side
        ``serving/request`` → admission → dispatch subtree hangs under
        the exact attempt that reached it — a hedged request renders as
        ONE trace with both attempts and the winner's full subtree.
        Replicas named by local attempt spans are asked first; with no
        local evidence (ring rolled over, or another front door served
        the request) every known replica is asked. An unreachable
        replica just contributes nothing — stitching is best-effort."""
        trc = tracer()
        local = [e for e in trc.events_for(trace_id)
                 if isinstance(e.get("args"), dict)]
        urls = sorted({e["args"].get("replica") for e in local
                       if e.get("name") == "fleet/attempt"
                       and e["args"].get("replica")})
        if not urls:
            urls = sorted(r.url for r in self.replicas())
        events = list(local)
        stitched_from: List[str] = []
        timeout = min(self.timeout_s, max(self.poll_s * 2, 1.0))
        for url in urls:
            try:
                _, doc = self._fetch_json(
                    url + "/debug/trace/" + trace_id, timeout)
            except (OSError, ValueError):
                continue
            remote = doc.get("events") if isinstance(doc, dict) else None
            if isinstance(remote, list) and remote:
                stitched_from.append(url)
                events.extend(e for e in remote if isinstance(e, dict))
        # dedup by span id: an in-process fleet (tests, benches) shares
        # one tracer ring, so the "remote" fetch returns spans the local
        # scan already collected — one node per span keeps the tree sane
        seen: set = set()
        deduped = []
        for e in events:
            sid = e.get("args", {}).get("span_id") \
                if isinstance(e.get("args"), dict) else None
            if sid is not None:
                if sid in seen:
                    continue
                seen.add(sid)
            deduped.append(e)
        events = deduped
        return {"trace_id": trace_id, "count": len(events),
                "replicas": stitched_from, "tree": span_tree(events),
                "events": events}

    # -- autoscaler signal feed -------------------------------------------
    def fleet_signals(self) -> Dict[str, Any]:
        """``GET /fleet/signals``: the aggregator's latest per-replica
        autoscaling signals joined with the router's own membership
        view (ready/ejected/inflight) and brownout posture, plus the
        fleet rollup — the documented feed for an SLO-driven
        autoscaler."""
        with self._lock:
            state = {r.url: {"ready": r.ready, "ejected": r.ejected,
                             "inflight": r.inflight,
                             "models": list(r.models)}
                     for r in self._replicas.values()}
        return self.aggregator.signals(replica_state=state,
                                       brownout=self.brownout_state())

    # -- convenience client API -------------------------------------------
    def predict(self, model: str, inputs, *,
                timeout_s: Optional[float] = None,
                session_key: Optional[str] = None) -> dict:
        """JSON predict against the least-loaded replica; returns the
        parsed response body. Non-2xx answers raise RuntimeError with
        the replica's error payload."""
        body = json.dumps({"inputs": inputs if isinstance(inputs, (dict,
                           list)) else inputs.tolist()}).encode()
        status, _, payload, url = self.route(
            "POST", f"/v1/models/{model}/predict", body,
            headers=[("Content-Type", "application/json")],
            model=model, timeout_s=timeout_s, idempotent=True,
            session_key=session_key)
        doc = json.loads(payload or b"{}")
        if status != 200:
            raise RuntimeError(
                f"predict on {url} answered {status}: {doc.get('error')}")
        return doc

    def generate(self, model: str, prompt: Sequence[int], *,
                 timeout_s: Optional[float] = None,
                 session_key: Optional[str] = None, **opts) -> dict:
        """Generate with optional session affinity: pass the same
        ``session_key`` on every turn of a chat session and follow-up
        turns land on the replica whose prefix cache holds the
        session's KV blocks. Omitted, the key defaults to a
        fingerprint of the prompt's leading tokens, which pins shared
        system-prompt storms the same way."""
        if session_key is None:
            session_key = prompt_fingerprint(model, prompt)
        body = json.dumps({"prompt": list(prompt), **opts}).encode()
        status, _, payload, url = self.route(
            "POST", f"/v1/models/{model}/generate", body,
            headers=[("Content-Type", "application/json")],
            model=model, timeout_s=timeout_s, idempotent=False,
            session_key=session_key)
        doc = json.loads(payload or b"{}")
        if status != 200:
            raise RuntimeError(
                f"generate on {url} answered {status}: {doc.get('error')}")
        return doc


_MODEL_PATH_RE = re.compile(r"^/v1/models/([^/:]+)(?::[^/]+)?/")

#: how many leading prompt tokens the fallback session fingerprint
#: covers — enough to separate distinct system prompts, short enough
#: that every turn of a growing session keeps hashing the same head
_FINGERPRINT_TOKENS = 32

#: request headers the front door forwards to the replica (trace context,
#: deadlines, priority, and the session key must survive the hop;
#: hop-by-hop headers must not)
_FORWARDED_HEADERS = ("content-type", "traceparent", "x-request-timeout-s",
                      "x-priority", "x-session-id")


def prompt_fingerprint(model: Optional[str],
                       prompt: Sequence[int]) -> str:
    """Session key derived from a prompt's leading tokens: requests
    sharing a system prompt (or earlier turns of the same session)
    hash identically and therefore pin to the same replica."""
    head = ",".join(str(int(t)) for t in list(prompt)[:_FINGERPRINT_TOKENS])
    digest = hashlib.sha1(f"{model or ''}|{head}".encode()).hexdigest()
    return f"pfx:{digest}"


def _parse_priority(raw: Optional[str], default: int) -> int:
    if raw is None:
        return default
    try:
        return min(max(int(str(raw).strip()), 0), 9)
    except ValueError:
        return default


class FleetServer:
    """HTTP front door over a :class:`FleetRouter`: the one URL clients
    talk to. ``POST /v1/models/...`` proxies to the least-loaded ready
    replica (with budgeted failover + hedging); ``GET /v1/models``
    answers from the best replica; ``/readyz`` is the *fleet's*
    readiness (any replica ready) plus its brownout posture; ``/fleet``
    is the router's polled membership + budget view; ``/metrics`` +
    ``/metrics.json`` serve the router process's own registry (dispatch
    counters + fleet gauges) COMBINED with the aggregated replica
    registries — per-replica series carry a ``replica`` label, merged
    series none (see :mod:`.aggregator`); ``/fleet/signals`` is the
    distilled autoscaler feed; ``/debug/trace/<id>`` (debug-gated like
    every ``/debug/*``) answers the cross-replica stitched span tree.

    During brownout the front door sheds POSTs whose ``X-Priority``
    (0–9, default ``DL4J_TPU_FLEET_DEFAULT_PRIORITY``) falls below the
    capacity-scaled cutoff — 503 with ``Retry-After`` and
    ``X-Fleet-Brownout: 1`` — and tightens the forwarded
    ``X-Request-Timeout-S`` so queued work inside the degraded fleet
    gives up sooner.

    Clients that want prefix-cache locality send ``X-Session-Id`` (any
    stable opaque string per chat session); generates without one are
    keyed by a fingerprint of the prompt's leading tokens. Either way
    the request pins to the session's ring owner when that replica is
    healthy — see :class:`FleetRouter` session affinity."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self.host = host
        self.port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        from ...common.httpserver import QuietThreadingHTTPServer
        self._httpd = QuietThreadingHTTPServer((self.host, self.port),
                                               self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dl4j-torch-fleet-router",
                                        daemon=True)
        self._thread.start()
        self.router.start_polling()
        log.info("fleet router on %s:%d fronting %d replicas",
                 self.host, self.port, len(self.router.replicas()))
        return self.port

    def stop(self):
        self.router.stop_polling()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        return self

    def _handler(self):
        from ...common.httpserver import JsonRequestHandler, debug_enabled
        from ...common.metrics import touch_runtime_info
        from .aggregator import render_prometheus_text
        router = self.router

        class Handler(JsonRequestHandler):
            def _fleet_exposition(self):
                """Front-door registry + aggregated replica registries
                in one /metrics.json-shaped document."""
                return router.aggregator.merged_with(
                    touch_runtime_info().snapshot())

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self.send_payload(b"ok", "text/plain")
                elif path == "/readyz":
                    reps = router.replicas()
                    ready = any(r.ready for r in reps)
                    self.send_json(
                        {"ready": ready,
                         "brownout": router.brownout_state(),
                         "replicas": [{"url": r.url, "ready": r.ready,
                                       "ejected": r.ejected}
                                      for r in reps]},
                        200 if ready else 503)
                elif path == "/fleet":
                    self.send_json(router.snapshot())
                elif path == "/fleet/signals":
                    self.send_json(router.fleet_signals())
                elif path == "/metrics":
                    self.send_payload(
                        render_prometheus_text(
                            self._fleet_exposition()).encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/metrics.json":
                    self.send_payload(
                        json.dumps(self._fleet_exposition()).encode(),
                        "application/json")
                elif path.startswith("/debug/trace/") and debug_enabled():
                    self.send_json(router.stitched_trace(
                        path[len("/debug/trace/"):].strip("/")))
                elif path == "/v1/models":
                    self._proxy("GET", None)
                else:
                    self.send_json({"error": "not found"}, 404)

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                m = _MODEL_PATH_RE.match(path)
                if m is None:
                    self.send_json({"error": "not found"}, 404)
                    return
                self._proxy("POST", m.group(1))

            def _proxy(self, method: str, model: Optional[str]):
                body = self.read_body() if method == "POST" else None
                fwd = [(k, v) for k, v in self.headers.items()
                       if k.lower() in _FORWARDED_HEADERS]
                brown = router.brownout_state()
                if method == "POST" and brown["active"]:
                    prio = _parse_priority(self.headers.get("X-Priority"),
                                           brown["default_priority"])
                    if prio < brown["cutoff"]:
                        router.count_shed(model, prio)
                        self.send_json(
                            {"error": "brownout: fleet capacity at "
                             f"{brown['ready_fraction']:.0%}, shedding "
                             f"priority < {brown['cutoff']}",
                             "priority": prio},
                            503,
                            headers=[("Retry-After",
                                      str(brown["retry_after_s"])),
                                     ("X-Fleet-Brownout", "1")])
                        return
                    # tighten the forwarded deadline: a browned-out
                    # fleet must not queue work it cannot finish
                    base = None
                    for k, v in fwd:
                        if k.lower() == "x-request-timeout-s":
                            try:
                                base = float(v)
                            except ValueError:
                                base = None
                    if base is None:
                        base = environment().serving_default_timeout_s() \
                            or router.timeout_s
                    tightened = max(base * brown["timeout_scale"], 0.1)
                    fwd = [(k, v) for k, v in fwd
                           if k.lower() != "x-request-timeout-s"]
                    fwd.append(("X-Request-Timeout-S",
                                f"{tightened:.3f}"))
                path = self.path.split("?", 1)[0]
                idempotent = not path.endswith("/generate")
                session_key = self.headers.get("X-Session-Id")
                if session_key is None and not idempotent and body:
                    # no explicit session: fingerprint the prompt head
                    # so shared-prefix storms still pin to one replica
                    try:
                        doc = json.loads(body)
                        session_key = prompt_fingerprint(
                            model, doc.get("prompt") or ())
                    except (ValueError, TypeError):
                        session_key = None
                try:
                    status, hdrs, payload, url = router.route(
                        method, self.path, body, headers=fwd, model=model,
                        idempotent=idempotent, session_key=session_key)
                except MidStreamError as e:
                    hh = [("X-Trace-Id", e.trace_id)] if e.trace_id else []
                    self.send_json(
                        {"error": str(e), "trace_id": e.trace_id,
                         "replica": e.replica_url},
                        502, headers=hh)
                    return
                except NoReplicaError as e:
                    self.send_json({"error": str(e)}, 503,
                                   headers=[("Retry-After", "1")])
                    return
                passthrough = [(k, v) for k, v in hdrs.items()
                               if k.lower() in ("x-trace-id",
                                                "x-model-version",
                                                "retry-after")]
                passthrough.append(("X-Fleet-Replica", url))
                self.send_payload(
                    payload,
                    hdrs.get("Content-Type", "application/json"),
                    status, headers=passthrough)

        return Handler
