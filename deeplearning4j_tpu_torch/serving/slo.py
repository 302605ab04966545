"""Per-model SLOs: deadline-hit-rate objectives with multi-window burn
rates.

A copy of the JAX package's ``serving/slo.py`` (the port imports nothing
from that package). Reference: the multi-window, multi-burn-rate alerting policy of the SRE
workbook (ch. 5) and the Dapper/Canopy practice of judging a serving
fleet by its *objective*, not its mean. The serving stack records one
observation per completed request — did it finish OK, within its
deadline (and optional latency objective)? — and this module answers two
questions the raw counters cannot:

1. **How fast is the error budget burning?** ``burn_rate(window)`` =
   observed error rate / allowed error rate (``1 - objective``) over a
   sliding window. A burn rate of 1.0 spends the budget exactly on
   schedule; 14.4 exhausts a 30-day budget in 2 days.
2. **Should this replica stop taking traffic?** ``healthy()`` is False
   only when EVERY configured window burns past its threshold *and* the
   short window holds at least ``min_samples`` observations — the
   standard fast-burn page condition, conservative enough that a single
   unlucky request never flips ``/readyz`` (which
   ``serving.server.ModelServer`` gates on this, see
   ``DL4J_TPU_SLO_READYZ``).

Implementation: a ring of coarse time buckets (width = short window /
30) holding (good, total) pairs — O(1) record, O(#buckets) evaluation,
no per-request allocation beyond the bucket roll. Gauges exported per
model: ``dl4j_slo_burn_rate{model,window}``,
``dl4j_slo_hit_rate{model,window}``, and
``dl4j_slo_healthy{model}``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.environment import environment
from ..common.locks import ordered_lock
from ..common.metrics import registry


class SLOTracker:
    """Sliding-window success-rate tracking for one served model."""

    def __init__(self, model: str, *,
                 objective: Optional[float] = None,
                 latency_objective_s: Optional[float] = "env",
                 windows: Optional[Sequence[Tuple[float, float]]] = None,
                 min_samples: int = 20,
                 clock=time.monotonic):
        env = environment()
        self.model = str(model)
        self.objective = (env.slo_objective() if objective is None
                          else float(objective))
        self.latency_objective_s = (env.slo_latency_s()
                                    if latency_objective_s == "env"
                                    else latency_objective_s)
        self.windows: Tuple[Tuple[float, float], ...] = tuple(
            sorted((float(w), float(b))
                   for w, b in (windows if windows is not None
                                else env.slo_windows())))
        if not self.windows:
            raise ValueError("need at least one (window_s, burn) pair")
        self.min_samples = max(int(min_samples), 1)
        self._clock = clock
        # bucket ring sized for the longest window at short-window/30
        # granularity — burn-rate evaluation walks <= maxlen buckets
        self.bucket_s = max(self.windows[0][0] / 30.0, 0.05)
        maxlen = int(self.windows[-1][0] / self.bucket_s) + 2
        self._buckets: deque = deque(maxlen=maxlen)  # [idx, good, total]
        self._lock = ordered_lock("slo")
        reg = registry()
        self._m_requests = reg.counter(
            "dl4j_slo_requests_total",
            "SLO-eligible serving requests by objective outcome",
            labels=("model", "good"))
        burn = reg.gauge(
            "dl4j_slo_burn_rate",
            "Error-budget burn rate (error rate / allowed rate) per window",
            labels=("model", "window"))
        hit = reg.gauge(
            "dl4j_slo_hit_rate",
            "Fraction of requests meeting the objective per window",
            labels=("model", "window"))
        self._m_burn = {w: burn.labels(model=self.model, window=int(w))
                        for w, _ in self.windows}
        self._m_hit = {w: hit.labels(model=self.model, window=int(w))
                       for w, _ in self.windows}
        self._m_healthy = reg.gauge(
            "dl4j_slo_healthy",
            "1 while the model's SLO is not fast-burning, else 0",
            labels=("model",)).labels(model=self.model)
        self._m_healthy.set(1)
        self._m_excluded = reg.counter(
            "dl4j_slo_excluded_total",
            "Requests excluded from the SLO as client faults, by reason "
            "(e.g. quarantined poison requests)",
            labels=("model", "reason"))

    # -- recording ---------------------------------------------------------
    def record(self, latency_s: float, ok: bool = True):
        """One completed request: ``ok=False`` for a deadline miss /
        server error; an ``ok`` request still misses the objective when
        a latency objective is set and ``latency_s`` exceeds it."""
        good = bool(ok) and (self.latency_objective_s is None
                             or latency_s <= self.latency_objective_s)
        idx = int(self._clock() // self.bucket_s)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == idx:
                slot = self._buckets[-1]
            else:
                slot = [idx, 0, 0]
                self._buckets.append(slot)
            slot[1] += 1 if good else 0
            slot[2] += 1
        self._m_requests.labels(model=self.model,
                                good="true" if good else "false").inc()
        self._refresh_gauges()
        return good

    def record_excluded(self, reason: str):
        """Count a request deliberately NOT fed into the objective (a
        quarantined poison request is the request's fault, not the
        replica's) so the exclusion itself stays observable — a replica
        quarantining half its traffic should look odd on a dashboard
        even while its SLO reads healthy."""
        self._m_excluded.labels(model=self.model,
                                reason=str(reason)).inc()

    # -- evaluation --------------------------------------------------------
    def _counts(self, window_s: float) -> Tuple[int, int]:
        """(good, total) over the trailing ``window_s`` seconds."""
        floor = int((self._clock() - window_s) // self.bucket_s)
        good = total = 0
        with self._lock:
            for idx, g, t in self._buckets:
                if idx > floor:
                    good += g
                    total += t
        return good, total

    def hit_rate(self, window_s: float) -> Optional[float]:
        good, total = self._counts(window_s)
        return good / total if total else None

    def burn_rate(self, window_s: float) -> float:
        """Error-budget burn rate over the window; 0.0 with no traffic
        (an idle model is not burning budget)."""
        good, total = self._counts(window_s)
        if total == 0:
            return 0.0
        error_rate = (total - good) / total
        budget = max(1.0 - self.objective, 1e-9)
        return error_rate / budget

    def healthy(self) -> bool:
        """False only when every window burns past its threshold and the
        shortest window saw at least ``min_samples`` requests."""
        short_total = self._counts(self.windows[0][0])[1]
        if short_total < self.min_samples:
            return True
        return not all(self.burn_rate(w) >= b for w, b in self.windows)

    def snapshot(self) -> Dict:
        """JSON-able state for /readyz, /debug, and the flight
        recorder."""
        windows: List[Dict] = []
        for w, b in self.windows:
            good, total = self._counts(w)
            windows.append({
                "window_s": w, "burn_threshold": b, "total": total,
                "good": good,
                "hit_rate": good / total if total else None,
                "burn_rate": self.burn_rate(w)})
        return {"model": self.model, "objective": self.objective,
                "latency_objective_s": self.latency_objective_s,
                "min_samples": self.min_samples,
                "healthy": self.healthy(), "windows": windows}

    def _refresh_gauges(self):
        for w, _ in self.windows:
            good, total = self._counts(w)
            self._m_burn[w].set(self.burn_rate(w))
            if total:
                self._m_hit[w].set(good / total)
        self._m_healthy.set(1 if self.healthy() else 0)
