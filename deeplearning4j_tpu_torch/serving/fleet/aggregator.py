"""Fleet metrics aggregation: one exposition over N replica registries.

A copy of the JAX package's ``serving/fleet/aggregator.py`` (the port
imports nothing from that package).

:class:`FleetAggregator` rides the :class:`~.router.FleetRouter` poll
loop — every ``/metrics.json`` scrape the poller already performs is
handed to :meth:`FleetAggregator.ingest` — and maintains a fleet-wide
view with *correct per-type merge semantics*:

- **counters** are summed across replicas with per-replica **reset
  detection**: each (family, label-set, replica) series tracks the last
  raw value and accumulates deltas, so a replica restart (its counters
  snap back to ~0) contributes its post-restart counts instead of
  stepping the fleet sum backward. The fleet-level rate of a counter is
  therefore monotone non-decreasing through any single-replica restart.
- **gauges** keep the last scraped value per replica; the merged series
  is the sum across replicas — exact for the capacity gauges the
  autoscaler reads (waiters, queue depth, active, free KV blocks), and
  documented as "sum" for everything else.
- **histograms** are merged **bucket-wise**: every engine in the repo
  observes into the same exponential bucket scheme
  (``common.metrics.exponential_buckets``), so summing per-bucket counts
  across replicas and interpolating quantiles inside the merged buckets
  yields *exactly* the percentiles of the pooled observations — not a
  re-estimate over pre-digested p50/p99s (averaging percentiles is the
  classic aggregation bug this module exists to avoid). Bucket counts
  get the same reset detection as counters, keyed on the series'
  monotone total count.

Exposition (served by ``FleetServer`` ``GET /metrics`` +
``/metrics.json``): per family, every per-replica series carries a
``replica="<url>"`` label and the merged series carries none, so one
scrape answers both "which replica?" and "the fleet as a whole".

A bounded in-memory **signal ring** (``DL4J_TPU_FLEET_AGG_RETENTION_S``
seconds / ``DL4J_TPU_FLEET_AGG_MAX_SAMPLES`` samples) keeps a short
time-series of each replica's autoscaling signals — admission waiters,
service EWMA, SLO burn/healthy, free KV blocks — and
:meth:`FleetAggregator.signals` joins the latest sample per replica with
the router's membership/brownout posture into the ``GET /fleet/signals``
JSON an SLO-driven autoscaler consumes.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ...common.environment import environment
from ...common.metrics import _fmt

#: gauge families distilled into the per-replica autoscaler signal view
_SIGNAL_GAUGES = {
    "dl4j_serving_waiters": ("admission", "waiters"),
    "dl4j_serving_ewma_service_seconds": ("admission", "ewma_s"),
    "dl4j_serving_queue_depth": ("admission", "queue_depth"),
    "dl4j_serving_active": ("admission", "active"),
    "dl4j_kv_blocks_free": ("kv", "blocks_free"),
    "dl4j_slo_healthy": ("slo", "healthy"),
}

#: signal fields whose fleet rollup is a plain SUM across replicas (the
#: capacity view); everything else rolls up as documented in signals()
_SUMMED_SIGNALS = ("waiters", "queue_depth", "active", "blocks_free")


def histogram_quantile(bounds: Tuple[float, ...], counts: List[float],
                       q: float) -> Optional[float]:
    """q-quantile by linear interpolation inside the buckets — the same
    rule as ``_HistogramChild.quantile`` and PromQL's
    ``histogram_quantile`` — over an explicit (bounds, counts) pair so
    fleet-merged bucket vectors use identical math to a single child.
    ``counts`` is per-bucket (NOT cumulative), last slot = +Inf
    overflow. None for an empty histogram (strict-JSON safe)."""
    total = sum(counts)
    if total <= 0 or not bounds:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):  # +Inf bucket clamps to the top bound
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * (rank - prev_cum) / c
    return bounds[-1]


def _label_suffix(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{labels[k]}"' for k in sorted(labels)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus_text(snap: Dict[str, dict]) -> str:
    """Prometheus text exposition (0.0.4) from a ``/metrics.json``-shaped
    snapshot — works for both a local ``MetricsRegistry.snapshot()`` and
    the aggregator's merged view (their series now both carry raw
    ``bounds``/``bucket_counts`` for histograms), so the fleet front
    door can serve one combined ``/metrics`` text."""
    lines: List[str] = []
    for name in sorted(snap):
        fam = snap[name]
        if not isinstance(fam, dict):
            continue
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam.get('type', 'untyped')}")
        for series in fam.get("series", ()):
            labels = series.get("labels") or {}
            if "bucket_counts" in series:
                bounds = series.get("bounds") or ()
                counts = series["bucket_counts"]
                cum = 0.0
                for bound, c in zip(bounds, counts):
                    cum += c
                    le = _label_suffix(labels, f'le="{_fmt(bound)}"')
                    lines.append(f"{name}_bucket{le} {_fmt(cum)}")
                le = _label_suffix(labels, 'le="+Inf"')
                lines.append(f"{name}_bucket{le} "
                             f"{_fmt(series.get('count', 0))}")
                ls = _label_suffix(labels)
                lines.append(f"{name}_sum{ls} "
                             f"{_fmt(series.get('sum', 0.0))}")
                lines.append(f"{name}_count{ls} "
                             f"{_fmt(series.get('count', 0))}")
            else:
                ls = _label_suffix(labels)
                lines.append(f"{name}{ls} "
                             f"{_fmt(series.get('value', 0.0))}")
    return "\n".join(lines) + ("\n" if lines else "")


class _HistState:
    """Per (family, label-set, replica) histogram accumulator with reset
    detection keyed on the series' monotone total count."""
    __slots__ = ("bounds", "last_counts", "adj_counts", "last_count",
                 "adj_count", "last_sum", "adj_sum")

    def __init__(self, bounds: Tuple[float, ...]):
        n = len(bounds) + 1
        self.bounds = bounds
        self.last_counts = [0.0] * n
        self.adj_counts = [0.0] * n
        self.last_count = 0.0
        self.adj_count = 0.0
        self.last_sum = 0.0
        self.adj_sum = 0.0

    def update(self, counts: List[float], count: float, total_sum: float):
        if count < self.last_count:  # replica restarted: fresh baseline
            self.last_counts = [0.0] * len(self.last_counts)
            self.last_count = 0.0
            self.last_sum = 0.0
        for i, c in enumerate(counts[:len(self.adj_counts)]):
            self.adj_counts[i] += max(c - self.last_counts[i], 0.0)
            self.last_counts[i] = c
        self.adj_count += max(count - self.last_count, 0.0)
        self.last_count = count
        self.adj_sum += max(total_sum - self.last_sum, 0.0)
        self.last_sum = total_sum


class FleetAggregator:
    """Scrape sink + merged exposition for a fleet of replicas. All
    state is in-process and bounded; ``ingest`` is defensive — a junk
    payload (wrong types, non-finite values) skips the junk entries and
    never raises into the poll loop."""

    def __init__(self, retention_s: Optional[float] = None,
                 max_samples: Optional[int] = None):
        env = environment()
        self.retention_s = env.fleet_agg_retention_s() \
            if retention_s is None else max(float(retention_s), 1.0)
        self.max_samples = env.fleet_agg_max_samples() \
            if max_samples is None else max(int(max_samples), 1)
        self._lock = threading.Lock()
        #: family name -> {"type", "help"}
        self._families: Dict[str, Dict[str, str]] = {}
        #: (name, labelkey) -> replica -> [last_raw, adjusted]
        self._counters: Dict[Tuple[str, Tuple], Dict[str, List[float]]] = {}
        #: (name, labelkey) -> adjusted totals of forgotten replicas —
        #: keeps the merged counter monotone across membership changes
        self._retired: Dict[Tuple[str, Tuple], float] = {}
        #: (name, labelkey) -> replica -> last value
        self._gauges: Dict[Tuple[str, Tuple], Dict[str, float]] = {}
        #: (name, labelkey) -> replica -> _HistState
        self._hists: Dict[Tuple[str, Tuple], Dict[str, _HistState]] = {}
        #: (ts, replica, signal view) ring — the autoscaler's short
        #: history; bounded by retention_s AND max_samples
        self._ring: "deque[Tuple[float, str, dict]]" = deque()
        self._scrapes = 0

    # -- ingest -----------------------------------------------------------
    def ingest(self, replica: str, doc: Any):
        """Fold one replica's ``/metrics.json`` into the fleet view."""
        if not isinstance(doc, dict):
            return
        replica = str(replica).rstrip("/")
        now = time.time()
        with self._lock:
            self._scrapes += 1
            for name, fam in doc.items():
                if not isinstance(fam, dict):
                    continue
                kind = fam.get("type")
                series = fam.get("series")
                if kind not in ("counter", "gauge", "histogram") \
                        or not isinstance(series, (list, tuple)):
                    continue
                self._families.setdefault(
                    name, {"type": kind, "help": str(fam.get("help", ""))})
                for entry in series:
                    if not isinstance(entry, dict):
                        continue
                    labels = entry.get("labels")
                    if not isinstance(labels, dict):
                        continue
                    key = (name, tuple(sorted(
                        (str(k), str(v)) for k, v in labels.items())))
                    if kind == "histogram":
                        self._ingest_hist(key, replica, entry)
                    elif kind == "counter":
                        v = _finite(entry.get("value"))
                        if v is None:
                            continue
                        st = self._counters.setdefault(key, {}).get(replica)
                        if st is None:
                            self._counters[key][replica] = [v, v]
                        else:
                            st[1] += v - st[0] if v >= st[0] else v
                            st[0] = v
                    else:
                        v = _finite(entry.get("value"))
                        if v is not None:
                            self._gauges.setdefault(key, {})[replica] = v
            self._ring.append((now, replica,
                               self._signal_view_locked(replica)))
            horizon = now - self.retention_s
            while self._ring and (len(self._ring) > self.max_samples
                                  or self._ring[0][0] < horizon):
                self._ring.popleft()

    def _ingest_hist(self, key, replica: str, entry: dict):
        bounds = entry.get("bounds")
        counts = entry.get("bucket_counts")
        if not isinstance(bounds, (list, tuple)) \
                or not isinstance(counts, (list, tuple)) \
                or len(counts) != len(bounds) + 1:
            return
        try:
            bounds = tuple(float(b) for b in bounds)
            counts = [float(c) for c in counts]
            count = float(entry.get("count") or 0.0)
            total_sum = float(entry.get("sum") or 0.0)
        except (TypeError, ValueError):
            return
        per_rep = self._hists.setdefault(key, {})
        st = per_rep.get(replica)
        if st is None or st.bounds != bounds:
            st = per_rep[replica] = _HistState(bounds)
        st.update(counts, count, total_sum)

    def forget(self, replica: str):
        """Drop a removed replica's per-series state (its already-merged
        counter history stays in the adjusted sums — a retired replica's
        past traffic really happened)."""
        replica = str(replica).rstrip("/")
        with self._lock:
            for key, per_rep in self._counters.items():
                st = per_rep.pop(replica, None)
                if st is not None:
                    self._retired[key] = self._retired.get(key, 0.0) \
                        + st[1]
            for table in (self._gauges, self._hists):
                for per_rep in table.values():
                    per_rep.pop(replica, None)

    # -- merged exposition ------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """``/metrics.json``-shaped fleet view: per family, one series
        per (label-set, replica) carrying a ``replica`` label, plus one
        merged series per label-set carrying none."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = dict(self._families)
            counters = {k: {r: st[1] for r, st in v.items()}
                        for k, v in self._counters.items()}
            retired = dict(self._retired)
            for key in retired:
                counters.setdefault(key, {})
            gauges = {k: dict(v) for k, v in self._gauges.items()}
            hists = {k: {r: (st.bounds, list(st.adj_counts), st.adj_count,
                             st.adj_sum) for r, st in v.items()}
                     for k, v in self._hists.items()}
        for name in sorted(fams):
            kind = fams[name]["type"]
            series: List[dict] = []
            if kind == "histogram":
                keys = sorted(k for k in hists if k[0] == name)
                for key in keys:
                    merged: Dict[Tuple[float, ...], list] = {}
                    for rep in sorted(hists[key]):
                        bounds, counts, count, s = hists[key][rep]
                        series.append(self._hist_entry(
                            dict(key[1]), bounds, counts, count, s,
                            replica=rep))
                        m = merged.setdefault(
                            bounds, [[0.0] * len(counts), 0.0, 0.0])
                        for i, c in enumerate(counts):
                            m[0][i] += c
                        m[1] += count
                        m[2] += s
                    for bounds in sorted(merged):
                        counts, count, s = merged[bounds]
                        series.append(self._hist_entry(
                            dict(key[1]), bounds, counts, count, s))
            else:
                table = counters if kind == "counter" else gauges
                keys = sorted(k for k in table if k[0] == name)
                for key in keys:
                    for rep in sorted(table[key]):
                        series.append(
                            {"labels": {**dict(key[1]), "replica": rep},
                             "value": table[key][rep]})
                    # merged counters fold in forgotten replicas'
                    # adjusted totals: the fleet sum stays monotone
                    # across membership changes
                    merged_v = sum(table[key].values())
                    if kind == "counter":
                        merged_v += retired.get(key, 0.0)
                    series.append({"labels": dict(key[1]),
                                   "value": merged_v})
            out[name] = {"type": kind, "help": fams[name]["help"],
                         "series": series}
        return out

    @staticmethod
    def _hist_entry(labels: Dict[str, str], bounds, counts, count, s,
                    replica: Optional[str] = None) -> dict:
        if replica is not None:
            labels = {**labels, "replica": replica}
        return {"labels": labels, "count": count, "sum": s,
                "bounds": list(bounds), "bucket_counts": list(counts),
                "p50": histogram_quantile(bounds, counts, 0.50),
                "p90": histogram_quantile(bounds, counts, 0.90),
                "p99": histogram_quantile(bounds, counts, 0.99)}

    def merged_with(self, local: Dict[str, dict]) -> Dict[str, dict]:
        """The combined fleet exposition: the front door's own registry
        snapshot with every aggregated family folded in (on a name
        collision the aggregated series — replica-labeled + merged —
        append to the local family's series list)."""
        out = {name: {"type": fam.get("type"), "help": fam.get("help"),
                      "series": list(fam.get("series", ()))}
               for name, fam in local.items()}
        for name, fam in self.snapshot().items():
            if name in out:
                out[name]["series"].extend(fam["series"])
            else:
                out[name] = fam
        return out

    # -- autoscaler signals -----------------------------------------------
    def _signal_view_locked(self, replica: str) -> Dict[str, Any]:
        """Distill the replica's latest gauges into the autoscaler's
        signal schema. Caller holds the lock."""
        view: Dict[str, Any] = {"admission": {}, "slo": {}, "kv": {}}
        for (name, labelkey), per_rep in self._gauges.items():
            spec = _SIGNAL_GAUGES.get(name)
            if spec is None or replica not in per_rep:
                continue
            group, field = spec
            labels = dict(labelkey)
            model = labels.get("model")
            if model is None:
                continue
            slot = view[group].setdefault(model, {})
            value = per_rep[replica]
            slot[field] = bool(value) if field == "healthy" else value
        for (name, labelkey), per_rep in self._gauges.items():
            if name != "dl4j_slo_burn_rate" or replica not in per_rep:
                continue
            labels = dict(labelkey)
            model, window = labels.get("model"), labels.get("window")
            if model is None or window is None:
                continue
            view["slo"].setdefault(model, {}).setdefault(
                "burn", {})[window] = per_rep[replica]
        return view

    def signals(self, replica_state: Optional[Dict[str, dict]] = None,
                brownout: Optional[dict] = None) -> Dict[str, Any]:
        """The ``GET /fleet/signals`` document: per replica the latest
        distilled signal view (admission waiters/EWMA/queue/active, SLO
        burn rates + healthy, free KV blocks) joined with the router's
        membership state, plus a fleet rollup — membership counts
        (``replicas``/``ready``) ride on top, capacity fields
        (waiters, queue_depth, active, blocks_free) are exact sums,
        ``ewma_s`` is the mean across reporting replicas, SLO burn is
        the worst (max) replica and ``healthy`` is the AND. The ring
        depth/retention ride along so an autoscaler can tell how much
        history backs the numbers."""
        with self._lock:
            latest: Dict[str, Tuple[float, dict]] = {}
            for ts, rep, view in self._ring:
                latest[rep] = (ts, view)
            ring_len = len(self._ring)
            scrapes = self._scrapes
        replicas: Dict[str, dict] = {}
        for rep, (ts, view) in sorted(latest.items()):
            entry = {"ts": ts, **view}
            if replica_state and rep in replica_state:
                entry.update(replica_state[rep])
            replicas[rep] = entry
        for rep, state in sorted((replica_state or {}).items()):
            replicas.setdefault(rep, {"ts": None, "admission": {},
                                      "slo": {}, "kv": {}, **state})
        rollup: Dict[str, Any] = {
            "replicas": len(replicas),
            "ready": sum(1 for e in replicas.values() if e.get("ready")),
            "admission": {}, "slo": {}, "kv": {}}
        ewma_n: Dict[str, int] = {}
        for entry in replicas.values():
            for model, adm in entry.get("admission", {}).items():
                slot = rollup["admission"].setdefault(model, {})
                for field in _SUMMED_SIGNALS:
                    if field in adm:
                        slot[field] = slot.get(field, 0.0) + adm[field]
                if "ewma_s" in adm:
                    slot["ewma_s"] = slot.get("ewma_s", 0.0) + adm["ewma_s"]
                    ewma_n[model] = ewma_n.get(model, 0) + 1
            for model, kv in entry.get("kv", {}).items():
                slot = rollup["kv"].setdefault(model, {})
                for field in _SUMMED_SIGNALS:
                    if field in kv:
                        slot[field] = slot.get(field, 0.0) + kv[field]
            for model, slo in entry.get("slo", {}).items():
                slot = rollup["slo"].setdefault(
                    model, {"healthy": True, "burn": {}})
                if slo.get("healthy") is False:
                    slot["healthy"] = False
                for window, rate in slo.get("burn", {}).items():
                    slot["burn"][window] = max(
                        slot["burn"].get(window, 0.0), rate)
        for model, n in ewma_n.items():
            rollup["admission"][model]["ewma_s"] /= n
        doc = {"ts": time.time(), "replicas": replicas, "fleet": rollup,
               "ring": {"samples": ring_len, "scrapes": scrapes,
                        "retention_s": self.retention_s,
                        "max_samples": self.max_samples}}
        if brownout is not None:
            doc["brownout"] = brownout
        return doc

    def history(self, replica: Optional[str] = None) -> List[dict]:
        """The retained signal ring, oldest first (debug/tests)."""
        with self._lock:
            return [{"ts": ts, "replica": rep, "signals": view}
                    for ts, rep, view in self._ring
                    if replica is None or rep == str(replica).rstrip("/")]


def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f and f not in (float("inf"), float("-inf")) else None
