"""Process-wide metrics registry: labeled Counter/Gauge/Histogram.

A copy of the JAX package's ``common/metrics.py`` (the port imports
nothing from that package), cut to what the serving slice uses: the
registry, the three metric kinds, ``exponential_buckets`` /
``linear_buckets``, histogram quantiles, the JSON ``snapshot`` that
``/metrics.json`` serves and the Prometheus text view, and the scrape-time
``dl4j_uptime_seconds`` / ``dl4j_build_info`` gauges (labelled with the
torch and CUDA versions and the platform in place of the JAX package's
jax/jaxlib labels). Metric names are the JAX package's
(``dl4j_decode_*``, ``dl4j_kv_*``, ``dl4j_kernel_dispatch_total``, ...), so
a dashboard reads either package the same way.

- one process-wide singleton (``registry()``), also reachable as
  ``environment().metrics()``;
- every write reads ONE cached ``enabled`` flag (``DL4J_TPU_METRICS``, on
  by default) and returns at once when off;
- ``family.labels(...)`` returns cached children, so hot loops hoist the
  child and pay only an inc/observe per event;
- a kind or label-set clash at creation raises (programming error), but
  inc/set/observe never raise into the instrumented path.

Histograms carry exemplars: ``observe(value, exemplar=trace_id)``
remembers the last exemplar per bucket, linking a tail observation to
the request trace that produced it.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .locks import ordered_lock

#: process telemetry epoch: dl4j_uptime_seconds measures from here
_START_TIME = time.time()


def exponential_buckets(start: float, factor: float,
                        count: int) -> Tuple[float, ...]:
    """`count` bucket upper bounds: start, start*factor, ... (Prometheus
    client convention; the +Inf bucket is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


def linear_buckets(start: float, width: float,
                   count: int) -> Tuple[float, ...]:
    if width <= 0 or count < 1:
        raise ValueError("need width > 0, count >= 1")
    return tuple(start + width * i for i in range(count))


#: default latency buckets: 1us .. ~8.4s, x2 per rung
DEFAULT_BUCKETS = exponential_buckets(1e-6, 2.0, 24)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0."""
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled time series. Base for counter/gauge children."""
    __slots__ = ("_registry", "_value", "_lock")

    def __init__(self, registry):
        self._registry = registry
        self._value = 0.0
        self._lock = threading.Lock()

    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0):
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value: float):
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_registry", "_bounds", "_counts", "_sum", "_count",
                 "_lock", "_exemplars")

    def __init__(self, registry, bounds: Tuple[float, ...]):
        self._registry = registry
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._exemplars: Optional[Dict[int, Tuple[float, str, float]]] = None

    def observe(self, value: float, exemplar: Optional[str] = None):
        """Record one observation; with ``exemplar`` (a trace_id), the
        bucket it lands in remembers (value, trace_id, unix-time) — last
        writer wins, one slot per bucket."""
        if not self._registry.enabled:
            return
        v = float(value)
        i = 0
        for b in self._bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (v, str(exemplar), time.time())

    def exemplars(self) -> List[dict]:
        """Per-bucket exemplars, highest bucket first: ``{"le", "value",
        "trace_id", "ts"}``."""
        with self._lock:
            if not self._exemplars:
                return []
            items = sorted(self._exemplars.items(), reverse=True)
        return [{"le": (_fmt(self._bounds[i]) if i < len(self._bounds)
                        else "+Inf"),
                 "value": v, "trace_id": tid, "ts": ts}
                for i, (v, tid, ts) in items]

    def count(self) -> int:
        return self._count

    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by linear interpolation inside
        the buckets (the histogram_quantile rule). Observations past the
        top bound clamp to it."""
        with self._lock:
            counts, total = list(self._counts), self._count
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self._bounds):  # +Inf bucket
                    return self._bounds[-1]
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i]
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self._bounds[-1]

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class _Family:
    """A named metric with a fixed label set; unlabeled families act as
    their own single child."""

    def __init__(self, registry, name: str, help: str, kind: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self._registry = registry
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = label_names
        self._buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not label_names:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self):
        if self.kind == "counter":
            return _CounterChild(self._registry)
        if self.kind == "gauge":
            return _GaugeChild(self._registry)
        return _HistogramChild(self._registry, self._buckets)

    def labels(self, **kv):
        """Cached child for a label-value combination."""
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def _require_default(self):
        if self._default is None:
            raise ValueError(
                f"metric {self.name} has labels {self.label_names}; "
                "use .labels(...)")
        return self._default

    # unlabeled convenience passthroughs
    def inc(self, amount: float = 1.0):
        self._require_default().inc(amount)

    def set(self, value: float):
        self._require_default().set(value)

    def dec(self, amount: float = 1.0):
        self._require_default().dec(amount)

    def observe(self, value: float, exemplar: Optional[str] = None):
        self._require_default().observe(value, exemplar)

    def value(self) -> float:
        return self._require_default().value()

    def count(self) -> int:
        return self._require_default().count()

    def quantile(self, q: float) -> float:
        return self._require_default().quantile(q)

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Thread-safe named-metric registry with Prometheus exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create: the same name
    returns the same family (a kind or label-set clash raises)."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("DL4J_TPU_METRICS", "1") not in (
                "0", "false")
        self.enabled = bool(enabled)
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def set_enabled(self, v: bool):
        self.enabled = bool(v)
        return self

    def _get_or_create(self, name, help, kind, labels, buckets=None):
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(self, name, help, kind, tuple(labels),
                                  buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(f"metric {name} already registered as "
                             f"{fam.kind}, not {kind}")
        if fam.label_names != tuple(labels):
            raise ValueError(f"metric {name} registered with labels "
                             f"{fam.label_names}, not {tuple(labels)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> _Family:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> _Family:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        b = tuple(sorted(float(x) for x in (buckets or DEFAULT_BUCKETS)))
        return self._get_or_create(name, help, "histogram", labels, b)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def clear(self):
        """Drop every registered family (test isolation)."""
        with self._lock:
            self._families.clear()
        return self

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able view: per family, the type/help and every labelled
        series; histograms add sum/count, the raw bucket counts and
        p50/p90/p99 (None while empty, so the view stays strict JSON)."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            series = []
            for key, child in fam.children():
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    with child._lock:
                        n = child._count
                        s = child._sum
                        counts = list(child._counts)
                    pct = child.percentiles() if n else {
                        "p50": None, "p90": None, "p99": None}
                    entry = {"labels": labels, "count": n, "sum": s,
                             "bounds": list(child._bounds),
                             "bucket_counts": counts, **pct}
                    ex = child.exemplars()
                    if ex:
                        entry["exemplars"] = ex
                    series.append(entry)
                else:
                    series.append({"labels": labels,
                                   "value": child.value()})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.children():
                if fam.kind == "histogram":
                    with child._lock:
                        counts = list(child._counts)
                        total, s = child._count, child._sum
                    cum = 0
                    for bound, c in zip(child._bounds, counts):
                        cum += c
                        le = _label_str(fam.label_names, key,
                                        f'le="{_fmt(bound)}"')
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = _label_str(fam.label_names, key, 'le="+Inf"')
                    lines.append(f"{name}_bucket{le} {total}")
                    ls = _label_str(fam.label_names, key)
                    lines.append(f"{name}_sum{ls} {_fmt(s)}")
                    lines.append(f"{name}_count{ls} {total}")
                else:
                    ls = _label_str(fam.label_names, key)
                    lines.append(f"{name}{ls} {_fmt(child.value())}")
        return "\n".join(lines) + ("\n" if lines else "")


# -- process-identity gauges (dl4j_uptime_seconds, dl4j_build_info) --------

_BUILD_LABELS: Optional[Dict[str, str]] = None


def _build_labels() -> Dict[str, str]:
    """Label values of dl4j_build_info, resolved once: the torch and CUDA
    versions, the platform the card (or the CPU) gives, and whether the
    cache volume is enabled. Never raises."""
    global _BUILD_LABELS
    if _BUILD_LABELS is None:
        labels = {"torch_version": "unavailable",
                  "cuda_version": "none", "platform": "unavailable",
                  "cache": "unknown"}
        try:
            import torch
            labels["torch_version"] = torch.__version__
            labels["cuda_version"] = str(torch.version.cuda or "none")
            labels["platform"] = ("gpu" if torch.cuda.is_available()
                                  else "cpu")
        except Exception:
            pass
        try:
            from .environment import environment
            labels["cache"] = ("enabled" if environment().cache_dir()
                               else "disabled")
        except Exception:
            pass
        _BUILD_LABELS = labels
    return _BUILD_LABELS


def touch_runtime_info(reg: Optional[MetricsRegistry] = None):
    """Refresh the scrape-time gauges: uptime since telemetry import, and
    the constant-1 ``dl4j_build_info`` whose labels carry the build and
    runtime identity. Every ``/metrics`` render calls it."""
    reg = reg or registry()
    reg.gauge("dl4j_uptime_seconds",
              "Seconds since process telemetry initialized").set(
                  time.time() - _START_TIME)
    labels = _build_labels()
    reg.gauge("dl4j_build_info",
              "Constant 1; build/runtime identity in the labels",
              labels=tuple(sorted(labels))).labels(**labels).set(1)
    return reg


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = ordered_lock("metrics.singleton")


def registry() -> MetricsRegistry:
    """The process-wide registry (also ``environment().metrics()``)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY
