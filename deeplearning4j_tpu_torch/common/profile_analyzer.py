"""ProfileAnalyzer: load and compare chrome-trace profiles.

The port's own copy of the JAX package's ``common/profile_analyzer.py``
(the reference's ``ProfileAnalyzer.java``): it loads chrome trace-format
JSON files, plain or gzipped, and compares per-name aggregate timings.
It reads ``common.tracing.export``'s span files and
``torch.profiler``'s ``export_chrome_trace`` output alike (both are
chrome format).
"""
from __future__ import annotations

import gzip
import json
from collections import defaultdict
from typing import Dict, List


def load_trace(path: str) -> List[dict]:
    """Load chrome trace events (plain or gzipped; list or traceEvents)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") in ("X", "B", "E")
            and "name" in e]


class Aggregate(dict):
    """Per-name totals, plus truncation visibility: ``unmatched`` counts
    "E" events whose (tid, name) never had an open "B" — a nonzero value
    means the trace was cut mid-span (ring-buffer wrap, early export) and
    the per-name totals undercount."""

    def __init__(self, *args, unmatched: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.unmatched = unmatched


def aggregate(events: List[dict]) -> Aggregate:
    """Per-name totals (reference ProfileAnalyzer summarize): complete
    ("X") events aggregate by duration; B/E pairs are matched per tid.
    The result's ``unmatched`` attribute counts orphan "E" events."""
    totals = defaultdict(lambda: {"total_us": 0.0, "count": 0})
    open_begins: Dict[tuple, List[dict]] = defaultdict(list)
    unmatched = 0
    for e in events:
        if e.get("ph") == "X":
            t = totals[e["name"]]
            t["total_us"] += float(e.get("dur", 0.0))
            t["count"] += 1
        elif e.get("ph") == "B":
            open_begins[(e.get("tid"), e["name"])].append(e)
        elif e.get("ph") == "E":
            stack = open_begins.get((e.get("tid"), e.get("name")))
            if stack:
                b = stack.pop()
                t = totals[e["name"]]
                t["total_us"] += float(e.get("ts", 0)) - float(b.get("ts", 0))
                t["count"] += 1
            else:
                unmatched += 1
    out = Aggregate(unmatched=unmatched)
    for name, t in totals.items():
        out[name] = {**t, "avg_us": t["total_us"] / max(t["count"], 1)}
    return out


def compare(path_a: str, path_b: str,
            sort_by: str = "total_us") -> List[dict]:
    """Side-by-side per-op comparison of two traces (reference
    compareProfiles). Rows sorted by |delta| of `sort_by`."""
    agg_a = aggregate(load_trace(path_a))
    agg_b = aggregate(load_trace(path_b))
    rows = []
    for name in sorted(set(agg_a) | set(agg_b)):
        a = agg_a.get(name, {"total_us": 0.0, "count": 0, "avg_us": 0.0})
        b = agg_b.get(name, {"total_us": 0.0, "count": 0, "avg_us": 0.0})
        rows.append({
            "name": name,
            "a_total_us": a["total_us"], "b_total_us": b["total_us"],
            "a_count": a["count"], "b_count": b["count"],
            "a_avg_us": a["avg_us"], "b_avg_us": b["avg_us"],
            "delta_us": b[sort_by] - a[sort_by],
            "ratio": (b[sort_by] / a[sort_by]) if a[sort_by] else None,
        })
    rows.sort(key=lambda r: -abs(r["delta_us"]))
    return rows


def print_comparison(path_a: str, path_b: str, log_fn=print, top: int = 20):
    rows = compare(path_a, path_b)
    log_fn(f"{'name':<30} {'A total ms':>12} {'B total ms':>12} "
           f"{'ratio':>8}")
    for r in rows[:top]:
        ratio = f"{r['ratio']:.2f}" if r["ratio"] else "n/a"
        log_fn(f"{r['name']:<30} {r['a_total_us']/1e3:>12.2f} "
               f"{r['b_total_us']/1e3:>12.2f} {ratio:>8}")
