"""Host-side tracing: request-scoped span trees in a bounded ring buffer.

A copy of the JAX package's ``common/tracing.py`` (the port imports
nothing from that package):

- a contextvar ``TraceContext`` (trace_id / span_id / parent) that nested
  ``span()`` calls extend into a tree, and that ``DecodeEngine.generate``
  captures from the submitting thread;
- ``tracer().record(...)``, with which the decode loop appends the
  ``generation/prefill`` and ``generation/decode`` spans on a request's
  behalf (contextvars do not cross threads);
- ``parse_traceparent`` / ``format_traceparent`` /
  ``context_from_traceparent`` for W3C trace context at the HTTP edge;
- ``span_tree`` (the ``/debug/requests`` view) and
  ``record_disposition`` for failure post-mortems;
- ``capture_profile``: one ``torch.profiler`` capture at a time for
  ``/debug/profile``. While it runs, every ``span()`` also enters
  ``torch.profiler.record_function``, so host spans show on the
  profiler's timeline (the JAX package enters
  ``jax.profiler.TraceAnnotation``).

Enabled-ness is the metrics registry's one cached flag
(``DL4J_TPU_METRICS``): a disabled ``span()`` returns a shared no-op
context manager and ``record`` returns at once.
"""
from __future__ import annotations

import contextvars
import gzip
import json
import os
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

from .locks import ordered_lock
from .metrics import registry

#: True while capture_profile runs (spans then enter record_function)
_PROFILE_ACTIVE = False


class TraceContext(NamedTuple):
    """The active position in a request's span tree. ``span_id`` is the
    id of the currently open span; an empty one marks a root context."""
    trace_id: str
    span_id: str = ""
    parent_id: Optional[str] = None


_CTX: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("dl4j_tpu_torch_trace_ctx", default=None)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def current_context() -> Optional[TraceContext]:
    """The TraceContext bound to this thread/task, or None."""
    return _CTX.get()


@contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Bind ``ctx`` as the active trace context for the with-block."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """W3C ``traceparent`` -> TraceContext, or None when absent or
    malformed. Format: ``<2hex version>-<32hex trace-id>-<16hex
    parent-id>-<2hex flags>``; all-zero ids are invalid."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, parent_id = parts[0], parts[1], parts[2]
    if (len(version) != 2 or len(trace_id) != 32 or len(parent_id) != 16
            or version == "ff"):
        return None
    try:
        int(trace_id, 16), int(parent_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return TraceContext(trace_id, parent_id, None)


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id or '0' * 16}-01"


def context_from_traceparent(header: Optional[str]) -> TraceContext:
    """The entry context of one inbound request: the caller's (trace_id,
    span_id) when a valid ``traceparent`` arrives, else a fresh root
    trace."""
    ctx = parse_traceparent(header)
    return ctx if ctx is not None else TraceContext(new_trace_id())


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _count_span_error(name: str):
    try:
        registry().counter(
            "dl4j_span_errors_total",
            "Spans that exited with an exception, by span name",
            labels=("name",)).labels(name=name).inc()
    except Exception:
        pass  # observability must never break the failing path further


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_annotation", "_ctx",
                 "_token")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._annotation = None
        self._ctx: Optional[TraceContext] = None
        self._token = None

    def __enter__(self):
        parent = _CTX.get()
        if parent is not None:
            self._ctx = TraceContext(parent.trace_id, new_span_id(),
                                     parent.span_id or None)
            self._token = _CTX.set(self._ctx)
        if _PROFILE_ACTIVE:
            try:
                import torch.profiler
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            except Exception:
                self._annotation = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._annotation is not None:
            try:
                self._annotation.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        if self._token is not None:
            _CTX.reset(self._token)
        ev = {"name": self.name, "ph": "X",
              "ts": self._t0 * 1e6, "dur": (t1 - self._t0) * 1e6,
              "pid": self._tracer.pid, "tid": threading.get_ident()}
        args = self.args
        if exc_type is not None:
            args = dict(args) if args else {}
            args["error"] = exc_type.__name__
            _count_span_error(self.name)
        if self._ctx is not None:
            args = dict(args) if args else {}
            args["trace_id"] = self._ctx.trace_id
            args["span_id"] = self._ctx.span_id
            if self._ctx.parent_id:
                args["parent_span_id"] = self._ctx.parent_id
        if args:
            ev["args"] = args
        self._tracer._events.append(ev)  # deque append: thread-safe
        return False


class Tracer:
    """Ring buffer of span events (capacity = DL4J_TPU_TRACE_BUFFER)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            from .environment import environment
            capacity = environment().trace_buffer()
        self.capacity = max(int(capacity), 1)
        self.pid = os.getpid()
        self._events: deque = deque(maxlen=self.capacity)

    def span(self, name: str, **attrs):
        """Context manager timing one region; a no-op singleton when
        telemetry is disabled."""
        if not registry().enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def record(self, name: str, t0: float, t1: float,
               context: Optional[TraceContext] = None,
               span_id: Optional[str] = None,
               **attrs) -> Optional[dict]:
        """Append one completed span on behalf of a request whose context
        lives on another thread (``t0``/``t1`` in ``time.perf_counter``
        seconds). With ``context``, the span enters that request's tree
        as a child of ``context.span_id``; ``span_id`` pins the recorded
        span's own id instead of minting one."""
        if not registry().enabled:
            return None
        ev = {"name": name, "ph": "X", "ts": t0 * 1e6,
              "dur": max(t1 - t0, 0.0) * 1e6, "pid": self.pid,
              "tid": threading.get_ident()}
        args = dict(attrs)
        if context is not None:
            args["trace_id"] = context.trace_id
            args["span_id"] = span_id or new_span_id()
            if context.span_id:
                args["parent_span_id"] = context.span_id
        if args.get("error"):
            _count_span_error(name)
        if args:
            ev["args"] = args
        self._events.append(ev)
        return ev

    def events(self) -> List[dict]:
        return list(self._events)

    def events_for(self, trace_id: str) -> List[dict]:
        """Every buffered event tagged with ``trace_id``, oldest first."""
        return [e for e in self._events
                if e.get("args", {}).get("trace_id") == trace_id]

    def clear(self):
        self._events.clear()
        return self

    def export(self, path: str) -> int:
        """Write the buffer as a chrome trace JSON file (gzipped when the
        path ends in .gz), which ``profile_analyzer.load_trace`` reads
        back. Parent directories are created and the write is atomic (a
        temporary file, then a rename). Returns the events written."""
        events = self.events()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        opener = gzip.open if path.endswith(".gz") else open
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with opener(tmp, "wt") as f:
                json.dump({"traceEvents": events,
                           "displayTimeUnit": "ms"}, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return len(events)



def span_tree(events: List[dict]) -> List[dict]:
    """Nest a flat event list (``events_for`` output) into span trees by
    span_id / parent_span_id; roots (and orphans whose parent fell off the
    ring) sort by start time."""
    nodes, order = {}, []
    for e in events:
        args = e.get("args", {})
        node = {"name": e.get("name"), "ts": e.get("ts"),
                "dur": e.get("dur"),
                "args": {k: v for k, v in args.items()
                         if k not in ("trace_id", "span_id",
                                      "parent_span_id")},
                "span_id": args.get("span_id"),
                "parent_span_id": args.get("parent_span_id"),
                "children": []}
        order.append(node)
        if node["span_id"]:
            nodes[node["span_id"]] = node
    roots = []
    for node in order:
        parent = nodes.get(node["parent_span_id"]) \
            if node["parent_span_id"] else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in order:
        node["children"].sort(key=lambda n: n["ts"] or 0)
    roots.sort(key=lambda n: n["ts"] or 0)
    return roots


# -- on-demand profiling (the /debug/profile endpoint) ----------------------

_PROFILE_CAPTURE_LOCK = ordered_lock("tracing.profile_capture")


class ProfileBusyError(RuntimeError):
    """A profiler capture is already running (one at a time)."""


def capture_profile(seconds: float, log_dir: Optional[str] = None) -> dict:
    """Run a blocking ``torch.profiler`` capture (host activity, and the
    card's kernels where CUDA is available) for ``seconds`` and write it
    as a chrome trace. Returns ``{"path", "seconds", "files": [{"file",
    "bytes"}, ...]}``. One capture at a time (``ProfileBusyError``
    otherwise); captures land under ``log_dir`` (default
    ``Environment.profile_dir()``), one timestamped subdir each."""
    global _PROFILE_ACTIVE
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .environment import environment

    seconds = min(max(float(seconds), 0.01), 120.0)
    base = log_dir or environment().profile_dir()
    path = os.path.join(
        base, time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}")
    if not _PROFILE_CAPTURE_LOCK.acquire(blocking=False):
        raise ProfileBusyError(
            "a profiler capture is already running; retry when it ends")
    try:
        os.makedirs(path, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _PROFILE_ACTIVE = True
            try:
                time.sleep(seconds)
            finally:
                _PROFILE_ACTIVE = False
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
    finally:
        _PROFILE_CAPTURE_LOCK.release()
    files = []
    for root, _, names in os.walk(path):
        for name in names:
            p = os.path.join(root, name)
            try:
                files.append({"file": os.path.relpath(p, path),
                              "bytes": os.path.getsize(p)})
            except OSError:
                pass
    return {"path": path, "seconds": seconds,
            "files": sorted(files, key=lambda f: f["file"])}


# per-trace failure dispositions: what the resilience machinery did to a
# request (``engine_restart`` — failed by a crashed worker dispatch).
# Bounded dict, oldest-first eviction; keyed by trace_id.
_DISPOSITIONS: "OrderedDict[str, str]" = OrderedDict()
_DISPOSITIONS_LOCK = ordered_lock("tracing.dispositions")
_DISPOSITIONS_CAP = 4096


def record_disposition(trace_id: Optional[str], disposition: str):
    """Stamp a failure disposition on ``trace_id`` (no-op without one)."""
    if not trace_id:
        return
    with _DISPOSITIONS_LOCK:
        _DISPOSITIONS[trace_id] = disposition
        _DISPOSITIONS.move_to_end(trace_id)
        while len(_DISPOSITIONS) > _DISPOSITIONS_CAP:
            _DISPOSITIONS.popitem(last=False)


def pop_disposition(trace_id: Optional[str]) -> Optional[str]:
    """Consume the disposition recorded for ``trace_id``, if any."""
    if not trace_id:
        return None
    with _DISPOSITIONS_LOCK:
        return _DISPOSITIONS.pop(trace_id, None)


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = ordered_lock("tracing.singleton")


def tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER


def span(name: str, **attrs):
    """``with span("serving/request", model=name): ...`` on the process
    tracer."""
    return tracer().span(name, **attrs)


def export(path: str) -> int:
    """The process tracer's buffer as a chrome trace file
    (:meth:`Tracer.export`)."""
    return tracer().export(path)
