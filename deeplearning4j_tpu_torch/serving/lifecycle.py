"""Graceful serving lifecycle: SIGTERM drain and replica handoff.

A copy of the JAX package's ``serving/lifecycle.py`` (the port imports
nothing from that package). Reference: the Kubernetes termination contract every production serving
deployment runs under — on SIGTERM a replica must (1) fail its readiness
probe so the load balancer stops routing to it, (2) refuse new work with
backpressure the client understands, (3) finish what it already accepted,
and (4) leave enough state behind that its replacement starts warm. Here:

1. ``ModelServer.begin_drain()`` — ``/readyz`` answers 503, predicts
   answer 503/429, admission controllers shed their waiters.
2. ``ModelRegistry.drain_all()`` — every engine finishes its queued and
   in-flight requests, and late submits fail fast with
   ``EngineClosedError``.
3. ``save_manifests()`` — warmup manifests land in
   ``runtime.compile_cache.serving_manifest_dir()`` (a generative engine
   has none: its warmup is fixed by its shape).
4. The HTTP socket closes last, after the work is done.

On the way down (and on demand at SIGQUIT, which does *not* drain) the
lifecycle writes a **flight recorder**: one JSON file carrying the
recent-requests ring, the buffered trace events, the per-model SLO
state, and the metrics snapshot — the post-mortem a dead replica can no
longer serve from ``/debug/requests``. Dumps land in
``DL4J_TPU_FLIGHT_RECORDER_DIR`` (default ``<cache_dir>/flight``) and
are written atomically.

``GracefulLifecycle.install()`` wires this to SIGTERM (handler chains to
any previously installed one); ``drain()`` can also be called directly —
e.g. from a preStop hook or a test.

With a fleet-shared artifact store configured (``DL4J_TPU_REMOTE_CACHE``)
the contract extends across replicas: ``drain()`` additionally pushes the
local kernel libraries + manifests to the shared store
(``compile_cache.push_to_remote``), and :func:`restore_on_boot` pulls
them down on the way up — call it before deploying models, i.e. before
``/readyz`` can flip, so the load balancer never routes traffic to a
replica that would run ``nvcc`` instead of serving. A warm image
(``runtime/warm_image.py``) is such a shared store, baked ahead of time.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Callable, Iterable, Optional

from ..common import faults
from ..common.environment import environment
from ..common.locks import ordered_lock
from ..common.metrics import registry as metrics_registry
from ..common.tracing import tracer
from ..runtime import compile_cache
from . import resilience
from .registry import ModelRegistry
from .server import ModelServer

log = logging.getLogger(__name__)


def restore_on_boot() -> dict:
    """Pull the fleet's kernel libraries + warmup manifests from the
    shared artifact store into the local cache (no-op without
    ``DL4J_TPU_REMOTE_CACHE``). Call before ``registry.deploy`` /
    ``ModelServer`` start so every kernel library loads from a store hit
    and ``/readyz`` only ever flips on a replica that will not compile
    under live traffic. Returns ``{"executables": n, "manifests": m}``
    (``executables``: the libraries pulled)."""
    try:
        return compile_cache.pull_from_remote()
    except Exception:
        log.exception("artifact-store pull on boot failed; continuing "
                      "with a cold cache")
        return {"executables": 0, "manifests": 0}


class GracefulLifecycle:
    """Owns the drain sequence for one (registry, server) pair."""

    def __init__(self, registry: ModelRegistry,
                 server: Optional[ModelServer] = None,
                 drain_timeout_s: Optional[float] = None,
                 on_drained: Optional[Callable[[], None]] = None):
        self.registry = registry
        self.server = server
        self.drain_timeout_s = (drain_timeout_s
                                if drain_timeout_s is not None
                                else environment().serving_drain_timeout_s())
        self.on_drained = on_drained
        self._lock = ordered_lock("lifecycle")
        self._drain_started = False
        self._drained = threading.Event()
        self._previous: dict = {}

    # -- signal wiring ----------------------------------------------------
    def install(self, signals: Iterable[int] = (signal.SIGTERM,),
                dump_signals: Iterable[int] = (
                    (signal.SIGQUIT,) if hasattr(signal, "SIGQUIT")
                    else ())):
        """Install the drain handler on ``signals`` and a dump-only
        handler on ``dump_signals`` (SIGQUIT = "show me what you were
        doing" without shutting down). Main thread only — a CPython
        constraint of ``signal.signal``. Previous handlers are chained
        after ours and restored by ``uninstall()``."""
        for sig in signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        for sig in dump_signals:
            self._previous[sig] = signal.signal(sig, self._handle_dump)
        return self

    def uninstall(self):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return self

    def _handle(self, signum, frame):
        log.info("signal %d: starting graceful drain", signum)
        # the drain blocks on in-flight work; never do that in a signal
        # handler — hand it to a thread and return immediately
        threading.Thread(target=self.drain, name="dl4j-torch-drain",
                         daemon=True).start()
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    def _handle_dump(self, signum, frame):
        log.info("signal %d: dumping flight recorder", signum)
        threading.Thread(target=self.dump_flight_recorder,
                         name="dl4j-torch-flight-dump", daemon=True).start()
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    # -- flight recorder ---------------------------------------------------
    def dump_flight_recorder(self, path: Optional[str] = None
                             ) -> Optional[str]:
        """Write the in-memory observability state — recent-requests
        ring, buffered trace events, SLO snapshots, metrics — as one JSON
        file (atomic: tmp + rename). ``path`` overrides the default
        ``<flight_recorder_dir>/flight-<utc>-<pid>.json``; returns the
        written path, or None when the recorder is disabled (no dir
        resolvable) or the write failed — a dump must never break the
        drain."""
        try:
            if path is None:
                d = environment().flight_recorder_dir()
                if not d:
                    return None
                path = os.path.join(
                    d, time.strftime("flight-%Y%m%d-%H%M%S",
                                     time.gmtime())
                    + f"-{os.getpid()}.json")
            server = self.server
            doc = {
                "dumped_at": time.time(),
                "pid": os.getpid(),
                "draining": self._drain_started,
                "requests": (server.request_ring.records()
                             if server is not None else []),
                "slo": (server.slo_snapshot()
                        if server is not None else {}),
                # resilience state: which breakers were open, which
                # engines were flagged unhealthy, and what faults were
                # armed — the ring's per-request dispositions only make
                # sense next to these
                "breakers": self.registry.breaker_snapshot(),
                "engine_health": resilience.health().snapshot(),
                "faults": faults.stats(),
                # generative decode state: slot map, block tables, pool
                # occupancy, speculative acceptance (same join as
                # /debug/decode)
                "decode": self.registry.decode_snapshots(),
                "trace_events": tracer().events(),
                "metrics": metrics_registry().snapshot(),
            }
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            log.info("flight recorder written to %s (%d requests, %d "
                     "trace events)", path, len(doc["requests"]),
                     len(doc["trace_events"]))
            return path
        except Exception:
            log.exception("flight recorder dump failed")
            return None

    # -- the drain sequence -----------------------------------------------
    @property
    def drained(self) -> bool:
        return self._drained.is_set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def drain(self) -> bool:
        """Run the full drain sequence (idempotent: concurrent calls wait
        for the first). Returns True when everything flushed in time."""
        with self._lock:
            if self._drain_started:
                return self._drained.wait(self.drain_timeout_s + 5)
            self._drain_started = True
        try:
            if self.server is not None:
                self.server.begin_drain()  # readyz -> 503, shed new work
            # snapshot the in-memory observability state before engines
            # flush — the post-mortem of whatever this replica was doing
            self.dump_flight_recorder()
            ok = self.registry.drain_all(timeout_s=self.drain_timeout_s,
                                         save_manifests=True)
            # publish this replica's kernel libraries and manifests to
            # the shared artifact store (no-op without
            # DL4J_TPU_REMOTE_CACHE)
            try:
                compile_cache.push_to_remote()
            except Exception:
                log.exception("artifact-store push on drain failed")
            if self.server is not None:
                self.server.stop()  # socket closes after the work is done
            if self.on_drained is not None:
                try:
                    self.on_drained()
                except Exception:
                    log.exception("on_drained callback failed")
            log.info("graceful drain complete (flushed=%s)", ok)
            return ok
        finally:
            self._drained.set()
