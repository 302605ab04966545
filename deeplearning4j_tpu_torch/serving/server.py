"""Model-serving HTTP front end (stdlib ThreadingHTTPServer).

Counterpart of the JAX package's ``serving/server.py``, over the port's
registry:

    POST /v1/models/<name>/generate           autoregressive generation
    POST /v1/models/<name>/predict            current version
    POST /v1/models/<name>:<version>/predict  pinned version
                                              (InferenceEngine's
                                              micro-batcher)
    POST /v1/models/<name>:<version>/generate (DecodeEngine; optional
                                              chunked token streaming)
    GET  /v1/models                           registry listing
    GET  /healthz                             liveness (process is up)
    GET  /readyz                              readiness (all current
                                              versions warmed, not
                                              draining, engines healthy,
                                              SLOs not fast-burning) —
                                              503 otherwise
    GET  /metrics, /metrics.json              Prometheus / JSON exposition
    GET  /debug/requests                      recent-requests ring with
                                              per-request span trees
    GET  /debug/trace/<trace_id>              one trace's span tree
    GET  /debug/decode                        live slot maps and pools
    GET  /debug/slo, /debug/resilience        SLO and breaker state
    GET  /debug/memory                        torch.cuda memory stats
    POST /debug/profile?seconds=              torch.profiler capture

``/predict`` takes JSON (``{"inputs": ..., "timeout_s": ...}``: a list
becomes one array; f64 / i64 numbers arrive as f32 / i32) or a raw
``.npy`` payload (``Content-Type: application/x-npy``; the response
mirrors the format). ``/generate`` takes ``{"prompt": [ids...],
"max_tokens", "temperature",
"top_k", "eos_token", "stream", "timeout_s"}``. Requests ride the
per-model admission controller (429 + ``Retry-After`` past the
high-water mark, 504 when the deadline expires first) and the request's
trace: an inbound W3C ``traceparent`` joins the caller's trace, else a
fresh trace id is minted, and every response echoes ``X-Trace-Id``. The
latency fed to the per-model SLO tracker is the request's (for a
generate, time-to-first-token). With
``"stream": true`` the response is ``application/x-ndjson`` over chunked
transfer encoding: one ``{"token": id}`` line per sampled token, then a
``{"done": true, ...}`` summary line. Token ids go out as Python ints.

Status mapping (the JAX package's): 404 unknown model/version, 400
malformed input, 409 pinned to a retired version, 422 quarantined (a
poison request: it failed its coalesced dispatch and its isolated
re-dispatch; the body carries its ``trace_id``), 429 shed, 503 draining
or breaker open, 504 deadline, 500 anything else.
"""
from __future__ import annotations

import io
import json
import logging
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..common import faults
from ..common.environment import environment
from ..common.locks import ordered_lock
from ..common.httpserver import (CLIENT_DISCONNECTS, JsonRequestHandler,
                                 QuietThreadingHTTPServer, handle_debug_get,
                                 handle_debug_post, metrics_payload)
from ..common.tracing import (context_from_traceparent, pop_disposition,
                              span, span_tree, tracer, use_context)
from ..runtime.inference import EngineClosedError, PoisonRequestError
from . import resilience
from .admission import AdmissionController, DeadlineExceededError, ShedError
from .registry import ModelRegistry
from .resilience import BreakerOpenError
from .slo import SLOTracker

log = logging.getLogger(__name__)

_PREDICT_RE = re.compile(r"^/v1/models/([^/:]+)(?::([^/]+))?/predict$")
_GENERATE_RE = re.compile(r"^/v1/models/([^/:]+)(?::([^/]+))?/generate$")
_NPY_TYPES = ("application/x-npy", "application/octet-stream")

def _np_cast(a: np.ndarray) -> np.ndarray:
    """JSON numbers arrive as f64/i64; the networks run f32/i32 (the JAX
    package's x64-off types)."""
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _parse_inputs(obj):
    if isinstance(obj, dict):
        return {k: _np_cast(np.asarray(v)) for k, v in obj.items()}
    return _np_cast(np.asarray(obj))


def _host_array(x) -> np.ndarray:
    """An output (``NDArray`` or tensor) as a host numpy array."""
    if hasattr(x, "numpy") and hasattr(x, "torch"):
        return x.numpy()
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy() \
            if x.dtype.is_floating_point else x.detach().cpu().numpy()
    return np.asarray(x)


def _jsonable_outputs(out):
    if isinstance(out, dict):
        return {k: _host_array(v).tolist() for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [_host_array(v).tolist() for v in out]
    return _host_array(out).tolist()


#: response status -> ring/SLO outcome label
_OUTCOMES = {200: "ok", 400: "bad_request", 404: "not_found",
             409: "retired", 422: "quarantined", 429: "shed",
             500: "error", 503: "draining", 504: "deadline"}

#: statuses that count against the serving SLO (client mistakes don't:
#: a quarantined poison request — 422 — is the request's own fault and
#: must not burn the replica's error budget; it is counted separately
#: via ``SLOTracker.record_excluded`` and the request ring disposition)
_SLO_STATUSES = (200, 429, 500, 503, 504)


class RequestRing:
    """Bounded ring of completed-request records (the flight recorder's
    and ``/debug/requests``'s source). Thread-safe via deque atomics."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = environment().request_ring_size()
        self._records: deque = deque(maxlen=max(int(capacity), 1))

    def add(self, record: dict):
        self._records.append(record)

    def records(self) -> List[dict]:
        return list(self._records)

    def find(self, trace_id: str) -> Optional[dict]:
        """The newest record of ``trace_id``, or None."""
        for rec in reversed(self._records):
            if rec.get("trace_id") == trace_id:
                return rec
        return None

    def __len__(self) -> int:
        return len(self._records)


class ModelServer:
    """HTTP server over a ModelRegistry with per-model admission control.

    One ``AdmissionController`` and one ``SLOTracker`` per model, created
    on first use from the ``DL4J_TPU_SERVING_*`` / ``DL4J_TPU_SLO_*`` env
    knobs (or the constructor overrides); ``set_admission()`` /
    ``set_slo()`` swap in custom-tuned instances."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_concurrent: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 high_water: Optional[int] = None,
                 request_ring: Optional[int] = None):
        self.registry = registry if registry is not None else ModelRegistry()
        self.host = host
        self.port = port
        self.draining = False
        self._admission_kwargs = dict(max_concurrent=max_concurrent,
                                      queue_depth=queue_depth,
                                      high_water=high_water)
        self._admission: Dict[str, AdmissionController] = {}
        self._admission_lock = ordered_lock("server.admission")
        self._slo: Dict[str, SLOTracker] = {}
        self._slo_lock = ordered_lock("server.slo")
        self.request_ring = RequestRing(request_ring)
        self._httpd: Optional[QuietThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- admission plumbing -----------------------------------------------
    def admission_for(self, name: str) -> AdmissionController:
        ctrl = self._admission.get(name)
        if ctrl is None:
            with self._admission_lock:
                ctrl = self._admission.get(name)
                if ctrl is None:
                    ctrl = AdmissionController(name,
                                               **self._admission_kwargs)
                    self._admission[name] = ctrl
        return ctrl

    def set_admission(self, name: str, controller: AdmissionController):
        with self._admission_lock:
            self._admission[name] = controller
        return self

    # -- SLO plumbing ------------------------------------------------------
    def slo_for(self, name: str) -> SLOTracker:
        slo = self._slo.get(name)
        if slo is None:
            with self._slo_lock:
                slo = self._slo.get(name)
                if slo is None:
                    slo = SLOTracker(name)
                    self._slo[name] = slo
        return slo

    def set_slo(self, name: str, tracker: SLOTracker):
        with self._slo_lock:
            self._slo[name] = tracker
        return self

    def slo_healthy(self) -> bool:
        """True while no served model's error budget is fast-burning."""
        with self._slo_lock:
            trackers = list(self._slo.values())
        return all(t.healthy() for t in trackers)

    def slo_snapshot(self) -> Dict[str, dict]:
        with self._slo_lock:
            trackers = dict(self._slo)
        return {name: t.snapshot() for name, t in sorted(trackers.items())}

    # -- request accounting ------------------------------------------------
    def _finish_request(self, name: str, version: Optional[str],
                        trace_id: str, status: int, duration_s: float,
                        timeout_s: Optional[float],
                        kind: str = "predict",
                        latency_s: Optional[float] = None,
                        disposition: Optional[str] = None,
                        precision: Optional[str] = None,
                        priority: Optional[int] = None,
                        fleet_replica: Optional[str] = None,
                        fleet_attempt: Optional[str] = None,
                        phases: Optional[dict] = None):
        """Ring + SLO bookkeeping for one completed request, whatever its
        outcome (the ring is the /debug/requests + flight-recorder
        source). ``latency_s`` overrides the SLO-fed latency — generate
        requests feed time-to-first-token, the generative latency
        objective, while ``duration_s`` in the ring stays wall time.
        ``disposition`` records what the resilience machinery did to the
        request (``quarantined|retried|breaker_open|engine_restart``);
        when the handler did not set one, the engine-recorded
        disposition for this trace id is consumed — so a post-mortem can
        tell shed load from faulted load by trace id.
        ``fleet_replica``/``fleet_attempt`` echo the front-door attempt
        that carried the request (the ``X-Fleet-Replica`` /
        ``X-Fleet-Attempt`` headers the fleet router stamps per
        attempt), so ``/debug/requests`` — and the flight recorder,
        which dumps these same ring records — shows which hedge/retry a
        replica actually served; ``phases`` is the engine's per-request
        latency decomposition (queue/prefill/decode seconds)."""
        if disposition is None:
            disposition = pop_disposition(trace_id)
        else:
            pop_disposition(trace_id)  # handler's verdict wins; drop ours
        self.request_ring.add({
            "trace_id": trace_id, "model": name, "version": version,
            "kind": kind, "status": status,
            "outcome": _OUTCOMES.get(status, str(status)),
            "disposition": disposition,
            "precision": precision,
            "priority": priority,
            "ts": time.time(), "duration_s": round(duration_s, 6),
            "timeout_s": timeout_s,
            "fleet_replica": fleet_replica,
            "fleet_attempt": fleet_attempt,
            "phases": phases})
        if status in _SLO_STATUSES:
            try:
                self.slo_for(name).record(
                    latency_s if latency_s is not None else duration_s,
                    ok=status == 200)
            except Exception:  # SLO bookkeeping never fails a response
                log.exception("SLO record failed for %s", name)

    def debug_requests(self, query: Dict[str, List[str]]) -> dict:
        """``GET /debug/requests``: newest-first records, each joined
        with its span tree from the trace ring (so a deadline-expired
        request's admission wait / queue / coalesce / dispatch timeline
        reads in one place)."""
        try:
            limit = int((query.get("n") or ["50"])[0])
        except ValueError:
            limit = 50
        model = (query.get("model") or [None])[0]
        trace_id = (query.get("trace_id") or [None])[0]
        trc = tracer()
        out = []
        for rec in reversed(self.request_ring.records()):
            if model and rec.get("model") != model:
                continue
            if trace_id and rec.get("trace_id") != trace_id:
                continue
            out.append({**rec,
                        "spans": span_tree(trc.events_for(
                            rec["trace_id"]))})
            if len(out) >= max(limit, 1):
                break
        return {"count": len(out), "ring_size": len(self.request_ring),
                "requests": out}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> int:
        """Serve on a daemon thread; returns the bound port."""
        self._httpd = QuietThreadingHTTPServer((self.host, self.port),
                                               self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dl4j-torch-model-server",
                                        daemon=True)
        self._thread.start()
        log.info("model server on %s:%d", self.host, self.port)
        return self.port

    def begin_drain(self):
        """Flip readiness off and shed all new work (the first step of a
        graceful shutdown; the HTTP socket stays up so load balancers see
        the 503s and drain routing)."""
        self.draining = True
        with self._admission_lock:
            for ctrl in self._admission.values():
                ctrl.close()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        return self

    # -- handler ----------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(JsonRequestHandler):
            _trace_id: Optional[str] = None

            def send_payload(self, body, content_type="text/plain",
                             code=200, headers=()):
                self._last_status = code
                if self._trace_id:
                    headers = list(headers) + [("X-Trace-Id",
                                                self._trace_id)]
                super().send_payload(body, content_type, code, headers)

            def do_GET(self):
                self._trace_id = None  # keep-alive: no stale echo
                url = urlparse(self.path)
                path = url.path
                if path == "/healthz":
                    self.send_payload(b"ok", "text/plain")
                elif path == "/readyz":
                    warm = not server.draining and server.registry.ready()
                    slo_ok = server.slo_healthy()
                    health = resilience.health()
                    engines_ok = health.healthy()
                    ready = (warm and engines_ok
                             and (slo_ok
                                  or not environment().slo_gate_readyz()))
                    self.send_json(
                        {"ready": ready, "draining": server.draining,
                         "slo_healthy": slo_ok,
                         "engines_healthy": engines_ok,
                         "engine_health": health.snapshot(),
                         "slo": server.slo_snapshot(),
                         "models": server.registry.models()},
                        200 if ready else 503)
                elif path == "/v1/models":
                    self.send_json({"models": server.registry.models()})
                elif path == "/metrics":
                    self.send_payload(*metrics_payload())
                elif path == "/metrics.json":
                    self.send_payload(*metrics_payload("json"))
                elif path.startswith("/debug/"):
                    if not environment().debug_endpoints_enabled():
                        self.send_json(
                            {"error": "debug endpoints disabled "
                                      "(DL4J_TPU_DEBUG_ENDPOINTS=0)"}, 404)
                    elif path == "/debug/requests":
                        self.send_json(server.debug_requests(
                            parse_qs(url.query)))
                    elif path == "/debug/slo":
                        self.send_json({"healthy": server.slo_healthy(),
                                        "models": server.slo_snapshot()})
                    elif path == "/debug/resilience":
                        self.send_json({
                            "breakers":
                                server.registry.breaker_snapshot(),
                            "engine_health":
                                resilience.health().snapshot(),
                            "watchdog":
                                resilience.watchdog().watched(),
                            "faults": faults.stats()})
                    elif path == "/debug/decode":
                        self.send_json({
                            "decode":
                                server.registry.decode_snapshots()})
                    elif not handle_debug_get(self, path):
                        self.send_json({"error": "not found"}, 404)
                else:
                    self.send_json({"error": "not found"}, 404)

            def do_POST(self):
                url = urlparse(self.path)
                path = url.path
                if path.startswith("/debug/"):
                    if not environment().debug_endpoints_enabled() or \
                            not handle_debug_post(self, path,
                                                  parse_qs(url.query)):
                        self.send_json({"error": "not found"}, 404)
                    return
                kind = "predict"
                m = _PREDICT_RE.match(path)
                if m is None:
                    m = _GENERATE_RE.match(path)
                    kind = "generate"
                if m is None:
                    self.send_json({"error": "not found"}, 404)
                    return
                name, version = m.group(1), m.group(2)
                # join the caller's W3C trace or mint a fresh one; the
                # whole request — admission wait, prefill/decode or
                # coalesce/dispatch — records spans under it, and every
                # response (including errors) echoes X-Trace-Id
                ctx = context_from_traceparent(
                    self.headers.get("traceparent"))
                self._trace_id = ctx.trace_id
                self._last_status = 500
                self._served_version = version
                self._timeout_s = None
                self._latency_s = None
                self._disposition = None
                self._precision = None
                # the fleet front door's brownout class rides X-Priority;
                # recording it in the ring lets a post-mortem tell what a
                # shed would have cost (which priorities were in flight)
                self._priority = None
                raw_prio = self.headers.get("X-Priority")
                if raw_prio is not None:
                    try:
                        self._priority = min(max(int(raw_prio.strip()),
                                                 0), 9)
                    except ValueError:
                        pass
                # the fleet router stamps which attempt this is
                # (primary|retry|hedge|affinity_fallback) and its own
                # view of this replica's URL; echoing them into the
                # ring joins a replica's /debug/requests (and flight
                # recorder) back to the front-door attempt it served
                self._fleet_replica = self.headers.get("X-Fleet-Replica")
                self._fleet_attempt = self.headers.get("X-Fleet-Attempt")
                self._phases = None
                if server.draining:
                    self.send_json(
                        {"error": "server is draining"}, 503,
                        headers=[("Retry-After", "1")])
                    return
                t0 = time.perf_counter()
                try:
                    with use_context(ctx), \
                            span("serving/request", model=name,
                                 version=version or "", kind=kind):
                        self._dispatch_request(kind, name, version)
                finally:
                    server._finish_request(
                        name, self._served_version, ctx.trace_id,
                        self._last_status, time.perf_counter() - t0,
                        self._timeout_s, kind=kind,
                        latency_s=self._latency_s,
                        disposition=self._disposition,
                        precision=self._precision,
                        priority=self._priority,
                        fleet_replica=self._fleet_replica,
                        fleet_attempt=self._fleet_attempt,
                        phases=self._phases)

            def _dispatch_request(self, kind: str, name: str,
                                  version: Optional[str]):
                try:
                    if faults.active():
                        # handler-level injection site: an InjectedFault
                        # here maps to 500 and burns the SLO like any
                        # other server fault (that is the point)
                        faults.check("http.handler", model=name,
                                     kind=kind)
                    if kind == "generate":
                        self._generate(name, version)
                    else:
                        self._predict(name, version)
                except KeyError as e:
                    self.send_json({"error": str(e.args[0])}, 404)
                except PoisonRequestError as e:
                    # quarantined: failed its coalesced dispatch AND the
                    # one isolated retry: the fault follows the request,
                    # so answer 4xx with the trace id and keep serving
                    self._disposition = "quarantined"
                    try:
                        server.slo_for(name).record_excluded("quarantined")
                    except Exception:
                        pass
                    self.send_json(
                        {"error": str(e), "quarantined": True,
                         "trace_id": self._trace_id}, 422)
                except ShedError as e:
                    retry = max(1, int(np.ceil(e.retry_after_s)))
                    self.send_json(
                        {"error": str(e),
                         "retry_after_s": round(e.retry_after_s, 3)},
                        429, headers=[("Retry-After", retry)])
                except BreakerOpenError as e:
                    # fail-fast: the version's breaker is open; hint the
                    # client off for the larger of the probe window and
                    # the admission backlog estimate
                    self._disposition = "breaker_open"
                    hint = e.retry_after_s
                    try:
                        hint = max(hint, server.admission_for(name)
                                   .retry_after_hint())
                    except Exception:
                        pass
                    self.send_json(
                        {"error": str(e),
                         "retry_after_s": round(hint, 3)},
                        503, headers=[("Retry-After",
                                       max(1, int(np.ceil(hint))))])
                except (DeadlineExceededError, TimeoutError) as e:
                    self.send_json({"error": f"deadline exceeded: {e}"},
                                   504)
                except EngineClosedError as e:
                    # a version pinned to a retired/drained engine: a
                    # routine routing miss, not a server fault
                    self.send_json({"error": str(e)}, 409)
                except (ValueError, TypeError) as e:
                    self.send_json({"error": f"bad request: {e}"}, 400)
                except Exception as e:  # the server must outlive any model
                    log.exception("predict failed for %s", name)
                    self.send_json(
                        {"error": f"{type(e).__name__}: {e}"}, 500)

            def _predict(self, name: str, version: Optional[str]):
                body = self.read_body()
                ctype = (self.headers.get("Content-Type") or
                         "application/json").split(";")[0].strip()
                timeout_s = None
                hdr = self.headers.get("X-Request-Timeout-S")
                if hdr:
                    timeout_s = float(hdr)
                if ctype in _NPY_TYPES:
                    request = _np_cast(
                        np.load(io.BytesIO(body), allow_pickle=False))
                    as_npy = True
                else:
                    doc = json.loads(body or b"{}")
                    if "inputs" not in doc:
                        raise ValueError('JSON body must carry "inputs"')
                    request = _parse_inputs(doc["inputs"])
                    if doc.get("timeout_s") is not None:
                        timeout_s = float(doc["timeout_s"])
                    as_npy = False
                self._timeout_s = timeout_s
                # resolve first so unknown models 404 before admission
                mv = server.registry.get(name, version)
                self._served_version = mv.version
                self._precision = mv.precision
                ctrl = server.admission_for(name)
                with ctrl.admit(timeout_s if timeout_s is not None
                                else "default",
                                version=mv.version) as permit:
                    out = server.registry.predict(
                        name, request, version=version,
                        timeout_s=permit.remaining_s())
                    mv = server.registry.get(name, version)
                    self._served_version = mv.version
                    self._precision = mv.precision
                if as_npy:
                    first = out
                    if isinstance(out, dict):
                        first = next(iter(out.values()))
                    elif isinstance(out, (list, tuple)):
                        first = out[0]
                    buf = io.BytesIO()
                    np.save(buf, _host_array(first))
                    self.send_payload(
                        buf.getvalue(), "application/x-npy",
                        headers=[("X-Model-Version", mv.version)])
                else:
                    self.send_json({"model": name, "version": mv.version,
                                    "outputs": _jsonable_outputs(out)})

            # -- generation (KV-cached decode engine) ---------------------
            def _generate(self, name: str, version: Optional[str]):
                doc = json.loads(self.read_body() or b"{}")
                if "prompt" not in doc:
                    raise ValueError('JSON body must carry "prompt" '
                                     "(a list of token ids)")
                prompt = doc["prompt"]
                if not isinstance(prompt, (list, tuple)) or not all(
                        isinstance(t, int) for t in prompt):
                    raise ValueError('"prompt" must be a flat list of '
                                     "integer token ids")
                timeout_s = None
                hdr = self.headers.get("X-Request-Timeout-S")
                if hdr:
                    timeout_s = float(hdr)
                if doc.get("timeout_s") is not None:
                    timeout_s = float(doc["timeout_s"])
                self._timeout_s = timeout_s
                opts = {}
                if doc.get("max_tokens") is not None:
                    opts["max_tokens"] = int(doc["max_tokens"])
                if doc.get("temperature") is not None:
                    opts["temperature"] = float(doc["temperature"])
                if doc.get("top_k") is not None:
                    opts["top_k"] = int(doc["top_k"])
                if "eos_token" in doc:
                    opts["eos_token"] = doc["eos_token"]
                stream = bool(doc.get("stream"))
                # resolve first so unknown models 404 before admission
                mv = server.registry.get(name, version)
                self._served_version = mv.version
                self._precision = mv.precision
                ctrl = server.admission_for(name)
                with ctrl.admit(timeout_s if timeout_s is not None
                                else "default",
                                version=mv.version) as permit:
                    if stream:
                        self._stream_generate(name, version, prompt,
                                              opts, permit)
                        return
                    res = server.registry.generate(
                        name, prompt, version=version,
                        timeout_s=permit.remaining_s(), **opts)
                mv = server.registry.get(name, version)
                self._served_version = mv.version
                self._precision = mv.precision
                self._latency_s = res.get("ttft_s")
                self._phases = res.get("phases")
                self.send_json({"model": name, "version": mv.version,
                                **res})

            def _stream_generate(self, name, version, prompt, opts,
                                 permit):
                """Chunked token streaming: one ndjson line per sampled
                token from the decode loop, then a summary line. The
                engine's on_token callback feeds a queue the handler
                thread drains — sockets are written from one thread
                only."""
                import queue

                mv = server.registry.get(name, version)
                from ..runtime.generation import DecodeEngine
                if not isinstance(mv.engine, DecodeEngine):
                    raise TypeError(f"model '{name}' is not generative; "
                                    "use predict()")
                q: "queue.Queue" = queue.Queue()
                fut = mv.engine.generate(
                    prompt, timeout_s=permit.remaining_s(),
                    on_token=q.put, **opts)
                self.begin_chunked("application/x-ndjson")
                try:
                    while True:
                        try:
                            tok = q.get(timeout=0.05)
                        except queue.Empty:
                            if fut.done() and q.empty():
                                break
                            continue
                        self.write_chunk(json.dumps(
                            {"token": tok}).encode() + b"\n")
                    try:
                        res = fut.result()
                        tail = {"done": True, "model": name,
                                "version": mv.version, **res}
                        self._latency_s = res.get("ttft_s")
                        self._phases = res.get("phases")
                    except Exception as e:  # headers are out: in-band error
                        self._last_status = 500
                        tail = {"done": True,
                                "error": f"{type(e).__name__}: {e}"}
                    self.write_chunk(json.dumps(tail).encode() + b"\n")
                finally:
                    self.end_chunked()

            # chunked transfer-encoding plumbing (streaming responses)
            def begin_chunked(self, content_type, code=200, headers=()):
                self._last_status = code
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Transfer-Encoding", "chunked")
                if self._trace_id:
                    self.send_header("X-Trace-Id", self._trace_id)
                for k, v in headers:
                    self.send_header(k, str(v))
                self.end_headers()

            def write_chunk(self, body: bytes):
                try:
                    self.wfile.write(b"%X\r\n" % len(body) + body + b"\r\n")
                    self.wfile.flush()
                except CLIENT_DISCONNECTS:
                    self.close_connection = True

            def end_chunked(self):
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except CLIENT_DISCONNECTS:
                    self.close_connection = True

        return Handler
