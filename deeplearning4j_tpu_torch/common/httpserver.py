"""Shared stdlib-HTTP building blocks of the serving front end.

A copy of the JAX package's ``common/httpserver.py`` (the port imports
nothing from that package), so the HTTP hygiene (Content-Length on every
response, client disconnects handled without stack traces, debug-gated
request logging) is the reference's.

- ``QuietThreadingHTTPServer`` — ThreadingHTTPServer whose
  ``handle_error`` treats client disconnects (``BrokenPipeError`` /
  ``ConnectionResetError`` when the peer goes away mid-response) as
  routine: counted on ``server.client_disconnects`` and debug-logged,
  never a stderr stack trace. Anything else still reports normally.
- ``JsonRequestHandler`` — BaseHTTPRequestHandler with ``send_payload``/
  ``send_json`` (always sets Content-Length, swallows disconnects while
  writing) and ``read_body``.
- ``metrics_payload`` — the Prometheus / JSON exposition of the process
  metrics registry, shared by every ``/metrics`` endpoint (refreshes the
  ``dl4j_uptime_seconds`` / ``dl4j_build_info`` gauges at scrape time).
- ``handle_debug_get`` / ``handle_debug_post`` — the shared ``/debug/*``
  endpoint family (gated by ``DL4J_TPU_DEBUG_ENDPOINTS``):

      GET  /debug/trace/<trace_id>       buffered span events + tree
      GET  /debug/compile_cache          artifact-store inventory
                                         (kernel libraries, tiers)
      GET  /debug/memory                 per-device memory stats
                                         (``torch.cuda.memory_stats``)
      POST /debug/profile?seconds=       blocking torch.profiler capture

  (``/debug/requests`` lives on ``serving.ModelServer``, the only server
  that owns per-request records.)
"""
from __future__ import annotations

import json
import logging
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Tuple

log = logging.getLogger(__name__)

#: exceptions that mean "the client hung up", not "the server broke"
CLIENT_DISCONNECTS = (BrokenPipeError, ConnectionResetError,
                      ConnectionAbortedError)


class QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that logs client disconnects instead of
    printing a traceback for every impatient curl."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.client_disconnects = 0

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, CLIENT_DISCONNECTS):
            self.client_disconnects += 1
            log.debug("client %s disconnected mid-request: %r",
                      client_address, exc)
            return
        super().handle_error(request, client_address)


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Handler base: every response carries Content-Length (HTTP/1.1
    keep-alive safe), writes survive the client hanging up, and per-line
    request logging only appears under debug logging."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("%s - %s", self.address_string(), fmt % args)

    def send_payload(self, body: bytes, content_type: str = "text/plain",
                     code: int = 200,
                     headers: Iterable[Tuple[str, str]] = ()):
        """One response: status + Content-Type + Content-Length + body.
        A client that disconnected mid-write is counted and the
        connection dropped — no stack trace, no retry."""
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)
        except CLIENT_DISCONNECTS as e:
            srv = getattr(self, "server", None)
            if hasattr(srv, "client_disconnects"):
                srv.client_disconnects += 1
            log.debug("client disconnected during response: %r", e)
            self.close_connection = True

    def send_json(self, obj, code: int = 200,
                  headers: Iterable[Tuple[str, str]] = ()):
        self.send_payload(json.dumps(obj).encode(), "application/json",
                          code, headers)

    def read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(n) if n > 0 else b""


def metrics_payload(fmt: str = "text") -> Tuple[bytes, str]:
    """(body, content_type) for a /metrics[.json] endpoint, off the
    process-wide registry (``environment().metrics()``). Refreshes the
    scrape-time process-identity gauges (uptime, build info) first."""
    from .environment import environment
    from .metrics import touch_runtime_info

    reg = environment().metrics()
    touch_runtime_info(reg)
    if fmt == "json":
        return json.dumps(reg.snapshot()).encode(), "application/json"
    return (reg.prometheus_text().encode(),
            "text/plain; version=0.0.4; charset=utf-8")


# ---------------------------------------------------------------------------
# shared /debug/* endpoint family
# ---------------------------------------------------------------------------

def device_memory_stats() -> dict:
    """Per-device memory stats (``/debug/memory``): the integer entries of
    ``torch.cuda.memory_stats`` for every CUDA device, and none without
    one; never raising."""
    devices: List[Dict] = []
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for i in range(n):
            try:
                stats = torch.cuda.memory_stats(i) or {}
            except Exception:
                stats = {}
            devices.append({"device": f"cuda:{i}", "platform": "gpu",
                            "name": torch.cuda.get_device_name(i),
                            "stats": {k: int(v) for k, v in stats.items()
                                      if isinstance(v, (int, float))}})
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}", "devices": []}
    return {"devices": devices}



def debug_enabled() -> bool:
    from .environment import environment
    return environment().debug_endpoints_enabled()


def handle_debug_get(handler: "JsonRequestHandler", path: str) -> bool:
    """Serve the shared GET ``/debug/*`` endpoints; returns True when the
    path was handled (the caller 404s otherwise)."""
    from .tracing import span_tree, tracer

    if path.startswith("/debug/trace/"):
        trace_id = path[len("/debug/trace/"):].strip("/")
        events = tracer().events_for(trace_id)
        handler.send_json({"trace_id": trace_id, "count": len(events),
                           "tree": span_tree(events), "events": events})
        return True
    if path == "/debug/compile_cache":
        from ..runtime import compile_cache
        handler.send_json(compile_cache.inventory())
        return True
    if path == "/debug/memory":
        handler.send_json(device_memory_stats())
        return True
    return False


def handle_debug_post(handler: "JsonRequestHandler", path: str,
                      query: Dict[str, List[str]]) -> bool:
    """Serve the shared POST ``/debug/*`` endpoints (currently the
    on-demand profiler capture); returns True when handled."""
    from .tracing import ProfileBusyError, capture_profile

    if path == "/debug/profile":
        try:
            seconds = float((query.get("seconds") or ["1"])[0])
        except ValueError:
            handler.send_json({"error": "seconds must be a number"}, 400)
            return True
        try:
            handler.send_json(capture_profile(seconds))
        except ProfileBusyError as e:
            handler.send_json({"error": str(e)}, 409)
        except Exception as e:
            log.exception("profiler capture failed")
            handler.send_json({"error": f"{type(e).__name__}: {e}"}, 500)
        return True
    return False
