"""Request admission control: bounded queues, deadlines, load shedding.

A copy of the JAX package's ``serving/admission.py`` (the port imports
nothing from that package). Reference: the Clipper (NSDI '17) deadline-aware request frontend and the
Orca (OSDI '22) admission playbook — a serving system under overload must
choose *which* requests to serve, because serving all of them late serves
none of them. The three rules implemented here:

1. **Bounded concurrency** — at most ``max_concurrent`` requests of a
   model dispatch at once; the rest wait for a slot.
2. **Deadline propagation** — every request carries a budget
   (``timeout_s``, default ``DL4J_TPU_SERVING_TIMEOUT_S``). Waiting for a
   slot consumes it; a request whose budget expires *before* dispatch is
   shed right there — it never occupies a decode slot its caller already
   gave up on. The leftover budget rides along on the permit so the
   engine (``DecodeEngine.generate(timeout_s=...)``) can keep enforcing
   it after admission.
3. **Load shedding with retry-after** — once the waiting count crosses
   the high-water mark (``DL4J_TPU_SERVING_HIGH_WATER``, default 3/4 of
   ``DL4J_TPU_SERVING_QUEUE_DEPTH``), new arrivals are refused
   immediately with a ``ShedError`` carrying a retry-after hint derived
   from the queue length and an EWMA of recent service times — the HTTP
   layer turns it into ``429 Retry-After``. The queue therefore never
   grows unboundedly and admitted requests keep a bounded p99.

Admission is FIFO-fair (a ticket queue, not a bare condition variable):
a thread releasing its slot and immediately re-arriving queues *behind*
the waiters instead of barging past them — with a bare cv the releaser
re-acquires before the woken waiter is scheduled and starves it for
whole multiples of the service time, which is exactly the tail the p99
gate exists to catch.

Telemetry (``common.metrics``), labeled per model/version:
``dl4j_serving_requests_total{model,version,outcome}``,
``dl4j_serving_shed_total{model,reason}``,
``dl4j_serving_queue_seconds{model,version}``,
``dl4j_serving_queue_depth{model}``, ``dl4j_serving_active{model}``;
the internals that drive shedding decisions are exported too —
``dl4j_serving_ewma_service_seconds{model}`` (the EWMA behind
``Retry-After`` hints) and ``dl4j_serving_waiters{model}`` (the backlog
the hint is computed from). Each ``admit()`` runs inside a
``serving/admission`` span, so a request's admission wait — and a shed
or deadline expiry, recorded as span errors — lands in its trace.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..common.environment import environment
from ..common.locks import ordered_condition
from ..common.metrics import exponential_buckets, registry
from ..common.tracing import current_context, span


class ShedError(RuntimeError):
    """Refused at admission (queue past high-water / controller closed):
    back off ``retry_after_s`` seconds and retry."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceededError(TimeoutError):
    """The request's deadline budget expired before dispatch."""


class _Permit:
    """One admitted dispatch slot; a context manager so the slot is
    released (and the service-time EWMA updated) however dispatch ends."""

    __slots__ = ("_ctrl", "version", "_deadline", "_t_dispatch", "_done")

    def __init__(self, ctrl: "AdmissionController", version: str,
                 deadline: Optional[float]):
        self._ctrl = ctrl
        self.version = version
        self._deadline = deadline
        self._t_dispatch = time.monotonic()
        self._done = False

    def remaining_s(self) -> Optional[float]:
        """Budget left for the dispatch itself (deadline propagation into
        ``DecodeEngine.generate(timeout_s=...)``); None = no deadline."""
        if self._deadline is None:
            return None
        return max(self._deadline - time.monotonic(), 0.0)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._done:
            return False
        self._done = True
        outcome = "ok" if exc_type is None else (
            "deadline" if issubclass(exc_type, TimeoutError) else "error")
        self._ctrl._release(self, time.monotonic() - self._t_dispatch,
                            outcome)
        return False


class AdmissionController:
    """Admission gate for one served model (all versions share it — the
    capacity being protected is the device, not the executable)."""

    def __init__(self, model: str, *,
                 max_concurrent: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 high_water: Optional[int] = None,
                 default_timeout_s: Optional[float] = "env"):
        env = environment()
        self.model = str(model)
        self.max_concurrent = int(max_concurrent if max_concurrent
                                  is not None else env.serving_max_concurrent())
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else env.serving_queue_depth())
        self.high_water = int(high_water if high_water is not None
                              else env.serving_high_water())
        self.default_timeout_s = (env.serving_default_timeout_s()
                                  if default_timeout_s == "env"
                                  else default_timeout_s)
        self._cv = ordered_condition("admission")
        self._active = 0
        self._queue: list = []  # FIFO waiter tickets (bounded: high_water)
        self._closed = False
        # EWMA of dispatch seconds, seeding the retry-after estimator
        # before the first completion
        self._ewma_service_s = 0.05
        reg = registry()
        self._m_requests = reg.counter(
            "dl4j_serving_requests_total",
            "Serving requests by admission/dispatch outcome",
            labels=("model", "version", "outcome"))
        self._m_shed = reg.counter(
            "dl4j_serving_shed_total",
            "Requests refused at admission, by reason",
            labels=("model", "reason"))
        self._m_queue_lat = reg.histogram(
            "dl4j_serving_queue_seconds",
            "Wait between arrival and dispatch slot for admitted requests",
            labels=("model", "version"),
            buckets=exponential_buckets(1e-4, 2.0, 20))
        self._m_depth = reg.gauge(
            "dl4j_serving_queue_depth",
            "Requests waiting for a dispatch slot",
            labels=("model",)).labels(model=self.model)
        self._m_active = reg.gauge(
            "dl4j_serving_active",
            "Requests currently holding a dispatch slot",
            labels=("model",)).labels(model=self.model)
        self._m_ewma = reg.gauge(
            "dl4j_serving_ewma_service_seconds",
            "EWMA of per-request dispatch service time (drives the "
            "Retry-After hint on shed responses)",
            labels=("model",)).labels(model=self.model)
        self._m_ewma.set(self._ewma_service_s)
        self._m_waiters = reg.gauge(
            "dl4j_serving_waiters",
            "Backlog behind the retry-after estimate: requests waiting "
            "for or holding a dispatch slot",
            labels=("model",)).labels(model=self.model)

    # -- introspection ----------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def retry_after_hint(self) -> float:
        """How long a shed client should back off: the time the current
        backlog needs to clear at the recent service rate, floored so
        clients never hot-loop. Also the ``Retry-After`` source for
        breaker-open 503s (merged with the probe window)."""
        with self._cv:
            backlog = len(self._queue) + self._active
        est = backlog * self._ewma_service_s / max(self.max_concurrent, 1)
        return min(max(est, 0.05), 30.0)

    def ewma_service_s(self) -> float:
        """The service-time EWMA behind the retry-after estimate."""
        with self._cv:
            return self._ewma_service_s

    # -- lifecycle --------------------------------------------------------
    def close(self):
        """Stop admitting (graceful drain): new arrivals and current
        waiters shed with a draining message; in-flight dispatches finish
        normally."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        return self

    def reopen(self):
        """Admit again after :meth:`close`."""
        with self._cv:
            self._closed = False
        return self

    # -- admission --------------------------------------------------------
    def _shed(self, reason: str, version: str, message: str,
              retry_after: Optional[float] = None) -> ShedError:
        self._m_shed.labels(model=self.model, reason=reason).inc()
        self._m_requests.labels(model=self.model, version=version,
                                outcome="shed").inc()
        return ShedError(message, retry_after if retry_after is not None
                         else self.retry_after_hint())

    def admit(self, timeout_s: Optional[float] = "default",
              version: str = "") -> _Permit:
        """Block until a dispatch slot frees up (within the request's
        deadline budget) and return the permit. Raises ``ShedError`` when
        the queue is past high-water / full / draining, and
        ``DeadlineExceededError`` when the budget expires while waiting —
        in both cases *before* any model work happens. The wait runs in a
        ``serving/admission`` span of the caller's trace; shed/expired
        admissions exit it with error status."""
        if current_context() is not None:
            with span("serving/admission", model=self.model):
                return self._admit(timeout_s, version)
        return self._admit(timeout_s, version)

    def _admit(self, timeout_s: Optional[float] = "default",
               version: str = "") -> _Permit:
        budget = (self.default_timeout_s if timeout_s == "default"
                  else timeout_s)
        deadline = (time.monotonic() + budget
                    if budget is not None and budget > 0 else None)
        t0 = time.monotonic()
        version = str(version)
        ticket = object()
        with self._cv:
            if self._closed:
                raise self._shed(
                    "draining", version,
                    f"model '{self.model}' is draining", retry_after=1.0)
            threshold = min(self.high_water, self.queue_depth)
            if self._active >= self.max_concurrent \
                    and len(self._queue) >= threshold:
                raise self._shed(
                    "queue_full", version,
                    f"model '{self.model}' queue past high-water "
                    f"({len(self._queue)} waiting >= {threshold}); "
                    "retry later")
            self._queue.append(ticket)
            self._m_depth.set(len(self._queue))
            self._m_waiters.set(len(self._queue) + self._active)
            try:
                # FIFO: dispatch only at the queue head with a free slot
                while (self._active >= self.max_concurrent
                       or self._queue[0] is not ticket):
                    if self._closed:
                        raise self._shed(
                            "draining", version,
                            f"model '{self.model}' is draining",
                            retry_after=1.0)
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            self._m_shed.labels(model=self.model,
                                                reason="deadline").inc()
                            self._m_requests.labels(
                                model=self.model, version=version,
                                outcome="deadline").inc()
                            raise DeadlineExceededError(
                                f"deadline budget ({budget}s) expired "
                                f"before dispatch for model "
                                f"'{self.model}'")
                        self._cv.wait(remaining)
                    else:
                        self._cv.wait()
            finally:
                self._queue.remove(ticket)
                self._m_depth.set(len(self._queue))
                self._m_waiters.set(len(self._queue) + self._active)
                self._cv.notify_all()  # the head may have changed
            self._active += 1
            self._m_active.set(self._active)
            self._m_waiters.set(len(self._queue) + self._active)
        ctx = current_context()
        self._m_queue_lat.labels(model=self.model, version=version).observe(
            time.monotonic() - t0, exemplar=ctx.trace_id if ctx else None)
        return _Permit(self, version, deadline)

    def _release(self, permit: _Permit, service_s: float, outcome: str):
        self._m_requests.labels(model=self.model, version=permit.version,
                                outcome=outcome).inc()
        with self._cv:
            if outcome == "ok":
                self._ewma_service_s = (0.8 * self._ewma_service_s
                                        + 0.2 * service_s)
                self._m_ewma.set(self._ewma_service_s)
            self._active -= 1
            self._m_active.set(self._active)
            self._m_waiters.set(len(self._queue) + self._active)
            self._cv.notify_all()

    # -- convenience ------------------------------------------------------
    def run(self, fn: Callable, timeout_s: Optional[float] = "default",
            version: str = ""):
        """``admit()`` + call ``fn()`` under the permit."""
        with self.admit(timeout_s, version=version):
            return fn()
