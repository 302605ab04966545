"""CUDA-graph capture of the census-counted steps.

The capturing form of ``runtime/inference.py::counted_dispatch`` (its
``captured_dispatch`` builds on :class:`StepGraphs`), of the decode
engine's prefill, decode and verify steps (``runtime/generation.py``),
of the layer API's ``fit`` steps (``nn/fit_fastpath.py``, whose
static inputs include the network's own params, written in place) and
of the model-level train steps (``inference.captured_train_step``:
BERT's and the Seq2Seq step, over the caller's params and Adam state).
It is the port's counterpart of the JAX package's compiled-executable
contract (``counted_jit``): where XLA compiles each input signature once
and dispatches the executable after that, a :class:`StepGraphs` captures
each signature's step once as a ``torch.cuda.CUDAGraph`` and replays it.

- **Per signature** (:class:`Step`): static input buffers, the graph and
  its outputs. The census records one event per (tag, signature),
  ``dl4j_compiles_total{kind,cache="captured"}``, and the capture's
  seconds land on ``dl4j_compile_seconds{kind,cache}``.
- **Before capture** the body runs once on the set's own stream: cuBLAS
  handles, the kernels' builds (``kernels/_build.py``), their counter
  buffers and lazy allocations happen there, outside the graph. That
  run answers the call; the graph replays from the next call on.
- **One private memory pool** for the graphs of one set; they never
  replay at once (the set's ``lock``). A graph's outputs are its own:
  callers copy them out under the lock, before the next replay. The
  allocator's cached blocks are freed before each capture, and Python's
  collector is held off during it.
- **Stale graphs.** A graph holds the addresses of the tensors it read.
  A caller passes a ``key`` (for a network's forward, the identity of
  its param tensors and the precision in force); a call under another
  key captures again. The old params stay referenced until then, or
  until :meth:`StepGraphs.release` lets go of the graph with them, so
  no graph ever reads freed memory.
- **What a replay hides.** A replay runs no Python wrapper: the kernels'
  launch counts and dispatch records made during capture
  (``kernels/_counts.py``) are added on every replay.
- **Eager signatures.** A signature whose capture raises runs eagerly
  from then on, reported as ``cache="eager:<reason>"`` in the census and
  in :meth:`StepGraphs.report`, and logged once; so does one whose
  capture recorded no kernel (``eager:empty_graph``: torch only warns of
  an empty graph, whose replay would run nothing). A caller keeps a call
  eager by passing its reason to :meth:`StepGraphs.run`: steps that
  issue collectives between ranks (a mesh of more than one rank,
  :func:`mesh_reason`) as ``eager:<backend>``, signatures with host
  values among their inputs as ``eager:host_value``.
- **Release.** :meth:`StepGraphs.release` drops the graphs, their
  outputs and the bodies with the params they hold (an engine's
  ``close()``, a network whose params were replaced); the census of the
  signatures stays, and a later call captures again.
- **On the CPU** there is nothing to capture: the same body runs eagerly
  on the same static buffers, bound to the params of its last capture,
  so the CPU tests exercise the buffers, the keys and the census
  (``cache="eager"``).

CUDA runs one capture at a time in a process: captures are serialised
(``_CAPTURE_LOCK``) and run with ``capture_error_mode="thread_local"``, so
one engine's capture never faults another engine's thread.
"""
from __future__ import annotations

import gc
import logging
import math
import time
import warnings
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.environment import environment
from ..common.locks import ordered_lock, ordered_rlock
from ..kernels._counts import LaunchRecord, recording
from .compile_cache import observe_compile

log = logging.getLogger(__name__)

#: one capture at a time in the process
_CAPTURE_LOCK = ordered_lock("cuda_graphs.capture")


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _same_key(a, b) -> bool:
    """Objects by identity, numbers and strings by value."""
    if a is None or len(a) != len(b):
        return False
    return all(x is y or (isinstance(x, (int, float, str))
                          and type(x) is type(y) and x == y)
               for x, y in zip(a, b))


def mesh_reason(mesh) -> Optional[str]:
    """Why a step on ``mesh`` runs eagerly: the process group's backend
    where its collectives span more than one rank (gloo stages them
    through host memory, and a rank's capture cannot hold another
    rank's), None where it issues none (no mesh, or one rank)."""
    if mesh is None or mesh.size <= 1:
        return None
    import torch.distributed as dist
    return str(dist.get_backend()) if dist.is_initialized() else None


class EmptyGraph(RuntimeError):
    """A capture that ended with no node in its graph: a replay would run
    nothing."""


class _Seen:
    empty = False


@contextmanager
def empty_capture():
    """A block that ends a capture: torch's warning that the graph came
    out empty (its only word on it) is taken, not printed, and the
    yielded object's ``empty`` says, once the block has ended, whether
    it came. Other warnings pass on."""
    seen = _Seen()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield seen
    for w in caught:
        if "CUDA Graph is empty" in str(w.message):
            seen.empty = True
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


def _empty_detail(outputs, inputs) -> str:
    """What an empty capture's outputs were: how many, how many on the
    CPU, how many share storage with the step's inputs (a forward that
    only views its input launches nothing)."""
    outs = _tensors(outputs)
    held = {t.untyped_storage().data_ptr() for t in _tensors(inputs)}
    cpu = sum(t.device.type == "cpu" for t in outs)
    alias = sum(t.untyped_storage().data_ptr() in held for t in outs)
    return (f"the capture recorded no kernel on its stream ({len(outs)} "
            f"outputs: {cpu} on the CPU, {alias} sharing the inputs' "
            f"storage)")


def _reason_class(exc: BaseException) -> str:
    """A short class for a failed capture: ``empty_graph`` for a capture
    that recorded nothing, ``host_copy`` for a copy between host and card
    through pageable memory, ``host_sync`` for another operation CUDA
    refuses while a stream captures (a host read, a synchronisation),
    else the exception's type."""
    if isinstance(exc, EmptyGraph):
        return "empty_graph"
    msg = str(exc)
    if "Cannot copy between CPU and CUDA" in msg:
        return "host_copy"
    if "stream is capturing" in msg or "StreamCapture" in msg \
            or "capture" in msg and "not permitted" in msg:
        return "host_sync"
    return type(exc).__name__


class Step:
    """One signature of a :class:`StepGraphs`: its static ``inputs``, the
    body last bound, its graph (on a CUDA device, once captured) and
    outputs, and what the census and :meth:`StepGraphs.report` say of
    it."""

    def __init__(self, tag: str, sig: tuple, inputs: Any, desc: str):
        self.tag = tag
        self.sig = sig
        self.inputs = inputs
        self.desc = desc
        self.body: Optional[Callable] = None
        self.graph = None
        self.record: Optional[LaunchRecord] = None
        self.outputs = None
        self.key = None
        self.cache: Optional[str] = None
        self.error: Optional[str] = None
        self.captures = 0
        self.replays = 0


class StepGraphs:
    """The captured steps of one engine (or of one network's forward):
    their signatures, one capture stream and one private memory pool."""

    def __init__(self, device=None):
        #: the card (or the CPU) the steps run on; a set made without one
        #: takes the device of its first call (:meth:`bind`)
        self.device = None
        #: held around filling a step's inputs, running it and copying
        #: its outputs out
        self.lock = ordered_rlock("cuda_graphs.steps")
        self._steps: Dict[Tuple[str, tuple], Step] = {}
        self._stream = None
        self._pool = None
        if device is not None:
            self.bind(device)

    def bind(self, device) -> None:
        """Run the steps on ``device``, where the set has no device yet."""
        if self.device is None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device = device

    def step(self, tag: str, sig: tuple, make_inputs: Callable[[], Any],
             desc: Optional[str] = None) -> Step:
        """The step of (``tag``, ``sig``), its inputs made by
        ``make_inputs()`` the first time."""
        with self.lock:
            s = self._steps.get((tag, sig))
            if s is None:
                s = Step(tag, sig, make_inputs(), desc or str(sig)[:200])
                self._steps[(tag, sig)] = s
            return s

    def run(self, step: Step, make_body: Callable[[], Callable],
            key: tuple = (), eager: Optional[str] = None):
        """Run ``step`` on its current inputs and return its outputs: the
        graph's own after a replay, so the caller copies them out before
        it lets go of :attr:`lock`. ``make_body()`` gives the body to
        capture (or to run eagerly); it is asked for only when the step
        has none yet or was bound under another ``key``. With an
        ``eager`` reason the body runs eagerly, as ``eager:<reason>``."""
        with self.lock:
            if eager is not None:
                return self._eager(step, make_body(), f"eager:{eager}")
            if step.body is None:
                return self._materialize(step, make_body(), key)
            if not _same_key(step.key, key):
                if step.graph is not None:
                    return self._materialize(step, make_body(), key)
                step.key, step.body = key, make_body()
                step.captures += 1
            step.replays += 1
            if step.graph is None:
                return step.body()
            step.graph.replay()
            step.record.replay()
            return step.outputs

    def note(self, step: Step, eager: Optional[str] = None) -> None:
        """Record ``step``'s census event without running it
        (``warm_compile``), under the label its first run takes:
        ``eager:<eager>``, ``captured`` on a CUDA device, else ``eager``."""
        with self.lock:
            if step.cache is None:
                step.cache = (f"eager:{eager}" if eager is not None
                              else "captured" if self.device.type == "cuda"
                              else "eager")
                environment().record_compile((step.tag,) + step.sig,
                                             cache=step.cache)

    # -- capture -------------------------------------------------------------
    def _census(self, step: Step, label: str, seconds: float):
        kind = step.tag.split(":")[0]
        if step.cache is None:
            environment().record_compile((step.tag,) + step.sig, cache=label)
        step.cache = label
        observe_compile(kind, label, seconds)

    def _eager(self, step: Step, body: Callable, label: str):
        """An eager run of ``body`` for the caller's reason; the step's
        own graph, if it has one, stays for other callers."""
        t0 = time.perf_counter()
        out = body()
        if step.cache is None:
            self._census(step, label, time.perf_counter() - t0)
        step.replays += 1
        return out

    def _materialize(self, step: Step, body: Callable, key: tuple):
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            out, label = self._capture(step, body)
        else:
            out, label = body(), "eager"
            step.graph = None
        step.body, step.key = body, key
        step.captures += 1
        self._census(step, label, time.perf_counter() - t0)
        return out

    def _capture(self, step: Step, body: Callable):
        """Run ``body`` once on the capture stream (its outputs answer
        this call), then capture it. Returns (outputs, census label)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        stream = self._stream
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = body()
        cur.wait_stream(stream)
        for t in _tensors(out):
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        rec = LaunchRecord()
        err = None
        with _CAPTURE_LOCK, recording(rec, stream.cuda_stream), \
                torch.cuda.stream(stream):
            # a capture cannot hand cached blocks back to the card, so the
            # ones cached for other streams (the warm run's) go first, as
            # torch.cuda.graph does
            torch.cuda.empty_cache()
            # no collection inside the capture: it would destroy dead
            # engines' graphs, which CUDA refuses while a capture runs
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(pool=self._pool_handle(),
                                    capture_error_mode="thread_local")
            except Exception as e:  # noqa: BLE001 — reported below
                err = e
            else:
                try:
                    static = body()
                except Exception as e:  # noqa: BLE001 — reported below
                    err = e
                try:
                    with empty_capture() as seen:
                        graph.capture_end()
                except Exception as e:  # noqa: BLE001 — reported below
                    err = err or e
                else:
                    if seen.empty and err is None:
                        err = EmptyGraph(_empty_detail(static, step.inputs))
            finally:
                if collecting:
                    gc.enable()
        if err is not None:
            # the pool may still be recording: the next capture takes a
            # new one
            self._pool = None
            torch.cuda.synchronize(self.device)
            step.graph, step.record, step.outputs = None, None, None
            step.error = (f"{type(err).__name__}: "
                          f"{(str(err).splitlines() or [''])[0][:200]}")
            label = f"eager:{_reason_class(err)}"
            log.warning("step %s %s cannot be captured (%s); it runs "
                        "eagerly", step.tag, step.desc, step.error)
            return out, label
        step.graph, step.record, step.outputs = graph, rec, static
        step.error = None
        return out, "captured"

    def release(self) -> None:
        """Let go of every graph, its outputs and its private pool, and of
        the bodies (and the params they hold); the signatures' census and
        counts stay, and the next call of a signature captures again."""
        with self.lock:
            for s in self._steps.values():
                s.graph = s.outputs = s.body = s.key = None
            self._pool = None

    def _pool_handle(self):
        """The set's private memory pool: the one its graphs share, kept
        alive by them (a graph is replaced only by a new capture into the
        same pool), or a new one after a failed capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    # -- observability -------------------------------------------------------
    def report(self) -> List[Dict[str, Any]]:
        """One entry a signature: its tag and signature, ``cache``
        (``captured``, ``eager`` on the CPU, ``eager:<reason>``), captures
        and replays, the kernel launches a replay makes, and the error
        that kept it eager."""
        with self.lock:
            steps = list(self._steps.values())
        return [{"tag": s.tag, "signature": s.desc, "cache": s.cache,
                 "captures": s.captures, "replays": s.replays,
                 "launches": s.record.counts() if s.record else {},
                 "error": s.error}
                for s in sorted(steps, key=lambda s: (s.tag, s.desc))]


class PackedInputs:
    """Static step inputs as views of one int32 device buffer, filled from
    one host staging buffer (pinned on a CUDA device) by one copy a step.
    ``fields`` are ``(name, shape, dtype)``: int32, float32 (kept as its
    bits) or bool (kept as 0/1, read as int32)."""

    def __init__(self, device, fields: Sequence[Tuple[str, tuple, Any]]):
        device = torch.device(device)
        n = sum(math.prod(shape) for _, shape, _ in fields)
        cuda = device.type == "cuda"
        self.host = torch.zeros(max(n, 1), dtype=torch.int32,
                                pin_memory=cuda)
        self.buffer = torch.zeros(max(n, 1), dtype=torch.int32,
                                  device=device)
        self._np = self.host.numpy()
        self._f32 = self._np.view(np.float32)
        self._copied = torch.cuda.Event() if cuda else None
        self.views: Dict[str, torch.Tensor] = {}
        self._slots: Dict[str, Tuple[slice, Any]] = {}
        o = 0
        for name, shape, dtype in fields:
            size = math.prod(shape)
            view = self.buffer[o:o + size]
            if dtype == torch.float32:
                view = view.view(torch.float32)
            self.views[name] = view.view(shape)
            self._slots[name] = (slice(o, o + size), dtype)
            o += size

    def fill(self, values: Dict[str, Any]) -> torch.Tensor:
        """Write every field from ``values`` (arrays, or numbers wrapped
        to 32 bits) and copy the staging buffer to the device; returns
        the device buffer."""
        if self._copied is not None and not self._copied.query():
            self._copied.synchronize()   # the last copy still reads it
        for name, (sl, dtype) in self._slots.items():
            v = values[name]
            if dtype == torch.float32:
                self._f32[sl] = np.ravel(v)
            elif isinstance(v, (int, np.integer)):
                self._np[sl] = (int(v) + (1 << 31) & 0xFFFFFFFF) - (1 << 31)
            else:
                self._np[sl] = np.ravel(v)
        self.buffer.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.buffer

    def load(self, buffer: torch.Tensor) -> None:
        """Take the device buffer as it is (a sharded follower's copy of
        the leader's)."""
        self.buffer.copy_(buffer.reshape(-1))
