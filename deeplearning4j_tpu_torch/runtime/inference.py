"""Shape-bucketed inference engine with dynamic micro-batching.

Counterpart of the JAX package's ``runtime/inference.py`` (reference:
``org/deeplearning4j/parallelism/ParallelInference.java``, worker threads
plus ``batchLimit``/``queueLimit`` request coalescing).

- **bucket ladder**: incoming batches are zero-padded up the batch dim to
  the next bucket (default: powers of two up to ``max_batch``) and the
  padded rows are sliced off the result. Row-independent inference
  (every layer-API forward at ``training=False``) makes the sliced rows
  equal to an exact-shape run up to the order of f32 sums: on the card
  the dequant-matmul kernel picks its plan by M, so a row's bits may
  differ between buckets, and the port's tests hold padded against exact
  with ``allclose``.
- **warmup** runs the bucket set before traffic arrives.
- **dynamic micro-batching**: ``submit()`` returns a Future; a background
  thread coalesces concurrent requests within a ``max_delay_ms`` /
  ``max_batch`` window into ONE padded dispatch and resolves each future
  with its unpadded slice, brought to the host.

The JAX package buckets to bound XLA compiles; the port's ladder bounds
the CUDA graphs it captures: ``captured_dispatch`` records each
first-seen (tag, padded input signature) in the environment's census and
replays one graph of it from then on (``runtime/cuda_graphs.py``). The
same bucketing rides the direct ``MultiLayerNetwork.output()`` and
``ComputationGraph.output()`` paths through ``maybe_pad_tree``.

A ``MultiLayerNetwork``, a ``ComputationGraph`` or a ``SameDiff`` graph
(with ``outputs=[...]``, a placeholder dict a request) is served.

**Sharded predict** (``mesh=``, ``param_spec=``): every rank of the mesh
builds the engine over the same model. The adapter stores the params
under ``param_spec`` (by default ``naive_param_spec`` over ``model``)
and gathers them at each dispatch; a padded bucket whose rows divide the
``data`` size is split over ``data`` and its outputs all-gathered, any
other bucket runs whole on every rank. The mesh's first rank leads: each
of its dispatches (``infer``, ``submit``, ``warmup``) goes to the other
ranks as a record first, whose channel thread runs the same dispatch
(``runtime/sharded.py``); ``close()`` on the leader ends the followers'
engine. ``infer``/``submit`` on a follower raise. A dispatch over a mesh
of more than one rank runs eagerly, its collectives crossing ranks
(``eager:<backend>`` in ``stats()["graphs"]``).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import faults
from ..common.environment import environment
from ..common.locks import ordered_condition, ordered_lock
from ..common.metrics import linear_buckets, registry
from ..common.tracing import (current_context, record_disposition, span,
                              tracer, use_context)
from . import cuda_graphs, sharded

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# bucket ladder + padding primitives
# ---------------------------------------------------------------------------

def bucket_ladder(max_batch: int,
                  buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The sorted bucket set: explicit ``buckets`` if given, else powers
    of two up to (and always including) ``max_batch``."""
    if buckets:
        out = sorted({int(b) for b in buckets if int(b) > 0})
        if not out:
            raise ValueError("bucket ladder is empty")
        return tuple(out)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


def bucket_for(n: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds the ladder."""
    for b in ladder:
        if b >= n:
            return b
    return None


def pad_batch(x: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the leading (batch) dim of ``x`` up to ``target`` rows."""
    n = x.shape[0]
    if n == target:
        return x
    return torch.cat([x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])


def _tree_leaves(tree) -> list:
    """Leaves of a dict/list/tuple nest (dict keys sorted; None is an
    empty subtree), as ``jax.tree_util.tree_leaves`` orders them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    return [tree]


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return None if tree is None else "*"


def _leading_dim(tree) -> Optional[int]:
    """Shared leading dim of every array leaf, or None if leaves disagree
    / any leaf is unbatched (scalar) / there are no leaves."""
    leaves = _tree_leaves(tree)
    if not leaves:
        return None
    n = None
    for leaf in leaves:
        if getattr(leaf, "ndim", 0) < 1:
            return None
        if n is None:
            n = leaf.shape[0]
        elif leaf.shape[0] != n:
            return None
    return n


def maybe_pad_tree(tree, *, training: bool = False, mesh=None):
    """Environment-gated bucket padding for the direct ``output()`` paths.

    Returns (padded_tree, (n, bucket)) when bucketing applies, else
    (tree, None): disabled flag, training mode (padded rows would enter
    batch statistics), a mesh, mismatched/absent leading dims, batch
    already on a bucket, or batch above the ladder (exact shape in all
    cases)."""
    env = environment()
    if training or mesh is not None or not env.inference_bucketing():
        return tree, None
    n = _leading_dim(tree)
    if n is None or n == 0:
        return tree, None
    b = bucket_for(n, bucket_ladder(env.inference_max_batch()))
    if b is None or b == n:
        return tree, None
    return _tree_map(lambda leaf: pad_batch(leaf, b), tree), (n, b)


def slice_batch(outputs: Sequence[Any], n: int, bucket: int) -> List[Any]:
    """Drop padded rows: slice every output whose leading dim is the
    bucket (batch-shaped); leave scalars / non-batch outputs untouched."""
    return [o[:n] if getattr(o, "ndim", 0) >= 1 and o.shape[0] == bucket
            else o for o in outputs]


def _dtype_name(x) -> str:
    """``"float32"``, ``"bfloat16"``, ... for a tensor or an array: the
    JAX package's spelling, so both sides read one manifest."""
    return str(x.dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a warmup signature")
    return dt


# ---------------------------------------------------------------------------
# the dispatch census
# ---------------------------------------------------------------------------

def _signature(data) -> Tuple:
    return (_structure(data),
            tuple((tuple(leaf.shape), _dtype_name(leaf))
                  if hasattr(leaf, "shape") else f"py:{type(leaf).__name__}"
                  for leaf in _tree_leaves(data)))


def counted_dispatch(fn: Callable, tag: str,
                     seen: Optional[set] = None) -> Callable:
    """``fn`` wrapped with the dispatch census: each new input signature
    records one event (``Environment.record_compile``) and then runs
    ``fn`` eagerly, as every later call does. The port's counterpart of
    the JAX package's ``counted_jit``, which counts XLA compiles; its
    capturing form, which replays one CUDA graph a signature, is
    :func:`captured_dispatch` (``runtime/cuda_graphs.py``).

    The signature is computed from ``args[1:]``: by convention the first
    argument is the parameter tree, whose shapes change only on re-init.
    Python-scalar leaves count by type, tensors by shape and dtype (not
    by device). ``seen``, the signatures already counted, may be shared
    by the wrappers of one step built afresh on each call (the fit
    loop's), as the JAX package's one cached jit holds them.
    ``wrapped.note(*args)`` counts ``args``' signature without running
    ``fn`` (``warm_compile``)."""
    seen = set() if seen is None else seen

    def note(*args) -> bool:
        sig = _signature(args[1:])
        if sig in seen:
            return False
        seen.add(sig)
        return environment().record_compile((tag,) + sig)

    def wrapped(*args):
        note(*args)
        return fn(*args)

    wrapped.note = note
    return wrapped


def eager_dispatch(fn: Callable, tag: str, graphs, reason: str) -> Callable:
    """``fn`` under the census of ``graphs`` (a
    :class:`~.cuda_graphs.StepGraphs`), always run eagerly as
    ``eager:<reason>``: a step whose host decisions or collectives keep
    it out of a CUDA graph. One event per new signature (from
    ``args[1:]``, as :func:`counted_dispatch`'s), and an entry in
    ``graphs.report()``."""
    def wrapped(*args):
        step = graphs.step(tag, _signature(args[1:]), lambda: None)
        return graphs.run(step, lambda: lambda: fn(*args), eager=reason)
    return wrapped


def _param_key(params) -> tuple:
    """What a captured forward over ``params`` holds: each leaf (by
    identity; a quantized leaf with its ``q`` and ``scale``) with the
    address of its storage, then the ``matmul_precision`` in force."""
    out: list = []
    for leaf in _tree_leaves(params):
        out.append(leaf)
        for t in (leaf, getattr(leaf, "q", None),
                  getattr(leaf, "scale", None)):
            if isinstance(t, torch.Tensor):
                out.append(t.data_ptr())
    out.append(environment().matmul_precision())
    return tuple(out)


def captured_dispatch(fn: Callable, tag: str, device) -> Callable:
    """:func:`counted_dispatch`'s capturing form, with its census (one
    event per ``(tag, signature)``): each input signature gets static
    buffers on ``device`` and one CUDA graph of ``fn(params, *buffers)``,
    replayed by every later call (``runtime/cuda_graphs.py``; on the CPU
    the same body runs eagerly on the same buffers). A graph is keyed on
    the identity of the param tensors and the precision in force
    (:func:`_param_key`), so a call after ``fit``,
    ``set_params``, a reload or a precision change captures again. A
    signature with a host value among its inputs (a Python scalar) runs
    eagerly, as ``eager:host_value``, and so does a call given an
    ``eager`` reason (``eager:<reason>``). Outputs come back as copies.
    ``wrapped.graphs`` is the :class:`~.cuda_graphs.StepGraphs`."""
    graphs = cuda_graphs.StepGraphs(device)

    def wrapped(*args, eager: Optional[str] = None):
        params, data = args[0], args[1:]
        sig = _signature(data)
        leaves = _tree_leaves(data)
        with graphs.lock:
            if not all(isinstance(x, torch.Tensor) for x in leaves):
                step = graphs.step(tag, sig, lambda: None)
                return graphs.run(step, lambda: lambda: fn(*args),
                                  eager="host_value")
            step = graphs.step(tag, sig, lambda: _tree_map(
                lambda x: torch.empty_like(x, device=graphs.device), data))
            for buf, x in zip(_tree_leaves(step.inputs), leaves):
                buf.copy_(x)
            # the body holds the inputs, not the step (a cycle would keep
            # a dropped network's graphs until a collection)
            ins = step.inputs
            out = graphs.run(
                step, lambda: lambda: fn(params, *ins),
                _param_key(params), eager=eager)
            return _tree_map(lambda t: t.clone() if isinstance(
                t, torch.Tensor) else t, out)

    wrapped.graphs = graphs
    return wrapped


def captured_train_step(fn: Callable, tag: str,
                        n_steps: Optional[int] = None,
                        reason: Optional[str] = None) -> Callable:
    """A model-level train step ``fn(params, opt_state, batch, iteration)
    -> (params, opt_state, loss)``, which writes the params and the
    optimizer state in place, under the census (one event per ``(tag,
    signature)`` of its opt_state, batch and iteration, as
    :func:`counted_dispatch`) with one CUDA graph a signature.

    The caller's params and state are the graph's static buffers: a
    graph is keyed on each leaf's identity and storage and on the
    precision in force (:func:`_param_key`), so a call on other tensors
    captures again. The batch is copied into static buffers per
    signature, and the iteration into a 0-d int64 tensor before each
    run, so its value is never baked in; ``fn`` sees a tensor iteration
    on every path (the Adam bias correction then rounds in f32, as under
    ``jit``, captured or eager alike). With ``n_steps`` one step is
    captured and replayed ``n_steps`` times at iterations
    ``iteration + i``, each loss copied into a device
    ``losses[n_steps]`` with no host sync. The returned loss is a copy.

    Eager: a batch with a host value among its leaves
    (``eager:host_value``, run on the caller's batch), every call of a
    step made with a ``reason`` (a mesh: ``eager:<backend>``), and a call
    given ``eager=<reason>``, which runs the same body on the same
    buffers (the reference a replay is held against). On the CPU the
    body runs eagerly on the same buffers. ``wrapped.graphs`` is the
    :class:`~.cuda_graphs.StepGraphs`; dropping the step frees its graphs
    and pool (the bodies hold their buffers, not the step)."""
    graphs = cuda_graphs.StepGraphs()

    def wrapped(params, opt_state, batch, iteration,
                eager: Optional[str] = None):
        sig = _signature((opt_state, batch, iteration))
        leaves = _tree_leaves(batch)
        dev = _tree_leaves(params)[0].device
        why = reason or (None if all(isinstance(x, torch.Tensor)
                                     for x in leaves) else "host_value")
        with graphs.lock:
            graphs.bind(dev)
            if why is not None:
                step = graphs.step(tag, sig, lambda: None)

                def run(i):
                    it = torch.as_tensor(iteration + i, dtype=torch.int64,
                                         device=dev)
                    return graphs.run(step, lambda: lambda: fn(
                        params, opt_state, batch, it)[2], eager=why)
            else:
                step = graphs.step(tag, sig, lambda: {
                    "batch": _tree_map(
                        lambda x: torch.empty_like(x, device=dev), batch),
                    "it": torch.zeros((), dtype=torch.int64, device=dev)})
                ins = step.inputs
                for buf, x in zip(_tree_leaves(ins["batch"]), leaves):
                    buf.copy_(x)
                key = _param_key([params, opt_state])

                def make_body():
                    return lambda: fn(params, opt_state, ins["batch"],
                                      ins["it"])[2]

                def run(i):
                    ins["it"].fill_(iteration + i)
                    return graphs.run(step, make_body, key, eager=eager)
            if n_steps is None:
                return params, opt_state, run(0).clone()
            losses = None
            for i in range(n_steps):
                loss = run(i)
                if losses is None:
                    losses = torch.empty((n_steps,), dtype=loss.dtype,
                                         device=loss.device)
                losses[i].copy_(loss)
            return params, opt_state, losses

    wrapped.graphs = graphs
    return wrapped


def release_captured(fns) -> None:
    """Let go of the graphs (and the params they hold) of every
    :func:`captured_dispatch` among ``fns``: a model whose params were
    replaced calls it, so the old params and the graphs' pool are freed
    then, not at its next predict."""
    for fn in fns:
        graphs = getattr(fn, "graphs", None)
        if graphs is not None:
            graphs.release()


# ---------------------------------------------------------------------------
# frontend adapters
# ---------------------------------------------------------------------------

def _unwrap(x) -> torch.Tensor:
    """A request input as a tensor (an ``NDArray``'s own, a tensor as it
    is, anything else through numpy). float64 and int64 narrow to
    float32 and int32, as the JAX package's ``jnp.asarray`` does with
    x64 off, so both sides see one signature."""
    if hasattr(x, "torch") and callable(x.torch):
        t = x.torch()
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        return t.float()
    if t.dtype == torch.int64:
        return t.int()
    return t


def _model_device(model) -> torch.device:
    """The model's device, with its index: a bare ``"cuda"`` means the
    card current on the constructing thread, which the batcher thread
    (starting on card 0) must make current too."""
    dev = getattr(model, "device", None)
    dev = torch.device(dev) if dev is not None else torch.device("cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Params:
    """The params an adapter runs with: the model's own, or this rank's
    shards under a spec (:meth:`shard`), gathered at each use."""

    placed = None

    def own(self):
        return self.model._params

    def shard(self, mesh, spec):
        from ..common.mesh import shard_params
        self.placed = shard_params(mesh, self.own(), spec)

    def live(self):
        if self.placed is None:
            return self.own()
        from ..common.mesh import gather_tree
        return gather_tree(self.placed)


class _MultiLayerAdapter(_Params):
    """MultiLayerNetwork: one input array -> one output NDArray."""

    def __init__(self, model):
        self.model = model

    def inputs_of(self, request) -> List[torch.Tensor]:
        return [_unwrap(request)]

    def run(self, inputs: List[torch.Tensor],
            eager: Optional[str] = None) -> List[torch.Tensor]:
        return [self.model._output_fn(False)(self.live(), inputs[0],
                                             eager=eager)]

    def graphs(self):
        return self.model._output_fn(False).graphs

    def package(self, outputs: List[torch.Tensor]):
        from ..ndarray.ndarray import NDArray
        return NDArray(outputs[0])


class _GraphAdapter(_Params):
    """ComputationGraph: an array, a list (in ``conf.inputs`` order) or a
    name -> array dict -> a list of NDArrays ordered as
    ``conf.outputs``."""

    def __init__(self, model):
        self.model = model
        self.input_names = list(model.conf.inputs)

    def inputs_of(self, request) -> List[torch.Tensor]:
        if isinstance(request, dict):
            return [_unwrap(request[n]) for n in self.input_names]
        if not isinstance(request, (list, tuple)):
            request = [request]
        if len(request) != len(self.input_names):
            raise ValueError(f"graph expects {len(self.input_names)} inputs, "
                             f"got {len(request)}")
        return [_unwrap(x) for x in request]

    def run(self, inputs: List[torch.Tensor],
            eager: Optional[str] = None) -> List[torch.Tensor]:
        ind = {n: x for n, x in zip(self.input_names, inputs)}
        return list(self.model._output_fn(False)(self.live(), ind,
                                                 eager=eager))

    def graphs(self):
        return self.model._output_fn(False).graphs

    def package(self, outputs: List[torch.Tensor]):
        from ..ndarray.ndarray import NDArray
        return [NDArray(o) for o in outputs]


class _SameDiffAdapter(_Params):
    """SameDiff: a placeholder dict -> {name: NDArray} for ``outputs``.
    The graph's own callable (``make_function``) moves the placeholders
    to its device and runs under ``no_grad`` / ``full_f32()``."""

    def __init__(self, model, outputs: Sequence[Any]):
        if not outputs:
            raise ValueError("wrapping a SameDiff requires outputs=[...] "
                             "(the variable names to serve)")
        self.model = model
        self.out_names = [o.name if hasattr(o, "name") else o
                          for o in outputs]
        self.ph_names: Optional[List[str]] = None
        self._fn = None

    def inputs_of(self, request) -> List[torch.Tensor]:
        if not isinstance(request, dict):
            raise TypeError("SameDiff requests must be placeholder dicts")
        if self.ph_names is None:
            self.ph_names = sorted(request)
        if sorted(request) != self.ph_names:
            raise ValueError(f"placeholder keys {sorted(request)} != "
                             f"{self.ph_names} of the first request")
        return [_unwrap(request[n]) for n in self.ph_names]

    def run(self, inputs: List[torch.Tensor],
            eager: Optional[str] = None) -> List[torch.Tensor]:
        sd = self.model
        ph = {n: x for n, x in zip(self.ph_names, inputs)}
        if any(node.needs_key for node in sd._ops.values()):
            fn = self._fn = sd.make_function(
                self.out_names, tuple(self.ph_names), with_rng=True)
            return list(fn(self.live(), ph, sd._rng_call_key(),
                           eager=eager))
        fn = self._fn = sd.make_function(self.out_names,
                                         tuple(self.ph_names))
        return list(fn(self.live(), ph, eager=eager))

    def graphs(self):
        return getattr(self._fn, "graphs", None)

    def package(self, outputs: List[torch.Tensor]):
        from ..ndarray.ndarray import NDArray
        return {n: NDArray(o) for n, o in zip(self.out_names, outputs)}

    def own(self):
        return self.model._arrays


def _make_adapter(model, outputs):
    # duck-typed, as the JAX package's, so runtime never imports nn/
    if hasattr(model, "make_function") and hasattr(model, "_vars"):
        return _SameDiffAdapter(model, outputs or [])
    if hasattr(model, "conf") and hasattr(getattr(model.conf, "outputs", None),
                                          "__iter__") and hasattr(
                                              model, "_order"):
        return _GraphAdapter(model)
    if hasattr(model, "layers") and hasattr(model, "_output_fn"):
        return _MultiLayerAdapter(model)
    raise TypeError(f"cannot serve a {type(model).__name__}; expected "
                    "MultiLayerNetwork, ComputationGraph, or SameDiff")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class EngineClosedError(RuntimeError):
    """Raised by ``submit()``/``infer()``/``generate()`` once the engine
    is draining or closed: late requests fail fast with a signal the
    caller can act on (the serving registry retries them against the
    engine that replaced this one)."""


class PoisonRequestError(RuntimeError):
    """A request that failed its coalesced dispatch AND its one isolated
    re-dispatch: the failure follows the request, not the batch, so it is
    quarantined (HTTP 422 with trace id). Carries the underlying dispatch
    error as ``cause``."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


#: error types a device-side fault raises (``torch.AcceleratorError``
#: where this PyTorch has it)
_DEVICE_ERRORS = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                                   getattr(torch.cuda, "CudaError", None))
                       if isinstance(t, type))
_DEVICE_FAULT_TEXT = ("CUDA error", "CUDA launch failed", "CUBLAS_STATUS",
                      "cuDNN error", "CUDNN_STATUS")


def is_device_fault(exc: BaseException) -> bool:
    """True for a card-side failure (illegal address, launch failure, a
    library's status): the CUDA context may be poisoned for every later
    request, and the fault says nothing about the request that met it."""
    if _DEVICE_ERRORS and isinstance(exc, _DEVICE_ERRORS):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and any(
        t in msg for t in _DEVICE_FAULT_TEXT)


def _to_host(outs: List[Any]) -> List[Any]:
    """Outputs on the host: one copy each, which waits for the card, so a
    resolved future never hands out a tensor still being written."""
    return [o.cpu() if isinstance(o, torch.Tensor) and o.device.type != "cpu"
            else o for o in outs]


class _Request:
    __slots__ = ("inputs", "n", "sig", "future", "deadline", "ctx",
                 "t_submit")

    def __init__(self, inputs, sig, future, deadline=None, ctx=None):
        self.inputs = inputs
        self.n = inputs[0].shape[0]
        self.sig = sig
        self.future = future
        self.deadline = deadline  # monotonic instant, or None
        # the submitter's trace context: the batcher thread emits this
        # request's spans under it (contextvars don't cross threads)
        self.ctx = ctx
        self.t_submit = time.perf_counter()

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline


class InferenceEngine:
    """Serving front-end over a layer-API network or a SameDiff graph.

    - ``infer(request)``: synchronous bucketed inference (pads to the
      bucket, slices padded rows off; batches above ``max_batch`` are
      chunked so the shape census bound still holds). Results stay on
      the model's device.
    - ``warmup(example[, batch_sizes])``: run the buckets ahead of
      traffic.
    - ``submit(request) -> Future``: enqueue for the dynamic
      micro-batcher. A background thread (on the model's device)
      coalesces concurrent requests within the ``max_delay_ms`` /
      ``max_batch`` window into one padded dispatch; results come back
      on the host.

    Knob mapping from the reference ParallelInference: ``batchLimit`` ->
    ``max_batch``; ``InferenceMode.BATCHED`` -> ``submit()``;
    ``queueLimit`` has no analog (``max_delay_ms`` bounds latency).
    """

    def __init__(self, model, *, max_batch: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_delay_ms: float = 2.0,
                 outputs: Optional[Sequence[Any]] = None,
                 manifest_path: Optional[str] = None,
                 mesh=None, param_spec=None):
        self.model = model
        self._adapter = _make_adapter(model, outputs)
        self.device = _model_device(model)
        # sharded predict (module docstring); mesh=None: one process
        self.mesh = mesh
        self.param_spec = param_spec
        self._data_size = 1
        if mesh is not None:
            from ..common.mesh import DATA, validate_mesh
            validate_mesh(mesh, required=(DATA,))
            self._data_size = int(mesh.shape[DATA])
            self._adapter.shard(mesh, param_spec)
        self.max_batch = int(max_batch if max_batch is not None
                             else environment().inference_max_batch())
        self.ladder = bucket_ladder(self.max_batch, buckets)
        self.max_batch = self.ladder[-1]
        self.max_delay_ms = float(max_delay_ms)
        # warmup guard + traffic-shape manifest: _warmed holds
        # (bucket, input-sig) keys already run by warmup, _warming the
        # in-flight ones (concurrent/repeated warmups wait instead of
        # running twice); _observed accumulates the shapes live traffic
        # dispatched, persisted when manifest_path is set so a restarted
        # server replays yesterday's buckets before taking traffic
        self._warm_lock = ordered_lock("inference.warm")
        self._warmed: set = set()
        self._warming: Dict[Any, threading.Event] = {}
        self.manifest_path = manifest_path
        self._observed: Dict[Tuple, set] = {}
        # micro-batcher state
        self._cv = ordered_condition("inference.batcher")
        self._pending: List[_Request] = []
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        # lifecycle: draining refuses new requests but is reversible via
        # start() (the registry parks retired versions this way so a
        # rollback re-admits at once); closed is permanent
        self._draining = False
        self._closed = False
        self._inflight = 0  # synchronous infer() calls currently running
        # resilience: the supervised batcher's restart budget state and
        # the watchdog-readable in-flight dispatch timestamp
        self._worker_dead = False
        self._dispatch_started_at: Optional[float] = None
        # stats
        self._lock = ordered_lock("inference.stats")
        self._stats = {"requests": 0, "dispatches": 0, "rows_real": 0,
                       "rows_padded": 0, "coalesced": 0,
                       "bucket_dispatches": {}}
        # telemetry: registry families created once, per-bucket children
        # cached so the dispatch path pays one dict lookup + observe
        self._reg = registry()
        lat = self._reg.histogram(
            "dl4j_inference_latency_seconds",
            "Per-bucket dispatch latency of the inference engine",
            labels=("bucket",))
        pad = self._reg.histogram(
            "dl4j_inference_padding_ratio",
            "Fraction of dispatched rows that were bucket padding",
            labels=("bucket",), buckets=linear_buckets(0.0, 0.05, 20))
        self._m_latency = {b: lat.labels(bucket=b) for b in self.ladder}
        self._m_padding = {b: pad.labels(bucket=b) for b in self.ladder}
        self._m_requests = self._reg.counter(
            "dl4j_inference_requests_total",
            "Requests accepted by infer()/submit()")
        self._m_queue = self._reg.gauge(
            "dl4j_inference_queue_depth",
            "Requests waiting in the submit() micro-batcher queue")
        self._m_coalesce = self._reg.histogram(
            "dl4j_inference_coalesce_size",
            "Requests coalesced into one micro-batched dispatch",
            buckets=[float(1 << i) for i in range(11)])
        self._m_expired = self._reg.counter(
            "dl4j_inference_deadline_expired_total",
            "submit() requests whose deadline expired before dispatch")
        self._m_restarts = self._reg.counter(
            "dl4j_engine_restarts_total",
            "Supervised engine worker-thread restarts after a crash",
            labels=("engine",)).labels(engine="inference")
        self._m_quarantined = self._reg.counter(
            "dl4j_quarantined_requests_total",
            "Poison requests quarantined after a failed isolated retry")
        self._m_isolated = self._reg.counter(
            "dl4j_inference_isolated_retries_total",
            "Riders of a failed coalesced dispatch re-dispatched "
            "individually, by outcome", labels=("outcome",))
        # last: a follower may replay the leader's dispatches from here on
        self._link = sharded.StepLink.for_mesh(mesh, self._replay)

    # -- the mesh ----------------------------------------------------------
    def _is_follower(self) -> bool:
        return self._link is not None and not self._link.is_leader

    def _run(self, padded: List[torch.Tensor]) -> List[torch.Tensor]:
        """The adapter over a padded batch: as it is without a mesh, else
        on this rank's part of the mesh, after the record on a leader."""
        if self.mesh is None:
            return self._adapter.run(padded)
        if self._link is None:
            return self._sharded_run(padded)
        names = json.dumps(getattr(self._adapter, "ph_names", None) or [])
        record = [torch.tensor(list(names.encode()), dtype=torch.uint8)]
        return self._link.call(sharded.PREDICT, record + list(padded),
                               lambda: self._sharded_run(padded))

    def _sharded_run(self, padded: List[torch.Tensor]) -> List[torch.Tensor]:
        """One dispatch on this rank: the rows over ``data`` where the
        bucket divides, the outputs all-gathered; else the whole bucket."""
        from ..common.mesh import DATA, P, local_slice
        from ..parallel.collectives import all_gather_raw
        split = self._data_size > 1 and \
            padded[0].shape[0] % self._data_size == 0
        if split:
            padded = [local_slice(x, self.mesh, P(DATA)) for x in padded]
        outs = self._adapter.run(padded,
                                 eager=cuda_graphs.mesh_reason(self.mesh))
        if split:
            outs = [all_gather_raw(o, DATA, self.mesh, dim=0) for o in outs]
        return outs

    def _replay(self, kind, t):
        """(Follower) one of the leader's dispatches: its record holds the
        placeholder names a SameDiff graph needs (UTF-8 JSON), then the
        padded batch."""
        if kind != sharded.PREDICT:
            raise RuntimeError(f"unknown predict step record {kind}")
        names = json.loads(bytes(t[0].cpu().tolist()).decode())
        if names:
            self._adapter.ph_names = names
        self._sharded_run(t[1:])

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """(Follower) wait until the leader closed this engine; True once
        it has."""
        return self._link is None or self._link.done.wait(timeout_s)

    def _on_device(self):
        """Make the model's card current on the calling thread (a new
        thread starts on card 0)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # -- core dispatch ---------------------------------------------------
    def _dispatch(self, inputs: List[torch.Tensor], n: int,
                  span_attrs: Optional[Dict[str, Any]] = None
                  ) -> List[torch.Tensor]:
        """Pad ``inputs`` (shared leading dim n <= max_batch) to the
        bucket, run, slice the padded rows back off. The dispatch span
        inherits any active trace context; ``span_attrs`` lets the
        micro-batcher stamp the coalesced riders' trace_ids onto it."""
        b = bucket_for(n, self.ladder)
        if faults.active():
            faults.check("engine.dispatch", inputs=inputs, rows=n, bucket=b)
        padded = [pad_batch(x, b) for x in inputs]
        self._dispatch_started_at = time.monotonic()  # watchdog-readable
        try:
            if self._reg.enabled:
                ctx = current_context()
                t0 = time.perf_counter()
                with span("inference/dispatch", bucket=b, rows=n,
                          **(span_attrs or {})):
                    outs = self._run(padded)
                lat = self._m_latency.get(b)
                if lat is not None:
                    # tail observations carry the request's trace_id as an
                    # exemplar, linking the histogram back to /debug/trace
                    lat.observe(time.perf_counter() - t0,
                                exemplar=ctx.trace_id if ctx else None)
                    self._m_padding[b].observe((b - n) / b)
            else:
                outs = self._run(padded)
        finally:
            self._dispatch_started_at = None
        with self._lock:
            s = self._stats
            s["dispatches"] += 1
            s["rows_real"] += n
            s["rows_padded"] += b - n
            s["bucket_dispatches"][b] = s["bucket_dispatches"].get(b, 0) + 1
        self._record_observed(inputs, b)
        return slice_batch(outs, n, b)

    def _dispatch_chunked(self, inputs: List[torch.Tensor],
                          n: int) -> List[torch.Tensor]:
        if n <= self.max_batch:
            return self._dispatch(inputs, n)
        pieces = []
        for lo in range(0, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            pieces.append(self._dispatch([x[lo:hi] for x in inputs], hi - lo))
        out = []
        for parts in zip(*pieces):
            # outputs that carried the batch dim were per-chunk sliced;
            # concatenate those, keep non-batch outputs from the last chunk
            # (all chunks agree on them only for row-independent nets,
            # which is the contract of this engine)
            sliced = all(getattr(p, "ndim", 0) >= 1
                         and p.shape[0] == min(self.max_batch,
                                               n - i * self.max_batch)
                         for i, p in enumerate(parts))
            out.append(torch.cat(parts, 0) if sliced else parts[-1])
        return out

    def _refuse_if_closed(self):
        """Raise ``EngineClosedError`` once the engine is draining, closed
        or dead (call with ``_cv`` held)."""
        if self._draining or self._closed or self._worker_dead:
            raise EngineClosedError(
                "InferenceEngine is "
                + ("closed" if self._closed else
                   "draining" if self._draining else
                   "dead (worker restart budget exhausted)")
                + "; it no longer accepts requests")

    def _refuse_on_follower(self):
        if self._is_follower():
            raise RuntimeError(
                "a follower rank of a sharded InferenceEngine takes no "
                "requests: they go to the mesh's leader (rank "
                f"{self._link.leader_rank})")

    def infer(self, request):
        """Synchronous bucketed inference for one request."""
        self._refuse_on_follower()
        with self._cv:
            self._refuse_if_closed()
            self._inflight += 1
        try:
            inputs = self._adapter.inputs_of(request)
            n = _leading_dim(inputs)
            if n is None:
                raise ValueError(
                    "request inputs must share a leading batch dim")
            with self._lock:
                self._stats["requests"] += 1
            self._m_requests.inc()
            return self._adapter.package(self._dispatch_chunked(inputs, n))
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    __call__ = infer

    # -- warmup + manifest -------------------------------------------------
    @staticmethod
    def _input_sig(inputs: Sequence[Any]) -> Tuple:
        """Trailing (feature) shapes + dtypes: what identifies a traffic
        shape independent of its batch bucket."""
        return tuple((tuple(int(d) for d in x.shape[1:]), _dtype_name(x))
                     for x in inputs)

    def _record_observed(self, inputs: Sequence[Any], bucket: int):
        """Remember that live traffic exercised (sig, bucket); persist to
        the manifest file when one is configured (new keys only: the hot
        path pays a set lookup per dispatch)."""
        sig = self._input_sig(inputs)
        with self._warm_lock:
            buckets = self._observed.setdefault(sig, set())
            if bucket in buckets:
                return
            buckets.add(bucket)
        if self.manifest_path:
            try:
                self.save_manifest(self.manifest_path)
            except OSError as e:
                log.warning("warmup manifest write to %s failed (%s)",
                            self.manifest_path, e)

    def save_manifest(self, path: Optional[str] = None) -> str:
        """Write the observed bucket/shape/dtype keys as JSON (atomic),
        in the JAX package's format. A restarted server hands the file to
        ``warmup()`` to replay yesterday's shapes before taking
        traffic."""
        path = path or self.manifest_path
        if not path:
            raise ValueError("no manifest path given or configured")
        with self._warm_lock:
            entries = [{"inputs": [{"shape": list(s), "dtype": d}
                                   for s, d in sig],
                        "buckets": sorted(int(b) for b in buckets)}
                       for sig, buckets in sorted(self._observed.items())]
        doc = {"version": 1, "max_batch": self.max_batch,
               "entries": entries}
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_manifest(path: str) -> List[dict]:
        """Parse a warmup manifest; malformed files return [] with a
        warning (a stale manifest must never block serving startup)."""
        try:
            with open(path, "r") as f:
                doc = json.load(f)
            entries = []
            for e in doc.get("entries", []):
                inputs = [(tuple(int(d) for d in i["shape"]), str(i["dtype"]))
                          for i in e["inputs"]]
                buckets = [int(b) for b in e["buckets"]]
                if buckets:
                    entries.append({"inputs": inputs, "buckets": buckets})
            return entries
        except Exception as e:
            log.warning("warmup manifest %s unreadable (%s: %s); skipping "
                        "replay", path, type(e).__name__, e)
            return []

    def observed_entries(self) -> List[dict]:
        """The live-traffic manifest in ``load_manifest`` format, without
        touching disk: the in-process handoff a serving registry uses to
        warm an incoming model version with the shapes the outgoing
        version served."""
        with self._warm_lock:
            return [{"inputs": [(tuple(int(d) for d in s), str(dt))
                                for s, dt in sig],
                     "buckets": sorted(int(b) for b in buckets)}
                    for sig, buckets in sorted(self._observed.items())]

    def warmup(self, example=None,
               batch_sizes: Optional[Sequence[int]] = None,
               manifest: Optional[str] = None,
               workers: Optional[int] = None,
               entries: Optional[List[dict]] = None) -> List[int]:
        """Run each bucket once before traffic arrives, so that every
        dispatch shape of the ladder is in the census. Returns the sorted
        buckets warmed.

        ``example`` is any valid request (only its trailing feature shapes
        and dtypes matter). With ``batch_sizes``, only the buckets those
        sizes map to run; default is the whole ladder. With
        ``example=None``, shapes are replayed from ``entries``
        (``load_manifest``/``observed_entries`` format: the hot-swap
        handoff from a live predecessor engine) or from ``manifest`` (or
        the engine's ``manifest_path``): the restart flow.

        Idempotent and re-entrant: a (bucket, shape) pair already warmed,
        or being warmed by a concurrent call, runs once; late callers
        wait for it. The buckets run one after another: the JAX package
        compiles them on a pool of ``workers`` threads, but an eager
        dispatch compiles nothing to overlap, so the port takes
        ``workers`` for the same signature and ignores it. On a follower
        of a sharded engine it runs nothing: the leader's warmup
        dispatches reach it as records."""
        if self._is_follower():
            return []
        jobs: List[Tuple[int, Tuple]] = []  # (bucket, input-sig)
        if example is not None:
            sig = self._input_sig(self._adapter.inputs_of(example))
            if batch_sizes is not None:
                todo = sorted({bucket_for(min(int(s), self.max_batch),
                                          self.ladder)
                               for s in batch_sizes})
            else:
                todo = list(self.ladder)
            jobs = [(b, sig) for b in todo]
        else:
            if entries is None:
                path = manifest or self.manifest_path
                if not path or not os.path.exists(path):
                    return []
                entries = self.load_manifest(path)
            for e in entries:
                sig = tuple((tuple(int(d) for d in s), str(dt))
                            for s, dt in e["inputs"])
                for b in e["buckets"]:
                    b = bucket_for(min(int(b), self.max_batch), self.ladder)
                    jobs.append((b, sig))
            jobs = sorted(set(jobs))
        if not jobs:
            return []

        claimed: List[Tuple[int, Tuple, threading.Event]] = []
        wait_for: List[threading.Event] = []
        with self._warm_lock:
            for b, sig in jobs:
                key = (b, sig)
                if key in self._warmed:
                    continue
                ev = self._warming.get(key)
                if ev is not None:
                    wait_for.append(ev)
                    continue
                ev = threading.Event()
                self._warming[key] = ev
                claimed.append((b, sig, ev))

        def warm_one(b, sig, ev):
            try:
                self._dispatch([torch.zeros((b,) + tuple(shape),
                                            dtype=_torch_dtype(dtype))
                                for shape, dtype in sig], b)
                with self._warm_lock:
                    self._warmed.add((b, sig))
            finally:
                ev.set()
                with self._warm_lock:
                    self._warming.pop((b, sig), None)

        for b, sig, ev in claimed:
            warm_one(b, sig, ev)
        for ev in wait_for:
            ev.wait(timeout=600)
        return sorted({b for b, _ in jobs})

    # -- dynamic micro-batcher -------------------------------------------
    def submit(self, request, timeout_s: Optional[float] = None) -> Future:
        """Enqueue one request; the returned Future resolves to what
        ``infer(request)`` gives, on the host.

        With ``timeout_s``, the request carries a deadline budget: if it
        is still queued when the budget expires, the micro-batcher
        resolves its Future with ``TimeoutError`` instead of padding it
        into a batch slot nobody is waiting for."""
        self._refuse_on_follower()
        inputs = self._adapter.inputs_of(request)
        n = _leading_dim(inputs)
        if n is None:
            raise ValueError("request inputs must share a leading batch dim")
        if n > self.max_batch:
            raise ValueError(f"submit() batch {n} exceeds max_batch "
                             f"{self.max_batch}; use infer() (it chunks)")
        sig = self._input_sig(inputs)
        fut: Future = Future()
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with self._cv:
            self._refuse_if_closed()
            self._pending.append(_Request(inputs, sig, fut, deadline,
                                          ctx=current_context()))
            depth = len(self._pending)
            self._cv.notify_all()
        with self._lock:
            self._stats["requests"] += 1
        self._m_requests.inc()
        self._m_queue.set(depth)
        self._ensure_thread()
        return fut

    def _ensure_thread(self):
        with self._cv:
            if self._draining or self._closed or self._worker_dead:
                return  # a drain in progress must never be un-stopped
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._batcher_main,
                    name="dl4j-torch-inference-batcher", daemon=True)
                self._thread.start()

    @property
    def worker_dead(self) -> bool:
        """True once the supervised batcher exhausted its restart budget
        or met a device fault (the watchdog reports this engine
        unhealthy; submits fail fast)."""
        return self._worker_dead

    def _batcher_main(self):
        """Supervised batcher: a crash anywhere in the loop fails at most
        the dispatch it was running (``_run_group`` already fails only
        its riders), is counted, and the loop resumes after exponential
        backoff with jitter. A crash *burst* past
        ``DL4J_TPU_ENGINE_MAX_RESTARTS`` declares the worker dead: queued
        requests fail fast with ``EngineClosedError`` and the watchdog
        flips ``/readyz``. A device fault declares it dead at once: the
        CUDA context may be lost, and a restart would only fail the next
        group."""
        self._on_device()
        policy = faults.RetryPolicy(
            max_restarts=environment().engine_max_restarts(),
            base_s=0.01, max_s=2.0, seed=0)
        while True:
            try:
                self._batcher_loop()
                return  # normal stop (drain / idle exit)
            except Exception as e:
                if is_device_fault(e):
                    log.error("inference batcher met a device fault (%s: "
                              "%s); the engine stops", type(e).__name__, e)
                    self._worker_died()
                    return
                log.exception("inference batcher crashed; restarting the "
                              "loop")
                policy.note_failure()
                self._m_restarts.inc()
                if policy.exhausted():
                    self._worker_died()
                    return
                time.sleep(policy.backoff.next_delay())

    def _worker_died(self):
        """Fail everything queued, refuse new work, leave the process
        alive (the registry / operator decides what happens next:
        rollback, redeploy, or drain)."""
        with self._cv:
            self._worker_dead = True
            leftovers, self._pending = self._pending, []
            if self._thread is threading.current_thread():
                self._thread = None
            self._cv.notify_all()
        log.error("inference batcher stopped for good; engine refuses new "
                  "work (worker_dead)")
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(EngineClosedError(
                    "InferenceEngine worker thread permanently failed"))

    def start(self):
        """(Re)open the engine for requests: reverses drain() (a parked
        previous version resumes warm) and starts the micro-batcher
        thread. Raises once close() has run."""
        with self._cv:
            if self._closed:
                raise EngineClosedError(
                    "InferenceEngine is closed; it cannot be restarted")
            self._draining = False
        self._ensure_thread()
        return self

    def stop(self):
        """Drain pending requests, then stop the batcher thread (the
        engine stays open: a later submit() restarts it)."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=30)
        return self

    # -- graceful drain / close ------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining and not self._closed

    @property
    def closed(self) -> bool:
        return self._closed

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, flush every queued request through the
        micro-batcher, wait for in-flight infer() calls, and stop the
        batcher thread. Idempotent; reversible via start(). Late
        submit()/infer() calls raise ``EngineClosedError``. Returns True
        when fully drained within ``timeout_s``. On a follower of a
        sharded engine: :meth:`join`."""
        if self._is_follower():
            return self.join(timeout_s)
        deadline = time.monotonic() + timeout_s
        with self._cv:
            self._draining = True
            self._stopping = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        # a submit that raced the drain may have left requests behind a
        # stopped batcher: fail them explicitly rather than strand futures
        with self._cv:
            leftovers, self._pending = self._pending, []
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            drained = self._inflight == 0 and (t is None or not t.is_alive())
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(EngineClosedError(
                    "InferenceEngine drained before this request was "
                    "dispatched"))
        return drained

    def close(self, timeout_s: float = 30.0) -> bool:
        """Permanent drain: like drain(), but the engine can never be
        restarted. Idempotent. Returns True when fully drained. The
        model's captured forward lets go of its graphs (a later predict
        captures again): a SameDiff graph, which references itself, would
        otherwise keep them until a collection."""
        self._closed = True
        drained = self.drain(timeout_s)
        if self._link is not None:
            self._link.close()     # a leader ends the followers' engine
        graphs = self._adapter.graphs()
        if graphs is not None:
            graphs.release()
        return drained

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _expire(self, req: _Request) -> bool:
        """Resolve an expired request's Future with TimeoutError; True if
        it was expired (and must not occupy a batch slot)."""
        if not req.expired():
            return False
        if not req.future.done():
            req.future.set_exception(TimeoutError(
                "request deadline expired before dispatch"))
        self._m_expired.inc()
        if req.ctx is not None and self._reg.enabled:
            # the expired wait shows up in the request's trace with error
            # status: a shed request's timeline stays reconstructable
            tracer().record("inference/queue_expired", req.t_submit,
                            time.perf_counter(), context=req.ctx,
                            rows=req.n, error="TimeoutError")
        return True

    def _batcher_loop(self):
        while True:
            # the crash site sits BEFORE any request is popped, so an
            # injected batcher crash loses no queued work: the
            # supervisor restarts the loop and the queue survives
            if faults.active():
                faults.check("engine.batcher")
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if not self._pending:  # stopping and drained
                    if self._thread is threading.current_thread():
                        # a submit() racing this exit sees _thread None and
                        # starts a fresh batcher for its request
                        self._thread = None
                    return
                first = self._pending.pop(0)
            if self._expire(first):
                continue
            group, total = [first], first.n
            deadline = time.monotonic() + self.max_delay_ms / 1000.0
            while total < self.max_batch:
                with self._cv:
                    timeout = deadline - time.monotonic()
                    while (not self._pending and timeout > 0
                           and not self._stopping):
                        self._cv.wait(timeout)
                        timeout = deadline - time.monotonic()
                    if not self._pending:
                        break
                    nxt = self._pending[0]
                    if nxt.sig != first.sig or total + nxt.n > self.max_batch:
                        break
                    self._pending.pop(0)
                if self._expire(nxt):
                    continue
                group.append(nxt)
                total += nxt.n
            if self._reg.enabled:
                with self._cv:
                    self._m_queue.set(len(self._pending))
            self._run_group(group, total)

    def _run_group(self, group: List[_Request], total: int):
        self._m_coalesce.observe(len(group))
        # the dispatch span runs under the first traced rider's context
        # and lists every rider's trace_id, so each request's timeline
        # survives coalescing: its own trace keeps an inference/ride
        # span, and the shared dispatch names all trace_ids that rode
        lead_ctx = next((r.ctx for r in group if r.ctx is not None), None)
        attrs: Dict[str, Any] = {}
        if lead_ctx is not None:
            attrs["trace_ids"] = [r.ctx.trace_id for r in group
                                  if r.ctx is not None]
            if len(group) > 1:
                attrs["coalesced"] = len(group)
        t_dispatch = time.perf_counter()
        try:
            if len(group) == 1:
                inputs = group[0].inputs
            else:
                with self._lock:
                    self._stats["coalesced"] += len(group)
                inputs = [torch.cat(parts, 0)
                          for parts in zip(*(r.inputs for r in group))]
            with use_context(lead_ctx):
                outs = _to_host(self._dispatch(inputs, total,
                                               span_attrs=attrs))
            lo = 0
            for r in group:
                hi = lo + r.n
                r.future.set_result(self._adapter.package(
                    [o[lo:hi] if getattr(o, "ndim", 0) >= 1
                     and o.shape[0] == total else o for o in outs]))
                lo = hi
            self._record_rides(group, t_dispatch)
        except Exception as e:
            self._rescue_group(group, e, t_dispatch)

    def _fail_group(self, group: List[_Request], exc: Exception,
                    t_dispatch: float):
        for r in group:
            if not r.future.done():
                r.future.set_exception(exc)
        self._record_rides(group, t_dispatch, error=type(exc).__name__)

    def _rescue_group(self, group: List[_Request], exc: Exception,
                      t_dispatch: float):
        """Poison isolation: a failed coalesced dispatch re-dispatches
        each rider individually ONCE, so the one request carrying the
        fault is quarantined (``PoisonRequestError`` -> 422 with trace
        id) while its innocent riders succeed. An ``EngineClosedError``
        (drain race) is not a model fault and fails the group as it is,
        so the registry's swap retry fires. A device fault is not the
        request's either: it fails the group and propagates, which stops
        the batcher (``_batcher_main``)."""
        if isinstance(exc, EngineClosedError):
            self._fail_group(group, exc, t_dispatch)
            return
        if is_device_fault(exc):
            self._fail_group(group, exc, t_dispatch)
            raise exc
        for r in group:
            if r.future.done():
                continue
            trace_id = r.ctx.trace_id if r.ctx is not None else None
            try:
                outs = _to_host(self._dispatch(
                    r.inputs, r.n, span_attrs={"isolated_retry": True}))
            except Exception as e2:
                if is_device_fault(e2):
                    self._fail_group(group, e2, t_dispatch)
                    raise
                self._m_isolated.labels(outcome="quarantined").inc()
                self._m_quarantined.inc()
                record_disposition(trace_id, "quarantined")
                if r.ctx is not None and self._reg.enabled:
                    tracer().record(
                        "inference/quarantine", t_dispatch,
                        time.perf_counter(), context=r.ctx, rows=r.n,
                        error=type(e2).__name__)
                r.future.set_exception(PoisonRequestError(
                    f"request quarantined: dispatch failed coalesced "
                    f"({type(exc).__name__}: {exc}) and again isolated "
                    f"({type(e2).__name__}: {e2})", cause=e2))
            else:
                self._m_isolated.labels(outcome="ok").inc()
                record_disposition(trace_id, "retried")
                r.future.set_result(self._adapter.package(outs))
        self._record_rides(group, t_dispatch, error=type(exc).__name__)

    def _record_rides(self, group: List[_Request], t_dispatch: float,
                      error: Optional[str] = None):
        """Per-rider micro-batcher spans: each traced request gets an
        ``inference/ride`` span in its OWN trace covering queue wait +
        dispatch, so its timeline reads end-to-end even when another
        request's trace holds the shared dispatch span."""
        if not self._reg.enabled:
            return
        t1 = time.perf_counter()
        for r in group:
            if r.ctx is None:
                continue
            attrs = {"rows": r.n, "coalesced": len(group),
                     "queue_s": round(t_dispatch - r.t_submit, 6)}
            if error is not None:
                attrs["error"] = error
            tracer().record("inference/ride", r.t_submit, t1,
                            context=r.ctx, **attrs)

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in self._stats.items()}
        real, padded = s["rows_real"], s["rows_padded"]
        s["padding_overhead"] = padded / max(real + padded, 1)
        s["compile_count"] = environment().compile_count()
        s["buckets"] = list(self.ladder)
        graphs = self._adapter.graphs()
        s["graphs"] = graphs.report() if graphs is not None else []
        return sharded.report(s, self.mesh, self.param_spec)
