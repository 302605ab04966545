"""Sharded serving: the leader/follower step channel and the serving layouts.

Counterpart of the GSPMD half of the JAX package's sharded engines
(``runtime/generation.py``'s ``mesh=``/``param_spec=`` and
``_shard_kv_pool``, ``runtime/inference.py``'s adapters' ``shard``).
There one jitted program runs over every device of the mesh and XLA
inserts the collectives. Here every rank of the mesh is a process that
builds the same engines, in the same order, from the same global
weights, and the steps are written out as an SPMD program by hand:

- **Leader and followers.** The mesh's first rank (``devices[0, 0]``,
  global rank 0 for ``serving_mesh()``) is the leader: it alone takes
  requests, runs the schedulers and samples. Each step of a sharded
  engine there (a prefill, a decode, a verify, a predict dispatch,
  warmup's too) runs on the process's one **channel thread** for the
  mesh, which first sends the step's record to every other rank: the
  engine's id, the step's kind and its tensors (a decode step's shape
  and packed inputs, a predict dispatch's padded batch). Each follower's
  channel thread receives the records in that order and runs the same
  step on its shard through the engine the id names. So every collective of every sharded
  engine is issued from one thread a process, in one order on every
  rank, however many engines, callers and loop threads there are.
- An idle leader with live engines sends a heartbeat every
  :data:`HEARTBEAT_S`, so that a follower's wait never reaches the
  process group's timeout. ``close()`` on the leader sends the engine's
  stop record: the follower's engine ends (its ``join()`` returns), and
  a channel thread with no engine left ends too.
- **Without a process group** (a 1x1 mesh in one process) there is no
  link: the engine runs alone and every collective is the identity. A
  one-rank mesh inside a process group has no link either: its steps
  run on the engine's own thread, with no record.
- A step that raises on the leader (a request the model cannot run)
  raises on every follower at the same point, on the same inputs: a
  follower logs it and goes on receiving, as the leader fails only that
  step's requests. Only a failure of the wire ends a follower's
  channel.
- Engine ids count the sharded engines built in the process, so every
  rank must build them in the same order (as every rank builds every
  mesh, ``common/mesh.py``).

The layouts:

- :func:`causal_lm_specs`, the Megatron layout of a CausalLM's params
  (``models/causal_lm.py``'s head-parallel decode): ``wq``/``wk``/``wv``
  and their [H, Dh] biases split on H, ``wo`` on H, ``w1``/``b1`` on F,
  ``w2`` on F; every other leaf whole. A leaf whose dim does not divide
  over ``model`` stays whole (``mesh.valid_spec``), so attention runs
  unsplit where the heads do not divide, and the MLP where F does not.
- :func:`shard_kv_pool`: the paged pool ``[blocks, layers, block_size,
  heads, head_dim]`` keeps this rank's heads where they divide over
  ``model``, and is whole otherwise.
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..common.locks import ordered_condition
from ..common.mesh import (MODEL, P, Mesh, _dist, gather_tree, local_slice,
                           mesh_shape, place, spec_desc, tag,
                           tree_map_specs, valid_spec)

log = logging.getLogger(__name__)

#: step kinds of a record
NOOP, STOP, PREFILL, DECODE, SPEC, PREDICT = range(6)
#: seconds an idle leader waits before it sends a heartbeat record
HEARTBEAT_S = 5.0
#: int64 words of a record's header: kind, engine id, the tensor count,
#: then per tensor its dtype code, its rank and its dims
_HEADER = 64
_DTYPES = (torch.int32, torch.int64, torch.float32, torch.bfloat16,
           torch.float16, torch.float64, torch.uint8, torch.int8, torch.bool)


def _wire_dtype(dtype):
    # a bool mask travels as uint8 (not every backend takes bools)
    return torch.uint8 if dtype == torch.bool else dtype


class _Channel:
    """The records of every sharded engine over one set of ranks, and the
    one thread a process that sends (leader) or receives and replays
    (follower) them."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.leader_rank = int(mesh.devices.reshape(-1)[0])
        self.is_leader = mesh.rank == self.leader_rank
        self.cv = ordered_condition("sharded.channel")
        self.links: Dict[int, "StepLink"] = {}
        self.next_id = 0
        self.calls: List = []
        self.thread = None
        # the card of the building thread (a bare "cuda" means its
        # current one), made current on the channel thread
        dev = mesh.device
        self.card = None if dev.type != "cuda" else (
            dev.index if dev.index is not None
            else torch.cuda.current_device())

    def register(self, link: "StepLink") -> int:
        with self.cv:
            i = self.next_id
            self.next_id += 1
            self.links[i] = link
            if self.thread is None:
                self.thread = threading.Thread(
                    target=self._lead if self.is_leader else self._follow,
                    name="dl4j-torch-sharded-channel", daemon=True)
                self.thread.start()
        return i

    # -- the wire ----------------------------------------------------------
    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        from ..parallel.collectives import broadcast_raw
        return broadcast_raw(t, self.axes, self.mesh)

    def _send(self, kind: int, link_id: int, tensors: Sequence = ()):
        head = [kind, link_id, len(tensors)]
        for t in tensors:
            head += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        if len(head) > _HEADER:
            raise ValueError(f"a step record of {len(tensors)} tensors "
                             f"needs {len(head)} header words, over "
                             f"{_HEADER}")
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[:len(head)] = torch.tensor(head, dtype=torch.int64)
        self._bcast(header.to(self.mesh.device))
        for t in tensors:
            self._bcast(t.to(self.mesh.device, _wire_dtype(t.dtype))
                        .contiguous())

    def _recv(self) -> Tuple[int, int, List[torch.Tensor]]:
        dev = self.mesh.device
        head = self._bcast(torch.zeros(_HEADER, dtype=torch.int64,
                                       device=dev)).tolist()
        kind, link_id, n, i, out = head[0], head[1], head[2], 3, []
        for _ in range(n):
            dtype, ndim = _DTYPES[head[i]], head[i + 1]
            shape = tuple(head[i + 2:i + 2 + ndim])
            i += 2 + ndim
            buf = torch.empty(shape, dtype=_wire_dtype(dtype), device=dev)
            out.append(self._bcast(buf).to(dtype))
        return kind, link_id, out

    def _on_device(self):
        if self.card is not None:
            torch.cuda.set_device(self.card)

    # -- the leader ----------------------------------------------------------
    def call(self, link_id: int, kind: int, tensors, fn: Callable):
        """(Leader) send the record, then ``fn()``, on the channel
        thread; blocks for ``fn``'s result."""
        fut: Future = Future()
        with self.cv:
            self.calls.append((link_id, kind, tensors, fn, fut))
            self.cv.notify_all()
        return fut.result()

    def _lead(self):
        self._on_device()
        while True:
            with self.cv:
                while not self.calls and self.links:
                    if not self.cv.wait(HEARTBEAT_S):
                        break
                calls, self.calls = self.calls, []
                if not calls and not self.links:
                    self.thread = None
                    return
            if not calls:
                self._send(NOOP, -1)
            for link_id, kind, tensors, fn, fut in calls:
                try:
                    self._send(kind, link_id, tensors)
                    fut.set_result(fn())
                except Exception as e:  # noqa: BLE001 — to the caller
                    fut.set_exception(e)
                if kind == STOP:
                    with self.cv:
                        self.links.pop(link_id, None)

    # -- a follower ----------------------------------------------------------
    def _follow(self):
        self._on_device()
        try:
            while True:
                kind, link_id, tensors = self._recv()
                if kind == NOOP:
                    continue
                with self.cv:
                    # the leader may run an engine's first step (its
                    # warmup) before this rank has finished building it
                    while link_id >= self.next_id:
                        self.cv.wait(1.0)
                    link = self.links.get(link_id)
                if link is None:
                    raise RuntimeError(
                        f"a step record for engine {link_id}, which this "
                        "rank has closed: every rank must build the "
                        "sharded engines in the same order")
                if kind == STOP:
                    with self.cv:
                        self.links.pop(link_id)
                        last = not self.links
                        if last:
                            self.thread = None
                    link.done.set()
                    if last:
                        return
                    continue
                try:
                    link.replay(kind, tensors)
                except Exception:  # noqa: BLE001 — the step's, not the wire's
                    # the leader meets the same error on the same inputs
                    # at the same point (a request the model cannot run),
                    # so both ranks' collectives stay in one order: the
                    # step fails on both and the channel goes on
                    log.exception("a replayed step of sharded engine %d "
                                  "failed, as it does on the leader",
                                  link_id)
        except BaseException:
            log.exception("the sharded-serving follower channel failed; "
                          "its engines end")
            with self.cv:
                links, self.links = list(self.links.values()), {}
                self.thread = None
            for link in links:
                link.done.set()
            raise


#: channels by the mesh's ranks
_CHANNELS: Dict[Tuple[int, ...], _Channel] = {}
_CHANNELS_LOCK = threading.Lock()


class StepLink:
    """One sharded engine's end of its mesh's channel (module
    docstring): :meth:`call` on the leader, ``replay(kind, tensors)`` on
    a follower, ``done`` set once the leader closed the engine."""

    def __init__(self, mesh: Mesh, replay: Callable):
        key = tuple(sorted(int(r) for r in mesh.devices.reshape(-1)))
        with _CHANNELS_LOCK:
            ch = _CHANNELS.get(key)
            if ch is None:
                ch = _CHANNELS[key] = _Channel(mesh)
        self.channel = ch
        self.is_leader = ch.is_leader
        self.leader_rank = ch.leader_rank
        self.replay = replay
        self.done = threading.Event()
        self.closed = False
        self.id = ch.register(self)

    @staticmethod
    def for_mesh(mesh, replay: Callable):
        """The link of an engine on ``mesh``, or None where no process
        group is initialised or the mesh holds one rank (no follower to
        replay a step: the single-process engine, its collectives over
        the one rank's group)."""
        if mesh is None or _dist() is None or mesh.devices.size == 1:
            return None
        return StepLink(mesh, replay)

    def call(self, kind: int, tensors, fn: Callable):
        """(Leader) the step ``fn`` after its record, on the channel
        thread; refused once the engine's stop record went out."""
        if self.closed:
            raise RuntimeError("this sharded engine is closed: its "
                               "followers have stopped")
        return self.channel.call(self.id, kind, tuple(tensors), fn)

    def close(self):
        """(Leader) the stop record: the followers' engine ends."""
        if self.is_leader and not self.closed:
            self.closed = True
            self.channel.call(self.id, STOP, (), lambda: None)
            self.done.set()


# -- the serving layouts ------------------------------------------------------

#: Megatron layout of a CausalLM layer's leaves, by key (every other
#: leaf whole)
_CAUSAL_LM_SPECS = {
    "wq": P(None, MODEL), "wk": P(None, MODEL), "wv": P(None, MODEL),
    "bq": P(MODEL), "bk": P(MODEL), "bv": P(MODEL),
    "wo": P(MODEL), "w1": P(None, MODEL), "b1": P(MODEL),
    "w2": P(MODEL),
}


def causal_lm_specs(params):
    """The spec tree of a CausalLM params tree under the Megatron
    layout (module docstring)."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return _CAUSAL_LM_SPECS.get(key, P())
    return walk(params, None)


def place_causal_lm(mesh: Mesh, params):
    """This rank's shard of a global CausalLM params tree under the
    Megatron layout (each leaf a contiguous copy, tagged)."""
    return tree_map_specs(lambda a, s: place(a, mesh, s), params,
                 causal_lm_specs(params))


def causal_lm_views(mesh: Mesh, params):
    """This rank's Megatron views of a global params tree (no copy):
    what a step computes with when the params are stored under an
    explicit ``param_spec`` and gathered at use."""
    def view(a, s):
        if hasattr(a, "sliced"):
            return a.sliced(mesh, s)
        spec = valid_spec(mesh, s, a.shape)
        return tag(local_slice(a, mesh, spec), mesh, spec, a.shape)
    return tree_map_specs(view, params, causal_lm_specs(params))


def use_params(mesh: Mesh, stored, param_spec):
    """The params a step computes with: the stored Megatron shards as
    they are (``param_spec`` None), else the stored tree gathered (one
    all-gather a split leaf, on every rank) and viewed in the Megatron
    layout."""
    if param_spec is None:
        return stored
    return causal_lm_views(mesh, gather_tree(stored))


def report(d, mesh, param_spec):
    """``mesh_shape`` and ``param_spec`` into a sharded engine's stats or
    snapshot ``d`` (nothing without a mesh, as the JAX package)."""
    if mesh is not None:
        d["mesh_shape"] = mesh_shape(mesh)
        d["param_spec"] = spec_desc(param_spec)
    return d


def _pool_spec(mesh: Mesh, leaf) -> P:
    size = mesh.shape.get(MODEL, 1)
    if size > 1 and leaf.dim() == 5 and leaf.shape[3] % size == 0:
        return P(None, None, None, MODEL)
    return P()


def shard_kv_pool(mesh: Mesh, cache):
    """The paged pool's leaves with this rank's heads (axis 3) where they
    divide over ``model``, whole otherwise (``_shard_kv_pool`` of the
    JAX package)."""
    return {k: place(v, mesh, _pool_spec(mesh, v)) for k, v in cache.items()}


def pool_bytes(cache) -> int:
    """Bytes of a KV pool as this rank holds it."""
    return sum(int(v.numel()) * v.element_size() for v in cache.values())
