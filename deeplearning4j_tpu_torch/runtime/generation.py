"""Generative serving fast path: paged KV cache, batched prefill,
continuous batching, and speculative decoding.

Counterpart of ``deeplearning4j_tpu/runtime/generation.py``: the Orca
(OSDI '22) per-iteration scheduling playbook over the vLLM/PagedAttention
(SOSP '23) block-granular KV cache, with RadixAttention (SGLang) prefix
reuse and Leviathan et al. (2023) draft-model speculative decoding. The
scheduler is the JAX package's, line for line; the steps run eagerly in
PyTorch on the model's device.

- **paged KV cache** — a block pool
  ``[num_blocks, layers, block_size, heads, head_dim]`` plus a per-slot
  block table, so a sequence holds ``ceil(len/block_size)`` blocks.
  Admission is gated on free blocks, blocks are appended as a sequence
  grows, and block 0 is a scratch block that padding writes land in and
  every read masks. When the pool runs dry mid-decode the engine preempts
  the most recently admitted sequence (LIFO) and requeues it with its
  generated prefix — recompute-style preemption that keeps greedy output
  token-identical.
- **prefix-aware KV reuse** — a refcounted allocator plus a radix tree
  keyed on block-aligned token bytes let an admitted prompt attach the
  longest cached block run and prefill only the uncached tail
  (``paged_prefill``'s ``start_pos``). Finished and preempted requests
  release refs; their committed full blocks stay cached; cold cached
  leaves are reclaimed LRU. Gate with ``prefix_cache=`` /
  ``DL4J_TPU_PREFIX_CACHE``.
- **batched prefill** — queued prompts whose tails pad to the same
  prompt bucket share ONE prefill call (group padded up a batch ladder);
  every later token costs one batched ``paged_decode`` over all slots.
- **continuous batching** — requests join and leave the running batch
  per token.
- **speculative decoding** — with ``draft_model`` + ``spec_k``
  (``DL4J_TPU_SPEC_DRAFT_K``), each all-greedy iteration drafts k tokens,
  verifies all k+1 positions in one ``paged_decode`` pass (Q=k+1, the same
  kernel as the Q=1 step) and commits the longest matching prefix plus
  one target token.
- **sampling** — greedy, temperature and top-k per slot, Gumbel-max with
  noise hashed from ``(seed, request, position)`` (:func:`step_uniforms`
  over :func:`row_streams`): a request's sampled tokens depend on the
  engine's seed, the order it was submitted in and its own tokens, never
  on what else the engine was running when it was sampled.
- **captured steps** — every prefill (prompt bucket, batch rung), the
  decode step and the verify step is one signature: on a CUDA engine it
  is captured once as a CUDA graph and replayed after that
  (``runtime/cuda_graphs.py``), on a CPU engine the same body runs
  eagerly on the same static buffers. A step's inputs are views of one
  packed buffer, filled from one pinned staging buffer by one copy; its
  output comes back in one copy. Each signature records one census event
  under the JAX package's tags (``prefill``, ``decode``, ``spec``, with
  the twin's precision suffix), ``len(ladder) * len(batch ladder) + 1``
  (+1 with speculation) after ``warmup()`` and none after that;
  ``stats()["graphs"]`` lists them.

The KV pools are written in place by the model's step functions (the JAX
package donates them to its jitted steps instead).

- **tensor-parallel decode** — with ``mesh=`` (``serving_mesh()``) every
  rank of the mesh builds the engine with the same arguments and the same
  global weights. The params (and the draft's) take the Megatron layout
  (``runtime/sharded.py``; an explicit ``param_spec`` stores them as given
  and gathers them at each step), the paged pool keeps this rank's heads
  where they divide over ``model``, and each layer's ``wo`` and ``w2``
  products meet in one all-reduce. The mesh's first rank leads: it takes
  the requests, schedules and samples, and each of its prefill, decode
  and verify steps (warmup's too) goes to the followers as a record
  first, whose channel thread runs the same model calls on their shards.
  ``generate`` on a follower raises; ``close()`` on the leader ends the
  followers' engine (``join()`` on a follower waits for it).
The engine carries the JAX package's registry-compat surface (``max_batch``,
``manifest_path``, ``observed_entries()``) and the dispatch instant the
serving watchdog reads (``_dispatch_started_at``).

Observability (the JAX package's names): ``dl4j_decode_requests_total``,
``dl4j_decode_tokens_total``, ``dl4j_decode_steps_total``,
``dl4j_decode_active_slots``, ``dl4j_decode_queue_depth``,
``dl4j_kv_blocks_free{model}``, ``dl4j_decode_preempted_total``,
``dl4j_spec_proposed_tokens_total`` / ``dl4j_spec_accepted_tokens_total``,
``dl4j_kv_prefix_{hits,misses,evictions}_total``,
``dl4j_kv_prefix_blocks{model}``, ``dl4j_decode_ttft_seconds{model}``
(exemplared with trace ids), ``dl4j_decode_itl_seconds{model}`` and the
goodput split ``dl4j_tokens_total{model,slo=ok|violated}``; each
signature's capture lands on ``dl4j_compile_seconds{kind,cache}``
(``captured``; ``eager`` on the CPU; ``eager:<reason>``). Each
request's trace gains ``generation/prefill`` and ``generation/decode``
spans, and its result carries a ``phases`` dict
(``queue_s``/``prefill_s``/``decode_s``).
"""
from __future__ import annotations

import logging
import math
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common import faults
from ..common.environment import environment
from ..common.locks import ordered_condition, ordered_lock, ordered_rlock
from ..common.metrics import exponential_buckets, registry
from ..common.rng import _mix32
from ..common.tracing import current_context, record_disposition, tracer
from . import cuda_graphs, sharded
from .inference import EngineClosedError, bucket_for, bucket_ladder

log = logging.getLogger(__name__)


def is_generative_model(model) -> bool:
    """Duck-typed generative-model protocol (``models.causal_lm.CausalLM``):
    the paged trio ``init_paged_kv_cache`` / ``paged_prefill`` /
    ``paged_decode``, the slab trio ``init_kv_cache`` / ``prefill`` /
    ``decode``, plus ``params``."""
    return all(callable(getattr(model, m, None))
               for m in ("init_kv_cache", "prefill", "decode",
                         "init_paged_kv_cache", "paged_prefill",
                         "paged_decode")) \
        and hasattr(model, "params")


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def step_uniforms(seed, step, shape, device) -> torch.Tensor:
    """Uniform draws in (0, 1), float32 ``shape`` [rows, V]: a
    counter-based hash of (seed, step, row, column) in plain integer ops.
    ``seed`` and ``step`` are ints or 0-d tensors (a captured step reads
    them from its static inputs), or ``step`` holds one stream a row
    ([rows], :func:`row_streams`), which then draws from (seed, its
    stream, column) whatever row it sits in. So the draws are the same in
    an eager step and in a CUDA-graph replay, and on every device (the
    JAX package folds ``step`` into a PRNG key instead)."""
    seed = torch.as_tensor(seed, device=device).long() & _M32
    step = torch.as_tensor(step, device=device).long() & _M32
    key = _mix32(seed ^ _mix32((step + 0x9E3779B9) & _M32))
    if key.dim() == 1:
        key = key[:, None]
        idx = torch.arange(shape[-1], device=device, dtype=torch.int64)
    else:
        idx = torch.arange(math.prod(shape), device=device,
                           dtype=torch.int64).view(shape)
    h = _mix32((_mix32(idx ^ key) + key) & _M32)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def row_streams(numbers, positions) -> torch.Tensor:
    """One noise stream a row [rows] for :func:`step_uniforms`: the draw
    of request ``numbers[r]`` (its submission number in the engine) for
    its token ``positions[r]`` (the tokens it has generated so far)."""
    n = numbers.long() & _M32
    p = positions.long() & _M32
    return _mix32(n ^ _mix32((p + 0x7F4A7C15) & _M32))


def sample_tokens(logits, temperature, top_k, seed, step):
    """Next-token sampling over ``logits`` [S, V] (f32); ``step`` is one
    stream for the whole draw or one a row (:func:`step_uniforms`).

    ``temperature`` [S]: <= 0 means greedy argmax for that slot.
    ``top_k`` [S]: <= 0 disables the top-k filter for that slot.
    Gumbel-max sampling, so greedy/temperature/top-k share one batched
    computation with fixed shapes; the noise is
    :func:`step_uniforms` of (``seed``, ``step``).
    """
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    k = torch.clamp(torch.where(top_k <= 0, V, top_k), 1, V).long()
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    thr = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    masked = torch.where(scaled >= thr, scaled, -torch.inf)
    u = step_uniforms(seed, step, tuple(logits.shape), logits.device)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

class _GenRequest:
    __slots__ = ("prompt", "max_tokens", "temperature", "top_k", "eos",
                 "on_token", "future", "ctx", "deadline", "t_submit",
                 "t_first", "t_prefill0", "t_last", "tokens", "slot",
                 "prefix", "admit_seq", "reuse_nodes", "start", "number")

    def __init__(self, prompt, max_tokens, temperature, top_k, eos,
                 on_token, deadline, ctx):
        self.prompt = prompt              # np.int32 [T]
        self.max_tokens = max_tokens
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos = eos                    # int or None
        self.on_token = on_token
        self.future: Future = Future()
        self.ctx = ctx                    # submitter's TraceContext
        self.deadline = deadline          # monotonic instant or None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        # phase boundaries: queue = [t_submit, t_prefill0), prefill =
        # [t_prefill0, t_first), decode = [t_first, finish); t_last is the
        # previous token's emit instant (the inter-token-latency basis)
        self.t_prefill0: Optional[float] = None
        self.t_last: Optional[float] = None
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        # the rows a prefill must (re)compute: the prompt, extended with
        # every generated token when the request is preempted/requeued
        self.prefix = prompt              # np.int32 [>=T]
        self.admit_seq = -1               # LIFO preemption order
        # prefix-cache attachment planned at admission: the radix nodes
        # whose blocks this request shares, covering rows [0, start)
        self.reuse_nodes: List = []
        self.start = 0
        # submission number: with the count of its tokens, the stream of
        # its sampling noise (row_streams)
        self.number = 0

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline


class _BlockAllocator:
    """Refcounted free-list allocator over KV-pool block ids ``1..total``
    (block 0 is scratch and never handed out). A block is freed only when
    its refcount reaches zero: a slot's block table holds one ref per
    appearance and the radix cache one per cached node. Callers hold the
    engine's scheduler lock around every operation."""

    def __init__(self, total: int):
        self.total = int(total)
        self._free = list(range(self.total, 0, -1))  # pop() yields 1 first
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._refs)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def incref(self, ids) -> None:
        """Add one ref per id; unknown ids are ignored."""
        for b in ids:
            b = int(b)
            if b in self._refs:
                self._refs[b] += 1

    def decref(self, ids) -> int:
        """Drop one ref per id; a block reaching zero returns to the pool.
        Unknown ids and id 0 are ignored. Returns how many blocks were
        freed."""
        n = 0
        for b in ids:
            b = int(b)
            r = self._refs.get(b)
            if r is None:
                continue
            if r <= 1:
                del self._refs[b]
                self._free.append(b)
                n += 1
            else:
                self._refs[b] = r - 1
        return n

    free = decref

    def refcounts(self) -> Dict[int, int]:
        return dict(self._refs)

    def reset_to(self, expected) -> None:
        """Rebuild so exactly ``expected`` is outstanding: a ``{block:
        refcount}`` mapping, or an iterable of ids meaning refcount 1."""
        if not isinstance(expected, dict):
            expected = {int(b): 1 for b in expected}
        self._refs = {int(b): int(r) for b, r in expected.items()
                      if 0 < int(b) <= self.total and int(r) > 0}
        self._free = [b for b in range(self.total, 0, -1)
                      if b not in self._refs]


class _RadixNode:
    """One cached block: ``key`` is the block's exact token bytes,
    ``block`` the pool block holding those rows' KV, ``refs`` the slots
    attached through this node, ``digest`` the chained prefix hash shown
    by ``debug_snapshot``."""
    __slots__ = ("key", "digest", "block", "parent", "children", "refs",
                 "last_used")

    def __init__(self, key: bytes, digest: str, block: int, parent):
        self.key = key
        self.digest = digest
        self.block = int(block)
        self.parent = parent
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.refs = 0
        self.last_used = 0


class _RadixCache:
    """Radix tree over block-aligned token prefixes: depth ``d`` holds a
    sequence's ``d``-th full KV block, keyed by that block's exact token
    bytes. The tree holds one allocator ref per cached block; attached
    slots add theirs on top. All mutations happen under the engine's
    scheduler lock."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self.root = _RadixNode(b"", "", 0, None)
        self._nodes: set = set()
        self._clock = 0
        self.evictions = 0          # lifetime LRU evictions

    @property
    def size(self) -> int:
        return len(self._nodes)

    def nodes(self) -> List[_RadixNode]:
        return list(self._nodes)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens) -> List[_RadixNode]:
        """Longest run of cached full blocks prefixing ``tokens``; bumps
        the run's LRU stamps."""
        out: List[_RadixNode] = []
        node = self.root
        bs = self.block_size
        n = int(len(tokens))
        i = 0
        while i + bs <= n:
            child = node.children.get(tokens[i:i + bs].tobytes())
            if child is None:
                break
            out.append(child)
            node = child
            i += bs
        t = self._tick()
        for nd in out:
            nd.last_used = t
        return out

    def insert(self, tokens, blocks) -> List[_RadixNode]:
        """Record ``blocks[j]`` as the cached KV for token rows
        ``[j*bs, (j+1)*bs)``. Existing nodes win. Returns the newly
        created nodes; the caller takes the tree's ref on each."""
        import hashlib

        node = self.root
        bs = self.block_size
        created: List[_RadixNode] = []
        t = self._tick()
        for j, block in enumerate(blocks):
            if (j + 1) * bs > len(tokens):
                break
            key = tokens[j * bs:(j + 1) * bs].tobytes()
            child = node.children.get(key)
            if child is None:
                digest = hashlib.sha1(
                    node.digest.encode() + key).hexdigest()[:12]
                child = _RadixNode(key, digest, int(block), node)
                node.children[key] = child
                self._nodes.add(child)
                created.append(child)
            child.last_used = t
            node = child
        return created

    def lru_leaf(self) -> Optional[_RadixNode]:
        """Least-recently-used unattached leaf, or None."""
        best = None
        for nd in self._nodes:
            if nd.children or nd.refs > 0:
                continue
            if best is None or nd.last_used < best.last_used:
                best = nd
        return best

    def remove(self, node: _RadixNode) -> None:
        node.parent.children.pop(node.key, None)
        self._nodes.discard(node)

    def reclaimable_count(self, exclude=(), ref_fn=None) -> int:
        """Blocks reclaimable by cascading leaf eviction: nodes whose
        whole subtree is unattached and not in ``exclude``, counting only
        those whose block eviction would actually free (``ref_fn`` is the
        allocator refcount)."""
        ex = set(exclude)

        def walk(nd):
            n, all_ok = 0, True
            for ch in nd.children.values():
                cn, ok = walk(ch)
                n += cn
                all_ok = all_ok and ok
            if all_ok and nd.refs == 0 and nd not in ex:
                frees = ref_fn is None or ref_fn(nd.block) <= 1
                return (n + 1 if frees else n), True
            return n, False

        return sum(walk(ch)[0] for ch in self.root.children.values())


class DecodeEngine:
    """Continuous-batching autoregressive decode engine over one model,
    serving from a paged KV cache on ``device`` (the model's device).

    - ``generate(prompt, ...) -> Future`` resolving to a result dict
      (``tokens``, ``finish_reason``, ``ttft_s``, token counts, ``phases``);
      ``on_token`` streams tokens as they are sampled.
    - ``warmup()`` runs one prefill per (prompt bucket, batch rung) pair
      plus the decode step (plus the speculative step) before traffic:
      it builds the kernels and captures every step's graph.
    - ``drain()/close()/start()`` manage the loop thread's lifecycle.

    ``slots`` bounds concurrent sequences (``DL4J_TPU_DECODE_SLOTS``);
    ``max_ctx`` bounds prompt+generation length (``DL4J_TPU_DECODE_MAX_CTX``,
    capped by the model's position table); ``kv_block_size``
    (``DL4J_TPU_KV_BLOCK_SIZE``) sets the block granularity, clamped to
    ``max_ctx``; ``kv_blocks`` sizes the pool (default slab-equivalent,
    ``slots * ceil(max_ctx/block_size)``); ``prefill_batch`` caps how many
    same-bucket prompts share one prefill; ``draft_model`` + ``spec_k``
    (``DL4J_TPU_SPEC_DRAFT_K``) enable greedy speculative decoding;
    ``prefix_cache`` (``DL4J_TPU_PREFIX_CACHE``, default on) enables KV
    block reuse across requests.
    """

    def __init__(self, model, *, slots: Optional[int] = None,
                 max_ctx: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 eos_token: Optional[int] = None, seed: int = 0,
                 kv_block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 prefill_batch: Optional[int] = None,
                 draft_model=None, spec_k: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 model_name: str = "default",
                 mesh=None, param_spec=None, device="cuda"):
        if not is_generative_model(model):
            raise TypeError(
                f"cannot decode a {type(model).__name__}: expected the "
                "generative-model protocol (init_paged_kv_cache/"
                "paged_prefill/paged_decode)")
        self.device = torch.device(device)
        for m, what in ((model, "model"), (draft_model, "draft_model")):
            dev = getattr(m, "device", None)
            if dev is not None and torch.device(dev) != self.device:
                raise ValueError(f"{what} lives on {dev}, the engine on "
                                 f"{self.device}: pass device= to match")
        env = environment()
        self.model = model
        self.model_name = str(model_name)
        self.slots = int(slots if slots is not None else env.decode_slots())
        max_ctx = int(max_ctx if max_ctx is not None
                      else env.decode_max_ctx())
        pos_cap = getattr(getattr(model, "config", None),
                          "max_position_embeddings", None)
        if pos_cap:
            max_ctx = min(max_ctx, int(pos_cap))
        self.max_ctx = max_ctx
        # prompt-length bucket ladder. The top rung always covers
        # max_ctx: a preempted rider re-enters the queue with
        # prompt+generated as its prefix, which can exceed the largest
        # explicit bucket (but never max_ctx).
        self.ladder = bucket_ladder(self.max_ctx, prompt_buckets)
        if self.ladder[-1] < self.max_ctx:
            self.ladder = self.ladder + (self.max_ctx,)
        bs = int(kv_block_size if kv_block_size is not None
                 else env.kv_block_size())
        self.block_size = max(1, min(bs, self.max_ctx))
        self.max_blocks = _cdiv(self.max_ctx, self.block_size)  # per slot
        pool = int(kv_blocks if kv_blocks is not None
                   else self.slots * self.max_blocks)
        self.kv_blocks = max(1, pool)
        pb = int(prefill_batch if prefill_batch is not None
                 else min(4, self.slots))
        self.prefill_batch = max(1, min(pb, self.slots))
        self.batch_ladder = bucket_ladder(self.prefill_batch)
        k = int(spec_k if spec_k is not None else env.spec_draft_k())
        self.spec_k = max(0, k)
        self.draft = draft_model
        if self.draft is not None and not is_generative_model(self.draft):
            raise TypeError(
                f"draft_model {type(self.draft).__name__} does not "
                "implement the generative-model protocol")
        self._spec_enabled = self.draft is not None and self.spec_k >= 1
        self.eos_token = eos_token
        self._seed = int(seed)
        self._params = model.params
        # +1: block 0 is the scratch block for padding/inactive writes
        self._cache = model.init_paged_kv_cache(self.kv_blocks + 1,
                                                self.block_size)
        self._dparams = self.draft.params if self._spec_enabled else None
        self._dcache = (self.draft.init_paged_kv_cache(
            self.kv_blocks + 1, self.block_size)
            if self._spec_enabled else None)
        # tensor-parallel decode (module docstring); mesh=None: the
        # single-device engine
        self.mesh = mesh
        self.param_spec = param_spec
        if mesh is not None:
            self._shard(mesh, param_spec)
        #: requests submitted so far (each one's ``number``)
        self._submitted = 0
        # per-slot host state (the loop thread owns it)
        S = self.slots
        self._tokens = np.zeros(S, np.int32)
        self._lengths = np.zeros(S, np.int32)
        self._temps = np.zeros(S, np.float32)
        self._topks = np.zeros(S, np.int32)
        self._numbers = np.zeros(S, np.int32)
        self._tables = np.zeros((S, self.max_blocks), np.int32)
        self._nblocks = np.zeros(S, np.int32)
        self._alloc = _BlockAllocator(self.kv_blocks)
        pc = (prefix_cache if prefix_cache is not None
              else env.prefix_cache_enabled())
        self._prefix_cache = bool(pc)
        self._radix = _RadixCache(self.block_size)
        self._slot_nodes: List[List[_RadixNode]] = [[] for _ in range(S)]
        self._slot_req: List[Optional[_GenRequest]] = [None] * S
        self._active_n = 0
        self._admit_counter = 0
        # dispatch serialization: warmup and the loop both step the cache
        self._dispatch_lock = ordered_rlock("decode.dispatch")
        self._warmed: set = set()
        # scheduler state
        self._cv = ordered_condition("decode.scheduler")
        self._pending: List[_GenRequest] = []
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._draining = False
        self._closed = False
        # supervised-loop state + the watchdog-readable dispatch instant
        # (serving/resilience.py polls both from outside)
        self._worker_dead = False
        self._dispatch_started_at: Optional[float] = None
        # registry-compat surface (the manifest machinery is predict-only)
        self.max_batch = self.slots
        self.manifest_path = None
        self._stats_lock = ordered_lock("decode.stats")
        self._stats = {"requests": 0, "tokens": 0, "decode_steps": 0,
                       "prefills": 0, "prefill_dispatches": 0,
                       "prefill_rows": 0, "expired": 0, "preempted": 0,
                       "spec_steps": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "prefix_hits": 0,
                       "prefix_misses": 0, "prefix_reused_rows": 0}
        self._build_steps()
        reg = registry()
        self._reg = reg
        self._m_requests = reg.counter(
            "dl4j_decode_requests_total",
            "Generation requests accepted by DecodeEngine.generate()")
        self._m_tokens = reg.counter(
            "dl4j_decode_tokens_total",
            "Tokens sampled across prefill + decode steps")
        self._m_steps = reg.counter(
            "dl4j_decode_steps_total",
            "Batched decode dispatches (plain single-token + speculative)")
        self._m_active = reg.gauge(
            "dl4j_decode_active_slots",
            "Sequences currently occupying a decode slot")
        self._m_queue = reg.gauge(
            "dl4j_decode_queue_depth",
            "Generation requests waiting for a free slot")
        self._m_blocks_free = reg.gauge(
            "dl4j_kv_blocks_free",
            "Free KV-cache blocks in the paged decode pool",
            labels=("model",)).labels(model=self.model_name)
        self._m_blocks_free.set(self._alloc.free_count)
        self._m_ttft = reg.histogram(
            "dl4j_decode_ttft_seconds",
            "Time from generate() to the first sampled token",
            labels=("model",),
            buckets=exponential_buckets(1e-3, 2.0, 18)).labels(
                model=self.model_name)
        self._m_itl = reg.histogram(
            "dl4j_decode_itl_seconds",
            "Inter-token latency: gap between consecutive sampled "
            "tokens of one request (the decode-phase tail a reader "
            "actually feels)",
            labels=("model",),
            buckets=exponential_buckets(1e-4, 2.0, 18)).labels(
                model=self.model_name)
        goodput = reg.counter(
            "dl4j_tokens_total",
            "Goodput: tokens emitted, split by whether the owning "
            "request's TTFT met the per-model latency objective "
            "(DL4J_TPU_SLO_LATENCY_MS; no objective -> every token ok)",
            labels=("model", "slo"))
        self._m_tok_ok = goodput.labels(model=self.model_name, slo="ok")
        self._m_tok_violated = goodput.labels(model=self.model_name,
                                              slo="violated")
        self._slo_latency_s = env.slo_latency_s()
        self._m_expired = reg.counter(
            "dl4j_decode_expired_total",
            "Generation requests whose deadline expired before a slot")
        self._m_restarts = reg.counter(
            "dl4j_engine_restarts_total",
            "Supervised engine worker-thread restarts after a crash",
            labels=("engine",)).labels(engine="decode")
        self._m_slot_leaks = reg.counter(
            "dl4j_decode_slot_leaks_total",
            "KV-cache slots found leaked (occupied without a live rider) "
            "and reclaimed by the per-iteration accounting check")
        self._m_block_leaks = reg.counter(
            "dl4j_kv_block_leaks_total",
            "KV-pool blocks whose allocator accounting drifted from the "
            "slot block tables and were repaired by the reconcile pass")
        self._m_cancelled = reg.counter(
            "dl4j_decode_cancelled_total",
            "Riders whose future was cancelled mid-decode; their slot is "
            "freed immediately")
        self._m_preempted = reg.counter(
            "dl4j_decode_preempted_total",
            "Sequences preempted (blocks reclaimed, requeued for "
            "recompute) because the KV block pool ran dry mid-decode")
        self._m_spec_proposed = reg.counter(
            "dl4j_spec_proposed_tokens_total",
            "Draft tokens proposed by speculative decode steps")
        self._m_spec_accepted = reg.counter(
            "dl4j_spec_accepted_tokens_total",
            "Draft tokens accepted (verified equal to the target model's "
            "greedy choice) by speculative decode steps")
        self._m_prefix_hits = reg.counter(
            "dl4j_kv_prefix_hits_total",
            "Admitted prompts that attached at least one cached KV block "
            "from the radix prefix cache (tail-only prefill)")
        self._m_prefix_misses = reg.counter(
            "dl4j_kv_prefix_misses_total",
            "Admitted prompts that found no cached KV prefix and "
            "prefilled cold")
        self._m_prefix_evictions = reg.counter(
            "dl4j_kv_prefix_evictions_total",
            "Cached KV blocks reclaimed from the radix prefix cache "
            "(LRU leaf eviction — the primary reclaim path)")
        self._m_prefix_blocks = reg.gauge(
            "dl4j_kv_prefix_blocks",
            "KV-pool blocks currently held by the radix prefix cache",
            labels=("model",)).labels(model=self.model_name)
        # last: a follower may replay the leader's steps from here on
        self._link = sharded.StepLink.for_mesh(mesh, self._replay)

    # -- the mesh ------------------------------------------------------------
    def _shard(self, mesh, param_spec):
        """Place the params, the draft's and both pools on this rank of
        ``mesh`` (module docstring)."""
        from ..common.mesh import shard_params, validate_mesh
        validate_mesh(mesh)
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh lives on {mesh.device}, the engine "
                             f"on {self.device}: pass device= to match")

        def store(params):
            return (sharded.place_causal_lm(mesh, params)
                    if param_spec is None
                    else shard_params(mesh, params, param_spec))
        self._params = store(self._params)
        self._cache = sharded.shard_kv_pool(mesh, self._cache)
        if self._spec_enabled:
            self._dparams = store(self._dparams)
            self._dcache = sharded.shard_kv_pool(mesh, self._dcache)

    def _step_params(self):
        """(params, draft params) a step computes with; under an explicit
        ``param_spec`` they are gathered here, on every rank."""
        if self.mesh is None or self.param_spec is None:
            return self._params, self._dparams
        return (sharded.use_params(self.mesh, self._params,
                                   self.param_spec),
                sharded.use_params(self.mesh, self._dparams,
                                   self.param_spec)
                if self._spec_enabled else None)

    def _replay(self, kind, t):
        """(Follower) one of the leader's steps on this rank's shard: the
        record holds the step's shape and its packed inputs, and the same
        step (graph or eager body) runs on them; its output stays on the
        card."""
        name = {sharded.PREFILL: "prefill", sharded.DECODE: "decode",
                sharded.SPEC: "spec"}.get(kind)
        if name is None:
            raise RuntimeError(f"unknown decode step record {kind}")
        with self._dispatch_lock, torch.no_grad():
            step = self._graph_step(name, tuple(int(d) for d in
                                                t[0].tolist()))
            with self._graphs.lock:
                step.inputs.load(t[1])
                self._graphs.run(step, lambda: self._bodies[name](
                    step.inputs.views), eager=self._eager_reason)

    def _is_follower(self) -> bool:
        return self._link is not None and not self._link.is_leader

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """(Follower) wait until the leader closed this engine; True once
        it has."""
        return self._link is None or self._link.done.wait(timeout_s)

    # -- steps ---------------------------------------------------------------
    def _build_steps(self):
        """The step bodies and the graphs that replay them
        (``runtime/cuda_graphs.py``): one signature for each (prompt
        bucket, batch rung) prefill, one decode and one verify step,
        each captured once on a CUDA engine and replayed after that (run
        eagerly on a CPU engine, and on a mesh whose steps cross ranks).
        A body reads its inputs from static views of one packed buffer
        and returns the one tensor the host copies back. The KV pools are
        written in place, so a body returns no cache. A body reaches the
        engine through a weak reference: the engine holds its bodies, and
        a cycle would keep a dropped engine's pools until a collection."""
        model = self.model
        draft = self.draft if self._spec_enabled else None
        k = self.spec_k
        dev = self.device
        engine = weakref.ref(self)

        def prefill_body(v):
            def body():
                # starts: rows already committed by attached prefix-cache
                # blocks — the call prefills only the tail (0 = cold)
                eng = engine()
                params, dparams = eng._step_params()
                _, logits = model.paged_prefill(
                    params, eng._cache, v["ids"], v["tables"],
                    v["lengths"], v["starts"])
                if draft is not None:
                    # the draft cache must hold the same committed rows as
                    # the target's, so the draft prefills in the same step
                    draft.paged_prefill(dparams, eng._dcache, v["ids"],
                                        v["tables"], v["lengths"],
                                        v["starts"])
                return sample_tokens(logits, v["temps"], v["top_ks"],
                                     v["seed"], row_streams(
                                         v["numbers"], v["positions"]))
            return body

        def decode_body(v):
            def body():
                tokens = v["tokens"]
                eng = engine()
                _, logits = model.paged_decode(
                    eng._step_params()[0], eng._cache, v["tables"],
                    tokens[:, None], v["lengths"])
                nxt = sample_tokens(logits[:, 0], v["temps"], v["top_ks"],
                                    v["seed"], row_streams(
                                        v["numbers"], v["positions"]))
                return torch.where(v["active"] != 0, nxt, tokens)
            return body

        def spec_body(v):
            # greedy-only speculative step (Leviathan et al., 2023): draft
            # proposes k tokens one at a time (k+1 steps — the last is
            # write-only so the draft cache covers every row the target
            # may commit), the target verifies all k+1 positions in ONE
            # paged_decode pass, and the longest drafted prefix matching
            # the target's own greedy choices is committed plus one free
            # target token. Rejected rows are overwritten by the next
            # step's writes before any mask admits them. Returns [S, k+2]:
            # the k+1 committed tokens, then how many of them count.
            def body():
                eng = engine()
                params, dparams = eng._step_params()
                tables, tokens, lengths = (v["tables"], v["tokens"],
                                           v["lengths"])
                S = tokens.shape[0]
                prev = tokens
                drafted = []
                for j in range(k + 1):
                    _, dlogits = draft.paged_decode(
                        dparams, eng._dcache, tables, prev[:, None],
                        lengths + j)
                    if j < k:
                        prev = torch.argmax(dlogits[:, 0, :],
                                            dim=-1).to(torch.int32)
                        drafted.append(prev)
                d = torch.stack(drafted, dim=1)                  # [S, k]
                verify_in = torch.cat([tokens[:, None], d], dim=1)
                _, vlogits = model.paged_decode(params, eng._cache, tables,
                                                verify_in, lengths)
                g = torch.argmax(vlogits, dim=-1).to(torch.int32)  # [S, k+1]
                match = (d == g[:, :k]).to(torch.int32)
                n_acc = torch.sum(torch.cumprod(match, dim=1), dim=1)
                idx = torch.arange(k + 1, device=dev)[None, :]
                g_at = torch.gather(g, 1, n_acc[:, None].long())
                pad_d = torch.cat(
                    [d, torch.zeros((S, 1), dtype=torch.int32, device=dev)],
                    dim=1)
                commit = torch.where(idx < n_acc[:, None], pad_d,
                                     torch.where(idx == n_acc[:, None],
                                                 g_at, 0))
                n_commit = torch.where(v["active"] != 0, n_acc + 1,
                                       0).to(torch.int32)
                return torch.cat([commit, n_commit[:, None]], dim=1)
            return body

        self._bodies = {"prefill": prefill_body, "decode": decode_body,
                        "spec": spec_body}
        # a quantized twin carries _precision: its census tags stay apart
        # from the full-precision model's (the first tag segment is the
        # metric's kind label)
        prec = getattr(model, "_precision", None)
        suffix = f":{prec}" if prec else ""
        self._tags = {kind: kind + suffix for kind in self._bodies}
        self._graphs = cuda_graphs.StepGraphs(dev)
        self._steps: Dict[tuple, cuda_graphs.Step] = {}
        #: why every step runs eagerly (``eager:<reason>``): the backend
        #: of a mesh whose steps issue collectives between ranks; None
        #: captures
        self._eager_reason = cuda_graphs.mesh_reason(self.mesh)

    def _fields(self, kind, shape):
        """(name, shape, dtype) of a step's packed inputs; ``shape`` is
        (batch rung, prompt bucket) for a prefill, (slots,) otherwise."""
        i32, f32 = torch.int32, torch.float32
        rows, MB = shape[0], self.max_blocks
        if kind == "prefill":
            return (("ids", (rows, shape[1]), i32),
                    ("tables", (rows, MB), i32),
                    ("lengths", (rows,), i32), ("starts", (rows,), i32),
                    ("temps", (rows,), f32), ("top_ks", (rows,), i32),
                    ("seed", (), i32), ("numbers", (rows,), i32),
                    ("positions", (rows,), i32))
        fields = (("tables", (rows, MB), i32), ("tokens", (rows,), i32),
                  ("lengths", (rows,), i32), ("active", (rows,), i32))
        if kind == "decode":
            fields += (("temps", (rows,), f32), ("top_ks", (rows,), i32),
                       ("seed", (), i32), ("numbers", (rows,), i32),
                       ("positions", (rows,), i32))
        return fields

    def _graph_step(self, kind, shape):
        """The step of one signature: its packed inputs and graph."""
        step = self._steps.get((kind, shape))
        if step is not None:
            return step
        fields = self._fields(kind, shape)
        sig = tuple((n, sh, str(dt).replace("torch.", ""))
                    for n, sh, dt in fields)
        if kind == "prefill" and self._spec_enabled:
            sig += (("draft", self.spec_k),)
        desc = (f"batch={shape[0]} bucket={shape[1]}" if kind == "prefill"
                else f"slots={shape[0]}")
        step = self._steps[(kind, shape)] = self._graphs.step(
            self._tags[kind], sig,
            lambda: cuda_graphs.PackedInputs(self.device, fields), desc)
        return step

    def _launch(self, kind, shape, values, record_kind):
        """One step: fill its static inputs from the host ``values`` (one
        copy to the card), send its record on a sharded leader, run its
        graph, and copy its output to the host (the step's one
        device-to-host copy: the host needs the tokens for its stop
        checks)."""
        step = self._graph_step(kind, shape)

        def run():
            with self._graphs.lock:
                out = self._graphs.run(step, lambda: self._bodies[kind](
                    step.inputs.views), eager=self._eager_reason)
                return out.cpu().numpy()
        with self._graphs.lock:
            buf = step.inputs.fill(values)
        if self._link is None:
            return run()
        return self._link.call(
            record_kind, (torch.tensor(shape, dtype=torch.int32), buf), run)

    def _run_prefill(self, ids, tables, lengths, starts, temps, top_ks,
                     numbers, positions):
        """One batched prefill: ``ids`` [B, Tb] padded prompt *tails*,
        ``tables`` [B, MB] the target slots' block tables, ``lengths`` [B]
        real total prompt lengths, ``starts`` [B] rows already committed
        by attached cached blocks (0 = cold). Returns the B first sampled
        tokens."""
        if faults.active():
            faults.check("decode.prefill", batch=ids.shape[0],
                         bucket=ids.shape[1])
        with self._dispatch_lock, torch.no_grad():
            self._dispatch_started_at = time.monotonic()
            try:
                toks = self._launch(
                    "prefill", tuple(ids.shape),
                    {"ids": ids, "tables": tables, "lengths": lengths,
                     "starts": starts, "temps": temps, "top_ks": top_ks,
                     "seed": self._seed, "numbers": numbers,
                     "positions": positions},
                    sharded.PREFILL)
                return toks
            finally:
                self._dispatch_started_at = None

    def _positions(self) -> np.ndarray:
        """Each slot's rider's tokens so far: the position its next
        sampled token takes (0 for an empty slot)."""
        return np.array([len(r.tokens) if r is not None else 0
                         for r in self._slot_req], np.int32)

    def _run_decode(self, active):
        if faults.active():
            faults.check("decode.step", active=int(np.sum(active)))
        with self._dispatch_lock, torch.no_grad():
            self._dispatch_started_at = time.monotonic()
            try:
                nxt = self._launch(
                    "decode", (self.slots,),
                    {"tables": self._tables, "tokens": self._tokens,
                     "lengths": self._lengths, "active": active,
                     "temps": self._temps, "top_ks": self._topks,
                     "seed": self._seed, "numbers": self._numbers,
                     "positions": self._positions()},
                    sharded.DECODE)
                return nxt
            finally:
                self._dispatch_started_at = None

    def _run_spec(self, active):
        if faults.active():
            faults.check("decode.step", active=int(np.sum(active)),
                         spec=True)
        with self._dispatch_lock, torch.no_grad():
            self._dispatch_started_at = time.monotonic()
            try:
                out = self._launch(
                    "spec", (self.slots,),
                    {"tables": self._tables, "tokens": self._tokens,
                     "lengths": self._lengths, "active": active},
                    sharded.SPEC)
                return out[:, :-1], out[:, -1]
            finally:
                self._dispatch_started_at = None

    # -- warmup ------------------------------------------------------------
    def warmup(self) -> List[int]:
        """Run every step shape once before traffic: one prefill per
        (prompt bucket, batch rung) pair + the decode step (+ the
        speculative step). Idempotent. Warmup rows use the scratch block
        table (all zeros) so no live block is touched. Returns the prompt
        buckets warmed. On a follower of a sharded engine it runs
        nothing: the leader's warmup steps reach it as records."""
        if self._is_follower():
            return list(self.ladder)
        with self._cv:
            if self._active_n > 0:
                raise RuntimeError(
                    "warmup() while sequences are active would overwrite "
                    "live KV rows; warm before taking traffic")
        warmed = []
        for b in self.ladder:
            for bb in self.batch_ladder:
                key = ("prefill", bb, b)
                if key not in self._warmed:
                    self._run_prefill(
                        np.zeros((bb, b), np.int32),
                        np.zeros((bb, self.max_blocks), np.int32),
                        np.ones(bb, np.int32), np.zeros(bb, np.int32),
                        np.zeros(bb, np.float32), np.zeros(bb, np.int32),
                        np.zeros(bb, np.int32), np.zeros(bb, np.int32))
                    self._warmed.add(key)
            warmed.append(b)
        if "decode" not in self._warmed:
            self._run_decode(np.zeros(self.slots, bool))
            self._warmed.add("decode")
        if self._spec_enabled and "spec" not in self._warmed:
            self._run_spec(np.zeros(self.slots, bool))
            self._warmed.add("spec")
        return warmed

    # -- request intake ----------------------------------------------------
    def generate(self, prompt, *, max_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_token="default", on_token: Optional[Callable] = None,
                 timeout_s: Optional[float] = None) -> Future:
        """Enqueue one generation request; returns a Future resolving to
        ``{"tokens", "finish_reason", "ttft_s", "prompt_tokens",
        "completion_tokens", "tokens_per_sec", "phases"}``.

        ``timeout_s`` bounds the wait for a decode *slot*, not the
        generation; an expired request fails with ``TimeoutError`` before
        any model work. ``on_token`` is called from the decode loop with
        each sampled token id. ``eos_token="default"`` uses the engine's
        EOS; ``None`` disables the stop."""
        if self._is_follower():
            raise RuntimeError(
                "generate() on a follower rank of a sharded DecodeEngine: "
                "requests go to the mesh's leader (rank "
                f"{self._link.leader_rank})")
        ids = np.asarray(prompt, np.int32).reshape(-1)
        if ids.size < 1:
            raise ValueError("prompt must contain at least one token")
        if ids.size >= self.max_ctx:
            raise ValueError(
                f"prompt length {ids.size} leaves no room to generate "
                f"within max_ctx {self.max_ctx}")
        cap = self.max_ctx - int(ids.size)
        if max_tokens is None:
            max_tokens = min(environment().decode_max_tokens(), cap)
        max_tokens = max(1, min(int(max_tokens), cap))
        worst = self._blocks_for(int(ids.size) + max_tokens)
        if worst > self._alloc.total:
            raise ValueError(
                f"request may need {worst} KV blocks "
                f"(prompt {ids.size} + max_tokens {max_tokens}, "
                f"block_size {self.block_size}) but the pool holds only "
                f"{self._alloc.total}; raise kv_blocks or lower "
                "max_tokens")
        eos = self.eos_token if eos_token == "default" else eos_token
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        req = _GenRequest(ids, max_tokens, temperature, top_k, eos,
                          on_token, deadline, current_context())
        with self._cv:
            if self._draining or self._closed or self._worker_dead:
                raise EngineClosedError(
                    "DecodeEngine is "
                    + ("closed" if self._closed else
                       "draining" if self._draining else
                       "dead (worker restart budget exhausted)")
                    + "; it no longer accepts requests")
            req.number = self._submitted & 0x7FFFFFFF
            self._submitted += 1
            self._pending.append(req)
            depth = len(self._pending)
            self._cv.notify_all()
        with self._stats_lock:
            self._stats["requests"] += 1
        self._m_requests.inc()
        self._m_queue.set(depth)
        self._ensure_thread()
        return req.future

    def generate_sync(self, prompt, **kw) -> Dict[str, Any]:
        return self.generate(prompt, **kw).result()

    # -- the continuous-batching loop --------------------------------------
    def _ensure_thread(self):
        with self._cv:
            if self._draining or self._closed or self._worker_dead:
                return
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._loop_main, name="dl4j-torch-decode-loop",
                    daemon=True)
                self._thread.start()

    @property
    def worker_dead(self) -> bool:
        """True once the supervised decode loop exhausted its restart
        budget."""
        return self._worker_dead

    def _loop_main(self):
        """Supervised decode loop: a crash that escapes the per-iteration
        handler is counted and the loop restarts with backoff; a crash
        burst past ``DL4J_TPU_ENGINE_MAX_RESTARTS`` declares the worker
        dead and fails everything queued."""
        policy = faults.RetryPolicy(
            max_restarts=environment().engine_max_restarts(),
            base_s=0.01, max_s=2.0, seed=0)
        while True:
            try:
                self._loop()
                return  # normal stop
            except Exception:
                log.exception("decode loop crashed; restarting")
                policy.note_failure()
                self._m_restarts.inc()
                if policy.exhausted():
                    self._worker_died()
                    return
                time.sleep(policy.backoff.next_delay())

    def _worker_died(self):
        with self._cv:
            self._worker_dead = True
            pending, self._pending = self._pending, []
            if self._thread is threading.current_thread():
                self._thread = None
            self._cv.notify_all()
        log.error("decode loop exceeded its restart budget; engine "
                  "refuses new work (worker_dead)")
        exc = EngineClosedError(
            "DecodeEngine worker thread permanently failed "
            "(restart budget exhausted)")
        for req in pending:
            if not req.future.done():
                req.future.set_exception(exc)
        self._fail_dispatch_riders(exc)

    def _loop(self):
        while True:
            # deliberate thread-crash site: raises OUTSIDE the
            # per-iteration handler so only the supervisor catches it
            if faults.active():
                faults.check("decode.loop")
            with self._cv:
                while (not self._pending and self._active_n == 0
                       and not self._stopping):
                    self._cv.wait()
                if (self._stopping and not self._pending
                        and self._active_n == 0):
                    if self._thread is threading.current_thread():
                        self._thread = None
                    return
            try:
                self._admit_pending()
                if self._active_n > 0:
                    self._decode_once()
            except Exception as e:  # a step fault fails only THIS step's
                # riders (the active slots); queued requests stay queued
                log.exception("decode dispatch failed; failing its "
                              "riders only")
                self._fail_dispatch_riders(e)
            self._reconcile_slots()

    def _fail_dispatch_riders(self, exc: Exception):
        """Fail + release only the sequences that rode the failed step
        (every active slot); pending requests survive."""
        for slot, req in enumerate(list(self._slot_req)):
            if req is not None:
                if not req.future.done():
                    req.future.set_exception(exc)
                if req.ctx is not None:
                    record_disposition(req.ctx.trace_id, "engine_restart")
                self._release_slot(slot)

    def _reconcile_slots(self):
        """Slot- and block-lifecycle check: every occupied slot must hold
        a live rider, and the allocator's outstanding blocks must equal
        the occupied slots' tables plus the radix cache's nodes. Drift is
        repaired here and counted (``dl4j_decode_slot_leaks_total`` /
        ``dl4j_kv_block_leaks_total``)."""
        leaked = []
        with self._cv:
            occupied = sum(1 for r in self._slot_req if r is not None)
            if occupied != self._active_n:
                leaked.append(("accounting", occupied - self._active_n))
                self._active_n = occupied
        for slot, req in enumerate(list(self._slot_req)):
            if req is not None and req.future.cancelled():
                self._m_cancelled.inc()
                self._release_slot(slot)
        if leaked:
            self._m_slot_leaks.inc(abs(leaked[0][1]))
            log.warning("decode slot accounting drifted by %d; repaired",
                        leaked[0][1])
        block_drift = 0
        with self._cv:
            # a free slot must hold zero blocks and zero cache
            # attachments; a crashed/cancelled rider's blocks are
            # decref'd, so a block shared elsewhere survives
            for slot, req in enumerate(self._slot_req):
                nb = int(self._nblocks[slot])
                if req is None and (nb > 0 or self._slot_nodes[slot]):
                    block_drift += nb
                    self._alloc.decref(self._tables[slot, :nb])
                    for nd in self._slot_nodes[slot]:
                        nd.refs = max(0, nd.refs - 1)
                    self._slot_nodes[slot] = []
                    self._tables[slot, :] = 0
                    self._nblocks[slot] = 0
            # expected refcounts: one per appearance in an occupied
            # slot's table + one per radix-cache node
            expected: Dict[int, int] = {}
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                for b in self._tables[slot, :int(self._nblocks[slot])]:
                    expected[int(b)] = expected.get(int(b), 0) + 1
            for nd in self._radix.nodes():
                expected[nd.block] = expected.get(nd.block, 0) + 1
            actual = self._alloc.refcounts()
            if expected != actual:
                block_drift += len(
                    {b for b in set(expected) | set(actual)
                     if expected.get(b, 0) != actual.get(b, 0)})
                self._alloc.reset_to(expected)
            # node attachment counts must mirror the slots' lists
            want_refs: Dict[int, int] = {}
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                for nd in self._slot_nodes[slot]:
                    want_refs[id(nd)] = want_refs.get(id(nd), 0) + 1
            for nd in self._radix.nodes():
                want = want_refs.get(id(nd), 0)
                if nd.refs != want:
                    block_drift += 1
                    nd.refs = want
            free = self._alloc.free_count
            cached = self._radix.size
        self._m_blocks_free.set(free)
        self._m_prefix_blocks.set(cached)
        if block_drift:
            self._m_block_leaks.inc(block_drift)
            log.warning("KV block accounting drifted by %d blocks; "
                        "repaired", block_drift)

    # -- block accounting --------------------------------------------------
    def _blocks_for(self, rows: int) -> int:
        """Blocks a sequence needs to hold ``rows`` KV rows (capped at the
        per-slot maximum)."""
        return _cdiv(min(int(rows), self.max_ctx), self.block_size)

    def _grow_slot(self, slot: int, rows: int) -> bool:
        """Extend ``slot``'s table to cover ``rows`` rows, evicting LRU
        cached leaves when the free list alone cannot; False when the
        pool cannot satisfy it at all. Caller holds ``_cv``."""
        need = self._blocks_for(rows)
        have = int(self._nblocks[slot])
        if need <= have:
            return True
        n = need - have
        if n > self._alloc.free_count:
            self._evict_for(n)
        got = self._alloc.alloc(n)
        if got is None:
            return False
        self._tables[slot, have:need] = got
        self._nblocks[slot] = need
        return True

    def _evict_for(self, n: int) -> int:
        """LRU-evict unattached radix leaves until ``n`` blocks are free
        (LIFO preemption stays the backstop). Caller holds ``_cv``."""
        evicted = 0
        while self._alloc.free_count < n:
            leaf = self._radix.lru_leaf()
            if leaf is None:
                break
            self._radix.remove(leaf)
            self._alloc.decref([leaf.block])
            evicted += 1
        if evicted:
            self._radix.evictions += evicted
            self._m_prefix_evictions.inc(evicted)
            self._m_prefix_blocks.set(self._radix.size)
        return evicted

    def _available_blocks(self, exclude=()) -> int:
        """Blocks obtainable without preempting anyone: the free list plus
        everything LRU eviction could free. Caller holds ``_cv``."""
        return self._alloc.free_count + self._radix.reclaimable_count(
            exclude, self._alloc.ref)

    def _match_prefix(self, req: _GenRequest):
        """Longest cached full-block run prefixing ``req.prefix``, capped
        so at least one tail token remains to prefill. Returns
        ``(nodes, rows)``. Caller holds ``_cv``."""
        if not self._prefix_cache:
            return [], 0
        nodes = self._radix.match(req.prefix)
        max_rows = len(req.prefix) - 1
        while nodes and len(nodes) * self.block_size > max_rows:
            nodes.pop()
        return nodes, len(nodes) * self.block_size

    def _attach_nodes(self, slot: int, req: _GenRequest) -> None:
        """Share the matched cached blocks into ``slot``'s table
        (refcount++ on each block, attachment++ on each node). Tail and
        decode rows land in blocks allocated at the divergence point, so
        a shared block is never written. Caller holds ``_cv``."""
        k = len(req.reuse_nodes)
        if k == 0:
            return
        blocks = [nd.block for nd in req.reuse_nodes]
        self._tables[slot, :k] = blocks
        self._nblocks[slot] = k
        self._alloc.incref(blocks)
        for nd in req.reuse_nodes:
            nd.refs += 1
        self._slot_nodes[slot] = list(req.reuse_nodes)

    def _cache_slot_prefix(self, slot: int, req: _GenRequest) -> None:
        """Insert the slot's committed full blocks into the radix tree
        (one tree ref per newly cached block). Caller holds ``_cv``."""
        if not self._prefix_cache:
            return
        committed = int(self._lengths[slot])
        full = committed // self.block_size
        if full <= 0:
            return
        seq = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)]
        ).astype(np.int32)[:committed]
        blocks = [int(b) for b in self._tables[slot, :full]]
        for nd in self._radix.insert(seq, blocks):
            self._alloc.incref([nd.block])
        self._m_prefix_blocks.set(self._radix.size)

    def _blocks_deficit(self, horizon: int) -> int:
        """Additional blocks the active set needs so every rider can write
        ``horizon`` more rows. Caller holds ``_cv``."""
        deficit = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            need = self._blocks_for(int(self._lengths[slot]) + horizon)
            deficit += max(0, need - int(self._nblocks[slot]))
        return deficit

    def _ensure_blocks(self, horizon: int):
        """Guarantee every active rider owns blocks for its next
        ``horizon`` rows, preempting the most recently admitted rider
        (LIFO recompute) when the pool runs dry."""
        while True:
            victim = failed = None
            with self._cv:
                if self._blocks_deficit(horizon) <= self._available_blocks():
                    for slot, req in enumerate(self._slot_req):
                        if req is not None:
                            ok = self._grow_slot(
                                slot, int(self._lengths[slot]) + horizon)
                            if not ok:
                                raise RuntimeError(
                                    "KV block deficit accounting went "
                                    "stale")
                    self._m_blocks_free.set(self._alloc.free_count)
                    return
                riders = [(req.admit_seq, slot, req)
                          for slot, req in enumerate(self._slot_req)
                          if req is not None]
                if len(riders) <= 1:
                    # nothing left to preempt (generate() validation makes
                    # this unreachable; the guard covers drifted state)
                    failed = (riders[0][1], riders[0][2])
                else:
                    _, vslot, vreq = max(riders)
                    victim = (vslot, vreq)
            if failed is not None:
                slot, req = failed
                if not req.future.done():
                    req.future.set_exception(RuntimeError(
                        "KV block pool exhausted with no rider left "
                        "to preempt; raise kv_blocks"))
                self._release_slot(slot)
                return
            self._preempt(*victim)

    def _preempt(self, slot: int, req: _GenRequest):
        """Recompute-preemption: drop ``req`` from its slot, return its
        blocks, and requeue it at the queue head with prompt + generated
        tokens as the new prefix. Its committed full blocks are cached
        first, so on re-admit it re-attaches them unless pool pressure
        evicted them meanwhile."""
        with self._cv:
            if self._slot_req[slot] is not req:
                return
            req.prefix = np.concatenate(
                [req.prompt,
                 np.asarray(req.tokens, np.int32)]).astype(np.int32)
            self._pending.insert(0, req)
            depth = len(self._pending)
            self._cache_slot_prefix(slot, req)
        self._release_slot(slot)
        req.slot = None
        with self._stats_lock:
            self._stats["preempted"] += 1
        self._m_preempted.inc()
        self._m_queue.set(depth)
        log.info("preempted slot %d (seq len %d) for KV blocks; requeued",
                 slot, len(req.prefix))

    # -- admission ---------------------------------------------------------
    def _admit_pending(self):
        """Fill free slots from the queue (the join half of continuous
        batching, between every decode step). Each queued prompt first
        walks the radix cache; requests are grouped by TAIL bucket.
        Admission is capped by free slots, available blocks and
        ``prefill_batch``; the queue head is always first in its group."""
        while True:
            expired: List[_GenRequest] = []
            group: List[_GenRequest] = []
            slots_for: List[int] = []
            bucket = None
            with self._cv:
                while self._pending and self._pending[0].expired():
                    expired.append(self._pending.pop(0))
                free_slots = [i for i, r in enumerate(self._slot_req)
                              if r is None]
                self._m_queue.set(len(self._pending))
                if self._pending and free_slots:
                    head = self._pending[0]
                    h_nodes, h_start = self._match_prefix(head)
                    bucket = bucket_for(len(head.prefix) - h_start,
                                        self.ladder)
                    # blocks promised to the group so far; matched nodes
                    # are pinned out of the evictable budget
                    pinned: set = set()
                    committed = 0
                    need = (self._blocks_for(len(head.prefix) + 1)
                            - len(h_nodes))
                    if bucket is not None and need <= \
                            self._available_blocks(set(h_nodes)):
                        head.reuse_nodes, head.start = h_nodes, h_start
                        pinned.update(h_nodes)
                        committed += need
                        group.append(head)
                        cap = min(len(free_slots), self.prefill_batch)
                        for req in self._pending[1:]:
                            if len(group) >= cap:
                                break
                            if req.expired():
                                expired.append(req)
                                continue
                            r_nodes, r_start = self._match_prefix(req)
                            if bucket_for(len(req.prefix) - r_start,
                                          self.ladder) != bucket:
                                continue
                            need = (self._blocks_for(len(req.prefix) + 1)
                                    - len(r_nodes))
                            if committed + need > self._available_blocks(
                                    pinned | set(r_nodes)):
                                continue
                            req.reuse_nodes, req.start = r_nodes, r_start
                            pinned.update(r_nodes)
                            committed += need
                            group.append(req)
                        for req in group + expired:
                            if req in self._pending:
                                self._pending.remove(req)
                        slots_for = free_slots[:len(group)]
                        # attach every member's cached run BEFORE any
                        # grow: attachment pins the nodes, so one member's
                        # eviction never frees a block another matched
                        for req, slot in zip(group, slots_for):
                            self._attach_nodes(slot, req)
                        for req, slot in zip(group, slots_for):
                            if not self._grow_slot(slot,
                                                   len(req.prefix) + 1):
                                raise RuntimeError(
                                    "admission block budget went stale")
                        self._m_blocks_free.set(self._alloc.free_count)
                        self._m_queue.set(len(self._pending))
            for req in expired:
                self._expire(req)
            if not group:
                return
            try:
                self._start_group(group, slots_for, bucket)
            except Exception as e:
                for req, slot in zip(group, slots_for):
                    if not req.future.done():
                        req.future.set_exception(e)
                    with self._cv:
                        blks = self._tables[slot,
                                            :int(self._nblocks[slot])]
                        self._alloc.decref(blks)
                        for nd in self._slot_nodes[slot]:
                            nd.refs = max(0, nd.refs - 1)
                        self._slot_nodes[slot] = []
                        self._tables[slot, :] = 0
                        self._nblocks[slot] = 0
                        self._m_blocks_free.set(self._alloc.free_count)
                    if self._slot_req[slot] is req:
                        self._release_slot(slot)
                return

    def _expire(self, req: _GenRequest):
        if not req.future.done():
            req.future.set_exception(TimeoutError(
                "generation deadline expired before a decode slot freed"))
        with self._stats_lock:
            self._stats["expired"] += 1
        self._m_expired.inc()
        if req.ctx is not None and self._reg.enabled:
            tracer().record("generation/queue_expired", req.t_submit,
                            time.perf_counter(), context=req.ctx,
                            prompt_tokens=int(req.prompt.size),
                            error="TimeoutError")

    def _start_group(self, group: List[_GenRequest], slots: List[int],
                     bucket: int):
        """Prefill a same-TAIL-bucket group in ONE call (padded up the
        batch ladder; padding rows write the scratch block) and sample
        each request's first token. A member with an attached cached
        prefix ships only its uncached tail."""
        B = len(group)
        bb = bucket_for(B, self.batch_ladder)
        ids = np.zeros((bb, bucket), np.int32)
        tables = np.zeros((bb, self.max_blocks), np.int32)
        lengths = np.ones(bb, np.int32)
        starts = np.zeros(bb, np.int32)
        temps = np.zeros(bb, np.float32)
        topks = np.zeros(bb, np.int32)
        numbers = np.zeros(bb, np.int32)
        positions = np.zeros(bb, np.int32)
        for r, (req, slot) in enumerate(zip(group, slots)):
            p = req.prefix
            s = int(req.start)
            tail = p[s:]
            ids[r, :tail.size] = tail
            tables[r] = self._tables[slot]
            lengths[r] = p.size
            starts[r] = s
            temps[r] = req.temperature
            topks[r] = req.top_k
            numbers[r] = req.number
            positions[r] = len(req.tokens)
        t0 = time.perf_counter()
        toks = self._run_prefill(ids, tables, lengths, starts, temps,
                                 topks, numbers, positions)
        t_done = time.perf_counter()
        hits = sum(1 for req in group if req.start > 0)
        reused = int(sum(req.start for req in group))
        with self._stats_lock:
            self._stats["prefills"] += B
            self._stats["prefill_dispatches"] += 1
            self._stats["prefill_rows"] += int(
                sum(len(req.prefix) - req.start for req in group))
            if self._prefix_cache:
                self._stats["prefix_hits"] += hits
                self._stats["prefix_misses"] += B - hits
                self._stats["prefix_reused_rows"] += reused
        if self._prefix_cache:
            if hits:
                self._m_prefix_hits.inc(hits)
            if B - hits:
                self._m_prefix_misses.inc(B - hits)
        for r, (req, slot) in enumerate(zip(group, slots)):
            tok = int(toks[r])
            first = req.t_first is None
            if req.t_prefill0 is None:
                # a preempted rider keeps its original boundary so queue
                # attribution stays honest across requeues
                req.t_prefill0 = t0
            if first:
                req.t_first = t_done
            if self._reg.enabled:
                if first:
                    self._m_ttft.observe(
                        req.t_first - req.t_submit,
                        exemplar=req.ctx.trace_id if req.ctx else None)
                if req.ctx is not None:
                    tracer().record(
                        "generation/prefill", t0, t_done, context=req.ctx,
                        slot=slot, prompt_tokens=int(req.prefix.size),
                        cached_tokens=int(req.start),
                        bucket=bucket, batch=B,
                        queue_s=round(t0 - req.t_submit, 6))
            req.slot = slot
            with self._cv:
                self._admit_counter += 1
                req.admit_seq = self._admit_counter
                self._slot_req[slot] = req
                self._active_n += 1
            self._m_active.set(self._active_n)
            self._tokens[slot] = tok
            self._lengths[slot] = int(req.prefix.size)
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            self._numbers[slot] = req.number
            with self._cv:
                # publish the just-committed prompt blocks (decode writes
                # land strictly past the prefix)
                self._cache_slot_prefix(slot, req)
            self._emit_token(req, tok)
            self._check_stop(req, slot, tok)

    # -- decode ------------------------------------------------------------
    def _spec_ready(self) -> bool:
        """True when this iteration can take the speculative step: every
        active rider is greedy with k+1 rows of context headroom, and the
        pool covers the k+1-row horizon without preempting anyone."""
        if not self._spec_enabled:
            return False
        k = self.spec_k
        with self._cv:
            riders = [slot for slot, r in enumerate(self._slot_req)
                      if r is not None]
            if not riders:
                return False
            for slot in riders:
                if self._temps[slot] > 0:
                    return False
                if int(self._lengths[slot]) + k + 1 > self.max_ctx:
                    return False
            return self._blocks_deficit(k + 1) <= self._available_blocks()

    def _decode_once(self):
        spec = self._spec_ready()
        self._ensure_blocks(self.spec_k + 1 if spec else 1)
        active = np.array([r is not None for r in self._slot_req])
        if not active.any():
            return
        if spec:
            self._spec_once(active)
        else:
            nxt = self._run_decode(active)
            with self._stats_lock:
                self._stats["decode_steps"] += 1
            self._m_steps.inc()
            for slot, req in enumerate(list(self._slot_req)):
                if req is None:
                    continue
                self._lengths[slot] += 1
                tok = int(nxt[slot])
                self._tokens[slot] = tok
                self._emit_token(req, tok)
                self._check_stop(req, slot, tok)

    def _spec_once(self, active):
        commit, n_commit = self._run_spec(active)
        k = self.spec_k
        n_active = int(np.sum(active))
        accepted = int(np.sum(np.maximum(n_commit[active] - 1, 0)))
        with self._stats_lock:
            self._stats["decode_steps"] += 1
            self._stats["spec_steps"] += 1
            self._stats["spec_proposed"] += k * n_active
            self._stats["spec_accepted"] += accepted
        self._m_steps.inc()
        self._m_spec_proposed.inc(k * n_active)
        self._m_spec_accepted.inc(accepted)
        for slot, req in enumerate(list(self._slot_req)):
            if req is None:
                continue
            for j in range(int(n_commit[slot])):
                tok = int(commit[slot, j])
                self._lengths[slot] += 1
                self._tokens[slot] = tok
                self._emit_token(req, tok)
                self._check_stop(req, slot, tok)
                if self._slot_req[slot] is not req:
                    break  # finished mid-prefix: drop the rest

    def _emit_token(self, req: _GenRequest, tok: int):
        req.tokens.append(tok)
        with self._stats_lock:
            self._stats["tokens"] += 1
        self._m_tokens.inc()
        if self._reg.enabled:
            now = time.perf_counter()
            if req.t_last is not None:
                self._m_itl.observe(now - req.t_last)
            req.t_last = now
            # goodput: every token of a request whose TTFT met the
            # latency objective counts as slo=ok; no objective means
            # nothing can violate
            obj = self._slo_latency_s
            ttft = (req.t_first - req.t_submit) \
                if req.t_first is not None else None
            (self._m_tok_ok if obj is None
             or (ttft is not None and ttft <= obj)
             else self._m_tok_violated).inc()
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                log.exception("on_token callback raised; token dropped "
                              "from the stream")

    def _check_stop(self, req: _GenRequest, slot: int, tok: int):
        reason = None
        if req.eos is not None and tok == req.eos:
            reason = "eos"
        elif len(req.tokens) >= req.max_tokens:
            reason = "length"
        elif int(self._lengths[slot]) >= self.max_ctx:
            reason = "length"   # context full: no cache row left to write
        if reason is not None:
            self._finish(req, slot, reason)

    def _finish(self, req: _GenRequest, slot: int, reason: str):
        t_done = time.perf_counter()
        if req.ctx is not None and self._reg.enabled:
            tracer().record("generation/decode", req.t_first or t_done,
                            t_done, context=req.ctx, slot=slot,
                            tokens=len(req.tokens), finish_reason=reason)
        with self._cv:
            # cache prompt + generated full blocks for the session's next
            # turn
            self._cache_slot_prefix(slot, req)
        self._release_slot(slot)
        ttft = ((req.t_first - req.t_submit)
                if req.t_first is not None else None)
        gen_s = t_done - (req.t_first or req.t_submit)
        phases = {
            "queue_s": round(req.t_prefill0 - req.t_submit, 6)
            if req.t_prefill0 is not None else None,
            "prefill_s": round(req.t_first - req.t_prefill0, 6)
            if req.t_first is not None and req.t_prefill0 is not None
            else None,
            "decode_s": round(t_done - req.t_first, 6)
            if req.t_first is not None else None,
        }
        if not req.future.done():
            req.future.set_result({
                "tokens": list(req.tokens),
                "finish_reason": reason,
                "prompt_tokens": int(req.prompt.size),
                "completion_tokens": len(req.tokens),
                "ttft_s": round(ttft, 6) if ttft is not None else None,
                "tokens_per_sec": round(len(req.tokens) / gen_s, 3)
                if gen_s > 0 else None,
                "phases": phases,
            })

    def _release_slot(self, slot: int):
        with self._cv:
            if self._slot_req[slot] is not None:
                self._slot_req[slot] = None
                self._active_n -= 1
            # the slot RELEASES its blocks (refcount--): a block cached in
            # the radix tree or shared with another slot survives. Stale
            # KV rows stay in freed blocks, but lengths=0 and a zeroed
            # table mask them out of every later read
            nb = int(self._nblocks[slot])
            if nb > 0:
                self._alloc.decref(self._tables[slot, :nb])
                self._tables[slot, :] = 0
                self._nblocks[slot] = 0
            for nd in self._slot_nodes[slot]:
                nd.refs = max(0, nd.refs - 1)
            self._slot_nodes[slot] = []
            self._lengths[slot] = 0
            self._tokens[slot] = 0
            free = self._alloc.free_count
            self._cv.notify_all()
        self._m_active.set(self._active_n)
        self._m_blocks_free.set(free)

    # -- lifecycle -----------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining and not self._closed

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self):
        with self._cv:
            if self._closed:
                raise EngineClosedError(
                    "DecodeEngine is closed; it cannot be restarted")
            self._draining = False
        self._ensure_thread()
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, finish queued + in-flight generations, stop the
        loop. Reversible via ``start()``. On a follower of a sharded
        engine: :meth:`join`."""
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
        with self._cv:
            leftovers, self._pending = self._pending, []
            drained = (self._active_n == 0
                       and (t is None or not t.is_alive()))
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(EngineClosedError(
                    "DecodeEngine drained before this request was "
                    "scheduled"))
        return drained

    def close(self, timeout_s: float = 30.0) -> bool:
        """Permanent :meth:`drain`; a sharded leader then ends the
        followers' engine. The captured steps' graphs and their memory
        pool go (``StepGraphs.release``)."""
        self._closed = True
        drained = self.drain(timeout_s)
        if self._link is not None:
            self._link.close()
        with self._dispatch_lock:
            self._graphs.release()
        return drained

    def stop(self):
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=30)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- introspection -----------------------------------------------------
    def observed_entries(self) -> List[dict]:
        """Manifest handoff compatibility: generative warmup is fully
        determined by (slots, max_ctx, ladder, batch ladder), so there is
        nothing to replay from observed traffic."""
        return []

    def debug_snapshot(self) -> Dict[str, Any]:
        """Live slot map + block tables: which sequence owns which slot,
        how many rows it committed, which pool blocks back it — plus the
        ``kernels`` section (``kernels.dispatch_snapshot()``: which path
        served the last call per kernel family, and why)."""
        from ..kernels import dispatch_snapshot

        with self._cv:
            slots = []
            for slot, req in enumerate(self._slot_req):
                nb = int(self._nblocks[slot])
                entry = {"slot": slot, "active": req is not None,
                         "length": int(self._lengths[slot]),
                         "blocks": [int(b)
                                    for b in self._tables[slot, :nb]]}
                if req is not None:
                    entry.update({
                        "prompt_tokens": int(req.prompt.size),
                        "generated": len(req.tokens),
                        "temperature": req.temperature,
                        "trace_id": req.ctx.trace_id if req.ctx else None,
                    })
                slots.append(entry)
            snap = {
                "model": self.model_name,
                "device": str(self.device),
                "slots": slots,
                "queue_depth": len(self._pending),
                "pool": {"block_size": self.block_size,
                         "total_blocks": self._alloc.total,
                         "free_blocks": self._alloc.free_count,
                         "max_blocks_per_slot": self.max_blocks,
                         "scratch_block": 0},
                "prefix_cache": {
                    "enabled": self._prefix_cache,
                    "cached_blocks": self._radix.size,
                    "evictions": self._radix.evictions,
                    # most-recently-used first, bounded
                    "nodes": [{"digest": nd.digest, "block": nd.block,
                               "refs": nd.refs,
                               "children": len(nd.children),
                               "last_used": nd.last_used}
                              for nd in sorted(
                                  self._radix.nodes(),
                                  key=lambda n: -n.last_used)[:64]],
                },
                "prefill": {"batch": self.prefill_batch,
                            "buckets": list(self.ladder),
                            "batch_ladder": list(self.batch_ladder)},
                "speculative": {"enabled": self._spec_enabled,
                                "k": self.spec_k},
                "worker_dead": self._worker_dead,
                "draining": self._draining,
                "closed": self._closed,
                "kernels": dispatch_snapshot(),
            }
            sharded.report(snap, self.mesh, self.param_spec)
        with self._stats_lock:
            snap["speculative"]["proposed"] = self._stats["spec_proposed"]
            snap["speculative"]["accepted"] = self._stats["spec_accepted"]
            prop = self._stats["spec_proposed"]
            snap["speculative"]["acceptance_rate"] = (
                round(self._stats["spec_accepted"] / prop, 4)
                if prop else None)
        return snap

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            s = dict(self._stats)
        with self._cv:
            s["active_slots"] = self._active_n
            s["queued"] = len(self._pending)
            s["kv_blocks_free"] = self._alloc.free_count
            s["prefix_cached_blocks"] = self._radix.size
            s["prefix_evictions"] = self._radix.evictions
        s["prefix_cache"] = self._prefix_cache
        s["slots"] = self.slots
        s["max_ctx"] = self.max_ctx
        s["prompt_buckets"] = list(self.ladder)
        s["kv_block_size"] = self.block_size
        s["kv_blocks"] = self.kv_blocks
        s["prefill_batch"] = self.prefill_batch
        s["spec_k"] = self.spec_k if self._spec_enabled else 0
        s["graphs"] = self._graphs.report()
        if s["spec_proposed"]:
            s["spec_acceptance"] = round(
                s["spec_accepted"] / s["spec_proposed"], 4)
        return sharded.report(s, self.mesh, self.param_spec)
