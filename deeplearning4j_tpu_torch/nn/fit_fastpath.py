"""The fit loop, mixed precision and memory levers of the layer API.

Counterpart of ``deeplearning4j_tpu/nn/fit_fastpath.py``:

- **Mixed precision** (``conf.dtype = "bfloat16"``): the layer body runs
  in bf16 while master params, updater state, batch-norm running stats
  and the loss head stay f32. ``_cast_layer_params`` casts floating
  tensors only, so an int8 twin's ``QuantizedTensor`` weights pass
  through untouched and stay int8 at rest.
- **Full f32 unless TF32 is asked for**: every forward and backward of a
  network runs under :func:`full_f32`, so an f32 matmul or convolution
  on the card gives f32 results whatever the process's TF32 flags say,
  unless ``set_property("matmul_precision", "high")`` applied TF32.
- **The epoch loop**: finite sources are staged on the network's device
  once per ``fit``; with no listener overriding ``iteration_done``, an
  epoch runs its steps back to back with the loss left on the device
  (``path="scan"`` in the telemetry, the JAX package's scanned epoch).
- **Captured steps**: every training step runs through the network's
  ``runtime.cuda_graphs.StepGraphs``. On a CUDA network each signature
  is captured once as a CUDA graph and replayed after that, on the
  per-step path (listeners, streamed iterators) and on the epoch path,
  whose step is captured once and replayed n times; on the CPU the same
  body runs eagerly on the same buffers. The step's static inputs are
  the network's own params, layer states and updater state (the body
  ends by copying its new values into them, one ``_foreach_copy_``), x,
  y, the iteration and the step key (0-d int64 tensors filled before
  each run): schedules, Adam's bias correction, dropout and weight noise
  advance on every replay. A step stays eager, with its reason in the
  census and in :meth:`FitFastPathMixin.train_graphs_report`, on a mesh
  (``eager:<backend>``, ``eager:mesh`` at one rank) and with a schedule
  that answers a tensor with a host number (``eager:host_value``).
- **The census**: the step and the epoch record the JAX package's tags
  (``train:<id>:k<k>:<remat>``, ``epoch:...``), one
  ``dl4j_compiles_total`` event per new signature (``cache="captured"``
  on the card), as the JAX package's ``counted_jit`` does, and a repeat
  call none. ``warm_compile`` records the step's event without running
  it, and pulls or builds every kernel library through the artifact
  store (``kernels/_build.py``).
- **Activation checkpointing** (``conf.remat``): ``"layer"`` wraps each
  layer apply in ``torch.utils.checkpoint``, ``"dots_saveable"`` in a
  selective checkpoint that keeps matmul and convolution outputs.
- **Gradient accumulation** (``conf.grad_accum = k``): each batch splits
  into k micro-batches whose gradients are averaged before one updater
  step; stateful layers refresh per micro-batch.

The mixin serves both network classes, whose params are a list
(``MultiLayerNetwork``) or a vertex-name -> dict (``ComputationGraph``)
of per-layer dicts: it stages inputs, adds the L1/L2 penalties and runs
clip -> updater -> weight decay -> constraints (``_apply_update``) over
either. Subclasses provide ``_micro_grads`` (loss, refreshed states and
gradients of one micro-batch), ``_step_fn``, ``_materialize_batches``,
``_stage_batch`` and ``_coerce_fit_data``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..common import rng
from ..common.environment import environment, tf32_applied
from ..common.tracing import span
from ..learning import host_schedules, tree_map
from ..ndarray.ndarray import NDArray
from .conf.constraints import apply_constraints

REMAT_MODES = ("none", "layer", "dots_saveable")

_END = object()  # iterator-exhausted sentinel

#: the products "dots_saveable" keeps for the backward pass
_SAVED_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm,
                   torch.ops.aten.bmm, torch.ops.aten.convolution)


def _keep_products(ctx, op, *args, **kwargs):
    if getattr(op, "overloadpacket", op) in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_saveable = functools.partial(create_selective_checkpoint_contexts,
                                   _keep_products)


_f32_lock = threading.Lock()
_f32_holders = 0
_f32_saved = None


@contextlib.contextmanager
def full_f32():
    """The applied ``matmul_precision`` level for the matmuls and
    convolutions run inside (the flags restored after): TF32 off, so the
    port computes f32 products in f32 as the JAX package does on the CPU,
    unless ``set_property("matmul_precision", "high")`` (or
    "tensorfloat32") applied TF32.

    The flags are process-wide, and two threads (two engines' batchers,
    or a batcher and a caller) may hold this at once: the first holder
    saves and clears them, the last one out restores them, so no holder
    sees TF32 come back while its products run."""
    global _f32_holders, _f32_saved
    with _f32_lock:
        if _f32_holders == 0:
            _f32_saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            tf32 = tf32_applied()
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        _f32_holders += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_holders -= 1
            if _f32_holders == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _f32_saved


def _leaves(tree) -> list:
    """The tensors of a dict/list/tuple nest (dict keys in order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _batch_rows(tree) -> int:
    """Leading dim of the first batched tensor of ``tree`` (0 if none)."""
    for leaf in _leaves(tree):
        if leaf.dim():
            return int(leaf.shape[0])
    return 0


def _micro_batches(tree, k):
    """``tree`` cut into k trees of equal row count along dim 0."""
    def rows(t):
        if t.shape[0] % k:
            raise ValueError(f"grad_accum={k} does not divide batch dim "
                             f"{t.shape[0]} (shape {tuple(t.shape)})")
        return t.shape[0] // k
    return [tree_map(lambda t, _i=i: t[_i * rows(t):(_i + 1) * rows(t)],
                     tree) for i in range(k)]


def micro_keys(key, k: int, device) -> list:
    """The keys of a step's k micro-batches, derived from its key on the
    device (``common/rng.py``)."""
    key = rng.as_key(key, device)
    return [rng.fold(key, m) for m in range(k)]


class FitFastPathMixin:
    # -- the params ------------------------------------------------------
    @property
    def _params(self):
        """The param tree. Setting it (``init(params=)``, ``set_params``,
        a load, ``distribute``) lets go of the captured graphs that hold
        the old tensors: the inference forward's
        (``runtime/inference.py::captured_dispatch``) and the training
        steps'. They and their pools are freed now, not at the next call,
        which captures again. ``fit`` itself never sets it: its steps
        write the new values into the same tensors."""
        try:
            return self.__dict__["_params"]
        except KeyError:
            raise AttributeError("_params") from None

    @_params.setter
    def _params(self, value):
        self.__dict__["_params"] = value
        fns = self.__dict__.get("_out_fns")
        if fns:
            from ..runtime.inference import release_captured
            release_captured(fns.values())
        graphs = self.__dict__.get("_fit_graphs")
        if graphs is not None:
            graphs.release()

    # -- memory levers ---------------------------------------------------
    def _remat_mode(self) -> str:
        """conf.remat, falling back to the Environment default
        (DL4J_TPU_REMAT) when the conf leaves it unset."""
        mode = getattr(self.conf, "remat", None)
        if mode is None:
            mode = environment().training_remat()
        mode = str(mode or "none")
        if mode not in REMAT_MODES:
            raise ValueError(f"conf.remat must be one of {REMAT_MODES}, "
                             f"got {mode!r}")
        return mode

    def _grad_accum(self) -> int:
        """conf.grad_accum, falling back to the Environment default
        (DL4J_TPU_GRAD_ACCUM) when the conf leaves it unset (0/None)."""
        k = getattr(self.conf, "grad_accum", 0) or 0
        if int(k) <= 0:
            k = environment().training_grad_accum()
        return max(int(k), 1)

    def _remat_wrap(self, fn):
        """Wrap a layer apply per the remat policy: under "layer" only the
        call's inputs survive to the backward pass (everything inside is
        recomputed); "dots_saveable" also keeps matmul and convolution
        outputs. A layer's key is a tensor input of the checkpointed call,
        so the recompute draws the same masks."""
        mode = self._remat_mode()
        if mode == "none":
            return fn
        if mode == "layer":
            return functools.partial(checkpoint, fn, use_reentrant=False)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_dots_saveable)

    # -- mixed precision -------------------------------------------------
    def _compute_dtype(self):
        """conf.dtype as a torch dtype, or None for plain f32 (no casting)."""
        cd = str(getattr(self.conf, "dtype", "float32") or "float32")
        return None if cd in ("float32", "f32", "FLOAT") else getattr(torch,
                                                                      cd)

    @staticmethod
    def _cast_layer_params(p, dt):
        return {k: (v.to(dt) if (not k.startswith("state_")
                                 and isinstance(v, torch.Tensor)
                                 and v.is_floating_point()) else v)
                for k, v in p.items()}

    @staticmethod
    def _cast_act(h, dt):
        return h.to(dt) if h.is_floating_point() else h

    # -- staging and the update (shared by both network classes) ---------
    def _stage(self, x) -> torch.Tensor:
        """An input on the network's device; float64 host data becomes
        float32, as the JAX package's default does."""
        t = x.torch() if isinstance(x, NDArray) else x
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    def _regularized(self, loss, trainable):
        """L1/L2 penalties (reference BaseLayer.calcRegularizationScore)."""
        if self.conf.l2 > 0 or self.conf.l1 > 0:
            for v in _leaves(trainable):
                if self.conf.l2 > 0:
                    loss = loss + 0.5 * self.conf.l2 * torch.sum(v * v)
                if self.conf.l1 > 0:
                    loss = loss + self.conf.l1 * torch.sum(torch.abs(v))
        return loss

    def _clip_grads(self, grads):
        """conf.gradient_normalization (clip_l2 / clip_value) applied."""
        grad_norm = self.conf.gradient_normalization
        clip = self.conf.gradient_clip
        if grad_norm == "clip_l2":
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in _leaves(grads)))
            scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12), 1.0)
            return tree_map(lambda g: g * scale, grads)
        if grad_norm == "clip_value":
            return tree_map(lambda g: torch.clamp(g, -clip, clip), grads)
        return grads

    @torch.no_grad()
    def _apply_update(self, trainable, updater_state, iteration, grads):
        """Clip -> updater -> weight decay -> constraints."""
        grads = self._clip_grads(grads)
        update, updater_state = self.conf.updater.apply(grads, updater_state,
                                                        iteration)
        wd = self.conf.weight_decay
        new = tree_map(lambda p, u: p - u.to(p.dtype) - wd * p, trainable,
                       update)
        return apply_constraints(getattr(self.conf, "constraints", None),
                                 new), updater_state

    # -- the captured training steps -------------------------------------
    def _train_graphs(self):
        """The network's :class:`~..runtime.cuda_graphs.StepGraphs`: its
        training steps (``train``, ``epoch``) and the eager steps that
        report beside them (solvers, ``ParallelWrapper``,
        ``fit_accumulated``)."""
        graphs = self.__dict__.get("_fit_graphs")
        if graphs is None:
            from ..runtime.cuda_graphs import StepGraphs
            graphs = self.__dict__["_fit_graphs"] = StepGraphs(self.device)
        return graphs

    def train_graphs_report(self) -> list:
        """One entry a training-step signature (``StepGraphs.report``):
        its tag, ``cache`` (``captured``, ``eager`` on the CPU,
        ``eager:<reason>``), captures and replays."""
        return self._train_graphs().report()

    def _train_eager_reason(self) -> Optional[str]:
        """Why this network's ``fit`` steps run eagerly, or None: the
        backend of a mesh whose collectives cross ranks (``mesh`` at one
        rank, not captured yet), or ``host_value`` for a schedule that
        answers a tensor iteration with a host number. A network's
        ``_eager_reason``, where set, keeps its steps eager under that
        reason (the reference the card's checks hold replays against)."""
        forced = self.__dict__.get("_eager_reason")
        if forced:
            return forced
        mesh = getattr(self, "_mesh", None)
        if mesh is not None:
            from ..runtime.cuda_graphs import mesh_reason
            return mesh_reason(mesh) or "mesh"
        if host_schedules(self.conf.updater):
            return "host_value"
        return None

    def _state_leaves(self) -> list:
        """The tensors of the params and the updater state, in order."""
        return [t for t in _leaves([self._params, self._updater_state])
                if isinstance(t, torch.Tensor)]

    def _own_state(self) -> None:
        """Make the params and the updater state the network's own static
        buffers before ``fit`` writes into them: the first time, and
        again after either was replaced from outside, each tensor is
        cloned (a tensor may be shared: with the caller of
        ``init(params=)``, a transfer-learning source, a bridge), except
        on a mesh, whose shards ``distribute`` made for this network."""
        owned = self.__dict__.get("_owned")
        leaves = self._state_leaves()
        if owned is not None and len(owned) == len(leaves) \
                and all(r() is t for r, t in zip(owned, leaves)):
            return
        if getattr(self, "_mesh", None) is None:
            def own(t):
                return t.clone() if isinstance(t, torch.Tensor) else t
            ustate = self._updater_state
            self._params = tree_map(own, self._params)
            self._updater_state = None if ustate is None \
                else tree_map(own, ustate)
        else:
            self._train_graphs().release()
        self.__dict__["_owned"] = [weakref.ref(t)
                                   for t in self._state_leaves()]

    @staticmethod
    @torch.no_grad()
    def _write_back(static, new) -> None:
        """Copy each tensor of ``new`` into the tensor at its place in
        ``static`` (trees of one structure), one ``_foreach_copy_``."""
        dst, src = [], []

        def pair(d, s):
            if isinstance(d, torch.Tensor) and d is not s:
                dst.append(d)
                src.append(s)
        tree_map(pair, static, new)
        if dst:
            torch._foreach_copy_(dst, src)

    def _step_in_place(self, ins):
        """One training step on the static inputs ``ins`` (x, y, the
        iteration and the key): the new params, states and updater state
        written into the network's own tensors; returns the loss."""
        static = (self._trainable(self._params), self._states(self._params),
                  self._updater_state)
        *new, loss = self._train_step_fn()(*static, ins["it"], ins["x"],
                                           ins["y"], ins["key"])
        self._write_back(list(static), new)
        return loss

    def _step_tag(self, kind: str) -> str:
        """The JAX package's census tag of this network's ``kind`` step
        (``train`` or ``epoch``) and build knobs."""
        return f"{kind}:{id(self)}:k{self._grad_accum()}:{self._remat_mode()}"

    def _step_of(self, kind, state_sig, x, y, n=None):
        """The :class:`~..runtime.cuda_graphs.Step` of one signature:
        static x and y shaped as these, the iteration and the key; the
        epoch's signature also holds its batch count, as the JAX
        package's stacked epoch does."""
        from ..runtime.inference import _signature
        sig = state_sig + _signature((x, y))
        if n is not None:
            sig += (("batches", n),)
        dev = self.device

        def inputs():
            def buf(t):
                return torch.empty_like(t, device=dev)
            return {"x": tree_map(buf, x), "y": tree_map(buf, y),
                    "it": torch.zeros((), dtype=torch.int64, device=dev),
                    "key": torch.zeros((), dtype=torch.int64, device=dev)}
        return self._train_graphs().step(self._step_tag(kind), sig, inputs)

    def _run_step(self, step, x, y, key, graph_key, eager):
        """Fill ``step``'s static inputs (x, y, ``self._iteration``,
        ``key``) and run it: its graph's replay, or its body. Returns the
        loss (on a replay the graph's own, good until its next run)."""
        graphs = self._train_graphs()
        ins = step.inputs
        net = weakref.ref(self)   # the graphs must not hold the network

        def make_body():
            return lambda: net()._step_in_place(ins)
        with graphs.lock:
            tree_map(lambda d, s: d.copy_(s), ins["x"], x)
            tree_map(lambda d, s: d.copy_(s), ins["y"], y)
            ins["it"].fill_(self._iteration)
            ins["key"].fill_(key)
            return graphs.run(step, make_body, graph_key, eager=eager)

    # -- distribution (``distribute(mesh)``, nn/sharding.py) -------------
    def _distribute(self, mesh, sharded_params):
        """Keep ``sharded_params`` (this rank's shards), re-initialise the
        updater state from them and drop the cached steps, as the JAX
        package's ``distribute`` does."""
        from ..common.mesh import placement, tag
        self._mesh = mesh
        self.device = mesh.device
        self._params = sharded_params
        trainable = self._trainable(self._params)
        state = self.conf.updater.init(trainable)
        if state is not None:
            state = {k: tree_map(lambda z, p: tag(z, *placement(p)), v,
                                 trainable) for k, v in state.items()}
        self._updater_state = state
        self.__dict__.pop("_out_fns", None)
        return self

    def _full_params(self, params):
        """``params`` with every mesh shard all-gathered (as they are
        without a mesh)."""
        if getattr(self, "_mesh", None) is None:
            return params
        from ..common.mesh import gather
        return tree_map(gather, params)

    # -- steps -----------------------------------------------------------
    def _train_step_fn(self):
        """The step of one logical batch: ``_step_fn()`` when grad_accum
        <= 1, else k micro-batches whose gradients are averaged before
        the updater runs once (exact for mean-reduced losses). On a mesh
        (``distribute``) the sharded step of ``nn/sharding.py``."""
        mesh = getattr(self, "_mesh", None)
        if mesh is not None:
            from .sharding import sharded_train_step
            return sharded_train_step(self, mesh)
        k = self._grad_accum()
        if k <= 1:
            return self._step_fn()

        def step(trainable, states, updater_state, iteration, data, labels,
                 key):
            gsum, lsum = None, 0.0
            for mx, my, mkey in zip(_micro_batches(data, k),
                                    _micro_batches(labels, k),
                                    micro_keys(key, k, self.device)):
                loss, states, grads = self._micro_grads(
                    trainable, states, mx, my, mkey)
                gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                           grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / k, gsum)
            new_trainable, updater_state = self._apply_update(
                trainable, updater_state, iteration, grads)
            return new_trainable, states, updater_state, lsum / k

        return step

    def _step_keys(self, n):
        return [rng.split(self._rng) for _ in range(n)]

    def _state_sig(self):
        """The census signature of the params' states and the updater
        state (what the JAX package's step signature holds beside x and
        y)."""
        from ..runtime.inference import _signature
        return _signature((self._states(self._params), self._updater_state))

    def warm_compile(self, data, labels=None):
        """Ready the first ``fit`` ahead of time without stepping: record
        the train step's census event for the first batch (the signature
        ``fit``'s per-step path would record), then pull or build every
        kernel library through the artifact store
        (``kernels/_build.warm``). Nothing runs, so the params and the
        updater state stay bit for bit as they were. Returns ``"hit"``
        (every library present or from the store), ``"miss"`` (``nvcc``
        ran) or ``"bypass"`` (no store configured, or a network on the
        CPU, where nothing is built)."""
        from ..kernels import _build
        self._check_init()
        data = self._coerce_fit_data(data, labels)
        batches = self._materialize_batches(data)
        if not batches:
            raise ValueError("warm_compile needs at least one batch")
        x, y = batches[0]
        graphs = self._train_graphs()
        graphs.note(self._step_of("train", self._state_sig(), x, y),
                    self._train_eager_reason())
        return _build.warm(self.device)

    @staticmethod
    def _listener_overrides(lst, name):
        """True if the listener meaningfully implements ``name`` (a
        duck-typed method, or a TrainingListener subclass that overrides
        the base no-op)."""
        if not hasattr(lst, name):
            return False
        from .listeners import TrainingListener
        if isinstance(lst, TrainingListener):
            return getattr(type(lst), name) is not getattr(TrainingListener,
                                                           name)
        return True

    # -- fit -------------------------------------------------------------
    def fit(self, data, labels=None, num_epochs: int = 1):
        """Train. Accepts a DataSet, a list of them, a DataSetIterator, or
        (features, labels).

        Finite sources are staged on the network's device once per call;
        with no listener overriding ``iteration_done``, each epoch's steps
        run back to back and the losses stay on the device until the
        epoch ends (or, with telemetry off, until ``fit`` returns). Each
        step replays its signature's CUDA graph on the card (module
        docstring).
        """
        from ..runtime.inference import _param_key
        self._check_init()
        data = self._coerce_fit_data(data, labels)
        batches = self._materialize_batches(data)
        self._own_state()
        eager = self._train_eager_reason()
        state_sig = self._state_sig()
        # a graph holds the addresses of the state it updates, and the
        # matmul precision in force when it was captured
        graph_key = _param_key([self._params, self._updater_state])

        iter_listeners = [l for l in self._listeners
                          if self._listener_overrides(l, "iteration_done")]
        epoch_listeners = [l for l in self._listeners
                           if self._listener_overrides(l, "on_epoch_end")]

        def sig(b):
            return [(tuple(a.shape), a.dtype) for a in _leaves(b)]

        use_scan = (batches is not None and batches and not iter_listeners
                    and all(sig(b) == sig(batches[0]) for b in batches[1:]))

        reg = environment().metrics()
        tel = reg.enabled
        if tel:
            path = "scan" if use_scan else "step"
            steps_c = reg.counter("dl4j_train_steps_total",
                                  "Optimizer steps taken",
                                  labels=("path",)).labels(path=path)
            samples_c = reg.counter("dl4j_train_samples_total",
                                    "Training samples consumed",
                                    labels=("path",)).labels(path=path)
            loss_g = reg.gauge("dl4j_train_loss",
                               "Most recent training loss")

        loss = None
        if use_scan:
            n = len(batches)
            bs = _batch_rows(batches[0][0])
            self._last_batch_size = bs
            step = self._step_of("epoch", state_sig, *batches[0], n=n)
            for _ in range(num_epochs):
                keys = self._step_keys(n)
                with span("train/epoch_scan", batches=n, batch_size=bs):
                    for (x, y), key in zip(batches, keys):
                        loss = self._run_step(step, x, y, key, graph_key,
                                              eager)
                        self._iteration += 1
                self._epoch += 1
                if tel:
                    with span("train/device"):
                        value = float(loss)
                    steps_c.inc(n)
                    samples_c.inc(n * bs)
                    loss_g.set(value)
                if epoch_listeners:
                    self.score_value = float(loss)
                    for lst in epoch_listeners:
                        lst.on_epoch_end(self._epoch, self)
        else:
            for _ in range(num_epochs):
                if batches is None and hasattr(data, "reset"):
                    data.reset()
                src = iter(batches if batches is not None else data)
                while True:
                    # data-wait covers the iterator pull and the staging
                    with span("train/data_wait"):
                        item = next(src, _END)
                        if item is _END:
                            break
                        x, y = item if batches is not None \
                            else self._stage_batch(item)
                    self._last_batch_size = _batch_rows(x)
                    with span("train/dispatch"):
                        loss = self._run_step(
                            self._step_of("train", state_sig, x, y), x, y,
                            rng.split(self._rng), graph_key, eager)
                    if tel:
                        with span("train/device"):
                            value = float(loss)
                        steps_c.inc()
                        samples_c.inc(self._last_batch_size)
                        loss_g.set(value)
                    if iter_listeners:
                        self.score_value = float(loss)
                        for lst in iter_listeners:
                            lst.iteration_done(self, self._iteration,
                                               loss=self.score_value)
                    self._iteration += 1
                self._epoch += 1
                if epoch_listeners:
                    if loss is not None:
                        self.score_value = float(loss)
                    for lst in epoch_listeners:
                        lst.on_epoch_end(self._epoch, self)
        if loss is not None:
            self.score_value = float(loss)
        return self
