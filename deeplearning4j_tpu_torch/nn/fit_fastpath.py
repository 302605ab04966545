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
  Capturing the epoch as a CUDA graph is ``ROADMAP.md`` queue 1 #12b.
- **The census**: the step and the epoch go through
  ``runtime.inference.counted_dispatch`` with the JAX package's tags
  (``train:<id>:k<k>:<remat>``, ``epoch:...``), so a ``fit`` records one
  ``dl4j_compiles_total`` event per new signature, as the JAX package's
  ``counted_jit`` does, and a repeat call none. ``warm_compile`` records
  the step's event without running it, and pulls or builds every kernel
  library through the artifact store (``kernels/_build.py``).
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
import threading
import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..common import rng
from ..common.environment import environment, tf32_applied
from ..common.tracing import span
from ..learning import tree_map
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


class FitFastPathMixin:
    # -- the params ------------------------------------------------------
    @property
    def _params(self):
        """The param tree. Setting it lets go of the inference forward's
        captured graphs (``runtime/inference.py::captured_dispatch``),
        which hold the old tensors: they and the graphs' pool are freed
        now, not at the next predict, which captures again."""
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
        outputs. Dropout keys are ints, so the recompute draws the same
        masks."""
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

    # -- distribution (``distribute(mesh)``, nn/sharding.py) -------------
    def _distribute(self, mesh, sharded_params):
        """Keep ``sharded_params`` (this rank's shards), re-initialise the
        updater state from them and drop the cached steps, as the JAX
        package's ``distribute`` does."""
        from ..common.mesh import placement, tag
        self._mesh = mesh
        self.device = mesh.device
        self._params = sharded_params
        self.__dict__.pop("_census_seen", None)  # the steps are rebuilt
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
            host = torch.Generator().manual_seed(int(key))
            gsum, lsum = None, 0.0
            for mx, my in zip(_micro_batches(data, k),
                              _micro_batches(labels, k)):
                loss, states, grads = self._micro_grads(
                    trainable, states, mx, my, rng.split(host))
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

    def _counted_step(self, kind: str, fn):
        """``fn`` under the census with the JAX package's tag for this
        network's ``kind`` step (``train`` or ``epoch``) and build knobs.
        The signatures seen are kept on the network per tag, as the JAX
        package's cached jit keeps them across fits."""
        from ..runtime.inference import counted_dispatch
        k = self._grad_accum()
        tag = f"{kind}:{id(self)}:k{k}:{self._remat_mode()}"
        seen = self.__dict__.setdefault("_census_seen", {})
        return counted_dispatch(fn, tag, seen.setdefault(tag, set()))

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
        self._counted_step("train", self._train_step_fn()).note(
            self._trainable(self._params), self._states(self._params),
            self._updater_state, self._iteration, x, y, 0)
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
        epoch ends (or, with telemetry off, until ``fit`` returns).
        """
        self._check_init()
        data = self._coerce_fit_data(data, labels)
        batches = self._materialize_batches(data)
        step_fn = self._train_step_fn()

        trainable = self._trainable(self._params)
        states = self._states(self._params)
        ustate = self._updater_state

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
            epoch = self._counted_step("epoch", None)
            for _ in range(num_epochs):
                keys = self._step_keys(n)
                epoch.note(trainable, states, ustate, self._iteration,
                           batches, keys)
                with span("train/epoch_scan", batches=n, batch_size=bs):
                    for (x, y), key in zip(batches, keys):
                        trainable, states, ustate, loss = step_fn(
                            trainable, states, ustate, self._iteration, x,
                            y, key)
                        self._iteration += 1
                self._params = self._merge_states(trainable, states)
                self._updater_state = ustate
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
            train_step = self._counted_step("train", step_fn)
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
                        trainable, states, ustate, loss = train_step(
                            trainable, states, ustate, self._iteration, x, y,
                            rng.split(self._rng))
                    self._params = self._merge_states(trainable, states)
                    self._updater_state = ustate
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
        self._params = self._merge_states(trainable, states)
        self._updater_state = ustate
        if loss is not None:
            self.score_value = float(loss)
        return self
