"""SameDiff training: TrainingConfig and the fit loop.

Counterpart of ``deeplearning4j_tpu/autodiff/training.py`` (the
reference's ``TrainingConfig.java`` and ``TrainingSession``). One
training iteration is the interpreted forward, an autograd backward, the
regularization, the updater and the parameter update, computed as the
JAX step computes them:

- the loss is the sum of the loss variables, plus ``l2 * sum(p^2)`` and
  ``l1 * sum(|p|)`` over the trainable variables;
- the update is ``p - sign * update - weight_decay * p`` (``sign`` -1
  when ``minimize`` is off; the decay decoupled, AdamW-style);
- ``grad_accum = k`` splits every placeholder's leading axis into k
  micro-batches whose gradients and losses are averaged (exact for a
  batch-mean loss);
- ``remat`` wraps the whole loss in ``torch.utils.checkpoint`` (the graph
  has no layer boundaries to cut at): ``"dots_saveable"`` keeps the
  matrix-product outputs through a selective-checkpoint policy where the
  installed torch has one (``create_selective_checkpoint_contexts``) and
  otherwise recomputes everything; any other mode recomputes everything.

A step returns new parameter tensors (functional, as the JAX donated
step) and runs under ``full_f32()``; the dispatch census counts it once
per new input signature (tag ``sdtrain:...``). The updater state has the
JAX package's layout (``{"u": {name: tensor}, "m": ...}`` for Adam).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..learning import Adam, IUpdater
from ..nn.fit_fastpath import full_f32


@dataclasses.dataclass
class TrainingConfig:
    updater: IUpdater = dataclasses.field(default_factory=Adam)
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    loss_variables: Sequence[str] = ()
    minimize: bool = True
    #: activation rematerialization: "none" keeps every forward
    #: activation for the backward; "layer" / "dots_saveable" checkpoint
    #: the whole loss ("dots_saveable" keeps matmul outputs). None
    #: resolves the Environment default (DL4J_TPU_REMAT).
    remat: Optional[str] = None
    #: micro-batches per optimizer step (gradient accumulation over the
    #: leading placeholder dim); 0/None resolves the Environment default.
    grad_accum: int = 0


@dataclasses.dataclass
class LossCurve:
    losses: List[float]

    def mean_loss(self):
        return sum(self.losses) / max(len(self.losses), 1)


@dataclasses.dataclass
class History:
    """Reference ``autodiff/listeners/records/History.java``."""
    loss_curves: List[LossCurve]
    epochs: int
    iterations: int
    train_time_ms: float

    def final_loss(self) -> float:
        return self.loss_curves[-1].losses[-1] if self.loss_curves \
            else float("nan")


_MATMULS = ("mm", "bmm", "addmm", "baddbmm")


def dots_saveable_context():
    """``context_fn`` for ``checkpoint`` that saves the outputs of matrix
    products and recomputes the rest, or None where this torch has no
    selective checkpointing."""
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)
    except ImportError:
        return None
    aten = torch.ops.aten
    keep = {getattr(aten, n).default for n in _MATMULS if hasattr(aten, n)}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _split(a: torch.Tensor, k: int):
    if a.shape[0] % k:
        raise ValueError(f"grad_accum={k} does not divide batch dim "
                         f"{a.shape[0]} (shape {tuple(a.shape)})")
    return a.chunk(k, dim=0)


def build_train_step(sd, config: TrainingConfig,
                     placeholders: Sequence[str]) -> Callable:
    """One training iteration as a function.

    step(params, updater_state, iteration, ph) -> (params', state', loss)
    """
    loss_names = list(config.loss_variables or sd.loss_variables())
    if not loss_names:
        raise ValueError("TrainingConfig has no loss variables")
    trainable = [v.name for v in sd.trainable_variables()]

    def loss_fn(params, ph):
        variables = dict(sd._arrays)
        variables.update(params)
        outs = sd._trace(variables, ph, loss_names)
        loss = sum(torch.sum(o) for o in outs)
        if config.l2 > 0:
            loss = loss + config.l2 * sum(torch.sum(p * p)
                                          for p in params.values())
        if config.l1 > 0:
            # |p| written so that its gradient at 0 is 1, as jnp.abs's
            # (torch.abs gives 0 there, and a zero-initialized bias starts
            # at 0)
            loss = loss + config.l1 * sum(
                torch.sum(torch.where(p >= 0, p, -p))
                for p in params.values())
        return loss

    from ..common.environment import environment
    remat = getattr(config, "remat", None)
    if remat is None:
        remat = environment().training_remat()
    if remat and remat != "none":
        plain_loss = loss_fn
        kw = {"use_reentrant": False}
        if remat == "dots_saveable":
            ctx = dots_saveable_context()
            if ctx is not None:
                kw["context_fn"] = ctx

        def loss_fn(params, ph):
            return checkpoint(plain_loss, params, ph, **kw)

    k = int(getattr(config, "grad_accum", 0) or 0)
    if k <= 0:
        k = environment().training_grad_accum()

    def grads_of(params, ph):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        names = list(leaves)

        def one(micro):
            loss = loss_fn(leaves, micro)
            gs = torch.autograd.grad(loss, [leaves[n] for n in names],
                                     allow_unused=True)
            return loss.detach(), [torch.zeros_like(leaves[n]) if g is None
                                   else g for n, g in zip(names, gs)]

        if k <= 1:
            loss, gs = one(ph)
            return loss, dict(zip(names, gs))
        parts = {n: _split(a, k) for n, a in ph.items()}
        lsum, gsum = None, None
        for i in range(k):
            loss, gs = one({n: p[i] for n, p in parts.items()})
            lsum = loss if lsum is None else lsum + loss
            gsum = gs if gsum is None else [a + b for a, b in zip(gsum, gs)]
        return lsum / k, {n: g / k for n, g in zip(names, gsum)}

    def step(params, updater_state, iteration, ph):
        with torch.enable_grad(), full_f32():
            loss, grads = grads_of(params, ph)
        with torch.no_grad():
            update, updater_state = config.updater.apply(
                grads, updater_state, iteration)
            sign = 1.0 if config.minimize else -1.0
            new_params = {n: p - sign * update[n].to(p.dtype)
                          - config.weight_decay * p
                          for n, p in params.items()}
        return new_params, updater_state, loss

    from ..runtime.inference import counted_dispatch
    return counted_dispatch(step, tag=f"sdtrain:{id(sd)}:k{k}:{remat}"), \
        trainable


def fit(sd, iterator=None, num_epochs: int = 1, placeholders_fn=None,
        listeners: Sequence[Any] = ()) -> History:
    """Train from a DataSet / MultiDataSet iterator (reference
    SameDiff.fit).

    Features and labels bind to placeholders through the TrainingConfig
    mappings (a MultiDataSet's lists in order); they move to the graph's
    device. As in the JAX package, each ``fit`` call counts its
    iterations (the updater's step) from 0."""
    config = sd.training_config
    if config is None:
        raise ValueError("call set_training_config first")
    f_map = list(config.data_set_feature_mapping)
    l_map = list(config.data_set_label_mapping)
    ph_names = tuple(sorted(f_map + l_map))

    step, trainable = build_train_step(sd, config, ph_names)
    params = {n: sd._arrays[n] for n in trainable}
    state = sd._updater_state if sd._updater_state is not None \
        else config.updater.init(params)

    all_listeners = list(sd._listeners) + list(listeners)
    curves = []
    iteration = 0
    t0 = time.time()

    from ..common.environment import environment
    from ..common.tracing import span
    reg = environment().metrics()
    tel = reg.enabled
    if tel:
        steps_c = reg.counter("dl4j_train_steps_total",
                              "Optimizer steps taken",
                              labels=("path",)).labels(path="samediff")
        samples_c = reg.counter("dl4j_train_samples_total",
                                "Training samples consumed",
                                labels=("path",)).labels(path="samediff")
        loss_g = reg.gauge("dl4j_train_loss", "Most recent training loss")

    for epoch in range(num_epochs):
        losses = []
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            with span("train/data_wait"):
                feats = ds.features if isinstance(ds.features, (list, tuple)) \
                    else [ds.features]
                labs = ds.labels if isinstance(ds.labels, (list, tuple)) \
                    else [ds.labels]
                ph = {}
                for name, arr in zip(f_map, feats):
                    ph[name] = sd._tensor(arr)
                for name, arr in zip(l_map, labs):
                    ph[name] = sd._tensor(arr)
            with span("train/dispatch"):
                params, state, loss = step(params, state, iteration, ph)
            # repoint the graph's arrays before listeners (which may call
            # sd.output / save) run
            sd._arrays.update(params)
            sd._release_graphs()
            sd._updater_state = state
            with span("train/device"):
                loss_val = float(loss)  # host sync: device time lands here
            losses.append(loss_val)
            sd._last_batch_size = next(
                (int(v.shape[0]) for v in ph.values() if v.dim() >= 1), 0)
            if tel:
                steps_c.inc()
                samples_c.inc(sd._last_batch_size)
                loss_g.set(loss_val)
            for lst in all_listeners:
                if hasattr(lst, "iteration_done"):
                    lst.iteration_done(sd, iteration, epoch, loss_val)
            iteration += 1
        curves.append(LossCurve(losses))
        for lst in all_listeners:
            if hasattr(lst, "epoch_done"):
                lst.epoch_done(sd, epoch)
    sd._arrays.update(params)
    sd._release_graphs()
    sd._updater_state = state
    return History(curves, num_epochs, iteration, (time.time() - t0) * 1000)
