"""Gradient accumulation: micro-batch gradients folded into one update.

Counterpart of ``deeplearning4j_tpu/parallel/accumulation.py`` (the
reference's ``EncodedGradientsAccumulator``): ``GradientsAccumulator``
keeps the reference API (``store_update`` / ``get_average``), with an
optional threshold round trip of the averaged gradients through
``ops/compression`` (``encode_threshold`` then ``decode_threshold``: the
reference's wire format, here for parity, since the collectives move
dense tensors); ``fit_accumulated`` drives a network with it, one
optimizer step per ``accumulation_steps`` micro-batches, a trailing
partial window applied as a last, smaller step. Gradients are averaged,
which equals one large batch for mean-reduced losses.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..common import rng
from ..datasets.dataset import DataSet
from ..learning import tree_map


class GradientsAccumulator:
    """``store_update(grads)`` k times, then ``get_average()``."""

    def __init__(self, threshold: Optional[float] = None):
        self.threshold = threshold
        self._sum = None
        self._count = 0

    def store_update(self, grads):
        if self._sum is None:
            self._sum = tree_map(lambda g: g.detach().clone(), grads)
        else:
            self._sum = tree_map(torch.add, self._sum, grads)
        self._count += 1

    def get_average(self):
        if self._sum is None:
            raise ValueError("no updates stored")
        avg = tree_map(lambda s: s / self._count, self._sum)
        if self.threshold is not None:
            from ..ops import compression

            def roundtrip(g):
                _, enc = compression.encode_threshold(g, self.threshold)
                return compression.decode_threshold(enc, self.threshold,
                                                    g.dtype)

            avg = tree_map(roundtrip, avg)
        return avg

    def reset(self):
        self._sum = None
        self._count = 0

    @property
    def count(self) -> int:
        return self._count


def fit_accumulated(net, batches: List, accumulation_steps: int = None,
                    threshold: Optional[float] = None):
    """One optimizer step per ``accumulation_steps`` micro-batches of
    ``batches`` (DataSets or (x, y) pairs). Returns the losses, one per
    step (the mean of its micro-batches'). Uses the network's update
    rule (clipping, updater, weight decay, constraints) and refreshes
    stateful layers' running stats per micro-batch."""
    net._check_init()
    accumulation_steps = accumulation_steps or len(batches)
    # the census of the JAX package's two counted_jit entries; eager,
    # since the host accumulator sums the gradients between them
    from ..runtime.inference import eager_dispatch
    graphs = net._train_graphs()
    grad_fn = eager_dispatch(net._micro_grads, f"accum_grad:{id(net)}",
                             graphs, "host_accumulator")
    apply_fn = eager_dispatch(net._apply_update, f"accum_apply:{id(net)}",
                              graphs, "host_accumulator")

    losses: list = []
    acc = GradientsAccumulator(threshold=threshold)
    micro_losses: list = []
    trainable = net._trainable(net._params)
    states = net._states(net._params)
    ustate = net._updater_state

    def flush():
        nonlocal trainable, ustate, micro_losses
        trainable, ustate = apply_fn(trainable, ustate, net._iteration,
                                     acc.get_average())
        net._params = net._merge_states(trainable, states)
        net._updater_state = ustate
        net._iteration += 1
        losses.append(sum(micro_losses) / len(micro_losses))
        net.score_value = losses[-1]
        acc.reset()
        micro_losses = []

    for ds in batches:
        if not isinstance(ds, DataSet):
            ds = DataSet(*ds)
        x, y = net._stage(ds.features), net._stage(ds.labels)
        loss, states, grads = grad_fn(trainable, states, x, y,
                                      rng.split(net._rng))
        acc.store_update(grads)
        micro_losses.append(float(loss))
        if acc.count >= accumulation_steps:
            flush()
    if acc.count:  # a trailing partial window still contributes
        flush()
    net._params = net._merge_states(trainable, states)
    return losses
