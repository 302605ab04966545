"""Layer-API sharding: per-layer parameter specs and the sharded step.

Counterpart of ``deeplearning4j_tpu/nn/sharding.py``. The leaf rules
are the JAX package's: a matrix gets row-FSDP and column-TP (``P(fsdp,
..., tensor)``), a convolution kernel (HWIO) its in-channels on
``fsdp`` and out-channels on ``tensor``, state, biases and vectors are
replicated, and a layer may bring its own ``param_specs``; a spec that
does not divide falls back to replicated on that dim.

There ``net.distribute(mesh)`` lets GSPMD partition the one jitted step;
the layer API has no hand-written tensor parallelism, so here a leaf
sharded over ``fsdp`` or ``tensor`` is stored sharded and used whole:
:func:`sharded_train_step` all-gathers the params, runs the network's
own forward and backward on this rank's rows of the global batch, sums
the gradients over the ``(data, fsdp)`` group and keeps each leaf's
shard of them (FSDP's gather-at-use and reduce-scatter), and runs the
updater on the shards of the updater state. The numbers are the global
program's: inside ``common.mesh.batch_context`` the batch-norm
statistics and the loss's mean are over the global batch (sum and
count over the group), and a dropout or noise mask is the global
batch's, drawn from the step's key, this rank keeping its rows. Where
the rows do not divide over the group every rank takes them all.

ZeRO-1 (``zero1=True``) keeps each updater-state leaf's leading dim
sharded over ``(data, fsdp)`` where it divides: the updater runs on the
shard of the summed gradient and the update is all-gathered back, which
is exact for the element-wise updaters of ``learning.py``. Gradient
clipping sees the whole gradient before, weight decay and the
constraints the whole parameter after.
"""
from __future__ import annotations

import torch

from ..common.mesh import (DATA, FSDP, TENSOR, P, batch_context,
                           batch_divides, dp_size, gather, gather_as,
                           local_slice, place, placement, shard_slices, tag,
                           valid_spec, zero1_spec)
from ..learning import tree_map
from .conf.constraints import apply_constraints


def default_leaf_spec(key: str, arr) -> P:
    """Replicate state, biases and vectors; a matrix gets row-FSDP and
    column-TP (Dense W (in, out) -> P(fsdp, tensor))."""
    if key.startswith("state_") or len(arr.shape) < 2:
        return P()
    return P(*((FSDP,) + (None,) * (len(arr.shape) - 2) + (TENSOR,)))


def conv_leaf_spec(key: str, arr) -> P:
    """Conv kernels are HWIO: in-channels on fsdp, out-channels on
    tensor."""
    if key.startswith("state_") or len(arr.shape) < 2:
        return P()
    if len(arr.shape) == 4:
        return P(None, None, FSDP, TENSOR)
    if len(arr.shape) == 5:
        return P(None, None, None, FSDP, TENSOR)
    return default_leaf_spec(key, arr)


def _is_conv_like(layer) -> bool:
    from .conf import layers as L
    return isinstance(layer, L.ConvolutionLayer)


def layer_param_specs(layer, params):
    """Spec tree matching ``params`` (nested dicts too, e.g.
    Bidirectional's fwd/bwd). A layer may override ``param_specs``."""
    rule = getattr(layer, "param_specs", None)
    if callable(rule):
        custom = rule(params)
        if custom is not None:
            return custom
    leaf_rule = conv_leaf_spec if _is_conv_like(layer) else default_leaf_spec

    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        return leaf_rule(prefix, node)

    return {k: walk(k, v) for k, v in params.items()}


def valid_sharding(mesh, spec: P, shape) -> P:
    """``spec`` with every axis that does not divide its dim dropped."""
    return valid_spec(mesh, spec, shape)


def shard_layer_params(mesh, layer, params):
    """This rank's shards of one layer's param dict, per its specs."""
    specs = layer_param_specs(layer, params)

    def put(node, spec):
        if isinstance(node, dict):
            return {k: put(v, spec[k]) for k, v in node.items()}
        return place(node, mesh, spec)

    return {k: put(v, specs[k]) for k, v in params.items()}


def batch_sharding(mesh) -> P:
    """The batch dim over data(+fsdp) where either is > 1."""
    return P((DATA, FSDP)) if dp_size(mesh) > 1 else P()


def shard_batch_value(mesh, x):
    """This rank's rows of ``x`` (all of them where they do not divide)."""
    if x.dim() and batch_divides(mesh, x.shape[0]):
        return local_slice(x, mesh, valid_spec(mesh, batch_sharding(mesh),
                                               x.shape))
    return x


def local_rows(mesh, tree):
    """:func:`shard_batch_value` over a dict/list tree of batch arrays."""
    return tree_map(lambda x: shard_batch_value(mesh, x), tree)


def _spec(p) -> P:
    pl = placement(p)
    return P() if pl is None else pl[1]


def _put(full, mesh, spec):
    """``full``'s shard under ``spec``, tagged (a replicated leaf is
    tagged as it is, not copied)."""
    if not spec:
        return tag(full, mesh, spec, full.shape)
    return place(full, mesh, spec)


def _batch_rows(tree) -> int:
    from .fit_fastpath import _batch_rows as rows
    return rows(tree)


def place_updater_state(mesh, state, trainable, zero1: bool):
    """This rank's shard of a global updater state: each leaf placed by
    its parameter's spec, or by ZeRO-1's when ``zero1``."""
    if state is None:
        return None

    def one(s, p):
        spec = zero1_spec(mesh, s) if zero1 else _spec(p)
        return place(s, mesh, spec)
    return {k: tree_map(one, v, trainable) for k, v in state.items()}


def gather_updater_state(state):
    if state is None:
        return None
    return {k: tree_map(gather, v) for k, v in state.items()}


def sharded_train_step(net, mesh, zero1: bool = False):
    """The network's train step on ``mesh`` (module docstring):
    ``(trainable, states, updater_state, iteration, x, y, key) ->
    (trainable, states, updater_state, loss)`` with the trainable leaves
    and the updater state this rank's shards, ``x`` / ``y`` the global
    batch and the loss the global one."""
    k = net._grad_accum()
    n_dp = dp_size(mesh)
    from .fit_fastpath import _micro_batches, micro_keys

    def step(trainable, states, ustate, iteration, x, y, key):
        full = tree_map(gather, trainable)
        if k <= 1:
            micro, keys = [(x, y)], [key]
        else:
            micro = list(zip(_micro_batches(x, k), _micro_batches(y, k)))
            keys = micro_keys(key, k, net.device)
        gsum, lsum, sharded = None, 0.0, False
        for (mx, my), mkey in zip(micro, keys):
            rows = _batch_rows(mx)
            sharded = mesh.group((DATA, FSDP)) is not None and \
                batch_divides(mesh, rows)
            with batch_context(mesh, rows):
                loss, states, grads = net._micro_grads(
                    full, states, local_rows(mesh, mx),
                    local_rows(mesh, my), mkey)
            gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                       grads)
            lsum = lsum + loss
        grads = tree_map(lambda g: g / k, gsum)
        # each rank's gradient is n_dp x its rows' part of the global one
        # inside the batch context: the sum over the group / n_dp is exact
        # (at world size 1 the sum still goes through the group)
        from ..parallel import collectives as C
        flat = _flat(grads)
        if flat and sharded:
            flat = [g / n_dp for g in C.all_reduce_tree(flat, (DATA, FSDP),
                                                         mesh)]
            grads = _unflat(grads, flat)
        grads = net._clip_grads(grads)

        def ospec(p, g):
            return valid_spec(mesh, zero1_spec(mesh, g) if zero1
                              else _spec(p), g.shape)
        g_sh = tree_map(lambda g, p: g[shard_slices(mesh, ospec(p, g),
                                                    g.shape)],
                        grads, trainable)
        upd_sh, ustate = net.conf.updater.apply(g_sh, ustate, iteration)
        update = tree_map(lambda u, p, g: gather_as(u, mesh, ospec(p, g)),
                          upd_sh, trainable, grads)
        wd = net.conf.weight_decay
        with torch.no_grad():
            new = tree_map(lambda p, u: p - u.to(p.dtype) - wd * p, full,
                           update)
            new = apply_constraints(getattr(net.conf, "constraints", None),
                                    new)
        new_trainable = tree_map(lambda nf, p: _put(nf, mesh, _spec(p)),
                                 new, trainable)
        if ustate is not None:
            ustate = {name: tree_map(
                lambda s, p, g: tag(s, mesh, ospec(p, g), g.shape), v,
                trainable, grads) for name, v in ustate.items()}
        return new_trainable, states, ustate, lsum / k

    return step


def _flat(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _unflat(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
