"""Shared flat-Adam update for the model-level train steps.

Counterpart of ``deeplearning4j_tpu/models/_optim.py``: the optimizer
state is ``(u_list, m_list)`` aligned with :func:`tree_leaves` of the
params, which walks dicts in sorted-key order and lists in order, as
``jax.tree_util.tree_leaves`` does — so a state bridged from the JAX
package lines up leaf for leaf.
"""
from __future__ import annotations

import torch

from ..ops import updater_ops


def tree_leaves(tree):
    """The tensors of a nested dict/list/tuple, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    return _build(tree, iter(leaves))


def _build(node, it):
    # a module function, not a closure: a recursive closure is a
    # reference cycle, which would hold ``leaves`` (a step's gradients)
    # until a collection
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        seq = [_build(v, it) for v in node]
        return seq if isinstance(node, list) else tuple(seq)
    return None if node is None else next(it)


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)`` with respect to
    every tensor leaf of ``params``; grads come back as a tree like
    ``params``, each in its parameter's dtype (zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


@torch.no_grad()
def adam_apply(params, grads, opt_state, learning_rate, iteration,
               cast_f32: bool = True):
    """One Adam step over a params tree, IN PLACE: each parameter and
    each state tensor is overwritten, where the JAX package returns new
    arrays and donates the old ones. ``grads`` is a tree like ``params``;
    ``opt_state = (u_list, m_list)``. With ``cast_f32`` the update math runs in f32 and
    the result is cast back to each parameter's dtype (bf16 masters).
    Returns ``(params, opt_state)``, the same objects."""
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    u, m = opt_state
    for p, g, ui, mi in zip(flat_p, flat_g, u, m):
        g_ = g.float() if cast_f32 else g
        upd, u2, m2 = updater_ops.adam_updater(g_, ui, mi, lr=learning_rate,
                                               iteration=iteration)
        if cast_f32:
            p.copy_((p.float() - upd).to(p.dtype))
        else:
            p.sub_(upd)
        ui.copy_(u2)
        mi.copy_(m2)
    return params, opt_state


def adam_init(params):
    """Zero f32 moments ``(u_list, m_list)`` beside each parameter; a
    placed parameter's (a mesh shard) are placed as it is."""
    from ..common.mesh import placement, tag

    def zeros(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        pl = placement(p)
        return z if pl is None else tag(z, *pl)
    flat = tree_leaves(params)
    return [zeros(p) for p in flat], [zeros(p) for p in flat]
