"""Control-flow ops: cond / while_loop / scan with sub-graph bodies.

Counterpart of ``deeplearning4j_tpu/ops/controlflow.py`` (the reference's
If / While and the TF frame ops). Bodies are ``autodiff.subgraph``
``SubGraph``s (static kwargs of the node, so they serialize); parent
variables a body closes over arrive as trailing operands (``cap_names``)
and are handed to each sub-graph by name.

The JAX package lowers these to ``lax.cond`` / ``lax.while_loop`` /
``lax.scan``; eagerly they are Python:
- ``cond`` reads its predicate on the host (one sync) and runs one
  branch; autograd differentiates through the branch taken;
- ``while_loop`` is a Python loop that tests the condition on the host
  each trip; forward only, as the JAX one (use ``scan`` for a trainable
  loop);
- ``scan`` runs its body once per slice and stacks the ys (honouring
  ``reverse``); autograd differentiates through the unrolled steps.
"""
from __future__ import annotations

import torch

from .registry import op


def _as_bool(r) -> bool:
    r = torch.as_tensor(r)
    return bool(torch.all(r)) if r.dim() > 0 else bool(r)


def _caps_for(graph, cap_env):
    return [cap_env[n] for n in graph.captured]


def _one_or_tuple(res):
    return res[0] if len(res) == 1 else tuple(res)


@op("cond", "controlflow", aliases=("If",))
def cond(pred, *args, true_graph, false_graph, n_base, cap_names=()):
    """One SubGraph branch, picked on the host (reference If op)."""
    base = args[:n_base]
    cap_env = dict(zip(cap_names, args[n_base:]))
    g = true_graph if _as_bool(pred) else false_graph
    return _one_or_tuple(g.call_tuple(*base, *_caps_for(g, cap_env)))


@op("while_loop", "controlflow", aliases=("While",))
def while_loop(*args, cond_graph, body_graph, n_loop_vars, cap_names=()):
    """A host loop over SubGraph cond / body (reference While op)."""
    carry = tuple(args[:n_loop_vars])
    cap_env = dict(zip(cap_names, args[n_loop_vars:]))
    c_caps = _caps_for(cond_graph, cap_env)
    b_caps = _caps_for(body_graph, cap_env)
    while _as_bool(cond_graph(*carry, *c_caps)):
        carry = body_graph.call_tuple(*carry, *b_caps)
    return _one_or_tuple(carry)


@op("scan", "controlflow")
def scan(*args, body_graph, n_carry, n_scan, cap_names=(), length=None,
         reverse=False):
    """``lax.scan`` semantics with a SubGraph body.

    args = (*carry_init, *xs, *captured). The body receives
    (*carry, *x_slices, *captured) and returns (*new_carry, *ys). Output =
    (*final_carry, *stacked_ys)."""
    carry = tuple(args[:n_carry])
    xs = tuple(args[n_carry:n_carry + n_scan])
    cap_env = dict(zip(cap_names, args[n_carry + n_scan:]))
    caps = _caps_for(body_graph, cap_env)
    n = int(length) if length is not None else int(xs[0].shape[0])
    steps = range(n - 1, -1, -1) if reverse else range(n)
    ys_steps = []
    for t in steps:
        res = body_graph.call_tuple(*carry, *(x[t] for x in xs), *caps)
        carry = tuple(res[:n_carry])
        ys_steps.append(tuple(res[n_carry:]))
    if reverse:
        ys_steps.reverse()
    ys = tuple(torch.stack(parts) for parts in zip(*ys_steps)) \
        if ys_steps else ()
    return _one_or_tuple(carry + ys)


@op("enter", "controlflow", aliases=("Enter",))
def enter(x, frame_name=None):
    """Frame ops are identity here (there are no frames); kept for parity
    with imported TF1 graphs."""
    return x


@op("exit", "controlflow", aliases=("Exit",))
def exit_(x, frame_name=None):
    return x


@op("next_iteration", "controlflow", aliases=("NextIteration",))
def next_iteration(x):
    return x


@op("switch", "controlflow", aliases=("Switch",))
def switch(x, pred):
    """Reference Switch: both outputs exist, the side not taken zeroed;
    returns (false_out, true_out)."""
    p = _as_bool(pred)
    z = torch.zeros_like(x)
    return (z, x) if p else (x, z)


@op("merge", "controlflow", aliases=("Merge",))
def merge(a, b):
    """Reference Merge: the sum of the two inputs, correct only when both
    come straight from the two outputs of one ``switch`` (one side is
    exactly zero), as in the JAX package."""
    return a + b
