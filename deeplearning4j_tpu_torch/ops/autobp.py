"""Backprop (``_bp`` / ``_grad``) ops derived from the forwards.

Counterpart of ``deeplearning4j_tpu/ops/autobp.py``: where the reference
ships a hand-written ``<op>_bp`` for each declarable op family, the
backprop rule here is ``torch.autograd.grad`` of the registered forward.
The ops exist for name parity and for graphs that call a bp op by name.

Convention (the reference's bp signature): positional args are the
forward's inputs followed by the upstream gradient; kwargs go to the
forward. A gradient comes back for every input, zeros for an integer
one. A bp op is registered only for a ported, differentiable forward
that the reference inventory lists a bp for, as the JAX package
registers them.
"""
from __future__ import annotations

import torch

from ._util import narrow
from .reference_inventory import all_reference_ops
from .registry import OpDef, OpRegistry


def _is_diff(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


def _zeros(x):
    """Zeros like a non-differentiable input (a Python scalar or list as
    JAX sees it: int32 / float32)."""
    t = torch.as_tensor(x)
    return torch.zeros_like(t, dtype=narrow(t.dtype))


def _make_bp(fwd_fn, name):
    def bp(*args, **kwargs):
        if len(args) < 2:
            raise ValueError(f"{name}: expected (inputs..., grad)")
        *xs, g = args
        is_diff = [_is_diff(x) for x in xs]
        if not any(is_diff):
            return tuple(_zeros(x) for x in xs)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) if d else x
                      for x, d in zip(xs, is_diff)]
            out = fwd_fn(*leaves, **kwargs)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            outs = [o for o in outs if isinstance(o, torch.Tensor)
                    and o.requires_grad]
            cots = [torch.broadcast_to(torch.as_tensor(g, dtype=o.dtype,
                                                       device=o.device),
                                       o.shape) for o in outs]
            diff_leaves = [x for x, d in zip(leaves, is_diff) if d]
            grads = iter(torch.autograd.grad(outs, diff_leaves, cots,
                                             allow_unused=True))
        full = []
        for x, d in zip(xs, is_diff):
            if d:
                gx = next(grads)
                full.append(torch.zeros_like(x) if gx is None else gx)
            else:
                full.append(_zeros(x))
        return full[0] if len(full) == 1 else tuple(full)

    bp.__name__ = name
    return bp


def register_auto_bp():
    """Register ``<op>_bp`` / ``<op>_grad`` for every registered
    differentiable base op that the reference inventory lists a bp
    for."""
    reg = OpRegistry.get()
    for name in all_reference_ops():
        for suffix in ("_bp", "_grad"):
            if not name.endswith(suffix):
                continue
            base = name[: -len(suffix)]
            if reg.has(name) or not reg.has(base):
                continue
            base_def = reg.lookup(base)
            if not base_def.differentiable:
                continue
            reg.register(OpDef(name=name, fn=_make_bp(base_def.fn, name),
                               category="autodiff_bp", differentiable=False))
    # irregular names / bases flagged non-differentiable but with real
    # gradients
    for bp_name, base in (("lstmLayerCellBp", "lstmLayerCell"),
                          ("dynamic_partition_bp", "dynamic_partition")):
        if not reg.has(bp_name) and reg.has(base):
            reg.register(OpDef(name=bp_name,
                               fn=_make_bp(reg.lookup(base).fn, bp_name),
                               category="autodiff_bp", differentiable=False))


register_auto_bp()
