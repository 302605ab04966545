"""Broadcastable pairwise ops.

Counterpart of ``deeplearning4j_tpu/ops/pairwise.py`` (the reference's
``headers/broadcastable.h`` and the legacy pairwise loops); PyTorch's
broadcasting takes the place of XLA's. ``mod`` / ``floormod`` take the
sign of the divisor (``torch.remainder``, as ``jnp.mod``), ``floordiv``
floors, and index results are int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._util import i32, tensor_like
from .registry import op


def _binary(fn):
    """``fn`` over two operands, either of which may be a Python scalar."""
    def f(x, y):
        if not isinstance(x, torch.Tensor):
            x = tensor_like(x, y)
        return fn(x, tensor_like(y, x))
    return f


op("add", "pairwise")(_binary(torch.add))
op("subtract", "pairwise", aliases=("sub",))(_binary(torch.sub))
op("multiply", "pairwise", aliases=("mul",))(_binary(torch.mul))
op("divide", "pairwise", aliases=("div",))(_binary(torch.true_divide))
op("realdiv", "pairwise")(_binary(torch.true_divide))
op("truncatediv", "pairwise")(
    _binary(lambda x, y: torch.trunc(torch.true_divide(x, y))))
op("floordiv", "pairwise")(_binary(
    lambda x, y: torch.floor(torch.true_divide(x, y)) if x.is_floating_point()
    or y.is_floating_point() else torch.floor_divide(x, y)))
op("mod", "pairwise")(_binary(torch.remainder))
op("floormod", "pairwise")(_binary(torch.remainder))
op("reversesubtract", "pairwise", aliases=("rsub",))(
    _binary(lambda x, y: y - x))
op("reversedivide", "pairwise", aliases=("rdiv",))(
    _binary(lambda x, y: torch.true_divide(y, x)))
op("reversemod", "pairwise")(_binary(lambda x, y: torch.remainder(y, x)))
op("maximum", "pairwise")(_binary(torch.maximum))
op("minimum", "pairwise")(_binary(torch.minimum))
op("Pow", "pairwise", aliases=("pow",))(_binary(torch.pow))
op("squaredsubtract", "pairwise")(_binary(lambda x, y: torch.square(x - y)))


@op("cross", "pairwise")
def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    """``jnp.cross``: the vector axes of ``a`` and ``b`` (2 or 3 long; a
    2-vector has a zero third component) and of the result, or ``axis``
    for all three; two 2-vectors give the z component alone."""
    if axis is not None:
        axisa = axisb = axisc = axis
    a = torch.movedim(tensor_like(a, b), axisa, -1)
    b = torch.movedim(tensor_like(b, a), axisb, -1)
    n_a, n_b = a.shape[-1], b.shape[-1]
    if n_a not in (2, 3) or n_b not in (2, 3):
        raise ValueError("cross: the vector axes must be 2 or 3 long")
    a = F.pad(a, (0, 3 - n_a)) if n_a == 2 else a
    b = F.pad(b, (0, 3 - n_b)) if n_b == 2 else b
    c = torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)
    if n_a == 2 and n_b == 2:
        return c[..., 2]
    return torch.movedim(c, -1, axisc)


@op("divide_no_nan", "pairwise")
def divide_no_nan(x, y):
    y = tensor_like(y, x)
    zero = y == 0
    return torch.where(zero, torch.zeros_like(x),
                       x / torch.where(zero, torch.ones_like(y), y))


# -- comparison (bool output) ------------------------------------------
op("equals", "pairwise", differentiable=False)(_binary(torch.eq))
op("not_equals", "pairwise", differentiable=False)(_binary(torch.ne))
op("greater", "pairwise", differentiable=False)(_binary(torch.gt))
op("greater_equal", "pairwise", differentiable=False)(_binary(torch.ge))
op("less", "pairwise", differentiable=False)(_binary(torch.lt))
op("less_equal", "pairwise", differentiable=False)(_binary(torch.le))

# scalar comparison variants (reference *_scalar ops): the same functions
for _n, _f in [("eq_scalar", torch.eq), ("neq_scalar", torch.ne),
               ("gt_scalar", torch.gt), ("gte_scalar", torch.ge),
               ("lt_scalar", torch.lt), ("lte_scalar", torch.le)]:
    op(_n, "pairwise", differentiable=False)(_binary(_f))

# -- boolean ------------------------------------------------------------
op("boolean_and", "pairwise", differentiable=False)(
    _binary(torch.logical_and))
op("boolean_or", "pairwise", differentiable=False)(_binary(torch.logical_or))
op("boolean_xor", "pairwise", differentiable=False)(
    _binary(torch.logical_xor))
op("boolean_not", "pairwise", differentiable=False)(torch.logical_not)


def _cond(c):
    return c if c.dtype == torch.bool else c != 0


@op("select", "pairwise")
def select(cond, x, y):
    return torch.where(_cond(cond), x, y)


@op("Where", "pairwise", differentiable=False, aliases=("where_np",))
def where(cond, x=None, y=None):
    if x is None:
        return i32(torch.stack(torch.where(_cond(cond)), dim=-1))
    return torch.where(_cond(cond), x, y)


# -- merge family (n-ary elementwise) ----------------------------------
@op("mergeadd", "pairwise", aliases=("accumulate",))
def mergeadd(*xs):
    r = xs[0]
    for x in xs[1:]:
        r = r + x
    return r


@op("mergeavg", "pairwise")
def mergeavg(*xs):
    return mergeadd(*xs) / len(xs)


@op("mergemax", "pairwise")
def mergemax(*xs):
    r = xs[0]
    for x in xs[1:]:
        r = torch.maximum(r, x)
    return r


@op("mergemaxindex", "pairwise", differentiable=False)
def mergemaxindex(*xs):
    return i32(torch.argmax(torch.stack(xs, dim=0), dim=0))
