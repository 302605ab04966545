"""Elementwise transform ops and activations.

Counterpart of ``deeplearning4j_tpu/ops/transforms.py`` (the reference's
``headers/transforms.h``, the legacy transform loops and the activations
of ``headers/nn.h``): each op is one or a few PyTorch calls. Where the
JAX op's semantics differ from PyTorch's default they are kept:
``gelu`` is the tanh form (``jax.nn.gelu``'s default), ``round`` and
``rint`` round half to even, ``standardize`` uses the biased (ddof 0)
deviation, and a cast to a 64-bit type gives the 32-bit type, as JAX
does with 64-bit types off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._util import axes, dtype_of, tensor_like, tree_leaves, tree_map
from .registry import op

# -- basic unary math ---------------------------------------------------
op("abs", "transforms")(torch.abs)
op("neg", "transforms")(torch.neg)
op("exp", "transforms")(torch.exp)
op("expm1", "transforms")(torch.expm1)
op("log", "transforms")(torch.log)
op("Log1p", "transforms", aliases=("log1p",))(torch.log1p)
op("log2", "transforms")(torch.log2)
op("sqrt", "transforms")(torch.sqrt)
op("rsqrt", "transforms")(torch.rsqrt)
op("square", "transforms")(torch.square)
op("cube", "transforms")(lambda x: x * x * x)
op("reciprocal", "transforms")(torch.reciprocal)
op("sign", "transforms")(torch.sign)
op("Floor", "transforms", aliases=("floor",))(torch.floor)
op("ceil", "transforms")(torch.ceil)
op("rint", "transforms")(torch.round)    # half to even, as jnp.rint
op("round", "transforms")(torch.round)   # half to even, as jnp.round

# -- trig ---------------------------------------------------------------
op("sin", "transforms")(torch.sin)
op("cos", "transforms")(torch.cos)
op("tan", "transforms")(torch.tan)
op("asin", "transforms")(torch.asin)
op("acos", "transforms")(torch.acos)
op("atan", "transforms")(torch.atan)
op("sinh", "transforms")(torch.sinh)
op("cosh", "transforms")(torch.cosh)
op("tanh", "transforms")(torch.tanh)
op("asinh", "transforms")(torch.asinh)
op("acosh", "transforms")(torch.acosh)
op("atanh", "transforms")(torch.atanh)
op("tf_atan2", "transforms", aliases=("atan2",))(
    lambda y, x: torch.atan2(y, tensor_like(x, y)))

# -- special ------------------------------------------------------------
op("isnan", "transforms", differentiable=False)(torch.isnan)
op("isinf", "transforms", differentiable=False)(torch.isinf)
op("isfinite", "transforms", differentiable=False)(torch.isfinite)
op("erf", "transforms")(torch.erf)
op("erfc", "transforms")(torch.erfc)
op("lgamma", "transforms")(torch.lgamma)
op("digamma", "transforms")(torch.digamma)


@op("polygamma", "transforms")
def polygamma(n, x):
    """The n-th derivative of digamma; an integer tensor ``n`` of more
    than one element is taken elementwise, through
    ``(-1)^(n+1) n! zeta(n + 1, x)``."""
    if not isinstance(n, torch.Tensor) or n.dim() == 0:
        return torch.special.polygamma(int(n), x)
    nf = n.to(x.dtype)
    sign = 1.0 - 2.0 * torch.remainder(nf + 1.0, 2.0)
    val = sign * torch.exp(torch.lgamma(nf + 1.0)) * torch.special.zeta(
        nf + 1.0, x)
    return torch.where(n == 0, torch.special.digamma(x), val)



op("zeta", "transforms")(
    lambda x, q: torch.special.zeta(x, tensor_like(q, x)))
op("igamma", "transforms")(
    lambda a, x: torch.special.gammainc(a, tensor_like(x, a)))
op("igammac", "transforms")(
    lambda a, x: torch.special.gammaincc(a, tensor_like(x, a)))


def _betacf(a, b, x, iters=200):
    """The continued fraction of the incomplete beta function (modified
    Lentz), for x < (a + 1) / (a + b + 2)."""
    tiny = torch.finfo(x.dtype).tiny
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    h = d
    for m in range(1, iters + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    return h


@op("betainc", "transforms")
def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b) (PyTorch has none): the
    continued fraction on the side of (a + 1) / (a + b + 2) where it
    converges, the symmetry I_x(a, b) = 1 - I_{1-x}(b, a) on the other."""
    a, b, x = torch.broadcast_tensors(a, tensor_like(b, a), tensor_like(x, a))
    xc = x.clamp(0.0, 1.0)
    inner = xc.clamp(1e-30, 1.0 - 1e-7)
    lbt = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
           + a * torch.log(inner) + b * torch.log1p(-inner))
    bt = torch.exp(lbt)
    front = xc < (a + 1.0) / (a + b + 2.0)
    lo = bt * _betacf(a, b, inner) / a
    hi = 1.0 - bt * _betacf(b, a, 1.0 - inner) / b
    out = torch.where(front, lo, hi)
    out = torch.where(xc <= 0.0, torch.zeros_like(out), out)
    return torch.where(xc >= 1.0, torch.ones_like(out), out)


# -- activations (headers/nn.h) ----------------------------------------
op("sigmoid", "activations")(torch.sigmoid)
op("relu", "activations")(lambda x, cutoff=0.0: torch.clamp(x, min=cutoff))
op("relu6", "activations")(lambda x: torch.clamp(x, 0.0, 6.0))
op("lrelu", "activations", aliases=("leakyrelu",))(
    lambda x, alpha=0.01: F.leaky_relu(x, alpha))
op("elu", "activations")(lambda x, alpha=1.0: F.elu(x, alpha))
# functions of x alone, as jax.nn's: torch.nn.functional's own take an
# `inplace=` that would overwrite the caller's tensor
op("selu", "activations")(lambda x: F.selu(x))


@op("gelu", "activations")
def gelu(x, approximate=True):
    """jax.nn.gelu: the tanh approximation by default, the erf form with
    ``approximate=False``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


op("softplus", "activations")(
    lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                             device=x.device)))
op("softsign", "activations")(F.softsign)
op("hardsigmoid", "activations")(lambda x: F.hardsigmoid(x))
op("hardtanh", "activations")(lambda x: torch.clamp(x, -1.0, 1.0))
op("swish", "activations")(lambda x: F.silu(x))
op("mish", "activations")(lambda x: F.mish(x))
op("hardswish", "activations")(lambda x: F.hardswish(x))


@op("thresholdedrelu", "activations")
def thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


@op("rationaltanh", "activations")
def rationaltanh(x):
    # reference: 1.7159 * tanh(2x/3) approximated rationally
    a = 1.7159
    x23 = 0.6666667 * x
    return a * x23 / (1.0 + torch.abs(x23))


@op("rectifiedtanh", "activations")
def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


@op("crelu", "activations")
def crelu(x):
    return torch.cat([torch.clamp(x, min=0), torch.clamp(-x, min=0)], dim=-1)


@op("prelu", "activations")
def prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


@op("cast", "transforms")
def cast(x, dtype):
    return x.to(dtype_of(dtype))


for _name, _dt in [("to_double", "float64"), ("to_float32", "float32"),
                   ("to_float16", "float16"), ("to_int32", "int32"),
                   ("to_int64", "int64"), ("to_uint32", "uint32"),
                   ("to_uint64", "uint64")]:
    op(_name, "transforms")(lambda x, _d=_dt: x.to(dtype_of(_d)))

op("identity", "transforms")(lambda x: x)
op("ones_as", "transforms")(torch.ones_like)
op("zeros_as", "transforms")(torch.zeros_like)
op("fill_as", "transforms")(lambda x, v: torch.as_tensor(
    v, dtype=x.dtype, device=x.device).expand(x.shape).clone())
op("stop_gradient", "transforms")(lambda x: x.detach())
op("noop", "transforms")(lambda *a: a[0] if a else None)


@op("clipbyvalue", "transforms", aliases=("clip_by_value",))
def clipbyvalue(x, clip_min, clip_max):
    return torch.clamp(x, clip_min, clip_max)


def _norm_clip(x, clip_norm, axis, reduce):
    ax = axes(axis)
    n = torch.sqrt(reduce(x * x, dim=ax, keepdim=ax is not None))
    return torch.where(n > clip_norm,
                       x * (clip_norm / torch.clamp(n, min=1e-12)), x)


@op("clipbynorm", "transforms")
def clipbynorm(x, clip_norm, axis=None):
    return _norm_clip(x, clip_norm, axis, torch.sum)


@op("clipbyavgnorm", "transforms")
def clipbyavgnorm(x, clip_norm, axis=None):
    return _norm_clip(x, clip_norm, axis, torch.mean)


@op("clip_by_global_norm", "transforms")
def clip_by_global_norm(xs, clip_norm):
    g = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(xs)))
    scale = torch.clamp(clip_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, xs), g


@op("standardize", "transforms")
def standardize(x, axis=-1):
    ax = axes(axis)
    m = torch.mean(x, dim=ax, keepdim=True)
    s = torch.std(x, dim=ax, keepdim=True, correction=0)
    return (x - m) / torch.clamp(s, min=1e-12)


def _scan(fn, x, axis, exclusive, reverse, undo):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if reverse:
        x = torch.flip(x, dims=(axis,))
    r = fn(x, dim=axis)
    if exclusive:
        r = undo(r, x)
    if reverse:
        r = torch.flip(r, dims=(axis,))
    return r


@op("cumsum", "transforms")
def cumsum(x, axis=None, exclusive=False, reverse=False):
    return _scan(torch.cumsum, x, axis, exclusive, reverse,
                 lambda r, x: r - x)


@op("cumprod", "transforms")
def cumprod(x, axis=None, exclusive=False, reverse=False):
    return _scan(torch.cumprod, x, axis, exclusive, reverse,
                 lambda r, x: r / x)


op("is_numeric_tensor", "transforms", differentiable=False)(
    lambda x: torch.tensor(x.dtype != torch.bool, device=x.device))
op("is_non_decreasing", "transforms", differentiable=False)(
    lambda x: torch.all(torch.diff(x.reshape(-1)) >= 0))
op("is_strictly_increasing", "transforms", differentiable=False)(
    lambda x: torch.all(torch.diff(x.reshape(-1)) > 0))


@op("check_numerics", "transforms", differentiable=False)
def check_numerics(x, message=""):
    return x  # panic-mode checking happens in the executioner profiler


@op("ismax", "transforms", differentiable=False)
def ismax(x, axis=None):
    if axis is None:
        return (x == torch.max(x)).to(x.dtype)
    return (x == torch.amax(x, dim=axis, keepdim=True)).to(x.dtype)


@op("zero_fraction", "transforms", differentiable=False)
def zero_fraction(x):
    return torch.mean((x == 0).to(torch.float32))


@op("axpy", "transforms")
def axpy(x, y, alpha=1.0):
    return alpha * x + y


_COMPARISONS = {0: torch.eq, 1: torch.ne, 2: torch.lt, 3: torch.le,
                4: torch.gt, 5: torch.ge}


@op("choose", "transforms", differentiable=False)
def choose(x, mode, scalar):
    return x[_COMPARISONS[int(mode)](x, scalar)]
