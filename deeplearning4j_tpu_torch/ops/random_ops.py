"""Random ops.

Counterpart of ``deeplearning4j_tpu/ops/random_ops.py`` (the reference's
``headers/random.h``). Every op takes ``key`` first, as the JAX ops do;
the port's key is an int seed (``common/rng.py``; a 0-d tensor or a
``torch.Generator`` also serve), drawn on the default device (the
SameDiff graph's). The streams cannot match ``jax.random``: the same key
gives the same draws here, and only shapes, dtypes and moments compare
with the JAX package.
"""
from __future__ import annotations

import torch

from ._util import dtype_of, generator, i32, ints
from .registry import op


@op("randomuniform", "random", differentiable=False,
    aliases=("random_uniform",))
def randomuniform(key, shape, minval=0.0, maxval=1.0, dtype="float32"):
    dt = dtype_of(dtype)
    g = generator(key)
    if not dt.is_floating_point:
        return torch.randint(int(minval), int(maxval), ints(shape),
                             generator=g, device=g.device, dtype=dt)
    u = torch.rand(ints(shape), generator=g, device=g.device, dtype=dt)
    return minval + (maxval - minval) * u


@op("random_normal", "random", differentiable=False)
def random_normal(key, shape, mean=0.0, stddev=1.0, dtype="float32"):
    g = generator(key)
    return mean + stddev * torch.randn(ints(shape), generator=g,
                                       device=g.device,
                                       dtype=dtype_of(dtype))


@op("random_bernoulli", "random", differentiable=False)
def random_bernoulli(key, shape, p=0.5, dtype="float32"):
    g = generator(key)
    u = torch.rand(ints(shape), generator=g, device=g.device)
    return (u < p).to(dtype_of(dtype))


@op("random_exponential", "random", differentiable=False)
def random_exponential(key, shape, lam=1.0, dtype="float32"):
    g = generator(key)
    e = torch.empty(ints(shape), device=g.device, dtype=dtype_of(dtype))
    return e.exponential_(1.0, generator=g) / lam


@op("random_gamma", "random", differentiable=False)
def random_gamma(key, shape, alpha, beta=1.0, dtype="float32"):
    """Gamma(alpha, 1) / beta. ``torch._standard_gamma`` takes no
    generator, so the draw runs on a forked global stream seeded with
    the key."""
    g = generator(key)
    dt = dtype_of(dtype)
    a = torch.broadcast_to(torch.as_tensor(alpha, dtype=dt, device=g.device),
                           ints(shape))
    devices = [g.device] if g.device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(int(g.initial_seed()))
        return torch._standard_gamma(a.contiguous()) / beta


@op("random_poisson", "random", differentiable=False)
def random_poisson(key, shape, lam, dtype="int32"):
    g = generator(key)
    rates = torch.broadcast_to(torch.as_tensor(lam, dtype=torch.float32,
                                               device=g.device), ints(shape))
    return torch.poisson(rates.contiguous(), generator=g).to(dtype_of(dtype))


@op("random_multinomial", "random", differentiable=False)
def random_multinomial(key, logits, num_samples, dtype="int32"):
    g = generator(key, logits.device)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, int(num_samples), replacement=True,
                             generator=g).to(dtype_of(dtype))


@op("random_shuffle", "random", differentiable=False)
def random_shuffle(key, x, axis=0):
    g = generator(key, x.device)
    perm = torch.randperm(x.shape[axis], generator=g, device=x.device)
    return torch.index_select(x, axis, perm)


@op("random_crop", "random", differentiable=False)
def random_crop(key, x, size):
    size = ints(size)
    g = generator(key, "cpu")   # a Generator key draws on its device
    starts = [int(torch.randint(0, d - s + 1, (), generator=g,
                                device=g.device))
              for d, s in zip(x.shape, size)]
    return x[tuple(slice(b, b + s) for b, s in zip(starts, size))]


@op("dropout_inverted", "random", differentiable=False)
def dropout_inverted(key, x, p):
    keep = 1.0 - p
    g = generator(key, x.device)
    mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@op("get_seed", "random", differentiable=False)
def get_seed():
    from ..ndarray import factory
    return i32(torch.tensor(factory.get_random().get_seed()))


@op("set_seed", "random", differentiable=False)
def set_seed(seed):
    from ..ndarray import factory
    factory.set_seed(int(seed))
    return i32(torch.tensor(int(seed)))
