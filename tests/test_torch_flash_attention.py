"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs ``deeplearning4j_tpu.kernels.flash_attention`` as its
own tests run it here: the Pallas kernels (forward, dq, dk/dv) through
the Pallas interpreter. The port's wrappers take their plain version for
CPU tensors, with gradients from autograd; the CUDA kernels themselves
are held against that plain version on the card
(``tests/test_torch_kernels_cuda.py``). Inputs come from
``np.random.RandomState``; the cases are those of
``tests/test_kernels.py``.

Tolerances, as in the JAX package's tests: f32 atol 2e-5 on outputs and
on lse (O(1) values, the same sums in another order and tiling), 1e-4 on
gradients (sums over S of products of O(1) terms).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import flash_attention as jflash
from deeplearning4j_tpu.kernels import flash_attention_with_lse as jflash_lse
from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                              flash_attention_plain,
                                              flash_attention_with_lse,
                                              flash_attention_with_lse_plain)
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    _aligned, _check_kernel_args)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


def _inputs(seed, B=2, S=128, H=2, D=16, masked_from=None,
            hidden_lead=None):
    """q, k, v [B, S, H, D] and a key mask: ``masked_from`` hides the keys
    from there on in every batch row; ``hidden_lead`` = (row, n) hides
    keys [0, n) of one batch row."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = None
    if masked_from is not None:
        mask = np.ones((B, S), np.int32)
        mask[:, masked_from:] = 0
    if hidden_lead is not None:
        mask = np.ones((B, S), np.int32) if mask is None else mask
        row, n = hidden_lead
        mask[row, :n] = 0
    return q, k, v, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# forward cases: (name, seed, shape kw, masked_from, causal)
FWD_CASES = [
    ("reference", 0, {}, None, False),
    ("masked", 1, {}, 100, False),
    ("causal", 2, {"S": 64}, None, True),
    ("odd_seq_200", 7, {"S": 200}, None, False),
    ("odd_seq_150_masked", 8, {"B": 1, "S": 150, "D": 8}, 120, False),
    ("causal_and_masked", 9, {"S": 96}, 70, True),
    # batch row 1 hides its first 128 keys: at S = 520 (padded to 640)
    # the JAX kernel's first 128-key tile, where p = 1 until the next
    # tile resets it through alpha
    ("leading_keys_masked", 16, {"S": 520, "hidden_lead": (1, 128)}, None,
     False),
]


@pytest.mark.parametrize("name,seed,kw,masked_from,causal", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_forward_matches_jax(name, seed, kw, masked_from, causal):
    q, k, v, mask = _inputs(seed, masked_from=masked_from, **kw)
    want = jax.jit(lambda q, k, v, m: jflash(q, k, v, mask=m,
                                             causal=causal))(
        _j(q), _j(k), _j(v), _j(mask))
    got = flash_attention(_t(q), _t(k), _t(v), mask=_t(mask), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


def _grads_torch(loss, q, k, v, **kw):
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    loss(flash_attention(*ts, **kw)).backward()
    return [t.grad.numpy() for t in ts]


# gradient cases: (name, seed, shape kw, masked_from, causal, loss)
GRAD_CASES = [
    ("plain", 3, {"S": 64}, None, False, "sq"),
    ("masked", 4, {"S": 64}, 50, False, "sq"),
    ("causal", 5, {"S": 64}, None, True, "cos"),
    ("odd_seq_150_masked", 8, {"B": 1, "S": 150, "D": 8}, 120, False, "sq"),
]
LOSSES = {"sq": (lambda o: jnp.sum(o ** 2), lambda o: torch.sum(o ** 2)),
          "cos": (lambda o: jnp.sum(o * jnp.cos(o)),
                  lambda o: torch.sum(o * torch.cos(o)))}


@pytest.mark.parametrize("name,seed,kw,masked_from,causal,loss", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax(name, seed, kw, masked_from, causal, loss):
    q, k, v, mask = _inputs(seed, masked_from=masked_from, **kw)
    jloss, tloss = LOSSES[loss]
    want = jax.jit(jax.grad(
        lambda q, k, v, m: jloss(jflash(q, k, v, mask=m, causal=causal)),
        argnums=(0, 1, 2)))(_j(q), _j(k), _j(v), _j(mask))
    got = _grads_torch(tloss, q, k, v, mask=_t(mask), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_and_its_gradient_match_jax(causal):
    """Both outputs, and a loss that reads lse: the lse cotangent path
    (delta - g_lse in the backward kernels)."""
    q, k, v, mask = _inputs(10, S=64, masked_from=40)
    w = np.random.RandomState(11).randn(2, 2, 64).astype(np.float32)

    def jloss(q, k, v, m):
        o, lse = jflash_lse(q, k, v, mask=m, causal=causal)
        return jnp.sum(o ** 2) + jnp.sum(lse * w)

    o_j, lse_j = jax.jit(lambda q, k, v, m: jflash_lse(
        q, k, v, mask=m, causal=causal))(_j(q), _j(k), _j(v), _j(mask))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        _j(q), _j(k), _j(v), _j(mask))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = flash_attention_with_lse(*ts, mask=_t(mask), causal=causal)
    assert lse.shape == (2, 2, 64) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               atol=OUT_ATOL, rtol=0)
    (torch.sum(o ** 2) + torch.sum(lse * _t(w))).backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, rtol=0)


def test_fully_masked_row_is_the_mean_of_v():
    """At S <= 128 the JAX flash path pads nothing, so both sides give
    the uniform softmax over all S keys; lse rounds to -1e30."""
    q, k, v, _ = _inputs(12, S=96)
    mask = np.ones((2, 96), np.int32)
    mask[1] = 0                                  # batch row 1: no key
    o_j, lse_j = jax.jit(lambda q, k, v, m: jflash_lse(q, k, v, mask=m))(
        _j(q), _j(k), _j(v), _j(mask))
    o, lse = flash_attention_with_lse(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(o[1].numpy(),
                               np.broadcast_to(v[1].mean(0), (96, 2, 16)),
                               atol=OUT_ATOL, rtol=0)
    assert (lse[1].numpy() == np.float32(-1e30)).all()
    assert (np.asarray(lse_j)[1] == np.float32(-1e30)).all()


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask = _inputs(13, S=32, masked_from=20)
    args = (_t(q), _t(k), _t(v))
    want = flash_attention_plain(*args, mask=_t(mask))
    assert torch.equal(flash_attention(*args, mask=_t(mask)), want)
    o, lse = flash_attention_with_lse(*args, mask=_t(mask))
    o_p, lse_p = flash_attention_with_lse_plain(*args, mask=_t(mask))
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)


def test_argument_checks():
    q, k, v, _ = _inputs(14, S=16)
    with pytest.raises(ValueError):
        flash_attention(_t(q), _t(k)[:, :8], _t(v))
    with pytest.raises(ValueError):
        flash_attention(_t(q), _t(k), _t(v), mask=torch.ones(2, 8))
    # what only the CUDA kernels refuse, checked before any launch
    t = _t(q)
    _check_kernel_args(t, t, t)
    _check_kernel_args(t.bfloat16(), t.bfloat16(), t.bfloat16())
    with pytest.raises(TypeError):
        _check_kernel_args(t.half(), t.half(), t.half())
    with pytest.raises(TypeError):
        _check_kernel_args(t, t.bfloat16(), t)
    odd = torch.zeros(2, 16, 2, 12)
    with pytest.raises(ValueError):
        _check_kernel_args(odd, odd, odd)
    wide = torch.zeros(1, 4, 1, 136)
    with pytest.raises(ValueError):
        _check_kernel_args(wide, wide, wide)
    strided = torch.zeros(2, 16, 2, 32)[..., ::2]
    with pytest.raises(ValueError):
        _check_kernel_args(strided, strided, strided)


def test_fully_masked_row_gradient_is_the_plain_softmax_gradient():
    """For a fully masked row the port's gradient is that of the masked
    softmax (``ds = 0``, ``p = 1/S`` for dv), which the JAX package's
    plain attention gives too; its Pallas backward differs there (it
    recomputes ``p = exp(s - lse) = 1`` from an lse that rounds to
    -1e30), so the reference here is the JAX plain version."""
    q, k, v, _ = _inputs(15, S=64)
    mask = np.ones((2, 64), np.int32)
    mask[1] = 0

    def jref(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
        s = jnp.where(jnp.asarray(mask)[:, None, None, :] != 0, s, -1e30)
        o = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)
        return jnp.sum(o ** 2)

    want = jax.jit(jax.grad(jref, argnums=(0, 1, 2)))(_j(q), _j(k), _j(v))
    got = _grads_torch(lambda o: torch.sum(o ** 2), q, k, v, mask=_t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_inputs_are_16_byte_aligned(dtype):
    """What the backward kernels' 16-byte cp.async copies are given: an
    aligned tensor or view as it is (no copy), anything else as an
    aligned contiguous copy with the same values."""
    B, S, H, D = 2, 5, 3, 16
    t = torch.randn(B, S, H, D).to(dtype)
    assert _aligned(t) is t
    # q, k and v of one packed projection: strided, every step aligned
    qkv = torch.randn(B, S, H, 3 * D).to(dtype)
    q = qkv[..., D:2 * D]
    assert not q.is_contiguous() and _aligned(q) is q
    # a base 1 element past a 16-byte boundary: contiguous, misaligned
    buf = torch.randn(B * S * H * D + 1).to(dtype)
    odd_base = buf[1:].view(B, S, H, D)
    # a row step that is not a multiple of 16 bytes
    odd_step = torch.randn(B, S, H, D + 2).to(dtype)[..., :D]
    # a D stride of 2
    d_step = torch.randn(B, S, H, 2 * D).to(dtype)[..., ::2]
    for bad in (odd_base, odd_step, d_step):
        got = _aligned(bad)
        assert got is not bad and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, bad)
