"""The port's ring, flash ring, blockwise and Ulysses attention against
dense attention and the JAX package's (``parallel/ring_attention.py``).

The sequence-parallel paths run on 4 gloo ranks, data=2 x seq=2, on
global inputs made with numpy; their gradients are those of
``sum(out * c)``, each rank backpropagating its part and the ranks'
gradients summed. The flash ring on CPU tensors runs the plain flash
version per block (the kernels run on CUDA tensors only); its blocks,
merge and written-out backward are what this holds. The JAX references
are its XLA ring (``use_flash=False``; the JAX package's own tests hold
its Pallas ring equal to it) on the same mesh shape.

Tolerances: f32 against float64 dense attention, atol 2e-5 on outputs
and 5e-5 on gradients (online-softmax sums in another order); against
the JAX ring, the same.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.parallel import ring_attention as jring

from deeplearning4j_tpu_torch.parallel import ring_attention as tring

from torch_parallel_cases import Ranks

OUT_ATOL, GRAD_ATOL = 2e-5, 5e-5
B, T, H, D = 4, 16, 4, 8


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def inputs(seed, masked):
    rs = np.random.RandomState(seed)
    q, k, v, c = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = (rs.rand(B, T) < 0.8).astype(np.int32)
        mask[0] = 0                      # a batch row with no live key
    return q, k, v, c, mask


def dense(q, k, v, mask=None, causal=False):
    """float64 softmax attention; a row with no live key gives 0."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    keep = np.ones(s.shape, bool)
    if mask is not None:
        keep &= mask[:, None, None, :] != 0
    if causal:
        keep &= np.tril(np.ones((q.shape[1],) * 2, bool))[None, None]
    s = np.where(keep, s, -np.inf)
    m = np.max(s, -1, keepdims=True)
    p = np.where(keep, np.exp(s - np.where(np.isfinite(m), m, 0)), 0)
    den = p.sum(-1, keepdims=True)
    p = np.where(den > 0, p / np.where(den > 0, den, 1), 0)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def dense_grads(q, k, v, c, mask, causal):
    """Gradients of sum(dense * c) by autograd in float64 torch."""
    import torch
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
          for a in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", ts[0], ts[1]) * D ** -0.5
    keep = torch.ones(s.shape, dtype=torch.bool)
    if mask is not None:
        keep &= torch.tensor(mask)[:, None, None, :] != 0
    if causal:
        keep &= torch.ones((T, T), dtype=torch.bool).tril()
    s = torch.where(keep, s, torch.tensor(-1e300, dtype=torch.float64))
    p = torch.softmax(s, -1) * keep.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, ts[2])
    (out * torch.tensor(c, dtype=torch.float64)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_matches_dense(ranks, use_flash, causal, masked):
    q, k, v, c, mask = inputs(1 + 2 * causal + masked, masked)
    out, grads = ranks.run("ring", "ring", q, k, v, mask, c, causal,
                           use_flash)[0]
    np.testing.assert_allclose(out, dense(q, k, v, mask, causal),
                               atol=OUT_ATOL, rtol=0)
    for g, w in zip(grads, dense_grads(q, k, v, c, mask, causal)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0)
    if masked:   # the row with no live key: zeros, and zero gradients
        assert np.all(out[0] == 0.0)
        assert np.all(grads[0][0] == 0.0)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(jmesh.MeshConfig(data=2, seq=2),
                           devices=jax.devices()[:4])


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_matches_jax_ring(ranks, jax_mesh, jax_ring_ref, use_flash):
    """Causal, with a key mask and a batch row with no live key."""
    q, k, v, c, mask, j_out, j_grads = jax_ring_ref
    out, grads = ranks.run("ring", "ring", q, k, v, mask, c, True,
                           use_flash)[0]
    np.testing.assert_allclose(out, j_out, atol=OUT_ATOL, rtol=0)
    for g, w in zip(grads, j_grads):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0)


@pytest.fixture(scope="module")
def jax_ring_ref(jax_mesh):
    causal = True
    q, k, v, c, mask = inputs(7 + causal, True)
    jm = jnp.asarray(mask.astype(bool))

    def f(q, k, v):
        return jring.ring_attention(q, k, v, jax_mesh, mask=jm,
                                    causal=causal)
    j_out = np.asarray(f(q, k, v))
    j_grads = jax.grad(lambda *a: jnp.sum(f(*a) * c), argnums=(0, 1, 2))(
        q, k, v)
    assert np.all(j_out[0] == 0.0)
    return q, k, v, c, mask, j_out, [np.asarray(g) for g in j_grads]


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_dense(ranks, jax_mesh, causal):
    q, k, v, c, _ = inputs(11 + causal, False)
    out, grads = ranks.run("ring", "ulysses", q, k, v, None, c, causal,
                           False)[0]
    want = np.asarray(jring.ulysses_attention(q, k, v, jax_mesh,
                                              causal=causal))
    np.testing.assert_allclose(out, want, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(out, dense(q, k, v, None, causal),
                               atol=OUT_ATOL, rtol=0)
    for g, w in zip(grads, dense_grads(q, k, v, c, None, causal)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("causal,block", [(False, 6), (True, 7),
                                          (False, 512)])
def test_blockwise_matches_jax_and_dense(causal, block):
    import torch
    q, k, v, _, _ = inputs(13, False)
    got = tring.blockwise_attention(*(torch.tensor(a) for a in (q, k, v)),
                                    causal=causal, block_size=block)
    want = np.asarray(jring.blockwise_attention(q, k, v, causal=causal,
                                                block_size=block))
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), dense(q, k, v, None, causal),
                               atol=OUT_ATOL, rtol=0)


def test_merge_floor_matches_jax():
    """A block at the masked floor merges with weight 0 on both sides;
    the port's plain flash gives about -1e30 + log Tk for a row it masks
    whole, under the floor."""
    import torch
    from deeplearning4j_tpu_torch.kernels import \
        flash_attention_with_lse_plain
    assert tring._MASKED_LSE_FLOOR == jring._MASKED_LSE_FLOOR
    q = torch.randn(1, 4, 1, 8)
    _, lse = flash_attention_with_lse_plain(
        q, q, q, torch.zeros(1, 4, dtype=torch.int32))
    assert float(lse.max()) < tring._MASKED_LSE_FLOOR
    rs = np.random.RandomState(3)
    o = rs.randn(1, 4, 1, 8).astype(np.float32)
    o_blk = rs.randn(1, 4, 1, 8).astype(np.float32)
    lse_blk = np.array([[[0.5, -2e30, 1.0, -1e31]]], np.float32)
    l, m = (np.full((1, 1, 4), 0.7, np.float32),
            np.full((1, 1, 4), 0.2, np.float32))
    want = jring._merge_block(*(jnp.asarray(a) for a in (o, l, m, o_blk,
                                                         lse_blk)))
    got = tring._merge_block(*(torch.tensor(a) for a in (o, l, m, o_blk,
                                                         lse_blk)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
