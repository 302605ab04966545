"""The port's paged-flash decode read against the JAX package's.

On the CPU the port's wrapper runs ``paged_flash_decode_plain`` (the
block-table gather read); it is held against the JAX Pallas kernel in
interpret mode and against the gather math written out in numpy, for the
Q=1 decode and Q=3 speculative-verify shapes, with an empty, an unaligned
and a nearly full slot, a permuted table with block 0 as scratch, and the
strided per-layer view of a 5-D pool. Inputs come from numpy with a seed.

Tolerance: atol = rtol = 2e-5 in f32. Both sides compute the same masked
softmax over the same rows; they differ only in summation order (online
softmax in the kernel, one-shot in the gather), which at unit-scale
inputs moves results by ~1e-7.

``TestSplitAlgebra`` holds ``paged_flash_decode_split_plain`` (the CUDA
kernel's split-and-merge written out in PyTorch) against the JAX kernel
and the plain read at the lengths where a split boundary matters, at
atol 1e-5 in f32: the merge rescales each split's sums by exp(m_split -
m) once, a few f32 roundings more than the one-shot softmax.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.kernels.paged_flash_decode import \
    paged_flash_decode as jax_paged_flash_decode
from deeplearning4j_tpu_torch.kernels import (paged_flash_decode,
                                              paged_flash_decode_plain)
from deeplearning4j_tpu_torch.kernels.paged_flash_decode import \
    paged_flash_decode_split_plain

ATOL = RTOL = 2e-5


def _inputs(Q, S=3, MB=2, Bs=8, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    N = S * MB + 1  # block 0 left as scratch, like the engine's pool
    q = (rng.randn(S, Q, H, D) * 0.4).astype(np.float32)
    kp = (rng.randn(N, Bs, H, D) * 0.4).astype(np.float32)
    vp = (rng.randn(N, Bs, H, D) * 0.4).astype(np.float32)
    tables = rng.permutation(np.arange(1, N)).reshape(S, MB).astype(np.int32)
    # committed lengths: empty slot, unaligned, nearly full
    lengths = np.asarray([0, 5, MB * Bs - Q][:S], np.int32)
    return q, kp, vp, tables, lengths


def _gather_math(q, kp, vp, tables, lengths):
    """The gather read in float64 numpy: softmax(QKᵀ·scale) V over rows
    r <= lengths[s] + qi of each slot's gathered blocks."""
    S, Q, H, D = q.shape
    MB, Bs = tables.shape[1], kp.shape[1]
    C = MB * Bs
    ks = kp[tables].reshape(S, C, H, D).astype(np.float64)
    vs = vp[tables].reshape(S, C, H, D).astype(np.float64)
    att = np.einsum("sqhd,schd->shqc", q.astype(np.float64), ks) * D ** -0.5
    pos = lengths[:, None] + np.arange(Q)[None, :]
    mask = np.arange(C)[None, None, :] <= pos[:, :, None]
    att = np.where(mask[:, None], att, -np.inf)
    p = np.exp(att - att.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("shqc,schd->sqhd", p, vs)


def _port(q, kp, vp, tables, lengths):
    t = torch.from_numpy
    return paged_flash_decode(t(q), t(kp), t(vp), t(tables),
                              t(lengths)).numpy()


class TestAgainstReference:
    @pytest.mark.parametrize("Q", [1, 3])
    def test_matches_jax_kernel_interpret(self, Q):
        q, kp, vp, tables, lengths = _inputs(Q)
        ref = np.asarray(jax_paged_flash_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lengths), interpret=True))
        np.testing.assert_allclose(_port(q, kp, vp, tables, lengths), ref,
                                   atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("Q", [1, 3])
    def test_matches_gather_math(self, Q):
        q, kp, vp, tables, lengths = _inputs(Q, seed=1)
        np.testing.assert_allclose(_port(q, kp, vp, tables, lengths),
                                   _gather_math(q, kp, vp, tables, lengths),
                                   atol=ATOL, rtol=RTOL)

    def test_strided_layer_view_of_5d_pool(self):
        """The caller passes ``pool[:, i]`` of a [N, L, Bs, H, D] pool: a
        non-contiguous view, read in place."""
        Q, L, i = 3, 3, 1
        q, kp, vp, tables, lengths = _inputs(Q, seed=2)
        rng = np.random.RandomState(3)
        pool_k = rng.randn(kp.shape[0], L, *kp.shape[1:]).astype(np.float32)
        pool_v = rng.randn(kp.shape[0], L, *kp.shape[1:]).astype(np.float32)
        pool_k[:, i], pool_v[:, i] = kp, vp
        tk, tv = torch.from_numpy(pool_k), torch.from_numpy(pool_v)
        view_k, view_v = tk[:, i], tv[:, i]
        assert not view_k.is_contiguous()
        got = paged_flash_decode(torch.from_numpy(q), view_k, view_v,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(lengths)).numpy()
        ref = np.asarray(jax_paged_flash_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lengths), interpret=True))
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("Q", [1, 3])
    def test_scratch_block_never_leaks(self, Q):
        """Table padding points at block 0: poisoning it changes
        nothing."""
        q, kp, vp, tables, lengths = _inputs(Q, MB=4, seed=4)
        tables[:, 2:] = 0                      # unallocated columns
        lengths = np.minimum(lengths, 2 * 8 - Q).astype(np.int32)
        clean = _port(q, kp, vp, tables, lengths)
        kp[0], vp[0] = 1e4, -1e4
        np.testing.assert_array_equal(_port(q, kp, vp, tables, lengths),
                                      clean)


# the split tests' table: 6 blocks of 8 rows, 48 rows in all
_SPLIT_MB, _SPLIT_BS = 6, 8


def _split_lengths(Q, split_rows):
    """Empty, one row, Bs-1, Bs, the last query row ending exactly on the
    first split boundary and one row past it, and a full table."""
    C = _SPLIT_MB * _SPLIT_BS
    return np.asarray([0, 1, _SPLIT_BS - 1, _SPLIT_BS, split_rows - Q,
                       split_rows - Q + 1, C - Q], np.int32).clip(0, C - Q)


@functools.lru_cache(maxsize=None)
def _split_case(Q, split_rows):
    q, kp, vp, tables, _ = _inputs(Q, S=7, MB=_SPLIT_MB, Bs=_SPLIT_BS,
                                   seed=10 + Q)
    return q, kp, vp, tables, _split_lengths(Q, split_rows)


@functools.lru_cache(maxsize=None)
def _jax_ref(Q, split_rows):
    q, kp, vp, tables, lengths = _split_case(Q, split_rows)
    return np.asarray(jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True))


class TestSplitAlgebra:
    """The kernel's split-and-merge, emulated on the CPU: split sizes that
    divide the 48-row table (16, 48: one split) and that do not (32)."""

    @pytest.mark.parametrize("ref", ["jax_interpret", "plain"])
    @pytest.mark.parametrize("split_rows", [16, 32, 48])
    @pytest.mark.parametrize("Q", [1, 5])
    def test_split_merge_matches(self, Q, split_rows, ref):
        q, kp, vp, tables, lengths = _split_case(Q, split_rows)
        t = torch.from_numpy
        got = paged_flash_decode_split_plain(
            t(q), t(kp), t(vp), t(tables), t(lengths), split_rows).numpy()
        assert np.isfinite(got).all()
        if ref == "jax_interpret":
            want = _jax_ref(Q, split_rows)
        else:
            want = paged_flash_decode_plain(
                t(q), t(kp), t(vp), t(tables), t(lengths)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_a_split_with_no_visible_row_adds_nothing(self):
        """Slot 0 (length 0) sees row 0 only: its later splits hold no
        visible row, so poisoning their rows changes nothing."""
        q, kp, vp, tables, lengths = (np.array(a) for a in
                                      _split_case(1, 16))
        t = torch.from_numpy
        clean = paged_flash_decode_split_plain(
            t(q), t(kp), t(vp), t(tables), t(lengths), 16).numpy()
        for blk in tables[0, 2:]:          # rows 16.. of slot 0
            kp[blk], vp[blk] = 1e4, -1e4
        got = paged_flash_decode_split_plain(
            t(q), t(kp), t(vp), t(tables), t(lengths), 16).numpy()
        np.testing.assert_array_equal(got[0], clean[0])


class TestWrapperChecks:
    def test_rejects_mixed_dtypes(self):
        q, kp, vp, tables, lengths = map(torch.from_numpy, _inputs(1))
        with pytest.raises(TypeError):
            paged_flash_decode(q, kp.double(), vp, tables, lengths)

    def test_rejects_int64_tables(self):
        q, kp, vp, tables, lengths = map(torch.from_numpy, _inputs(1))
        with pytest.raises(TypeError):
            paged_flash_decode(q, kp, vp, tables.long(), lengths)

    def test_rejects_mismatched_shapes(self):
        q, kp, vp, tables, lengths = map(torch.from_numpy, _inputs(1))
        with pytest.raises(ValueError):
            paged_flash_decode(q, kp[..., :32], vp[..., :32], tables,
                               lengths)

    def test_cpu_call_does_not_count_a_launch(self):
        before = paged_flash_decode.launches
        _port(*_inputs(1))
        assert paged_flash_decode.launches == before

