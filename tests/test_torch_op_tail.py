"""The port's last op families against the JAX package's, op by op, on
the same numpy inputs: bitwise, compression, segment (with the segment
``_bp`` ops), string, list, the linear-algebra decompositions and the
parity tail (``deeplearning4j_tpu_torch/ops/{bitwise_ops,compression,
segment_ops,string_ops,list_ops,linalg_ops,parity_extra}.py``), and the
three activations' and ``cross``'s keyword repairs.

Tensor ops run through ``test_torch_ops.py``'s harness (``exec_op`` on
both sides from one ``np.random.RandomState`` draw; results, dtypes and
shapes, and for a differentiable op the port's autograd against
``jax.grad``); host ops (strings, ``hashcode``, ``broadcastgradientargs``)
and the list ops' tuples compare their numpy results here. Tolerances,
each with its reason:
- integer, boolean and bit results, selections and host results:
  exactly (``EXACT``);
- elementwise f32: atol 1e-6 plus rtol 1e-6 (``F32``);
- sums, products and small solves (segments, confusion weights, t-SNE
  forces, the transposed convolutions, inverses, determinants and
  triangular solves of well-conditioned 4x4 draws): 1e-5 (``SUM``), a
  few dozen terms in another order;
- factorisations through LAPACK on both sides (cholesky, lu, eigh's
  eigenvalues, the SVD's singular values, lstsq through the SVD, 20
  Denman-Beavers steps): 1e-4 (``FACTOR``), each an iteration whose f32
  rounding differs between LAPACK builds;
- gradients through the harness: 1e-5, as in ``test_torch_ops.py``;
  those of the factors held by invariants below: ``FACTOR`` (a backward
  through an SVD or an eigendecomposition divides by differences of
  singular values or eigenvalues).
Where the two libraries may legitimately differ (the column signs of
``qr``, ``svd`` and ``eigh``; ``eig``'s order and scale), the factors are
held by reconstruction and invariants, not raw.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.registry import exec_op as jexec

from test_torch_ops import (BP_SEGMENT, F, F32, I, K, P, SUM, TREG,
                            _compare, _draw,
                            test_bp_op_matches_jax as _bp_matches,
                            test_op_matches_jax as _op_matches)

from deeplearning4j_tpu_torch.ops import exec_op as texec

EXACT = dict(atol=0, rtol=0)
FACTOR = dict(atol=1e-4, rtol=1e-4)

#: the 85 names this slice registers: 74 forwards and the 11 segment
#: ``_bp`` ops autobp derives from them
TAIL = {
    "bitwise_ops": (
        "bits_hamming_distance", "bitwise_and", "bitwise_or", "bitwise_xor",
        "cyclic_rshift_bits", "cyclic_shift_bits", "rshift_bits",
        "shift_bits", "toggle_bits"),
    "compression": (
        "decode_bitmap", "decode_threshold", "encode_bitmap",
        "encode_threshold"),
    "linalg_ops": (
        "cholesky", "cross_batched", "eig", "knn_mindistance",
        "log_matrix_determinant", "logdet", "lstsq", "lu",
        "matrix_determinant", "matrix_inverse", "qr", "self_adjoint_eig",
        "solve", "solve_ls", "sqrtm", "svd", "triangular_solve"),
    "list_ops": (
        "clone_list", "create_list", "delete_list", "gather_list",
        "pick_list", "read_list", "scatter_list", "size_list", "split_list",
        "stack_list", "unstack_list", "write_list"),
    "parity_extra": (
        "Assert", "barnes_edge_forces", "barnes_gains", "barnes_symmetrized",
        "broadcastgradientargs", "cell_contains", "compare_and_bitpack",
        "confusion_matrix", "conv2d_input_bp", "create_view", "ctc_beam",
        "deconv2d_tf", "fake_quant_with_min_max_vars",
        "fake_quant_with_min_max_vars_per_channel", "min_max_datatype",
        "norm", "print_variable"),
    "segment_ops": (
        "segment_max", "segment_mean", "segment_min", "segment_prod",
        "segment_sum", "unsorted_segment_max", "unsorted_segment_mean",
        "unsorted_segment_min", "unsorted_segment_prod",
        "unsorted_segment_sqrt_n", "unsorted_segment_sum"),
    "segment_bp": tuple(sorted(BP_SEGMENT)),
    "string_ops": (
        "compat_sparse_to_dense", "compat_string_split", "hashcode",
        "split_string"),
}

CASES = []


def case(op, inputs, kwargs=None, cid=None, **opts):
    CASES.append(pytest.param(op, inputs, kwargs or {}, opts,
                              id=cid or op))


def INT(*s):
    """int32 over the whole range (sign bits set half the time)."""
    return lambda r: r.randint(-2 ** 31, 2 ** 31 - 1, s,
                               dtype=np.int64).astype(np.int32)


def I8(*s, lo=-1, hi=2):
    return lambda r: r.randint(lo, hi, s).astype(np.int8)


def SPD(n, asym=0.0):
    """A well-conditioned symmetric positive-definite draw, plus
    ``asym`` times a non-symmetric one (cholesky / eigh / logdet
    symmetrise first)."""
    def f(r):
        a = r.randn(n, n)
        m = a @ a.T + n * np.eye(n) + asym * r.randn(n, n)
        return m.astype(np.float32)
    return f


def WELL(n):
    """A well-conditioned square draw (diagonally dominant)."""
    return lambda r: (r.randn(n, n) + 3 * np.eye(n)).astype(np.float32)


def TRI(n, lower=True):
    def f(r):
        a = r.randn(n, n) + 3 * np.eye(n)
        return (np.tril(a) if lower else np.triu(a)).astype(np.float32)
    return f


# -- bitwise --------------------------------------------------------------
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(_n, [INT(3, 4), INT(3, 4)], **EXACT)
case("toggle_bits", [INT(3, 4)], **EXACT)
case("shift_bits", [INT(3, 4), I(3, 4, lo=-2, hi=35)],
     cid="shift_bits-counts-past-the-width", **EXACT)
case("rshift_bits", [INT(3, 4), I(3, 4, lo=-2, hi=35)],
     cid="rshift_bits-counts-past-the-width", **EXACT)
for _n in ("shift_bits", "rshift_bits", "cyclic_shift_bits",
           "cyclic_rshift_bits"):
    # 0 and the width give x back for the cyclic shifts; 33 and -1 give
    # 0 (the sign for an arithmetic shift) in XLA
    for _s in (0, 1, 7, 31, 32, 33, -1):
        case(_n, [INT(3, 4), K(_s)], cid=f"{_n}-by-{_s}", **EXACT)
case("cyclic_shift_bits", [INT(3, 4), I(3, 4, lo=0, hi=33)],
     cid="cyclic_shift_bits-elementwise", **EXACT)
case("cyclic_rshift_bits", [I8(3, 4, lo=-128, hi=127), K(3, np.int8)],
     cid="cyclic_rshift_bits-int8", **EXACT)
# int32 result (lax.population_count, then a sum)
case("bits_hamming_distance", [INT(3, 4), INT(3, 4)], **EXACT)
case("bits_hamming_distance", [I8(5, lo=-128, hi=127),
                               I8(5, lo=-128, hi=127)],
     cid="bits_hamming_distance-int8", **EXACT)

# -- compression ----------------------------------------------------------
_UPD = lambda r: (2e-3 * r.randn(4, 5)).astype(np.float32)  # noqa: E731
case("encode_threshold", [_UPD], **F32)
case("encode_threshold", [_UPD], {"threshold": 2e-3},
     cid="encode_threshold-threshold", **F32)
case("encode_bitmap", [_UPD], **F32)
case("decode_threshold", [I8(4, 5)], **F32)
case("decode_threshold", [I8(4, 5)], {"threshold": 0.5, "dtype": "float16"},
     cid="decode_threshold-float16")
case("decode_bitmap", [I8(4, 5)], **F32)

# -- segment --------------------------------------------------------------
# ids 2 and 4 empty, a negative id and one past num_segments dropped
_IDS = K(np.asarray([0, 0, 1, 3, 3, -1, 5], np.int32))
_SORTED = K(np.asarray([0, 0, 1, 1, 1, 3, 4], np.int32))
for _r in ("sum", "max", "min", "prod", "mean"):
    # jax has no segment_prod gradient (scatter_mul's needs unique ids):
    # the port's is held by test_segment_prod_bp_against_a_dense_jax_product
    _g = _r != "prod"
    for _p in ("", "unsorted_"):
        case(f"{_p}segment_{_r}", [F(7, 3), _IDS], {"num_segments": 5},
             cid=f"{_p}segment_{_r}-dropped-and-empty", grad=_g, **SUM)
    case(f"segment_{_r}", [F(7), _SORTED], cid=f"segment_{_r}-num-from-ids",
         grad=_g, **SUM)
    case(f"segment_{_r}", [I(7, 2, lo=-9, hi=9), _IDS], {"num_segments": 5},
         cid=f"segment_{_r}-int32", **EXACT)
case("unsorted_segment_sqrt_n", [F(7, 3), _IDS], {"num_segments": 5},
     cid="unsorted_segment_sqrt_n-dropped-and-empty", **SUM)
case("unsorted_segment_sqrt_n", [F(7), _SORTED], **SUM)

# -- linear algebra ---------------------------------------------------------
case("cholesky", [SPD(4)], **FACTOR)
case("cholesky", [SPD(4, asym=0.3)], cid="cholesky-not-quite-symmetric",
     **FACTOR)
case("cholesky", [SPD(4, asym=0.3)], {"upper": True}, cid="cholesky-upper",
     **FACTOR)
# one triangle read: the two libraries' gradients differ in how they
# split between the triangles (their symmetric parts agree), so the
# forward alone is held
case("cholesky", [SPD(4, asym=0.3)], {"symmetrize_input": False},
     cid="cholesky-lower-triangle", grad=False, **FACTOR)
case("logdet", [SPD(4, asym=0.3)], cid="logdet-not-quite-symmetric",
     **FACTOR)
case("matrix_inverse", [WELL(4)], **SUM)
# no error where the factorisation fails: NaN and inf as XLA gives them
_INDEF = K(np.asarray([[1.0, 2.0], [2.0, 1.0]], np.float32))
_SING = K(np.asarray([[1.0, 2.0], [2.0, 4.0]], np.float32))
case("cholesky", [_INDEF], cid="cholesky-indefinite", grad=False)
case("cholesky", [_INDEF], {"upper": True}, cid="cholesky-indefinite-upper",
     grad=False)
case("logdet", [_INDEF], cid="logdet-indefinite", grad=False)
case("matrix_inverse", [_SING], cid="matrix_inverse-singular", grad=False)
case("solve", [_SING, K(np.ones((2, 1), np.float32))], cid="solve-singular",
     grad=False)
case("matrix_determinant", [WELL(4)], **SUM)
case("log_matrix_determinant", [F(4, 4)], **SUM)
case("lu", [F(5, 5)], **FACTOR)
case("solve", [WELL(4), F(4, 2)], **SUM)
case("solve", [WELL(4), F(4)], {"adjoint": True}, cid="solve-adjoint-vector",
     **SUM)
case("triangular_solve", [TRI(4), F(4, 3)], **SUM)
case("triangular_solve", [TRI(4, lower=False), F(4, 3)],
     {"lower": False, "adjoint": True}, cid="triangular_solve-upper-adjoint",
     **SUM)
# a full triangle in the unread half: only the named one is read
case("triangular_solve", [WELL(4), F(4, 2)], cid="triangular_solve-reads-one",
     **SUM)
case("lstsq", [F(6, 3), F(6, 2)], cid="lstsq-overdetermined", **FACTOR)
case("lstsq", [F(3, 5), F(3, 2)], cid="lstsq-underdetermined", **FACTOR)
case("solve_ls", [F(6, 3), F(6)], cid="solve_ls(alias)-vector", **FACTOR)
case("lstsq", [F(5, 3), F(5, 2)], {"l2_regularizer": 0.1},
     cid="lstsq-l2", **FACTOR)
case("sqrtm", [SPD(4)], **FACTOR)
case("cross_batched", [F(4, 3), F(4, 3)], **F32)
case("knn_mindistance", [F(5, 3), K(np.full(3, -0.5, np.float32)),
                         K(np.full(3, 0.5, np.float32))], **F32)

# -- parity tail ------------------------------------------------------------
# label 5 lands past n * n (dropped); label -1 counts from the end, as
# jax's .at[] does; prediction 3 with label 1 lands in-range
_LABELS = K(np.asarray([0, 1, 5, -1, 2, 1, 2], np.int32))
_PREDS = K(np.asarray([0, 2, 1, 0, 2, 3, 2], np.int32))
case("confusion_matrix", [_LABELS, _PREDS], {"num_classes": 3},
     cid="confusion_matrix-out-of-range", **EXACT)
case("confusion_matrix", [_LABELS, _PREDS, None, F(7)],
     cid="confusion_matrix-weights-num-from-data", **SUM)
_Q = lambda r: (1.5 * r.randn(4, 6)).astype(np.float32)  # noqa: E731
case("fake_quant_with_min_max_vars", [_Q, K(-1.0), K(1.0)], **F32)
# the exact half-integer zero point of [-1.5, 1.5] at 8 bits
case("fake_quant_with_min_max_vars", [_Q, K(-1.5), K(1.5)],
     {"num_bits": 8, "narrow_range": True}, cid="fake_quant-half-zero",
     **F32)
case("fake_quant_with_min_max_vars", [_Q, K(-0.3), K(2.1)],
     {"num_bits": 4}, cid="fake_quant-4-bits", **F32)
case("fake_quant_with_min_max_vars_per_channel",
     [_Q, lambda r: -r.uniform(0.5, 2, 6).astype(np.float32),
      lambda r: r.uniform(0.5, 2, 6).astype(np.float32)], **F32)
case("compare_and_bitpack", [F(3, 16), K(0.25)], **EXACT)
case("create_view", [F(3, 4)], **EXACT)
case("norm", [F(3, 4)], **SUM)
case("norm", [F(3, 4)], {"mode": 1, "dims": [1], "keep_dims": True},
     cid="norm-max-dims", **F32)
case("norm", [F(3, 4)], {"mode": 2, "dims": [0]}, cid="norm-1-dims", **SUM)
for _d in ("float32", "float16", "int8", "uint8", "int16", "int32",
           "uint32", "float64"):
    for _m in (0, 1):
        case("min_max_datatype", [K(_d), K(_m)],
             cid=f"min_max_datatype-{_d}-{_m}", **EXACT)
case("deconv2d_tf", [K(np.asarray([2, 8, 8, 3], np.int32)), F(3, 3, 3, 4),
                     F(2, 4, 4, 4)], {"strides": (2, 2)}, **SUM)
case("conv2d_input_bp", [K(np.asarray([2, 3, 6, 6], np.int32)),
                         F(3, 3, 3, 4), F(2, 4, 6, 6)], **SUM)
case("conv2d_input_bp", [K(np.asarray([2, 3, 7, 6], np.int32)),
                         F(3, 2, 3, 4), F(2, 4, 3, 2)],
     {"strides": (2, 2), "padding": "VALID", "dilation": (1, 2)},
     cid="conv2d_input_bp-strided-valid", **SUM)
case("ctc_beam", [F(2, 6, 4), K(np.asarray([6, 4], np.int32))],
     {"beam_width": 3, "top_paths": 2}, **F32)
case("ctc_beam", [F(5, 3)], {"blank_index": 2}, cid="ctc_beam-2d-blank",
     **F32)
case("barnes_symmetrized", [K(np.asarray([0, 2, 3, 5], np.int32)),
                            K(np.asarray([1, 2, 0, 0, 1], np.int32)),
                            P(5)], **F32)
case("barnes_edge_forces", [P(5, 5), F(5, 2)], **SUM)
case("barnes_gains", [P(4, 3), F(4, 3), F(4, 3)], **F32)
case("cell_contains", [F(2), P(2), F(6, 2)], **EXACT)

# -- the keyword repairs ------------------------------------------------------
case("gelu", [F(3, 4)], {"approximate": False}, cid="gelu-erf", **F32)
case("gelu", [F(3, 4)], {"approximate": True}, cid="gelu-tanh", **F32)
case("cross", [F(3, 5), F(3, 5)], {"axis": 0}, cid="cross-axis0", **F32)
case("cross", [F(4, 3, 2), F(3, 2)], {"axisa": 1, "axisb": 0, "axisc": 0},
     cid="cross-axisa-axisb-axisc", **F32)
case("cross", [F(4, 2), F(4, 3)], cid="cross-2-by-3", **F32)
case("cross", [F(4, 2), F(4, 2)], cid="cross-2-by-2", **F32)

# -- ops of earlier slices that took no array where jax takes one (found
# by the sweep, whose candidates pass arrays there) --------------------------
case("polygamma", [I(3, 4, lo=0, hi=4), P(3, 4)], cid="polygamma-int-array",
     **dict(atol=1e-5, rtol=1e-5))
case("fill_as", [F(3, 4), F(4)], cid="fill_as-array", **F32)
case("fill_as", [F(3, 4), K(2.5)], cid="fill_as-scalar", **F32)
case("nth_element", [F(3, 6), K([1, 4])], cid="nth_element-list", **F32)
case("cast", [F(3, 4), I(2, 2)], cid="cast-to-an-arrays-dtype", **F32)
case("bitcast", [F(3, 4), I(2, 2)], cid="bitcast-to-an-arrays-dtype",
     **EXACT)
case("min_max_datatype", [I8(3)], cid="min_max_datatype-of-an-array",
     **EXACT)


@pytest.mark.parametrize("op_name,inputs,kwargs,opts", CASES)
def test_tail_op_matches_jax(op_name, inputs, kwargs, opts):
    _op_matches(op_name, inputs, kwargs, opts)


# -- the segment bp ops --------------------------------------------------------

def _segment_bp_cases():
    out = []
    for name in sorted(BP_SEGMENT):
        base = name[:-3]
        if base.endswith("_prod"):
            continue   # the JAX bp raises; held by the test below
        out.append(pytest.param(name, base, [F(7, 3), _IDS],
                                {"num_segments": 5}, SUM, id=name))
    return out


SEGMENT_BP_CASES = _segment_bp_cases()


@pytest.mark.parametrize("name,base,inputs,kwargs,opts", SEGMENT_BP_CASES)
def test_segment_bp_op_matches_jax(name, base, inputs, kwargs, opts):
    _bp_matches(name, base, inputs, kwargs, opts)


@pytest.mark.parametrize("name", ["segment_prod_bp",
                                  "unsorted_segment_prod_bp"])
def test_segment_prod_bp_against_a_dense_jax_product(name):
    """The JAX ``segment_prod_bp`` raises (``scatter_mul`` has no
    gradient without unique indices); the port's is held against
    ``jax.vjp`` of the same product written densely."""
    r = np.random.RandomState(0)
    data = r.uniform(0.5, 2.0, (7, 3)).astype(np.float32)
    ids = np.asarray([0, 0, 1, 3, 3, -1, 5], np.int32)
    g = r.randn(5, 3).astype(np.float32)
    with pytest.raises(NotImplementedError):
        jexec(name, jnp.asarray(data), jnp.asarray(ids), jnp.asarray(g),
              num_segments=5)
    member = jnp.asarray(ids[None, :] == np.arange(5)[:, None])

    def dense(d):
        return jnp.prod(jnp.where(member[:, :, None], d[None], 1.0), axis=1)

    _, vjp = jax.vjp(dense, jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))
    got, gids = texec(name, torch.from_numpy(data), torch.from_numpy(ids),
                      torch.from_numpy(g), num_segments=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM)
    assert gids.dtype == torch.int32 and not gids.any()


def test_segment_mean_of_bfloat16_is_float32():
    r = np.random.RandomState(1)
    x = r.randn(6, 2).astype(np.float32)
    ids = np.asarray([0, 1, 1, 2, 2, 2], np.int32)
    for name in ("segment_mean", "unsorted_segment_sqrt_n"):
        j = jexec(name, jnp.asarray(x, jnp.bfloat16), jnp.asarray(ids),
                  num_segments=4)
        t = texec(name, torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(ids), num_segments=4)
        assert str(j.dtype) == "float32" and t.dtype == torch.float32
        # the sums are bfloat16 (8 significant bits), added in another order
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-2,
                                   rtol=1e-2)


def test_encode_threshold_keeps_the_update_dtype():
    x = (2e-3 * np.random.RandomState(2).randn(4, 5)).astype(np.float32)
    jr, je = jexec("encode_threshold", jnp.asarray(x, jnp.bfloat16))
    tr, te = texec("encode_threshold", torch.from_numpy(x).to(torch.bfloat16))
    assert tr.dtype == torch.bfloat16 and te.dtype == torch.int8
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tr.float().numpy(),
                                  np.asarray(jr, np.float32))


# -- factors held by invariants ------------------------------------------------

def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def test_qr_by_reconstruction():
    r = np.random.RandomState(3)
    for shape, full in (((5, 3), False), ((5, 3), True), ((3, 5), False)):
        a = r.randn(*shape).astype(np.float32)
        ja, ta = _pair(a)
        jq, jr = jexec("qr", ja, full_matrices=full)
        tq, tr = texec("qr", ta, full_matrices=full)
        assert tq.shape == jq.shape and tr.shape == jr.shape
        assert tq.dtype == torch.float32 and tr.dtype == torch.float32
        np.testing.assert_allclose((tq @ tr).numpy(), a, **SUM)
        k = tq.shape[-1]
        np.testing.assert_allclose((tq.T @ tq).numpy(), np.eye(k), **SUM)
        np.testing.assert_array_equal(np.tril(tr.numpy(), -1), 0)
        # R is unique up to the sign of each row
        np.testing.assert_allclose(np.abs(tr.numpy()), np.abs(np.asarray(jr)),
                                   **SUM)
    # the gradient of a sign-free function of R
    w = r.randn(3, 3).astype(np.float32)
    a = r.randn(5, 3).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jnp.abs(jexec("qr", x)[1]) * w))(
        jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        torch.sum(torch.abs(texec("qr", ta)[1]) * torch.from_numpy(w)), ta)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **FACTOR)


def test_svd_by_reconstruction_and_singular_values():
    r = np.random.RandomState(4)
    for shape, full in (((5, 3), False), ((3, 5), True), ((4, 4), False)):
        a = r.randn(*shape).astype(np.float32)
        ja, ta = _pair(a)
        ju, js, jvh = jexec("svd", ja, full_matrices=full)
        tu, ts, tvh = texec("svd", ta, full_matrices=full)
        assert (tu.shape, ts.shape, tvh.shape) == (ju.shape, js.shape,
                                                   jvh.shape)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FACTOR)
        k = ts.shape[0]
        rec = (tu[:, :k] * ts) @ tvh[:k]
        np.testing.assert_allclose(rec.numpy(), a, **SUM)
        np.testing.assert_allclose((tu.T @ tu).numpy(),
                                   np.eye(tu.shape[1]), **SUM)
    s_only = texec("svd", ta, compute_uv=False)
    np.testing.assert_allclose(s_only.numpy(),
                               np.asarray(jexec("svd", ja, compute_uv=False)),
                               **FACTOR)
    w = r.randn(4).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jexec("svd", x)[1] * w))(ja)
    ta = ta.clone().requires_grad_(True)
    (tg,) = torch.autograd.grad(
        torch.sum(texec("svd", ta)[1] * torch.from_numpy(w)), ta)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **FACTOR)


def test_self_adjoint_eig_of_a_not_quite_symmetric_input():
    """Eigenvalues against JAX's (both from ``(a + aᵀ)/2``), eigenvectors
    up to each column's sign, and ``A v = v w`` on the symmetrised A."""
    r = np.random.RandomState(5)
    a = SPD(4, asym=0.3)(r)
    sym = (a + a.T) / 2
    ja, ta = _pair(a)
    for kw in ({}, {"UPLO": "U"}):
        jw, jv = jexec("self_adjoint_eig", ja, **kw)
        tw, tv = texec("self_adjoint_eig", ta, **kw)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **FACTOR)
        sign = np.sign(np.sum(tv.numpy() * np.asarray(jv), axis=0))
        np.testing.assert_allclose(tv.numpy() * sign, np.asarray(jv),
                                   **FACTOR)
        np.testing.assert_allclose(sym @ tv.numpy(), tv.numpy() * tw.numpy(),
                                   **FACTOR)
    # torch alone reads one triangle: without symmetrising it differs
    tw0 = torch.linalg.eigvalsh(ta)
    assert np.abs(tw0.numpy() - np.asarray(jw)).max() > 1e-3
    w = r.randn(4).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jexec("self_adjoint_eig", x)[0] * w))(ja)
    ta = ta.clone().requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.sum(
        texec("self_adjoint_eig", ta)[0] * torch.from_numpy(w)), ta)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **FACTOR)


def test_eig_by_invariants():
    r = np.random.RandomState(6)
    a = r.randn(5, 5).astype(np.float32)
    ja, ta = _pair(a)
    jw, jv = jexec("eig", ja)
    tw, tv = texec("eig", ta)
    assert tw.dtype == torch.complex64 and tv.dtype == torch.complex64
    assert str(jw.dtype) == "complex64" and tw.shape == jw.shape
    # the same eigenvalues as a set
    key = lambda w: np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))  # noqa: E731,E501
    tn, jn = tw.numpy(), np.asarray(jw)
    np.testing.assert_allclose(tn[key(tn)], jn[key(jn)], **FACTOR)
    # A v = v diag(w), unit columns
    vn = tv.numpy()
    np.testing.assert_allclose(a.astype(np.complex64) @ vn, vn * tn,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(vn, axis=0), 1.0, **FACTOR)


def test_lu_reconstructs_the_permuted_input():
    r = np.random.RandomState(7)
    for shape in ((5, 5), (4, 6), (6, 4)):
        a = r.randn(*shape).astype(np.float32)
        tlu, perm = texec("lu", torch.from_numpy(a))
        jlu, jperm = jexec("lu", jnp.asarray(a))
        assert perm.dtype == torch.int32
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        m, n = shape
        k = min(m, n)
        lu = tlu.numpy()
        low = np.tril(lu, -1)[:, :k] + np.eye(m, k)
        up = np.triu(lu)[:k]
        np.testing.assert_allclose(a[perm.numpy()], low @ up, **SUM)
        np.testing.assert_allclose(lu, np.asarray(jlu), **FACTOR)


def test_lstsq_rank_deficient_is_the_minimum_norm_solution():
    """Two columns repeat others: the SVD cuts their singular values, and
    both packages give the pseudo-inverse's solution."""
    r = np.random.RandomState(8)
    base = r.randn(6, 2)
    a = np.concatenate([base, base, base[:, :1]], axis=1).astype(np.float32)
    b = r.randn(6, 2).astype(np.float32)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    want = np.asarray(jexec("lstsq", ja, jb))
    got = texec("lstsq", ta, tb).numpy()
    np.testing.assert_allclose(got, want, **FACTOR)
    np.testing.assert_allclose(got, np.linalg.pinv(a.astype(np.float64))
                               @ b, atol=1e-4, rtol=1e-4)


# -- host and structural ops ---------------------------------------------------

def test_assert_raises_or_returns_true():
    ok = np.asarray([True, True])
    assert bool(jexec("Assert", jnp.asarray(ok))) is True
    t = texec("Assert", torch.from_numpy(ok), torch.ones(2))
    assert t.dtype == torch.bool and bool(t)
    for run in (lambda: jexec("Assert", jnp.asarray([True, False]),
                              message="bad"),
                lambda: texec("Assert", torch.tensor([True, False]),
                              message="bad")):
        with pytest.raises(AssertionError, match="bad"):
            run()


def test_print_variable_prints_and_returns(capsys):
    x = np.asarray([1.0, 2.5, -3.0], np.float32)
    out = texec("print_variable", torch.from_numpy(x), message="x=")
    np.testing.assert_array_equal(out.numpy(), x)
    jax_out = jexec("print_variable", jnp.asarray(x), message="x=")
    jax.effects_barrier()
    printed = capsys.readouterr().out.splitlines()
    np.testing.assert_array_equal(np.asarray(jax_out), x)
    assert printed == ["x=[ 1.   2.5 -3. ]", "x=[ 1.   2.5 -3. ]"]


def test_min_max_datatype_of_a_64_bit_int_overflows_on_both():
    for d in ("int64", "uint64"):
        for side in (jexec, texec):
            with pytest.raises(OverflowError):
                side("min_max_datatype", d, 0 if d == "int64" else 1)


def test_broadcastgradientargs_is_host_int64():
    for sa, sb in (((2, 1, 3), (4, 3)), ((5,), (1, 5)), ((2, 3), (2, 3))):
        jr = jexec("broadcastgradientargs", np.asarray(sa), np.asarray(sb))
        tr = texec("broadcastgradientargs", torch.tensor(sa),
                   torch.tensor(sb))
        for j, t in zip(jr, tr):
            assert isinstance(t, np.ndarray) and t.dtype == np.int64
            np.testing.assert_array_equal(t, j)


_STRINGS = np.asarray([["a b  c", "hello world"], ["", "x,y z"]], object)


def _same_host(j, t):
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert isinstance(b, np.ndarray) and b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("delimiter", [" ", ",", None])
def test_string_split_ops_on_object_arrays(delimiter):
    for name in ("split_string", "compat_string_split"):
        _same_host(jexec(name, _STRINGS, delimiter=delimiter),
                   texec(name, _STRINGS, delimiter=delimiter))


def test_compat_sparse_to_dense_strings_and_numbers():
    idx = np.asarray([[0, 1], [2, 0]], np.int64)
    _same_host(jexec("compat_sparse_to_dense", idx, [3, 2],
                     np.asarray(["p", "q"], object), "-"),
               texec("compat_sparse_to_dense", torch.from_numpy(idx),
                     torch.tensor([3, 2]), np.asarray(["p", "q"], object),
                     "-"))
    vals = np.asarray([1.5, -2.0], np.float32)
    _same_host(jexec("compat_sparse_to_dense", jnp.asarray(idx), [3, 2],
                     jnp.asarray(vals), 7.0),
               texec("compat_sparse_to_dense", torch.from_numpy(idx), [3, 2],
                     torch.from_numpy(vals), 7.0))


def test_hashcode_of_numbers_and_strings():
    r = np.random.RandomState(9)
    for x in (r.randn(3, 4).astype(np.float32),
              r.randint(-50, 50, (7,)).astype(np.int32),
              np.asarray([True, False])):
        j = jexec("hashcode", jnp.asarray(x))
        t = texec("hashcode", torch.from_numpy(x))
        assert isinstance(t, np.int64) and t == j
    s = np.asarray(["ab", "cd"], object)
    assert texec("hashcode", s) == jexec("hashcode", s)


_HASH = """
import numpy as np
from deeplearning4j_tpu.ops.registry import exec_op as jexec
from deeplearning4j_tpu_torch.ops import exec_op as texec
for run in (jexec, texec):
    print(int(run("hashcode", np.asarray(["ab", "cd"], object))),
          int(run("hashcode", np.arange(4, dtype=np.int32))))
"""


def test_hashcode_of_strings_follows_the_salted_hash_on_both_sides():
    """The reference fault kept alike: a string array's "deterministic"
    hash uses Python's salted ``hash()``, so it changes with
    ``PYTHONHASHSEED``; a numeric array's does not. One interpreter a
    seed runs both packages; the two run side by side."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {seed: subprocess.Popen(
        [sys.executable, "-c", _HASH], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=root,
                 JAX_PLATFORMS="cpu")) for seed in ("1", "2")}
    got = {}
    for seed, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        jax_line, torch_line = out.splitlines()[-2:]
        got["jax", seed] = tuple(int(v) for v in jax_line.split())
        got["torch", seed] = tuple(int(v) for v in torch_line.split())
    assert got["jax", "1"] == got["torch", "1"]
    assert got["jax", "2"] == got["torch", "2"]
    assert got["torch", "1"][0] != got["torch", "2"][0]
    assert got["torch", "1"][1] == got["torch", "2"][1]


def _lists(x, mk):
    if isinstance(x, np.ndarray):
        return mk(x)
    if isinstance(x, (list, tuple)):
        return tuple(_lists(v, mk) for v in x)
    return x


def _lst(n, *shape):
    return lambda r: [r.randn(*shape).astype(np.float32) for _ in range(n)]


LIST_CASES = [
    ("create_list", [], {}),
    ("write_list", [_lst(3, 2, 2), F(2, 2), K(1)], {}),
    ("write_list", [_lst(2, 2, 2), F(2, 2), K(4)], {}),
    ("read_list", [_lst(3, 4), K(2)], {}),
    ("pick_list", [_lst(4, 3), K(2), K(0)], {}),
    ("pick_list", [_lst(4, 3), K([3, 1])], {}),
    ("size_list", [_lst(3, 2)], {}),
    ("scatter_list", [_lst(2, 3), K([0, 3]), F(2, 3)], {}),
    ("gather_list", [_lst(4, 2), K([3, 0, 3])], {}),
    ("stack_list", [_lst(3, 2, 2)], {}),
    ("unstack_list", [F(2, 3, 4)], {"axis": 1}),
    ("split_list", [F(6, 2), K([1, 3, 2])], {}),
    ("clone_list", [_lst(2, 3)], {}),
    ("delete_list", [_lst(2, 3)], {}),
]


@pytest.mark.parametrize("name,inputs,kwargs", LIST_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LIST_CASES)])
def test_list_op_tuples_match_jax(name, inputs, kwargs):
    arrays = _draw(inputs, seed=len(name))
    jout = jexec(name, *[_lists(a, jnp.asarray) for a in arrays], **kwargs)
    tout = texec(name, *[_lists(a, lambda v: torch.from_numpy(np.array(v)))
                         for a in arrays], **kwargs)
    assert isinstance(tout, tuple) == isinstance(jout, tuple)
    _compare(jout, tout, EXACT)


# -- the keyword repairs -------------------------------------------------------

@pytest.mark.parametrize("name", ["selu", "hardsigmoid", "swish", "mish",
                                  "hardswish"])
def test_activation_ignores_no_inplace_and_leaves_its_input(name):
    """The activations are functions of ``x`` alone, as jax.nn's: an
    ``inplace=`` no longer reaches torch, so it raises and the caller's
    tensor stays as it was."""
    x = np.random.RandomState(10).randn(3, 4).astype(np.float32)
    t = torch.from_numpy(x.copy())
    with pytest.raises(TypeError):
        texec(name, t, inplace=True)
    np.testing.assert_array_equal(t.numpy(), x)
    with pytest.raises(TypeError):
        jexec(name, jnp.asarray(x), inplace=True)
    out = texec(name, t)
    np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jexec(name,
                                                             jnp.asarray(x))),
                               **F32)


# -- accounting ------------------------------------------------------------------

def test_every_tail_name_is_registered_and_held():
    names = [n for ns in TAIL.values() for n in ns]
    assert len(names) == len(set(names)) == 85
    assert all(TREG.has(n) for n in names)
    held = ({p.values[0] for p in CASES} | {c[0] for c in LIST_CASES}
            | {p.values[0] for p in SEGMENT_BP_CASES}
            | {"segment_prod_bp", "unsorted_segment_prod_bp", "qr", "svd",
               "self_adjoint_eig", "eig", "Assert", "print_variable",
               "broadcastgradientargs", "split_string", "compat_string_split",
               "compat_sparse_to_dense", "hashcode"})
    assert set(names) - held == set()
