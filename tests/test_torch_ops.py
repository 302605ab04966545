"""The port's op registry and op families (``deeplearning4j_tpu_torch/ops``)
against the JAX package's, op by op, on the same numpy inputs.

Registry accounting: every name the JAX ``OpRegistry`` registers is
registered in the port with the same category, ``differentiable`` flag
and aliases, and the port registers nothing else. Of the reference
inventory's 517 names (``all_reference_ops()``), both packages register
510; the other 7 are names neither registers. The convolution and image
families are held op by op in ``test_torch_conv_image_ops.py``, the
bitwise, compression, segment, string, list and linear-algebra
decomposition families and the parity tail in ``test_torch_op_tail.py``.

Each ported op that is not random runs through ``exec_op`` on both
sides (JAX on the CPU, the port with CPU tensors) from one
``np.random.RandomState`` draw. Tolerances, each with its reason:
- f32 results: atol 1e-6 plus rtol 1e-6 (``F32``): the same formula, an
  ulp or two apart where PyTorch's and XLA's elementwise kernels round
  differently; special functions (lgamma, digamma, polygamma, zeta, the
  incomplete gamma and beta functions, ``erfc``) use other series than
  XLA's and are held to 1e-5 (``SPECIAL``); sums over a few dozen
  elements and products (reductions, attention, convolutions, matmuls,
  losses) to 1e-5 (``SUM``).
- result dtypes must match exactly (int32 indices, counts and shapes;
  the 64-bit casts narrowed as JAX narrows them).
- gradients of differentiable ops: the port's autograd against
  ``jax.grad`` of the same weighted sum of the first output, atol 1e-5
  plus rtol 1e-5 (``GRAD``; 1e-4 for the special functions); the
  ``_bp`` ops of ``autobp`` against the JAX ``_bp`` ops likewise.
Random ops cannot match ``jax.random``'s streams: they are held to
shapes, dtypes, moments and same-seed determinism.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.reference_inventory import all_reference_ops
from deeplearning4j_tpu.ops.registry import OpRegistry as JReg
from deeplearning4j_tpu.ops.registry import exec_op as jexec

import deeplearning4j_tpu_torch.ops as tops
from deeplearning4j_tpu_torch.ops import exec_op as texec

F32 = dict(atol=1e-6, rtol=1e-6)
SUM = dict(atol=1e-5, rtol=1e-5)
SPECIAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-5)
GRAD_SPECIAL = dict(atol=1e-4, rtol=1e-4)

TREG = tops.registry()


# -- registry accounting --------------------------------------------------

def _jax_names():
    reg = JReg.get()
    return sorted(set(reg._ops))


def test_every_jax_op_registered_with_its_metadata():
    """Every JAX name (aliases included) is registered with the same
    name, category, differentiability and aliases; nothing else is; an
    unknown name raises ``KeyError``."""
    jreg = JReg.get()
    assert set(TREG._ops) == set(jreg._ops)
    mismatched = []
    for name in _jax_names():
        j, t = jreg.lookup(name), TREG.lookup(name)
        if (j.name, j.category, j.differentiable, tuple(j.aliases)) != \
                (t.name, t.category, t.differentiable, tuple(t.aliases)):
            mismatched.append((name, (j.category, j.differentiable,
                                      j.aliases),
                               (t.category, t.differentiable, t.aliases)))
    assert not mismatched, mismatched
    assert TREG.names() == jreg.names()
    with pytest.raises(KeyError, match="unknown op"):
        TREG.lookup("no_such_op")
    with pytest.raises(KeyError, match="unknown op"):
        texec("no_such_op")
    assert not TREG.has("no_such_op")


def test_reference_coverage_as_stated():
    names = all_reference_ops()
    registered = [n for n in names if TREG.has(n)]
    jax_has = [n for n in names if JReg.get().has(n)]
    assert registered == jax_has
    assert (len(names), len(registered), len(TREG), len(TREG._ops)) == \
        (517, 510, 561, 610)


# -- input makers -----------------------------------------------------------

def F(*s):
    return lambda r: r.randn(*s).astype(np.float32)


def P(*s, lo=0.5, hi=2.0):
    return lambda r: r.uniform(lo, hi, s).astype(np.float32)


def U(*s):
    return lambda r: r.uniform(-0.9, 0.9, s).astype(np.float32)


def I(*s, lo=0, hi=5):
    return lambda r: r.randint(lo, hi, s).astype(np.int32)


def B(*s):
    return lambda r: r.rand(*s) > 0.5


def K(v, dt=None):
    """A constant: a Python value as it is, or an array of ``dt``."""
    if dt is None:
        return lambda r: v
    return lambda r: np.asarray(v, dt)


def NZ(*s):
    """Floats away from 0 (divisors)."""
    def f(r):
        a = r.uniform(0.5, 2.0, s) * r.choice([-1, 1], s)
        return a.astype(np.float32)
    return f


# name or case id -> (op, input makers, kwargs, options)
CASES = []


def case(op, inputs, kwargs=None, cid=None, **opts):
    CASES.append(pytest.param(op, inputs, kwargs or {}, opts,
                              id=cid or op))


for _n in ["abs", "neg", "exp", "expm1", "square", "cube", "sign", "Floor",
           "ceil", "rint", "round", "sin", "cos", "atan", "sinh", "cosh",
           "tanh", "asinh", "erf", "isnan", "isinf", "isfinite", "sigmoid",
           "relu", "lrelu", "elu", "selu", "gelu", "softplus", "softsign",
           "hardsigmoid", "swish", "mish", "hardswish", "thresholdedrelu",
           "rationaltanh", "rectifiedtanh", "crelu", "identity", "ones_as",
           "zeros_as", "stop_gradient", "noop", "standardize",
           "is_numeric_tensor", "check_numerics", "ismax", "zero_fraction"]:
    case(_n, [F(3, 4)])
case("floor", [F(3, 4)], cid="floor(alias)")
case("log1p", [P(3, 4)], cid="log1p(alias)")
for _n in ["log", "Log1p", "log2", "sqrt", "rsqrt", "reciprocal"]:
    case(_n, [P(3, 4)])
case("erfc", [F(3, 4)], **SPECIAL)
case("lgamma", [P(3, 4)], **SPECIAL)
case("digamma", [P(3, 4)], **SPECIAL)
for _n in ["tan", "asin", "acos", "atanh"]:
    case(_n, [U(3, 4)])
case("acosh", [P(3, 4, lo=1.1, hi=3.0)])
case("tf_atan2", [F(3, 4), F(3, 4)])
case("atan2", [F(3, 4), F(3, 4)], cid="atan2(alias)")
case("polygamma", [K(1), P(3, 4)], grad_args=[1], **SPECIAL)
case("zeta", [P(3, 4, lo=1.5, hi=3.0), P(3, 4)], grad=False, **SPECIAL)
case("betainc", [P(3, 4), P(3, 4), P(3, 4, lo=0.05, hi=0.95)], grad=False,
     **SPECIAL)
case("igamma", [P(3, 4), P(3, 4)], grad_args=[1], **SPECIAL)
case("igammac", [P(3, 4), P(3, 4)], grad_args=[1], **SPECIAL)
case("relu", [F(3, 4)], {"cutoff": 0.3}, cid="relu-cutoff")
case("relu6", [lambda r: (4 * r.randn(3, 4)).astype(np.float32)])
case("hardtanh", [lambda r: (2 * r.randn(3, 4)).astype(np.float32)])
case("lrelu", [F(3, 4)], {"alpha": 0.2}, cid="lrelu-alpha")
case("elu", [F(3, 4)], {"alpha": 0.5}, cid="elu-alpha")
case("thresholdedrelu", [F(3, 4)], {"theta": 0.2}, cid="thresholdedrelu-theta")
case("prelu", [F(3, 4), P(4)])
case("cast", [F(3, 4)], {"dtype": "int32"})
case("cast", [I(3, 4)], {"dtype": "float32"}, cid="cast-int-float")
for _n in ["to_double", "to_float32", "to_float16", "to_int32", "to_int64",
           "to_uint32", "to_uint64"]:
    case(_n, [P(3, 4, lo=0.5, hi=9.0)], grad=False)
case("fill_as", [F(3, 4), K(2.5)])
case("clipbyvalue", [F(3, 4), K(-0.5, np.float32), K(0.5, np.float32)])
case("clip_by_value", [F(3, 4), K(-0.5, np.float32), K(0.5, np.float32)],
     cid="clip_by_value(alias)")
case("clipbynorm", [F(3, 4), K(1.0, np.float32)])
case("clipbynorm", [F(3, 4), K(1.0, np.float32)], {"axis": 1},
     cid="clipbynorm-axis")
case("clipbyavgnorm", [F(3, 4), K(0.5, np.float32)])
case("standardize", [F(3, 4)], {"axis": 0}, cid="standardize-axis0")
case("cumsum", [F(3, 4)], {"axis": 1})
case("cumsum", [F(3, 4)], cid="cumsum-flat")
case("cumsum", [F(3, 4)], {"axis": 1, "exclusive": True, "reverse": True},
     cid="cumsum-exclusive-reverse")
case("cumprod", [P(3, 4)], {"axis": 1, "exclusive": True}, **SUM)
case("cumprod", [P(3, 4)], {"axis": 0, "reverse": True}, cid="cumprod-rev",
     **SUM)
case("is_non_decreasing", [K([1.0, 2.0, 2.0, 3.0], np.float32)])
case("is_strictly_increasing", [K([1.0, 2.0, 2.0, 3.0], np.float32)])
case("is_strictly_increasing", [K([1.0, 2.0, 3.0], np.float32)],
     cid="is_strictly_increasing-true")
case("ismax", [F(3, 4)], {"axis": 1}, cid="ismax-axis")
case("zero_fraction", [K([[0.0, 1.0], [0.0, 0.0]], np.float32)],
     cid="zero_fraction-zeros")
case("axpy", [F(3, 4), F(3, 4)], {"alpha": 2.0})
case("choose", [F(3, 4), K(4), K(0.0, np.float32)])

# -- pairwise --------------------------------------------------------------
for _n in ["add", "subtract", "multiply", "maximum", "minimum",
           "squaredsubtract", "reversesubtract", "sub", "mul",
           "mergeadd", "mergeavg", "mergemax", "accumulate", "rsub"]:
    case(_n, [F(3, 4), F(3, 4)])
for _n in ["divide", "realdiv", "truncatediv", "floordiv", "mod",
           "floormod", "reversedivide", "reversemod", "div", "rdiv"]:
    case(_n, [F(3, 4), NZ(3, 4)], **F32)
for _n in ["floordiv", "mod", "floormod", "truncatediv", "divide"]:
    case(_n, [I(3, 4, lo=-7, hi=7), K([[3, -2, 5, -4]] * 3, np.int32)],
         cid=f"{_n}-int", grad=False)
case("add", [F(3, 4), F(4)], cid="add-broadcast")
case("add", [I(3, 4), I(3, 4)], cid="add-int")
case("Pow", [P(3, 4), F(3, 4)])
case("pow", [P(3, 4), K(2.0, np.float32)], cid="pow(alias)")
case("cross", [F(4, 3), F(4, 3)])
case("divide_no_nan", [F(3, 4), K([[0.0, 1.0, 2.0, 0.0]] * 3, np.float32)])
for _n in ["equals", "not_equals", "greater", "greater_equal", "less",
           "less_equal"]:
    case(_n, [I(3, 4), I(3, 4)])
for _n in ["eq_scalar", "neq_scalar", "gt_scalar", "gte_scalar",
           "lt_scalar", "lte_scalar"]:
    case(_n, [I(3, 4), K(2, np.int32)])
for _n in ["boolean_and", "boolean_or", "boolean_xor"]:
    case(_n, [B(3, 4), B(3, 4)])
case("boolean_not", [B(3, 4)])
case("select", [B(3, 4), F(3, 4), F(3, 4)])
case("Where", [B(3, 4)])
case("Where", [B(3, 4), F(3, 4), F(3, 4)], cid="Where-select")
case("where_np", [B(3, 4)], cid="where_np(alias)")
case("mergemaxindex", [F(3, 4), F(3, 4), F(3, 4)])

# -- reductions -------------------------------------------------------------
for _n in ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_norm1", "reduce_norm2", "reduce_sqnorm",
           "reduce_norm_max", "reduce_logsumexp", "amax", "amin", "amean",
           "reduce_stdev", "reduce_variance"]:
    case(_n, [F(3, 4)], **SUM)
    case(_n, [F(2, 3, 4)], {"dims": [0, 2], "keep_dims": True},
         cid=f"{_n}-dims-keep", **SUM)
case("reduce_prod", [P(3, 4)], {"dims": 1}, **SUM)
case("reduce_prod", [P(2, 3, 2)], {"dims": [0, 2]}, cid="reduce_prod-dims",
     **SUM)
case("reduce_sum", [I(3, 4)], {"dims": 1}, cid="reduce_sum-int")
case("reduce_mean", [I(3, 4)], cid="reduce_mean-int")
case("reduce_stdev", [F(3, 4)], {"dims": 1, "bias_corrected": False},
     cid="reduce_stdev-ddof0", **SUM)
case("reduce_variance", [F(3, 4)], {"dims": 0, "bias_corrected": False},
     cid="reduce_variance-ddof0", **SUM)
case("reduce_any", [B(3, 4)], {"dims": 1})
case("reduce_all", [B(3, 4)])
case("countNonZero", [I(3, 4, hi=2)], {"dims": 0})
case("countZero", [I(3, 4, hi=2)])
case("reduce_dot", [F(3, 4), F(3, 4)], {"dims": 1}, **SUM)
case("moments", [F(3, 4)], {"dims": [0]}, **SUM)
case("normalize_moments", [K(4.0, np.float32), F(3), P(3)])
case("sufficient_statistics", [F(3, 4)], {"dims": [0]}, **SUM)
case("sufficient_statistics", [F(3, 4)], {"dims": [1], "shift": 0.5},
     cid="sufficient_statistics-shift", **SUM)
case("argmax", [F(3, 4)], {"dims": 1})
case("argmax", [F(3, 4)], cid="argmax-flat")
case("argmax", [F(3, 4)], {"dims": 0, "keep_dims": True},
     cid="argmax-keep")
case("argamax", [F(3, 4)], {"dims": 1}, cid="argamax(alias)")
case("argmin", [F(3, 4)], {"dims": 1})
case("argamin", [F(3, 4)], cid="argamin(alias)")
case("top_k", [F(3, 6), K(2)])
case("in_top_k", [F(4, 6), I(4, hi=6), K(2)])
case("nth_element", [F(3, 6), K(2)])
case("nth_element", [F(3, 6), K(1)], {"reverse": True},
     cid="nth_element-reverse")
case("percentile", [F(3, 8), K(30.0)], {"dims": 1}, **SUM)
case("percentile", [F(3, 8), K(50.0)], cid="percentile-all", **SUM)
case("bincount", [I(10, hi=6)], {"minlength": 6})
case("bincount", [I(10, hi=6), P(10)], {"maxlength": 4},
     cid="bincount-weights-maxlength", **SUM)
case("histogram", [F(20), K(5)])
case("histogram_fixed_width", [F(20), K([-1.0, 1.0], np.float32)],
     {"nbins": 5})
for _n in ["cosine_similarity", "cosine_distance", "euclidean_distance",
           "manhattan_distance", "dot"]:
    case(_n, [F(3, 4), F(3, 4)], {"dims": 1}, **SUM)
case("dot", [F(3, 4), F(3, 4)], cid="dot-all", **SUM)
case("jaccard_distance", [P(3, 4), P(3, 4)], {"dims": 1}, **SUM)
case("hamming_distance", [I(3, 4, hi=2), I(3, 4, hi=2)], {"dims": 1})
case("matrix_band_part", [F(4, 5), K(1), K(0)])
case("matrix_band_part", [F(4, 5), K(-1), K(1)], cid="matrix_band_part-neg")

# -- shape ---------------------------------------------------------------------
case("reshape", [F(3, 4), K([4, 3])])
case("reshape", [F(3, 4), K([-1, 2])], cid="reshape-infer")
case("reshapeas", [F(3, 4), F(2, 6)])
case("flatten", [F(3, 4), F(2)])
case("flatten_2d", [F(2, 3, 4)], {"axis": 2})
case("transpose", [F(3, 4)])
case("transpose", [F(2, 3, 4)], {"axes": (2, 0, 1)}, cid="transpose-axes")
case("permute", [F(2, 3, 4), K([1, 2, 0])])
case("squeeze", [F(3, 1, 4, 1)])
case("squeeze", [F(3, 1, 4, 1)], {"axis": 1}, cid="squeeze-axis")
case("expand_dims", [F(3, 4), K(1)])
case("expand_dims", [F(3, 4)], {"axis": (0, 3)}, cid="expand_dims-tuple")
case("broadcast_to", [F(4), K([3, 4])])
case("tile", [F(2, 3), K([2, 1])])
case("tile_to_shape", [F(1, 4), K([3, 4])])
case("repeat", [F(2, 3), K(2)], {"axis": 0})
case("repeat", [F(2, 3), K(2)], cid="repeat-flat")
case("concat", [F(3, 4), F(3, 2)], {"axis": 1})
case("stack", [F(3, 4), F(3, 4)], {"axis": 1})
case("parallel_stack", [F(3, 4), F(3, 4)], cid="parallel_stack(alias)")
case("unstack", [F(3, 4)], {"axis": 1})
case("split", [F(4, 6), K(3)], {"axis": 1})
case("split", [F(4, 6), K([1, 3])], {"axis": 1}, cid="split-indices")
case("split_v", [F(4, 6), K([1, 2, 3])], {"axis": 1})
case("tear", [F(3, 4)])
case("reverse", [F(3, 4)], {"dims": [1]})
case("reverse", [F(3, 4)], cid="reverse-all")
case("roll", [F(3, 4), K(1)], {"axis": 1})
case("roll", [F(3, 4), K(2)], cid="roll-flat")
case("order", [F(3, 4)])
for _n in ["rank", "shape_of", "size"]:
    case(_n, [F(3, 4)])
case("shape", [F(3, 4)], cid="shape(alias)")
case("shapes_of", [F(3, 4), F(2)])
case("size_at", [F(3, 4), K(1)])
case("set_shape", [F(3, 4), K([2, 6])])
case("evaluate_reduction_shape", [K([3, 4, 5], np.int32), K([1])],
     {"keep_dims": True})
case("evaluate_reduction_shape", [K([3, 4, 5], np.int32), K([0, 2])],
     cid="evaluate_reduction_shape-drop")
case("broadcast_dynamic_shape", [K([3, 1], np.int32), K([1, 4], np.int32)])
case("eye", [K(3)])
case("eye", [K(3), K(4)], {"batch_shape": [2]}, cid="eye-batch")
case("fill", [K([2, 3]), K(1.5)])
case("fill", [K([2, 3]), K(2)], cid="fill-int")
case("create", [K([2, 3])])
case("range", [K(0), K(10), K(2)])
case("range", [K(5)], cid="range-limit")
case("range", [K(0.0), K(1.0), K(0.25)], cid="range-float")
case("lin_space", [K(0.0), K(1.0), K(5)])
case("meshgrid", [F(3), F(4)])
case("meshgrid", [F(3), F(4)], {"indexing": "ij"}, cid="meshgrid-ij")
case("onehot", [I(3, hi=4), K(4)])
case("onehot", [I(3, hi=4), K(4)],
     {"axis": 0, "on_value": 2.0, "off_value": -1.0}, cid="onehot-axis0")
case("sequence_mask", [K([1, 3, 2], np.int32), K(4)])
case("sequence_mask", [K([1, 3, 2], np.int32)], cid="sequence_mask-nomax")
case("reverse_sequence", [F(2, 5, 3), K([3, 5], np.int32)])
case("reverse_sequence", [F(5, 2, 3), K([2, 4], np.int32)],
     {"seq_axis": 0, "batch_axis": 1}, cid="reverse_sequence-axes")
case("gather", [F(5, 4), I(2, 3, hi=5)])
case("gather", [F(5, 4), K([-1, 0, 2], np.int32)], {"axis": 1},
     cid="gather-axis1-negative")
case("gather_nd", [F(4, 5), K([[0, 1], [3, 4], [2, 2]], np.int32)])
case("gather_nd", [F(4, 5, 2), K([[0], [3]], np.int32)],
     cid="gather_nd-slices")
case("embedding_lookup", [F(6, 4), I(2, 3, hi=6)])
case("invert_permutation", [K([2, 0, 3, 1], np.int32)])
_IDX = K([1, 3, 1], np.int32)
for _n in ["scatter_add", "scatter_sub", "scatter_max", "scatter_min"]:
    case(_n, [F(5, 4), _IDX, F(3, 4)])
# jax.grad of .at[].multiply needs unique indices: values only
case("scatter_mul", [F(5, 4), _IDX, F(3, 4)], grad=False)
case("scatter_div", [F(5, 4), _IDX, NZ(3, 4)], grad=False)
case("scatter_upd", [F(5, 4), K([0, 3], np.int32), F(2, 4)])
case("scatter_update", [F(5, 4), K([4], np.int32), F(1, 4)],
     cid="scatter_update(alias)")
case("scatter_nd", [K([[0, 1], [3, 4], [0, 1]], np.int32), F(3), K([4, 5])])
case("scatter_nd", [K([[1], [3]], np.int32), F(2, 5), K([4, 5])],
     cid="scatter_nd-slices")
_ND = K([[0, 1], [3, 4], [0, 1]], np.int32)
for _n in ["scatter_nd_add", "scatter_nd_sub", "scatter_nd_max",
           "scatter_nd_min"]:
    case(_n, [F(4, 5), _ND, F(3)])
case("scatter_nd_update", [F(4, 5), K([[0, 1], [3, 4]], np.int32), F(2)])
case("slice", [F(3, 4), K([1, 0]), K([2, -1])])
case("strided_slice", [F(4, 5), K([0, 1]), K([3, 5]), K([2, 1])])
case("dynamic_partition", [F(4, 3), K([0, 1, 0, 1], np.int32), K(2)])
case("space_to_depth", [F(1, 4, 4, 2), K(2)])
case("space_to_depth", [F(1, 2, 4, 4), K(2)], {"data_format": "NCHW"},
     cid="space_to_depth-nchw")
case("depth_to_space", [F(1, 2, 2, 8), K(2)])
case("depth_to_space", [F(1, 8, 2, 2), K(2)], {"data_format": "NCHW"},
     cid="depth_to_space-nchw")
case("batch_to_space", [F(4, 2, 2, 1), K([2, 2]), K([[0, 0], [0, 1]])])
case("batch_to_space_nd", [F(4, 2, 2, 1), K([2, 2]), K([[0, 0], [0, 0]])],
     cid="batch_to_space_nd(alias)")
case("space_to_batch", [F(1, 4, 4, 1), K([2, 2]), K([[0, 0], [0, 0]])])
case("space_to_batch_nd", [F(1, 2, 4, 1), K([2, 2]), K([[1, 1], [0, 0]])],
     cid="space_to_batch_nd(alias)")
case("pad", [F(3, 4), K([[1, 2], [0, 1]])])
case("pad", [F(3, 4), K([[1, 2], [0, 1]])], {"constant_values": 1.5},
     cid="pad-value")
case("pad", [F(3, 4), K([[1, 2], [2, 1]])], {"mode": "REFLECT"},
     cid="pad-reflect")
case("pad", [F(3, 4), K([[1, 2], [2, 1]])], {"mode": "SYMMETRIC"},
     cid="pad-symmetric")
case("pad", [F(3, 4), K([[1, 1], [1, 1]])], {"mode": 1}, cid="pad-mode-int")
case("mirror_pad", [F(3, 4), K([[1, 1], [2, 2]])])
case("unique", [I(8, hi=4)])
case("unique_with_counts", [I(8, hi=4)])
case("listdiff", [K([1, 2, 3, 4, 5], np.int32), K([2, 5], np.int32)])
case("diag", [F(3)])
case("diag", [F(2, 2)], cid="diag-flat")
case("diag_part", [F(3, 3)])
case("matrix_diag", [F(2, 3)])
case("matrix_diag_part", [F(2, 3, 4)])
case("matrix_set_diag", [F(3, 4), F(3)])
case("tri", [K(3), K(4), K(1)])
case("triu", [F(4, 4), K(1)])
case("trace", [F(2, 3, 3)])
case("bitcast", [F(3, 4), K("int32")], grad=False)
case("bitcast", [F(3), K("uint8")], cid="bitcast-narrower", grad=False)
case("assign", [F(3, 4), F(4)])
case("identity_n", [F(3, 4), F(2)])
case("tf_strided_slice", [F(4, 5)],
     {"spec": [("slice", 1, 3, 1), ("slice", None, None, -1)]})
case("tf_strided_slice", [F(2, 3, 4)],
     {"spec": [("ellipsis",), ("newaxis",), ("int", -1)]},
     cid="tf_strided_slice-ellipsis")
case("tf_strided_slice", [F(4, 5)],
     {"spec": [("slice", 3, 0, -2), ("all",)]},
     cid="tf_strided_slice-negative-step")

# -- nn ----------------------------------------------------------------------
case("softmax", [F(3, 4)])
case("softmax", [F(3, 4)], {"axis": 0}, cid="softmax-axis0")
case("log_softmax", [F(3, 4)])
case("softmax_with_temperature", [F(3, 4)], {"temperature": 2.0})
case("biasadd", [F(2, 3, 4), F(4)])
case("biasadd", [F(2, 3, 4, 4), F(3)], {"nchw": True}, cid="biasadd-nchw")
case("xw_plus_b", [F(2, 3), F(3, 4), F(4)], **SUM)
case("xw_plus_b", [F(2, 3), F(4, 3), F(4)], {"transpose_w": True},
     cid="xw_plus_b-transposed", **SUM)
case("relu_layer", [F(2, 3), F(3, 4), F(4)], **SUM)
case("layer_norm", [F(2, 5), P(5), F(5)], {"eps": 1e-5}, **SUM)
case("layer_norm", [F(2, 5), P(5)], {"eps": 1e-12}, cid="layer_norm-nobias",
     **SUM)
case("batchnorm", [F(2, 3), F(3), P(3), P(3), F(3)], **SUM)
case("fused_batch_norm", [F(2, 2, 2, 3), P(3), F(3)], **SUM)
case("lrn", [F(1, 2, 2, 8)], {"depth_radius": 2}, **SUM)
_MASK = lambda r: np.concatenate([r.rand(2, 3, 4) > 0.3,   # noqa: E731
                                  np.zeros((2, 3, 1), bool)], -1)
case("dot_product_attention", [F(2, 3, 4), F(2, 5, 4), F(2, 5, 4)], **SUM)
case("dot_product_attention", [F(2, 3, 4), F(2, 5, 4), F(2, 5, 4), _MASK],
     cid="dot_product_attention-mask", **SUM)
case("multi_head_dot_product_attention",
     [F(2, 3, 6), F(2, 3, 6), F(2, 3, 6), F(6, 2, 3), F(6, 2, 3), F(6, 2, 3),
      F(6, 6), lambda r: np.asarray([[1, 1, 0], [1, 0, 1]], np.int32)],
     **SUM)
case("l2_normalize", [F(3, 4)])
for _d in ("dropout", "alpha_dropout", "gaussian_dropout"):
    case(_d, [F(3, 4), K(0.5), K(0)], {"training": False},
         cid=f"{_d}-inference")

# -- losses ------------------------------------------------------------------
_W = P(3, 4)
for _n in ["mean_sqerr_loss", "absolute_difference_loss", "huber_loss",
           "cosine_distance_loss", "mean_pairwssqerr_loss"]:
    case(_n, [F(3, 4), None, F(3, 4)], **SUM)
case("log_loss", [P(3, 4, lo=0.05, hi=0.95), None,
                  lambda r: (r.rand(3, 4) > 0.5).astype(np.float32)], **SUM)
case("log_poisson_loss", [F(3, 4), None, P(3, 4)], {"full": True}, **SUM)
for _n in ["hinge_loss", "squared_hinge_loss", "sigm_cross_entropy_loss"]:
    case(_n, [F(3, 4), None,
              lambda r: (r.rand(3, 4) > 0.5).astype(np.float32)], **SUM)
case("sigm_cross_entropy_loss",
     [F(3, 4), _W, lambda r: (r.rand(3, 4) > 0.5).astype(np.float32)],
     {"label_smoothing": 0.1, "reduction": 3},
     cid="sigm_cross_entropy_loss-smooth-weighted", **SUM)
case("softmax_cross_entropy_loss",
     [F(3, 4), None, lambda r: np.eye(4, dtype=np.float32)[[0, 2, 3]]],
     {"label_smoothing": 0.2}, **SUM)
for _red in (0, 1, 2, 3):
    case("mean_sqerr_loss", [F(3, 4), _W, F(3, 4)], {"reduction": _red},
         cid=f"mean_sqerr_loss-weights-reduction{_red}", **SUM)
case("softmax_cross_entropy_loss_with_logits",
     [F(3, 4), lambda r: np.eye(4, dtype=np.float32)[[0, 2, 3]]], **SUM)
case("sparse_softmax_cross_entropy_loss_with_logits", [I(3, hi=4), F(3, 4)],
     **SUM)
case("weighted_cross_entropy_with_logits",
     [lambda r: (r.rand(3, 4) > 0.5).astype(np.float32), F(3, 4),
      K(2.0, np.float32)], **SUM)
case("l2_loss", [F(3, 4)], **SUM)
# weighted forms: the cases the _bp / _grad ops run (the JAX bp ops take
# no None input)
_LAB = lambda r: (r.rand(3, 4) > 0.5).astype(np.float32)  # noqa: E731
for _n, _a in [("absolute_difference_loss", [F(3, 4), _W, F(3, 4)]),
               ("huber_loss", [F(3, 4), _W, F(3, 4)]),
               ("cosine_distance_loss", [F(3, 4), P(3, 1), F(3, 4)]),
               ("mean_pairwssqerr_loss", [F(3, 4), P(3, 1), F(3, 4)]),
               ("log_loss", [P(3, 4, lo=0.05, hi=0.95), _W, _LAB]),
               ("log_poisson_loss", [F(3, 4), _W, P(3, 4)]),
               ("hinge_loss", [F(3, 4), _W, _LAB]),
               ("squared_hinge_loss", [F(3, 4), _W, _LAB]),
               ("softmax_cross_entropy_loss",
                [F(3, 4), P(3), lambda r: np.eye(4, dtype=np.float32)[
                    [0, 2, 3]]])]:
    case(_n, _a, cid=f"{_n}-weighted", **SUM)

# -- updaters ----------------------------------------------------------------
G, S1, S2 = F(3, 4), P(3, 4, lo=0.01, hi=0.5), F(3, 4)
case("sgd_updater", [G], {"lr": 0.05})
case("apply_sgd", [G], cid="apply_sgd(alias)")
case("momentum_updater", [G, S2], {"lr": 0.05, "momentum": 0.8})
case("nesterovs_updater", [G, S2], {"lr": 0.05})
for _n in ["adam_updater", "ada_max_updater", "adabelief_updater",
           "nadam_updater"]:
    case(_n, [G, S1, S2], {"lr": 0.01, "iteration": 3}, **SUM)
case("ams_grad_updater", [G, S1, S2, S1], {"iteration": 2}, **SUM)
case("ada_grad_updater", [G, S1], **SUM)
case("ada_delta_updater", [G, S1, S1], **SUM)
case("rms_prop_updater", [G, S1], **SUM)

# -- convolution / pooling ---------------------------------------------------
case("conv2d", [F(1, 2, 5, 5), F(3, 3, 2, 4)], **SUM)
case("conv2d", [F(1, 5, 5, 2), F(3, 3, 2, 4), F(4)],
     {"strides": (2, 2), "data_format": "NHWC"}, cid="conv2d-nhwc-stride",
     **SUM)
case("conv2d", [F(1, 2, 6, 6), F(2, 2, 2, 4)], {"padding": "VALID",
                                                 "dilation": (2, 2)},
     cid="conv2d-valid-dilated", **SUM)
for _n in ["maxpool2d", "avgpool2d", "pnormpool2d"]:
    case(_n, [F(1, 2, 4, 6)], **SUM)
case("maxpool2d", [F(1, 2, 5, 5)], {"kernel": (3, 3), "strides": (2, 2),
                                    "padding": "SAME"}, cid="maxpool2d-same",
     **SUM)
case("avgpool2d", [F(1, 2, 5, 5)], {"kernel": (3, 3), "strides": (2, 2),
                                    "padding": "SAME", "include_pad": False},
     cid="avgpool2d-same-exclude-pad", **SUM)

# -- matrix products ---------------------------------------------------------
case("matmul", [F(3, 4), F(4, 5)], **SUM)
case("matmul", [F(2, 4, 3), F(2, 5, 4)],
     {"transpose_a": True, "transpose_b": True, "alpha": 2.0},
     cid="matmul-transposed-alpha", **SUM)
case("mmul", [F(2, 3, 4), F(4, 5)], cid="mmul(alias)", **SUM)
case("gemm", [F(3, 4), F(4, 5)], cid="gemm(alias)", **SUM)
case("batched_gemm", [F(2, 3, 4), F(2, 4, 5)], **SUM)
case("tensormmul", [F(2, 3, 4), F(4, 3, 5), K([1, 2]), K([1, 0])], **SUM)
case("tensordot", [F(3, 4), F(4, 2), K([1]), K([0])], cid="tensordot(alias)",
     **SUM)
case("einsum", [F(3, 4), F(4, 5)], {"equation": "ij,jk->ik"}, **SUM)

# -- frame ops ---------------------------------------------------------------
for _n in ["enter", "exit", "next_iteration", "Enter", "Exit",
           "NextIteration"]:
    case(_n, [F(3, 4)])
case("switch", [F(3, 4), K(True)])
case("Switch", [F(3, 4), K(False)], cid="Switch(alias)")
case("merge", [F(3, 4), F(3, 4)])

# -- recurrent (B=2, T=3, In=4, H=3) and nlp rounds ---------------------------
# masked and activation-named forms of every op: tests/test_torch_recurrent.py
_X, _H = F(2, 3, 4), F(2, 3)
_LSTM_W = [F(4, 12), F(3, 12), F(12)]
_GRU_W = [F(7, 6), F(7, 3), F(6), F(3)]
_MASK = lambda r: r.rand(2, 3) > 0.3  # noqa: E731
case("lstmLayerCell", [F(2, 4), _H, _H] + _LSTM_W, **SUM)
case("lstmCell", [F(2, 4), _H, _H] + _LSTM_W, {"forget_bias": 1.0},
     cid="lstmCell(alias)-forget-bias", **SUM)
case("lstmLayer", [_X] + _LSTM_W + [_H, _H], **SUM)
case("lstmLayer", [_X] + _LSTM_W + [K(None), K(None), K(0.0), K(False),
                                    K(True), _MASK],
     cid="lstmLayer-masked", **SUM)
case("lstm", [F(3, 2, 4)] + _LSTM_W,
     {"time_major": True, "return_sequence": False}, cid="lstm(alias)-tm",
     **SUM)
case("lstmLayer_bidirectional", [_X] + _LSTM_W + _LSTM_W, **SUM)
case("lstmLayer_bidirectional", [_X] + _LSTM_W + _LSTM_W, {"mode": "ave"},
     cid="lstmLayer_bidirectional-ave", **SUM)
case("gruCell", [F(2, 4), _H] + _GRU_W, **SUM)
case("gru_block_cell", [F(2, 4), _H] + _GRU_W, **SUM)
case("gru", [_X, _H] + _GRU_W, **SUM)
case("gru", [_X, _H] + _GRU_W + [K(False), _MASK], cid="gru-masked", **SUM)
case("gru_onnx", [F(3, 2, 4), F(9, 4), F(9, 3), F(18)], **SUM)
case("gru_onnx", [F(3, 2, 4), F(9, 4), F(9, 3), F(18), _H, K(1)],
     cid="gru_onnx-linear-before-reset", **SUM)
case("gru_onnx", [_X, F(9, 4), F(9, 3), F(18), _H, K(0), K(False), _MASK],
     cid="gru_onnx-batch-major-masked", **SUM)
case("sruCell", [F(2, 4), _H, F(4, 9), F(6)], **SUM)
case("sru", [_X, _H, F(4, 9), F(6)], **SUM)
case("sru_bi", [_X, F(4, 9), F(6), F(4, 9), F(6)], **SUM)
case("static_rnn", [_X, F(4, 3), F(3, 3), F(3), _H], **SUM)
case("dynamic_rnn", [F(3, 2, 4), F(4, 3), F(3, 3), F(3)],
     {"time_major": True}, cid="dynamic_rnn(alias)-tm", **SUM)
case("lstmBlockCell", [F(2, 4), _H, _H, F(7, 12), F(12)], **SUM)
case("lstmBlockCell", [F(2, 4), _H, _H, F(7, 12), F(12), F(3), F(3), F(3),
                       K(0.5), K(0.4)], cid="lstmBlockCell-peephole-clip",
     **SUM)
case("lstmBlock", [F(3, 2, 4), _H, _H, F(7, 12), F(12)], **SUM)
case("static_bidirectional_rnn",
     [_X, F(4, 3), F(3, 3), F(3), F(4, 3), F(3, 3), F(3)], **SUM)
case("dynamic_bidirectional_rnn",
     [_X, F(4, 3), F(3, 3), F(3), F(4, 3), F(3, 3), F(3), _H, _H],
     cid="dynamic_bidirectional_rnn(alias)-h0", **SUM)
# 6 pairs over 10 rows: repeated ids, whose updates sum
case("skipgram", [F(10, 4), F(10, 4), I(6, hi=10), I(6, hi=10),
                  I(6, 3, hi=10)], {"lr": 0.1}, **SUM)
case("cbow", [F(10, 4), F(10, 4), I(6, 4, hi=10),
              lambda r: (r.rand(6, 4) > 0.3).astype(np.float32),
              I(6, hi=10), I(6, 3, hi=10)], **SUM)


# -- the comparison harness ---------------------------------------------------

def _draw(inputs, seed):
    r = np.random.RandomState(seed)
    return [None if m is None else m(r) for m in inputs]


def _jx(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _tx(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _tname(t):
    return str(t.dtype).replace("torch.", "")


def _compare(jout, tout, tol):
    jl, tl = _leaves(jout), _leaves(tout)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert isinstance(t, torch.Tensor)
        assert str(j.dtype) == _tname(t), (j.dtype, t.dtype)
        assert tuple(j.shape) == tuple(t.shape)
        np.testing.assert_allclose(t.detach().numpy(), j, **tol)


def _first_float(out):
    for leaf in _leaves(out):
        if hasattr(leaf, "dtype") and (
                (isinstance(leaf, torch.Tensor) and leaf.is_floating_point())
                or (not isinstance(leaf, torch.Tensor)
                    and jnp.issubdtype(leaf.dtype, jnp.floating))):
            return leaf
    return None


@pytest.mark.parametrize("op_name,inputs,kwargs,opts", CASES)
def test_op_matches_jax(op_name, inputs, kwargs, opts):
    arrays = _draw(inputs, seed=len(op_name))
    jargs = [_jx(a) for a in arrays]
    targs = [_tx(a) for a in arrays]
    jout = jexec(op_name, *jargs, **kwargs)
    tout = texec(op_name, *targs, **kwargs)
    tol = {k: opts[k] for k in ("atol", "rtol") if k in opts} or F32
    _compare(jout, tout, tol)

    if not (TREG.lookup(op_name).differentiable and opts.get("grad", True)):
        return
    float_idx = [i for i, a in enumerate(arrays)
                 if isinstance(a, np.ndarray) and a.dtype == np.float32
                 and a.ndim > 0]
    float_idx = opts.get("grad_args", float_idx)
    jfirst = _first_float(jout)
    if not float_idx or jfirst is None:
        return
    w = np.asarray(np.random.RandomState(7).randn(*np.shape(jfirst)),
                   np.float32)

    def jloss(*fl):
        a = list(jargs)
        for i, v in zip(float_idx, fl):
            a[i] = v
        return jnp.sum(_first_float(jexec(op_name, *a, **kwargs)) * w)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(float_idx))))(
        *[jargs[i] for i in float_idx])
    leaves = [targs[i].clone().requires_grad_(True) for i in float_idx]
    a = list(targs)
    for i, v in zip(float_idx, leaves):
        a[i] = v
    tloss = torch.sum(_first_float(texec(op_name, *a, **kwargs))
                      * torch.from_numpy(w))
    tgrads = (torch.autograd.grad(tloss, leaves, allow_unused=True)
              if tloss.requires_grad else [None] * len(leaves))
    gtol = GRAD_SPECIAL if opts.get("atol", 0) >= SPECIAL["atol"] and \
        op_name in ("polygamma", "igamma", "igammac", "lgamma", "digamma",
                    "erfc") else GRAD
    for jg, tg, x in zip(jgrads, tgrads, leaves):
        tg = torch.zeros_like(x) if tg is None else tg
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **gtol)


# -- the _bp ops ----------------------------------------------------------------

def _bp_cases():
    by_op = {}
    for p in CASES:
        op_name, inputs, kwargs, opts = p.values
        base = TREG.lookup(op_name).name
        if base not in by_op or (None in by_op[base][0]
                                 and None not in inputs):
            by_op[base] = (inputs, kwargs, opts)
    out = []
    for name in TREG.by_category("autodiff_bp"):
        base = _BP_IRREGULAR.get(name) or (
            name[:-3] if name.endswith("_bp") else name[:-5])
        if base in _BP_ELSEWHERE or base not in by_op:
            continue
        out.append(pytest.param(name, base, *by_op[base], id=name))
    return out


#: bp names that are not <base>_bp / <base>_grad
_BP_IRREGULAR = {"lstmLayerCellBp": "lstmLayerCell"}
#: bp ops held by their own tests below: ctc_loss (the JAX forward needs
#: optax) and dynamic_partition (a list of outputs)
_BP_ELSEWHERE = ("ctc_loss", "dynamic_partition")
BP_CASES = _bp_cases()
#: the bp ops of the convolution and image families' later ops, held
#: with their forwards in test_torch_conv_image_ops.py
BP_CONV_IMAGE = {"avgpool3dnew_bp", "conv1d_bp", "conv3dnew_bp",
                 "deconv2d_bp", "deconv3d_bp", "depthwise_conv2d_bp",
                 "im2col_bp", "maxpool3dnew_bp", "sconv2d_bp",
                 "upsampling2d_bp", "upsampling3d_bp"}
#: the segment family's bp ops, held with their forwards in
#: test_torch_op_tail.py
BP_SEGMENT = {f"{p}segment_{r}_bp" for p in ("", "unsorted_")
              for r in ("sum", "max", "min", "prod", "mean")} | {
    "unsorted_segment_sqrt_n_bp"}


def test_every_bp_op_has_a_case():
    covered = {p.values[0] for p in BP_CASES}
    assert set(TREG.by_category("autodiff_bp")) - covered == {
        "ctc_loss_grad", "dynamic_partition_bp"} | BP_CONV_IMAGE | BP_SEGMENT


@pytest.mark.parametrize("name,base,inputs,kwargs,opts", BP_CASES)
def test_bp_op_matches_jax(name, base, inputs, kwargs, opts):
    arrays = _draw(inputs, seed=len(base))
    jargs = [_jx(a) for a in arrays]
    targs = [_tx(a) for a in arrays]
    jout = jexec(base, *jargs, **kwargs)
    # one upstream gradient, broadcast to every output: an output's shape,
    # or a scalar where the forward returns several (recurrent ops)
    shape = () if isinstance(jout, (tuple, list)) else np.shape(jout)
    dtype = np.asarray(_first_float(jout)).dtype
    g = np.asarray(np.random.RandomState(3).randn(*shape), dtype)
    jbp = jexec(name, *jargs, jnp.asarray(g), **kwargs)
    tbp = texec(name, *targs, torch.from_numpy(g), **kwargs)
    _compare(jbp, tbp, SUM if opts.get("atol", 0) < 1e-4 else opts)


def test_concat_and_dynamic_partition_bp():
    r = np.random.RandomState(0)
    x = r.randn(4, 3).astype(np.float32)
    parts = np.asarray([0, 1, 0, 1], np.int32)
    _compare(jexec("dynamic_partition_bp", jnp.asarray(x), jnp.asarray(parts),
                   2, jnp.asarray(0.5, jnp.float32)),
             texec("dynamic_partition_bp", torch.from_numpy(x),
                   torch.from_numpy(parts), 2, torch.tensor(0.5)), SUM)
    a, b = r.randn(3, 4).astype(np.float32), r.randn(3, 2).astype(np.float32)
    g = r.randn(3, 6).astype(np.float32)
    _compare(jexec("concat_bp", jnp.asarray(a), jnp.asarray(b),
                   jnp.asarray(g), axis=1),
             texec("concat_bp", torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(g), axis=1), SUM)


# -- lists in, lists out ---------------------------------------------------------

def test_clip_by_global_norm_and_dynamic_stitch():
    r = np.random.RandomState(1)
    xs = [r.randn(3, 4).astype(np.float32), r.randn(5).astype(np.float32)]
    j = jexec("clip_by_global_norm", [jnp.asarray(x) for x in xs], 1.0)
    t = texec("clip_by_global_norm", [torch.from_numpy(x) for x in xs], 1.0)
    _compare(j, t, F32)
    idx = [np.asarray([0, 2], np.int32), np.asarray([1, 3], np.int32)]
    data = [r.randn(2, 3).astype(np.float32), r.randn(2, 3).astype(np.float32)]
    j = jexec("dynamic_stitch", [jnp.asarray(i) for i in idx],
              [jnp.asarray(d) for d in data])
    t = texec("dynamic_stitch", [torch.from_numpy(i) for i in idx],
              [torch.from_numpy(d) for d in data])
    _compare(j, t, F32)


def _ctc_brute_force(logp, label, blank=0):
    """-log sum over every alignment of length T that collapses to
    ``label`` (small T and C only)."""
    import itertools
    T, C = logp.shape
    total = []
    for path in itertools.product(range(C), repeat=T):
        collapsed, prev = [], None
        for s in path:
            if s != prev and s != blank:
                collapsed.append(s)
            prev = s
        if collapsed == list(label):
            total.append(sum(logp[t, s] for t, s in enumerate(path)))
    m = max(total)
    return -(m + math.log(sum(math.exp(v - m) for v in total)))


def test_ctc_loss_against_brute_force():
    """The JAX op calls optax, which does not import here; the port's
    per-sequence CTC NLL is held against the sum over alignments (atol
    1e-5)."""
    r = np.random.RandomState(2)
    logits = r.randn(2, 4, 3).astype(np.float32)
    labels = np.asarray([[1, 2], [2, 0]], np.int32)
    lab_len = np.asarray([2, 1], np.int32)
    log_len = np.asarray([4, 3], np.int32)
    got = texec("ctc_loss", torch.from_numpy(labels),
                torch.from_numpy(logits), torch.from_numpy(lab_len),
                torch.from_numpy(log_len)).numpy()
    ls = torch.log_softmax(torch.from_numpy(logits), -1).double().numpy()
    want = [_ctc_brute_force(ls[b, :log_len[b]], labels[b, :lab_len[b]])
            for b in range(2)]
    np.testing.assert_allclose(got, want, atol=1e-5)
    # its _grad op: autograd of the same loss, the upstream gradient 1
    lg = torch.from_numpy(logits).requires_grad_(True)
    texec("ctc_loss", torch.from_numpy(labels), lg, torch.from_numpy(lab_len),
          torch.from_numpy(log_len)).sum().backward()
    bp = texec("ctc_loss_grad", torch.from_numpy(labels),
               torch.from_numpy(logits), torch.from_numpy(lab_len),
               torch.from_numpy(log_len), torch.tensor(1.0))
    np.testing.assert_allclose(bp[1].numpy(), lg.grad.numpy(), atol=1e-6)
    assert bp[0].dtype == torch.int32 and not bp[0].any()


# -- random ops --------------------------------------------------------------------

RANDOM = [
    ("randomuniform", lambda k: texec("randomuniform", k, [400, 50],
                                      -1.0, 3.0), (400, 50), "float32",
     1.0, 4.0 / 12 ** 0.5),
    ("random_uniform", lambda k: texec("random_uniform", k, [20000], 0, 10,
                                       dtype="int32"),
     (20000,), "int32", 4.5, (100 / 12 - 1 / 12) ** 0.5 * 1.0),
    ("random_normal", lambda k: texec("random_normal", k, [20000], 2.0,
                                      0.5), (20000,), "float32", 2.0, 0.5),
    ("random_bernoulli", lambda k: texec("random_bernoulli", k, [20000],
                                         0.3), (20000,), "float32", 0.3,
     (0.3 * 0.7) ** 0.5),
    ("random_exponential", lambda k: texec("random_exponential", k, [20000],
                                           2.0), (20000,), "float32", 0.5,
     0.5),
    ("random_gamma", lambda k: texec("random_gamma", k, [20000], 3.0, 2.0),
     (20000,), "float32", 1.5, 3.0 ** 0.5 / 2.0),
    ("random_poisson", lambda k: texec("random_poisson", k, [20000], 4.0),
     (20000,), "int32", 4.0, 2.0),
]


@pytest.mark.parametrize("name,draw,shape,dtype,mean,std", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_op_moments_and_determinism(name, draw, shape, dtype, mean,
                                           std):
    a, b, c = draw(5), draw(5), draw(6)
    assert tuple(a.shape) == shape and _tname(a) == dtype
    assert torch.equal(a, b) and not torch.equal(a, c)
    af = a.double()
    assert abs(float(af.mean()) - mean) < 0.05 * max(std, 0.2) * 4
    assert abs(float(af.std()) - std) < 0.1 * std
    # the JAX op gives the same shape and dtype
    jname = name
    jkey = jax.random.key(0)
    jargs = {"randomuniform": (jkey, [400, 50], -1.0, 3.0),
             "random_uniform": (jkey, [20000], 0, 10),
             "random_normal": (jkey, [20000], 2.0, 0.5),
             "random_bernoulli": (jkey, [20000], 0.3),
             "random_exponential": (jkey, [20000], 2.0),
             "random_gamma": (jkey, [20000], 3.0, 2.0),
             "random_poisson": (jkey, [20000], 4.0)}[name]
    jkw = {"dtype": jnp.int32} if name == "random_uniform" else {}
    j = jexec(jname, *jargs, **jkw)
    assert tuple(j.shape) == shape and str(j.dtype) == dtype


def test_random_multinomial_shuffle_crop_dropouts():
    logits = torch.log(torch.tensor([[0.1, 0.6, 0.3]]))
    s = texec("random_multinomial", 3, logits, 30000)
    assert s.shape == (1, 30000) and s.dtype == torch.int32
    freq = torch.bincount(s[0].long(), minlength=3).double() / 30000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.6, 0.3], atol=0.02)
    x = torch.arange(20.0).reshape(10, 2)
    sh = texec("random_shuffle", 1, x)
    assert torch.equal(torch.sort(sh[:, 0]).values, x[:, 0])
    assert torch.equal(sh, texec("random_shuffle", 1, x))
    c = texec("random_crop", 2, torch.arange(30.0).reshape(5, 6), [2, 3])
    assert c.shape == (2, 3) and float(c[0, 1] - c[0, 0]) == 1.0
    big = torch.ones(200, 100)
    for name in ("dropout_inverted",):
        d = texec(name, 4, big, 0.25)
        assert abs(float((d == 0).double().mean()) - 0.25) < 0.02
        assert set(torch.unique(d).tolist()) <= {0.0, float(
            np.float32(1.0) / np.float32(0.75))}
    d = texec("dropout", big, 0.25, 9)
    assert abs(float((d == 0).double().mean()) - 0.25) < 0.02
    assert torch.equal(d, texec("dropout", big, 0.25, 9))
    ad = texec("alpha_dropout", torch.randn(200, 100,
                                            generator=torch.Generator()
                                            .manual_seed(0)), 0.2, 1)
    assert abs(float(ad.mean())) < 0.05 and abs(float(ad.std()) - 1) < 0.05
    gd = texec("gaussian_dropout", big, 0.2, 2)
    assert abs(float(gd.mean()) - 1) < 0.02
    assert abs(float(gd.std()) - (0.2 / 0.8) ** 0.5) < 0.02
    gn = texec("gaussian_noise", big * 0, 0.3, 2)
    assert abs(float(gn.std()) - 0.3) < 0.02
    texec("set_seed", 77)
    assert int(texec("get_seed")) == 77


# -- the trouble spots, pinned -------------------------------------------------------

def test_variance_is_ddof0_where_jax_is():
    x = np.asarray([1.0, 2.0, 4.0, 7.0], np.float32)
    t = torch.from_numpy(x)
    assert float(texec("moments", t)[1]) == pytest.approx(np.var(x))
    assert float(texec("reduce_variance", t, bias_corrected=False)) == \
        pytest.approx(np.var(x))
    assert float(texec("reduce_variance", t)) == \
        pytest.approx(np.var(x, ddof=1))
    g = torch.ones(4)
    ln = texec("layer_norm", t, g, eps=0.0)
    np.testing.assert_allclose(ln.numpy(), (x - x.mean()) / x.std(),
                               atol=1e-6)


def test_gelu_is_the_tanh_form():
    x = torch.tensor([-2.0, -0.5, 0.7, 3.0])
    tanh_form = 0.5 * x * (1 + torch.tanh((2 / math.pi) ** 0.5
                                          * (x + 0.044715 * x ** 3)))
    np.testing.assert_allclose(texec("gelu", x).numpy(), tanh_form.numpy(),
                               atol=1e-7)
    np.testing.assert_allclose(
        texec("gelu", x).numpy(),
        np.asarray(jexec("gelu", jnp.asarray(x.numpy()))), atol=1e-6)


def test_round_half_to_even():
    x = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    for name in ("round", "rint"):
        got = texec(name, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, [-2, -2, -0, 0, 2, 2, 4])
        np.testing.assert_array_equal(
            got, np.asarray(jexec(name, jnp.asarray(x))))


def test_remainder_takes_the_divisors_sign_and_floordiv_floors():
    a = np.asarray([7, -7, 7, -7], np.int32)
    b = np.asarray([3, 3, -3, -3], np.int32)
    for name, want in (("mod", [1, 2, -2, -1]), ("floormod", [1, 2, -2, -1]),
                       ("floordiv", [2, -3, -3, 2])):
        got = texec(name, torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        assert got.tolist() == want
        assert got.tolist() == np.asarray(
            jexec(name, jnp.asarray(a), jnp.asarray(b))).tolist()
    f = texec("mod", torch.tensor([-7.5]), torch.tensor([2.0]))
    assert float(f) == pytest.approx(0.5)


def test_index_results_are_int32():
    x = torch.randn(3, 4)
    for name, args in (("argmax", (x,)), ("argmin", (x,)),
                       ("shape_of", (x,)), ("rank", (x,)), ("size", (x,)),
                       ("Where", (x > 0,)),
                       ("mergemaxindex", (x, -x))):
        assert texec(name, *args).dtype == torch.int32, name
    assert texec("top_k", x, 2)[1].dtype == torch.int32
    assert texec("reduce_sum", torch.ones(3, dtype=torch.int32)).dtype == \
        torch.int32
    assert texec("to_int64", x).dtype == torch.int32
    assert texec("to_double", x).dtype == torch.float32


def test_fully_masked_attention_row_is_the_uniform_softmax():
    """A query whose keys are all masked: the finfo.min fill gives the
    mean of V (as the JAX op), where scaled_dot_product_attention gives
    NaN."""
    r = np.random.RandomState(4)
    q, k, v = (r.randn(1, 2, 4).astype(np.float32) for _ in range(3))
    mask = np.asarray([[[True, False], [False, False]]])
    out = texec("dot_product_attention", *map(torch.from_numpy, (q, k, v)),
                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out[0, 1], v[0].mean(0), atol=1e-6)
    np.testing.assert_allclose(
        out, np.asarray(jexec("dot_product_attention",
                              *map(jnp.asarray, (q, k, v, mask)))),
        atol=1e-6)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), attn_mask=torch.from_numpy(mask))
    # NaN or zeros, by PyTorch version: not the mean of V either way
    assert not np.allclose(sdpa[0, 1].numpy(), v[0].mean(0), atol=1e-3)


def test_executioner_panic_modes_and_profiler():
    from deeplearning4j_tpu_torch.ops import executioner as ex
    prof = ex.OpProfiler.get_instance()
    prof.reset()
    try:
        ex.set_profiling_mode(ex.ProfilingMode.NAN_PANIC)
        with pytest.raises(FloatingPointError, match="NaN"):
            texec("log", torch.tensor([-1.0]))
        ex.set_profiling_mode(ex.ProfilingMode.INF_PANIC)
        with pytest.raises(FloatingPointError, match="Inf"):
            texec("reciprocal", torch.tensor([0.0]))
        ex.set_profiling_mode(ex.ProfilingMode.OPERATIONS)
        texec("exp", torch.ones(3))
        texec("exp", torch.ones(3))
        stats = {s["op"]: s for s in prof.stats()}
        assert stats["exp"]["invocations"] == 2
    finally:
        ex.set_profiling_mode(ex.ProfilingMode.DISABLED)
        prof.reset()
    executed, total = TREG.coverage()
    assert "exp" in executed and len(total) == len(TREG)


def test_factory_against_the_jax_factory():
    from deeplearning4j_tpu.ndarray import factory as jnd
    from deeplearning4j_tpu_torch.ndarray import factory as tnd
    r = np.random.RandomState(0)
    a = r.randn(3, 4).astype(np.float32)
    b = r.randn(3, 4).astype(np.float32)
    pairs = [
        (lambda nd: nd.create([[1.0, 2.0], [3.0, 4.0]])),
        (lambda nd: nd.create([1, 2, 3])),
        (lambda nd: nd.zeros(2, 3)), (lambda nd: nd.ones((2, 3))),
        (lambda nd: nd.full((2, 2), 3.5)), (lambda nd: nd.eye(3, 4)),
        (lambda nd: nd.arange(5)), (lambda nd: nd.arange(0.0, 1.0, 0.25)),
        (lambda nd: nd.linspace(0.0, 1.0, 5)), (lambda nd: nd.scalar(2.0)),
        (lambda nd: nd.empty()), (lambda nd: nd.zeros_like(nd.create(a))),
        (lambda nd: nd.stack([nd.create(a), nd.create(b)], axis=1)),
        (lambda nd: nd.hstack([nd.create(a), nd.create(b)])),
        (lambda nd: nd.vstack([nd.create(a), nd.create(b)])),
        (lambda nd: nd.concat([nd.create(a), nd.create(b)], axis=1)),
        (lambda nd: nd.sort(nd.create(a), axis=1, descending=True)),
        (lambda nd: nd.argsort(nd.create(a), axis=0)),
        (lambda nd: nd.where(nd.create(a > 0), nd.create(a), nd.create(b))),
        (lambda nd: nd.diag(nd.create(a[0]))),
        (lambda nd: nd.pad(nd.create(a), [(1, 0), (0, 2)])),
        (lambda nd: nd.pad(nd.create(a), [(1, 1), (2, 2)], mode="reflect")),
        (lambda nd: nd.flip(nd.create(a), 1)),
        (lambda nd: nd.roll(nd.create(a), 1, axis=0)),
        (lambda nd: nd.gather(nd.create(a), nd.create(
            np.asarray([2, 0], np.int32)), axis=0)),
        (lambda nd: nd.one_hot(nd.create(np.asarray([0, 2], np.int32)), 3)),
    ]
    for fn in pairs:
        j, t = fn(jnd), fn(tnd)
        assert str(np.asarray(j.numpy()).dtype) == str(t.numpy().dtype)
        np.testing.assert_allclose(t.numpy(), j.numpy(), atol=1e-6)
    for j, t in ((jnd.split(jnd.create(a), 2, axis=1),
                  tnd.split(tnd.create(a), 2, axis=1)),
                 (jnd.tear(jnd.create(a)), tnd.tear(tnd.create(a))),
                 (jnd.where(jnd.create(a > 0)), tnd.where(tnd.create(a > 0)))):
        assert len(j) == len(t)
        for jj, tt in zip(j, t):
            np.testing.assert_allclose(tt.numpy(), jj.numpy())
    # random constructors: shapes, dtypes, determinism under a key
    assert tnd.rand(3, 4).shape == (3, 4)
    assert torch.equal(tnd.randn(5, key=3).torch(), tnd.randn(5, key=3).torch())
    assert tnd.randint(0, 4, (6,)).numpy().dtype == np.int32
    assert tnd.bernoulli(0.5, (4, 4)).numpy().dtype == np.float32
    s = tnd.shuffle(tnd.create(np.arange(10, dtype=np.float32)), key=1)
    assert sorted(s.numpy().tolist()) == list(range(10))
