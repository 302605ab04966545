"""The port's convolution and image op families
(``deeplearning4j_tpu_torch/ops/conv_ops.py`` and ``image_ops.py``)
against the JAX package's, op by op, on the same numpy inputs.

Each case runs through ``exec_op`` on both sides (JAX on the CPU, the
port with CPU tensors) from one ``np.random.RandomState`` draw, with
``test_torch_ops.py``'s harness: results, result dtypes, and for a
differentiable op the port's autograd against ``jax.grad`` of the same
weighted sum of the first output; each ``_bp`` op of these families
against the JAX ``_bp`` op. Tolerances, each with its reason:
- convolutions, pools over sums, resizes, crops and colour mixes: sums
  over a few dozen products in another order, atol 1e-5 plus rtol 1e-5
  (``SUM``); gradients likewise (``GRAD``).
- selections (max pools, argmax indices, nearest resizes, upsampling,
  ``im2col``, patches, NMS indices, drawn boxes) and the elementwise
  colour conversions: atol 1e-6 plus rtol 1e-6 (``F32``), indices
  exactly.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.ops.registry import OpRegistry as JReg

from test_torch_ops import (BP_CONV_IMAGE, F, I, K, SUM, TREG,
                            test_bp_op_matches_jax as _bp_matches,
                            test_op_matches_jax as _op_matches)

CASES = []


def case(op, inputs, kwargs=None, cid=None, **opts):
    CASES.append(pytest.param(op, inputs, kwargs or {}, opts,
                              id=cid or op))


def UNIT(*s):
    """Floats in [0, 1) (colours, hsv)."""
    return lambda r: r.uniform(0.0, 1.0, s).astype(np.float32)


def TIES(*s):
    """Small integers as floats: many equal values (argmax / NMS ties)."""
    return lambda r: r.randint(0, 3, s).astype(np.float32)


def BOXES(*s):
    """Normalized ``[y1, x1, y2, x2]`` boxes with y1 < y2, x1 < x2."""
    def f(r):
        a = r.uniform(0.0, 1.0, s + (2,))
        b = r.uniform(0.0, 1.0, s + (2,))
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        return np.concatenate([lo, hi], -1).astype(np.float32)
    return f


# -- convolutions ---------------------------------------------------------
case("conv1d", [F(2, 3, 9), F(3, 3, 4), F(4)], {"strides": 2}, **SUM)
case("conv1d", [F(2, 9, 3), F(3, 3, 4)],
     {"padding": 1, "dilation": 2, "data_format": "NWC"}, cid="conv1d-nwc",
     **SUM)
case("conv1d", [F(2, 3, 9), F(2, 3, 4)], {"padding": "VALID"},
     cid="conv1d-valid", **SUM)
case("conv3dnew", [F(2, 2, 5, 6, 5), F(3, 3, 2, 2, 3), F(3)],
     {"strides": (2, 2, 1)}, **SUM)
case("conv3d", [F(1, 5, 4, 5, 2), F(2, 3, 2, 2, 3)],
     {"padding": "VALID", "data_format": "NDHWC"}, cid="conv3d(alias)-ndhwc",
     **SUM)
# stride-2 SAME: the odd padded pixel at the end
case("depthwise_conv2d", [F(2, 3, 7, 8), F(3, 3, 3, 2), F(6)],
     {"strides": (2, 2)}, **SUM)
case("depthwise_conv2d", [F(2, 7, 8, 3), F(2, 3, 3, 2)],
     {"strides": (2, 2), "dilation": (1, 1), "data_format": "NHWC"},
     cid="depthwise_conv2d-nhwc", **SUM)
case("sconv2d", [F(2, 3, 7, 8), F(3, 3, 3, 2), F(1, 1, 6, 4), F(4)],
     {"strides": (2, 2)}, **SUM)
case("separable_conv2d", [F(2, 8, 7, 3), F(3, 3, 3, 1), F(1, 1, 3, 5)],
     {"padding": "VALID", "data_format": "NHWC"},
     cid="separable_conv2d(alias)-nhwc", **SUM)
case("pointwise_conv2d", [F(2, 3, 5, 5), F(1, 1, 3, 4), F(4)], **SUM)

# the transposed grid: kernels 2-4 (even and odd), strides 1-2, lax's
# SAME / VALID and its explicit pads of the dilated input
for _k in (2, 3, 4):
    for _s in (1, 2):
        for _p in ("SAME", "VALID", 1):
            case("deconv2d", [F(2, 3, 4, 5), F(_k, _k, 4, 3), F(4)],
                 {"strides": (_s, _s), "padding": _p},
                 cid=f"deconv2d-k{_k}-s{_s}-{_p}", **SUM)
case("deconv2d", [F(2, 3, 4, 5), F(3, 2, 4, 3)],
     {"strides": (2, 1), "padding": ((0, 1), (2, 0))},
     cid="deconv2d-pairs", **SUM)
case("deconv2d", [F(2, 3, 4, 4), F(3, 3, 2, 3)],
     {"strides": (2, 2), "padding": ((4, 5), (0, 0))},
     cid="deconv2d-pads-beyond-window", **SUM)
case("deconv2d", [F(2, 3, 4, 4), F(3, 3, 2, 3)],
     {"strides": (2, 2), "padding": "SAME", "dilation": (2, 1)},
     cid="deconv2d-dilated", **SUM)
case("deconv2d", [F(2, 4, 5, 3), F(3, 3, 2, 3)],
     {"strides": (2, 2), "padding": "VALID", "data_format": "NHWC"},
     cid="deconv2d-nhwc", **SUM)
case("deconv3d", [F(1, 2, 3, 4, 3), F(2, 3, 2, 3, 2), F(3)],
     {"strides": (2, 1, 2)}, **SUM)
case("deconv3d", [F(1, 2, 3, 3, 2), F(3, 2, 2, 2, 2)],
     {"strides": (1, 2, 2), "padding": "VALID"}, cid="deconv3d-valid",
     **SUM)
case("dilation2d", [F(2, 7, 8, 3), F(3, 2, 3)],
     {"strides": (2, 2), "rates": (1, 2)}, **SUM)
case("dilation2d", [F(2, 7, 8, 3), F(2, 2, 3)],
     {"strides": (1, 2), "rates": (2, 1), "padding": "VALID"},
     cid="dilation2d-valid", **SUM)

# -- pools ----------------------------------------------------------------
case("maxpool3dnew", [F(2, 2, 5, 6, 5)], {"kernel": (2, 2, 2)})
case("maxpool3d", [F(2, 2, 5, 6, 5)],
     {"kernel": (3, 3, 3), "strides": (2, 2, 2), "padding": "SAME"},
     cid="maxpool3d(alias)-same")
case("maxpool3dnew", [F(1, 5, 4, 5, 2)],
     {"kernel": (2, 2, 2), "strides": (1, 2, 2), "padding": 1,
      "data_format": "NDHWC"}, cid="maxpool3dnew-ndhwc-pad")
case("avgpool3dnew", [F(2, 2, 5, 6, 5)], {"kernel": (2, 2, 2)}, **SUM)
case("avgpool3d", [F(2, 2, 5, 6, 5)],
     {"kernel": (3, 3, 3), "strides": (2, 2, 2), "padding": "SAME",
      "include_pad": False}, cid="avgpool3d(alias)-same-counted", **SUM)
case("avgpool3dnew", [F(2, 2, 5, 6, 5)],
     {"kernel": (3, 3, 3), "strides": (2, 2, 2), "padding": "SAME"},
     cid="avgpool3dnew-same-include-pad", **SUM)
case("max_pool_with_argmax", [F(2, 5, 7, 3)],
     {"kernel": (2, 2), "padding": "SAME"})
case("max_pool_with_argmax", [F(2, 6, 7, 3)],
     {"kernel": (3, 3), "strides": (2, 2)}, cid="max_pool_with_argmax-valid")
# equal values in a window: the index of the first offset
case("max_pool_with_argmax", [TIES(2, 6, 6, 3)],
     {"kernel": (2, 3), "strides": (2, 1)}, cid="max_pool_with_argmax-ties")

# -- upsampling, patches --------------------------------------------------
case("upsampling2d", [F(2, 3, 3, 4)], {"factor_h": 2, "factor_w": 3})
case("upsampling2d", [F(2, 3, 4, 3)], {"data_format": "NHWC"},
     cid="upsampling2d-nhwc")
case("upsampling3d", [F(1, 2, 2, 3, 2)], {"fd": 2, "fh": 1, "fw": 3})
case("upsampling3d", [F(1, 2, 3, 2, 2)], {"data_format": "NDHWC"},
     cid="upsampling3d-ndhwc")
case("im2col", [F(2, 3, 6, 7)],
     {"kh": 3, "kw": 2, "sh": 2, "sw": 1, "ph": 1, "pw": 0, "dh": 1,
      "dw": 2})
case("col2im", [F(2, 3, 3, 2, 3, 5)],
     {"sh": 2, "sw": 1, "ph": 1, "pw": 0, "h": 6, "w": 7, "dh": 1,
      "dw": 2}, **SUM)
# "SAME" pads k // 2 on both sides: 5x5 with a 2x2 kernel gives 6x6
case("extract_image_patches", [F(2, 5, 5, 3)],
     {"ksizes": (2, 2), "strides": (1, 1), "rates": (1, 1),
      "padding": "SAME"})
case("extract_image_patches", [F(2, 7, 8, 2)],
     {"ksizes": (3, 2), "strides": (2, 1), "rates": (1, 2)},
     cid="extract_image_patches-valid")

# -- colour ---------------------------------------------------------------
for _n in ("rgb_to_yiq", "yiq_to_rgb", "rgb_to_yuv", "yuv_to_rgb",
           "rgb_to_grs"):
    case(_n, [UNIT(2, 4, 5, 3)], **SUM)
case("rgb_to_hsv", [UNIT(2, 4, 5, 3)])
case("hsv_to_rgb", [UNIT(2, 4, 5, 3)])
case("adjust_contrast", [UNIT(2, 4, 5, 3)], {"factor": 1.7}, **SUM)
case("adjust_contrast_v2", [UNIT(4, 5, 3)], {"factor": 0.4},
     cid="adjust_contrast_v2(alias)", **SUM)
case("adjust_saturation", [UNIT(2, 4, 5, 3)], {"factor": 0.6}, **SUM)
case("adjust_hue", [UNIT(2, 4, 5, 3)], {"delta": 0.3}, **SUM)

# -- resizes: every method, down and up -----------------------------------
for _name, _kind in (("resize_bilinear", "linear"),
                     ("resize_nearest_neighbor", "nearest"),
                     ("resize_bicubic", "cubic"), ("resize_area", "area")):
    case(_name, [F(2, 9, 10, 3)], {"size": (4, 6)}, cid=f"{_name}-down",
         **SUM)
    case(_name, [F(2, 4, 5, 3)], {"height": 7, "width": 9},
         cid=f"{_name}-up", **SUM)
for _m in ("bilinear", "bicubic", "nearest", "area", "lanczos3",
           "lanczos5", 1, "mitchellcubic"):
    case("image_resize", [F(9, 10, 3)], {"size": (4, 6), "method": _m},
         cid=f"image_resize-{_m}-down", **SUM)
    case("image_resize", [F(2, 4, 5, 3)], {"size": (7, 9), "method": _m},
         cid=f"image_resize-{_m}-up", **SUM)
case("resize_images", [F(2, 6, 5, 3)], {"size": (6, 11)},
     cid="resize_images(alias)-one-axis", **SUM)
case("crop_and_resize", [F(2, 6, 7, 3), BOXES(3), I(3, hi=2), K((3, 4))],
     **SUM)
case("crop_and_resize", [F(2, 6, 7, 3), BOXES(3), I(3, hi=2), K((4, 1))],
     {"method": "nearest"}, cid="crop_and_resize-nearest", grad_args=[0])

# -- detection ------------------------------------------------------------
case("non_max_suppression", [BOXES(9), TIES(9), K(4)],
     {"iou_threshold": 0.3})
case("non_max_suppression_v3", [BOXES(7), TIES(7), K(9)],
     {"iou_threshold": 0.5, "score_threshold": 0.5},
     cid="non_max_suppression_v3(alias)-threshold")
case("non_max_suppression_overlaps", [UNIT(8, 8), TIES(8), K(3)],
     {"overlap_threshold": 0.6})
case("draw_bounding_boxes", [F(2, 6, 7, 3), BOXES(2, 3)])
case("draw_bounding_boxes", [F(2, 6, 7, 3), BOXES(2, 3), UNIT(3, 3)],
     cid="draw_bounding_boxes-colors")


@pytest.mark.parametrize("op_name,inputs,kwargs,opts", CASES)
def test_conv_image_op_matches_jax(op_name, inputs, kwargs, opts):
    _op_matches(op_name, inputs, kwargs, opts)


_FAMILY_CATEGORIES = ("conv", "pooling", "images")
#: the bp ops of these families that test_torch_ops.py holds (their
#: forwards were ported with the layer API's first slice)
_HELD_IN_OPS = {"conv2d_bp", "maxpool2d_bp", "avgpool2d_bp",
                "pnormpool2d_bp"}


def _bp_cases():
    by_op = {}
    for p in CASES:
        op_name, inputs, kwargs, opts = p.values
        by_op.setdefault(TREG.lookup(op_name).name, (inputs, kwargs, opts))
    out = []
    for name in TREG.by_category("autodiff_bp"):
        base = name[:-3] if name.endswith("_bp") else name[:-5]
        if base in by_op:
            out.append(pytest.param(name, base, *by_op[base], id=name))
    return out


BP_CASES = _bp_cases()


def test_every_family_name_is_registered_and_each_bp_op_has_a_case():
    jreg = JReg.get()
    jfam = {n for c in _FAMILY_CATEGORIES for n in jreg.by_category(c)}
    assert all(TREG.has(n) for n in jfam)
    names = {p.values[0] for p in CASES}
    fam = {n for c in _FAMILY_CATEGORIES for n in TREG.by_category(c)}
    assert fam == jfam
    # every registered name of the two families (aliases included), less
    # the four forwards test_torch_ops.py holds and parity_extra's two
    # "conv" ops that test_torch_op_tail.py holds, has a case here
    aliases = {a for n in fam for a in TREG.lookup(n).aliases}
    assert (fam | aliases) - names == {"conv2d", "maxpool2d", "avgpool2d",
                                       "pnormpool2d", "deconv2d_tf",
                                       "conv2d_input_bp"}
    bps = {n for n in TREG.by_category("autodiff_bp")
           if (n[:-3] if n.endswith("_bp") else n[:-5]) in fam}
    covered = {p.values[0] for p in BP_CASES}
    assert bps - covered == _HELD_IN_OPS and covered == BP_CONV_IMAGE


@pytest.mark.parametrize("name,base,inputs,kwargs,opts", BP_CASES)
def test_conv_image_bp_op_matches_jax(name, base, inputs, kwargs, opts):
    _bp_matches(name, base, inputs, kwargs, opts)


def test_samediff_namespaces_reach_the_ops_by_the_jax_aliases():
    """``sd.cnn.conv3d`` / ``sd.cnn.separable_conv2d`` (the JAX
    namespaces' aliases of ``conv3dnew`` / ``sconv2d``) and
    ``sd.image.resize_bilinear`` record the ops and evaluate as the JAX
    SameDiff's."""
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
    from deeplearning4j_tpu_torch.autodiff.samediff import \
        SameDiff as TSameDiff
    r = np.random.RandomState(0)
    arrays = [F(1, 2, 4, 5, 4)(r), F(2, 3, 2, 2, 3)(r), F(2, 3, 6, 5)(r),
              F(3, 3, 3, 2)(r), F(1, 1, 6, 4)(r), F(2, 6, 7, 3)(r)]

    def record(sd):
        c = [sd.constant(a) for a in arrays]
        return [sd.cnn.conv3d(c[0], c[1], strides=(2, 1, 2)),
                sd.cnn.separable_conv2d(c[2], c[3], c[4], strides=(2, 2)),
                sd.image.resize_bilinear(c[5], size=(4, 9))]

    def np_(a):
        return np.asarray(a.numpy() if hasattr(a, "numpy") else a)

    jouts = [np_(v.eval()) for v in record(JSameDiff.create())]
    touts = [np_(v.eval()) for v in record(TSameDiff.create(device="cpu"))]
    assert [j.shape for j in jouts] == [(1, 3, 2, 5, 2), (2, 4, 3, 3),
                                        (2, 4, 9, 3)]
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t, j, **SUM)
