"""TF op mapping rules — the long tail of the reference ruleset.

Counterpart of ``deeplearning4j_tpu/modelimport/tf/mappings_extra.py``,
rule for rule; its raw functions (fake-quant's nudged rounding and the
argument-order adapters) are torch functions here. Covers the remaining `inputFrameworkOpName` entries of
`nd4j/samediff-import/samediff-import-tensorflow/src/main/resources/
tensorflow-mapping-ruleset.pbtxt` beyond the core set in ``mappings.py``:
linalg, scatter/segment, image, random, quantization, bitwise, 3-D
conv/pool, block RNN cells, and loss ops.  Shape-ish constant inputs fold
to static kwargs (the graph keeps static shapes); dynamic-output ops
(Unique, Where, ListDiff, ...) are documented exemptions in
``coverage.py`` rather than silent failures.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir import Aval, IRNode, ImportContext, ImportException, mapper
from .mappings import TF, _ins, _conv_attrs, _simple, _dtype_name


def _const_i(ctx, name):
    return int(np.asarray(ctx.const_value(name)))


def _const_f(ctx, name):
    return float(np.asarray(ctx.const_value(name)))


def _const_list(ctx, name):
    return [int(v) for v in np.atleast_1d(np.asarray(ctx.const_value(name)))]


def _attr_scalar(v, default=None):
    return default if v is None else (v.decode() if isinstance(v, bytes)
                                      else v)


def _port_consumed(ctx, node, port):
    t = f"{node.name}:{port}"
    return any(t in n.inputs for n in ctx.graph.nodes)


def _emit_fn(ctx, fn, inputs, out_tensor, label, needs_key=False, **kwargs):
    """Record a non-registry callable (arg-order adapter) as a graph node."""
    out = ctx.sd._record_fn(fn, list(inputs), label=label,
                            out_name=out_tensor.replace(":", "_"),
                            needs_key=needs_key, **kwargs)
    ctx.bind(out_tensor, out)
    return out


def _reg_fn(name):
    from ...ops.registry import OpRegistry
    return OpRegistry.get().lookup(name).fn


# -- simple elementwise / linalg aliases ----------------------------------
for _tf, _op in [
    ("AccumulateNV2", "mergeadd"),
    ("BitwiseAnd", "bitwise_and"), ("BitwiseOr", "bitwise_or"),
    ("BitwiseXor", "bitwise_xor"), ("Invert", "toggle_bits"),
    ("LeftShift", "shift_bits"), ("RightShift", "rshift_bits"),
    ("IsFinite", "isfinite"), ("IsInf", "isinf"), ("IsNan", "isnan"),
    ("Igamma", "igamma"), ("Igammac", "igammac"), ("Betainc", "betainc"),
    ("Polygamma", "polygamma"), ("Zeta", "zeta"),
    ("Cholesky", "cholesky"),
    ("MatrixInverse", "matrix_inverse"),
    ("BatchMatrixInverse", "matrix_inverse"),
    ("MatrixDeterminant", "matrix_determinant"),
    ("BatchMatrixDeterminant", "matrix_determinant"),
    ("MatrixDiag", "matrix_diag"), ("MatrixDiagPart", "matrix_diag_part"),
    ("MatrixSetDiag", "matrix_set_diag"),
    ("BatchMatrixSetDiag", "matrix_set_diag"),
    ("Diag", "diag"), ("DiagPart", "diag_part"),
    ("HSVToRGB", "hsv_to_rgb"), ("RGBToHSV", "rgb_to_hsv"),
    ("ClipByValue", "clip_by_value"),
    ("Cross", "cross"),
]:
    _simple(_tf, _op)


@mapper(TF, "CheckNumericsV2", "Copy", "CopyHost", "DeepCopy")
def _identity_like(node, ctx):
    src = node.inputs[0]
    if src in ctx.const_np:
        ctx.const_np[node.outputs[0]] = ctx.const_np[src]
    else:
        ctx.bind(node.outputs[0], ctx.get(src), aval=ctx.aval(src))


@mapper(TF, "Assert")
def _assert(node, ctx):
    pass  # graph-mode assertion; imported graphs carry no side effects


@mapper(TF, "Assign")
def _assign(node, ctx):
    # frozen inference graphs keep Assign only as an init artifact; its
    # value output aliases the assigned value (reference maps it to identity)
    src = node.inputs[1] if len(node.inputs) > 1 else node.inputs[0]
    if src in ctx.const_np:
        ctx.const_np[node.outputs[0]] = ctx.const_np[src]
    else:
        ctx.bind(node.outputs[0], ctx.get(src), aval=ctx.aval(src))


@mapper(TF, "ApproximateEqual")
def _approx_equal(node, ctx):
    a, b = _ins(node, ctx)
    tol = float(node.attrs.get("tolerance", 1e-5))
    d = ctx.emit("subtract", [a, b], f"{node.name}__d")
    ad = ctx.emit("abs", [d], f"{node.name}__ad")
    t = ctx.sd.constant(np.float32(tol), f"{node.name}__tol")
    ctx.emit("less", [ad, t], node.outputs[0])


# -- shape/layout ---------------------------------------------------------
@mapper(TF, "BroadcastTo")
def _broadcast_to(node, ctx):
    x = ctx.get(node.inputs[0])
    shape = tuple(_const_list(ctx, node.inputs[1]))
    ctx.emit("broadcast_to", [x], node.outputs[0], shape=shape)


@mapper(TF, "BroadcastArgs")
def _broadcast_args(node, ctx):
    s0 = tuple(_const_list(ctx, node.inputs[0]))
    s1 = tuple(_const_list(ctx, node.inputs[1]))
    ctx.const_np[node.outputs[0]] = np.asarray(
        np.broadcast_shapes(s0, s1), np.int32)


@mapper(TF, "ShapeN")
def _shape_n(node, ctx):
    for i, src in enumerate(node.inputs):
        a = ctx.aval(src)
        if a is None:
            raise ImportException(
                f"ShapeN({src!r}) needs a static input shape")
        val = np.asarray(a.shape, np.int32)
        ctx.const_np[f"{node.name}:{i}"] = val
        if i == 0:
            ctx.const_np[node.outputs[0]] = val


@mapper(TF, "Empty")
def _empty(node, ctx):
    shape = tuple(_const_list(ctx, node.inputs[0]))
    ctx.const_np[node.outputs[0]] = np.zeros(
        shape, np.dtype(_dtype_name(node.attrs.get("dtype"))))


@mapper(TF, "DepthToSpace", "SpaceToDepth")
def _depth_space(node, ctx):
    op = ("depth_to_space" if node.op_type == "DepthToSpace"
          else "space_to_depth")
    df = _attr_scalar(node.attrs.get("data_format"), "NHWC")
    ctx.emit(op, _ins(node, ctx), node.outputs[0],
             block_size=int(node.attrs.get("block_size", 2)),
             data_format=df)


@mapper(TF, "BatchToSpaceND", "BatchToSpace")
def _batch_to_space(node, ctx):
    x = ctx.get(node.inputs[0])
    if node.op_type == "BatchToSpace":  # block_size attr, crops input
        bs = int(node.attrs.get("block_size", 2))
        block = [bs, bs]
        crops = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    else:
        block = _const_list(ctx, node.inputs[1])
        crops = np.asarray(ctx.const_value(node.inputs[2])).tolist()
    ctx.emit("batch_to_space", [x], node.outputs[0], block_shape=block,
             crops=crops)


@mapper(TF, "SpaceToBatchND", "SpaceToBatch")
def _space_to_batch(node, ctx):
    x = ctx.get(node.inputs[0])
    if node.op_type == "SpaceToBatch":
        bs = int(node.attrs.get("block_size", 2))
        block = [bs, bs]
        pads = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    else:
        block = _const_list(ctx, node.inputs[1])
        pads = np.asarray(ctx.const_value(node.inputs[2])).tolist()
    ctx.emit("space_to_batch", [x], node.outputs[0], block_shape=block,
             paddings=pads)


@mapper(TF, "ReverseV2")
def _reverse_v2(node, ctx):
    x = ctx.get(node.inputs[0])
    dims = _const_list(ctx, node.inputs[1])
    ctx.emit("reverse", [x], node.outputs[0], dims=tuple(dims))


@mapper(TF, "ReverseSequence")
def _reverse_sequence(node, ctx):
    x, lens = _ins(node, ctx)
    ctx.emit("reverse_sequence", [x, lens], node.outputs[0],
             seq_axis=int(node.attrs.get("seq_dim", 0)),
             batch_axis=int(node.attrs.get("batch_dim", 0)))


@mapper(TF, "Roll")
def _roll(node, ctx):
    x = ctx.get(node.inputs[0])
    shift = _const_list(ctx, node.inputs[1])
    axis = _const_list(ctx, node.inputs[2])
    ctx.emit("roll", [x], node.outputs[0],
             shift=shift if len(shift) > 1 else shift[0],
             axis=axis if len(axis) > 1 else axis[0])


@mapper(TF, "ParallelConcat")
def _parallel_concat(node, ctx):
    ctx.emit("concat", _ins(node, ctx), node.outputs[0], axis=0)


@mapper(TF, "Cumprod")
def _cumprod(node, ctx):
    x = ctx.get(node.inputs[0])
    axis = _const_i(ctx, node.inputs[1])
    ctx.emit("cumprod", [x], node.outputs[0], axis=axis,
             exclusive=bool(node.attrs.get("exclusive", False)),
             reverse=bool(node.attrs.get("reverse", False)))


@mapper(TF, "LinSpace")
def _lin_space(node, ctx):
    start = _const_f(ctx, node.inputs[0])
    stop = _const_f(ctx, node.inputs[1])
    num = _const_i(ctx, node.inputs[2])
    ctx.const_np[node.outputs[0]] = np.linspace(
        start, stop, num, dtype=np.float32)


@mapper(TF, "Bincount")
def _bincount(node, ctx):
    # Bincount(arr, size, weights): output length == size (static const).
    # Weights may be a runtime tensor; only *emptiness* must be static.
    arr = ctx.get(node.inputs[0])
    size = _const_i(ctx, node.inputs[1])
    ins = [arr]
    out_dtype = None
    if len(node.inputs) > 2:
        w_aval = ctx.aval(node.inputs[2])
        if w_aval is None:
            raise ImportException(
                "Bincount: cannot determine statically whether the weights "
                f"input {node.inputs[2]!r} is empty (unknown shape); TF "
                "treats empty weights as unweighted, which changes semantics")
        if int(np.prod(w_aval.shape)) > 0:
            ins.append(ctx.get(node.inputs[2]))
        else:
            # empty weights: unweighted counting, but the output dtype
            # still follows T (the weights dtype)
            out_dtype = np.dtype(w_aval.dtype).name
    if out_dtype is not None and not np.issubdtype(
            np.dtype(out_dtype), np.integer):
        cnt = ctx.emit("bincount", ins, f"{node.name}__counts",
                       minlength=size, maxlength=size)
        ctx.emit("cast", [cnt], node.outputs[0], dtype=out_dtype)
        return
    ctx.emit("bincount", ins, node.outputs[0], minlength=size,
             maxlength=size)


@mapper(TF, "HistogramFixedWidth")
def _histogram(node, ctx):
    x = ctx.get(node.inputs[0])
    lo, hi = (float(v) for v in
              np.asarray(ctx.const_value(node.inputs[1])).ravel()[:2])
    nbins = _const_i(ctx, node.inputs[2]) if len(node.inputs) > 2 else 100
    hist = _reg_fn("histogram_fixed_width")
    _emit_fn(ctx, lambda v: hist(v, (lo, hi), nbins), [x],
             node.outputs[0], "histogram_fixed_width")


@mapper(TF, "Bitcast")
def _bitcast(node, ctx):
    ctx.emit("bitcast", _ins(node, ctx), node.outputs[0],
             dtype=_dtype_name(node.attrs.get("type")))


@mapper(TF, "CompareAndBitpack")
def _compare_bitpack(node, ctx):
    ctx.emit("compare_and_bitpack", _ins(node, ctx), node.outputs[0])


# -- linalg multi-output --------------------------------------------------
@mapper(TF, "LogMatrixDeterminant")
def _log_matrix_det(node, ctx):
    x = ctx.get(node.inputs[0])
    det = ctx.emit("matrix_determinant", [x], f"{node.name}__det")
    ctx.emit("sign", [det], node.outputs[0])
    ad = ctx.emit("abs", [det], f"{node.name}__absdet")
    ctx.emit("log", [ad], f"{node.name}:1")


@mapper(TF, "Lu")
def _lu(node, ctx):
    x = ctx.get(node.inputs[0])
    outs = [node.outputs[0], f"{node.name}:1"]
    ctx.emit_multi("lu", [x], outs)


@mapper(TF, "Svd")
def _svd(node, ctx):
    x = ctx.get(node.inputs[0])
    full = bool(node.attrs.get("full_matrices", False))
    if not bool(node.attrs.get("compute_uv", True)):
        # registry svd(compute_uv=False) returns s only
        ctx.emit("svd", [x], node.outputs[0], full_matrices=full,
                 compute_uv=False)
        return
    # registry order (u, s, vh); TF order (s, u, v) with v un-transposed
    tmp = [f"{node.name}__u", f"{node.name}__s", f"{node.name}__vh"]
    u, s, vh = ctx.emit_multi("svd", [x], tmp, full_matrices=full)
    ctx.bind(node.outputs[0], s, aval=ctx.aval(tmp[1]))
    ctx.bind(f"{node.name}:1", u, aval=ctx.aval(tmp[0]))
    rank = len(ctx.aval(node.inputs[0]).shape) \
        if ctx.aval(node.inputs[0]) else 2
    perm = list(range(rank - 2)) + [rank - 1, rank - 2]
    ctx.emit("transpose", [vh], f"{node.name}:2", axes=tuple(perm))


@mapper(TF, "MatrixSolve")
def _matrix_solve(node, ctx):
    a, b = _ins(node, ctx)
    ctx.emit("solve", [a, b], node.outputs[0],
             adjoint=bool(node.attrs.get("adjoint", False)))


@mapper(TF, "MatrixTriangularSolve")
def _triangular_solve(node, ctx):
    a, b = _ins(node, ctx)
    ctx.emit("triangular_solve", [a, b], node.outputs[0],
             lower=bool(node.attrs.get("lower", True)),
             adjoint=bool(node.attrs.get("adjoint", False)))


@mapper(TF, "MatrixBandPart")
def _band_part(node, ctx):
    x = ctx.get(node.inputs[0])
    lo = _const_i(ctx, node.inputs[1])
    hi = _const_i(ctx, node.inputs[2])
    ctx.emit("matrix_band_part", [x], node.outputs[0], num_lower=lo,
             num_upper=hi)


# -- scatter / segment ----------------------------------------------------
@mapper(TF, "ScatterNd")
def _scatter_nd(node, ctx):
    idx, upd = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    shape = tuple(_const_list(ctx, node.inputs[2]))
    ctx.emit("scatter_nd", [idx, upd], node.outputs[0], shape=shape)


for _tf, _op in [
    ("ScatterAdd", "scatter_add"), ("ScatterSub", "scatter_sub"),
    ("ScatterMul", "scatter_mul"), ("ScatterDiv", "scatter_div"),
    ("ScatterMax", "scatter_max"), ("ScatterMin", "scatter_min"),
    ("ScatterUpdate", "scatter_upd"),
    ("ScatterNdAdd", "scatter_nd_add"), ("ScatterNdSub", "scatter_nd_sub"),
    ("ScatterNdUpdate", "scatter_nd_update"),
    ("TensorScatterAdd", "scatter_nd_add"),
    ("TensorScatterSub", "scatter_nd_sub"),
    ("TensorScatterUpdate", "scatter_nd_update"),
    ("TensorScatterMax", "scatter_nd_max"),
    ("TensorScatterMin", "scatter_nd_min"),
]:
    _simple(_tf, _op)


def _segment(tf_name, op_name, unsorted=False):
    @mapper(TF, tf_name)
    def _m(node, ctx, _op=op_name, _uns=unsorted):
        data, ids = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
        if _uns:
            n = _const_i(ctx, node.inputs[2])
        else:
            # sorted Segment*: output rows = max(id)+1, data-dependent
            # unless the ids are graph constants (the usual export shape)
            ids_np = ctx.maybe_const(node.inputs[1])
            if ids_np is None:
                raise ImportException(
                    f"{tf_name} {node.name!r}: segment_ids must be graph "
                    f"constants (output shape is data-dependent)")
            n = int(np.max(ids_np)) + 1
        ctx.emit(_op, [data, ids], node.outputs[0], num_segments=n)
    return _m


for _tf, _op in [("SegmentMax", "segment_max"), ("SegmentMean", "segment_mean"),
                 ("SegmentMin", "segment_min"), ("SegmentProd", "segment_prod"),
                 ("SegmentSum", "segment_sum")]:
    _segment(_tf, _op)
for _tf, _op in [("UnsortedSegmentMax", "unsorted_segment_max"),
                 ("UnsortedSegmentMin", "unsorted_segment_min"),
                 ("UnsortedSegmentProd", "unsorted_segment_prod"),
                 ("UnsortedSegmentSum", "unsorted_segment_sum")]:
    _segment(_tf, _op, unsorted=True)


@mapper(TF, "DynamicPartition")
def _dynamic_partition(node, ctx):
    # partition sizes are data-dependent; static only when the partition
    # vector is a graph constant — then each partition is a static gather
    parts_np = ctx.maybe_const(node.inputs[1])
    if parts_np is None:
        raise ImportException(
            f"DynamicPartition {node.name!r}: partitions must be graph "
            f"constants (output shapes are data-dependent)")
    x = ctx.get(node.inputs[0])
    n = int(node.attrs.get("num_partitions", 1))
    flat = np.asarray(parts_np).ravel()
    for i in range(n):
        sel = np.nonzero(flat == i)[0].astype(np.int32)
        idx = ctx.sd.constant(sel, f"{node.name}__idx{i}")
        out = node.outputs[0] if i == 0 else f"{node.name}:{i}"
        ctx.emit("gather", [x, idx], out, axis=0)


@mapper(TF, "DynamicStitch", "ParallelDynamicStitch")
def _dynamic_stitch(node, ctx):
    n = len(node.inputs) // 2
    stitch = _reg_fn("dynamic_stitch")

    def fn(*args, _n=n, _stitch=stitch):
        return _stitch(list(args[:_n]), list(args[_n:]))

    _emit_fn(ctx, fn, [ctx.get(i) for i in node.inputs], node.outputs[0],
             "dynamic_stitch")


# -- image ----------------------------------------------------------------
def _resize(tf_name, op_name):
    @mapper(TF, tf_name)
    def _m(node, ctx, _op=op_name):
        x = ctx.get(node.inputs[0])
        size = _const_list(ctx, node.inputs[1])
        ctx.emit(_op, [x], node.outputs[0], size=tuple(size),
                 align_corners=bool(node.attrs.get("align_corners", False)),
                 half_pixel_centers=bool(
                     node.attrs.get("half_pixel_centers", False)))
    return _m


for _tf, _op in [("ResizeArea", "resize_area"),
                 ("ResizeBicubic", "resize_bicubic"),
                 ("ResizeBilinear", "resize_bilinear"),
                 ("ResizeNearestNeighbor", "resize_nearest_neighbor")]:
    _resize(_tf, _op)


@mapper(TF, "CropAndResize")
def _crop_and_resize(node, ctx):
    img, boxes, box_ind = (ctx.get(node.inputs[i]) for i in range(3))
    crop_size = tuple(_const_list(ctx, node.inputs[3]))
    method = _attr_scalar(node.attrs.get("method"), "bilinear")
    ctx.emit("crop_and_resize", [img, boxes, box_ind], node.outputs[0],
             crop_size=crop_size, method=method,
             extrapolation_value=float(
                 node.attrs.get("extrapolation_value", 0.0)))


@mapper(TF, "ExtractImagePatches")
def _extract_patches(node, ctx):
    x = ctx.get(node.inputs[0])
    pad = _attr_scalar(node.attrs.get("padding"), "VALID")
    ks = [int(v) for v in node.attrs.get("ksizes", [1, 1, 1, 1])]
    st = [int(v) for v in node.attrs.get("strides", [1, 1, 1, 1])]
    rt = [int(v) for v in node.attrs.get("rates", [1, 1, 1, 1])]
    ctx.emit("extract_image_patches", [x], node.outputs[0],
             ksizes=ks[1:3], strides=st[1:3], rates=rt[1:3], padding=pad)


@mapper(TF, "AdjustContrastv2")
def _adjust_contrast(node, ctx):
    x, f = _ins(node, ctx)
    ctx.emit("adjust_contrast", [x, f], node.outputs[0])


@mapper(TF, "AdjustHue")
def _adjust_hue(node, ctx):
    x, d = _ins(node, ctx)
    ctx.emit("adjust_hue", [x, d], node.outputs[0])


@mapper(TF, "AdjustSaturation")
def _adjust_saturation(node, ctx):
    x, f = _ins(node, ctx)
    ctx.emit("adjust_saturation", [x, f], node.outputs[0])


@mapper(TF, "DrawBoundingBoxesV2", "DrawBoundingBoxes")
def _draw_boxes(node, ctx):
    ctx.emit("draw_bounding_boxes", _ins(node, ctx), node.outputs[0])


@mapper(TF, "NonMaxSuppression", "NonMaxSuppressionV2",
        "NonMaxSuppressionV3")
def _nms(node, ctx):
    boxes, scores = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    max_out = _const_i(ctx, node.inputs[2])
    if node.op_type == "NonMaxSuppression":
        iou = float(node.attrs.get("iou_threshold", 0.5))
    else:
        iou = _const_f(ctx, node.inputs[3])
    score = -np.inf
    if node.op_type == "NonMaxSuppressionV3" and len(node.inputs) > 4:
        score = _const_f(ctx, node.inputs[4])
    ctx.emit("non_max_suppression", [boxes, scores], node.outputs[0],
             max_output_size=max_out, iou_threshold=iou,
             score_threshold=score)


@mapper(TF, "NonMaxSuppressionV4")
def _nms_v4(node, ctx):
    # static-shape NMS: indices padded to max_output_size with -1 plus a
    # valid-count output — TF's pad_to_max_output_size=True contract
    boxes, scores = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    max_out = _const_i(ctx, node.inputs[2])
    iou = _const_f(ctx, node.inputs[3])
    score = _const_f(ctx, node.inputs[4]) if len(node.inputs) > 4 else -np.inf
    idx = ctx.emit("non_max_suppression", [boxes, scores],
                   f"{node.name}__rawidx",
                   max_output_size=max_out, iou_threshold=iou,
                   score_threshold=score)
    zero = ctx.sd.constant(np.int32(0), f"{node.name}__zero")
    # register the scalar's aval so downstream emits keep static shapes
    ctx.bind(f"{node.name}__zero", zero, aval=Aval((), np.dtype(np.int32)))
    valid = ctx.emit("greater_equal", [idx, zero], f"{node.name}__valid")
    vi = ctx.emit("cast", [valid], f"{node.name}__vi", dtype="int32")
    ctx.emit("reduce_sum", [vi], f"{node.name}:1")
    # TF pads with 0, not -1 (gather with padded indices must hit row 0,
    # not wrap to the last row as a negative index would)
    ctx.emit("maximum", [idx, zero], node.outputs[0])


@mapper(TF, "NonMaxSuppressionWithOverlaps")
def _nms_overlaps(node, ctx):
    ov, scores = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    max_out = _const_i(ctx, node.inputs[2])
    thr = _const_f(ctx, node.inputs[3])
    score = _const_f(ctx, node.inputs[4]) if len(node.inputs) > 4 else -np.inf
    ctx.emit("non_max_suppression_overlaps", [ov, scores], node.outputs[0],
             max_output_size=max_out, overlap_threshold=thr,
             score_threshold=score)


# -- quantization ---------------------------------------------------------
def _nudged_range(mn, mx, num_bits, narrow_range):
    """TF's quantization-range nudge, in float32 exactly like the kernel
    (fake_quant_ops_functor.h) — the f32 rounding of min/scale decides
    whether a half-integer zero point nudges up or down, so this runs on
    the host in numpy float32."""
    qmin = np.float32(1.0 if narrow_range else 0.0)
    qmax = np.float32(2 ** int(num_bits) - 1)
    mn, mx = np.float32(mn), np.float32(mx)
    scale = (mx - mn) / (qmax - qmin)
    zp = qmin - mn / scale
    # std::round = half-away-from-zero (zp >= qmin >= 0 here), NOT
    # numpy's round-half-to-even
    nzp = np.float32(qmin if zp < qmin else qmax if zp > qmax
                     else np.floor(zp + np.float32(0.5)))
    return ((qmin - nzp) * scale, (qmax - nzp) * scale, scale)


def _emit_fake_quant_static(ctx, node, x, mn, mx):
    nmin, nmax, scale = _nudged_range(
        mn, mx, int(node.attrs.get("num_bits", 8)),
        bool(node.attrs.get("narrow_range", False)))
    inv = np.float32(1.0) / scale

    def fn(v, _nmin=nmin, _nmax=nmax, _scale=scale, _inv=inv):
        clamped = torch.clamp(v, float(_nmin), float(_nmax))
        return torch.round((clamped - float(_nmin)) * float(_inv)) \
            * float(_scale) + float(_nmin)

    _emit_fn(ctx, fn, [x], node.outputs[0], "fake_quant")


@mapper(TF, "FakeQuantWithMinMaxArgs")
def _fake_quant_args(node, ctx):
    x = ctx.get(node.inputs[0])
    _emit_fake_quant_static(ctx, node, x,
                            float(node.attrs.get("min", -6.0)),
                            float(node.attrs.get("max", 6.0)))


@mapper(TF, "FakeQuantWithMinMaxVars", "FakeQuantWithMinMaxVarsPerChannel")
def _fake_quant_vars(node, ctx):
    mn = ctx.maybe_const(node.inputs[1])
    mx = ctx.maybe_const(node.inputs[2])
    if node.op_type == "FakeQuantWithMinMaxVars" and mn is not None \
            and mx is not None and np.asarray(mn).ndim == 0:
        _emit_fake_quant_static(ctx, node, ctx.get(node.inputs[0]),
                                float(mn), float(mx))
        return
    op = ("fake_quant_with_min_max_vars"
          if node.op_type == "FakeQuantWithMinMaxVars"
          else "fake_quant_with_min_max_vars_per_channel")
    ctx.emit(op, _ins(node, ctx), node.outputs[0],
             num_bits=int(node.attrs.get("num_bits", 8)),
             narrow_range=bool(node.attrs.get("narrow_range", False)))


# -- topk / selection -----------------------------------------------------
@mapper(TF, "TopK", "TopKV2")
def _top_k(node, ctx):
    x = ctx.get(node.inputs[0])
    if node.op_type == "TopKV2":
        k = _const_i(ctx, node.inputs[1])
    else:
        k = int(node.attrs.get("k", 1))
    outs = [node.outputs[0], f"{node.name}:1"]
    ctx.emit_multi("top_k", [x], outs, k=k,
                   sorted=bool(node.attrs.get("sorted", True)))


@mapper(TF, "InTopK", "InTopKV2")
def _in_top_k(node, ctx):
    pred, targ = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    if node.op_type == "InTopKV2":
        k = _const_i(ctx, node.inputs[2])
    else:
        k = int(node.attrs.get("k", 1))
    ctx.emit("in_top_k", [pred, targ], node.outputs[0], k=k)


@mapper(TF, "NthElement")
def _nth_element(node, ctx):
    x = ctx.get(node.inputs[0])
    n = _const_i(ctx, node.inputs[1])
    ctx.emit("nth_element", [x], node.outputs[0], n=n,
             reverse=bool(node.attrs.get("reverse", False)))


# -- nn: conv3d / pool3d / misc -------------------------------------------
@mapper(TF, "Conv3D")
def _conv3d(node, ctx):
    x, w = _ins(node, ctx)
    df, strides, dil, padding = _conv_attrs(node, n=3)
    ctx.emit("conv3d", [x, w], node.outputs[0], strides=strides,
             padding=padding, dilation=dil, data_format=df)


@mapper(TF, "MaxPool3D", "AvgPool3D")
def _pool3d(node, ctx):
    x = ctx.get(node.inputs[0])
    df = _attr_scalar(node.attrs.get("data_format"), "NDHWC")
    ks = node.attrs.get("ksize", [1] * 5)
    st = node.attrs.get("strides", [1] * 5)
    if df.startswith("NC"):
        kernel, strides = ks[2:5], st[2:5]
    else:
        kernel, strides = ks[1:4], st[1:4]
    ctx.emit("maxpool3d" if node.op_type == "MaxPool3D" else "avgpool3d",
             [x], node.outputs[0], kernel=tuple(int(k) for k in kernel),
             strides=tuple(int(s) for s in strides),
             padding=_attr_scalar(node.attrs.get("padding"), "VALID"),
             data_format=df)


@mapper(TF, "MaxPoolV2")
def _maxpool_v2(node, ctx):
    x = ctx.get(node.inputs[0])
    ks = _const_list(ctx, node.inputs[1])
    st = _const_list(ctx, node.inputs[2])
    df = _attr_scalar(node.attrs.get("data_format"), "NHWC")
    if df.startswith("NC"):
        kernel, strides = ks[2:4], st[2:4]
    else:
        kernel, strides = ks[1:3], st[1:3]
    ctx.emit("maxpool2d", [x], node.outputs[0], kernel=tuple(kernel),
             strides=tuple(strides),
             padding=_attr_scalar(node.attrs.get("padding"), "VALID"),
             data_format=df)


@mapper(TF, "MaxPoolWithArgmax")
def _maxpool_argmax(node, ctx):
    x = ctx.get(node.inputs[0])
    ks = [int(v) for v in node.attrs.get("ksize", [1, 2, 2, 1])]
    st = [int(v) for v in node.attrs.get("strides", ks)]
    outs = [node.outputs[0], f"{node.name}:1"]
    ctx.emit_multi("max_pool_with_argmax", [x], outs,
                   kernel=tuple(ks[1:3]), strides=tuple(st[1:3]),
                   padding=_attr_scalar(node.attrs.get("padding"), "VALID"))


@mapper(TF, "Conv2DBackpropInput")
def _conv2d_backprop_input(node, ctx):
    out_shape = tuple(_const_list(ctx, node.inputs[0]))
    w, g = ctx.get(node.inputs[1]), ctx.get(node.inputs[2])
    df, strides, _dil, padding = _conv_attrs(node)
    deconv = _reg_fn("deconv2d_tf")
    _emit_fn(ctx, lambda ww, gg: deconv(out_shape, ww, gg, strides=strides,
                                        padding=padding, data_format=df),
             [w, g], node.outputs[0], "deconv2d_tf")


@mapper(TF, "Dilation2D")
def _dilation2d(node, ctx):
    x, w = _ins(node, ctx)
    st = [int(v) for v in node.attrs.get("strides", [1, 1, 1, 1])]
    rt = [int(v) for v in node.attrs.get("rates", [1, 1, 1, 1])]
    ctx.emit("dilation2d", [x, w], node.outputs[0],
             strides=tuple(st[1:3]), rates=tuple(rt[1:3]),
             padding=_attr_scalar(node.attrs.get("padding"), "SAME"))


@mapper(TF, "LRN")
def _lrn(node, ctx):
    ctx.emit("lrn", _ins(node, ctx), node.outputs[0],
             depth_radius=int(node.attrs.get("depth_radius", 5)),
             bias=float(node.attrs.get("bias", 1.0)),
             alpha=float(node.attrs.get("alpha", 1.0)),
             beta=float(node.attrs.get("beta", 0.5)))


# -- losses ---------------------------------------------------------------
@mapper(TF, "SoftmaxCrossEntropyWithLogits")
def _softmax_xent(node, ctx):
    logits, labels = _ins(node, ctx)
    ctx.emit("softmax_cross_entropy_loss_with_logits", [logits, labels],
             node.outputs[0])
    if _port_consumed(ctx, node, 1):
        # backprop output: softmax(logits) - labels
        sm = ctx.emit("softmax", [logits], f"{node.name}__sm")
        ctx.emit("subtract", [sm, labels], f"{node.name}:1")


@mapper(TF, "SparseSoftmaxCrossEntropyWithLogits")
def _sparse_softmax_xent(node, ctx):
    logits, labels = _ins(node, ctx)  # TF input order: features, labels
    ctx.emit("sparse_softmax_cross_entropy_loss_with_logits",
             [labels, logits], node.outputs[0])
    if _port_consumed(ctx, node, 1):
        a = ctx.aval(node.inputs[0])  # features [B, C]
        if a is None:
            raise ImportException(
                f"{node.name}: backprop output needs static logits shape")
        sm = ctx.emit("softmax", [logits], f"{node.name}__sm")
        oh = ctx.emit("onehot", [labels], f"{node.name}__oh",
                      depth=int(a.shape[-1]))
        ctx.emit("subtract", [sm, oh], f"{node.name}:1")


@mapper(TF, "CTCLoss")
def _ctc_loss(node, ctx):
    # inputs: logits [T,B,C], labels_indices [N,2], labels_values [N],
    # sequence_length [B]; sparse labels must be graph constants
    logits = ctx.get(node.inputs[0])
    idx = np.asarray(ctx.const_value(node.inputs[1]))
    vals = np.asarray(ctx.const_value(node.inputs[2]))
    seq_len = ctx.get(node.inputs[3])
    a = ctx.aval(node.inputs[0])
    if a is None:
        raise ImportException("CTCLoss needs a static logits shape")
    T, B, C = a.shape
    lab_lens = np.zeros(B, np.int32)
    for b_i, _t in idx:
        lab_lens[int(b_i)] += 1
    maxlen = max(1, int(lab_lens.max()))
    dense = np.zeros((B, maxlen), np.int32)
    for (b_i, t_i), v in zip(idx, vals):
        dense[int(b_i), int(t_i)] = int(v)
    labels = ctx.sd.constant(dense, f"{node.name}__labels")
    lab_len_v = ctx.sd.constant(lab_lens, f"{node.name}__lab_lens")
    ctx.emit("ctc_loss", [labels, logits, lab_len_v, seq_len],
             node.outputs[0], blank_index=C - 1)
    if _port_consumed(ctx, node, 1):
        raise ImportException(
            f"CTCLoss {node.name!r}: gradient output consumption is not "
            f"supported at import (use autograd on the imported graph)")


# -- block RNN cells ------------------------------------------------------
@mapper(TF, "LSTMBlockCell")
def _lstm_block_cell(node, ctx):
    # TF inputs: x, cs_prev, h_prev, w, wci, wcf, wco, b
    x, cs, h, w, wci, wcf, wco, b = (ctx.get(i) for i in node.inputs)
    outs = [node.outputs[0]] + [f"{node.name}:{i}" for i in range(1, 7)]
    peephole = bool(node.attrs.get("use_peephole", False))
    ins = [x, h, cs, w, b] + ([wci, wcf, wco] if peephole else [])
    ctx.emit_multi("lstmBlockCell", ins, outs,
                   forget_bias=float(node.attrs.get("forget_bias", 1.0)),
                   clip_value=max(0.0,
                                  float(node.attrs.get("cell_clip", 0.0))))


@mapper(TF, "BlockLSTM", "BlockLSTMV2")
def _block_lstm(node, ctx):
    # TF inputs: seq_len_max, x, cs_prev, h_prev, w, wci, wcf, wco, b;
    # outputs (i, cs, f, o, ci, co, h) full sequences — h (:6) and cs (:1)
    # are the consumed ones in practice; gate traces aren't exposed by the
    # fused scan, so refuse loudly if a gate port is consumed.
    _seq, x, cs, h, w, wci, wcf, wco, b = (ctx.get(i) for i in node.inputs)
    for port in (0, 2, 3, 4, 5):
        if _port_consumed(ctx, node, port):
            raise ImportException(
                f"{node.op_type} {node.name!r}: per-gate sequence output "
                f":{port} is not exposed by the fused scan")
    peephole = bool(node.attrs.get("use_peephole", False))
    fb = 1.0 if node.op_type == "BlockLSTMV2" else \
        float(node.attrs.get("forget_bias", 1.0))
    ins = [x, h, cs, w, b] + ([wci, wcf, wco] if peephole else [])
    tmp = [f"{node.name}__hseq", f"{node.name}__hlast",
           f"{node.name}__clast"]
    h_seq, _hl, _cl = ctx.emit_multi(
        "lstmBlock", ins, tmp, forget_bias=fb,
        clip_value=max(0.0, float(node.attrs.get("cell_clip", 0.0))),
        time_major=True)
    ctx.bind(f"{node.name}:6", h_seq, aval=ctx.aval(tmp[0]))
    if _port_consumed(ctx, node, 1):
        raise ImportException(
            f"{node.op_type} {node.name!r}: cell-state sequence output :1 "
            f"is not exposed by the fused scan")


@mapper(TF, "GRUBlockCell")
def _gru_block_cell(node, ctx):
    # TF inputs: x, h_prev, w_ru, w_c, b_ru, b_c; outputs (r, u, c, h)
    x, h, w_ru, w_c, b_ru, b_c = (ctx.get(i) for i in node.inputs)
    outs = [node.outputs[0]] + [f"{node.name}:{i}" for i in range(1, 4)]
    ctx.emit_multi("gru_block_cell", [x, h, w_ru, w_c, b_ru, b_c], outs)


# -- random ---------------------------------------------------------------
def _random_shape(ctx, name):
    return tuple(_const_list(ctx, name))


@mapper(TF, "RandomUniform", "StatelessRandomUniform")
def _random_uniform(node, ctx):
    shape = _random_shape(ctx, node.inputs[0])
    ctx.emit("randomuniform", [], node.outputs[0], needs_key=True,
             shape=shape)


@mapper(TF, "RandomUniformInt")
def _random_uniform_int(node, ctx):
    shape = _random_shape(ctx, node.inputs[0])
    lo = _const_i(ctx, node.inputs[1])
    hi = _const_i(ctx, node.inputs[2])
    u = ctx.emit("randomuniform", [], f"{node.name}__u", needs_key=True,
                 shape=shape, minval=float(lo), maxval=float(hi))
    f = ctx.emit("Floor", [u], f"{node.name}__f")
    ctx.emit("cast", [f], node.outputs[0], dtype="int32")


@mapper(TF, "RandomStandardNormal")
def _random_normal(node, ctx):
    shape = _random_shape(ctx, node.inputs[0])
    ctx.emit("random_normal", [], node.outputs[0], needs_key=True,
             shape=shape)


@mapper(TF, "RandomGamma")
def _random_gamma(node, ctx):
    shape = _random_shape(ctx, node.inputs[0])
    g = _reg_fn("random_gamma")
    _emit_fn(ctx, lambda alpha, key: g(key, shape, alpha),
             [ctx.get(node.inputs[1])], node.outputs[0], "random_gamma",
             needs_key=True)


@mapper(TF, "RandomPoisson", "RandomPoissonV2")
def _random_poisson(node, ctx):
    shape = _random_shape(ctx, node.inputs[0])
    p = _reg_fn("random_poisson")
    _emit_fn(ctx, lambda lam, key: p(key, shape, lam),
             [ctx.get(node.inputs[1])], node.outputs[0], "random_poisson",
             needs_key=True)


@mapper(TF, "RandomShuffle")
def _random_shuffle(node, ctx):
    s = _reg_fn("random_shuffle")
    _emit_fn(ctx, lambda x, key: s(key, x), [ctx.get(node.inputs[0])],
             node.outputs[0], "random_shuffle", needs_key=True)


@mapper(TF, "RandomCrop")
def _random_crop(node, ctx):
    size = tuple(_const_list(ctx, node.inputs[1]))
    c = _reg_fn("random_crop")
    _emit_fn(ctx, lambda x, key: c(key, x, size), [ctx.get(node.inputs[0])],
             node.outputs[0], "random_crop", needs_key=True)


@mapper(TF, "Multinomial")
def _multinomial(node, ctx):
    n = _const_i(ctx, node.inputs[1])
    m = _reg_fn("random_multinomial")
    _emit_fn(ctx, lambda logits, key: m(key, logits, n),
             [ctx.get(node.inputs[0])], node.outputs[0], "multinomial",
             needs_key=True)
