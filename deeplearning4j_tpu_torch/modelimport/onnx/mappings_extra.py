"""ONNX op mapping rules — long tail of the reference ruleset.

Counterpart of ``deeplearning4j_tpu/modelimport/onnx/mappings_extra.py``,
rule for rule; its raw functions are torch functions here.

Covers the remaining `inputFrameworkOpName` entries of
`nd4j/samediff-import/samediff-import-onnx/src/main/resources/
onnx-mapping-ruleset.pbtxt` beyond the core set in ``mappings.py``.
Dynamic-output ops (NonZero, the Sequence* family) and subgraph control
flow (If, Loop) are documented exemptions in ``coverage.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir import IRNode, ImportContext, ImportException, mapper
from .mappings import ONNX, _ins, _simple


def _axes_arg(node, ctx, input_idx=1):
    """axes from attr (opset<13/18) or constant input (newer opsets)."""
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > input_idx and \
            node.inputs[input_idx]:
        axes = np.asarray(ctx.const_value(node.inputs[input_idx])).tolist()
    return tuple(int(a) for a in axes) if axes else None


def _emit_fn(ctx, fn, inputs, out_tensor, label, needs_key=False, **kwargs):
    out = ctx.sd._record_fn(fn, list(inputs), label=label,
                            out_name=out_tensor.replace(":", "_"),
                            needs_key=needs_key, **kwargs)
    ctx.bind(out_tensor, out)
    return out


def _reg_fn(name):
    from ...ops.registry import OpRegistry
    return OpRegistry.get().lookup(name).fn


for _ox, _op in [
    ("Det", "matrix_determinant"),
    ("PRelu", "prelu"),
    ("GatherND", "gather_nd"),
]:
    _simple(_ox, _op)


@mapper(ONNX, "HardSigmoid")
def _hard_sigmoid(node, ctx):
    # ONNX: max(0, min(1, alpha*x + beta)), default alpha=0.2 — NOT the
    # alpha=1/6 of jax.nn.hard_sigmoid / torch's hardsigmoid, so compose
    # explicitly
    alpha = float(node.attrs.get("alpha", 0.2))
    beta = float(node.attrs.get("beta", 0.5))

    def fn(x, _a=alpha, _b=beta):
        return torch.clamp(_a * x + _b, 0.0, 1.0)

    _emit_fn(ctx, fn, [ctx.get(node.inputs[0])], node.outputs[0],
             "hard_sigmoid")


@mapper(ONNX, "AliasWithName", "Placeholder")
def _alias(node, ctx):
    src = node.inputs[0]
    if src in ctx.const_np:
        ctx.const_np[node.outputs[0]] = ctx.const_np[src]
    else:
        ctx.bind(node.outputs[0], ctx.get(src), aval=ctx.aval(src))


@mapper(ONNX, "CumSum")
def _cumsum(node, ctx):
    x = ctx.get(node.inputs[0])
    axis = int(np.asarray(ctx.const_value(node.inputs[1])))
    ctx.emit("cumsum", [x], node.outputs[0], axis=axis,
             exclusive=bool(node.attrs.get("exclusive", 0)),
             reverse=bool(node.attrs.get("reverse", 0)))


@mapper(ONNX, "DepthToSpace")
def _depth_to_space(node, ctx):
    x = ctx.get(node.inputs[0])
    mode = node.attrs.get("mode", "DCR")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode != "DCR":
        raise ImportException("DepthToSpace mode=CRD is unsupported")
    ctx.emit("depth_to_space", [x], node.outputs[0],
             block_size=int(node.attrs.get("blocksize", 2)),
             data_format="NCHW")


@mapper(ONNX, "SpaceToDepth")
def _space_to_depth(node, ctx):
    x = ctx.get(node.inputs[0])
    ctx.emit("space_to_depth", [x], node.outputs[0],
             block_size=int(node.attrs.get("blocksize", 2)),
             data_format="NCHW")


@mapper(ONNX, "GlobalMaxPool")
def _global_max_pool(node, ctx):
    x = ctx.get(node.inputs[0])
    a = ctx.aval(node.inputs[0])
    ndim = len(a.shape) if a is not None else 4
    ctx.emit("reduce_max", [x], node.outputs[0],
             dims=tuple(range(2, ndim)), keep_dims=True)


@mapper(ONNX, "IsInf")
def _isinf(node, ctx):
    pos = bool(node.attrs.get("detect_positive", 1))
    neg = bool(node.attrs.get("detect_negative", 1))
    x = ctx.get(node.inputs[0])
    if pos and neg:
        ctx.emit("isinf", [x], node.outputs[0])
        return
    inf = ctx.sd.constant(np.float32(np.inf if pos else -np.inf),
                          f"{node.name}__inf")
    ctx.emit("equals", [x, inf], node.outputs[0])


_simple("IsNaN", "isnan")


@mapper(ONNX, "LRN")
def _lrn(node, ctx):
    size = int(node.attrs.get("size", 5))
    # ONNX normalizes alpha by window size and runs over the NCHW channel
    # axis; the TF-style registry op uses raw alpha over the LAST axis
    lrn = _reg_fn("lrn")
    dr = (size - 1) // 2
    bias = float(node.attrs.get("bias", 1.0))
    alpha = float(node.attrs.get("alpha", 1e-4)) / size
    beta = float(node.attrs.get("beta", 0.75))

    def fn(x, _lrn=lrn):
        t = torch.movedim(x, 1, -1)
        return torch.movedim(_lrn(t, dr, bias, alpha, beta), -1, 1)

    _emit_fn(ctx, fn, [ctx.get(node.inputs[0])], node.outputs[0], "lrn")


@mapper(ONNX, "NonMaxSuppression")
def _nms(node, ctx):
    # inputs: boxes [B,N,4] (y1,x1,y2,x2), scores [B,C,N], then const
    # max_output_boxes_per_class, iou_threshold, score_threshold.
    # Static-shape lowering: single batch/class only (the common detection
    # head export), indices padded with -1.
    a = ctx.aval(node.inputs[0])
    sa = ctx.aval(node.inputs[1])
    if a is None or sa is None:
        raise ImportException("NonMaxSuppression needs static shapes")
    if a.shape[0] != 1 or sa.shape[1] != 1:
        raise ImportException(
            "NonMaxSuppression: only batch=1, classes=1 supported "
            f"(got boxes {a.shape}, scores {sa.shape})")
    boxes, scores = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    max_out = int(np.asarray(ctx.const_value(node.inputs[2]))) \
        if len(node.inputs) > 2 and node.inputs[2] else 0
    iou = float(np.asarray(ctx.const_value(node.inputs[3]))) \
        if len(node.inputs) > 3 and node.inputs[3] else 0.0
    score = float(np.asarray(ctx.const_value(node.inputs[4]))) \
        if len(node.inputs) > 4 and node.inputs[4] else -np.inf
    nms = _reg_fn("non_max_suppression")

    def fn(b, s, _nms=nms, _mo=max_out, _iou=iou, _sc=score):
        idx = _nms(b[0], s[0, 0], _mo, _iou, _sc)  # [max_out], -1 padded
        z = torch.zeros_like(idx)
        return torch.stack([z, z, idx], dim=-1)  # [max_out, 3]

    _emit_fn(ctx, fn, [boxes, scores], node.outputs[0], "onnx_nms")


@mapper(ONNX, "RandomNormal", "RandomUniform")
def _random(node, ctx):
    shape = tuple(int(s) for s in node.attrs.get("shape", ()))
    if node.op_type == "RandomNormal":
        ctx.emit("random_normal", [], node.outputs[0], needs_key=True,
                 shape=shape, mean=float(node.attrs.get("mean", 0.0)),
                 stddev=float(node.attrs.get("scale", 1.0)))
    else:
        ctx.emit("randomuniform", [], node.outputs[0], needs_key=True,
                 shape=shape, minval=float(node.attrs.get("low", 0.0)),
                 maxval=float(node.attrs.get("high", 1.0)))


@mapper(ONNX, "Range")
def _range(node, ctx):
    start = np.asarray(ctx.const_value(node.inputs[0]))
    limit = np.asarray(ctx.const_value(node.inputs[1]))
    delta = np.asarray(ctx.const_value(node.inputs[2]))
    ctx.const_np[node.outputs[0]] = np.arange(
        start.item(), limit.item(), delta.item(), dtype=start.dtype)


@mapper(ONNX, "ReduceL1", "ReduceL2", "ReduceLogSumExp")
def _reduce_extra(node, ctx):
    op = {"ReduceL1": "reduce_norm1", "ReduceL2": "reduce_norm2",
          "ReduceLogSumExp": "reduce_logsumexp"}[node.op_type]
    x = ctx.get(node.inputs[0])
    ctx.emit(op, [x], node.outputs[0], dims=_axes_arg(node, ctx),
             keep_dims=bool(node.attrs.get("keepdims", 1)))


@mapper(ONNX, "Resize", "ResizeNearest")
def _resize(node, ctx):
    x = ctx.get(node.inputs[0])
    a = ctx.aval(node.inputs[0])
    if a is None:
        raise ImportException("Resize needs a static input shape")
    # opset>=11 inputs: X, roi, scales, sizes
    sizes = None
    if len(node.inputs) > 3 and node.inputs[3]:
        sizes = [int(s) for s in np.asarray(ctx.const_value(node.inputs[3]))]
    elif len(node.inputs) > 2 and node.inputs[2]:
        scales = np.asarray(ctx.const_value(node.inputs[2]))
        if scales.size:
            sizes = [int(round(d * s)) for d, s in zip(a.shape, scales)]
    elif "scales" in node.attrs:  # legacy Upsample-style
        sizes = [int(round(d * s))
                 for d, s in zip(a.shape, node.attrs["scales"])]
    if sizes is None:
        raise ImportException("Resize: need constant scales or sizes")
    mode = node.attrs.get("mode", "nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    method = {"nearest": "nearest", "linear": "bilinear",
              "cubic": "bicubic"}.get(mode, "nearest")
    if node.op_type == "ResizeNearest":
        method = "nearest"
    # NCHW input: spatial sizes are the trailing dims
    hw = sizes[2:] if len(sizes) == len(a.shape) else sizes
    perm_in = (0, 2, 3, 1)
    perm_out = (0, 3, 1, 2)
    t = ctx.emit("transpose", [x], f"{node.name}__nhwc", axes=perm_in)
    r = ctx.emit("image_resize", [t], f"{node.name}__r", size=tuple(hw),
                 method=method)
    ctx.emit("transpose", [r], node.outputs[0], axes=perm_out)


@mapper(ONNX, "ScatterND")
def _scatter_nd(node, ctx):
    data, idx, upd = (ctx.get(i) for i in node.inputs[:3])
    red = node.attrs.get("reduction", "none")
    red = red.decode() if isinstance(red, bytes) else red
    op = {"none": "scatter_nd_update", "add": "scatter_nd_add",
          "mul": None, "max": "scatter_nd_max",
          "min": "scatter_nd_min"}.get(red)
    if op is None:
        raise ImportException(f"ScatterND reduction={red!r} unsupported")
    ctx.emit(op, [data, idx, upd], node.outputs[0])


@mapper(ONNX, "ScatterElements", "Scatter")
def _scatter_elements(node, ctx):
    data, idx, upd = (ctx.get(i) for i in node.inputs[:3])
    axis = int(node.attrs.get("axis", 0))
    red = node.attrs.get("reduction", "none")
    red = red.decode() if isinstance(red, bytes) else red
    method = {"none": "set", "add": "sum", "mul": "prod",
              "max": "amax", "min": "amin"}.get(red)
    if method is None:
        raise ImportException(
            f"ScatterElements reduction={red!r} unsupported")

    def fn(d, i, u, _axis=axis, _m=method):
        i = i.long()
        i = torch.where(i < 0, i + d.shape[_axis], i)
        if _m == "set":
            return torch.scatter(d, _axis, i, u)
        return torch.scatter_reduce(d, _axis, i, u, _m)

    _emit_fn(ctx, fn, [data, idx, upd], node.outputs[0], "scatter_elements")


@mapper(ONNX, "Size")
def _size(node, ctx):
    a = ctx.aval(node.inputs[0])
    if a is None:
        raise ImportException("Size needs a static input shape")
    ctx.const_np[node.outputs[0]] = np.asarray(
        int(np.prod(a.shape)), np.int64)


@mapper(ONNX, "TopK")
def _top_k(node, ctx):
    x = ctx.get(node.inputs[0])
    if len(node.inputs) > 1 and node.inputs[1]:
        k = int(np.asarray(ctx.const_value(node.inputs[1])))
    else:
        k = int(node.attrs.get("k", 1))
    axis = int(node.attrs.get("axis", -1))
    largest = bool(node.attrs.get("largest", 1))
    srt = bool(node.attrs.get("sorted", 1))
    a = ctx.aval(node.inputs[0])
    rank = len(a.shape) if a is not None else 2
    if axis < 0:
        axis += rank
    tk = _reg_fn("top_k")

    def fn(v, _k=k, _axis=axis, _rank=rank, _largest=largest, _srt=srt):
        moved = torch.movedim(v, _axis, -1)
        vals, idx = tk(moved if _largest else -moved, _k, sorted=_srt)
        if not _largest:
            vals = -vals
        # ONNX's int64 indices, narrowed to 32 bits as the JAX package's
        return (torch.movedim(vals, -1, _axis),
                torch.movedim(idx, -1, _axis).to(torch.int32))

    out = ctx.sd._record_fn(fn, [x], label="onnx_topk", n_outputs=2,
                            out_names=[o.replace(":", "_")
                                       for o in node.outputs[:2]])
    for t, v in zip(node.outputs, out):
        ctx.bind(t, v)


@mapper(ONNX, "RoiAlign")
def _roi_align(node, ctx):
    # crop_and_resize-based RoiAlign (avg mode): bilinear-sample an
    # output_h*s x output_w*s grid per ROI, then average-pool s x s blocks
    x, rois = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    batch_idx = ctx.get(node.inputs[2])
    oh = int(node.attrs.get("output_height", 1))
    ow = int(node.attrs.get("output_width", 1))
    s = max(1, int(node.attrs.get("sampling_ratio", 1)))
    scale = float(node.attrs.get("spatial_scale", 1.0))
    mode = node.attrs.get("mode", "avg")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode != "avg":
        raise ImportException("RoiAlign mode=max is unsupported")
    a = ctx.aval(node.inputs[0])
    if a is None:
        raise ImportException("RoiAlign needs a static input shape")
    H, W = a.shape[2], a.shape[3]
    car = _reg_fn("crop_and_resize")

    def fn(feat, boxes, bidx, _oh=oh, _ow=ow, _s=s, _sc=scale, _H=H, _W=W):
        nhwc = feat.permute(0, 2, 3, 1)
        x1, y1, x2, y2 = (boxes[:, 0] * _sc, boxes[:, 1] * _sc,
                          boxes[:, 2] * _sc, boxes[:, 3] * _sc)
        # crop_and_resize wants normalized [y1, x1, y2, x2]
        nb = torch.stack([y1 / (_H - 1), x1 / (_W - 1),
                          y2 / (_H - 1), x2 / (_W - 1)], dim=1)
        crops = car(nhwc, nb, bidx.to(torch.int32), (_oh * _s, _ow * _s))
        r = crops.reshape(crops.shape[0], _oh, _s, _ow, _s, crops.shape[-1])
        return r.mean(dim=(2, 4)).permute(0, 3, 1, 2)

    _emit_fn(ctx, fn, [x, rois, batch_idx], node.outputs[0], "roi_align")
