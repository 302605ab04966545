"""ONNX op -> registered-op mapping rules.

Counterpart of ``deeplearning4j_tpu/modelimport/onnx/mappings.py``, rule
for rule.

Reference: `nd4j/samediff-import/samediff-import-onnx/src/main/kotlin/org/nd4j/
samediff/frameworkimport/onnx/definitions/OnnxOpDeclarations.kt` (the
declarative per-op rules) — rebuilt here against the registered ops.
"""
from __future__ import annotations

import numpy as np

from ..ir import IRNode, ImportContext, ImportException, dtype_name, mapper
from .parser import _np_dtype

ONNX = "onnx"


def _ins(node: IRNode, ctx: ImportContext):
    return [ctx.get(i) if i else None for i in node.inputs]


def _simple(onnx_name: str, op_name: str):
    @mapper(ONNX, onnx_name)
    def _m(node, ctx, _op=op_name):
        ctx.emit(_op, [ctx.get(i) for i in node.inputs if i],
                 node.outputs[0])
    return _m


for _ox, _op in [
    ("Add", "add"), ("Sub", "subtract"), ("Mul", "multiply"),
    ("Div", "divide"), ("Pow", "Pow"), ("Sqrt", "sqrt"), ("Exp", "exp"),
    ("Log", "log"), ("Tanh", "tanh"), ("Sigmoid", "sigmoid"),
    ("Relu", "relu"), ("Erf", "erf"), ("Neg", "neg"), ("Abs", "abs"),
    ("Floor", "floor"), ("Ceil", "ceil"), ("Round", "round"),
    ("Reciprocal", "reciprocal"), ("Sign", "sign"), ("Softplus", "softplus"),
    ("Softsign", "softsign"), ("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"),
    ("Asin", "asin"), ("Acos", "acos"), ("Atan", "atan"), ("Sinh", "sinh"),
    ("Cosh", "cosh"), ("Asinh", "asinh"), ("Acosh", "acosh"),
    ("Atanh", "atanh"), ("Not", "boolean_not"), ("And", "boolean_and"),
    ("Or", "boolean_or"), ("Xor", "boolean_xor"),
    ("Equal", "equals"), ("Greater", "greater"),
    ("GreaterOrEqual", "greater_equal"), ("Less", "less"),
    ("LessOrEqual", "less_equal"), ("Max", "maximum"), ("Min", "minimum"),
    ("Mod", "mod"), ("Where", "select"), ("MatMul", "matmul"),
    ("Mish", "mish"), ("HardSwish", "hardswish"),
]:
    _simple(_ox, _op)

_simple("Sum", "mergeadd")
_simple("Mean", "mergeavg")


@mapper(ONNX, "Identity", "Dropout")
def _identity(node, ctx):
    # Dropout at inference = identity (mask output, if requested, unused)
    src = node.inputs[0]
    if src in ctx.const_np:
        ctx.const_np[node.outputs[0]] = ctx.const_np[src]
    else:
        ctx.bind(node.outputs[0], ctx.get(src), aval=ctx.aval(src))


@mapper(ONNX, "Constant")
def _constant(node, ctx):
    val = node.attrs.get("value")
    if val is None:
        if "value_float" in node.attrs:
            val = np.float32(node.attrs["value_float"])
        elif "value_int" in node.attrs:
            val = np.int64(node.attrs["value_int"])
        elif "value_floats" in node.attrs:
            val = np.asarray(node.attrs["value_floats"], np.float32)
        elif "value_ints" in node.attrs:
            val = np.asarray(node.attrs["value_ints"], np.int64)
        else:
            raise ImportException(f"Constant node {node.name!r} without value")
    ctx.const_np[node.outputs[0]] = np.asarray(val)


@mapper(ONNX, "ConstantOfShape")
def _const_of_shape(node, ctx):
    shape = [int(s) for s in np.asarray(ctx.const_value(node.inputs[0]))]
    val = node.attrs.get("value")
    fill = np.asarray(val).ravel()[0] if val is not None else np.float32(0)
    ctx.const_np[node.outputs[0]] = np.full(shape, fill)


@mapper(ONNX, "Gemm")
def _gemm(node, ctx):
    a, b = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    c = ctx.get(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] \
        else None
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    out = ctx.emit("matmul", [a, b], node.outputs[0] + "/mm",
                   transpose_a=bool(node.attrs.get("transA", 0)),
                   transpose_b=bool(node.attrs.get("transB", 0)),
                   alpha=alpha)
    if c is not None:
        scaled = ctx.sd._record("multiply", [c, ctx.sd.constant(
            np.float32(beta), node.name + "/beta")]) if beta != 1.0 else c
        ctx.emit("add", [out, scaled], node.outputs[0])
    else:
        ctx.bind(node.outputs[0], out)


@mapper(ONNX, "Conv")
def _conv(node, ctx):
    x = ctx.get(node.inputs[0])
    w_name = node.inputs[1]
    w_np = ctx.maybe_const(w_name)
    group = int(node.attrs.get("group", 1))
    strides = tuple(int(s) for s in node.attrs.get("strides", [1, 1]))
    dilations = tuple(int(d) for d in node.attrs.get("dilations", [1, 1]))
    pads = node.attrs.get("pads")
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if pads is not None and any(int(p) for p in pads):
        n = len(pads) // 2
        padding = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    elif auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = "SAME"
    else:
        padding = "VALID"
    if w_np is None:
        raise ImportException("Conv weights must be an initializer")
    if w_np.ndim != 4:
        raise ImportException("only 2-D Conv supported")
    # ONNX weights OIHW -> our HWIO
    if group == 1:
        w = ctx.sd.constant(np.transpose(w_np, (2, 3, 1, 0)),
                            w_name.replace(":", "_") + "_hwio")
        opn, kw = "conv2d", {}
    elif group == w_np.shape[0] and w_np.shape[1] == 1:
        # depthwise: OIHW [C*M,1,kh,kw] -> HWIO-style [kh,kw,C,M]
        c = group
        m = w_np.shape[0] // c
        w_d = np.transpose(
            w_np.reshape(c, m, 1, *w_np.shape[2:]), (3, 4, 0, 1))
        w = ctx.sd.constant(w_d, w_name.replace(":", "_") + "_dw")
        opn, kw = "depthwise_conv2d", {}
    else:
        # grouped conv: OIHW [O, In/g, kh, kw] -> HWIO [kh, kw, In/g, O],
        # lowered through conv_ops.conv2d groups=
        w = ctx.sd.constant(np.transpose(w_np, (2, 3, 1, 0)),
                            w_name.replace(":", "_") + "_hwio")
        opn, kw = "conv2d", {"groups": group}
    bias = ctx.get(node.inputs[2]) if len(node.inputs) > 2 and \
        node.inputs[2] else None
    ctx.emit(opn, [x, w, bias], node.outputs[0], strides=strides,
             padding=padding, dilation=dilations, data_format="NCHW", **kw)


@mapper(ONNX, "ConvTranspose")
def _conv_transpose(node, ctx):
    x = ctx.get(node.inputs[0])
    w_np = ctx.maybe_const(node.inputs[1])
    if w_np is None:
        raise ImportException("ConvTranspose weights must be an initializer")
    if w_np.ndim != 4:
        raise ImportException("only 2-D ConvTranspose supported")
    if int(node.attrs.get("group", 1)) != 1:
        raise ImportException("grouped ConvTranspose unsupported")
    if node.attrs.get("output_shape"):
        raise ImportException(
            "ConvTranspose output_shape attribute unsupported; express the "
            "crop via pads")
    if any(int(p) for p in node.attrs.get("output_padding", [])):
        raise ImportException("ConvTranspose output_padding unsupported")
    strides = tuple(int(s) for s in node.attrs.get("strides", [1, 1]))
    dil = tuple(int(d) for d in node.attrs.get("dilations", [1, 1]))
    pads = [int(p) for p in node.attrs.get("pads", [0, 0, 0, 0])]
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad in ("SAME_UPPER", "SAME_LOWER") and not any(pads):
        # SAME: output = in*stride; crop the (dil*(k-1)+1-s) surplus,
        # extra on the end for SAME_UPPER, the start for SAME_LOWER
        kh, kw = w_np.shape[2], w_np.shape[3]
        tot = [max(dil[0] * (kh - 1) + 1 - strides[0], 0),
               max(dil[1] * (kw - 1) + 1 - strides[1], 0)]
        if auto_pad == "SAME_UPPER":
            pads = [tot[0] // 2, tot[1] // 2,
                    tot[0] - tot[0] // 2, tot[1] - tot[1] // 2]
        else:
            pads = [tot[0] - tot[0] // 2, tot[1] - tot[1] // 2,
                    tot[0] // 2, tot[1] // 2]
    # ONNX weights [Cin, Cout, kH, kW] -> deconv2d [kH, kW, outC, inC]
    w = ctx.sd.constant(np.transpose(w_np, (2, 3, 1, 0)),
                        node.inputs[1].replace(":", "_") + "_hwoi")
    bias = ctx.get(node.inputs[2]) if len(node.inputs) > 2 and \
        node.inputs[2] else None
    if not any(pads):
        ctx.emit("deconv2d", [x, w, bias], node.outputs[0],
                 strides=strides, padding="VALID", dilation=dil,
                 data_format="NCHW")
        return
    # ONNX pads CROP the full (VALID) transposed output:
    #   out = (in-1)*stride + dil*(k-1) + 1 - pad_begin - pad_end
    full = ctx.emit("deconv2d", [x, w, bias], f"{node.name}__full",
                    strides=strides, padding="VALID", dilation=dil,
                    data_format="NCHW")
    ax = ctx.aval(node.inputs[0])
    if ax is None or ax.shape[2] is None or ax.shape[3] is None:
        raise ImportException(
            "ConvTranspose with pads needs static spatial input dims to "
            "crop")
    ih, iw = ax.shape[2], ax.shape[3]
    kh, kw = w_np.shape[2], w_np.shape[3]
    hh = (ih - 1) * strides[0] + dil[0] * (kh - 1) + 1
    ww = (iw - 1) * strides[1] + dil[1] * (kw - 1) + 1
    # -1 = rest-of-dim: batch/channel stay symbolic-friendly
    ctx.emit("slice", [full], node.outputs[0],
             begin=(0, 0, pads[0], pads[1]),
             size=(-1, -1, hh - pads[0] - pads[2],
                   ww - pads[1] - pads[3]))


@mapper(ONNX, "MaxPool", "AveragePool")
def _pool(node, ctx):
    x = ctx.get(node.inputs[0])
    if int(node.attrs.get("ceil_mode", 0)):
        raise ImportException(f"{node.op_type} ceil_mode=1 unsupported "
                              "(floor-mode output grid only)")
    if any(int(d) != 1 for d in node.attrs.get("dilations", [])):
        raise ImportException(f"{node.op_type} with dilations unsupported")
    kernel = tuple(int(k) for k in node.attrs.get("kernel_shape", [2, 2]))
    strides = tuple(int(s) for s in node.attrs.get("strides", kernel))
    pads = node.attrs.get("pads")
    if pads is not None and any(int(p) for p in pads):
        n = len(pads) // 2
        padding = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    elif node.attrs.get("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER"):
        padding = "SAME"
    else:
        padding = "VALID"
    kw = {}
    if node.op_type == "AveragePool":
        # ONNX default count_include_pad=0: padded cells do NOT count in
        # the divisor (cross-checked against TF SAME avg-pool)
        kw["include_pad"] = bool(node.attrs.get("count_include_pad", 0))
    ctx.emit("maxpool2d" if node.op_type == "MaxPool" else "avgpool2d",
             [x], node.outputs[0], kernel=kernel, strides=strides,
             padding=padding, data_format="NCHW", **kw)


@mapper(ONNX, "GlobalAveragePool")
def _gap(node, ctx):
    x = ctx.get(node.inputs[0])
    a = ctx.aval(node.inputs[0])
    ndim = len(a.shape) if a is not None else 4
    ctx.emit("reduce_mean", [x], node.outputs[0],
             dims=tuple(range(2, ndim)), keep_dims=True)


@mapper(ONNX, "BatchNormalization")
def _bn(node, ctx):
    x, scale, b, mean, var = _ins(node, ctx)[:5]
    ctx.emit("batchnorm", [x, mean, var, scale, b], node.outputs[0],
             eps=float(node.attrs.get("epsilon", 1e-5)), axis=1)


@mapper(ONNX, "LayerNormalization")
def _ln(node, ctx):
    x, scale = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    b = ctx.get(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] \
        else None
    ctx.emit("layer_norm", [x, scale, b], node.outputs[0],
             axis=int(node.attrs.get("axis", -1)),
             eps=float(node.attrs.get("epsilon", 1e-5)))


@mapper(ONNX, "Reshape")
def _reshape(node, ctx):
    x = ctx.get(node.inputs[0])
    shape = [int(s) for s in np.asarray(ctx.const_value(node.inputs[1]))]
    a = ctx.aval(node.inputs[0])
    if a is not None:  # ONNX: 0 means "copy input dim"
        shape = [a.shape[i] if s == 0 and i < len(a.shape) else s
                 for i, s in enumerate(shape)]
    ctx.emit("reshape", [x], node.outputs[0], shape=tuple(shape))


@mapper(ONNX, "Flatten")
def _flatten(node, ctx):
    x = ctx.get(node.inputs[0])
    ctx.emit("flatten_2d", [x], node.outputs[0],
             axis=int(node.attrs.get("axis", 1)))


@mapper(ONNX, "Transpose")
def _transpose(node, ctx):
    x = ctx.get(node.inputs[0])
    perm = node.attrs.get("perm")
    ctx.emit("transpose", [x], node.outputs[0],
             axes=tuple(int(p) for p in perm) if perm else None)


@mapper(ONNX, "Concat")
def _concat(node, ctx):
    ctx.emit("concat", [ctx.get(i) for i in node.inputs], node.outputs[0],
             axis=int(node.attrs.get("axis", 0)))


@mapper(ONNX, "Split")
def _split(node, ctx):
    x = ctx.get(node.inputs[0])
    axis = int(node.attrs.get("axis", 0))
    sizes = node.attrs.get("split")
    if sizes is None and len(node.inputs) > 1 and node.inputs[1]:
        sizes = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    if sizes is not None:
        ctx.emit_multi("split_v", [x], node.outputs,
                       sizes=[int(s) for s in sizes], axis=axis)
    else:
        ctx.emit_multi("split", [x], node.outputs, num=len(node.outputs),
                       axis=axis)


@mapper(ONNX, "Squeeze", "Unsqueeze")
def _squeeze(node, ctx):
    x = ctx.get(node.inputs[0])
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        axes = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    if node.op_type == "Squeeze":
        ctx.emit("squeeze", [x], node.outputs[0],
                 axis=tuple(int(a) for a in axes) if axes else None)
    else:
        out = x
        for j, a in enumerate(sorted(int(a) for a in axes)):
            last = j == len(axes) - 1
            t = node.outputs[0] if last else f"{node.outputs[0]}/ed{j}"
            out = ctx.emit("expand_dims", [out], t, axis=a)


@mapper(ONNX, "Gather")
def _gather(node, ctx):
    params, indices = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    ctx.emit("gather", [params, indices], node.outputs[0],
             axis=int(node.attrs.get("axis", 0)))


@mapper(ONNX, "Slice")
def _slice(node, ctx):
    x = ctx.get(node.inputs[0])
    if len(node.inputs) > 1:  # opset >= 10: starts/ends/axes/steps inputs
        starts = np.asarray(ctx.const_value(node.inputs[1])).tolist()
        ends = np.asarray(ctx.const_value(node.inputs[2])).tolist()
        axes = np.asarray(ctx.const_value(node.inputs[3])).tolist() \
            if len(node.inputs) > 3 and node.inputs[3] else \
            list(range(len(starts)))
        steps = np.asarray(ctx.const_value(node.inputs[4])).tolist() \
            if len(node.inputs) > 4 and node.inputs[4] else [1] * len(starts)
    else:  # opset 1: attributes
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    a = ctx.aval(node.inputs[0])
    rank = len(a.shape) if a is not None else max(int(ax) for ax in axes) + 1
    spec = [("all",)] * rank
    intmax = 1 << 62
    for s, e, ax, st in zip(starts, ends, axes, steps):
        s, e, st = int(s), int(e), int(st)
        spec[int(ax)] = ("slice",
                         None if abs(s) >= intmax else s,
                         None if abs(e) >= intmax else e, st)
    ctx.emit("tf_strided_slice", [x], node.outputs[0], spec=spec)


@mapper(ONNX, "Softmax", "LogSoftmax")
def _softmax(node, ctx):
    x = ctx.get(node.inputs[0])
    ctx.emit("softmax" if node.op_type == "Softmax" else "log_softmax",
             [x], node.outputs[0], axis=int(node.attrs.get("axis", -1)))


@mapper(ONNX, "ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
        "ReduceProd")
def _reduce(node, ctx):
    op = {"ReduceMean": "reduce_mean", "ReduceSum": "reduce_sum",
          "ReduceMax": "reduce_max", "ReduceMin": "reduce_min",
          "ReduceProd": "reduce_prod"}[node.op_type]
    x = ctx.get(node.inputs[0])
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        axes = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    ctx.emit(op, [x], node.outputs[0],
             dims=tuple(int(a) for a in axes) if axes else None,
             keep_dims=bool(node.attrs.get("keepdims", 1)))


@mapper(ONNX, "ArgMax", "ArgMin")
def _argminmax(node, ctx):
    x = ctx.get(node.inputs[0])
    ctx.emit("argmax" if node.op_type == "ArgMax" else "argmin",
             [x], node.outputs[0], dims=int(node.attrs.get("axis", 0)),
             keep_dims=bool(node.attrs.get("keepdims", 1)))


@mapper(ONNX, "Cast")
def _cast(node, ctx):
    to = dtype_name(_np_dtype(int(node.attrs.get("to", 1))))
    ctx.emit("cast", [ctx.get(node.inputs[0])], node.outputs[0], dtype=to)


@mapper(ONNX, "Clip")
def _clip(node, ctx):
    x = ctx.get(node.inputs[0])
    lo = node.attrs.get("min")
    hi = node.attrs.get("max")
    if lo is None and len(node.inputs) > 1 and node.inputs[1]:
        lo = float(np.asarray(ctx.const_value(node.inputs[1])))
    if hi is None and len(node.inputs) > 2 and node.inputs[2]:
        hi = float(np.asarray(ctx.const_value(node.inputs[2])))
    ctx.emit("clipbyvalue", [x], node.outputs[0],
             clip_min=-np.inf if lo is None else float(lo),
             clip_max=np.inf if hi is None else float(hi))


@mapper(ONNX, "LeakyRelu")
def _leaky(node, ctx):
    ctx.emit("leakyrelu", [ctx.get(node.inputs[0])], node.outputs[0],
             alpha=float(node.attrs.get("alpha", 0.01)))


@mapper(ONNX, "Elu")
def _elu(node, ctx):
    ctx.emit("elu", [ctx.get(node.inputs[0])], node.outputs[0])


@mapper(ONNX, "Selu")
def _selu(node, ctx):
    ctx.emit("selu", [ctx.get(node.inputs[0])], node.outputs[0])


@mapper(ONNX, "Gelu")
def _gelu(node, ctx):
    ctx.emit("gelu", [ctx.get(node.inputs[0])], node.outputs[0],
             approximate=node.attrs.get("approximate") == "tanh")


@mapper(ONNX, "Expand")
def _expand(node, ctx):
    x = ctx.get(node.inputs[0])
    shape = [int(s) for s in np.asarray(ctx.const_value(node.inputs[1]))]
    a = ctx.aval(node.inputs[0])
    if a is not None:
        # ONNX Expand uses numpy broadcasting: result dim = max(in, target)
        in_shape = (1,) * (len(shape) - len(a.shape)) + tuple(a.shape)
        shape = [max(i_, s) for i_, s in zip(in_shape, shape)]
    ctx.emit("broadcast_to", [x], node.outputs[0], shape=tuple(shape))


@mapper(ONNX, "Tile")
def _tile(node, ctx):
    x = ctx.get(node.inputs[0])
    reps = [int(r) for r in np.asarray(ctx.const_value(node.inputs[1]))]
    ctx.emit("tile", [x], node.outputs[0], reps=reps)


@mapper(ONNX, "Pad")
def _pad(node, ctx):
    x = ctx.get(node.inputs[0])
    pads = node.attrs.get("pads")
    if pads is None and len(node.inputs) > 1 and node.inputs[1]:
        pads = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    n = len(pads) // 2
    paddings = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    mode = node.attrs.get("mode", "constant").upper()
    cval = 0.0
    if len(node.inputs) > 2 and node.inputs[2]:
        cval = float(np.asarray(ctx.const_value(node.inputs[2])))
    ctx.emit("pad", [x], node.outputs[0], paddings=paddings,
             mode="CONSTANT" if mode == "CONSTANT" else mode,
             constant_values=cval)


@mapper(ONNX, "Shape")
def _shape(node, ctx):
    a = ctx.aval(node.inputs[0])
    if a is None:
        raise ImportException(f"Shape({node.inputs[0]!r}) needs static shape")
    ctx.const_np[node.outputs[0]] = np.asarray(a.shape, np.int64)


@mapper(ONNX, "Einsum")
def _einsum(node, ctx):
    ctx.emit("einsum", [ctx.get(i) for i in node.inputs], node.outputs[0],
             equation=node.attrs.get("equation"))


@mapper(ONNX, "GRU")
def _gru(node, ctx):
    """ONNX GRU -> gru_onnx (reference gruCell semantics,
    `libnd4j/include/ops/declarable/headers/recurrent.h`). Both
    linear_before_reset conventions are supported (torch exports 1).

    Layout: X [T, B, In]; W [1, 3H, In] (z, r, h); R [1, 3H, H]; B [1, 6H].
    Outputs: Y [T, 1, B, H], Y_h [1, B, H]."""
    if node.attrs.get("direction", "forward") != "forward":
        raise ImportException("only forward ONNX GRU supported")
    for attr in ("activations", "activation_alpha", "activation_beta",
                 "clip"):
        if node.attrs.get(attr):
            raise ImportException(f"ONNX GRU attr {attr!r} not supported")
    if int(node.attrs.get("layout", 0)) != 0:
        raise ImportException("ONNX GRU layout=1 (batch-major) not "
                              "supported; export with layout=0")
    if len(node.inputs) > 4 and node.inputs[4]:
        raise ImportException("ONNX GRU sequence_lens not supported")
    H = int(node.attrs["hidden_size"])
    lbr = int(node.attrs.get("linear_before_reset", 0))
    w_np = ctx.const_value(node.inputs[1])[0]     # [3H, In]
    r_np = ctx.const_value(node.inputs[2])[0]     # [3H, H]
    b_np = ctx.const_value(node.inputs[3])[0] if len(node.inputs) > 3 and \
        node.inputs[3] else np.zeros(6 * H, np.float32)
    h0 = None
    if len(node.inputs) > 5 and node.inputs[5]:   # initial_h [1, B, H]
        h0 = ctx.sd._record("squeeze", [ctx.get(node.inputs[5])], axis=0)
    w = ctx.sd.constant(w_np, node.name + "_w")
    r = ctx.sd.constant(r_np, node.name + "_r")
    b = ctx.sd.constant(b_np, node.name + "_b")
    x = ctx.get(node.inputs[0])
    gru_in = [x, w, r, b]
    if h0 is not None:
        gru_in.append(h0)
    h_seq, h_last = ctx.sd._record(
        "gru_onnx", gru_in, n_outputs=2,
        out_name=node.name.replace(":", "_"), linear_before_reset=lbr,
        time_major=True)
    outs = node.outputs
    if len(outs) > 0 and outs[0]:
        ctx.emit("expand_dims", [h_seq], outs[0], axis=1)
    if len(outs) > 1 and outs[1]:
        ctx.emit("expand_dims", [h_last], outs[1], axis=0)


@mapper(ONNX, "LSTM")
def _lstm(node, ctx):
    """ONNX LSTM -> lstmLayer. ONNX gate order is [i, o, f, c]; the
    registered op uses [i, f, g(c), o] — weight blocks are reordered at
    import (weights must be initializers, as exported models' are).

    Layout: X [T, B, In]; W [1, 4H, In]; R [1, 4H, H]; B [1, 8H].
    Outputs: Y [T, 1, B, H], Y_h [1, B, H], Y_c [1, B, H]."""
    if node.attrs.get("direction", "forward") != "forward":
        raise ImportException("only forward ONNX LSTM supported")
    for attr in ("activations", "activation_alpha", "activation_beta",
                 "clip", "input_forget"):
        if node.attrs.get(attr):
            raise ImportException(f"ONNX LSTM attr {attr!r} not supported")
    if int(node.attrs.get("layout", 0)) != 0:
        raise ImportException("ONNX LSTM layout=1 (batch-major) not "
                              "supported; export with layout=0")
    if len(node.inputs) > 4 and node.inputs[4]:
        raise ImportException("ONNX LSTM sequence_lens not supported")
    if len(node.inputs) > 7 and node.inputs[7]:
        raise ImportException("ONNX LSTM peepholes (P) not supported")
    H = int(node.attrs["hidden_size"])
    w_np = ctx.const_value(node.inputs[1])[0]     # [4H, In]
    r_np = ctx.const_value(node.inputs[2])[0]     # [4H, H]
    b_np = ctx.const_value(node.inputs[3])[0] if len(node.inputs) > 3 and \
        node.inputs[3] else np.zeros(8 * H, np.float32)
    h0 = c0 = None
    if len(node.inputs) > 5 and node.inputs[5]:   # initial_h [1, B, H]
        h0 = ctx.sd._record("squeeze", [ctx.get(node.inputs[5])], axis=0)
    if len(node.inputs) > 6 and node.inputs[6]:   # initial_c
        c0 = ctx.sd._record("squeeze", [ctx.get(node.inputs[6])], axis=0)

    def reorder(m):  # [4H, ...] blocks [i,o,f,c] -> [i,f,c,o]
        i, o, f, c = np.split(m, 4, axis=0)
        return np.concatenate([i, f, c, o], axis=0)

    wx = ctx.sd.constant(reorder(w_np).T, node.name + "_wx")   # [In, 4H]
    wh = ctx.sd.constant(reorder(r_np).T, node.name + "_wh")   # [H, 4H]
    bias = ctx.sd.constant(
        reorder((b_np[:4 * H] + b_np[4 * H:]).reshape(4, H)).reshape(-1),
        node.name + "_b")
    x = ctx.get(node.inputs[0])
    lstm_in = [x, wx, wh, bias]
    if h0 is not None or c0 is not None:
        lstm_in += [h0, c0]
    h_seq, h_last, c_last = ctx.sd._record(
        "lstmLayer", lstm_in, n_outputs=3,
        out_name=node.name.replace(":", "_"), time_major=True)
    # ONNX inserts a num_directions axis
    outs = node.outputs
    if len(outs) > 0 and outs[0]:
        ctx.emit("expand_dims", [h_seq], outs[0], axis=1)
    if len(outs) > 1 and outs[1]:
        ctx.emit("expand_dims", [h_last], outs[1], axis=0)
    if len(outs) > 2 and outs[2]:
        ctx.emit("expand_dims", [c_last], outs[2], axis=0)
