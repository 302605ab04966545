"""TF op -> registered-op mapping rules.

Counterpart of ``deeplearning4j_tpu/modelimport/tf/mappings.py``, rule for
rule. Reference: the declarative mapping rules + per-op hooks of
`nd4j/samediff-import/samediff-import-tensorflow/src/main/resources/` and
`TensorflowOpDeclarations.kt`; legacy `TFGraphMapper.java` op switch.

Each rule maps one TF node onto a registered op (a torch function),
folding shape-ish constant inputs (perms, axes, reshape targets) into
static kwargs so the resulting SameDiff graph has static shapes.
"""
from __future__ import annotations

import numpy as np

from ..ir import IRNode, ImportContext, ImportException, dtype_name, mapper
from .parser import _np_dtype
from .slicing import build_index_spec

TF = "tensorflow"


def _ins(node: IRNode, ctx: ImportContext):
    return [ctx.get(i) for i in node.inputs]


def _dtype_name(attr) -> str:
    if isinstance(attr, tuple) and attr[0] == "dtype":
        return dtype_name(_np_dtype(attr[1]))
    return "float32"


def _simple(tf_name: str, op_name: str):
    @mapper(TF, tf_name)
    def _m(node, ctx, _op=op_name):
        ctx.emit(_op, _ins(node, ctx), node.outputs[0])
    return _m


# -- elementwise binary ---------------------------------------------------
for _tf, _op in [
    ("Add", "add"), ("AddV2", "add"), ("Sub", "subtract"),
    ("Mul", "multiply"), ("Div", "divide"), ("RealDiv", "divide"),
    ("DivNoNan", "divide_no_nan"), ("Pow", "Pow"),
    ("Maximum", "maximum"), ("Minimum", "minimum"),
    ("FloorDiv", "floordiv"), ("FloorMod", "floormod"), ("Mod", "mod"),
    ("SquaredDifference", "squaredsubtract"), ("Atan2", "atan2"),
    ("TruncateDiv", "truncatediv"),
    ("Greater", "greater"), ("GreaterEqual", "greater_equal"),
    ("Less", "less"), ("LessEqual", "less_equal"),
    ("Equal", "equals"), ("NotEqual", "not_equals"),
    ("LogicalAnd", "boolean_and"), ("LogicalOr", "boolean_or"),
]:
    _simple(_tf, _op)

# -- elementwise unary ----------------------------------------------------
for _tf, _op in [
    ("Tanh", "tanh"), ("Sigmoid", "sigmoid"), ("Relu", "relu"),
    ("Relu6", "relu6"), ("Elu", "elu"), ("Selu", "selu"),
    ("Softplus", "softplus"), ("Softsign", "softsign"),
    ("Exp", "exp"), ("Expm1", "expm1"), ("Log", "log"), ("Log1p", "log1p"),
    ("Sqrt", "sqrt"), ("Rsqrt", "rsqrt"), ("Square", "square"),
    ("Neg", "neg"), ("Abs", "abs"), ("Erf", "erf"), ("Erfc", "erfc"),
    ("Floor", "floor"), ("Ceil", "ceil"), ("Round", "round"),
    ("Rint", "rint"), ("Sign", "sign"), ("Reciprocal", "reciprocal"),
    ("Inv", "reciprocal"), ("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"),
    ("Asin", "asin"), ("Acos", "acos"), ("Atan", "atan"),
    ("Sinh", "sinh"), ("Cosh", "cosh"), ("Asinh", "asinh"),
    ("Acosh", "acosh"), ("Atanh", "atanh"), ("LogicalNot", "boolean_not"),
    ("Digamma", "digamma"), ("Lgamma", "lgamma"),
    ("ZerosLike", "zeros_as"), ("OnesLike", "ones_as"),
    ("Softmax", "softmax"), ("LogSoftmax", "log_softmax"),
    ("Mish", "mish"), ("L2Loss", "l2_loss"),
]:
    _simple(_tf, _op)

_simple("Select", "select")
_simple("SelectV2", "select")
_simple("AddN", "mergeadd")
_simple("InvertPermutation", "invert_permutation")


# -- identity-like: alias the input variable ------------------------------
@mapper(TF, "Identity", "Snapshot", "StopGradient", "PreventGradient",
        "CheckNumerics", "EnsureShape", "Enter", "Exit")
def _identity(node, ctx):
    src = node.inputs[0]
    if src in ctx.const_np:
        ctx.const_np[node.outputs[0]] = ctx.const_np[src]
    else:
        ctx.bind(node.outputs[0], ctx.get(src), aval=ctx.aval(src))


@mapper(TF, "IdentityN")
def _identity_n(node, ctx):
    for i, src in enumerate(node.inputs):
        out = f"{node.name}:{i}"
        if src in ctx.const_np:
            ctx.const_np[out] = ctx.const_np[src]
        else:
            ctx.bind(out, ctx.get(src), aval=ctx.aval(src))


@mapper(TF, "NoOp")
def _noop(node, ctx):
    pass


# -- TF1 cond (frameless Switch/Merge) ------------------------------------
# While-loop frames are consumed by while_frames.py before mapping, so any
# Switch/Merge reaching these rules belongs to a tf.cond region. Both
# branches are computed (no frames), so Switch passes its value
# through on both ports and Merge becomes an elementwise select on the
# Switch predicate — exact for the side-effect-free graphs freezing
# produces.

@mapper(TF, "Switch")
def _switch(node, ctx):
    v = ctx.get(node.inputs[0])
    ctx.bind(f"{node.name}:0", v, aval=ctx.aval(node.inputs[0]))
    ctx.bind(f"{node.name}:1", v, aval=ctx.aval(node.inputs[0]))
    ctx.bind(node.outputs[0], v, aval=ctx.aval(node.inputs[0]))


def _trace_switch_port(ctx, tensor):
    """Which Switch port (0=false, 1=true) a tensor derives from, and the
    Switch's predicate. Stops at intervening Merge nodes (an inner cond's
    output is branch *data* for the outer cond, not its routing)."""
    seen = set()
    stack = [tensor]
    while stack:
        t = stack.pop()
        if t in seen:
            continue
        seen.add(t)
        prod = ctx.producer(t)
        if prod is None:
            base = t.split(":")[0]
            prod = ctx.producer(base + ":0")
        if prod is None:
            continue
        if prod.op_type == "Switch":
            port = int(t.split(":")[1]) if ":" in t else 0
            return port, prod.inputs[1]
        if prod.op_type == "Merge":
            continue  # frame boundary of an inner cond
        stack.extend(prod.inputs)
    return None, None


@mapper(TF, "Merge")
def _merge(node, ctx):
    if len(node.inputs) != 2:
        raise ImportException(
            f"Merge {node.name!r}: {len(node.inputs)}-way merges (tf.case) "
            f"are not supported")
    for n in ctx.graph.nodes:
        if f"{node.name}:1" in n.inputs:
            raise ImportException(
                f"Merge {node.name!r}: its value_index output is consumed "
                f"by {n.name!r} — runtime branch indices are not "
                f"representable in a frameless lowering")
    a_port, a_pred = _trace_switch_port(ctx, node.inputs[0])
    b_port, b_pred = _trace_switch_port(ctx, node.inputs[1])
    if a_pred is not None and b_pred is not None and a_pred != b_pred:
        raise ImportException(
            f"Merge {node.name!r}: inputs route through different "
            f"predicates ({a_pred!r} vs {b_pred!r})")
    pred = a_pred if a_pred is not None else b_pred
    # a branch with no data-path Switch (e.g. a constant branch) infers
    # the complementary port
    if a_port is None and b_port is not None:
        a_port = 1 - b_port
    if b_port is None and a_port is not None:
        b_port = 1 - a_port
    if pred is None or a_port == b_port:
        raise ImportException(
            f"Merge {node.name!r}: cannot identify its cond branches "
            f"(ports {a_port}/{b_port}) — unsupported control-flow shape")
    true_t = node.inputs[0] if a_port == 1 else node.inputs[1]
    false_t = node.inputs[1] if a_port == 1 else node.inputs[0]
    ctx.emit("select", [ctx.get(pred), ctx.get(true_t), ctx.get(false_t)],
             node.outputs[0])


# -- matmul family --------------------------------------------------------
@mapper(TF, "MatMul")
def _matmul(node, ctx):
    ctx.emit("matmul", _ins(node, ctx), node.outputs[0],
             transpose_a=bool(node.attrs.get("transpose_a", False)),
             transpose_b=bool(node.attrs.get("transpose_b", False)))


@mapper(TF, "BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(node, ctx):
    ctx.emit("matmul", _ins(node, ctx), node.outputs[0],
             transpose_a=bool(node.attrs.get("adj_x", False)),
             transpose_b=bool(node.attrs.get("adj_y", False)))


@mapper(TF, "Einsum")
def _einsum(node, ctx):
    ctx.emit("einsum", _ins(node, ctx), node.outputs[0],
             equation=node.attrs.get("equation"))


@mapper(TF, "BiasAdd")
def _biasadd(node, ctx):
    ctx.emit("biasadd", _ins(node, ctx), node.outputs[0],
             nchw=node.attrs.get("data_format") == "NCHW")


# -- reductions -----------------------------------------------------------
def _reduction(tf_name: str, op_name: str):
    @mapper(TF, tf_name)
    def _m(node, ctx, _op=op_name):
        x = ctx.get(node.inputs[0])
        axes = ctx.const_value(node.inputs[1]) if len(node.inputs) > 1 else None
        dims = tuple(int(a) for a in np.atleast_1d(axes)) \
            if axes is not None else None
        ctx.emit(_op, [x], node.outputs[0], dims=dims,
                 keep_dims=bool(node.attrs.get("keep_dims", False)))
    return _m


for _tf, _op in [("Mean", "reduce_mean"), ("Sum", "reduce_sum"),
                 ("Max", "reduce_max"), ("Min", "reduce_min"),
                 ("Prod", "reduce_prod"), ("All", "reduce_all"),
                 ("Any", "reduce_any"),
                 ("EuclideanNorm", "reduce_norm2")]:
    _reduction(_tf, _op)


@mapper(TF, "ArgMax", "ArgMin")
def _argminmax(node, ctx):
    x = ctx.get(node.inputs[0])
    axis = int(np.asarray(ctx.const_value(node.inputs[1]))) \
        if len(node.inputs) > 1 else 0
    ctx.emit("argmax" if node.op_type == "ArgMax" else "argmin",
             [x], node.outputs[0], dims=axis)


@mapper(TF, "Cumsum")
def _cumsum(node, ctx):
    x = ctx.get(node.inputs[0])
    axis = int(np.asarray(ctx.const_value(node.inputs[1])))
    ctx.emit("cumsum", [x], node.outputs[0], axis=axis,
             exclusive=bool(node.attrs.get("exclusive", False)),
             reverse=bool(node.attrs.get("reverse", False)))


# -- shape manipulation ---------------------------------------------------
@mapper(TF, "Reshape")
def _reshape(node, ctx):
    x = ctx.get(node.inputs[0])
    shape = [int(s) for s in np.asarray(ctx.const_value(node.inputs[1]))]
    ctx.emit("reshape", [x], node.outputs[0], shape=tuple(shape))


@mapper(TF, "Transpose")
def _transpose(node, ctx):
    x = ctx.get(node.inputs[0])
    perm = tuple(int(p) for p in np.asarray(ctx.const_value(node.inputs[1])))
    ctx.emit("transpose", [x], node.outputs[0], axes=perm)


@mapper(TF, "ExpandDims")
def _expand_dims(node, ctx):
    x = ctx.get(node.inputs[0])
    axis = int(np.asarray(ctx.const_value(node.inputs[1])))
    ctx.emit("expand_dims", [x], node.outputs[0], axis=axis)


@mapper(TF, "Squeeze")
def _squeeze(node, ctx):
    x = ctx.get(node.inputs[0])
    dims = node.attrs.get("squeeze_dims") or node.attrs.get("axis")
    axis = tuple(int(d) for d in dims) if dims else None
    ctx.emit("squeeze", [x], node.outputs[0], axis=axis)


@mapper(TF, "ConcatV2")
def _concat_v2(node, ctx):
    xs = [ctx.get(i) for i in node.inputs[:-1]]
    axis = int(np.asarray(ctx.const_value(node.inputs[-1])))
    ctx.emit("concat", xs, node.outputs[0], axis=axis)


@mapper(TF, "Concat")
def _concat(node, ctx):
    axis = int(np.asarray(ctx.const_value(node.inputs[0])))
    xs = [ctx.get(i) for i in node.inputs[1:]]
    ctx.emit("concat", xs, node.outputs[0], axis=axis)


@mapper(TF, "Pack")
def _pack(node, ctx):
    ctx.emit("stack", _ins(node, ctx), node.outputs[0],
             axis=int(node.attrs.get("axis", 0)))


@mapper(TF, "Unpack")
def _unpack(node, ctx):
    num = int(node.attrs.get("num", 1))
    outs = [f"{node.name}:{i}" for i in range(num)]
    ctx.emit_multi("unstack", _ins(node, ctx), outs,
                   axis=int(node.attrs.get("axis", 0)))


@mapper(TF, "Split")
def _split(node, ctx):
    axis = int(np.asarray(ctx.const_value(node.inputs[0])))
    x = ctx.get(node.inputs[1])
    num = int(node.attrs.get("num_split", 1))
    outs = [f"{node.name}:{i}" for i in range(num)]
    ctx.emit_multi("split", [x], outs, num=num, axis=axis)


@mapper(TF, "SplitV")
def _split_v(node, ctx):
    x = ctx.get(node.inputs[0])
    sizes = [int(s) for s in np.asarray(ctx.const_value(node.inputs[1]))]
    axis = int(np.asarray(ctx.const_value(node.inputs[2])))
    outs = [f"{node.name}:{i}" for i in range(len(sizes))]
    ctx.emit_multi("split_v", [x], outs, sizes=sizes, axis=axis)


@mapper(TF, "StridedSlice")
def _strided_slice(node, ctx):
    x = ctx.get(node.inputs[0])
    begin = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    end = np.asarray(ctx.const_value(node.inputs[2])).tolist()
    strides = np.asarray(ctx.const_value(node.inputs[3])).tolist() \
        if len(node.inputs) > 3 else None
    a = ctx.aval(node.inputs[0])
    spec = build_index_spec(
        begin, end, strides,
        begin_mask=int(node.attrs.get("begin_mask", 0)),
        end_mask=int(node.attrs.get("end_mask", 0)),
        ellipsis_mask=int(node.attrs.get("ellipsis_mask", 0)),
        new_axis_mask=int(node.attrs.get("new_axis_mask", 0)),
        shrink_axis_mask=int(node.attrs.get("shrink_axis_mask", 0)),
        rank=len(a.shape) if a is not None else None)
    ctx.emit("tf_strided_slice", [x], node.outputs[0], spec=spec)


@mapper(TF, "Slice")
def _slice(node, ctx):
    x = ctx.get(node.inputs[0])
    begin = [int(b) for b in np.asarray(ctx.const_value(node.inputs[1]))]
    size = [int(s) for s in np.asarray(ctx.const_value(node.inputs[2]))]
    ctx.emit("slice", [x], node.outputs[0], begin=begin, size=size)


@mapper(TF, "GatherV2", "Gather")
def _gather(node, ctx):
    params = ctx.get(node.inputs[0])
    indices = ctx.get(node.inputs[1])
    axis = 0
    if node.op_type == "GatherV2" and len(node.inputs) > 2:
        axis = int(np.asarray(ctx.const_value(node.inputs[2])))
    if int(node.attrs.get("batch_dims", 0)) != 0:
        raise ImportException("GatherV2 batch_dims != 0 not supported")
    ctx.emit("gather", [params, indices], node.outputs[0], axis=axis)


@mapper(TF, "GatherNd")
def _gather_nd(node, ctx):
    ctx.emit("gather_nd", _ins(node, ctx), node.outputs[0])


@mapper(TF, "OneHot")
def _onehot(node, ctx):
    indices = ctx.get(node.inputs[0])
    depth = int(np.asarray(ctx.const_value(node.inputs[1])))
    on = float(np.asarray(ctx.const_value(node.inputs[2])))
    off = float(np.asarray(ctx.const_value(node.inputs[3])))
    ctx.emit("onehot", [indices], node.outputs[0], depth=depth, on_value=on,
             off_value=off, axis=int(node.attrs.get("axis", -1)))


@mapper(TF, "Fill")
def _fill(node, ctx):
    dims = [int(d) for d in np.asarray(ctx.const_value(node.inputs[0]))]
    value = ctx.get(node.inputs[1])
    ctx.emit("broadcast_to", [value], node.outputs[0], shape=tuple(dims))


@mapper(TF, "Tile")
def _tile(node, ctx):
    x = ctx.get(node.inputs[0])
    reps = [int(r) for r in np.asarray(ctx.const_value(node.inputs[1]))]
    ctx.emit("tile", [x], node.outputs[0], reps=reps)


@mapper(TF, "Pad", "PadV2", "MirrorPad")
def _pad(node, ctx):
    x = ctx.get(node.inputs[0])
    paddings = np.asarray(ctx.const_value(node.inputs[1])).tolist()
    cval = 0
    if node.op_type == "PadV2" and len(node.inputs) > 2:
        cval = float(np.asarray(ctx.const_value(node.inputs[2])))
    mode = node.attrs.get("mode", "CONSTANT") \
        if node.op_type == "MirrorPad" else "CONSTANT"
    ctx.emit("pad", [x], node.outputs[0], paddings=paddings, mode=mode,
             constant_values=cval)


@mapper(TF, "Cast")
def _cast(node, ctx):
    ctx.emit("cast", _ins(node, ctx), node.outputs[0],
             dtype=_dtype_name(node.attrs.get("DstT")))


@mapper(TF, "Shape", "Size", "Rank")
def _shape_of(node, ctx):
    a = ctx.aval(node.inputs[0])
    if a is None:
        raise ImportException(
            f"{node.op_type}({node.inputs[0]!r}) needs a static input shape; "
            f"pass concrete input_shapes to the importer")
    if node.op_type == "Shape":
        val = np.asarray(a.shape, np.int32)
    elif node.op_type == "Size":
        val = np.asarray(int(np.prod(a.shape)), np.int32)
    else:
        val = np.asarray(len(a.shape), np.int32)
    ctx.const_np[node.outputs[0]] = val


@mapper(TF, "Range")
def _range(node, ctx):
    start = float(np.asarray(ctx.const_value(node.inputs[0])))
    limit = float(np.asarray(ctx.const_value(node.inputs[1])))
    delta = float(np.asarray(ctx.const_value(node.inputs[2])))
    ctx.const_np[node.outputs[0]] = np.arange(start, limit, delta,
                                              dtype=np.int32
                                              if all(float(v).is_integer()
                                                     for v in (start, limit,
                                                               delta))
                                              else np.float32)


# -- nn -------------------------------------------------------------------
@mapper(TF, "FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(node, ctx):
    x, scale, offset, mean, var = _ins(node, ctx)
    outs = ctx.sd._record(
        "fused_batch_norm", [x, scale, offset, mean, var], n_outputs=3,
        out_name=node.name.replace(":", "_"),
        eps=float(node.attrs.get("epsilon", 1e-3)),
        training=bool(node.attrs.get("is_training", False)),
        data_format=node.attrs.get("data_format", "NHWC"))
    ctx.bind(node.outputs[0], outs[0])
    ctx.bind(f"{node.name}:1", outs[1])
    ctx.bind(f"{node.name}:2", outs[2])


@mapper(TF, "LeakyRelu")
def _leaky_relu(node, ctx):
    ctx.emit("leakyrelu", _ins(node, ctx), node.outputs[0],
             alpha=float(node.attrs.get("alpha", 0.2)))


def _conv_attrs(node, n=2):
    df = node.attrs.get("data_format", "NHWC")
    strides = node.attrs.get("strides", [1] * (n + 2))
    dilations = node.attrs.get("dilations", [1] * (n + 2))
    if df.startswith("NC"):
        s, d = strides[2:2 + n], dilations[2:2 + n]
    else:
        s, d = strides[1:1 + n], dilations[1:1 + n]
    padding = node.attrs.get("padding", "SAME")
    if isinstance(padding, bytes):
        padding = padding.decode()
    return df, tuple(int(v) for v in s), tuple(int(v) for v in d), padding


@mapper(TF, "Conv2D")
def _conv2d(node, ctx):
    x, w = _ins(node, ctx)
    df, strides, dil, padding = _conv_attrs(node)
    ctx.emit("conv2d", [x, w], node.outputs[0], strides=strides,
             padding=padding, dilation=dil, data_format=df)


@mapper(TF, "DepthwiseConv2dNative")
def _depthwise(node, ctx):
    x, w = _ins(node, ctx)
    df, strides, dil, padding = _conv_attrs(node)
    ctx.emit("depthwise_conv2d", [x, w], node.outputs[0], strides=strides,
             padding=padding, dilation=dil, data_format=df)


@mapper(TF, "MaxPool", "AvgPool")
def _pool(node, ctx):
    x = ctx.get(node.inputs[0])
    df = node.attrs.get("data_format", "NHWC")
    ks = node.attrs.get("ksize", [1, 1, 1, 1])
    st = node.attrs.get("strides", [1, 1, 1, 1])
    if df.startswith("NC"):
        kernel, strides = ks[2:4], st[2:4]
    else:
        kernel, strides = ks[1:3], st[1:3]
    padding = node.attrs.get("padding", "VALID")
    if isinstance(padding, bytes):
        padding = padding.decode()
    kw = {}
    if node.op_type == "AvgPool":
        # TF average pooling ALWAYS excludes padded cells from the divisor
        kw["include_pad"] = False
    ctx.emit("maxpool2d" if node.op_type == "MaxPool" else "avgpool2d",
             [x], node.outputs[0], kernel=tuple(int(k) for k in kernel),
             strides=tuple(int(s) for s in strides), padding=padding,
             data_format=df, **kw)
