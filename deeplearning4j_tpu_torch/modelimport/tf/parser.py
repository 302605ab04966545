"""TensorFlow GraphDef (.pb) wire-format parser -> IRGraph.

Counterpart of ``deeplearning4j_tpu/modelimport/tf/parser.py``; bf16
tensors come back as :data:`..ir.BFLOAT16` (raw 2-byte values), the port
having no ``ml_dtypes``.

Parses the public tensorflow/core/framework protos (graph.proto,
node_def.proto, attr_value.proto, tensor.proto, tensor_shape.proto) with the
schemaless decoder in `protoio.py` — no tensorflow runtime required.

Reference counterpart: the shaded TF protos consumed by
`nd4j/samediff-import/samediff-import-tensorflow` and the legacy
`org/nd4j/imports/graphmapper/tf/TFGraphMapper.java`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import protoio as pio
from ..ir import (BFLOAT16, IRGraph, IRNode, ImportException, dtype_name,
                  is_bf16)

# tensorflow DataType enum -> numpy dtype
_TF_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: object, 9: np.int64, 10: np.bool_, 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64,
}


def _np_dtype(tf_enum: int):
    if tf_enum == 14:  # DT_BFLOAT16
        return BFLOAT16
    try:
        return _TF_DTYPES[tf_enum]
    except KeyError:
        raise ImportException(f"unsupported TF dtype enum {tf_enum}")


def parse_tensor_shape(buf: bytes) -> Optional[Tuple[int, ...]]:
    """TensorShapeProto: dim=2 {size=1}, unknown_rank=3."""
    f = pio.decode(buf)
    if pio.first(f, 3):
        return None
    dims = []
    for d in pio.all_(f, 2):
        df = pio.decode(d)
        size = pio.as_int64(pio.first(df, 1, 0))
        dims.append(None if size == -1 else size)
    return tuple(dims)


def parse_tensor(buf: bytes) -> np.ndarray:
    """TensorProto -> numpy (tensor_content raw bytes or typed *_val arrays)."""
    f = pio.decode(buf)
    dtype = _np_dtype(pio.first(f, 1, 1))
    shape_buf = pio.first(f, 2)
    shape = parse_tensor_shape(shape_buf) if shape_buf is not None else ()
    if shape is None:
        raise ImportException("TensorProto with unknown rank")
    content = pio.first(f, 4)
    if content:
        arr = np.frombuffer(content, dtype=dtype)
        return arr.reshape(shape)
    # typed value fields
    if dtype == np.float32:
        vals = np.asarray(pio.floats(f, 5), np.float32)
    elif dtype == np.float64:
        vals = np.asarray(pio.doubles(f, 6), np.float64)
    elif dtype in (np.int32, np.int16, np.int8, np.uint8, np.uint16):
        vals = np.asarray(pio.ints(f, 7), dtype)
    elif dtype == np.int64:
        vals = np.asarray(pio.ints(f, 10), np.int64)
    elif dtype == np.bool_:
        vals = np.asarray(pio.ints(f, 11), np.bool_)
    elif dtype is np.float16 or is_bf16(dtype):
        raw = np.asarray(pio.ints(f, 13), np.uint16)
        vals = raw.view(dtype) if raw.size else np.asarray([], dtype)
    elif dtype == object:  # DT_STRING
        vals = np.asarray([s.decode("utf-8", "replace")
                           for s in pio.all_(f, 8)], object)
    else:
        vals = np.asarray(pio.ints(f, 7, signed=False), dtype)
    n = int(np.prod(shape)) if shape else 1
    if vals.size == 0:
        return np.zeros(shape, dtype if dtype != object else object)
    if vals.size == 1 and n != 1:   # splat value broadcast over shape
        return np.full(shape, vals[0], dtype if dtype != object else object)
    return vals.reshape(shape)


def parse_attr_value(buf: bytes) -> Any:
    """AttrValue: s=2 i=3 f=4 b=5 type=6 shape=7 tensor=8 list=1 placeholder=9."""
    f = pio.decode(buf)
    if 2 in f:
        raw = pio.first(f, 2)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw
    if 3 in f:
        return pio.as_int64(pio.first(f, 3))
    if 4 in f:
        return pio.as_float32(pio.first(f, 4))
    if 5 in f:
        return bool(pio.first(f, 5))
    if 6 in f:
        return ("dtype", pio.first(f, 6))
    if 7 in f:
        return ("shape", parse_tensor_shape(pio.first(f, 7)))
    if 8 in f:
        return parse_tensor(pio.first(f, 8))
    if 1 in f:
        lf = pio.decode(pio.first(f, 1))
        if 3 in lf:
            return pio.ints(lf, 3)
        if 4 in lf:
            return pio.floats(lf, 4)
        if 2 in lf:
            return [s.decode("utf-8", "replace") for s in pio.all_(lf, 2)]
        if 5 in lf:
            return [bool(b) for b in pio.ints(lf, 5)]
        if 6 in lf:
            return ("dtypes", pio.ints(lf, 6))
        if 7 in lf:
            return ("shapes", [parse_tensor_shape(s) for s in pio.all_(lf, 7)])
        return []
    if 9 in f:
        return ("placeholder", pio.as_str(pio.first(f, 9)))
    if 10 in f:
        return ("func", None)
    return None


def _norm(ref: str) -> str:
    """Normalize a NodeDef input ref: 'x' -> 'x:0' (keep '^ctrl' as is)."""
    if ref.startswith("^"):
        return ref
    return ref if ":" in ref else ref + ":0"


def parse_graphdef(data: bytes,
                   input_shapes: Optional[Dict[str, Tuple]] = None,
                   outputs: Optional[List[str]] = None) -> IRGraph:
    """GraphDef bytes -> IRGraph.

    `input_shapes`: concrete static shapes for placeholders (the import
    requires static shapes; overrides any -1/unknown dims in the graph).
    `outputs`: requested output tensor names ('node' or 'node:i'); defaults
    to terminal nodes (consumed by nobody).
    """
    g = pio.decode(data)
    if 2 in g and pio.all_(g, 2):
        lib = pio.decode(pio.first(g, 2))
        if 1 in lib:  # FunctionDefLibrary.function
            raise ImportException(
                "GraphDef contains a function library (PartitionedCall-style "
                "graph); freeze with aggressive inlining first")
    nodes: List[IRNode] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: Dict[str, Any] = {}
    input_shapes = input_shapes or {}

    for raw in pio.all_(g, 1):
        nf = pio.decode(raw)
        name = pio.as_str(pio.first(nf, 1))
        op = pio.as_str(pio.first(nf, 2))
        in_refs = [pio.as_str(s) for s in pio.all_(nf, 3)]
        data_in = [_norm(r) for r in in_refs if not r.startswith("^")]
        ctrl_in = [r[1:] for r in in_refs if r.startswith("^")]
        attrs: Dict[str, Any] = {}
        for entry in pio.all_(nf, 5):
            ef = pio.decode(entry)
            key = pio.as_str(pio.first(ef, 1))
            if key.startswith("_"):
                continue
            val_buf = pio.first(ef, 2)
            attrs[key] = parse_attr_value(val_buf) if val_buf else None

        if op == "Const":
            initializers[name + ":0"] = attrs.get("value")
            continue
        if op in ("Placeholder", "PlaceholderWithDefault"):
            shape = input_shapes.get(name)
            if shape is None:
                sh = attrs.get("shape")
                shape = sh[1] if isinstance(sh, tuple) and sh[0] == "shape" \
                    else None
            dt = attrs.get("dtype")
            np_dt = _np_dtype(dt[1]) if isinstance(dt, tuple) else np.float32
            inputs[name + ":0"] = (
                shape, "float32" if np_dt == object else dtype_name(np_dt))
            continue
        nodes.append(IRNode(name=name, op_type=op, inputs=data_in,
                            outputs=[name + ":0"], attrs=attrs,
                            control_inputs=ctrl_in))

    if outputs:
        out_names = [_norm(o) for o in outputs]
    else:
        consumed = {i for n in nodes for i in n.inputs}
        out_names = [n.outputs[0] for n in nodes
                     if n.outputs[0] not in consumed]
    return IRGraph(framework="tensorflow", nodes=nodes,
                   initializers=initializers, inputs=inputs,
                   outputs=out_names)
