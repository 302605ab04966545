"""ONNX ModelProto (.onnx) wire-format parser -> IRGraph.

Counterpart of ``deeplearning4j_tpu/modelimport/onnx/parser.py``; bf16
tensors come back as :data:`..ir.BFLOAT16` (raw 2-byte values).

Parses the public onnx.proto schema with `protoio.py` — no onnx runtime
required. Reference counterpart: the shaded ONNX protos consumed by
`nd4j/samediff-import/samediff-import-onnx/.../OnnxFrameworkImporter.kt`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import protoio as pio
from ..ir import BFLOAT16, IRGraph, IRNode, ImportException, dtype_name

# onnx TensorProto.DataType -> numpy
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 8: object, 9: np.bool_, 10: np.float16,
    11: np.float64, 12: np.uint32, 13: np.uint64,
}


def _np_dtype(onnx_enum: int):
    if onnx_enum == 16:  # BFLOAT16
        return BFLOAT16
    try:
        return _ONNX_DTYPES[onnx_enum]
    except KeyError:
        raise ImportException(f"unsupported ONNX dtype enum {onnx_enum}")


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1 data_type=2 float_data=4 int32_data=5
    string_data=6 int64_data=7 name=8 raw_data=9 double_data=10
    uint64_data=11."""
    f = pio.decode(buf)
    dims = pio.ints(f, 1)
    dtype = _np_dtype(pio.first(f, 2, 1))
    name = pio.as_str(pio.first(f, 8))
    raw = pio.first(f, 9)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif dtype == np.float32:
        arr = np.asarray(pio.floats(f, 4), np.float32)
    elif dtype == np.float64:
        arr = np.asarray(pio.doubles(f, 10), np.float64)
    elif dtype == np.int64:
        arr = np.asarray(pio.ints(f, 7), np.int64)
    elif dtype in (np.uint64, np.uint32):
        arr = np.asarray(pio.ints(f, 11, signed=False), dtype)
    elif dtype == object:
        arr = np.asarray([s.decode("utf-8", "replace")
                          for s in pio.all_(f, 6)], object)
    else:  # int32-packed family (int8/16/32, uint8/16, bool, fp16)
        vals = pio.ints(f, 5)
        if dtype == np.float16:
            arr = np.asarray(vals, np.uint16).view(np.float16)
        else:
            arr = np.asarray(vals, dtype)
    return name, arr.reshape([int(d) for d in dims])


def _parse_shape(buf: bytes) -> Optional[Tuple]:
    """TensorShapeProto: dim=1 {dim_value=1, dim_param=2}."""
    f = pio.decode(buf)
    dims = []
    for d in pio.all_(f, 1):
        df = pio.decode(d)
        if 1 in df:
            dims.append(pio.as_int64(pio.first(df, 1)))
        else:
            dims.append(None)  # symbolic dim_param
    return tuple(dims)


def _parse_value_info(buf: bytes):
    """ValueInfoProto -> (name, shape, np_dtype)."""
    f = pio.decode(buf)
    name = pio.as_str(pio.first(f, 1))
    shape, dtype = None, np.float32
    tbuf = pio.first(f, 2)
    if tbuf is not None:
        tf_ = pio.decode(tbuf)
        tens = pio.first(tf_, 1)  # TypeProto.tensor_type
        if tens is not None:
            ttf = pio.decode(tens)
            dtype = _np_dtype(pio.first(ttf, 1, 1))
            sbuf = pio.first(ttf, 2)
            if sbuf is not None:
                shape = _parse_shape(sbuf)
    return name, shape, dtype


def parse_attr(buf: bytes) -> Tuple[str, Any]:
    """AttributeProto: name=1 f=2 i=3 s=4 t=5 g=6 floats=7 ints=8
    strings=9 type=20."""
    f = pio.decode(buf)
    name = pio.as_str(pio.first(f, 1))
    atype = pio.first(f, 20)
    if atype == 1 or (atype is None and 2 in f):
        return name, pio.as_float32(pio.first(f, 2))
    if atype == 2 or (atype is None and 3 in f):
        return name, pio.as_int64(pio.first(f, 3))
    if atype == 3 or (atype is None and 4 in f):
        return name, pio.as_str(pio.first(f, 4))
    if atype == 4 or (atype is None and 5 in f):
        return name, parse_tensor(pio.first(f, 5))[1]
    if atype == 5 or (atype is None and 6 in f):
        return name, ("graph", pio.first(f, 6))
    if atype == 6 or 7 in f:
        return name, pio.floats(f, 7)
    if atype == 7 or 8 in f:
        return name, pio.ints(f, 8)
    if atype == 8 or 9 in f:
        return name, [s.decode("utf-8", "replace") for s in pio.all_(f, 9)]
    return name, None


def parse_model(data: bytes,
                input_shapes: Optional[Dict[str, Tuple]] = None) -> IRGraph:
    """ModelProto bytes -> IRGraph (graph=7, opset_import=8)."""
    m = pio.decode(data)
    gbuf = pio.first(m, 7)
    if gbuf is None:
        raise ImportException("not an ONNX ModelProto (no graph field)")
    g = pio.decode(gbuf)
    input_shapes = input_shapes or {}

    initializers: Dict[str, np.ndarray] = {}
    for t in pio.all_(g, 5):
        name, arr = parse_tensor(t)
        initializers[name] = arr

    inputs: Dict[str, Any] = {}
    for vi in pio.all_(g, 11):
        name, shape, dtype = _parse_value_info(vi)
        if name in initializers:   # opset<9 lists initializers as inputs
            continue
        if name in input_shapes:
            shape = input_shapes[name]
        inputs[name] = (shape,
                        "float32" if dtype == object else dtype_name(dtype))

    outputs = [_parse_value_info(vi)[0] for vi in pio.all_(g, 12)]

    nodes: List[IRNode] = []
    for i, nb in enumerate(pio.all_(g, 1)):
        nf = pio.decode(nb)
        op_type = pio.as_str(pio.first(nf, 4))
        name = pio.as_str(pio.first(nf, 3)) or f"{op_type}_{i}"
        node_in = [pio.as_str(s) for s in pio.all_(nf, 1)]
        node_out = [pio.as_str(s) for s in pio.all_(nf, 2)]
        attrs = dict(parse_attr(a) for a in pio.all_(nf, 5))
        # empty-string inputs are positional "absent optional" markers —
        # kept so mappers can interpret positions (e.g. Clip(x, min, max))
        nodes.append(IRNode(name=name, op_type=op_type, inputs=node_in,
                            outputs=node_out, attrs=attrs))
    return IRGraph(framework="onnx", nodes=nodes, initializers=initializers,
                   inputs=inputs, outputs=outputs)
