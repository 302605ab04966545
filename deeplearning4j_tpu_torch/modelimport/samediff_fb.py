"""Reader for reference-produced SameDiff FlatBuffers graphs (``.fb``).

The reference serializes SameDiff graphs as FlatBuffers ``FlatGraph`` tables
(writer: ``nd4j/.../autodiff/samediff/SameDiff.java:5465-5727`` ``asFlatGraph``;
schema: ``libnd4j/include/graph/scheme/graph.fbs`` / ``node.fbs`` /
``variable.fbs`` / ``array.fbs``).  This module reads those files directly —
no generated FlatBuffers classes, just the wire format walked with the
port's own table reader (``flatbuf.py``) — and rebuilds the graph as a
SameDiff on the caller's device (the card unless it names another).
Counterpart of ``deeplearning4j_tpu/modelimport/samediff_fb.py``; bf16
arrays come back as raw 2-byte values (:data:`.ir.BFLOAT16`).

Scope: inference graphs (variables + constants + placeholders + op nodes).
Training metadata (updaterState, trainingConfig JSON) is surfaced on the
returned object but not converted into an optimizer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..autodiff.samediff import SameDiff, SDVariable, to_tensor
from ..ops import OpRegistry
from .flatbuf import (i8 as _i8, i32 as _i32, i64 as _i64, root as _root,
                      string as _string, subtable as _subtable,
                      vec_bool as _vec_bool, vec_bytes as _vec_bytes,
                      vec_f64 as _vec_f64, vec_i32 as _vec_i32,
                      vec_i64 as _vec_i64, vec_len as _vec_len,
                      vec_str as _vec_str, vec_table as _vec_table)
from .ir import BFLOAT16, dtype_name


# --- DType enum (array.fbs) -> numpy -------------------------------------

_DTYPES = {
    1: np.bool_, 3: np.float16, 5: np.float32, 6: np.float64,
    7: np.int8, 8: np.int16, 9: np.int32, 10: np.int64,
    11: np.uint8, 12: np.uint16, 13: np.uint32, 14: np.uint64,
    17: BFLOAT16,
}


def _flat_array(t) -> np.ndarray:
    """Decode a FlatArray table: nd4j shapeInfo + raw byte buffer.

    shapeInfo layout (libnd4j ``shape.h``): ``[rank, *shape, *strides,
    extras, elementWiseStride, order]``.  The reference writes the raw
    buffer in the array's own ordering (``BaseNDArray.toFlatArray`` dups
    with ``this.ordering()``), so the trailing order char (99='c',
    102='f') decides how the dense buffer maps onto the shape.
    """
    return _decode_flat_array(_vec_i64(t, 0), _vec_bytes(t, 1),
                              _i8(t, 2, 5), _i8(t, 3, 0))


def _decode_flat_array(info, buf, dt, order) -> np.ndarray:
    """Pure decode: (shapeInfo, buffer, DType enum, ByteOrder) -> ndarray."""
    np_dt = _DTYPES.get(dt)
    if np_dt is None:
        raise ValueError(f"unsupported FlatArray dtype enum {dt}")
    rank = int(info[0]) if info else 0
    shape = tuple(int(d) for d in info[1:1 + rank])
    arr = np.frombuffer(buf, dtype=np_dt)
    if order == 1:
        arr = arr.byteswap()
    n = int(np.prod(shape)) if shape else 1
    if arr.size < n:
        raise ValueError(f"FlatArray buffer too small: {arr.size} < {n}")
    mem_order = "C"
    if rank > 1 and len(info) >= 2 * rank + 4:
        order_char = int(info[-1])
        if order_char == 102:
            mem_order = "F"
        elif order_char not in (99, 0):
            raise ValueError(
                f"unrecognized shapeInfo order char {order_char} "
                f"(expected 99 'c' or 102 'f')")
    return np.asarray(arr[:n].reshape(shape, order=mem_order), order="C")


# ---------------------------------------------------------------------------
# Schema-level records
# ---------------------------------------------------------------------------

_ALL_DIMS = 2147483647  # Integer.MAX_VALUE: reference marker for "all dims"


class FlatNodeRec:
    """One FlatNode (node.fbs) with the fields execution needs."""

    def __init__(self, t):
        self.id = _i32(t, 0)
        self.name = _string(t, 1)
        self.op_type = _i8(t, 2)
        self.op_num = _i64(t, 3)
        self.inputs: List[Tuple[int, int]] = []
        for i in range(_vec_len(t, 6)):  # inputPaired
            p = _vec_table(t, 6, i)
            self.inputs.append((_i32(p, 0), _i32(p, 1)))
        if not self.inputs:  # legacy `input:[int]` encoding
            self.inputs = [(i, 0) for i in _vec_i32(t, 5)]
        self.t_args = _vec_f64(t, 8)      # extraParams
        self.i_args = _vec_i64(t, 9)      # extraInteger
        self.b_args = _vec_bool(t, 10)    # extraBools
        self.dimensions = _vec_i32(t, 11)
        self.output_names = _vec_str(t, 15)
        self.op_name = _string(t, 16)
        sc = _subtable(t, 18)
        self.scalar = _flat_array(sc) if sc is not None else None


class FlatVariableRec:
    """One FlatVariable (variable.fbs)."""

    def __init__(self, t):
        idp = _subtable(t, 0)
        self.id = (_i32(idp, 0), _i32(idp, 1)) if idp is not None else (0, 0)
        self.name = _string(t, 1)
        self.dtype = _i8(t, 2, 5)
        self.shape = _vec_i64(t, 3)
        nd = _subtable(t, 4)
        self.array = _flat_array(nd) if nd is not None else None
        # VarType: 0=VARIABLE 1=CONSTANT 2=ARRAY 3=PLACEHOLDER
        self.var_type = _i8(t, 6)


class UpdaterStateRec:
    """One UpdaterState (graph.fbs): per-parameter optimizer state."""

    def __init__(self, t):
        self.param_name = _string(t, 0)
        self.keys = _vec_str(t, 1)
        self.values = [_flat_array(_vec_table(t, 2, i))
                       for i in range(_vec_len(t, 2))]


class FlatGraphFile:
    """Parsed FlatGraph (graph.fbs) — raw records before SameDiff rebuild."""

    def __init__(self, data: bytes):
        g = _root(data)
        self.graph_id = _i64(g, 0)
        self.variables = [FlatVariableRec(_vec_table(g, 1, i))
                          for i in range(_vec_len(g, 1))]
        self.nodes = [FlatNodeRec(_vec_table(g, 2, i))
                      for i in range(_vec_len(g, 2))]
        self.placeholders = _vec_str(g, 5)
        self.loss_variables = _vec_str(g, 6)
        self.training_config = _string(g, 7)
        self.updater_state = [UpdaterStateRec(_vec_table(g, 8, i))
                              for i in range(_vec_len(g, 8))]


# ---------------------------------------------------------------------------
# Op conversion: FlatNode -> registered op + kwargs
# ---------------------------------------------------------------------------

def _dims_arg(node: FlatNodeRec) -> Optional[List[int]]:
    dims = node.dimensions or [int(d) for d in node.i_args]
    if not dims or _ALL_DIMS in dims:
        return None
    return list(dims)


def _conv_matmul(node):
    ia = list(node.i_args) + [0, 0, 0]
    ta = list(node.t_args) + [1.0, 0.0]
    kw = {}
    if ia[0]:
        kw["transpose_a"] = True
    if ia[1]:
        kw["transpose_b"] = True
    if ta[0] != 1.0:
        kw["alpha"] = float(ta[0])
    return "matmul", kw


def _conv_softmax(node):
    axis = int(node.i_args[0]) if node.i_args else -1
    # keep the node's own op (softmax vs log_softmax) — only the axis
    # arg needs decoding
    return node.op_name or "softmax", {"axis": axis}


def _reduction(op_name):
    def conv(node):
        kw: Dict[str, Any] = {}
        d = _dims_arg(node)
        if d is not None:
            kw["dims"] = d
        if node.b_args and node.b_args[0]:
            kw["keep_dims"] = True
        return op_name, kw
    return conv


def _conv_axis(key):
    return lambda node: (node.op_name, {key: int(node.i_args[0])})


def _conv_axes(key):
    return lambda node: (node.op_name, {
        key: tuple(int(a) for a in node.i_args) or None})


def _conv_reshape(node):
    return "reshape", {"shape": tuple(int(d) for d in node.i_args[1:])}


def _conv_onehot(node):
    return "onehot", {"axis": int(node.i_args[0]),
                      "depth": int(node.i_args[1]),
                      "on_value": float(node.t_args[0]),
                      "off_value": float(node.t_args[1])}


def _conv_cast(node):
    return "cast", {"dtype": dtype_name(_DTYPES[int(node.i_args[0])])}


def _conv_biasadd(node):
    return "biasadd", {"nchw": bool(node.b_args and node.b_args[0])}


def _conv_strided_slice(node):
    """The inverse of the writer's strided_slice packing: the index spec
    ``tf_strided_slice`` takes."""
    ia = [int(a) for a in node.i_args]
    begin_m, ellipsis_m, end_m, new_m, shrink_m = ia[:5]
    n = (len(ia) - 5) // 3
    begin, end, strides = ia[5:5 + n], ia[5 + n:5 + 2 * n], ia[5 + 2 * n:]
    spec = []
    for i in range(n):
        bit = 1 << i
        if new_m & bit:
            spec.append(("newaxis",))
        elif ellipsis_m & bit:
            spec.append(("ellipsis",))
        elif shrink_m & bit:
            spec.append(("int", begin[i]))
        elif begin_m & end_m & bit and strides[i] == 1:
            spec.append(("all",))
        else:
            spec.append(("slice", None if begin_m & bit else begin[i],
                         None if end_m & bit else end[i], strides[i]))
    return "tf_strided_slice", {"spec": spec}


# opName -> converter.  Anything absent falls back to a bare registry call
# with no kwargs (correct for elementwise/pairwise ops, which is the long
# tail of what asFlatGraph emits).
_CONVERTERS = {
    "matmul": _conv_matmul,
    "mmul": _conv_matmul,
    "softmax": _conv_softmax,
    "log_softmax": _conv_softmax,
    "reduce_mean": _reduction("reduce_mean"),
    "mean": _reduction("reduce_mean"),
    "reduce_sum": _reduction("reduce_sum"),
    "sum": _reduction("reduce_sum"),
    "reduce_max": _reduction("reduce_max"),
    "max": _reduction("reduce_max"),
    "reduce_min": _reduction("reduce_min"),
    "min": _reduction("reduce_min"),
    "reduce_prod": _reduction("reduce_prod"),
    "norm2": _reduction("reduce_norm2"),
    "argmax": _reduction("argmax"),
    "argmin": _reduction("argmin"),
    # reference gruCell declares 4 outputs (r, u, c, h); the 1-output
    # registry 'gruCell' is the h-only convenience, so route to the
    # full-output port
    "gruCell": lambda node: ("gru_block_cell", {}),
    # the shape ops of an imported TF graph, as the port's writer packs
    # them (``autodiff/serialization.py``)
    "reshape": _conv_reshape,
    "transpose": _conv_axes("axes"), "squeeze": _conv_axes("axis"),
    "gather": _conv_axis("axis"), "expand_dims": _conv_axis("axis"),
    "onehot": _conv_onehot, "cast": _conv_cast, "biasadd": _conv_biasadd,
    "tf_strided_slice": _conv_strided_slice,
}

# Legacy nodes (opType != CUSTOM) sometimes omit opName; resolve the few
# (opType, opNum) pairs the reference writer emits for them.
# Sources: libnd4j legacy_ops.h op enumerations.
_LEGACY_NAMES = {
    (3, 29): "tanh", (3, 10): "sigmoid", (3, 35): "exp", (3, 36): "log",
    (1, 12): "abs", (1, 6): "neg", (2, 0): "isnan",
    (5, 0): "reduce_mean", (6, 0): "reduce_sum", (6, 3): "reduce_max",
    (6, 4): "reduce_min", (6, 8): "reduce_prod",
    (9, 0): "argmax", (9, 1): "argmin",
}


class SameDiffFbImport:
    """Rebuild a SameDiff on ``device`` from a parsed FlatGraph."""

    def __init__(self, flat: FlatGraphFile, device="cuda"):
        self.flat = flat
        self.sd = SameDiff(device=device)
        # (node_id, out_idx) -> SDVariable
        self._by_id: Dict[Tuple[int, int], SDVariable] = {}

    def convert(self) -> SameDiff:
        reg = OpRegistry.get()
        ph = set(self.flat.placeholders)
        node_ids = {n.id for n in self.flat.nodes}
        for v in self.flat.variables:
            if v.var_type == 2 or (v.id[0] in node_ids and v.array is None
                                   and v.name not in ph):
                continue  # ARRAY: produced by a node during conversion
            if v.var_type == 3 or v.name in ph:
                shape = (tuple(None if s < 0 else int(s) for s in v.shape)
                         if v.shape else None)
                dt = _DTYPES.get(v.dtype, np.float32)
                var = self.sd.placeholder(v.name, shape=shape,
                                          dtype=dtype_name(dt))
            elif v.var_type == 1:
                var = self.sd.constant(np.asarray(v.array), name=v.name)
            elif v.var_type == 0:
                if v.array is None:
                    raise ValueError(f"VARIABLE '{v.name}' has no ndarray")
                var = self.sd.var(v.name, value=np.asarray(v.array))
            else:
                continue
            self._by_id[v.id] = var

        for node in self._topo_order():
            ins = []
            for key in node.inputs:
                src = self._by_id.get(key)
                if src is None:
                    raise ValueError(
                        f"node '{node.name}' input {key} unresolved "
                        f"(cyclic or unsupported producer)")
                ins.append(src)
            op_name = node.op_name or _LEGACY_NAMES.get(
                (node.op_type, node.op_num))
            if op_name is None:
                raise ValueError(
                    f"node '{node.name}': no opName and unknown legacy pair "
                    f"(opType={node.op_type}, opNum={node.op_num})")
            conv = _CONVERTERS.get(op_name)
            if conv is not None:
                reg_name, kwargs = conv(node)
            else:
                reg_name, kwargs = op_name, {}
            if not reg.has(reg_name):
                raise ValueError(
                    f"node '{node.name}': op '{reg_name}' not registered")
            out_names = list(node.output_names) or [node.name]
            if node.scalar is not None and not ins:
                out = self.sd.constant(np.asarray(node.scalar),
                                       name=out_names[0])
                outs = (out,)
            else:
                if node.scalar is not None:
                    ins.append(self.sd.constant(np.asarray(node.scalar),
                                                name=f"{node.name}_scalar"))
                out = self.sd._record(reg_name, ins,
                                      n_outputs=len(out_names),
                                      out_names=out_names, **kwargs)
                outs = out if isinstance(out, tuple) else (out,)
            for i, v in enumerate(outs):
                self._by_id[(node.id, i)] = v
        return self.sd

    def _topo_order(self) -> List[FlatNodeRec]:
        """Nodes in producer-before-consumer order (writer order is close
        but not guaranteed — InferenceSession resolves lazily)."""
        pending = {n.id: n for n in self.flat.nodes}
        done = set(self._by_id)
        order: List[FlatNodeRec] = []
        while pending:
            progressed = False
            for nid in list(pending):
                n = pending[nid]
                if all(k in done or k[0] not in pending for k in n.inputs):
                    order.append(n)
                    done.add((nid, 0))
                    del pending[nid]
                    progressed = True
            if not progressed:
                raise ValueError(
                    f"cyclic FlatGraph: unresolved nodes "
                    f"{[pending[i].name for i in pending]}")
        return order


def load_samediff_fb(path: str, device="cuda") -> SameDiff:
    """Load a reference-produced SameDiff ``.fb`` file as a SameDiff on
    ``device``.

    The returned graph runs with ``sd.output(...)``; loss variables and
    placeholders from the file are preserved as ``sd.fb_loss_variables``
    / placeholder vars.
    """
    with open(path, "rb") as f:
        data = f.read()
    flat = FlatGraphFile(data)
    sd = SameDiffFbImport(flat, device).convert()
    sd.fb_loss_variables = list(flat.loss_variables)
    sd._loss_variables = list(flat.loss_variables)
    sd.fb_training_config = flat.training_config
    if flat.updater_state:
        # rebuild the native layout {state_key: {param: array}} so a
        # restored graph resumes training exactly where it stopped
        state: Dict[str, Dict[str, Any]] = {}
        for rec in flat.updater_state:
            for key, arr in zip(rec.keys, rec.values):
                state.setdefault(key, {})[rec.param_name] = to_tensor(
                    arr, sd.device)
        sd._updater_state = state
        sd.fb_updater_state = {
            rec.param_name: dict(zip(rec.keys, rec.values))
            for rec in flat.updater_state}
    return sd
