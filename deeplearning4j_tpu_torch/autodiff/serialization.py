"""SameDiff graph serialization.

Counterpart of ``save`` / ``load`` of
``deeplearning4j_tpu/autodiff/serialization.py``, in its format, so that
either package loads what the other saved: a zip holding ``graph.json``
(variables and op nodes by registry name) and ``arrays.npz`` (the
VARIABLE / CONSTANT values, ``/`` in a name written ``__SLASH__``, and
optionally the updater state as ``__updater__/<i>``, its leaves in
``jax.tree_util`` order: sorted dict keys, lists in order).

bf16 arrays are written as the JAX package's ``np.savez`` writes an
``ml_dtypes`` bf16 array: the raw 2-byte values, a ``V2`` record in the
``.npy`` header; the port reads such a record back as bf16. Ops recorded
from raw functions (``_record_fn``) are refused at save time: every node
must be a registered op.

``save_flatbuffers`` writes the reference's FlatGraph ``.fb`` (the JAX
package's writer, on the port's own builder, ``modelimport/flatbuf.py``);
``modelimport/samediff_fb.py`` reads it back.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any

import numpy as np
import torch

from ..ops import OpRegistry
from ..ops._util import tree_leaves

FORMAT_VERSION = 1
_UPDATER = "__updater__/"


def host_array(t) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as its raw 2-byte values (a
    ``V2`` record, what ``np.savez`` writes for an ``ml_dtypes`` bf16
    array)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_host(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def _json_safe(v: Any):
    from .subgraph import SubGraph
    if isinstance(v, SubGraph):
        return {"__subgraph__": v.to_dict()}
    if isinstance(v, torch.dtype):
        return {"__dtype__": str(v).replace("torch.", "")}
    if isinstance(v, np.dtype):
        return {"__dtype__": str(v)}
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        dt = str(t.dtype).replace("torch.", "")
        return {"__array__": t.float().tolist() if dt == "bfloat16"
                else t.tolist(), "__adtype__": dt}
    if isinstance(v, np.ndarray):
        return {"__array__": v.tolist(), "__adtype__": str(v.dtype)}
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _json_restore(v: Any, device="cpu"):
    if isinstance(v, dict):
        if "__subgraph__" in v:
            from .subgraph import SubGraph
            return SubGraph.from_dict(v["__subgraph__"], device)
        if "__dtype__" in v:
            return v["__dtype__"]
        if "__array__" in v:
            dt = getattr(torch, v["__adtype__"])
            return torch.tensor(v["__array__"], dtype=dt, device=device)
        return {k: _json_restore(x, device) for k, x in v.items()}
    if isinstance(v, list):
        return [_json_restore(x, device) for x in v]
    return v


def save(sd, path, save_updater_state: bool = False):
    reg = OpRegistry.get()
    nodes = []
    for name in sd._op_order:
        node = sd._ops[name]
        if not reg.has(node.op_name):
            raise ValueError(
                f"op {node.name!r} ({node.op_name}) was recorded from a raw "
                f"function and cannot be serialized; register it as a "
                f"named op")
        nodes.append({
            "name": node.name, "op": node.op_name, "inputs": node.inputs,
            "outputs": node.outputs, "kwargs": _json_safe(node.kwargs),
            "needs_key": node.needs_key,
        })

    graph = {
        "format_version": FORMAT_VERSION,
        "variables": [
            {"name": v.name, "type": v.var_type.value, "shape": v.shape,
             "dtype": v.dtype}
            for v in sd._vars.values()
        ],
        "ops": nodes,
        "op_order": sd._op_order,
        "loss_variables": sd._loss_variables,
        "training_config": _training_config_dict(sd.training_config),
    }

    arrays = {n: host_array(a) for n, a in sd._arrays.items()}
    if save_updater_state and sd._updater_state is not None:
        for i, leaf in enumerate(tree_leaves(sd._updater_state)):
            arrays[f"{_UPDATER}{i}"] = host_array(leaf)

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("graph.json", json.dumps(graph, indent=1))
        buf = io.BytesIO()
        np.savez(buf, **{k.replace("/", "__SLASH__"): v
                         for k, v in arrays.items()})
        z.writestr("arrays.npz", buf.getvalue())


def _training_config_dict(tc):
    if tc is None:
        return None
    return {
        "updater": tc.updater.to_dict(),
        "l1": tc.l1, "l2": tc.l2, "weight_decay": tc.weight_decay,
        "data_set_feature_mapping": list(tc.data_set_feature_mapping),
        "data_set_label_mapping": list(tc.data_set_label_mapping),
        "loss_variables": list(tc.loss_variables),
        "minimize": tc.minimize,
    }


# ---------------------------------------------------------------------------
# Reference-format FlatBuffers writer (the SameDiff.asFlatBuffers analog:
# `SameDiff.java:5465-5727`; schemas `libnd4j/include/graph/scheme/*.fbs`).
# Emits a FlatGraph the JVM reference and both packages' readers
# (`modelimport/samediff_fb.py`) can load: variables (VARIABLE/CONSTANT
# with ndarrays, PLACEHOLDER with shapes, ARRAY stubs), FlatNodes with
# inputPaired wiring + per-op arg packing, lossVariables, trainingConfig
# JSON, and per-param UpdaterState.
# ---------------------------------------------------------------------------

_FB_DTYPES = {"bool": 1, "float16": 3, "float32": 5, "float64": 6,
              "int8": 7, "int16": 8, "int32": 9, "int64": 10,
              "uint8": 11, "uint16": 12, "uint32": 13, "uint64": 14,
              "bfloat16": 17}
_FB_OPTYPE_CUSTOM = 21   # OpType.CUSTOM (utils.fbs)
_FB_ALL_DIMS = 2147483647


def _fb_dtype_enum(dt) -> int:
    from ..modelimport.ir import dtype_name
    name = dt if isinstance(dt, str) else dtype_name(dt)
    try:
        return _FB_DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {dt} has no FlatBuffers DType enum")


def _fb_str_vector(b, strings):
    offs = [b.CreateString(s) for s in strings]
    return _fb_table_vector(b, offs)


def _fb_table_vector(b, offs):
    b.StartVector(4, len(offs), 4)
    for o in reversed(offs):
        b.PrependUOffsetTRelative(o)
    return b.EndVector()


def _fb_flat_array(b, arr) -> int:
    """FlatArray table: nd4j shapeInfo [rank, *shape, *strides, extras,
    ews, order] + raw C-order buffer."""
    arr = np.ascontiguousarray(host_array(arr))
    rank = arr.ndim
    strides = []
    if rank:
        acc = 1
        for d in reversed(arr.shape):
            strides.insert(0, acc)
            acc *= d
    info = np.asarray([rank, *arr.shape, *strides, 0, 1, 99], np.int64)
    buf_off = b.CreateByteVector(arr.tobytes())
    info_off = b.CreateNumpyVector(info)
    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(1, buf_off, 0)
    b.PrependUOffsetTRelativeSlot(0, info_off, 0)
    b.PrependInt8Slot(2, _fb_dtype_enum(arr.dtype), 0)
    b.PrependInt8Slot(3, 0, 0)   # ByteOrder.LE
    return b.EndObject()


def _fb_int_pair(b, first, second) -> int:
    b.StartObject(2)
    b.PrependInt32Slot(1, int(second), 0)
    b.PrependInt32Slot(0, int(first), 0)
    return b.EndObject()


# Per-op argument packing: kwargs -> (i_args, t_args, b_args, dimensions).
# These are the exact inverses of the reader's _CONVERTERS
# (modelimport/samediff_fb.py), so writer->reader round-trips losslessly.

def _pack_matmul(kw):
    return dict(i_args=[1 if kw.get("transpose_a") else 0,
                        1 if kw.get("transpose_b") else 0],
                t_args=[float(kw.get("alpha", 1.0))]), \
        {"transpose_a", "transpose_b", "alpha"}


def _pack_softmax(kw):
    return dict(i_args=[int(kw.get("axis", -1))]), {"axis"}


def _pack_reduction(kw):
    out = {}
    dims = kw.get("dims")
    out["dimensions"] = ([int(d) for d in dims] if dims is not None
                         else [_FB_ALL_DIMS])
    if kw.get("keep_dims"):
        out["b_args"] = [True]
    return out, {"dims", "keep_dims"}


# The shape ops of an imported TF graph (the port packs these beyond the
# JAX package's writer, whose reader runs them without their kwargs), in
# the reference's encodings: reshape [order 'c', *shape], permute / squeeze
# axes, gather / expand_dims axis, onehot [axis, depth] + [on, off], cast
# [DType], biasadd [nchw] and strided_slice [begin, ellipsis, end,
# new_axis, shrink masks, *begin, *end, *strides].

def _pack_axis(key):
    return lambda kw: (dict(i_args=[int(kw.get(key, 0))]), {key})


def _pack_axes(key):
    def pack(kw):
        v = kw.get(key)
        return dict(i_args=[] if v is None else
                    [int(a) for a in np.atleast_1d(v)]), {key}
    return pack


def _pack_reshape(kw):
    return dict(i_args=[99] + [int(d) for d in kw["shape"]]), {"shape"}


def _pack_onehot(kw):
    return dict(i_args=[int(kw.get("axis", -1)), int(kw["depth"])],
                t_args=[float(kw.get("on_value", 1.0)),
                        float(kw.get("off_value", 0.0))]), \
        {"axis", "depth", "on_value", "off_value"}


def _pack_cast(kw):
    return dict(i_args=[_fb_dtype_enum(str(kw["dtype"]))]), {"dtype"}


def _pack_biasadd(kw):
    return dict(b_args=[bool(kw.get("nchw", False))]), {"nchw"}


def _pack_strided_slice(kw):
    masks = [0] * 5          # begin, ellipsis, end, new_axis, shrink
    begin, end, strides = [], [], []
    for i, entry in enumerate(kw["spec"]):
        kind, bit = entry[0], 1 << i
        b_, e_, s_ = 0, 0, 1
        if kind == "slice":
            b_, e_, s_ = entry[1], entry[2], entry[3]
            if b_ is None:
                masks[0] |= bit
            if e_ is None:
                masks[2] |= bit
        elif kind == "int":
            b_, e_ = entry[1], entry[1] + 1
            masks[4] |= bit
        elif kind == "newaxis":
            masks[3] |= bit
        elif kind == "ellipsis":
            masks[1] |= bit
        else:                # "all"
            masks[0] |= bit
            masks[2] |= bit
        begin.append(b_ or 0)
        end.append(e_ or 0)
        strides.append(s_)
    return dict(i_args=masks + begin + end + strides), {"spec"}


_FB_PACKERS = {
    "matmul": _pack_matmul,
    "softmax": _pack_softmax,
    "log_softmax": _pack_softmax,
    "reduce_mean": _pack_reduction, "reduce_sum": _pack_reduction,
    "reduce_max": _pack_reduction, "reduce_min": _pack_reduction,
    "reduce_prod": _pack_reduction, "reduce_norm2": _pack_reduction,
    "argmax": _pack_reduction, "argmin": _pack_reduction,
    "reshape": _pack_reshape,
    "transpose": _pack_axes("axes"), "squeeze": _pack_axes("axis"),
    "gather": _pack_axis("axis"), "expand_dims": _pack_axis("axis"),
    "onehot": _pack_onehot, "cast": _pack_cast, "biasadd": _pack_biasadd,
    "tf_strided_slice": _pack_strided_slice,
}


def _fb_pack_kwargs(node, opdef):
    """kwargs -> FlatNode arg vectors; unencodable non-default kwargs fail
    loudly (same contract as the JSON path's raw-function rejection)."""
    import inspect
    packer = _FB_PACKERS.get(node.op_name)
    if packer is not None:
        packed, known = packer(node.kwargs)
        extra = {k: v for k, v in node.kwargs.items() if k not in known}
    else:
        packed, extra = {}, dict(node.kwargs)
    if extra:
        # kwargs equal to the op's declared defaults carry no information
        def _is_default(param, v):
            if param.default is inspect.Parameter.empty:
                return False
            try:
                return bool(param.default == v)
            except (TypeError, ValueError, RuntimeError):
                # array-valued kwarg: `default == v` broadcasts and bool()
                # raises "truth value is ambiguous" — treat as non-default
                # so the clean ValueError below names the offending op
                return False
        try:
            sig = inspect.signature(opdef.fn)
            extra = {k: v for k, v in extra.items()
                     if not (k in sig.parameters
                             and _is_default(sig.parameters[k], v))}
        except (TypeError, ValueError):  # builtins without signatures
            pass
    if extra:
        raise ValueError(
            f"op {node.name!r} ({node.op_name}): kwargs {sorted(extra)} "
            f"have no FlatBuffers arg packing; extend _FB_PACKERS (and the "
            f"reader's _CONVERTERS) to serialize this op faithfully")
    return packed


def save_flatbuffers(sd, path, save_updater_state: bool = False):
    """Write the graph as a reference-format FlatGraph ``.fb`` file."""
    from ..modelimport.flatbuf import Builder
    from .samediff import VariableType

    reg = OpRegistry.get()
    b = Builder(4096)

    # ids: op nodes 1..N in recorded order; leaf variables after
    op_ids = {name: i + 1 for i, name in enumerate(sd._op_order)}
    var_ids = {}
    for opn in sd._op_order:
        for idx, out in enumerate(sd._ops[opn].outputs):
            var_ids[out] = (op_ids[opn], idx)
    next_id = len(sd._op_order) + 1
    for v in sd._vars.values():
        if v.name not in var_ids:
            var_ids[v.name] = (next_id, 0)
            next_id += 1

    # -- FlatNodes --------------------------------------------------------
    node_offs = []
    for opn in sd._op_order:
        node = sd._ops[opn]
        if not reg.has(node.op_name):
            raise ValueError(
                f"op {node.name!r} ({node.op_name}) was recorded from a raw "
                f"function and cannot be serialized; register it as a named "
                f"op")
        if node.needs_key:
            raise ValueError(
                f"op {node.name!r} ({node.op_name}) consumes RNG state; "
                f"random ops are not serializable to the reference format")
        packed = _fb_pack_kwargs(node, reg.lookup(node.op_name))

        name_off = b.CreateString(node.name)
        opname_off = b.CreateString(node.op_name)
        outnames_off = _fb_str_vector(b, node.outputs)
        pair_offs = [_fb_int_pair(b, *var_ids[i]) for i in node.inputs]
        inputs_off = _fb_table_vector(b, pair_offs)
        vec_offs = {}
        if packed.get("t_args"):
            vec_offs["t"] = b.CreateNumpyVector(
                np.asarray(packed["t_args"], np.float64))
        if packed.get("i_args"):
            vec_offs["i"] = b.CreateNumpyVector(
                np.asarray(packed["i_args"], np.int64))
        if packed.get("b_args"):
            ba = packed["b_args"]
            b.StartVector(1, len(ba), 1)
            for x in reversed(ba):
                b.PrependBool(bool(x))
            vec_offs["b"] = b.EndVector()
        if packed.get("dimensions"):
            vec_offs["d"] = b.CreateNumpyVector(
                np.asarray(packed["dimensions"], np.int32))

        b.StartObject(24)
        b.PrependInt32Slot(0, op_ids[opn], 0)
        b.PrependUOffsetTRelativeSlot(1, name_off, 0)
        b.PrependInt8Slot(2, _FB_OPTYPE_CUSTOM, 0)
        b.PrependUOffsetTRelativeSlot(6, inputs_off, 0)
        if "t" in vec_offs:
            b.PrependUOffsetTRelativeSlot(8, vec_offs["t"], 0)
        if "i" in vec_offs:
            b.PrependUOffsetTRelativeSlot(9, vec_offs["i"], 0)
        if "b" in vec_offs:
            b.PrependUOffsetTRelativeSlot(10, vec_offs["b"], 0)
        if "d" in vec_offs:
            b.PrependUOffsetTRelativeSlot(11, vec_offs["d"], 0)
        b.PrependUOffsetTRelativeSlot(15, outnames_off, 0)
        b.PrependUOffsetTRelativeSlot(16, opname_off, 0)
        node_offs.append(b.EndObject())

    # -- FlatVariables ----------------------------------------------------
    _VT = {VariableType.VARIABLE: 0, VariableType.CONSTANT: 1,
           VariableType.ARRAY: 2, VariableType.PLACEHOLDER: 3}
    var_offs = []
    for v in sd._vars.values():
        name_off = b.CreateString(v.name)
        arr_off = None
        if v.var_type in (VariableType.VARIABLE, VariableType.CONSTANT):
            if v.name not in sd._arrays:
                raise ValueError(f"{v.var_type.value} {v.name!r} has no "
                                 f"array value to serialize")
            arr_off = _fb_flat_array(b, sd._arrays[v.name])
        shape_off = None
        if v.shape is not None:
            # dynamic dims (None) are written as -1, the reference marker
            shape_off = b.CreateNumpyVector(
                np.asarray([-1 if s is None else int(s) for s in v.shape],
                           np.int64))
        id_off = _fb_int_pair(b, *var_ids[v.name])
        b.StartObject(10)
        b.PrependUOffsetTRelativeSlot(0, id_off, 0)
        b.PrependUOffsetTRelativeSlot(1, name_off, 0)
        b.PrependInt8Slot(2, _fb_dtype_enum(v.dtype), 0)
        if shape_off is not None:
            b.PrependUOffsetTRelativeSlot(3, shape_off, 0)
        if arr_off is not None:
            b.PrependUOffsetTRelativeSlot(4, arr_off, 0)
        b.PrependInt8Slot(6, _VT[v.var_type], 0)
        var_offs.append(b.EndObject())

    # -- UpdaterState ------------------------------------------------------
    upd_offs = []
    if save_updater_state and sd._updater_state is not None:
        # updater state shape: {state_key: {param_name: array}}
        state = sd._updater_state
        by_param = {}
        for key in sorted(state):
            for pname, arr in state[key].items():
                by_param.setdefault(pname, []).append((key, arr))
        for pname, pairs in sorted(by_param.items()):
            pn_off = b.CreateString(pname)
            keys_off = _fb_str_vector(b, [k for k, _ in pairs])
            vals_off = _fb_table_vector(
                b, [_fb_flat_array(b, a) for _, a in pairs])
            b.StartObject(3)
            b.PrependUOffsetTRelativeSlot(0, pn_off, 0)
            b.PrependUOffsetTRelativeSlot(1, keys_off, 0)
            b.PrependUOffsetTRelativeSlot(2, vals_off, 0)
            upd_offs.append(b.EndObject())

    # -- FlatGraph ---------------------------------------------------------
    placeholders = [v.name for v in sd._vars.values()
                    if v.var_type == VariableType.PLACEHOLDER]
    vars_off = _fb_table_vector(b, var_offs)
    nodes_off = _fb_table_vector(b, node_offs)
    ph_off = _fb_str_vector(b, placeholders)
    loss_off = _fb_str_vector(b, sd._loss_variables)
    tc = _training_config_dict(sd.training_config)
    tc_off = b.CreateString(json.dumps(tc)) if tc is not None else None
    upd_vec_off = _fb_table_vector(b, upd_offs) if upd_offs else None

    b.StartObject(9)
    b.PrependUOffsetTRelativeSlot(1, vars_off, 0)
    b.PrependUOffsetTRelativeSlot(2, nodes_off, 0)
    b.PrependUOffsetTRelativeSlot(5, ph_off, 0)
    b.PrependUOffsetTRelativeSlot(6, loss_off, 0)
    if tc_off is not None:
        b.PrependUOffsetTRelativeSlot(7, tc_off, 0)
    if upd_vec_off is not None:
        b.PrependUOffsetTRelativeSlot(8, upd_vec_off, 0)
    b.Finish(b.EndObject())

    with open(path, "wb") as f:
        f.write(b.Output())


def _unflatten(template, leaves):
    """``leaves`` in ``template``'s structure (sorted dict keys, lists in
    order): the inverse of ``tree_leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            seq = [build(v) for v in node]
            return seq if isinstance(node, list) else tuple(seq)
        return next(it)

    return build(template)


def load(path, device="cuda"):
    """A SameDiff graph from ``path`` (either package's save) on
    ``device``. The updater state, when the file holds one and a training
    config, comes back in the config updater's layout."""
    from ..learning import IUpdater
    from .samediff import SameDiff, SameDiffOp, SDVariable, VariableType
    from .training import TrainingConfig

    with zipfile.ZipFile(path) as z:
        graph = json.loads(z.read("graph.json"))
        with z.open("arrays.npz") as f:
            npz = np.load(io.BytesIO(f.read()), allow_pickle=False)
            arrays = {k.replace("__SLASH__", "/"): npz[k] for k in npz.files}

    sd = SameDiff(device=device)
    for vd in graph["variables"]:
        v = SDVariable(sd, vd["name"], VariableType(vd["type"]),
                       tuple(vd["shape"]) if vd["shape"] else None,
                       vd["dtype"])
        sd._vars[v.name] = v
    reg = OpRegistry.get()
    for nd_ in graph["ops"]:
        opdef = reg.lookup(nd_["op"])
        node = SameDiffOp(nd_["name"], nd_["op"], opdef.fn, nd_["inputs"],
                          nd_["outputs"],
                          _json_restore(nd_["kwargs"], sd.device),
                          nd_.get("needs_key", False))
        sd._ops[node.name] = node
        for i, oname in enumerate(node.outputs):
            sd._producer[oname] = (node.name, i)
    sd._op_order = graph["op_order"]
    sd._loss_variables = graph.get("loss_variables", [])
    for name, arr in arrays.items():
        if not name.startswith(_UPDATER):
            sd._arrays[name] = _from_host(arr, sd.device)
    tc = graph.get("training_config")
    if tc:
        sd.training_config = TrainingConfig(
            updater=IUpdater.from_dict(tc["updater"]),
            l1=tc["l1"], l2=tc["l2"], weight_decay=tc["weight_decay"],
            data_set_feature_mapping=tc["data_set_feature_mapping"],
            data_set_label_mapping=tc["data_set_label_mapping"],
            loss_variables=tc["loss_variables"], minimize=tc["minimize"])
        n_upd = sum(1 for k in arrays if k.startswith(_UPDATER))
        if n_upd:
            params = {v.name: sd._arrays[v.name]
                      for v in sd.trainable_variables()}
            template = sd.training_config.updater.init(params)
            leaves = [_from_host(arrays[f"{_UPDATER}{i}"], sd.device)
                      for i in range(n_upd)]
            if len(tree_leaves(template)) == n_upd:
                sd._updater_state = _unflatten(template, leaves)
    return sd
