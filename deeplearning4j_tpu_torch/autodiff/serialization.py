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
must be a registered op. ``SameDiff.save_flatbuffers`` (the reference
FlatBuffers writer) is not ported (``ROADMAP.md`` queue 1 item 11).
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
