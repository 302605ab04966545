"""Framework-agnostic import IR + mapping-rule registry.

Counterpart of ``deeplearning4j_tpu/modelimport/ir.py`` (the reference's
``ImportGraph.kt:68``: importGraph walks IRGraph nodes, resolving each
through a mapping-rule registry into SameDiff ops).

Mapping rules emit *registered ops* into a SameDiff graph on the
importer's device, so an imported model runs like a natively built one.
Shape-ish constant inputs (reshape targets, axes, perms) fold into static
kwargs at import time, as in the JAX package.

Static shapes propagate through the emitted ops as the JAX package's
``jax.eval_shape`` does, by running each op once on ``meta`` tensors
(shapes and dtypes, no data, no launch). An op that reads its data on
the host (an ``.item()``, a numpy round trip) raises there, and its
outputs then have no static shape, as an op ``jax.eval_shape`` cannot
trace has none in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..autodiff.samediff import SameDiff, SDVariable, run_node
from ..ops import OpRegistry
from ..ops._util import narrow

#: bfloat16 on the host: its raw 2-byte values (the port has no
#: ``ml_dtypes``), as ``autodiff/serialization.py`` writes them
BFLOAT16 = np.dtype("V2")


def is_bf16(dtype) -> bool:
    return np.dtype(dtype) == BFLOAT16


def dtype_name(dtype) -> str:
    """A numpy dtype's name, ``"bfloat16"`` for :data:`BFLOAT16`."""
    return "bfloat16" if is_bf16(dtype) else np.dtype(dtype).name


class ImportException(Exception):
    pass


class Aval(NamedTuple):
    """A static shape and numpy dtype (the JAX package's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: np.dtype


_META = torch.device("meta")


def _meta_tensor(a: Aval) -> torch.Tensor:
    dt = torch.bfloat16 if is_bf16(a.dtype) else \
        narrow(torch.from_numpy(np.zeros(0, a.dtype)).dtype)
    return torch.empty(a.shape, dtype=dt, device=_META)


def _aval_of(t: torch.Tensor) -> Aval:
    if t.dtype == torch.bfloat16:
        return Aval(tuple(t.shape), BFLOAT16)
    return Aval(tuple(t.shape), torch.empty(0, dtype=t.dtype).numpy().dtype)


@dataclasses.dataclass
class IRNode:
    """One foreign-graph node in framework-neutral form."""
    name: str
    op_type: str
    inputs: List[str]            # producer tensor names (foreign naming)
    outputs: List[str]           # tensor names this node produces
    attrs: Dict[str, Any]
    control_inputs: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class IRGraph:
    """Parsed foreign graph, before mapping."""
    framework: str
    nodes: List[IRNode]
    initializers: Dict[str, np.ndarray]          # weights/consts by tensor name
    inputs: Dict[str, Any]                       # name -> (shape, dtype)
    outputs: List[str]

    def node_map(self) -> Dict[str, IRNode]:
        m = {}
        for n in self.nodes:
            for o in n.outputs:
                m[o] = n
        return m


# --------------------------------------------------------------- registry
# framework -> op_type -> mapper(node, ctx) (ImportGraph's OpMappingRegistry)
_MAPPERS: Dict[str, Dict[str, Callable]] = {}


def mapper(framework: str, *op_types: str):
    def deco(fn):
        reg = _MAPPERS.setdefault(framework, {})
        for t in op_types:
            reg[t] = fn
        return fn
    return deco


def get_mapper(framework: str, op_type: str) -> Optional[Callable]:
    return _MAPPERS.get(framework, {}).get(op_type)


def unmapped_error(framework: str, unmapped) -> "ImportException":
    """Unmapped-op error, annotated with documented exemption reasons."""
    from .coverage import ONNX_EXEMPT, TF_EXEMPT
    unmapped = sorted(unmapped)
    exempt = TF_EXEMPT if framework == "tensorflow" else ONNX_EXEMPT
    notes = [f"{t}: {exempt[t]}" for t in unmapped if t in exempt]
    return ImportException(
        f"no {framework} mapping rule for op type(s): {unmapped}"
        + ("".join(f"\n  - {n}" for n in notes) if notes else ""))


def supported_ops(framework: str) -> List[str]:
    return sorted(_MAPPERS.get(framework, {}))


class ImportContext:
    """Carries the target SameDiff graph during a mapping pass.

    Mapping rules call `ctx.emit(...)` (registered-op node), `ctx.bind(...)`
    (alias a foreign tensor name to an SDVariable) and `ctx.const_value(...)`
    (static fold of a constant input). A new graph is made on ``device``.
    """

    def __init__(self, graph: IRGraph, sd: Optional[SameDiff] = None,
                 import_weights_as_variables: bool = False,
                 device="cuda"):
        self.graph = graph
        self.sd = sd or SameDiff.create(device=device)
        self.vars: Dict[str, SDVariable] = {}      # foreign tensor name -> var
        self.const_np: Dict[str, np.ndarray] = dict(graph.initializers)
        self._as_variables = import_weights_as_variables
        self._node_map = graph.node_map()
        # static shape/dtype propagation (meta tensors as we emit) — lets
        # Shape/Size/Rank fold to constants, which kills TF graphs'
        # dynamic reshape chains
        self._var_aval: Dict[str, Aval] = {}

    # -- variable plumbing ------------------------------------------------
    def bind(self, tensor_name: str, var: SDVariable,
             aval: Optional[Aval] = None):
        self.vars[tensor_name] = var
        if aval is not None:
            self._var_aval[var.name] = aval
        elif var.shape is not None and var.name not in self._var_aval:
            self._var_aval[var.name] = Aval(
                tuple(var.shape),
                BFLOAT16 if var.dtype == "bfloat16" else np.dtype(var.dtype))

    def aval(self, tensor_name: str) -> Optional[Aval]:
        """Static shape/dtype of a foreign tensor, if known."""
        if tensor_name in self.const_np:
            a = np.asarray(self.const_np[tensor_name])
            return Aval(a.shape, a.dtype)
        v = self.vars.get(tensor_name)
        return self._var_aval.get(v.name) if v is not None else None

    def has(self, tensor_name: str) -> bool:
        return tensor_name in self.vars or tensor_name in self.const_np

    def get(self, tensor_name: str) -> SDVariable:
        """SDVariable for a foreign tensor, materializing consts on demand."""
        if tensor_name in self.vars:
            return self.vars[tensor_name]
        if tensor_name in self.const_np:
            arr = self.const_np[tensor_name]
            safe = tensor_name.replace(":", "_")
            if self._as_variables and arr.dtype.kind == "f" and arr.ndim >= 1:
                v = self.sd.var(safe, arr)
            else:
                v = self.sd.constant(arr, safe)
            self.bind(tensor_name, v)
            return v
        raise ImportException(f"tensor {tensor_name!r} not yet produced — "
                              f"graph not topologically ordered?")

    def const_value(self, tensor_name: str) -> np.ndarray:
        """Static value of a constant input (for shapes/axes/perms)."""
        if tensor_name in self.const_np:
            return self.const_np[tensor_name]
        raise ImportException(
            f"input {tensor_name!r} must be a graph constant (static shape/"
            f"axis data) for import, but is computed at runtime")

    def maybe_const(self, tensor_name: str) -> Optional[np.ndarray]:
        return self.const_np.get(tensor_name)

    def producer(self, tensor_name: str) -> Optional[IRNode]:
        return self._node_map.get(tensor_name)

    # -- emission ---------------------------------------------------------
    def _infer_avals(self, op_name, inputs, n_outputs, kwargs):
        """Propagate static shapes through the emitted op: one run on
        ``meta`` tensors; None when an input has no static shape or the
        op cannot run without data."""
        avals = []
        for v in inputs:
            a = None if v is None else self._var_aval.get(v.name)
            if v is not None and a is None:
                return None
            avals.append(a)
        try:
            metas = [None if a is None else _meta_tensor(a) for a in avals]
            fn = OpRegistry.get().lookup(op_name).fn
            with torch.no_grad():
                out = run_node(fn, metas, kwargs, _META)
        except Exception:
            return None
        outs = [out] if n_outputs == 1 else list(out)
        if not all(isinstance(o, torch.Tensor) and o.device == _META
                   for o in outs):
            return None
        return [_aval_of(o) for o in outs]

    def emit(self, op_name: str, inputs: Sequence[SDVariable],
             out_tensor: str, n_outputs: int = 1, **kwargs):
        """Record a registered op; bind its output(s) to foreign name(s)."""
        safe = out_tensor.replace(":", "_")
        out = self.sd._record(op_name, list(inputs), n_outputs=n_outputs,
                              out_name=safe, **kwargs)
        avals = self._infer_avals(op_name, inputs, n_outputs, kwargs)
        if n_outputs == 1:
            self.bind(out_tensor, out,
                      aval=avals[0] if avals else None)
        return out

    def emit_multi(self, op_name: str, inputs: Sequence[SDVariable],
                   out_tensors: Sequence[str], **kwargs):
        outs = self.sd._record(op_name, list(inputs),
                               n_outputs=len(out_tensors), **kwargs)
        if len(out_tensors) == 1:
            outs = (outs,)
        avals = self._infer_avals(op_name, inputs, len(out_tensors), kwargs)
        for i, (t, v) in enumerate(zip(out_tensors, outs)):
            self.bind(t, v, aval=avals[i] if avals else None)
        return outs


def run_import(graph: IRGraph, sd: Optional[SameDiff] = None,
               import_weights_as_variables: bool = False,
               device="cuda") -> ImportContext:
    """The ImportGraph.importGraph analog: walk nodes, apply mapping rules."""
    ctx = ImportContext(graph, sd, import_weights_as_variables, device)
    for name, spec in graph.inputs.items():
        shape, dtype = spec
        ctx.bind(name, ctx.sd.placeholder(name.replace(":", "_"),
                                          shape=shape, dtype=dtype))
    unmapped = sorted({n.op_type for n in graph.nodes
                       if get_mapper(graph.framework, n.op_type) is None})
    if unmapped:
        raise unmapped_error(graph.framework, unmapped)
    for node in graph.nodes:
        fn = get_mapper(graph.framework, node.op_type)
        fn(node, ctx)
    return ctx
