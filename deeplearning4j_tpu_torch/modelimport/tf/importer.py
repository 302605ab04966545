"""TF GraphDef -> SameDiff importer (frozen inference graphs).

Reference: `nd4j/samediff-import/samediff-import-tensorflow/.../
TensorflowFrameworkImporter.kt` + `ImportGraph.kt:218` (runImport), legacy
`org/nd4j/imports/graphmapper/tf/TFGraphMapper.java:901`.

Counterpart of ``deeplearning4j_tpu/modelimport/tf/importer.py``: parse
(protoio) -> constant-fold the shape-computation subgraph with numpy ->
map the remaining nodes onto registered ops -> an ordinary SameDiff graph
on the importer's device (the card unless the caller names another),
which ``output()`` runs as any SameDiff graph.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...autodiff.samediff import SameDiff
from ...ndarray.ndarray import NDArray
from ..ir import (IRGraph, IRNode, ImportContext, ImportException, get_mapper)
from . import mappings  # noqa: F401 — registers the mapping rules
from . import mappings_extra  # noqa: F401 — long-tail ruleset coverage
from .parser import parse_graphdef, _np_dtype
from .slicing import build_index_spec, apply_spec_np


def _fold_reduce(fn):
    def f(node, ins, attrs):
        axes = tuple(int(a) for a in np.atleast_1d(ins[1]))
        return fn(ins[0], axis=axes or None,
                  keepdims=bool(attrs.get("keep_dims", False)))
    return f


def _fold_strided_slice(node, ins, attrs):
    spec = build_index_spec(
        np.asarray(ins[1]).tolist(), np.asarray(ins[2]).tolist(),
        np.asarray(ins[3]).tolist() if len(ins) > 3 else None,
        begin_mask=int(attrs.get("begin_mask", 0)),
        end_mask=int(attrs.get("end_mask", 0)),
        ellipsis_mask=int(attrs.get("ellipsis_mask", 0)),
        new_axis_mask=int(attrs.get("new_axis_mask", 0)),
        shrink_axis_mask=int(attrs.get("shrink_axis_mask", 0)),
        rank=np.asarray(ins[0]).ndim)
    return apply_spec_np(np.asarray(ins[0]), spec)


def _fold_cast(node, ins, attrs):
    dt = attrs.get("DstT")
    return np.asarray(ins[0]).astype(_np_dtype(dt[1])
                                     if isinstance(dt, tuple) else np.float32)


# numpy constant-folding rules for the shape-computation subgraph
_FOLD = {
    "Add": lambda n, i, a: i[0] + i[1],
    "AddV2": lambda n, i, a: i[0] + i[1],
    "Sub": lambda n, i, a: i[0] - i[1],
    "Mul": lambda n, i, a: i[0] * i[1],
    "Div": lambda n, i, a: i[0] / i[1],
    "RealDiv": lambda n, i, a: i[0] / i[1],
    "FloorDiv": lambda n, i, a: i[0] // i[1],
    "FloorMod": lambda n, i, a: np.mod(i[0], i[1]),
    "Maximum": lambda n, i, a: np.maximum(i[0], i[1]),
    "Minimum": lambda n, i, a: np.minimum(i[0], i[1]),
    "Neg": lambda n, i, a: -i[0],
    "Sqrt": lambda n, i, a: np.sqrt(i[0]),
    "Square": lambda n, i, a: np.square(i[0]),
    "Equal": lambda n, i, a: i[0] == i[1],
    "Greater": lambda n, i, a: i[0] > i[1],
    "Less": lambda n, i, a: i[0] < i[1],
    "Cast": _fold_cast,
    "Reshape": lambda n, i, a: np.reshape(i[0], [int(s) for s in i[1]]),
    "Transpose": lambda n, i, a: np.transpose(i[0], [int(p) for p in i[1]]),
    "ExpandDims": lambda n, i, a: np.expand_dims(i[0], int(i[1])),
    "Squeeze": lambda n, i, a: np.squeeze(
        i[0], tuple(a.get("squeeze_dims") or a.get("axis") or []) or None),
    "Pack": lambda n, i, a: np.stack(i, axis=int(a.get("axis", 0))),
    "ConcatV2": lambda n, i, a: np.concatenate(i[:-1], axis=int(i[-1])),
    "StridedSlice": _fold_strided_slice,
    "Slice": lambda n, i, a: np.asarray(i[0])[tuple(
        slice(int(b), None if int(s) == -1 else int(b) + int(s))
        for b, s in zip(i[1], i[2]))],
    "GatherV2": lambda n, i, a: np.take(i[0], i[1],
                                        axis=int(i[2]) if len(i) > 2 else 0),
    "Range": lambda n, i, a: np.arange(i[0], i[1], i[2]),
    "Fill": lambda n, i, a: np.full([int(d) for d in i[0]], i[1]),
    "Tile": lambda n, i, a: np.tile(i[0], [int(r) for r in i[1]]),
    "Prod": _fold_reduce(np.prod),
    "Sum": _fold_reduce(np.sum),
    "Max": _fold_reduce(np.max),
    "Min": _fold_reduce(np.min),
    "Select": lambda n, i, a: np.where(i[0], i[1], i[2]),
    "SelectV2": lambda n, i, a: np.where(i[0], i[1], i[2]),
    "ZerosLike": lambda n, i, a: np.zeros_like(i[0]),
    "OnesLike": lambda n, i, a: np.ones_like(i[0]),
}


def _toposort(nodes: List[IRNode], known: set) -> List[IRNode]:
    by_out = {o: n for n in nodes for o in n.outputs}
    order: List[IRNode] = []
    state: Dict[str, int] = {}  # node name -> 0 visiting, 1 done

    def visit(n: IRNode):
        s = state.get(n.name)
        if s == 1:
            return
        if s == 0:
            raise ImportException(f"cycle through node {n.name!r} — "
                                  f"raw TF control flow is not importable; "
                                  f"freeze/lower the graph first")
        state[n.name] = 0
        for t in n.inputs:
            if t in known:
                continue
            prod = by_out.get(t)
            if prod is None and ":" in t:
                # secondary outputs (e.g. Switch:1) alias the :0 producer
                prod = by_out.get(t.split(":")[0] + ":0")
            if prod is not None:
                visit(prod)
        state[n.name] = 1
        order.append(n)

    for n in nodes:
        visit(n)
    return order


class ImportedGraph:
    """Result of an import: a SameDiff graph + tensor-name bindings."""

    def __init__(self, sd: SameDiff, ctx: ImportContext,
                 inputs: Dict[str, str], outputs: Dict[str, str]):
        self.sd = sd
        self.ctx = ctx
        self.inputs = inputs     # foreign tensor name -> placeholder var name
        self.outputs = outputs   # foreign tensor name -> sd var name

    def _resolve_feed(self, feeds: Dict) -> Dict[str, np.ndarray]:
        ph = {}
        short = {k.split(":")[0]: v for k, v in self.inputs.items()}
        for k, v in feeds.items():
            if k in self.inputs:
                ph[self.inputs[k]] = v
            elif k in short:
                ph[short[k]] = v
            else:
                ph[k] = v
        return ph

    def output(self, feeds: Dict, outputs: Optional[Sequence[str]] = None
               ) -> Dict[str, NDArray]:
        """Run the imported graph (SameDiff.output under the hood)."""
        names = list(outputs) if outputs else list(self.outputs)
        sd_names = []
        for n in names:
            for cand in (n, n + ":0") if ":" not in n else (n,):
                if cand in self.outputs:
                    sd_names.append(self.outputs[cand])
                    break
                if cand in self.ctx.vars:
                    sd_names.append(self.ctx.vars[cand].name)
                    break
            else:
                raise KeyError(f"unknown output tensor {n!r}")
        res = self.sd.output(self._resolve_feed(feeds), sd_names)
        return {n: res[s] for n, s in zip(names, sd_names)}


class TFGraphImporter:
    """Import a frozen TF GraphDef (.pb file or bytes)."""

    def __init__(self, pb, input_shapes: Optional[Dict[str, Tuple]] = None,
                 outputs: Optional[List[str]] = None, device="cuda"):
        self.device = device
        if isinstance(pb, (str, os.PathLike)):
            with open(pb, "rb") as f:
                pb = f.read()
        self.graph = parse_graphdef(pb, input_shapes=input_shapes,
                                    outputs=outputs)

    def import_graph(self, sd: Optional[SameDiff] = None,
                     import_weights_as_variables: bool = False
                     ) -> ImportedGraph:
        g = self.graph

        # TF1 while frames (Enter/Merge/Switch/... cycles) lower to single
        # while_loop nodes before the acyclic pass; nested frames lower
        # innermost-first via graph rewriting (see while_frames.plan_frames)
        from .while_frames import plan_frames
        plans, g = plan_frames(g, self.device)

        unmapped = sorted({n.op_type for n in g.nodes
                           if get_mapper(g.framework, n.op_type) is None
                           and n.op_type not in _FOLD
                           and n.op_type != "_TF1WhileFrame"})
        if unmapped:
            from ..ir import unmapped_error
            raise unmapped_error("tensorflow", unmapped)
        ctx = ImportContext(g, sd, import_weights_as_variables, self.device)
        inputs = {}
        for name, (shape, dtype) in g.inputs.items():
            if shape is None or any(s is None for s in shape):
                raise ImportException(
                    f"placeholder {name!r} has dynamic shape {shape}; pass "
                    f"concrete input_shapes (import needs static shapes)")
            v = ctx.sd.placeholder(name.replace(":", "_").split(":")[0],
                                   shape=shape, dtype=dtype)
            ctx.bind(name, v)
            inputs[name] = v.name

        known = set(g.initializers) | set(g.inputs)
        for node in _toposort(g.nodes, known):
            if node.op_type == "_TF1WhileFrame":
                plans[node.attrs["plan"]].emit(ctx)
                continue
            folder = _FOLD.get(node.op_type)
            if folder is not None and all(i in ctx.const_np
                                          for i in node.inputs):
                ins = [np.asarray(ctx.const_np[i]) for i in node.inputs]
                out = folder(node, ins, node.attrs)
                ctx.const_np[node.outputs[0]] = np.asarray(out)
                continue
            rule = get_mapper(g.framework, node.op_type)
            if rule is None:
                raise ImportException(
                    f"op {node.op_type!r} is only constant-foldable but has "
                    f"non-constant inputs (node {node.name!r})")
            rule(node, ctx)

        outputs = {}
        for t in g.outputs:
            if t in ctx.vars:
                outputs[t] = ctx.vars[t].name
            elif t in ctx.const_np:
                outputs[t] = ctx.get(t).name
        return ImportedGraph(ctx.sd, ctx, inputs, outputs)


def import_tf_graph(pb, input_shapes=None, outputs=None,
                    import_weights_as_variables: bool = False,
                    device="cuda") -> ImportedGraph:
    """One-call TF .pb import (reference TFGraphMapper.importGraph analog)
    into a SameDiff graph on ``device``."""
    return TFGraphImporter(pb, input_shapes, outputs, device).import_graph(
        import_weights_as_variables=import_weights_as_variables)
