"""ONNX ModelProto -> SameDiff importer.

Counterpart of ``deeplearning4j_tpu/modelimport/onnx/importer.py``; the
graph is built on the importer's device (the card unless the caller names
another).

Reference: `nd4j/samediff-import/samediff-import-onnx/.../
OnnxFrameworkImporter.kt` over `ImportGraph.kt:218`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...autodiff.samediff import SameDiff
from ..ir import ImportContext, ImportException, get_mapper
from ..tf.importer import ImportedGraph, _toposort
from . import mappings  # noqa: F401 — registers the mapping rules
from . import mappings_extra  # noqa: F401 — long-tail ruleset coverage
from .parser import parse_model


class OnnxImporter:
    """Import an ONNX model (.onnx file or bytes)."""

    def __init__(self, model, input_shapes: Optional[Dict[str, Tuple]] = None,
                 device="cuda"):
        self.device = device
        if isinstance(model, (str, os.PathLike)):
            with open(model, "rb") as f:
                model = f.read()
        self.graph = parse_model(model, input_shapes=input_shapes)

    def import_graph(self, sd: Optional[SameDiff] = None,
                     import_weights_as_variables: bool = False
                     ) -> ImportedGraph:
        g = self.graph
        unmapped = sorted({n.op_type for n in g.nodes
                           if get_mapper("onnx", n.op_type) is None})
        if unmapped:
            from ..ir import unmapped_error
            raise unmapped_error("onnx", unmapped)
        ctx = ImportContext(g, sd, import_weights_as_variables, self.device)
        inputs = {}
        for name, (shape, dtype) in g.inputs.items():
            if shape is None or any(s is None for s in shape):
                raise ImportException(
                    f"ONNX input {name!r} has dynamic shape {shape}; pass "
                    f"concrete input_shapes")
            v = ctx.sd.placeholder(name.replace(":", "_"), shape=shape,
                                   dtype=dtype)
            ctx.bind(name, v)
            inputs[name] = v.name

        known = set(g.initializers) | set(g.inputs)
        for node in _toposort(g.nodes, known):
            get_mapper("onnx", node.op_type)(node, ctx)

        outputs = {}
        for t in g.outputs:
            if t in ctx.vars or t in ctx.const_np:
                outputs[t] = ctx.get(t).name
        return ImportedGraph(ctx.sd, ctx, inputs, outputs)


def import_onnx_model(model, input_shapes=None,
                      import_weights_as_variables: bool = False,
                      device="cuda") -> ImportedGraph:
    """One-call ONNX import into a SameDiff graph on ``device``."""
    return OnnxImporter(model, input_shapes, device).import_graph(
        import_weights_as_variables=import_weights_as_variables)
