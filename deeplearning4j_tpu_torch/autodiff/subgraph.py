"""Serializable sub-graphs for control-flow op bodies.

Counterpart of ``deeplearning4j_tpu/autodiff/subgraph.py``: a body is
recorded once into a standalone ``SubGraph`` (registered ops only, so it
serializes), and the parent graph holds it as a static kwarg of a
``cond`` / ``while_loop`` / ``scan`` node. At execution the control-flow
op (``ops/controlflow.py``) calls it eagerly, once per branch taken or
loop trip.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..ops import OpRegistry


class SubGraph:
    """A recorded, registry-only graph fragment: callable and
    serializable.

    ``captured`` lists parent-graph variable names the body closed over;
    their values are appended after the explicit args at call time."""

    def __init__(self, placeholders: List[str], outputs: List[str],
                 nodes: List[dict], constants: Dict[str, Any],
                 captured: List[str] = None):
        self.placeholders = placeholders
        self.outputs = outputs
        self.nodes = nodes          # {name, op, inputs, outputs, kwargs}
        self.constants = constants  # name -> tensor
        self.captured = captured or []

    # -- recording --------------------------------------------------------
    @staticmethod
    def record(fn: Callable, n_args: int, arg_prefix: str = "arg",
               device="cpu") -> Tuple["SubGraph", int]:
        """Record ``fn`` over fresh placeholders into a SubGraph on
        ``device`` (the parent graph's).

        Returns (subgraph, n_outputs). The body must use only registered
        ops (the rule serialization enforces on the main graph). Parent
        variables referenced by closure are detected and recorded in
        ``.captured``; the parent passes their values as extra
        operands."""
        from .samediff import SameDiff

        sub = SameDiff.create(device=device)
        phs = [sub.placeholder(f"{arg_prefix}{i}") for i in range(n_args)]
        out = fn(sub, *phs) if _wants_sd(fn) else fn(*phs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        reg = OpRegistry.get()
        nodes = []
        internal = {p.name for p in phs} | set(sub._arrays)
        captured: List[str] = []
        for name in sub._op_order:
            node = sub._ops[name]
            if not reg.has(node.op_name):
                raise ValueError(
                    f"control-flow body op {node.name!r} ({node.op_name}) is "
                    f"not a registered op and cannot be serialized")
            if node.needs_key:
                raise ValueError("stochastic ops (dropout etc.) are not "
                                 "supported inside control-flow bodies")
            for i in node.inputs:
                if i is not None and i not in internal and i not in captured:
                    captured.append(i)
            internal.update(node.outputs)
            nodes.append({"name": node.name, "op": node.op_name,
                          "inputs": node.inputs, "outputs": node.outputs,
                          "kwargs": node.kwargs})
        sg = SubGraph([p.name for p in phs], [o.name for o in outs],
                      nodes, dict(sub._arrays), captured)
        return sg, len(outs)

    # -- execution --------------------------------------------------------
    def __call__(self, *args):
        from .samediff import run_node
        reg = OpRegistry.get()
        env: Dict[str, Any] = dict(self.constants)
        for name, val in zip(self.placeholders + self.captured, args):
            env[name] = val
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
        for nd in self.nodes:
            fn = reg.lookup(nd["op"]).fn
            ins = [env[i] if i is not None else None for i in nd["inputs"]]
            res = run_node(fn, ins, nd["kwargs"], device)
            if len(nd["outputs"]) == 1:
                env[nd["outputs"][0]] = res
            else:
                for o, r in zip(nd["outputs"], res):
                    env[o] = r
        outs = tuple(env[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs

    def call_tuple(self, *args) -> Tuple:
        out = self(*args)
        return out if isinstance(out, tuple) else (out,)

    # -- serde ------------------------------------------------------------
    def to_dict(self) -> dict:
        from .serialization import _json_safe
        consts = {}
        for k, v in self.constants.items():
            dt = str(v.dtype).replace("torch.", "")
            data = v.detach().cpu()
            consts[k] = {"data": (data.float() if dt == "bfloat16"
                                  else data).tolist(), "dtype": dt}
        return {
            "placeholders": self.placeholders,
            "outputs": self.outputs,
            "captured": self.captured,
            "nodes": [{**n, "kwargs": _json_safe(n["kwargs"])}
                      for n in self.nodes],
            "constants": consts,
        }

    @staticmethod
    def from_dict(d: dict, device="cpu") -> "SubGraph":
        from .serialization import _json_restore
        return SubGraph(
            placeholders=list(d["placeholders"]),
            outputs=list(d["outputs"]),
            nodes=[{**n, "kwargs": _json_restore(n["kwargs"], device)}
                   for n in d["nodes"]],
            constants={k: torch.tensor(v["data"],
                                       dtype=getattr(torch, v["dtype"]),
                                       device=device)
                       for k, v in d["constants"].items()},
            captured=list(d.get("captured", [])))


def _wants_sd(fn) -> bool:
    """Body fns may take the sub-SameDiff as first arg (``lambda sd, x:
    sd.math.sin(x)``), as the reference's bodies receive the SameDiff
    instance."""
    import inspect
    try:
        params = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return False
    return bool(params) and params[0] in ("sd", "samediff")
