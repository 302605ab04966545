"""Op descriptors: a machine-readable description of the op surface.

Counterpart of ``deeplearning4j_tpu/ops/descriptors.py`` (the
reference's ``org/nd4j/ir`` OpNamespace descriptors, generated there and
read by the import mappings). Here each descriptor is read from the
port's live registry by introspection, so it cannot drift from the ops,
and the whole set exports to JSON for outside tools.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Dict, List, Optional

from .registry import OpRegistry


@dataclasses.dataclass
class ArgDescriptor:
    """One op argument (the reference's OpNamespace$ArgDescriptor)."""
    name: str
    arg_type: str          # INPUT_TENSOR | DOUBLE | INT64 | BOOL | STRING...
    required: bool
    default: Optional[str] = None


@dataclasses.dataclass
class OpDescriptor:
    """The reference's OpNamespace$OpDescriptor."""
    name: str
    category: str
    differentiable: bool
    aliases: List[str]
    args: List[ArgDescriptor]


def _classify_default(v) -> str:
    if isinstance(v, bool):
        return "BOOL"
    if isinstance(v, int):
        return "INT64"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, (tuple, list)):
        return "INT64_ARRAY"
    return "INPUT_TENSOR"


def describe(op_name: str) -> OpDescriptor:
    d = OpRegistry.get().lookup(op_name)
    args: List[ArgDescriptor] = []
    try:
        sig = inspect.signature(d.fn)
    except (TypeError, ValueError):
        sig = None
    for p in (sig.parameters.values() if sig is not None else ()):
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            args.append(ArgDescriptor(p.name, "INPUT_TENSOR_ARRAY",
                                      required=False))
        elif p.kind == inspect.Parameter.VAR_KEYWORD:
            continue
        elif p.default is inspect.Parameter.empty:
            args.append(ArgDescriptor(p.name, "INPUT_TENSOR",
                                      required=True))
        else:
            args.append(ArgDescriptor(p.name, _classify_default(p.default),
                                      required=False,
                                      default=repr(p.default)))
    return OpDescriptor(name=d.name, category=d.category,
                        differentiable=d.differentiable,
                        aliases=list(d.aliases), args=args)


def all_descriptors() -> Dict[str, OpDescriptor]:
    return {n: describe(n) for n in OpRegistry.get().names()}


def to_json(path: Optional[str] = None) -> str:
    """The whole descriptor set as JSON (the reference's
    nd4j-op-def.pbtxt), written to ``path`` when given."""
    data = {n: dataclasses.asdict(d) for n, d in all_descriptors().items()}
    s = json.dumps(data, indent=1, sort_keys=True)
    if path:
        with open(path, "w") as f:
            f.write(s)
    return s
