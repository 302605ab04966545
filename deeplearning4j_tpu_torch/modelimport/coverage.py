"""Importer coverage accounting against the reference mapping rulesets.

Counterpart of ``deeplearning4j_tpu/modelimport/coverage.py``, with the
same buckets and reasons.

The reference ships declarative import rules per framework op
(`nd4j/samediff-import/samediff-import-tensorflow/src/main/resources/
tensorflow-mapping-ruleset.pbtxt`, `.../samediff-import-onnx/.../
onnx-mapping-ruleset.pbtxt`).  This module parses those rulesets'
``inputFrameworkOpName`` inventories and diffs them against the registered
mapping rules, the same enforced-parity pattern as
``tests/test_op_parity.py`` for the op registry.

Three buckets:
- mapped: a `@mapper` rule exists
- structural: handled below the mapping layer (parser constants/
  placeholders, while-frame lowering) or precluded by the frozen-graph
  import contract
- exempt: not expressible as a static-shape program (data-dependent
  output shapes) or requiring runtime graph state; each carries a reason
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Set

# Reference checkout root (``REFERENCE_ROOT``; a ``reference`` directory
# under the working directory by default).
REFERENCE_ROOT = os.environ.get("REFERENCE_ROOT", "reference")
TF_RULESET = os.path.join(
    REFERENCE_ROOT, "nd4j/samediff-import/samediff-import-tensorflow/"
    "src/main/resources/tensorflow-mapping-ruleset.pbtxt")
ONNX_RULESET = os.path.join(
    REFERENCE_ROOT, "nd4j/samediff-import/samediff-import-onnx/"
    "src/main/resources/onnx-mapping-ruleset.pbtxt")

# Handled below the mapping-rule layer.
TF_STRUCTURAL: Dict[str, str] = {
    "Const": "parser folds to ctx.const_np (tf/parser.py)",
    "Placeholder": "parser binds to SameDiff placeholders (tf/parser.py)",
    "PlaceholderWithDefault": "parser binds placeholder (tf/parser.py)",
    "LoopCond": "consumed by while-frame lowering (tf/while_frames.py)",
    "NextIteration": "consumed by while-frame lowering "
                     "(tf/while_frames.py)",
    "Variable": "frozen inference graphs only: freezing rewrites "
                "variables to Const (import contract, tf/importer.py)",
    "VariableV2": "frozen inference graphs only (see Variable)",
}

# Not expressible as a static-shape program / runtime state.
TF_EXEMPT: Dict[str, str] = {
    "Unique": "output shape is data-dependent (# distinct values)",
    "UniqueV2": "data-dependent output shape",
    "UniqueWithCounts": "data-dependent output shape",
    "UniqueWithCountsV2": "data-dependent output shape",
    "Where": "1-arg Where: output rows = # nonzero, data-dependent",
    "ListDiff": "output shape is data-dependent (set difference)",
    "IteratorGetNext": "tf.data runtime state; feed tensors instead",
    "IteratorV2": "tf.data runtime state; feed tensors instead",
    "If": "TF2 functional control flow: branches live in the GraphDef "
          "function library, which frozen TF1-style inference graphs "
          "(the import contract) inline before freezing",
    "While": "TF2 functional while: see If; TF1 frame loops ARE lowered "
             "(tf/while_frames.py)",
}
# TensorArray family: per-step runtime list state inside TF1 loops. The
# while-frame lowering scans fixed-shape carries instead; graphs that
# thread TensorArrays are rejected loudly.
for _ta in ("TensorArrayV3", "TensorArrayConcat", "TensorArrayConcatV2",
            "TensorArrayConcatV3", "TensorArrayGather",
            "TensorArrayGatherV2", "TensorArrayGatherV3", "TensorArrayRead",
            "TensorArrayReadV2", "TensorArrayReadV3", "TensorArrayScatter",
            "TensorArrayScatterV2", "TensorArrayScatterV3",
            "TensorArraySize", "TensorArraySizeV2", "TensorArraySizeV3",
            "TensorArraySplit", "TensorArraySplitV2", "TensorArraySplitV3",
            "TensorArrayWriteV3"):
    TF_EXEMPT[_ta] = ("TF1 TensorArray runtime list state; while-frame "
                      "lowering uses fixed-shape scan carries")

ONNX_STRUCTURAL: Dict[str, str] = {}

ONNX_EXEMPT: Dict[str, str] = {
    "NonZero": "output shape is data-dependent (# nonzero elements)",
    "If": "subgraph attributes: the hand-rolled wire parser reads flat "
          "graphs; export with inlined branches",
    "Loop": "subgraph attributes + dynamic trip counts (see If)",
    "SequenceAt": "runtime tensor-sequence state",
    "SequenceConstruct": "runtime tensor-sequence state",
    "SequenceEmpty": "runtime tensor-sequence state",
    "SequenceErase": "runtime tensor-sequence state",
    "SequenceInsert": "runtime tensor-sequence state",
    "SequenceLength": "runtime tensor-sequence state",
    "SequenceRemove": "runtime tensor-sequence state",
}


def ruleset_op_names(path: str) -> Set[str]:
    with open(path) as f:
        return set(re.findall(r'inputFrameworkOpName:\s*"([^"]+)"',
                              f.read()))


def report(framework: str) -> dict:
    """Coverage report: mapped/structural/exempt/missing vs the ruleset."""
    from .ir import _MAPPERS
    if framework == "tensorflow":
        from .tf import importer  # noqa: F401 — registers the rules
        ruleset = ruleset_op_names(TF_RULESET)
        structural, exempt = TF_STRUCTURAL, TF_EXEMPT
    elif framework == "onnx":
        from .onnx import importer  # noqa: F401 — registers the rules
        ruleset = ruleset_op_names(ONNX_RULESET)
        structural, exempt = ONNX_STRUCTURAL, ONNX_EXEMPT
    else:
        raise ValueError(framework)
    mapped = set(_MAPPERS.get(framework, {}))
    covered = (mapped | set(structural)) & ruleset
    missing = sorted(ruleset - mapped - set(structural) - set(exempt))
    denom = len(ruleset)
    return {
        "framework": framework,
        "ruleset_total": denom,
        "mapped": sorted(mapped & ruleset),
        "structural": {k: v for k, v in structural.items() if k in ruleset},
        "exempt": {k: v for k, v in exempt.items() if k in ruleset},
        "missing": missing,
        "covered_pct": round(100.0 * len(covered) / denom, 1),
        "accounted_pct": round(
            100.0 * (len(covered) + len(set(exempt) & ruleset)) / denom, 1),
    }


def main():  # pragma: no cover — CLI convenience
    import json
    for fw in ("tensorflow", "onnx"):
        r = report(fw)
        print(json.dumps({k: (len(v) if isinstance(v, (list, dict)) else v)
                          for k, v in r.items()}, indent=None))
        if r["missing"]:
            print(f"  missing[{fw}]: {' '.join(r['missing'])}")


if __name__ == "__main__":  # pragma: no cover
    main()
