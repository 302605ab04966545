"""Local transform execution + data analysis.

Reference: `datavec/datavec-local/src/main/java/org/datavec/local/transforms/LocalTransformExecutor.java`
(603 lines — executes a TransformProcess over in-memory records) and
`datavec-api/.../transform/analysis/` (`AnalyzeLocal`, DataAnalysis per-column
statistics, quality analysis `DataQualityAnalysis`).

Execution is host-side and embarrassingly parallel; the native fast path
for numeric CSV parsing lives in `native/` (C++ via ctypes), this module
is the portable executor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

from .conditions import Condition
from .schema import Schema, SequenceSchema
from .transform_process import (ConvertFromSequenceStep, ConvertToSequenceStep,
                                FilterStep, Reducer, TransformProcess)
from .transforms import Transform
from .writable import ColumnType, is_missing, to_double


class LocalTransformExecutor:
    """Executes a TransformProcess over lists of records."""

    @staticmethod
    def execute(records: Sequence[Sequence], tp: TransformProcess
                ) -> List[List]:
        """Tabular execution: records is a list of rows."""
        data: Any = [list(r) for r in records]
        schema = tp.initial_schema
        sequence_mode = isinstance(schema, SequenceSchema)
        for step in tp.steps:
            data, schema, sequence_mode = LocalTransformExecutor._apply(
                step, data, schema, sequence_mode)
        return data

    execute_sequence = execute

    @staticmethod
    def _apply(step, data, schema, sequence_mode):
        if isinstance(step, Transform):
            if sequence_mode:
                data = [step.map_sequence(seq, schema) for seq in data]
            else:
                data = [step.map_row(r, schema) for r in data]
            return data, step.output_schema(schema), sequence_mode
        if isinstance(step, FilterStep):
            if sequence_mode:
                data = [s for s in data
                        if not step.condition.test_sequence(s, schema)]
            else:
                data = [r for r in data if not step.condition.test(r, schema)]
            return data, schema, sequence_mode
        if isinstance(step, Reducer):
            if sequence_mode:
                raise ValueError("reduce() on sequence data unsupported; "
                                 "convert_from_sequence() first")
            return step.reduce(data, schema), step.output_schema(schema), False
        if isinstance(step, ConvertToSequenceStep):
            if sequence_mode:
                raise ValueError("already in sequence mode")
            key_idx = [schema.index_of(k) for k in step.key_columns]
            groups: Dict = {}
            order = []
            for row in data:
                k = tuple(row[i] for i in key_idx)
                if k not in groups:
                    groups[k] = []
                    order.append(k)
                groups[k].append(row)
            seqs = []
            for k in order:
                grp = groups[k]
                if step.order_column is not None:
                    oi = schema.index_of(step.order_column)
                    grp = sorted(grp, key=lambda r: r[oi],
                                 reverse=not step.ascending)
                seqs.append(grp)
            return seqs, SequenceSchema(schema.columns), True
        if isinstance(step, ConvertFromSequenceStep):
            flat = [row for seq in data for row in seq]
            return flat, Schema(schema.columns), False
        raise TypeError(f"unknown step {step}")


# ---------------------------------------------------------------------------
# analysis (reference transform/analysis/AnalyzeLocal.java)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ColumnAnalysis:
    name: str
    column_type: str
    count: int = 0
    count_missing: int = 0
    min: Optional[float] = None
    max: Optional[float] = None
    mean: Optional[float] = None
    stdev: Optional[float] = None
    count_unique: Optional[int] = None
    state_counts: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class DataAnalysis:
    schema: Schema
    columns: List[ColumnAnalysis]

    def analysis_for(self, name: str) -> ColumnAnalysis:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


def analyze_local(schema: Schema, records: Sequence[Sequence]) -> DataAnalysis:
    out = []
    for i, meta in enumerate(schema.columns):
        vals = [r[i] for r in records]
        missing = sum(1 for v in vals if is_missing(v))
        present = [v for v in vals if not is_missing(v)]
        ca = ColumnAnalysis(meta.name, meta.column_type.value,
                            count=len(present), count_missing=missing)
        if meta.column_type.is_numeric() and present:
            nums = [to_double(v) for v in present]
            ca.min, ca.max = min(nums), max(nums)
            ca.mean = sum(nums) / len(nums)
            ca.stdev = math.sqrt(
                sum((x - ca.mean) ** 2 for x in nums)
                / max(1, len(nums) - 1))
        if meta.column_type in (ColumnType.Categorical, ColumnType.String):
            counts: Dict[str, int] = {}
            for v in present:
                counts[str(v)] = counts.get(str(v), 0) + 1
            ca.count_unique = len(counts)
            if meta.column_type == ColumnType.Categorical:
                ca.state_counts = counts
        out.append(ca)
    return DataAnalysis(schema, out)


@dataclasses.dataclass
class ColumnQuality:
    name: str
    valid: int = 0
    invalid: int = 0
    missing: int = 0


@dataclasses.dataclass
class DataQualityAnalysis:
    """Reference `transform/quality/DataQualityAnalysis.java`."""

    columns: List[ColumnQuality]

    def quality_for(self, name: str) -> ColumnQuality:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


def analyze_quality_local(schema: Schema, records: Sequence[Sequence]
                          ) -> DataQualityAnalysis:
    out = []
    for i, meta in enumerate(schema.columns):
        q = ColumnQuality(meta.name)
        for r in records:
            v = r[i]
            if is_missing(v):
                q.missing += 1
            elif meta.is_valid(v):
                q.valid += 1
            else:
                q.invalid += 1
        out.append(q)
    return DataQualityAnalysis(out)
