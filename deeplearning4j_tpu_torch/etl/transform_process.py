"""TransformProcess: an ordered, serializable ETL pipeline over a Schema.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/transform/TransformProcess.java`
(1492 lines — Builder chaining transforms/filters/reducers/sequence ops,
`getFinalSchema()`, JSON serde) and `reduce/Reducer.java`.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence

from .conditions import Condition, ColumnCondition, ConditionOp
from .schema import ColumnMetaData, Schema, SequenceSchema
from .transforms import (Transform, RemoveColumnsTransform,
                         RemoveAllColumnsExceptTransform,
                         RenameColumnsTransform, ReorderColumnsTransform,
                         DuplicateColumnsTransform, AddConstantColumnTransform,
                         ConvertTypeTransform, CategoricalToIntegerTransform,
                         CategoricalToOneHotTransform,
                         IntegerToCategoricalTransform,
                         StringToCategoricalTransform, MathOpTransform,
                         MathFunctionTransform, ColumnsMathOpTransform,
                         ConditionalReplaceValueTransform,
                         ConditionalCopyValueTransform,
                         ReplaceEmptyWithValueTransform,
                         ReplaceInvalidWithValueTransform,
                         AppendStringColumnTransform, StringMapTransform,
                         ReplaceStringTransform, ChangeCaseStringTransform,
                         ConcatenateStringColumnsTransform,
                         RemoveWhiteSpaceTransform, StringToTimeTransform,
                         DeriveColumnsFromTimeTransform)
from .writable import ColumnType, is_missing, to_double


# ---------------------------------------------------------------------------
# reduction (grouped aggregation)
# ---------------------------------------------------------------------------
_REDUCE_OPS = ("Sum", "Mean", "Stdev", "Min", "Max", "Count", "CountUnique",
               "TakeFirst", "TakeLast", "Range")


def _reduce_values(op: str, values: List) -> Any:
    vals = [v for v in values if not is_missing(v)]
    if op == "Count":
        return len(vals)
    if op == "CountUnique":
        return len(set(vals))
    if op == "TakeFirst":
        return vals[0] if vals else None
    if op == "TakeLast":
        return vals[-1] if vals else None
    nums = [to_double(v) for v in vals]
    if not nums:
        return None
    if op == "Sum":
        return sum(nums)
    if op == "Mean":
        return sum(nums) / len(nums)
    if op == "Min":
        return min(nums)
    if op == "Max":
        return max(nums)
    if op == "Range":
        return max(nums) - min(nums)
    if op == "Stdev":
        m = sum(nums) / len(nums)
        return math.sqrt(sum((x - m) ** 2 for x in nums)
                         / max(1, len(nums) - 1))
    raise ValueError(f"unknown reduce op {op}")


def _reduce_out_type(op: str, in_type: ColumnType) -> ColumnType:
    if op in ("Count", "CountUnique"):
        return ColumnType.Long
    if op in ("TakeFirst", "TakeLast"):
        return in_type
    return ColumnType.Double


@dataclasses.dataclass
class Reducer:
    """Group-by-key aggregation (reference `reduce/Reducer.java`)."""

    key_columns: List[str]
    # column name -> reduce op
    ops: Dict[str, str] = dataclasses.field(default_factory=dict)
    default_op: Optional[str] = None

    def output_schema(self, schema: Schema) -> Schema:
        cols = []
        for c in schema.columns:
            if c.name in self.key_columns:
                cols.append(c)
                continue
            op = self.ops.get(c.name, self.default_op)
            if op is None:
                continue  # un-reduced non-key columns are dropped
            cols.append(ColumnMetaData(f"{op.lower()}({c.name})",
                                       _reduce_out_type(op, c.column_type)))
        return Schema(cols)

    def reduce(self, rows: Sequence[Sequence], schema: Schema) -> List[List]:
        key_idx = [schema.index_of(k) for k in self.key_columns]
        groups: Dict = {}
        order = []
        for row in rows:
            k = tuple(row[i] for i in key_idx)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(row)
        out = []
        for k in order:
            grp = groups[k]
            new_row = []
            for i, c in enumerate(schema.columns):
                if c.name in self.key_columns:
                    new_row.append(grp[0][i])
                    continue
                op = self.ops.get(c.name, self.default_op)
                if op is None:
                    continue
                new_row.append(_reduce_values(op, [r[i] for r in grp]))
            out.append(new_row)
        return out

    def to_json_dict(self):
        return {"@class": "Reducer", **dataclasses.asdict(self)}


# ---------------------------------------------------------------------------
# step kinds
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FilterStep:
    """Remove examples matching the condition (reference
    `filter/ConditionFilter.java` — note: condition TRUE → removed)."""

    condition: Condition

    def to_json_dict(self):
        return {"@class": "FilterStep",
                "condition": self.condition.to_json_dict()}


@dataclasses.dataclass
class ConvertToSequenceStep:
    """Group rows by key column(s) and order by a column → sequences
    (reference `TransformProcess.Builder.convertToSequence`)."""

    key_columns: List[str]
    order_column: Optional[str] = None
    ascending: bool = True

    def to_json_dict(self):
        return {"@class": "ConvertToSequenceStep",
                **dataclasses.asdict(self)}


@dataclasses.dataclass
class ConvertFromSequenceStep:
    """Flatten sequences back to independent rows."""

    def to_json_dict(self):
        return {"@class": "ConvertFromSequenceStep"}


class TransformProcess:
    """Immutable pipeline: initial schema + ordered steps."""

    def __init__(self, initial_schema: Schema, steps: Sequence):
        self.initial_schema = initial_schema
        self.steps = list(steps)

    def final_schema(self) -> Schema:
        schema = self.initial_schema
        for step in self.steps:
            schema = self._step_schema(step, schema)
        return schema

    @staticmethod
    def _step_schema(step, schema: Schema) -> Schema:
        if isinstance(step, Transform):
            return step.output_schema(schema)
        if isinstance(step, Reducer):
            return step.output_schema(schema)
        if isinstance(step, FilterStep):
            return schema
        if isinstance(step, ConvertToSequenceStep):
            return SequenceSchema(schema.columns)
        if isinstance(step, ConvertFromSequenceStep):
            return Schema(schema.columns)
        raise TypeError(f"unknown step {step}")

    # -- serde -----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "initialSchema": json.loads(self.initial_schema.to_json()),
            "steps": [s.to_json_dict() for s in self.steps]})

    @staticmethod
    def from_json(s: str) -> "TransformProcess":
        d = json.loads(s)
        schema = Schema.from_json(json.dumps(d["initialSchema"]))
        steps = []
        for sd in d["steps"]:
            cls = sd.get("@class")
            if cls == "FilterStep":
                steps.append(FilterStep(
                    Condition.from_json_dict(sd["condition"])))
            elif cls == "Reducer":
                steps.append(Reducer(key_columns=sd["key_columns"],
                                     ops=sd.get("ops", {}),
                                     default_op=sd.get("default_op")))
            elif cls == "ConvertToSequenceStep":
                steps.append(ConvertToSequenceStep(
                    key_columns=sd["key_columns"],
                    order_column=sd.get("order_column"),
                    ascending=sd.get("ascending", True)))
            elif cls == "ConvertFromSequenceStep":
                steps.append(ConvertFromSequenceStep())
            else:
                steps.append(Transform.from_json_dict(sd))
        return TransformProcess(schema, steps)

    # -- builder ---------------------------------------------------------
    class Builder:
        def __init__(self, initial_schema: Schema):
            self._schema0 = initial_schema
            self._steps: List = []
            self._cur = initial_schema

        def _add(self, step):
            self._cur = TransformProcess._step_schema(step, self._cur)
            self._steps.append(step)
            return self

        def transform(self, t: Transform):
            return self._add(t)

        def remove_columns(self, *names):
            return self._add(RemoveColumnsTransform(list(names)))

        def remove_all_columns_except(self, *names):
            return self._add(RemoveAllColumnsExceptTransform(list(names)))

        def rename_column(self, old, new):
            return self._add(RenameColumnsTransform([old], [new]))

        def reorder_columns(self, *names):
            return self._add(ReorderColumnsTransform(list(names)))

        def duplicate_column(self, src, dst):
            return self._add(DuplicateColumnsTransform([src], [dst]))

        def add_constant_column(self, name, column_type, value):
            return self._add(AddConstantColumnTransform(
                name, ColumnType(column_type), value))

        def convert_to_integer(self, name):
            return self._add(ConvertTypeTransform(name, ColumnType.Integer))

        def convert_to_double(self, name):
            return self._add(ConvertTypeTransform(name, ColumnType.Double))

        def convert_to_string(self, name):
            return self._add(ConvertTypeTransform(name, ColumnType.String))

        def categorical_to_integer(self, *names):
            for n in names:
                self._add(CategoricalToIntegerTransform(n))
            return self

        def categorical_to_one_hot(self, *names):
            for n in names:
                self._add(CategoricalToOneHotTransform(n))
            return self

        def integer_to_categorical(self, name, categories):
            return self._add(IntegerToCategoricalTransform(
                name, list(categories)))

        def string_to_categorical(self, name, states):
            return self._add(StringToCategoricalTransform(name, list(states)))

        def double_math_op(self, name, op, scalar):
            return self._add(MathOpTransform(name, op, scalar))

        integer_math_op = double_math_op

        def double_math_function(self, name, fn):
            return self._add(MathFunctionTransform(name, fn))

        def double_columns_math_op(self, new_name, op, *columns):
            return self._add(ColumnsMathOpTransform(new_name, op,
                                                    list(columns)))

        def conditional_replace_value_transform(self, column, value,
                                                condition):
            return self._add(ConditionalReplaceValueTransform(
                column, value, condition))

        def conditional_copy_value_transform(self, col_to_replace, source,
                                             condition):
            return self._add(ConditionalCopyValueTransform(
                col_to_replace, source, condition))

        def replace_empty_with_value(self, column, value):
            return self._add(ReplaceEmptyWithValueTransform(column, value))

        def replace_invalid_with_value(self, column, value):
            return self._add(ReplaceInvalidWithValueTransform(column, value))

        def append_string_column_transform(self, column, to_append):
            return self._add(AppendStringColumnTransform(column, to_append))

        def string_map_transform(self, column, mapping):
            return self._add(StringMapTransform(column, dict(mapping)))

        def replace_string_transform(self, column, mapping):
            return self._add(ReplaceStringTransform(column, dict(mapping)))

        def change_case(self, column, mode="LOWER"):
            return self._add(ChangeCaseStringTransform(column, mode))

        def concatenate_string_columns(self, new_name, delimiter, *columns):
            return self._add(ConcatenateStringColumnsTransform(
                new_name, delimiter, list(columns)))

        def remove_white_space(self, column):
            return self._add(RemoveWhiteSpaceTransform(column))

        def string_to_time(self, column, fmt):
            return self._add(StringToTimeTransform(column, fmt))

        def derive_columns_from_time(self, column, fields):
            return self._add(DeriveColumnsFromTimeTransform(
                column, list(fields)))

        def filter(self, condition: Condition):
            return self._add(FilterStep(condition))

        def filter_invalid_values(self, *columns):
            from .conditions import InvalidValueColumnCondition, BooleanOr
            conds = [InvalidValueColumnCondition(c) for c in columns]
            cond = conds[0] if len(conds) == 1 else BooleanOr(conds)
            return self._add(FilterStep(cond))

        def reduce(self, reducer: Reducer):
            return self._add(reducer)

        def convert_to_sequence(self, key_columns, order_column=None,
                                ascending=True):
            keys = [key_columns] if isinstance(key_columns, str) \
                else list(key_columns)
            return self._add(ConvertToSequenceStep(keys, order_column,
                                                   ascending))

        def convert_from_sequence(self):
            return self._add(ConvertFromSequenceStep())

        def build(self) -> "TransformProcess":
            return TransformProcess(self._schema0, self._steps)
