"""Column / row / sequence transforms.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/transform/transform/`
(column: `column/*.java`, categorical: `categorical/*.java`, doubles/integers
math ops: `doubletransform/`, `integer/`, strings: `string/`, time:
`time/*.java`, sequence: `../sequence/`) — each a serializable operation with
an output-schema rule and a per-record map.

Design: every transform is a dataclass with
  - ``output_schema(schema) -> Schema``
  - ``map_row(row, schema) -> new_row``           (tabular)
  - ``map_sequence(seq, schema) -> new_seq``      (sequence; defaults to
    per-step map_row)
JSON serde mirrors the reference's Jackson polymorphic format.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Dict, List, Optional, Sequence

from .conditions import Condition
from .schema import ColumnMetaData, Schema, SequenceSchema
from .writable import ColumnType, is_missing, parse_writable, to_double

_TRANSFORM_REGISTRY: Dict[str, type] = {}


def register_transform(cls):
    _TRANSFORM_REGISTRY[cls.__name__] = cls
    return cls


class Transform:
    def output_schema(self, schema: Schema) -> Schema:
        raise NotImplementedError

    def map_row(self, row: Sequence, schema: Schema) -> List:
        raise NotImplementedError

    def map_sequence(self, seq: Sequence[Sequence], schema: Schema) -> List:
        return [self.map_row(r, schema) for r in seq]

    def to_json_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Condition):
                v = v.to_json_dict()
            elif isinstance(v, ColumnType):
                v = v.value
            d[f.name] = v
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Transform":
        d = dict(d)
        cls = _TRANSFORM_REGISTRY[d.pop("@class")]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name == "condition" and isinstance(v, dict):
                v = Condition.from_json_dict(v)
            if f.name in ("to_type", "column_type") and isinstance(v, str):
                v = ColumnType(v)
            kwargs[f.name] = v
        return cls(**kwargs)


def _same_type_schema(schema: Schema, cols: Sequence[ColumnMetaData]):
    cls = SequenceSchema if isinstance(schema, SequenceSchema) else Schema
    return cls(cols)


# ---------------------------------------------------------------------------
# column structure ops
# ---------------------------------------------------------------------------
@register_transform
@dataclasses.dataclass
class RemoveColumnsTransform(Transform):
    """Reference `transform/column/RemoveColumnsTransform.java`."""

    columns: List[str]

    def output_schema(self, schema):
        for c in self.columns:
            schema.index_of(c)  # raise on unknown
        return _same_type_schema(schema, [
            c for c in schema.columns if c.name not in self.columns])

    def map_row(self, row, schema):
        drop = {schema.index_of(c) for c in self.columns}
        return [v for i, v in enumerate(row) if i not in drop]


@register_transform
@dataclasses.dataclass
class RemoveAllColumnsExceptTransform(Transform):
    columns: List[str]

    def output_schema(self, schema):
        return _same_type_schema(schema, [
            c for c in schema.columns if c.name in self.columns])

    def map_row(self, row, schema):
        keep = {schema.index_of(c) for c in self.columns}
        return [v for i, v in enumerate(row) if i in keep]


@register_transform
@dataclasses.dataclass
class RenameColumnsTransform(Transform):
    old_names: List[str]
    new_names: List[str]

    def output_schema(self, schema):
        mapping = dict(zip(self.old_names, self.new_names))
        return _same_type_schema(schema, [
            dataclasses.replace(c, name=mapping.get(c.name, c.name))
            for c in schema.columns])

    def map_row(self, row, schema):
        return list(row)


@register_transform
@dataclasses.dataclass
class ReorderColumnsTransform(Transform):
    """Reference `column/ReorderColumnsTransform.java`: named columns first
    (in order), remaining columns keep relative order."""

    columns: List[str]

    def _order(self, schema):
        head = [schema.index_of(c) for c in self.columns]
        rest = [i for i in range(schema.num_columns()) if i not in head]
        return head + rest

    def output_schema(self, schema):
        return _same_type_schema(
            schema, [schema.columns[i] for i in self._order(schema)])

    def map_row(self, row, schema):
        return [row[i] for i in self._order(schema)]


@register_transform
@dataclasses.dataclass
class DuplicateColumnsTransform(Transform):
    columns: List[str]
    new_names: List[str]

    def output_schema(self, schema):
        cols = list(schema.columns)
        for src, dst in zip(self.columns, self.new_names):
            cols.append(dataclasses.replace(schema.meta(src), name=dst))
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        return list(row) + [row[schema.index_of(c)] for c in self.columns]


@register_transform
@dataclasses.dataclass
class AddConstantColumnTransform(Transform):
    name: str
    column_type: ColumnType
    value: Any

    def output_schema(self, schema):
        return _same_type_schema(schema, list(schema.columns) + [
            ColumnMetaData(self.name, self.column_type)])

    def map_row(self, row, schema):
        return list(row) + [self.value]


@register_transform
@dataclasses.dataclass
class ConvertTypeTransform(Transform):
    """Cast a column (reference CastTo{Integer,Double,Float}Transform +
    ConvertToString)."""

    column: str
    to_type: ColumnType

    def output_schema(self, schema):
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, self.to_type)
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        out[i] = None if is_missing(row[i]) else \
            parse_writable(row[i], self.to_type)
        return out


# ---------------------------------------------------------------------------
# categorical ops
# ---------------------------------------------------------------------------
@register_transform
@dataclasses.dataclass
class CategoricalToIntegerTransform(Transform):
    """Reference `categorical/CategoricalToIntegerTransform.java`."""

    column: str

    def _states(self, schema):
        states = schema.meta(self.column).state_names
        if not states:
            raise ValueError(
                f"column {self.column!r} has no categorical state names")
        return states

    def output_schema(self, schema):
        states = self._states(schema)
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, ColumnType.Integer,
                                 0, len(states) - 1)
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        states = self._states(schema)
        i = schema.index_of(self.column)
        out = list(row)
        out[i] = None if is_missing(row[i]) else states.index(row[i])
        return out


@register_transform
@dataclasses.dataclass
class CategoricalToOneHotTransform(Transform):
    """Reference `categorical/CategoricalToOneHotTransform.java` — expands
    the column into one 0/1 integer column per state."""

    column: str

    def output_schema(self, schema):
        states = schema.meta(self.column).state_names
        if not states:
            raise ValueError(f"no states for {self.column!r}")
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        onehot = [ColumnMetaData(f"{self.column}[{s}]", ColumnType.Integer,
                                 0, 1) for s in states]
        return _same_type_schema(schema, cols[:i] + onehot + cols[i + 1:])

    def map_row(self, row, schema):
        states = schema.meta(self.column).state_names
        i = schema.index_of(self.column)
        hot = [1 if row[i] == s else 0 for s in states]
        return list(row[:i]) + hot + list(row[i + 1:])


@register_transform
@dataclasses.dataclass
class IntegerToCategoricalTransform(Transform):
    column: str
    category_list: List[str]

    def output_schema(self, schema):
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, ColumnType.Categorical,
                                 state_names=list(self.category_list))
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        out[i] = None if is_missing(row[i]) \
            else self.category_list[int(row[i])]
        return out


@register_transform
@dataclasses.dataclass
class StringToCategoricalTransform(Transform):
    column: str
    state_names: List[str]

    def output_schema(self, schema):
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, ColumnType.Categorical,
                                 state_names=list(self.state_names))
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        return list(row)


# ---------------------------------------------------------------------------
# math ops
# ---------------------------------------------------------------------------
_MATH_OPS = {
    "Add": lambda a, b: a + b,
    "Subtract": lambda a, b: a - b,
    "Multiply": lambda a, b: a * b,
    "Divide": lambda a, b: a / b,
    "Modulus": lambda a, b: a % b,
    "ReverseSubtract": lambda a, b: b - a,
    "ReverseDivide": lambda a, b: b / a,
    "Min": min,
    "Max": max,
    "ScalarMin": min,
    "ScalarMax": max,
}

_MATH_FUNCTIONS = {
    "ABS": abs, "LOG": math.log, "LOG10": math.log10, "EXP": math.exp,
    "SIN": math.sin, "COS": math.cos, "TAN": math.tan, "SQRT": math.sqrt,
    "CEIL": math.ceil, "FLOOR": math.floor, "SIGNUM": lambda v: (v > 0) - (v < 0),
}


@register_transform
@dataclasses.dataclass
class MathOpTransform(Transform):
    """Scalar math op on a numeric column (reference
    `doubletransform/DoubleMathOpTransform.java`,
    `integer/IntegerMathOpTransform.java`; op set `MathOp.java`)."""

    column: str
    op: str
    scalar: float = 0.0

    def output_schema(self, schema):
        i = schema.index_of(self.column)
        if not schema.columns[i].column_type.is_numeric():
            raise ValueError(f"MathOp on non-numeric column {self.column!r}")
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, cols[i].column_type)
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if not is_missing(row[i]):
            ctype = schema.columns[i].column_type
            v = _MATH_OPS[self.op](to_double(row[i]), self.scalar)
            out[i] = int(v) if ctype in (ColumnType.Integer, ColumnType.Long,
                                         ColumnType.Time) else v
        return out


@register_transform
@dataclasses.dataclass
class MathFunctionTransform(Transform):
    """Unary function on a double column (reference
    `doubletransform/DoubleMathFunctionTransform.java`; `MathFunction.java`)."""

    column: str
    function: str

    def output_schema(self, schema):
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, ColumnType.Double)
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if not is_missing(row[i]):
            out[i] = float(_MATH_FUNCTIONS[self.function](to_double(row[i])))
        return out


@register_transform
@dataclasses.dataclass
class ColumnsMathOpTransform(Transform):
    """New column from elementwise op over existing numeric columns
    (reference `doubletransform/DoubleColumnsMathOpTransform.java`)."""

    new_name: str
    op: str
    columns: List[str]

    def output_schema(self, schema):
        return _same_type_schema(schema, list(schema.columns) + [
            ColumnMetaData(self.new_name, ColumnType.Double)])

    def map_row(self, row, schema):
        vals = [to_double(row[schema.index_of(c)]) for c in self.columns]
        if self.op == "Add":
            acc = sum(vals)
        elif self.op == "Multiply":
            acc = math.prod(vals)
        elif self.op == "Min":
            acc = min(vals)
        elif self.op == "Max":
            acc = max(vals)
        elif self.op == "Subtract":
            if len(vals) != 2:
                raise ValueError("Subtract needs exactly 2 columns")
            acc = vals[0] - vals[1]
        elif self.op == "Divide":
            if len(vals) != 2:
                raise ValueError("Divide needs exactly 2 columns")
            acc = vals[0] / vals[1]
        else:
            raise ValueError(f"unsupported op {self.op}")
        return list(row) + [acc]


# ---------------------------------------------------------------------------
# replace / conditional ops
# ---------------------------------------------------------------------------
@register_transform
@dataclasses.dataclass
class ReplaceEmptyWithValueTransform(Transform):
    """Reference `string/ReplaceEmptyStringTransform.java` generalized:
    missing/empty → value."""

    column: str
    value: Any

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if is_missing(out[i]):
            out[i] = self.value
        return out


@register_transform
@dataclasses.dataclass
class ReplaceInvalidWithValueTransform(Transform):
    column: str
    value: Any

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if not schema.meta(self.column).is_valid(out[i]):
            out[i] = self.value
        return out


@register_transform
@dataclasses.dataclass
class ConditionalReplaceValueTransform(Transform):
    """Reference `transform/condition/ConditionalReplaceValueTransform.java`."""

    column: str
    value: Any
    condition: Condition = None

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        out = list(row)
        if self.condition.test(row, schema):
            out[schema.index_of(self.column)] = self.value
        return out


@register_transform
@dataclasses.dataclass
class ConditionalCopyValueTransform(Transform):
    """Copy value from another column when condition holds (reference
    `transform/condition/ConditionalCopyValueTransform.java`)."""

    column_to_replace: str
    source_column: str
    condition: Condition = None

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        out = list(row)
        if self.condition.test(row, schema):
            out[schema.index_of(self.column_to_replace)] = \
                row[schema.index_of(self.source_column)]
        return out


# ---------------------------------------------------------------------------
# string ops
# ---------------------------------------------------------------------------
@register_transform
@dataclasses.dataclass
class AppendStringColumnTransform(Transform):
    column: str
    to_append: str

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        out[i] = ("" if is_missing(out[i]) else str(out[i])) + self.to_append
        return out


@register_transform
@dataclasses.dataclass
class StringMapTransform(Transform):
    """Exact-match string replacement map (reference
    `string/StringMapTransform.java`)."""

    column: str
    mapping: Dict[str, str]

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if out[i] in self.mapping:
            out[i] = self.mapping[out[i]]
        return out


@register_transform
@dataclasses.dataclass
class ReplaceStringTransform(Transform):
    """Regex replacement (reference `string/ReplaceStringTransform.java`)."""

    column: str
    mapping: Dict[str, str]  # regex -> replacement

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        import re
        i = schema.index_of(self.column)
        out = list(row)
        if not is_missing(out[i]):
            s = str(out[i])
            for pat, rep in self.mapping.items():
                s = re.sub(pat, rep, s)
            out[i] = s
        return out


@register_transform
@dataclasses.dataclass
class ChangeCaseStringTransform(Transform):
    column: str
    mode: str = "LOWER"  # LOWER | UPPER

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if not is_missing(out[i]):
            out[i] = str(out[i]).lower() if self.mode == "LOWER" \
                else str(out[i]).upper()
        return out


@register_transform
@dataclasses.dataclass
class ConcatenateStringColumnsTransform(Transform):
    new_name: str
    delimiter: str
    columns: List[str]

    def output_schema(self, schema):
        return _same_type_schema(schema, list(schema.columns) + [
            ColumnMetaData(self.new_name, ColumnType.String)])

    def map_row(self, row, schema):
        parts = [str(row[schema.index_of(c)]) for c in self.columns]
        return list(row) + [self.delimiter.join(parts)]


@register_transform
@dataclasses.dataclass
class RemoveWhiteSpaceTransform(Transform):
    column: str

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if not is_missing(out[i]):
            out[i] = "".join(str(out[i]).split())
        return out


# ---------------------------------------------------------------------------
# time ops
# ---------------------------------------------------------------------------
@register_transform
@dataclasses.dataclass
class StringToTimeTransform(Transform):
    """Parse a string column to epoch-millis Time column (reference
    `time/StringToTimeTransform.java`)."""

    column: str
    format: str  # strptime format

    def output_schema(self, schema):
        i = schema.index_of(self.column)
        cols = list(schema.columns)
        cols[i] = ColumnMetaData(self.column, ColumnType.Time)
        return _same_type_schema(schema, cols)

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        out = list(row)
        if not is_missing(out[i]):
            dt = datetime.datetime.strptime(str(out[i]), self.format)
            dt = dt.replace(tzinfo=datetime.timezone.utc)
            out[i] = int(dt.timestamp() * 1000)
        return out


@register_transform
@dataclasses.dataclass
class DeriveColumnsFromTimeTransform(Transform):
    """Derive hour/day/month/... integer columns from a Time column
    (reference `time/DeriveColumnsFromTimeTransform.java`)."""

    column: str
    fields: List[str]  # of: YEAR MONTH DAY HOUR MINUTE SECOND DAY_OF_WEEK

    def output_schema(self, schema):
        extra = [ColumnMetaData(f"{self.column}_{f.lower()}",
                                ColumnType.Integer) for f in self.fields]
        return _same_type_schema(schema, list(schema.columns) + extra)

    def map_row(self, row, schema):
        i = schema.index_of(self.column)
        ms = row[i]
        if is_missing(ms):
            return list(row) + [None] * len(self.fields)
        dt = datetime.datetime.fromtimestamp(
            ms / 1000.0, tz=datetime.timezone.utc)
        getters = {"YEAR": dt.year, "MONTH": dt.month, "DAY": dt.day,
                   "HOUR": dt.hour, "MINUTE": dt.minute, "SECOND": dt.second,
                   "DAY_OF_WEEK": dt.weekday()}
        return list(row) + [getters[f] for f in self.fields]


# ---------------------------------------------------------------------------
# sequence-only ops
# ---------------------------------------------------------------------------
@register_transform
@dataclasses.dataclass
class SequenceDifferenceTransform(Transform):
    """Replace x_t with x_t - x_{t-lag} (reference
    `sequence/difference/SequenceDifferenceTransform.java`)."""

    column: str
    lag: int = 1

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        raise ValueError("SequenceDifferenceTransform is sequence-only")

    def map_sequence(self, seq, schema):
        i = schema.index_of(self.column)
        out = []
        for t, row in enumerate(seq):
            r = list(row)
            prev = seq[t - self.lag][i] if t >= self.lag else None
            r[i] = 0 if prev is None else row[i] - prev
            out.append(r)
        return out


@register_transform
@dataclasses.dataclass
class SequenceOffsetTransform(Transform):
    """Shift a column by N steps within each sequence, trimming edge rows
    (reference `sequence/SequenceOffsetTransform.java`, InBuilt trim mode)."""

    columns: List[str]
    offset: int = 1

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        raise ValueError("SequenceOffsetTransform is sequence-only")

    def map_sequence(self, seq, schema):
        idx = [schema.index_of(c) for c in self.columns]
        n, k = len(seq), self.offset
        out = []
        if k >= 0:
            rng = range(k, n)
        else:
            rng = range(0, n + k)
        for t in rng:
            r = list(seq[t])
            for i in idx:
                r[i] = seq[t - k][i]
            out.append(r)
        return out


@register_transform
@dataclasses.dataclass
class SequenceTrimTransform(Transform):
    """Trim N steps from start or end (reference
    `sequence/trim/SequenceTrimTransform.java`)."""

    num_steps: int
    from_first: bool = True

    def output_schema(self, schema):
        return schema

    def map_row(self, row, schema):
        raise ValueError("SequenceTrimTransform is sequence-only")

    def map_sequence(self, seq, schema):
        return list(seq[self.num_steps:]) if self.from_first \
            else list(seq[:len(seq) - self.num_steps])
