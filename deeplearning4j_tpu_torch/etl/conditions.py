"""Condition DSL for filters / conditional transforms.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/transform/condition/`
— `ConditionOp.java` (LessThan..NotInSet), column conditions
(`column/DoubleColumnCondition.java`, `CategoricalColumnCondition.java`, ...),
boolean combinators (`BooleanCondition.java` AND/OR/NOT).

All conditions are serializable dataclasses; `test(row, schema)` evaluates
against one record.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence

from .schema import Schema
from .writable import is_missing, to_double


class ConditionOp(str, enum.Enum):
    LessThan = "LessThan"
    LessOrEqual = "LessOrEqual"
    GreaterThan = "GreaterThan"
    GreaterOrEqual = "GreaterOrEqual"
    Equal = "Equal"
    NotEqual = "NotEqual"
    InSet = "InSet"
    NotInSet = "NotInSet"

    def apply(self, value, target) -> bool:
        if self == ConditionOp.InSet:
            return value in target
        if self == ConditionOp.NotInSet:
            return value not in target
        if self in (ConditionOp.Equal, ConditionOp.NotEqual):
            # CSV values are often still strings — compare numerically when
            # the target is numeric (matches reference typed-writable equals)
            eq = value == target
            if not eq and isinstance(target, (int, float)) \
                    and not isinstance(target, bool):
                try:
                    eq = to_double(value) == to_double(target)
                except (TypeError, ValueError):
                    eq = False
            return eq if self == ConditionOp.Equal else not eq
        v, t = to_double(value), to_double(target)
        return {ConditionOp.LessThan: v < t,
                ConditionOp.LessOrEqual: v <= t,
                ConditionOp.GreaterThan: v > t,
                ConditionOp.GreaterOrEqual: v >= t}[self]


_CONDITION_REGISTRY: Dict[str, type] = {}


def register_condition(cls):
    _CONDITION_REGISTRY[cls.__name__] = cls
    return cls


class Condition:
    def test(self, row: Sequence, schema: Schema) -> bool:
        raise NotImplementedError

    # sequence form: test a whole sequence (list of rows)
    def test_sequence(self, seq: Sequence[Sequence], schema: Schema) -> bool:
        return any(self.test(r, schema) for r in seq)

    def to_json_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Condition":
        d = dict(d)
        cls = _CONDITION_REGISTRY[d.pop("@class")]
        if cls in (BooleanAnd, BooleanOr):
            return cls([Condition.from_json_dict(c) for c in d["conditions"]])
        if cls is BooleanNot:
            return cls(Condition.from_json_dict(d["condition"]))
        if "op" in d:
            d["op"] = ConditionOp(d["op"])
        return cls(**d)

    # combinators
    def __and__(self, other):
        return BooleanAnd([self, other])

    def __or__(self, other):
        return BooleanOr([self, other])

    def __invert__(self):
        return BooleanNot(self)


@register_condition
@dataclasses.dataclass
class ColumnCondition(Condition):
    """Compare one column against a constant or set
    (subsumes the reference's per-type column conditions)."""

    column: str
    op: ConditionOp
    value: Any = None
    value_set: Optional[List[Any]] = None

    def test(self, row, schema):
        v = row[schema.index_of(self.column)]
        if is_missing(v):
            return False
        target = self.value_set if self.op in (
            ConditionOp.InSet, ConditionOp.NotInSet) else self.value
        return self.op.apply(v, target)


@register_condition
@dataclasses.dataclass
class NullWritableColumnCondition(Condition):
    """True when the column value is missing (reference
    `condition/column/NullWritableColumnCondition.java`)."""

    column: str

    def test(self, row, schema):
        return is_missing(row[schema.index_of(self.column)])


@register_condition
@dataclasses.dataclass
class StringRegexColumnCondition(Condition):
    """Reference `condition/string/StringRegexColumnCondition.java`."""

    column: str
    regex: str

    def test(self, row, schema):
        import re
        v = row[schema.index_of(self.column)]
        return v is not None and re.fullmatch(self.regex, str(v)) is not None


@register_condition
@dataclasses.dataclass
class InvalidValueColumnCondition(Condition):
    """True when the value violates the column metadata (reference
    `condition/column/InvalidValueColumnCondition.java`)."""

    column: str

    def test(self, row, schema):
        meta = schema.meta(self.column)
        return not meta.is_valid(row[schema.index_of(self.column)])


@register_condition
class BooleanAnd(Condition):
    def __init__(self, conditions: Sequence[Condition]):
        self.conditions = list(conditions)

    def test(self, row, schema):
        return all(c.test(row, schema) for c in self.conditions)

    def to_json_dict(self):
        return {"@class": "BooleanAnd",
                "conditions": [c.to_json_dict() for c in self.conditions]}


@register_condition
class BooleanOr(Condition):
    def __init__(self, conditions: Sequence[Condition]):
        self.conditions = list(conditions)

    def test(self, row, schema):
        return any(c.test(row, schema) for c in self.conditions)

    def to_json_dict(self):
        return {"@class": "BooleanOr",
                "conditions": [c.to_json_dict() for c in self.conditions]}


@register_condition
class BooleanNot(Condition):
    def __init__(self, condition: Condition):
        self.condition = condition

    def test(self, row, schema):
        return not self.condition.test(row, schema)

    def to_json_dict(self):
        return {"@class": "BooleanNot",
                "condition": self.condition.to_json_dict()}
