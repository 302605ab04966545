"""Writable value system + column types.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/writable/`
(Writable.java:77 type system — IntWritable, DoubleWritable, Text, ...) and
`org/datavec/api/transform/ColumnType.java`.

Design note: records are host-side Python values (the JVM Writable
class-per-type hierarchy collapses to a `ColumnType` tag + native scalars);
the device never sees records — ETL output is vectorized into one float32
matrix and moved to the device by the iterator bridge
(`datasets/record_iterator.py`).
"""
from __future__ import annotations

import enum
import math
from typing import Any

import numpy as np


class ColumnType(str, enum.Enum):
    """Column types (reference `transform/ColumnType.java`)."""

    Integer = "Integer"
    Long = "Long"
    Double = "Double"
    Float = "Float"
    Categorical = "Categorical"
    String = "String"
    Time = "Time"
    Boolean = "Boolean"
    NDArray = "NDArray"

    def python_type(self):
        return {
            ColumnType.Integer: int,
            ColumnType.Long: int,
            ColumnType.Double: float,
            ColumnType.Float: float,
            ColumnType.Categorical: str,
            ColumnType.String: str,
            ColumnType.Time: int,
            ColumnType.Boolean: bool,
            ColumnType.NDArray: np.ndarray,
        }[self]

    def is_numeric(self) -> bool:
        return self in (ColumnType.Integer, ColumnType.Long,
                        ColumnType.Double, ColumnType.Float,
                        ColumnType.Time, ColumnType.Boolean)


def parse_writable(raw: Any, ctype: ColumnType):
    """Parse a raw (usually string) value into the column's python value.

    Mirrors the CSV→Writable conversion the reference does in
    `CSVRecordReader` + schema-typed transforms.
    """
    if raw is None:
        return None
    if ctype == ColumnType.NDArray:
        return np.asarray(raw)
    if isinstance(raw, str):
        s = raw.strip()
        if s == "":
            return None
        if ctype in (ColumnType.Integer, ColumnType.Long, ColumnType.Time):
            return int(float(s))
        if ctype in (ColumnType.Double, ColumnType.Float):
            return float(s)
        if ctype == ColumnType.Boolean:
            return s.lower() in ("true", "1", "yes")
        return s
    if ctype in (ColumnType.Integer, ColumnType.Long, ColumnType.Time):
        return int(raw)
    if ctype in (ColumnType.Double, ColumnType.Float):
        return float(raw)
    if ctype == ColumnType.Boolean:
        return bool(raw)
    return str(raw)


def is_missing(value: Any) -> bool:
    if value is None:
        return True
    if isinstance(value, str):
        return value == ""
    if isinstance(value, float):
        return math.isnan(value)
    return False


def to_double(value: Any) -> float:
    """Writable.toDouble() equivalent."""
    if value is None:
        raise ValueError("missing value has no double representation")
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        return float(value)
    if isinstance(value, np.ndarray):
        if value.size != 1:
            raise ValueError("NDArray writable with size != 1")
        return float(value.reshape(())[()])
    raise TypeError(f"cannot convert {type(value)} to double")
