"""Schema: typed column metadata for tabular + sequence data.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/transform/schema/Schema.java`
(876 lines — Builder with addColumn{Integer,Double,Categorical,...}, JSON serde)
and `SequenceSchema.java`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

from .writable import ColumnType


@dataclasses.dataclass
class ColumnMetaData:
    """Per-column metadata (reference `metadata/ColumnMetaData.java` impls)."""

    name: str
    column_type: ColumnType
    # restrictions (reference IntegerMetaData min/max etc.)
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    state_names: Optional[List[str]] = None  # Categorical only

    def is_valid(self, value) -> bool:
        if value is None:
            return False
        if self.column_type == ColumnType.Categorical:
            return self.state_names is None or value in self.state_names
        if self.column_type.is_numeric():
            try:
                v = float(value)
            except (TypeError, ValueError):
                return False
            if self.min_value is not None and v < self.min_value:
                return False
            if self.max_value is not None and v > self.max_value:
                return False
            return True
        return isinstance(value, self.column_type.python_type())

    def to_json_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "type": self.column_type.value}
        if self.min_value is not None:
            d["min"] = self.min_value
        if self.max_value is not None:
            d["max"] = self.max_value
        if self.state_names is not None:
            d["stateNames"] = list(self.state_names)
        return d

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "ColumnMetaData":
        return ColumnMetaData(
            name=d["name"], column_type=ColumnType(d["type"]),
            min_value=d.get("min"), max_value=d.get("max"),
            state_names=d.get("stateNames"))


class Schema:
    """Ordered, typed column list (reference Schema.java)."""

    def __init__(self, columns: Sequence[ColumnMetaData]):
        self.columns: List[ColumnMetaData] = list(columns)
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        # transforms call index_of per record — O(1) lookups matter
        self._index = {c.name: i for i, c in enumerate(self.columns)}

    # -- lookups ---------------------------------------------------------
    def num_columns(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def index_of(self, name: str) -> int:
        try:
            return self._index[name]
        except KeyError:
            raise KeyError(
                f"no column named {name!r}; have {self.column_names()}")


    def column_type(self, name: str) -> ColumnType:
        return self.columns[self.index_of(name)].column_type

    def meta(self, name: str) -> ColumnMetaData:
        return self.columns[self.index_of(name)]

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    # -- serde -----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "schemaType": type(self).__name__,
            "columns": [c.to_json_dict() for c in self.columns]})

    @staticmethod
    def from_json(s: str) -> "Schema":
        d = json.loads(s)
        cols = [ColumnMetaData.from_json_dict(c) for c in d["columns"]]
        cls = SequenceSchema if d.get("schemaType") == "SequenceSchema" else Schema
        return cls(cols)

    def __eq__(self, other):
        return (type(self) is type(other)
                and [dataclasses.asdict(c) for c in self.columns]
                == [dataclasses.asdict(c) for c in other.columns])

    def __repr__(self):
        cols = ", ".join(f"{c.name}:{c.column_type.value}"
                         for c in self.columns)
        return f"{type(self).__name__}([{cols}])"

    # -- builder ---------------------------------------------------------
    class Builder:
        def __init__(self):
            self._cols: List[ColumnMetaData] = []

        def add_column_integer(self, name, min_value=None, max_value=None):
            self._cols.append(ColumnMetaData(name, ColumnType.Integer,
                                             min_value, max_value))
            return self

        def add_column_long(self, name, min_value=None, max_value=None):
            self._cols.append(ColumnMetaData(name, ColumnType.Long,
                                             min_value, max_value))
            return self

        def add_column_double(self, name, min_value=None, max_value=None):
            self._cols.append(ColumnMetaData(name, ColumnType.Double,
                                             min_value, max_value))
            return self

        def add_column_float(self, name, min_value=None, max_value=None):
            self._cols.append(ColumnMetaData(name, ColumnType.Float,
                                             min_value, max_value))
            return self

        def add_column_categorical(self, name, *state_names):
            states = list(state_names[0]) if (
                len(state_names) == 1
                and isinstance(state_names[0], (list, tuple))) \
                else list(state_names)
            self._cols.append(ColumnMetaData(
                name, ColumnType.Categorical, state_names=states or None))
            return self

        def add_column_string(self, name):
            self._cols.append(ColumnMetaData(name, ColumnType.String))
            return self

        def add_column_time(self, name):
            self._cols.append(ColumnMetaData(name, ColumnType.Time))
            return self

        def add_column_boolean(self, name):
            self._cols.append(ColumnMetaData(name, ColumnType.Boolean))
            return self

        def add_column_ndarray(self, name):
            self._cols.append(ColumnMetaData(name, ColumnType.NDArray))
            return self

        def add_columns_double(self, *names):
            for n in names:
                self.add_column_double(n)
            return self

        def add_columns_integer(self, *names):
            for n in names:
                self.add_column_integer(n)
            return self

        def add_columns_string(self, *names):
            for n in names:
                self.add_column_string(n)
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)


class SequenceSchema(Schema):
    """Schema for sequence data: each record is a list of timesteps
    (reference `schema/SequenceSchema.java`)."""

    class Builder(Schema.Builder):
        def build(self) -> "SequenceSchema":
            return SequenceSchema(self._cols)


def infer_schema(rows: Sequence[Sequence], names: Optional[Sequence[str]] = None
                 ) -> Schema:
    """Infer a schema from sample rows (reference SequenceSchema.infer...)."""
    if not rows:
        raise ValueError("cannot infer schema from zero rows")
    ncol = len(rows[0])
    names = list(names) if names else [f"col{i}" for i in range(ncol)]
    b = Schema.Builder()
    for i, name in enumerate(names):
        vals = [r[i] for r in rows if r[i] is not None]
        if all(isinstance(v, bool) for v in vals):
            b.add_column_boolean(name)
        elif all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
            b.add_column_integer(name)
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in vals):
            b.add_column_double(name)
        else:
            b.add_column_string(name)
    return b.build()
