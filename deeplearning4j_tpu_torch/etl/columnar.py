"""Columnar data formats: Arrow IPC + Parquet record readers/writers.

Reference: ``datavec-arrow`` (ArrowRecordReader/ArrowRecordWriter over the
Arrow IPC file format) and the excel/JDBC family of columnar sources. Built
on pyarrow when present; ``available()`` gates it so the core package never
hard-depends on it.

Records interoperate with the Schema/TransformProcess machinery: a reader
yields list-of-values rows in column order, and ``infer_schema`` maps Arrow
types onto our Schema columns.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .schema import Schema

try:
    import pyarrow as _pa
    import pyarrow.ipc as _ipc
    import pyarrow.parquet as _pq
    _PA_ERR = None
except Exception as e:  # pragma: no cover - environment without pyarrow
    _pa = None
    _PA_ERR = str(e)


def available() -> bool:
    return _pa is not None


def _require():
    if _pa is None:
        raise RuntimeError(f"pyarrow unavailable: {_PA_ERR}")


def infer_schema(arrow_schema) -> Schema:
    """Arrow schema -> our Schema (reference ArrowConverter.toDatavecSchema)."""
    _require()
    b = Schema.Builder()
    for field in arrow_schema:
        t = field.type
        if _pa.types.is_integer(t):
            b.add_column_integer(field.name)
        elif _pa.types.is_floating(t):
            b.add_column_double(field.name)
        elif _pa.types.is_boolean(t):
            b.add_column_integer(field.name)
        else:
            b.add_column_string(field.name)
    return b.build()


def _table_rows(table) -> List[list]:
    cols = [c.to_pylist() for c in table.columns]
    return [list(row) for row in zip(*cols)] if cols else []


class ArrowRecordReader:
    """Read rows from an Arrow IPC file
    (reference datavec-arrow ArrowRecordReader.java)."""

    def __init__(self, path: str):
        _require()
        with _pa.memory_map(path) as src:
            self._table = _ipc.open_file(src).read_all()
        self.schema = infer_schema(self._table.schema)
        self._rows = _table_rows(self._table)
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._rows)

    def next(self) -> list:
        row = self._rows[self._i]
        self._i += 1
        return row

    def reset(self):
        self._i = 0

    def __iter__(self):
        self.reset()
        return iter(self._rows)


class ParquetRecordReader(ArrowRecordReader):
    """Read rows from a Parquet file (the datavec-arrow role over the
    other standard columnar on-disk format)."""

    def __init__(self, path: str, columns: Optional[Sequence[str]] = None):
        _require()
        self._table = _pq.read_table(path, columns=list(columns)
                                     if columns else None)
        self.schema = infer_schema(self._table.schema)
        self._rows = _table_rows(self._table)
        self._i = 0


def write_arrow(path: str, schema: Schema, records: Sequence[Sequence]):
    """Write rows as an Arrow IPC file (ArrowRecordWriter role)."""
    _require()
    table = _records_to_table(schema, records)
    with _pa.OSFile(path, "wb") as sink:
        with _ipc.new_file(sink, table.schema) as w:
            w.write_table(table)


def write_parquet(path: str, schema: Schema, records: Sequence[Sequence]):
    _require()
    _pq.write_table(_records_to_table(schema, records), path)


def _records_to_table(schema: Schema, records: Sequence[Sequence]):
    names = schema.column_names()
    cols = list(zip(*records)) if records else [[] for _ in names]
    arrays = []
    for name, col in zip(names, cols):
        ctype = schema.column_type(name).value.lower()
        if ctype in ("integer", "long", "boolean"):
            arrays.append(_pa.array([int(v) for v in col], _pa.int64()))
        elif ctype in ("double", "float"):
            arrays.append(_pa.array([float(v) for v in col], _pa.float64()))
        else:
            arrays.append(_pa.array([str(v) for v in col], _pa.string()))
    return _pa.table(dict(zip(names, arrays)))


def to_features(table_or_rows, dtype=np.float32) -> np.ndarray:
    """Rows of numeric columns -> a dense feature matrix."""
    rows = (_table_rows(table_or_rows)
            if _pa is not None and isinstance(table_or_rows, _pa.Table)
            else list(table_or_rows))
    return np.asarray(rows, dtype=dtype)
