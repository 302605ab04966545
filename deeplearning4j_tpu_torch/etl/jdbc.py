"""SQL record reader over DB-API connections.

Reference: `datavec/datavec-jdbc/src/main/java/org/datavec/jdbc/records/
reader/impl/jdbc/JDBCRecordReader.java` (DataSource + query, optional
metadata query for record lookup, trimStrings). The Python analog takes
any PEP-249 connection (sqlite3 in the stdlib; psycopg2/mysql drivers
plug in identically) instead of a JDBC DataSource.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .records import RecordMetaData, RecordReader


class RecordMetaDataJdbc(RecordMetaData):
    """Metadata carrying the per-record key values for the metadata query
    (reference RecordMetaDataJdbc)."""

    def __init__(self, uri: str, position: int, values: Sequence):
        super().__init__(uri, position)
        self.values = list(values)


class JDBCRecordReader(RecordReader):
    """Iterate a query's result set as records.

    - ``query``: executed on ``initialize(connection)``; ``reset()``
      rewinds over the fetched rows; ``refresh()`` re-executes the query
      on a fresh cursor when current data is wanted.
    - ``metadata_query`` + ``metadata_indices``: when given, each record's
      metadata captures the values at those column indices, and
      ``load_from_meta`` re-fetches single records with the metadata
      query (reference ``loadFromMetaData``).
    - ``trim_strings``: strip whitespace from string columns.
    """

    def __init__(self, query: str, metadata_query: Optional[str] = None,
                 metadata_indices: Optional[Sequence[int]] = None,
                 trim_strings: bool = False):
        self.query = query
        self.metadata_query = metadata_query
        self.metadata_indices = list(metadata_indices or [])
        self.trim_strings = trim_strings
        self._conn = None
        self._records: List[List] = []
        self._i = 0
        self._columns: List[str] = []

    # -- lifecycle --------------------------------------------------------
    def initialize(self, connection):
        self._conn = connection
        self._fetch()
        return self

    def _fetch(self):
        if self._conn is None:
            raise RuntimeError("call initialize(connection) first")
        cur = self._conn.cursor()
        try:
            cur.execute(self.query)
            self._columns = [d[0] for d in cur.description or []]
            self._records = [self._convert(row) for row in cur.fetchall()]
        finally:
            cur.close()
        self._i = 0

    def _convert(self, row) -> List:
        out = []
        for v in row:
            if self.trim_strings and isinstance(v, str):
                v = v.strip()
            out.append(v)
        return out

    # -- iteration --------------------------------------------------------
    def has_next(self) -> bool:
        return self._i < len(self._records)

    def next(self) -> List:
        r = self._records[self._i]
        self._i += 1
        return r

    def next_with_meta(self):
        idx = self._i
        rec = self.next()
        vals = [rec[i] for i in self.metadata_indices] \
            if self.metadata_indices else []
        return rec, RecordMetaDataJdbc("jdbc", idx, vals)

    def reset(self):
        self._i = 0

    def refresh(self):
        """Re-execute the query (fresh cursor) and rewind."""
        self._fetch()

    def get_labels(self) -> Optional[List[str]]:
        return self._columns or None

    def load_from_meta(self, meta: RecordMetaDataJdbc) -> List:
        """Re-fetch one record by its metadata key values (reference
        loadFromMetaData)."""
        if not self.metadata_query:
            raise ValueError("reader was built without a metadata_query")
        if self._conn is None:
            raise RuntimeError("call initialize(connection) first")
        cur = self._conn.cursor()
        try:
            cur.execute(self.metadata_query, tuple(meta.values))
            row = cur.fetchone()
            if row is None:
                raise KeyError(f"no record for metadata {meta.values}")
            return self._convert(row)
        finally:
            cur.close()

    def close(self):
        self._records = []
