"""Join: combine two record sets on key columns.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/transform/
join/Join.java` — Inner / LeftOuter / RightOuter / FullOuter joins with a
builder, executed by the local/Spark executors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .schema import ColumnType, Schema


class JoinType:
    INNER = "Inner"
    LEFT_OUTER = "LeftOuter"
    RIGHT_OUTER = "RightOuter"
    FULL_OUTER = "FullOuter"


class Join:
    """Reference Join.Builder:
        join = (Join.builder(JoinType.INNER)
                .set_join_columns("id")
                .set_schemas(left_schema, right_schema).build())
        out = join.execute(left_records, right_records)
    """

    def __init__(self, join_type: str, left_keys: Sequence[str],
                 right_keys: Sequence[str], left_schema: Schema,
                 right_schema: Schema):
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.left_schema = left_schema
        self.right_schema = right_schema

    class Builder:
        def __init__(self, join_type: str = JoinType.INNER):
            self._type = join_type
            self._left_keys: List[str] = []
            self._right_keys: List[str] = []
            self._left_schema: Optional[Schema] = None
            self._right_schema: Optional[Schema] = None

        def set_join_columns(self, *names: str) -> "Join.Builder":
            self._left_keys = list(names)
            self._right_keys = list(names)
            return self

        def set_join_columns_left_right(self, left: Sequence[str],
                                        right: Sequence[str]):
            self._left_keys = list(left)
            self._right_keys = list(right)
            return self

        def set_schemas(self, left: Schema, right: Schema) -> "Join.Builder":
            self._left_schema = left
            self._right_schema = right
            return self

        def build(self) -> "Join":
            if self._left_schema is None or self._right_schema is None:
                raise ValueError("set_schemas required")
            if not self._left_keys:
                raise ValueError("set_join_columns required")
            return Join(self._type, self._left_keys, self._right_keys,
                        self._left_schema, self._right_schema)

    @staticmethod
    def builder(join_type: str = JoinType.INNER) -> "Join.Builder":
        return Join.Builder(join_type)

    # -- output schema -----------------------------------------------------
    def output_schema(self) -> Schema:
        """Key columns once, then left non-keys, then right non-keys
        (reference getOutputSchema)."""
        import dataclasses
        cols = []
        l_names = self.left_schema.column_names()
        r_names = self.right_schema.column_names()
        for k in self.left_keys:
            cols.append(dataclasses.replace(self.left_schema.meta(k)))
        for n in l_names:
            if n not in self.left_keys:
                cols.append(dataclasses.replace(self.left_schema.meta(n)))
        for n in r_names:
            if n in self.right_keys:
                continue
            out_name = n if n not in l_names else f"right_{n}"
            cols.append(dataclasses.replace(self.right_schema.meta(n),
                                            name=out_name))
        return Schema(cols)

    # -- execution ---------------------------------------------------------
    def execute(self, left: Sequence[Sequence],
                right: Sequence[Sequence]) -> List[List]:
        l_idx = [self.left_schema.index_of(k) for k in self.left_keys]
        r_idx = [self.right_schema.index_of(k) for k in self.right_keys]
        l_rest = [i for i in range(len(self.left_schema.column_names()))
                  if i not in l_idx]
        r_rest = [i for i in range(len(self.right_schema.column_names()))
                  if i not in r_idx]

        r_by_key: Dict[Tuple, List[Sequence]] = {}
        for row in right:
            r_by_key.setdefault(tuple(row[i] for i in r_idx),
                                []).append(row)

        out: List[List] = []
        matched_right_keys = set()
        for lrow in left:
            key = tuple(lrow[i] for i in l_idx)
            matches = r_by_key.get(key)
            if matches:
                matched_right_keys.add(key)
                for rrow in matches:
                    out.append(list(key) + [lrow[i] for i in l_rest] +
                               [rrow[i] for i in r_rest])
            elif self.join_type in (JoinType.LEFT_OUTER,
                                    JoinType.FULL_OUTER):
                out.append(list(key) + [lrow[i] for i in l_rest] +
                           [None] * len(r_rest))
        if self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            for key, rows in r_by_key.items():
                if key in matched_right_keys:
                    continue
                for rrow in rows:
                    out.append(list(key) + [None] * len(l_rest) +
                               [rrow[i] for i in r_rest])
        return out
