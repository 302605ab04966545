"""RecordReader -> DataSet bridge iterators.

Counterpart of ``deeplearning4j_tpu/datasets/record_iterator.py``. Both
iterators read DataVec records through ``etl/``, which the port does not
have yet: they construct nothing and raise naming ``ROADMAP.md`` queue 1
item 11.
"""
from __future__ import annotations

from .iterators import DataSetIterator


class _WaitsForEtl(DataSetIterator):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet; it reads records "
            "through etl/, which waits for ROADMAP.md queue 1 item 11")


class RecordReaderDataSetIterator(_WaitsForEtl):
    """Tabular or image records -> batched DataSets (waits for etl/)."""


class SequenceRecordReaderDataSetIterator(_WaitsForEtl):
    """Sequence records -> [b, f, t] DataSets (waits for etl/)."""
