"""Multi-host sharded ETL execution.

Reference: ``datavec-spark``'s ``SparkTransformExecutor`` (execute a
TransformProcess over an RDD, SparkTransformExecutor.java:354) and the
Spark record-reader bridge. Counterpart of
``deeplearning4j_tpu/etl/distributed.py``. There is no external cluster
runtime: every rank of a ``torch.distributed`` job runs the same program,
so the executor shards the record set deterministically by
``(process_index, process_count)`` (round-robin, matching how ranks feed
per-rank batches), runs the local TransformProcess on its shard, and the
caller feeds the per-rank result straight into that rank's slice of the
global batch. Without explicit indices they are the process group's rank
and world size when one is initialised, else (0, 1).

No cross-rank shuffle is provided (the reduce/join transforms operate
within a shard); for global reductions run analyze on rank 0 or pre-shard
by key — documented limitation, matching how per-rank input pipelines
feed data-parallel training.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .executor import LocalTransformExecutor
from .transform_process import TransformProcess


def _process_info(process_index: Optional[int], process_count: Optional[int]):
    if process_index is None or process_count is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    return int(process_index), int(process_count)


def shard_records(records: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List:
    """Deterministic round-robin shard of a record list.

    Every host calling with the same records gets a disjoint slice;
    the union over hosts is exactly the input.
    """
    pi, pc = _process_info(process_index, process_count)
    return [r for i, r in enumerate(records) if i % pc == pi]


def shard_files(paths: Sequence[str], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[str]:
    """Shard a file list (sorted first so all hosts agree on the order
    regardless of filesystem enumeration)."""
    return shard_records(sorted(paths), process_index, process_count)


class ShardedTransformExecutor:
    """The SparkTransformExecutor role over the ranks of one job."""

    def __init__(self, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.process_index, self.process_count = _process_info(
            process_index, process_count)

    def execute(self, records: Sequence[Sequence],
                tp: TransformProcess) -> List[List]:
        """Transform this host's shard of `records`."""
        local = shard_records(records, self.process_index,
                              self.process_count)
        return LocalTransformExecutor.execute(local, tp)

    def execute_all(self, records: Sequence[Sequence],
                    tp: TransformProcess) -> List[List[List]]:
        """All shards' results (single-process testing/simulation of the
        full cluster: index == what host i would produce)."""
        return [
            LocalTransformExecutor.execute(
                shard_records(records, i, self.process_count), tp)
            for i in range(self.process_count)]
