"""Spark-API compatibility facade for distributed training.

Counterpart of ``deeplearning4j_tpu/parallel/spark_compat.py``: the
reference's ``SparkDl4jMultiLayer`` / ``SparkComputationGraph`` driven
by a ``ParameterAveragingTrainingMaster`` or a ``SharedTrainingMaster``.
Both masters' capability is the sharded step: gradients summed over the
data-parallel group every step, which is synchronous averaging with
``averaging_frequency=1``. The masters keep the reference's configuration
surface so ported code runs unchanged; the knobs that mean nothing here
(threshold algorithms, residual post-processors, aggregation depth) are
accepted and recorded, and each one set off its default logs one
warning line saying so.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

from ..common.mesh import Mesh, MeshConfig, make_mesh
from ..datasets.dataset import DataSet

log = logging.getLogger(__name__)


def _warn_inert(master) -> None:
    """One log line per accepted-but-inert knob."""
    inert = []
    if isinstance(master, ParameterAveragingTrainingMaster):
        if master.averaging_frequency != 1:
            inert.append(("averaging_frequency", master.averaging_frequency,
                          "the gradients are summed every step"))
        if master.aggregation_depth != 2:
            inert.append(("aggregation_depth", master.aggregation_depth,
                          "no treeAggregate over a collective group"))
    elif isinstance(master, SharedTrainingMaster):
        if master.threshold != 1e-3:
            inert.append(("threshold", master.threshold,
                          "dense all-reduce, no threshold encoding"))
        if master.threshold_algorithm is not None:
            inert.append(("threshold_algorithm", master.threshold_algorithm,
                          "dense all-reduce, no threshold encoding"))
        if master.residual_post_processor is not None:
            inert.append(("residual_post_processor",
                          master.residual_post_processor,
                          "no residual accumulation without sparsification"))
        if master.workers_per_node != -1:
            inert.append(("workers_per_node", master.workers_per_node,
                          "worker count is the mesh rank count"))
    for name, value, why in inert:
        log.warning("spark-compat: %s=%r has no effect on this card (%s)",
                    name, value, why)


@dataclasses.dataclass
class ParameterAveragingTrainingMaster:
    """Reference ParameterAveragingTrainingMaster.Builder surface."""
    batch_size_per_worker: int = 16
    averaging_frequency: int = 1
    aggregation_depth: int = 2
    worker_prefetch_num_batches: int = 2

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def averaging_frequency(self, v):
            self._kw["averaging_frequency"] = int(v)
            return self

        def aggregation_depth(self, v):
            self._kw["aggregation_depth"] = int(v)
            return self

        def worker_prefetch_num_batches(self, v):
            self._kw["worker_prefetch_num_batches"] = int(v)
            return self

        def build(self):
            return ParameterAveragingTrainingMaster(**self._kw)


@dataclasses.dataclass
class SharedTrainingMaster:
    """Reference SharedTrainingMaster.Builder surface (gradient sharing)."""
    batch_size_per_worker: int = 16
    threshold: float = 1e-3
    threshold_algorithm: Optional[Any] = None
    residual_post_processor: Optional[Any] = None
    workers_per_node: int = -1

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def update_threshold(self, v):
            self._kw["threshold"] = float(v)
            return self

        def threshold_algorithm(self, a):
            self._kw["threshold_algorithm"] = a
            return self

        def residual_post_processor(self, p):
            self._kw["residual_post_processor"] = p
            return self

        def workers_per_node(self, n):
            self._kw["workers_per_node"] = int(n)
            return self

        def build(self):
            return SharedTrainingMaster(**self._kw)


class SparkDl4jMultiLayer:
    """Reference SparkDl4jMultiLayer: "the cluster" is the mesh. The
    network is distributed over it and each element of the input
    iterable is one global batch (every rank iterates the same)."""

    def __init__(self, sc_or_mesh, net, training_master):
        self.net = net
        self.master = training_master
        if training_master is not None:
            _warn_inert(training_master)
        self.mesh = sc_or_mesh if isinstance(sc_or_mesh, Mesh) \
            else make_mesh(MeshConfig(), device=net.device)
        net.distribute(self.mesh)

    def fit(self, dataset_iterable, num_epochs: int = 1):
        for _ in range(num_epochs):
            if hasattr(dataset_iterable, "reset"):
                dataset_iterable.reset()
            for ds in dataset_iterable:
                if not isinstance(ds, DataSet):
                    ds = DataSet(*ds)
                self.net.fit(ds)
        return self.net

    def get_network(self):
        return self.net

    def get_score(self) -> float:
        return self.net.score_value


class SparkComputationGraph(SparkDl4jMultiLayer):
    """Reference SparkComputationGraph — the same driver, a graph."""
