"""Distributed trainers: ParallelWrapper, ParallelInference and the
multi-process bootstrap.

Counterpart of ``deeplearning4j_tpu/parallel/trainer.py`` (the
reference's ``ParallelWrapper``, ``ParallelInference`` and
``EarlyStoppingParallelTrainer``). The JAX package compiles the
network's train step over a mesh with the batch sharded over
``data``; here every rank runs ``nn/sharding.py``'s sharded step on its
rows of the global batch and the gradients are summed over the
``(data, fsdp)`` group (NCCL on the card, gloo on the CPU), so each rank
ends each step with the same params the single-process ``fit`` would
have. Every rank calls ``fit`` with the same iterator.

``zero1=True`` (or ``DL4J_TPU_ZERO1=1``) keeps the updater state sharded
over the data-parallel group for the duration of ``fit`` (ZeRO-1: each
rank holds 1/dp of every divisible state tensor); it is gathered back
into the network when ``fit`` returns. ``conf.grad_accum`` and
``conf.remat`` are honoured: the sharded step runs the network's own
micro-batch gradients under them. The prefetch thread
(``AsyncDataSetIterator``) places each global batch on the rank's
device while the previous step runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..common import rng
from ..common.environment import environment
from ..common.mesh import (DATA, FSDP, Mesh, MeshConfig, dp_size, gather,
                           make_mesh)
from ..common.tracing import span
from ..learning import tree_map
from ..ndarray.ndarray import NDArray
from ..nn.fit_fastpath import full_f32
from ..nn.sharding import (gather_updater_state, place_updater_state,
                           shard_batch_value, sharded_train_step)
from . import collectives as C


@dataclasses.dataclass
class DistributedConfig:
    """Multi-process bootstrap (the reference's ``VoidConfiguration``):
    ``initialize`` joins the default ``torch.distributed`` group at
    ``tcp://coordinator_address`` as rank ``process_id`` of
    ``num_processes`` (NCCL where CUDA is available, else gloo), when
    there is more than one process and no group yet."""
    coordinator_address: Optional[str] = None  # "host:port" of rank 0
    num_processes: int = 1
    process_id: int = 0
    backend: Optional[str] = None

    def initialize(self):
        import torch.distributed as dist
        if self.coordinator_address and self.num_processes > 1 and \
                not dist.is_initialized():
            backend = self.backend or ("nccl" if torch.cuda.is_available()
                                       else "gloo")
            dist.init_process_group(
                backend, init_method=f"tcp://{self.coordinator_address}",
                world_size=self.num_processes, rank=self.process_id)
        return self


def _tensor(x):
    return x.torch() if isinstance(x, NDArray) else x


class ParallelWrapper:
    """Data-parallel trainer over a mesh (module docstring)::

        wrapper = ParallelWrapper.builder(net).workers(8).build()
        wrapper.fit(iterator)

    ``workers(n)`` is a data axis of n ranks; ``averaging_frequency``,
    ``training_mode`` and ``residual_post_processor`` are accepted for
    source compatibility and do nothing (the gradients are summed every
    step)."""

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 prefetch_buffer: int = 2, zero1: Optional[bool] = None):
        self.net = net
        self.mesh = mesh if mesh is not None \
            else make_mesh(MeshConfig(), device=net.device)
        self.prefetch_buffer = prefetch_buffer
        self.zero1 = environment().training_zero1() if zero1 is None \
            else bool(zero1)
        self._step = None

    class Builder:
        def __init__(self, net):
            self._net = net
            self._mesh = None
            self._prefetch = 2
            self._zero1 = None

        def workers(self, n: int):
            self._mesh = make_mesh(MeshConfig(data=n), devices=range(n),
                                   device=self._net.device)
            return self

        def mesh(self, mesh: Mesh):
            self._mesh = mesh
            return self

        def prefetch_buffer(self, n: int):
            self._prefetch = n
            return self

        def zero1(self, v: bool = True):
            """ZeRO-1 updater-state sharding over the data-parallel
            group."""
            self._zero1 = bool(v)
            return self

        # accepted for source compatibility; the step sums every time
        def averaging_frequency(self, n: int):
            return self

        def training_mode(self, mode: str):
            return self

        def residual_post_processor(self, p):
            return self

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._net, self._mesh, self._prefetch,
                                   zero1=self._zero1)

    @staticmethod
    def builder(net) -> "ParallelWrapper.Builder":
        return ParallelWrapper.Builder(net)

    def fit(self, iterator, num_epochs: int = 1):
        net = self.net
        net._check_init()
        if self._step is None:
            # the census: one event per new signature, the JAX package's
            # counted_jit tag; eager, as a mesh's fit step is
            from ..runtime.cuda_graphs import mesh_reason
            from ..runtime.inference import eager_dispatch
            self._step = eager_dispatch(
                sharded_train_step(net, self.mesh, self.zero1),
                f"parallel:{id(net)}:z{int(self.zero1)}",
                net._train_graphs(), mesh_reason(self.mesh) or "mesh")
        trainable = net._trainable(net._params)
        states = net._states(net._params)
        ustate = net._updater_state
        if self.zero1:
            ustate = place_updater_state(self.mesh, ustate, trainable, True)

        reg = environment().metrics()
        tel = reg.enabled
        workers = [str(r) for r in self.mesh.devices.flat]
        if tel:
            steps_c = reg.counter("dl4j_train_steps_total",
                                  "Optimizer steps taken",
                                  labels=("path",)).labels(path="parallel")
            samples_c = reg.counter("dl4j_train_samples_total",
                                    "Training samples consumed",
                                    labels=("path",)).labels(path="parallel")
            total_g = reg.gauge("dl4j_parallel_samples_per_sec",
                                "ParallelWrapper whole-mesh throughput")
            worker_fam = reg.gauge(
                "dl4j_parallel_worker_samples_per_sec",
                "Per-worker (mesh rank) share of training throughput",
                labels=("worker",))
            worker_g = [worker_fam.labels(worker=w) for w in workers]

        from ..datasets.iterators import AsyncDataSetIterator
        if self.prefetch_buffer > 0 and hasattr(iterator, "has_next") and \
                not isinstance(iterator, AsyncDataSetIterator):
            iterator = AsyncDataSetIterator(iterator, self.prefetch_buffer,
                                            device=self.mesh.device)
        loss = None
        try:
            for _ in range(num_epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for ds in iterator:
                    with span("train/data_wait"):
                        x, y = net._stage_batch(ds)
                    t0 = time.perf_counter()
                    with span("train/dispatch"):
                        trainable, states, ustate, loss = self._step(
                            trainable, states, ustate, net._iteration, x,
                            y, rng.split(net._rng))
                    net._params = net._merge_states(trainable, states)
                    with span("train/device"):
                        net.score_value = float(loss)  # host sync
                    if tel:
                        from ..nn.fit_fastpath import _batch_rows
                        bs = _batch_rows(x)
                        net._last_batch_size = bs
                        dt = max(time.perf_counter() - t0, 1e-9)
                        steps_c.inc()
                        samples_c.inc(bs)
                        total_g.set(bs / dt)
                        for g in worker_g:
                            g.set(bs / dt / max(len(workers), 1))
                    for lst in net._listeners:
                        if hasattr(lst, "iteration_done"):
                            lst.iteration_done(net, net._iteration,
                                               loss=net.score_value)
                    net._iteration += 1
        finally:
            net._updater_state = gather_updater_state(ustate) \
                if self.zero1 else ustate
        return self

    def shutdown(self):
        pass


class ParallelInference:
    """Batched inference over the mesh's data-parallel ranks (reference
    ``ParallelInference``): the global batch is padded up to a multiple
    of dp, each rank runs its rows, the rows are all-gathered and the
    padding trimmed. Every rank calls ``output`` with the same batch."""

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 batch_limit: int = 64):
        self.net = net
        self.mesh = mesh if mesh is not None \
            else make_mesh(MeshConfig(), device=net.device)
        self.batch_limit = batch_limit
        from ..runtime.inference import counted_dispatch
        self._fn = counted_dispatch(self._forward,
                                    tag=f"parallel_infer:{id(self)}")

    def _forward(self, params, x):
        with torch.no_grad(), full_f32():
            return self.net._forward(params, shard_batch_value(self.mesh, x),
                                     training=False)

    def output(self, x) -> NDArray:
        net = self.net
        x = net._stage(_tensor(x))
        n = x.shape[0]
        pad = (-n) % dp_size(self.mesh)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        out = self._fn(tree_map(gather, net._params), x)
        if dp_size(self.mesh) > 1:
            out = C.all_gather_raw(out.contiguous(), (DATA, FSDP),
                                   self.mesh)
        return NDArray(out[:n])


class EarlyStoppingParallelTrainer:
    """Early stopping over ParallelWrapper (reference
    ``EarlyStoppingParallelTrainer``)."""

    def __init__(self, early_stopping_config, net, mesh=None):
        from ..nn.earlystopping import EarlyStoppingTrainer
        self.wrapper = ParallelWrapper(net, mesh)
        self.inner = EarlyStoppingTrainer(early_stopping_config, net,
                                          fit_fn=self.wrapper.fit)

    def fit(self, train_iter):
        return self.inner.fit(train_iter)
