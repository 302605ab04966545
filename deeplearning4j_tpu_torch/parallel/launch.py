"""Rank processes: a pool of ``torch.distributed`` ranks that run jobs.

A JAX program sees every device of the host from one process; the port
runs one process per rank. :class:`RankPool` starts ``world`` processes
with the ``spawn`` start method (never ``fork``: the parent may hold
threads, and a JAX runtime in a test process), joins them into one
default process group over a ``file://`` store in a fresh temporary
directory (no fixed port, so two pools on one host never collide), and
then runs jobs by name: ``pool.run("pkg.module:function", *args)`` calls
the function on every rank with the same arguments and returns the
results in rank order. A job that raises on any rank ends the pool at
once (the others may be waiting for it in a collective) and raises with
its traceback; so does a rank that dies or stalls past ``timeout``.

The backend is gloo on the CPU; on CUDA, NCCL where every rank has a
card of its own, else gloo with the ranks sharing ``cuda:0`` (NCCL
refuses two ranks on one device), the collectives staging CUDA tensors
through host memory (``collectives.transport``). Each rank process uses
one intra-op thread. Ranks run on the card unless ``device="cpu"`` is
passed; a CUDA device where torch sees none raises.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, List


def default_backend(device: str, world: int) -> str:
    import torch
    if str(device).startswith("cuda") and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def resolve(ref: str):
    """``"pkg.module:function"`` -> the function."""
    mod, _, name = ref.partition(":")
    return getattr(importlib.import_module(mod), name)


def _worker(rank, world, init_method, backend, device, timeout_s, jobs,
            results):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if str(device).startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            ref, args, kwargs = job
            try:
                results.put((rank, True, resolve(ref)(*args, **kwargs)))
            except BaseException:  # noqa: BLE001 — reported to the parent
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` rank processes that take jobs by name (module docstring).
    Use as a context manager, or call :meth:`close`."""

    def __init__(self, world: int, device: str = "cuda",
                 backend: str = None, timeout: float = 300.0):
        from ..nn.multilayer import resolve_device
        self.world = int(world)
        self.device = str(resolve_device(device))
        self.backend = backend or default_backend(self.device, self.world)
        self.timeout = float(timeout)
        self._dir = tempfile.mkdtemp(prefix="dl4j_ranks_")
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        init = "file://" + os.path.join(self._dir, "store")
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, self.world, init, self.backend, self.device,
                  self.timeout, self._jobs[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self.closed = False

    def run(self, ref: str, *args, **kwargs) -> List[Any]:
        """``ref(*args, **kwargs)`` on every rank; the results by rank."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        for q in self._jobs:
            q.put((ref, args, kwargs))
        out = {}
        deadline = time.monotonic() + self.timeout
        while len(out) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    why = (f"ranks {dead} died" if dead else
                           f"no answer in {self.timeout:.0f} s")
                    raise RuntimeError(f"{ref}: {why}; finished: "
                                       f"{sorted(out)}") from None
                continue
            if not ok:
                # the other ranks may be waiting in a collective for this
                # one: end them all now rather than at their timeout
                self.close()
                raise RuntimeError(f"{ref} failed on rank {rank}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def close(self):
        if self.closed:
            return
        self.closed = True
        for q in self._jobs:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for q in self._jobs + [self._results]:
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def spawn(ref: str, world: int, *args, device: str = "cuda",
          timeout: float = 600.0, **kwargs) -> List[Any]:
    """Start ``world`` ranks, run ``ref`` once on each, stop them."""
    with RankPool(world, device, timeout=timeout) as pool:
        return pool.run(ref, *args, **kwargs)
