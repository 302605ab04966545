"""Listener framework for SameDiff training.

Counterpart of ``deeplearning4j_tpu/autodiff/listeners.py`` (the
reference's ``org/nd4j/autodiff/listeners/``): the iteration- and
epoch-level hooks the reference's production listeners use.
``ProfilingListener`` writes one chrome-trace event a step and can run
``torch.profiler`` over a window of iterations (where the JAX listener
runs ``jax.profiler``).
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np
import torch


def _host(t) -> np.ndarray:
    """A tensor on the host; bf16 widened to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class BaseListener:
    def iteration_done(self, sd, iteration: int, epoch: int, loss: float):
        pass

    def epoch_done(self, sd, epoch: int):
        pass


class ScoreListener(BaseListener):
    """Logs loss every N iterations (reference ScoreListener)."""

    def __init__(self, frequency: int = 10, log_fn=print):
        self.frequency = frequency
        self.log_fn = log_fn

    def iteration_done(self, sd, iteration, epoch, loss):
        if iteration % self.frequency == 0:
            self.log_fn(f"iter {iteration} epoch {epoch}: loss {loss:.6f}")


class HistoryListener(BaseListener):
    def __init__(self):
        self.losses: List[float] = []

    def iteration_done(self, sd, iteration, epoch, loss):
        self.losses.append(loss)


class CheckpointListener(BaseListener):
    """Periodic model save with retention (reference CheckpointListener)."""

    def __init__(self, directory: str, save_every_n_iterations: int = None,
                 save_every_n_epochs: int = None, keep_last: int = 3):
        self.directory = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self._saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, sd, tag: str):
        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        sd.save(path, save_updater_state=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iteration_done(self, sd, iteration, epoch, loss):
        if self.every_iter and iteration > 0 and \
                iteration % self.every_iter == 0:
            self._save(sd, f"iter{iteration}")

    def epoch_done(self, sd, epoch):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0:
            self._save(sd, f"epoch{epoch}")


class ProfilingListener(BaseListener):
    """Chrome-trace JSON writer (reference ProfilingListener): one
    "train_step" event per iteration after ``warmup``. With
    ``trace_dir`` and ``trace_iters``, ``torch.profiler`` records
    iterations ``warmup`` .. ``warmup + trace_iters`` and writes its
    chrome trace into ``trace_dir``."""

    def __init__(self, output_path: str, warmup: int = 1,
                 trace_dir: Optional[str] = None, trace_iters: int = 0):
        self.output_path = output_path
        self.warmup = warmup
        self.events: List[dict] = []
        self._last_ts = None
        self.trace_dir = trace_dir
        self.trace_iters = trace_iters
        self._prof = None

    def iteration_done(self, sd, iteration, epoch, loss):
        now = time.time() * 1e6  # chrome trace uses microseconds
        if self._last_ts is not None and iteration >= self.warmup:
            self.events.append({
                "name": "train_step", "ph": "X", "pid": 0, "tid": 0,
                "ts": self._last_ts, "dur": now - self._last_ts,
                "args": {"iteration": iteration, "epoch": epoch,
                         "loss": loss},
            })
        self._last_ts = now
        if self.trace_dir and self.trace_iters:
            if iteration == self.warmup and self._prof is None:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
            elif self._prof is not None and \
                    iteration >= self.warmup + self.trace_iters:
                self._prof.__exit__(None, None, None)
                os.makedirs(self.trace_dir, exist_ok=True)
                self._prof.export_chrome_trace(
                    os.path.join(self.trace_dir, "trace.json"))
                self._prof = None

    def epoch_done(self, sd, epoch):
        with open(self.output_path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


class UIListener(BaseListener):
    """Streams SameDiff training into a UI StatsStorage (reference
    UIListener): any object with ``put_static_info`` and
    ``put_update``."""

    def __init__(self, storage, session_id: str = None,
                 update_frequency: int = 1):
        self.storage = storage
        self.session_id = session_id or f"samediff_{int(time.time())}"
        self.update_frequency = update_frequency
        self._static_sent = False

    def iteration_done(self, sd, iteration, epoch, loss):
        if iteration % self.update_frequency:
            return
        if not self._static_sent:
            self.storage.put_static_info(self.session_id, {
                "model_class": "SameDiff",
                "n_layers": len(sd._ops),
                "n_params": int(sum(
                    int(a.numel()) for n, a in sd._arrays.items()
                    if sd._vars[n].var_type.value == "VARIABLE")),
                "start_time": time.time(),
            })
            self._static_sent = True
        record = {"iteration": int(iteration), "epoch": int(epoch),
                  "time": time.time(), "score": float(loss), "params": {}}
        for name, arr in sd._arrays.items():
            v = sd._vars.get(name)
            if v is None or v.var_type.value != "VARIABLE":
                continue
            a = _host(arr)
            record["params"][name] = {
                "l2": float(np.linalg.norm(a)),
                "mean_mag": float(np.mean(np.abs(a)))}
        self.storage.put_update(self.session_id, record)


class ExecDebuggingListener(BaseListener):
    """Logs per-iteration loss and variable summaries (reference
    ExecDebuggingListener, at the granularity of a step)."""

    def __init__(self, log_fn=print, print_arrays: bool = False):
        self.log_fn = log_fn
        self.print_arrays = print_arrays

    def iteration_done(self, sd, iteration, epoch, loss):
        self.log_fn(f"[exec-debug] iter={iteration} epoch={epoch} "
                    f"loss={loss:.6f}")
        if self.print_arrays:
            for name, arr in sd._arrays.items():
                a = _host(arr)
                self.log_fn(f"  {name}: shape={a.shape} "
                            f"min={a.min():.4g} max={a.max():.4g} "
                            f"mean={a.mean():.4g}")


class OpBenchmarkListener(BaseListener):
    """Wall time per training step (reference OpBenchmarkListener, at the
    granularity of a step)."""

    def __init__(self):
        self.times: List[float] = []
        self._last = None

    def iteration_done(self, sd, iteration, epoch, loss):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def average_seconds(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


class ArraySavingListener(BaseListener):
    """Dumps variable arrays every N iterations (reference
    ArraySavingListener) for offline diffing."""

    def __init__(self, directory: str, frequency: int = 1):
        self.directory = directory
        self.frequency = frequency
        os.makedirs(directory, exist_ok=True)

    def iteration_done(self, sd, iteration, epoch, loss):
        if iteration % self.frequency:
            return
        path = os.path.join(self.directory, f"iter_{iteration}.npz")
        np.savez(path, **{n.replace("/", "__"): _host(a)
                          for n, a in sd._arrays.items()})
