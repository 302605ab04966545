"""Training listeners for the layer API (a copy of
``deeplearning4j_tpu/nn/listeners.py``; ``CheckpointListener`` saves
through ``save``, which waits for ``nn/serde.py``).

Reference: `org/deeplearning4j/optimize/listeners/` — ScoreIterationListener,
PerformanceListener (samples/sec), EvaluativeListener, CheckpointListener,
TimeIterationListener, and FailureTestingListener (fault injection for
resilience tests, FailureTestingListener.java:39-47).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional


class TrainingListener:
    def iteration_done(self, model, iteration: int, loss: float = None):
        pass

    def on_epoch_end(self, epoch: int, model):
        pass


class ScoreIterationListener(TrainingListener):
    def __init__(self, print_iterations: int = 10, log_fn=print):
        self.print_iterations = print_iterations
        self.log_fn = log_fn

    def iteration_done(self, model, iteration, loss=None):
        if iteration % self.print_iterations == 0:
            score = loss if loss is not None else model.score_value
            self.log_fn(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """samples/sec + batches/sec (reference PerformanceListener)."""

    def __init__(self, frequency: int = 10, report_samples: bool = True,
                 log_fn=print):
        self.frequency = frequency
        self.report_samples = report_samples
        self.log_fn = log_fn
        self._last_time = None
        self._last_iter = None
        self.batches_per_sec = 0.0
        self.samples_per_sec = 0.0

    def iteration_done(self, model, iteration, loss=None):
        now = time.time()
        if self._last_time is not None and iteration > self._last_iter:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            self.batches_per_sec = iters / dt
            # batch size of the model's last fit input (set by the fit
            # paths); 0 when the model never recorded one
            bs = int(getattr(model, "_last_batch_size", 0) or 0)
            self.samples_per_sec = self.batches_per_sec * bs
            if iteration % self.frequency == 0:
                msg = (f"iteration {iteration}: "
                       f"{self.batches_per_sec:.2f} batches/sec")
                if self.report_samples and bs:
                    msg += f", {self.samples_per_sec:.2f} samples/sec"
                self.log_fn(msg)
        self._last_time = now
        self._last_iter = iteration


class MetricsListener(TrainingListener):
    """Bridges iteration callbacks into the MetricsRegistry
    (`environment().metrics()`), so listener-driven training shows up at
    the UI server's /metrics endpoint alongside the fast-path counters.

    Note: like any listener overriding `iteration_done`, attaching it
    routes fit() through the per-step path (the scanned-epoch fast path
    has no per-iteration callback to bridge)."""

    def __init__(self):
        from ..common.environment import environment
        reg = environment().metrics()
        self._reg = reg
        self._iters = reg.counter(
            "dl4j_listener_iterations_total",
            "Iterations observed by MetricsListener")
        self._epochs = reg.counter(
            "dl4j_listener_epochs_total",
            "Epochs observed by MetricsListener")
        self._score = reg.gauge(
            "dl4j_train_score", "Most recent listener-observed score")
        self._iter_time = reg.histogram(
            "dl4j_iteration_seconds",
            "Wall time between successive iterations")
        self._sps = reg.gauge(
            "dl4j_train_samples_per_sec",
            "Listener-derived training throughput")
        self._last_time = None

    def iteration_done(self, model, iteration, loss=None):
        if not self._reg.enabled:
            return
        now = time.time()
        self._iters.inc()
        score = loss if loss is not None else getattr(model, "score_value",
                                                      None)
        if score is not None:
            self._score.set(float(score))
        if self._last_time is not None and now > self._last_time:
            dt = now - self._last_time
            self._iter_time.observe(dt)
            bs = int(getattr(model, "_last_batch_size", 0) or 0)
            if bs:
                self._sps.set(bs / dt)
        self._last_time = now

    def on_epoch_end(self, epoch, model):
        self._epochs.inc()


class TimeIterationListener(TrainingListener):
    """ETA logger (reference TimeIterationListener)."""

    def __init__(self, total_iterations: int, log_fn=print, frequency: int = 100):
        self.total = total_iterations
        self.start = time.time()
        self.log_fn = log_fn
        self.frequency = frequency

    def iteration_done(self, model, iteration, loss=None):
        if iteration > 0 and iteration % self.frequency == 0:
            elapsed = time.time() - self.start
            rate = iteration / elapsed
            remaining = (self.total - iteration) / max(rate, 1e-9)
            self.log_fn(f"iteration {iteration}/{self.total}, "
                        f"ETA {remaining:.0f}s")


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (reference EvaluativeListener)."""

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch"):
        self.iterator = iterator
        self.frequency = frequency
        self.unit = unit
        self.evaluations: List = []

    def _evaluate(self, model):
        e = model.evaluate(self.iterator)
        self.evaluations.append(e)
        return e

    def iteration_done(self, model, iteration, loss=None):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, epoch, model):
        if self.unit == "epoch" and epoch % self.frequency == 0:
            self._evaluate(model)


class CheckpointListener(TrainingListener):
    def __init__(self, directory: str, save_every_n_epochs: int = None,
                 save_every_n_iterations: int = None, keep_last: int = 3):
        self.directory = directory
        self.every_epoch = save_every_n_epochs
        self.every_iter = save_every_n_iterations
        self.keep_last = keep_last
        self._saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag):
        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        model.save(path, save_updater=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iteration_done(self, model, iteration, loss=None):
        if self.every_iter and iteration > 0 and iteration % self.every_iter == 0:
            self._save(model, f"iter{iteration}")

    def on_epoch_end(self, epoch, model):
        if self.every_epoch and epoch % self.every_epoch == 0:
            self._save(model, f"epoch{epoch}")


class CollectScoresListener(TrainingListener):
    def __init__(self):
        self.iterations: List[int] = []
        self.scores: List[float] = []

    def iteration_done(self, model, iteration, loss=None):
        self.iterations.append(iteration)
        self.scores.append(loss if loss is not None else model.score_value)


class FailureTestingListener(TrainingListener):
    """Fault injection for resilience tests (reference
    FailureTestingListener.FailureMode: OOM, SYSTEM_EXIT_1, ILLEGAL_STATE,
    INFINITE_SLEEP)."""

    OOM = "OOM"
    SYSTEM_EXIT_1 = "SYSTEM_EXIT_1"
    ILLEGAL_STATE = "ILLEGAL_STATE"
    INFINITE_SLEEP = "INFINITE_SLEEP"

    def __init__(self, failure_mode: str, trigger_iteration: int):
        self.failure_mode = failure_mode
        self.trigger_iteration = trigger_iteration

    def iteration_done(self, model, iteration, loss=None):
        if iteration != self.trigger_iteration:
            return
        if self.failure_mode == self.OOM:
            hog = []
            while True:
                hog.append(bytearray(1 << 30))
        elif self.failure_mode == self.SYSTEM_EXIT_1:
            raise SystemExit(1)
        elif self.failure_mode == self.ILLEGAL_STATE:
            raise RuntimeError("FailureTestingListener: injected failure")
        elif self.failure_mode == self.INFINITE_SLEEP:
            while True:
                time.sleep(3600)
