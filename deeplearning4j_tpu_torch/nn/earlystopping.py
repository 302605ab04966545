"""Early stopping.

Counterpart of ``deeplearning4j_tpu/nn/earlystopping.py`` (the
reference's ``earlystopping/`` package): the termination conditions, the
score calculators, the model savers, ``EarlyStoppingConfiguration`` and
``EarlyStoppingTrainer``, whose loop keeps the JAX package's bookkeeping
step for step (best score and epoch, evaluation cadence, termination
reason). ``InMemoryModelSaver`` keeps ``clone()``s on the network's
device; ``LocalFileModelSaver`` writes ``nn/serde.py``'s zip and restores
it onto ``device`` (the card by default).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Sequence


# -- termination conditions ---------------------------------------------
class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without improvement (reference class of same name).

    `minimize` is set automatically by EarlyStoppingTrainer from the score
    calculator's direction (accuracy-style calculators maximize)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0, minimize: bool = True):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.minimize = minimize
        self._best = None
        self._bad_epochs = 0

    def terminate(self, epoch, score):
        if score is None:  # no fresh evaluation this epoch — no signal
            return False
        if self._best is None:
            improved = True
        elif self.minimize:
            improved = score < self._best - self.min_improvement
        else:
            improved = score > self._best + self.min_improvement
        if improved:
            self._best = score
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
        return self._bad_epochs > self.patience


class MaxTimeIterationTerminationCondition:
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def start(self):
        self._start = time.time()

    def terminate(self) -> bool:
        return self._start is not None and \
            (time.time() - self._start) > self.max_seconds


# -- score calculators ---------------------------------------------------
class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError

    minimize_score = True


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (reference DataSetLossCalculator)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, net):
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for ds in self.iterator:
            total += net.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / max(n, 1)


class ClassificationScoreCalculator(ScoreCalculator):
    """Eval-metric score (accuracy/f1); maximized."""
    minimize_score = False

    def __init__(self, iterator, metric: str = "accuracy"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, net):
        e = net.evaluate(self.iterator)
        return getattr(e, self.metric)()


# -- savers --------------------------------------------------------------
class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, net, score):
        self.best = net.clone()

    def save_latest_model(self, net, score):
        self.latest = net.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver:
    def __init__(self, directory: str, device="cuda"):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    @property
    def _path(self):
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def _latest_path(self):
        return os.path.join(self.directory, "latestModel.zip")

    def save_best_model(self, net, score):
        net.save(self._path, save_updater=True)

    def save_latest_model(self, net, score):
        net.save(self._latest_path, save_updater=True)

    def get_best_model(self):
        from .serde import restore_model
        return restore_model(self._path, load_updater=True,
                             device=self.device)

    def get_latest_model(self):
        from .serde import restore_model
        return restore_model(self._latest_path, load_updater=True,
                             device=self.device)


# -- config + trainer ----------------------------------------------------
@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator = None
    epoch_termination_conditions: Sequence = ()
    iteration_termination_conditions: Sequence = ()
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._kw = {}

        def score_calculator(self, sc):
            self._kw["score_calculator"] = sc
            return self

        def epoch_termination_conditions(self, *conds):
            self._kw["epoch_termination_conditions"] = conds
            return self

        def iteration_termination_conditions(self, *conds):
            self._kw["iteration_termination_conditions"] = conds
            return self

        def model_saver(self, s):
            self._kw["model_saver"] = s
            return self

        def evaluate_every_n_epochs(self, n):
            self._kw["evaluate_every_n_epochs"] = n
            return self

        def build(self):
            return EarlyStoppingConfiguration(**self._kw)

    @staticmethod
    def builder():
        return EarlyStoppingConfiguration.Builder()


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object

    def get_best_model(self):
        return self.best_model


class EarlyStoppingTrainer:
    """Reference EarlyStoppingTrainer.fit() loop."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 fit_fn: Optional[Callable] = None):
        self.config = config
        self.net = net
        self._fit_fn = fit_fn or (lambda it, num_epochs=1:
                                  net.fit(it, num_epochs=num_epochs))

    def fit(self, train_iterator) -> EarlyStoppingResult:
        cfg = self.config
        if not cfg.epoch_termination_conditions and \
                not cfg.iteration_termination_conditions:
            raise ValueError(
                "EarlyStoppingConfiguration needs at least one termination "
                "condition (e.g. MaxEpochsTerminationCondition) — without "
                "one, fit() would never stop")
        minimize = (cfg.score_calculator is None or
                    cfg.score_calculator.minimize_score)
        for c in cfg.iteration_termination_conditions:
            if hasattr(c, "start"):
                c.start()
        for c in cfg.epoch_termination_conditions:
            # propagate score direction into direction-sensitive conditions
            if hasattr(c, "minimize"):
                c.minimize = minimize
        best_score = float("inf") if minimize else float("-inf")
        best_epoch = -1
        epoch = 0
        last_score = None
        reason, details = "Unknown", ""
        while True:
            self._fit_fn(train_iterator, num_epochs=1)
            terminated = False
            for c in cfg.iteration_termination_conditions:
                if c.terminate():
                    reason, details = "IterationTerminationCondition", type(c).__name__
                    terminated = True
            if cfg.score_calculator is not None:
                if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                    score = cfg.score_calculator.calculate_score(self.net)
                    last_score = score
                else:
                    # no fresh eval this epoch: pass None so patience-style
                    # conditions count *evaluations*, not epochs
                    score = None
            else:
                score = self.net.score_value
                last_score = score
            if cfg.save_last_model and \
                    hasattr(cfg.model_saver, "save_latest_model"):
                cfg.model_saver.save_latest_model(self.net, score)
            if score is not None:
                better = score < best_score if minimize else score > best_score
                if better:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.net, score)
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score):
                    reason = "EpochTerminationCondition"
                    details = type(c).__name__
                    terminated = True
            epoch += 1
            if terminated:
                break
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            best_model_epoch=best_epoch, best_model_score=best_score,
            total_epochs=epoch,
            best_model=cfg.model_saver.get_best_model())
