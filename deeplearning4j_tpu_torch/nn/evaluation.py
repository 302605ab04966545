"""Evaluation metrics.

A copy of ``deeplearning4j_tpu/nn/evaluation.py`` (numpy inside); labels
and predictions may be NDArrays, tensors on any device, or arrays.

Reference: `org/nd4j/evaluation/classification/Evaluation.java` (accuracy/
precision/recall/F1 + confusion matrix), `EvaluationBinary`, `ROC`,
`regression/RegressionEvaluation.java`. Accumulation happens on host in
numpy (tiny data); the confusion matrix is built with one vectorized
bincount per batch.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ndarray.ndarray import NDArray


def _np(x):
    if isinstance(x, NDArray):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).numpy()
    return np.asarray(x)


class Evaluation:
    """Multi-class classification metrics (reference Evaluation.java)."""

    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.confusion: Optional[np.ndarray] = None
        self.top_n = top_n
        self._top_n_correct = 0
        self._top_n_total = 0

    def eval(self, labels, predictions):
        y = _np(labels)
        p = _np(predictions)
        if y.ndim > 1 and y.shape[-1] > 1:
            y = np.argmax(y, axis=-1)
        else:
            y = y.astype(np.int64).reshape(y.shape[0], *y.shape[1:])
            y = y.squeeze(-1) if y.ndim > 1 and y.shape[-1] == 1 else y
        if p.ndim > 1 and p.shape[-1] > 1:
            n = p.shape[-1]
            if self.top_n > 1:  # reference topNAccuracy
                kth = min(self.top_n, n)
                top = np.argpartition(-p.reshape(-1, n), kth - 1,
                                      axis=-1)[:, :kth]
                self._top_n_correct += int(
                    np.sum(top == y.ravel()[:, None]))
                self._top_n_total += top.shape[0]
            p = np.argmax(p, axis=-1)
        else:
            p = p.squeeze(-1) if p.ndim > 1 else p
            if np.issubdtype(p.dtype, np.floating):
                # single sigmoid output: threshold at 0.5 (reference binary mode)
                p = (p > 0.5).astype(np.int64)
            else:
                p = p.astype(np.int64)
            n = self.num_classes or int(max(y.max(), p.max())) + 1
        if self.num_classes is None:
            self.num_classes = n
        if self.confusion is None:
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      np.int64)
        y = y.ravel()
        p = p.ravel()
        cm = np.bincount(y * self.num_classes + p,
                         minlength=self.num_classes ** 2)
        self.confusion += cm.reshape(self.num_classes, self.num_classes)

    # -- metrics ---------------------------------------------------------
    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def accuracy(self) -> float:
        total = self.confusion.sum()
        return float(self._tp().sum() / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction where the true class was in the top-N predictions
        (reference Evaluation.topNAccuracy)."""
        if self._top_n_total == 0:
            return self.accuracy()
        return self._top_n_correct / self._top_n_total

    def precision(self, cls: Optional[int] = None) -> float:
        col = self.confusion.sum(axis=0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, self._tp() / col, 0.0)
        return float(per[cls]) if cls is not None else float(np.mean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        row = self.confusion.sum(axis=1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, self._tp() / row, 0.0)
        return float(per[cls]) if cls is not None else float(np.mean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def false_positive_rate(self, cls: int) -> float:
        fp = self.confusion[:, cls].sum() - self.confusion[cls, cls]
        tn = self.confusion.sum() - self.confusion[cls, :].sum() \
            - self.confusion[:, cls].sum() + self.confusion[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) > 0 else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp = self.confusion[cls, cls]
        fp = self.confusion[:, cls].sum() - tp
        fn = self.confusion[cls, :].sum() - tp
        tn = self.confusion.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {self.num_classes}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "=========================Confusion Matrix=========================",
            str(self.confusion),
        ]
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary metrics (reference EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions):
        y = _np(labels) > 0.5
        p = _np(predictions) > self.threshold
        if self.tp is None:
            n = y.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        flat_y = y.reshape(-1, y.shape[-1])
        flat_p = p.reshape(-1, p.shape[-1])
        self.tp += np.sum(flat_y & flat_p, axis=0)
        self.fp += np.sum(~flat_y & flat_p, axis=0)
        self.tn += np.sum(~flat_y & ~flat_p, axis=0)
        self.fn += np.sum(flat_y & ~flat_p, axis=0)

    def accuracy(self, i: int = 0) -> float:
        total = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / total) if total else 0.0

    def precision(self, i: int = 0) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int = 0) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int = 0) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


class ROC:
    """Binary ROC/AUC with exact thresholding (reference ROC.java with
    thresholdSteps=0 exact mode)."""

    def __init__(self):
        self.scores = []
        self.labels = []

    def eval(self, labels, predictions):
        y = _np(labels).ravel()
        p = _np(predictions)
        if p.ndim > 1 and p.shape[-1] == 2:
            p = p[..., 1]
        self.scores.append(p.ravel())
        self.labels.append(y)

    def calculate_auc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s)
        y = y[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        tpr = tps / max(tps[-1], 1)
        fpr = fps / max(fps[-1], 1)
        return float(np.trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s)
        y = y[order]
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / max(tps[-1], 1)
        return float(np.trapezoid(precision, recall))


class RegressionEvaluation:
    """MSE/MAE/RMSE/R² per column (reference RegressionEvaluation.java)."""

    def __init__(self):
        self._sum_sq = None
        self._sum_abs = None
        self._sum_y = None
        self._sum_y2 = None
        self._sum_pred_err2 = None
        self._n = 0

    def eval(self, labels, predictions):
        y = _np(labels).reshape(-1, _np(labels).shape[-1])
        p = _np(predictions).reshape(-1, _np(predictions).shape[-1])
        err = y - p
        if self._sum_sq is None:
            c = y.shape[-1]
            self._sum_sq = np.zeros(c)
            self._sum_abs = np.zeros(c)
            self._sum_y = np.zeros(c)
            self._sum_y2 = np.zeros(c)
        self._sum_sq += np.sum(err ** 2, axis=0)
        self._sum_abs += np.sum(np.abs(err), axis=0)
        self._sum_y += np.sum(y, axis=0)
        self._sum_y2 += np.sum(y ** 2, axis=0)
        self._n += y.shape[0]

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_sq[col] / self._n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs[col] / self._n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self._sum_y2[col] - self._sum_y[col] ** 2 / self._n
        return float(1.0 - self._sum_sq[col] / max(ss_tot, 1e-12))


class ROCBinary:
    """Per-output binary ROC (reference ROCBinary.java): one ROC curve per
    output column of a multi-label network."""

    def __init__(self):
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions):
        y = _np(labels)
        p = _np(predictions)
        y2 = y.reshape(-1, y.shape[-1])
        p2 = p.reshape(-1, p.shape[-1])
        while len(self._rocs) < y2.shape[-1]:
            self._rocs.append(ROC())
        for i in range(y2.shape[-1]):
            self._rocs[i].eval(y2[:, i], p2[:, i])

    def num_outputs(self) -> int:
        return len(self._rocs)

    def calculate_auc(self, i: int = 0) -> float:
        return self._rocs[i].calculate_auc()

    def calculate_auprc(self, i: int = 0) -> float:
        return self._rocs[i].calculate_auprc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions):
        y = _np(labels)
        p = _np(predictions)
        y2 = y.reshape(-1, y.shape[-1])
        p2 = p.reshape(-1, p.shape[-1])
        n = y2.shape[-1]
        while len(self._rocs) < n:
            self._rocs.append(ROC())
        cls = np.argmax(y2, axis=-1)
        for i in range(n):
            self._rocs[i].eval((cls == i).astype(np.float64), p2[:, i])

    def num_classes(self) -> int:
        return len(self._rocs)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


class EvaluationCalibration:
    """Reliability diagram + histogram calibration metrics (reference
    EvaluationCalibration.java): bins predicted probabilities and records
    observed positive fraction per bin, plus residual-probability and
    probability histograms."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 10):
        self.n_bins = reliability_bins
        self.hist_bins = histogram_bins
        self.bin_counts = None        # [C, bins]
        self.bin_pos = None           # [C, bins] positives per bin
        self.bin_prob_sum = None      # [C, bins] sum of predicted prob
        self.residual_hist = np.zeros(histogram_bins, np.int64)
        self.prob_hist = None

    def eval(self, labels, predictions):
        y = _np(labels)
        p = _np(predictions)
        y2 = y.reshape(-1, y.shape[-1])
        p2 = p.reshape(-1, p.shape[-1])
        C = y2.shape[-1]
        if self.bin_counts is None:
            self.bin_counts = np.zeros((C, self.n_bins), np.int64)
            self.bin_pos = np.zeros((C, self.n_bins), np.int64)
            self.bin_prob_sum = np.zeros((C, self.n_bins), np.float64)
            self.prob_hist = np.zeros((C, self.hist_bins), np.int64)
        bins = np.clip((p2 * self.n_bins).astype(np.int64), 0,
                       self.n_bins - 1)
        hbins = np.clip((p2 * self.hist_bins).astype(np.int64), 0,
                        self.hist_bins - 1)
        for c in range(C):
            np.add.at(self.bin_counts[c], bins[:, c], 1)
            np.add.at(self.bin_pos[c], bins[:, c],
                      (y2[:, c] > 0.5).astype(np.int64))
            np.add.at(self.bin_prob_sum[c], bins[:, c], p2[:, c])
            np.add.at(self.prob_hist[c], hbins[:, c], 1)
        # residual = |label - prob| pooled over all outputs
        resid = np.abs(y2 - p2).ravel()
        rbins = np.clip((resid * self.hist_bins).astype(np.int64), 0,
                        self.hist_bins - 1)
        np.add.at(self.residual_hist, rbins, 1)

    def reliability_curve(self, cls: int = 0):
        """(mean predicted prob, observed fraction) per non-empty bin."""
        counts = self.bin_counts[cls]
        mask = counts > 0
        mean_pred = np.where(mask, self.bin_prob_sum[cls] /
                             np.maximum(counts, 1), 0.0)
        observed = np.where(mask, self.bin_pos[cls] /
                            np.maximum(counts, 1), 0.0)
        return mean_pred[mask], observed[mask]

    def expected_calibration_error(self, cls: int = 0) -> float:
        counts = self.bin_counts[cls].astype(np.float64)
        total = counts.sum()
        if total == 0:
            return 0.0
        mean_pred = self.bin_prob_sum[cls] / np.maximum(counts, 1)
        observed = self.bin_pos[cls] / np.maximum(counts, 1)
        return float(np.sum(counts / total * np.abs(mean_pred - observed)))

    def probability_histogram(self, cls: int = 0):
        return self.prob_hist[cls].copy()

    def residual_plot(self):
        return self.residual_hist.copy()
