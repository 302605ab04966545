"""DataSet container.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py`` (the
reference's ``DataSet.java``): features + labels (+ masks) with the
split/shuffle/batch helpers, and ``MultiDataSet``, the several inputs
and labels of a ComputationGraph.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ndarray import factory as nd
from ..ndarray.ndarray import NDArray


def _wrap(x):
    if x is None or isinstance(x, NDArray):
        return x
    return NDArray(x)


def one_hot_labels(idx: np.ndarray, n: int) -> np.ndarray:
    """Integer class ids → one-hot float32 matrix."""
    idx = np.asarray(idx).astype(np.int64).reshape(-1)
    out = np.zeros((len(idx), n), dtype=np.float32)
    out[np.arange(len(idx)), idx] = 1.0
    return out


def _take(a: NDArray, idx) -> NDArray:
    t = a.torch()
    return NDArray(t[torch.as_tensor(idx, device=t.device)])


class DataSet:
    """features + labels (+ optional masks)."""

    def __init__(self, features=None, labels=None, features_mask=None,
                 labels_mask=None):
        self.features = _wrap(features)
        self.labels = _wrap(labels)
        self.features_mask = _wrap(features_mask)
        self.labels_mask = _wrap(labels_mask)

    def num_examples(self) -> int:
        return self.features.shape[0] if self.features is not None else 0

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def shuffle(self, seed: Optional[int] = None):
        if seed is not None:
            nd.set_seed(seed)
        perm = np.random.RandomState(seed).permutation(self.num_examples())
        self.features = _take(self.features, perm)
        if self.labels is not None:
            self.labels = _take(self.labels, perm)
        return self

    def split_test_and_train(self, num_train: int):
        train = DataSet(self.features[:num_train].dup(),
                        self.labels[:num_train].dup() if self.labels is not None else None)
        test = DataSet(self.features[num_train:].dup(),
                       self.labels[num_train:].dup() if self.labels is not None else None)
        return train, test

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [DataSet(self.features[i:i + batch_size].dup(),
                        self.labels[i:i + batch_size].dup()
                        if self.labels is not None else None)
                for i in range(0, n, batch_size)]

    def sample(self, num: int, seed: Optional[int] = None) -> "DataSet":
        idx = np.random.RandomState(seed).choice(self.num_examples(), num,
                                                 replace=False)
        return DataSet(_take(self.features, idx),
                       _take(self.labels, idx)
                       if self.labels is not None else None)

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        feats = nd.concat([d.features for d in datasets], axis=0)
        labs = nd.concat([d.labels for d in datasets], axis=0) \
            if datasets[0].labels is not None else None
        return DataSet(feats, labs)

    def __repr__(self):
        return (f"DataSet(features={None if self.features is None else self.features.shape}, "
                f"labels={None if self.labels is None else self.labels.shape})")


class MultiDataSet:
    """Multiple feature/label arrays (reference MultiDataSet): a
    ComputationGraph's inputs in ``conf.inputs`` order and its labels in
    ``conf.outputs`` order."""

    def __init__(self, features: Sequence = (), labels: Sequence = (),
                 features_masks: Sequence = None,
                 labels_masks: Sequence = None):
        self.features = [_wrap(f) for f in features]
        self.labels = [_wrap(y) for y in labels]
        self.features_masks = ([_wrap(m) for m in features_masks]
                               if features_masks else None)
        self.labels_masks = ([_wrap(m) for m in labels_masks]
                             if labels_masks else None)

    def num_examples(self) -> int:
        return self.features[0].shape[0] if self.features else 0
