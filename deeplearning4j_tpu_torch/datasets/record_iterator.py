"""RecordReader → DataSet bridge iterators.

Counterpart of ``deeplearning4j_tpu/datasets/record_iterator.py``
(reference ``RecordReaderDataSetIterator.java``: label column +
numClasses → one-hot, regression mode, optional TransformProcess
pre-pass; and ``SequenceRecordReaderDataSetIterator.java``). Records are
read through the port's ``etl/`` on the host; the batches are tensors on
``device`` (the card by default).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..etl.executor import LocalTransformExecutor
from ..etl.records import RecordReader, SequenceRecordReader
from ..etl.transform_process import TransformProcess
from ..etl.writable import to_double
from ..ndarray.ndarray import NDArray
from .dataset import DataSet, one_hot_labels as _one_hot
from .iterators import DataSetIterator


def _device(device) -> torch.device:
    from ..nn.multilayer import resolve_device
    return resolve_device(device)


class RecordReaderDataSetIterator(DataSetIterator):
    """Tabular or image records → batched DataSets.

    - classification: ``label_index`` + ``num_classes`` → one-hot labels
    - regression: ``regression=True`` with ``label_index``(+``label_index_to``)
    - unsupervised: ``label_index=None``

    Every record is read (and transformed) once, into one float32 feature
    matrix and one label matrix, which move to ``device`` once; each batch
    is a slice of them there, not a copy.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = -1,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None,
                 transform_process: Optional[TransformProcess] = None,
                 device="cuda"):
        self.device = _device(device)
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to
        self.tp = transform_process
        self._features: Optional[torch.Tensor] = None
        self._labels: Optional[torch.Tensor] = None
        self._i = 0
        self._materialize()

    def _materialize(self):
        records = list(self.reader)
        if self.tp is not None:
            records = LocalTransformExecutor.execute(records, self.tp)
        if not records:
            raise ValueError("record reader produced no records")
        feats, labels = [], []
        for rec in records:
            if (len(rec) and isinstance(rec[0], np.ndarray)
                    and rec[0].ndim > 1):
                # image-style record: [array, label?]
                feats.append(np.asarray(rec[0], np.float32))
                if self.label_index is not None and len(rec) > 1:
                    labels.append(rec[1])
                continue
            row = list(rec)
            li = self.label_index
            if li is not None:
                if li < 0:
                    li = len(row) + li
                hi = self.label_index_to if self.label_index_to is not None \
                    else li
                lab = [to_double(v) for v in row[li:hi + 1]]
                labels.append(lab[0] if len(lab) == 1 else lab)
                del row[li:hi + 1]
            feats.append([to_double(v) for v in row])
        host_labels = None
        if self.label_index is not None and labels:
            lab = np.asarray(labels)
            if self.regression or self.num_classes is None:
                if lab.ndim == 1:
                    lab = lab[:, None]
                host_labels = lab.astype(np.float32)
            else:
                host_labels = _one_hot(np.asarray(lab).reshape(-1),
                                       self.num_classes)
        self._features = torch.from_numpy(
            np.asarray(feats, dtype=np.float32)).to(self.device)
        self._labels = None if host_labels is None \
            else torch.from_numpy(host_labels).to(self.device)
        self._i = 0

    # -- iterator protocol ----------------------------------------------
    def has_next(self):
        return self._i < len(self._features)

    def next(self):
        sl = slice(self._i, self._i + self.batch_size)
        self._i += self.batch_size
        return DataSet(NDArray(self._features[sl]),
                       None if self._labels is None
                       else NDArray(self._labels[sl]))

    def reset(self):
        self._i = 0

    def batch(self):
        return self.batch_size

    def total_examples(self):
        return len(self._features)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → [batch, features, time] DataSets with padding masks
    (reference SequenceRecordReaderDataSetIterator AlignmentMode):
    ALIGN_START (default) pads at the end; ALIGN_END right-aligns each
    sequence so its last timestep sits at index max_t-1 (for many-to-one
    setups reading the final step). Each batch is padded on the host and
    moved to ``device``."""

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 label_index: int = -1,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 align: str = "ALIGN_START",
                 device="cuda"):
        if align not in ("ALIGN_START", "ALIGN_END"):
            raise ValueError(f"align must be ALIGN_START or ALIGN_END, "
                             f"got {align!r}")
        self.device = _device(device)
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.align = align
        self._seqs: List = list(reader)
        self._i = 0

    def has_next(self):
        return self._i < len(self._seqs)

    def next(self):
        batch = self._seqs[self._i:self._i + self.batch_size]
        self._i += self.batch_size
        max_t = max(len(s) for s in batch)
        nf = len(batch[0][0]) - 1
        feats = np.zeros((len(batch), nf, max_t), np.float32)
        mask = np.zeros((len(batch), max_t), np.float32)
        li = self.label_index if self.label_index >= 0 \
            else len(batch[0][0]) + self.label_index
        if self.regression or self.num_classes is None:
            labs = np.zeros((len(batch), 1, max_t), np.float32)
        else:
            labs = np.zeros((len(batch), self.num_classes, max_t), np.float32)
        for b, seq in enumerate(batch):
            off = max_t - len(seq) if self.align == "ALIGN_END" else 0
            for t0, row in enumerate(seq):
                t = t0 + off
                vals = [to_double(v) for j, v in enumerate(row) if j != li]
                feats[b, :, t] = vals
                mask[b, t] = 1.0
                lv = to_double(row[li])
                if self.regression or self.num_classes is None:
                    labs[b, 0, t] = lv
                else:
                    labs[b, int(lv), t] = 1.0

        def put(a):
            return NDArray(torch.from_numpy(a).to(self.device))
        return DataSet(put(feats), put(labs), features_mask=put(mask),
                       labels_mask=put(mask.copy()))

    def reset(self):
        self._i = 0

    def batch(self):
        return self.batch_size
