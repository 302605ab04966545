"""DataSetIterator implementations.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py`` (the
reference's DataSetIterator API): ``ListDataSetIterator``,
``ArrayDataSetIterator``, ``AsyncDataSetIterator``, whose worker
thread copies each batch to the device (``device=``, the card by
default) while the consumer trains on the previous one, and
``BenchmarkDataSetIterator``, one fixed synthetic batch on the device,
and ``NativeBatchDataSetIterator``, whose batches the C++ ring of
``native/`` gathers into pinned host memory and copies to the card.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..ndarray.ndarray import NDArray
from .dataset import DataSet


class DataSetIterator:
    """Base iterator protocol (reference DataSetIterator interface)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    def batch(self) -> int:
        return -1

    def async_supported(self) -> bool:
        return True


class ListDataSetIterator(DataSetIterator):
    def __init__(self, datasets: Sequence[DataSet], batch_size: int = None):
        self._list = list(datasets)
        self._i = 0
        self._batch = batch_size or (self._list[0].num_examples()
                                     if self._list else 0)

    def has_next(self):
        return self._i < len(self._list)

    def next(self):
        ds = self._list[self._i]
        self._i += 1
        return ds

    def reset(self):
        self._i = 0

    def batch(self):
        return self._batch


class ArrayDataSetIterator(DataSetIterator):
    """Batches a single (features, labels) pair (TestDataSetIterator analog)."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False,
                 seed: int = 123):
        self.features = NDArray(features).torch()
        self.labels = NDArray(labels).torch()
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._order = None
        self._i = 0
        self.reset()

    def reset(self):
        n = self.features.shape[0]
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            self._order = rng.permutation(n)
            self._epoch += 1
        else:
            self._order = np.arange(n)
        self._i = 0

    def has_next(self):
        return self._i < len(self._order)

    def next(self):
        # the final batch may be partial (reference iterator behavior)
        idx = self._order[self._i:self._i + self.batch_size]
        self._i += len(idx)
        t = torch.as_tensor(idx, device=self.features.device)
        return DataSet(NDArray(self.features[t]),
                       NDArray(self.labels[t.to(self.labels.device)]))

    def batch(self):
        return self.batch_size


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch wrapper (reference AsyncDataSetIterator).

    A worker thread pulls from the underlying iterator and copies each
    batch to ``device`` into a bounded queue, so the host's preparation
    and the host-to-device copy overlap the consumer's compute. Pinned
    host tensors copy without blocking the worker. A failure in the
    worker (a device torch cannot use, a broken source) is raised to the
    consumer after the batches placed before it.
    """

    def __init__(self, underlying: DataSetIterator, queue_size: int = 2,
                 device="cuda"):
        self.underlying = underlying
        self.queue_size = queue_size
        self.device = torch.device(device)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._done = object()
        self._start()

    def _place(self, a: NDArray) -> NDArray:
        t = a.torch()
        return NDArray(t.to(self.device, non_blocking=t.is_pinned()))

    def _start(self):
        def worker():
            try:
                self.underlying.reset()
                while self.underlying.has_next():
                    ds = self.underlying.next()
                    labs = (self._place(ds.labels)
                            if ds.labels is not None else None)
                    self._queue.put(DataSet(self._place(ds.features), labs))
            except Exception as e:  # raised to the consumer by has_next
                self._error = e
            finally:
                self._queue.put(self._done)

        self._error = None
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._head = None
        self._exhausted = False
        self._consumed = False
        self._advance()

    def _advance(self):
        item = self._queue.get()
        if item is self._done:
            self._head = None
            self._exhausted = True
        else:
            self._head = item

    def has_next(self):
        if self._exhausted and self._error is not None:
            raise RuntimeError("AsyncDataSetIterator: the prefetch worker "
                               "failed") from self._error
        return not self._exhausted

    def next(self):
        ds = self._head
        self._consumed = True
        self._advance()
        return ds

    def reset(self):
        if not self._consumed and not self._exhausted:
            return  # fresh prefetch pass, nothing consumed — keep it
        if self._thread is not None and self._thread.is_alive():
            # drain remaining items so the worker can exit
            while not self._exhausted:
                self._advance()
            self._thread.join()
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._start()

    def batch(self):
        return self.underlying.batch()


class BenchmarkDataSetIterator(DataSetIterator):
    """One fixed synthetic batch, ``num_batches`` times, on ``device`` (the
    card by default): isolates model throughput from the data pipeline
    (reference ``BenchmarkDataSetIterator.java``).

    Features are ``randn`` from the array factory's generator seeded with
    ``seed`` (Philox, not the JAX package's values); the labels come from
    ``np.random.RandomState(seed)``, so they equal the JAX package's."""

    def __init__(self, feature_shape, num_classes: int, num_batches: int,
                 dtype="float32", seed: int = 42, device="cuda"):
        from ..ndarray import factory as nd
        from ..nn.multilayer import resolve_device
        dev = resolve_device(device)
        nd.set_seed(seed)
        self._features = NDArray(nd.randn(*feature_shape,
                                          dtype=dtype).torch().to(dev))
        labels_idx = np.random.RandomState(seed).randint(
            0, num_classes, feature_shape[0])
        self._labels = NDArray(nd.one_hot(labels_idx,
                                          num_classes).torch().to(dev))
        self.num_batches = num_batches
        self._i = 0

    def has_next(self):
        return self._i < self.num_batches

    def next(self):
        self._i += 1
        return DataSet(self._features, self._labels)

    def reset(self):
        self._i = 0

    def batch(self):
        return self._features.shape[0]


class NativeBatchDataSetIterator(DataSetIterator):
    """Minibatch iterator backed by the C++ batch-assembler ring
    (``native.NativeBatchIterator``): shuffling and gather-copies happen on
    a native thread outside the GIL while the previous step runs on the
    device — the AsyncDataSetIterator role with native workers (reference
    AsyncDataSetIterator + DataVec local executor threads). The same seed
    gives the JAX package's batches bit for bit: epoch ``e`` of the ring
    shuffles with ``seed + e``, and every ``reset()`` (``fit`` calls it,
    and so does ``iter()``) starts the next epoch.

    On ``device`` (the card by default) the ring writes each batch into a
    pinned host tensor fresh from torch's caching host allocator, which is
    copied to the card with ``non_blocking=True`` on the consumer's current
    stream. The allocator records an event on that stream for the block
    and hands it out again only once the copy has finished, so a pinned
    buffer is never rewritten while its copy is in flight, and no second
    stream is needed. On the CPU the batch is the host tensor itself.
    ``blocked_s`` adds up the seconds ``next()`` waited for the ring."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = True, seed: int = 0, n_slots: int = 4,
                 drop_last=None, device="cuda"):
        from ..nn.multilayer import resolve_device
        self.device = resolve_device(device)
        self._x = _host_f32(features)
        self._y = _host_f32(labels)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.n_slots = n_slots
        #: True (default): every batch has exactly ``batch_size`` rows —
        #: required by a captured step, whose graph holds one batch shape
        #: (a ragged last batch is a new signature and a new capture).
        #: Pass False to opt into the reference DataSetIterator contract,
        #: which emits a trailing partial batch.
        defaulted = drop_last is None
        self.drop_last = True if defaulted else drop_last
        if (defaulted and self.drop_last
                and self._x.shape[0] >= self.batch_size
                and self._x.shape[0] % self.batch_size != 0):
            warnings.warn(
                f"NativeBatchIterator: {self._x.shape[0] % self.batch_size} "
                f"trailing rows (of {self._x.shape[0]}) are dropped per "
                f"epoch under the drop_last=True default (differs from the "
                f"reference DataSetIterator contract); pass drop_last=False "
                f"to keep the partial batch, or drop_last=True to silence",
                stacklevel=2)
        if self.drop_last and self._x.shape[0] < self.batch_size:
            raise ValueError(
                f"dataset has {self._x.shape[0]} rows < batch_size="
                f"{self.batch_size}: with drop_last=True (the default) the "
                f"iterator would yield zero batches; lower batch_size or "
                f"pass drop_last=False")
        self.blocked_s = 0.0
        self._epoch = 0
        self._it = None
        self.reset()

    def reset(self):
        from .. import native
        if self._it is not None:
            self._it.close()
        self._it = native.NativeBatchIterator(
            self._x, self._y, self.batch_size, shuffle=self.shuffle,
            seed=self.seed + self._epoch, num_epochs=1,
            n_slots=self.n_slots, drop_last=self.drop_last)
        self._epoch += 1

    def __next__(self) -> DataSet:
        if self._it is None:
            raise StopIteration
        pin = self.device.type == "cuda"
        bx = torch.empty((self.batch_size,) + self._x.shape[1:],
                         dtype=torch.float32, pin_memory=pin)
        by = torch.empty((self.batch_size,) + self._y.shape[1:],
                         dtype=torch.float32, pin_memory=pin)
        t0 = time.perf_counter()
        rows = self._it.next_into(bx, by)
        self.blocked_s += time.perf_counter() - t0
        if not rows:
            raise StopIteration
        x, y = bx[:rows], by[:rows]
        if pin:
            x = x.to(self.device, non_blocking=True)
            y = y.to(self.device, non_blocking=True)
        return DataSet(x, y)

    def close(self):
        if self._it is not None:
            self._it.close()
            self._it = None


def _host_f32(a) -> np.ndarray:
    """``a`` (numpy, an ``NDArray`` or a tensor on any device) as a float32
    numpy array on the host."""
    if isinstance(a, NDArray):
        a = a.torch()
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)
