"""Dataset fetchers + ready-made iterators (MNIST / EMNIST / CIFAR-10 / Iris
/ Digits).

Counterpart of ``deeplearning4j_tpu/datasets/fetchers.py`` (the
reference's ``MnistDataFetcher``, ``EmnistDataFetcher``,
``Cifar10Fetcher`` and the iterator wrappers). The fetchers read a local
cache only (``$DL4J_TPU_DATA`` or ``~/.deeplearning4j_tpu/<name>/``) and
raise ``FileNotFoundError`` when the files are absent: nothing is
downloaded. Iris and the 8x8 Digits set come from scikit-learn's bundled
copies, imported when such an iterator is constructed. ``parse_idx`` is
the numpy reader; the JAX package's native decoder waits for ``native/``
(``ROADMAP.md`` queue 1 item 11).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

from .iterators import ArrayDataSetIterator


def _data_root() -> str:
    return os.environ.get(
        "DL4J_TPU_DATA",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _find(name: str, *candidates: str) -> str:
    base = os.path.join(_data_root(), name)
    for c in candidates:
        p = os.path.join(base, c)
        if os.path.exists(p) or os.path.exists(p + ".gz"):
            return p
    raise FileNotFoundError(
        f"{name} artifacts not found under {base} (looked for "
        f"{candidates}); this environment has no network egress — place the "
        f"files there manually, or use DigitsDataSetIterator / "
        f"IrisDataSetIterator which ship offline")


def parse_idx(path: str) -> np.ndarray:
    """Parse an IDX-format file (the MNIST container format), plain or
    gzipped."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        data = np.frombuffer(f.read(), dtype=np.dtype(
            dtypes[dtype_code]).newbyteorder(">"))
        return data.reshape(dims)


class MnistDataFetcher:
    """Reads idx files from the local cache (reference MnistDataFetcher)."""

    NUM_EXAMPLES = 60000
    NUM_EXAMPLES_TEST = 10000

    def __init__(self, train: bool = True, dataset: str = "mnist",
                 prefix: Optional[str] = None):
        self.dataset = dataset
        pre = prefix or ("train" if train else "t10k")
        self.images_path = _find(dataset, f"{pre}-images-idx3-ubyte",
                                 f"{pre}-images.idx3-ubyte")
        self.labels_path = _find(dataset, f"{pre}-labels-idx1-ubyte",
                                 f"{pre}-labels.idx1-ubyte")

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        images = parse_idx(self.images_path).astype(np.float32)
        labels = parse_idx(self.labels_path).astype(np.int64)
        return images.reshape(len(images), -1), labels


class EmnistDataFetcher(MnistDataFetcher):
    """EMNIST subsets (reference EmnistDataFetcher): files named
    emnist-<subset>-train-images-idx3-ubyte etc."""

    def __init__(self, subset: str = "balanced", train: bool = True):
        split = "train" if train else "test"
        super().__init__(train=train, dataset="emnist",
                         prefix=f"emnist-{subset}-{split}")


class Cifar10Fetcher:
    """CIFAR-10 python-pickle batches (reference Cifar10Fetcher)."""

    def __init__(self, train: bool = True):
        base = os.path.join(_data_root(), "cifar10", "cifar-10-batches-py")
        names = [f"data_batch_{i}" for i in range(1, 6)] if train \
            else ["test_batch"]
        self.paths = [os.path.join(base, n) for n in names]
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"CIFAR-10 batch missing: {p} (no network egress; place "
                    f"cifar-10-batches-py there manually)")

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for p in self.paths:
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.float32))
            ys.append(np.asarray(d[b"labels"], np.int64))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32)
        return x, np.concatenate(ys)


from .dataset import one_hot_labels as _one_hot  # noqa: E402


class MnistDataSetIterator(ArrayDataSetIterator):
    """Reference `iterator/impl/MnistDataSetIterator.java`: flattened 784-dim
    features in [0,1] + one-hot labels."""

    def __init__(self, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 123,
                 binarize: bool = False):
        x, y = MnistDataFetcher(train=train).fetch()
        x = x / 255.0
        if binarize:
            x = (x > 0.5).astype(np.float32)
        super().__init__(x.astype(np.float32), _one_hot(y, 10), batch_size,
                         shuffle=shuffle, seed=seed)


class EmnistDataSetIterator(ArrayDataSetIterator):
    _NUM_LABELS = {"balanced": 47, "byclass": 62, "bymerge": 47,
                   "digits": 10, "letters": 26, "mnist": 10}

    def __init__(self, subset: str, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 123):
        x, y = EmnistDataFetcher(subset=subset, train=train).fetch()
        n = self._NUM_LABELS[subset]
        if subset == "letters":  # 1-indexed labels
            y = y - y.min()
        super().__init__((x / 255.0).astype(np.float32), _one_hot(y, n),
                         batch_size, shuffle=shuffle, seed=seed)


class Cifar10DataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 123):
        x, y = Cifar10Fetcher(train=train).fetch()
        super().__init__((x / 255.0).astype(np.float32), _one_hot(y, 10),
                         batch_size, shuffle=shuffle, seed=seed)


class IrisDataSetIterator(ArrayDataSetIterator):
    """Reference `iterator/impl/IrisDataSetIterator.java` — the classic 150
    x 4 dataset, bundled offline (scikit-learn ships the CSV)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 shuffle: bool = False, seed: int = 123):
        from sklearn.datasets import load_iris
        d = load_iris()
        x = np.asarray(d.data[:num_examples], np.float32)
        y = _one_hot(np.asarray(d.target[:num_examples]), 3)
        super().__init__(x, y, batch_size, shuffle=shuffle, seed=seed)


class DigitsDataSetIterator(ArrayDataSetIterator):
    """8x8 handwritten digits (1797 samples, bundled offline via
    scikit-learn) — the real-data stand-in for MNIST end-to-end tests in
    the no-egress environment. Features scaled to [0,1], optionally shaped
    [b, 1, 8, 8] for CNN input."""

    def __init__(self, batch_size: int, train: bool = True,
                 as_image: bool = False, shuffle: bool = True,
                 seed: int = 123, train_fraction: float = 0.8):
        from sklearn.datasets import load_digits
        d = load_digits()
        x = np.asarray(d.data, np.float32) / 16.0
        y = np.asarray(d.target)
        n_train = int(len(x) * train_fraction)
        rng = np.random.RandomState(42)
        perm = rng.permutation(len(x))
        idx = perm[:n_train] if train else perm[n_train:]
        x, y = x[idx], y[idx]
        if as_image:
            x = x.reshape(-1, 1, 8, 8)
        super().__init__(x, _one_hot(y, 10), batch_size,
                         shuffle=shuffle, seed=seed)
