"""Data normalizers / preprocessors.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py`` (the
reference's ``NormalizerStandardize``, ``NormalizerMinMaxScaler``,
``ImagePreProcessingScaler``, ``MultiNormalizer`` and
``NormalizerSerializer``). Statistics are fitted on the host in float64
(streaming, one pass, the Chan et al. merge) and kept as float32 numpy
arrays, as the JAX package keeps them; ``transform`` / ``revert`` run in
float32 on the device the data lies on, with the JAX package's
arithmetic, so a batch on the card stays there. ``NormalizerSerializer``
writes the JAX package's zip (``meta.json`` + ``arrays.npz``): a file
written by either package restores in the other.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import List, Optional

import numpy as np
import torch

from ..ndarray.ndarray import NDArray
from .dataset import DataSet


def _host(x) -> np.ndarray:
    """An NDArray, tensor or array as host numpy (for the statistics)."""
    if isinstance(x, NDArray):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x.torch()
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _elementwise(fn):
    """``fn`` over float32 tensors, given numpy (numpy back) or a tensor
    / NDArray (a tensor back, on its device)."""
    def apply(self, x, *args):
        if isinstance(x, np.ndarray):
            return fn(self, _tensor(x.astype(np.float32, copy=False)),
                      *args).numpy()
        return fn(self, _tensor(x).float(), *args)
    return apply


class DataNormalization:
    """fit / transform / revert protocol (reference DataNormalization)."""

    def fit(self, data):
        """data: a DataSet or a DataSetIterator."""
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        ds.features = NDArray(self.transform_array(ds.features))
        if self.fit_labels_enabled() and ds.labels is not None:
            ds.labels = NDArray(self.transform_labels(ds.labels))
        return ds

    def pre_process(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    def revert(self, ds: DataSet) -> DataSet:
        ds.features = NDArray(self.revert_array(ds.features))
        if self.fit_labels_enabled() and ds.labels is not None:
            ds.labels = NDArray(self.revert_labels(ds.labels))
        return ds

    def revert_labels(self, y):
        return y

    def transform_array(self, x):
        raise NotImplementedError

    def revert_array(self, x):
        raise NotImplementedError

    def transform_labels(self, y):
        return y

    def fit_labels_enabled(self) -> bool:
        return False

    # serde
    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, d: dict):
        raise NotImplementedError


def _iter_datasets(data):
    if isinstance(data, DataSet):
        yield data
    else:
        data.reset()
        while data.has_next():
            yield data.next()
        data.reset()


def _feature_axes(x: np.ndarray):
    """Statistics are per feature column: reduce over the batch (and the
    time axis of [b, f, t] sequence data)."""
    if x.ndim == 3:
        return (0, 2)
    return tuple(i for i in range(x.ndim) if i != 1) if x.ndim > 1 else (0,)


def _stat(stat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """A per-column statistic shaped to broadcast over ``x`` (column axis
    1), on ``x``'s device."""
    t = torch.from_numpy(np.asarray(stat, np.float32)).to(x.device)
    if x.dim() <= 1:
        return t
    shape = [1] * x.dim()
    shape[1] = -1
    return t.reshape(shape)


class NormalizerStandardize(DataNormalization):
    """Z-score per feature column (reference NormalizerStandardize.java),
    fitted in one streaming pass."""

    def __init__(self, fit_label: bool = False):
        self._fit_label = fit_label
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None

    def fit_labels_enabled(self):
        return self._fit_label

    @staticmethod
    def _streaming_stats(arrays):
        n = 0
        mean = m2 = None
        for x in arrays:
            x = np.asarray(x, np.float64)
            ax = _feature_axes(x)
            cnt = int(np.prod([x.shape[a] for a in ax])) if x.ndim > 1 \
                else x.shape[0]
            bm = x.mean(axis=ax)
            bv = x.var(axis=ax)
            if mean is None:
                n, mean, m2 = cnt, bm, bv * cnt
            else:
                delta = bm - mean
                tot = n + cnt
                mean = mean + delta * (cnt / tot)
                m2 = m2 + bv * cnt + delta ** 2 * (n * cnt / tot)
                n = tot
        std = np.sqrt(m2 / n)
        std[std == 0] = 1.0
        return mean.astype(np.float32), std.astype(np.float32)

    def fit(self, data):
        feats, labs = [], []
        for ds in _iter_datasets(data):
            feats.append(_host(ds.features))
            if self._fit_label and ds.labels is not None:
                labs.append(_host(ds.labels))
        self.mean, self.std = self._streaming_stats(feats)
        if labs:
            self.label_mean, self.label_std = self._streaming_stats(labs)
        return self

    @_elementwise
    def transform_array(self, x):
        return (x - _stat(self.mean, x)) / _stat(self.std, x)

    @_elementwise
    def revert_array(self, x):
        return x * _stat(self.std, x) + _stat(self.mean, x)

    @_elementwise
    def _label_op(self, t, revert):
        m, s = _stat(self.label_mean, t), _stat(self.label_std, t)
        return t * s + m if revert else (t - m) / s

    def transform_labels(self, y):
        if self.label_mean is None:
            return y
        return self._label_op(y, False)

    def revert_labels(self, y):
        if self.label_mean is None:
            return y
        return self._label_op(y, True)

    def state_dict(self):
        return {"type": "NormalizerStandardize",
                "fit_label": self._fit_label,
                "mean": self.mean, "std": self.std,
                "label_mean": self.label_mean, "label_std": self.label_std}

    def load_state_dict(self, d):
        self._fit_label = d["fit_label"]
        self.mean, self.std = d["mean"], d["std"]
        self.label_mean, self.label_std = d["label_mean"], d["label_std"]


class NormalizerMinMaxScaler(DataNormalization):
    """Scale each feature column into [min_range, max_range]
    (reference NormalizerMinMaxScaler.java)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range, self.max_range = float(min_range), float(max_range)
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, data):
        lo = hi = None
        for ds in _iter_datasets(data):
            x = _host(ds.features)
            ax = _feature_axes(x)
            bl, bh = x.min(axis=ax), x.max(axis=ax)
            lo = bl if lo is None else np.minimum(lo, bl)
            hi = bh if hi is None else np.maximum(hi, bh)
        self.data_min, self.data_max = lo, hi
        return self

    def _scale(self):
        rng = self.data_max - self.data_min
        rng[rng == 0] = 1.0
        return rng

    @_elementwise
    def transform_array(self, x):
        z = (x - _stat(self.data_min, x)) / _stat(self._scale(), x)
        return z * (self.max_range - self.min_range) + self.min_range

    @_elementwise
    def revert_array(self, x):
        z = (x - self.min_range) / (self.max_range - self.min_range)
        return z * _stat(self._scale(), x) + _stat(self.data_min, x)

    def state_dict(self):
        return {"type": "NormalizerMinMaxScaler",
                "min_range": self.min_range, "max_range": self.max_range,
                "data_min": self.data_min, "data_max": self.data_max}

    def load_state_dict(self, d):
        self.min_range, self.max_range = d["min_range"], d["max_range"]
        self.data_min, self.data_max = d["data_min"], d["data_max"]


class ImagePreProcessingScaler(DataNormalization):
    """Pixel [0, 2^bits-1] -> [a, b] (reference
    ImagePreProcessingScaler.java). Stateless: fit does nothing."""

    def __init__(self, a: float = 0.0, b: float = 1.0, max_bits: int = 8):
        self.a, self.b = float(a), float(b)
        self.max_pixel = float(2 ** max_bits - 1)

    def fit(self, data):
        return self

    @_elementwise
    def transform_array(self, x):
        return x / self.max_pixel * (self.b - self.a) + self.a

    @_elementwise
    def revert_array(self, x):
        return (x - self.a) / (self.b - self.a) * self.max_pixel

    def state_dict(self):
        return {"type": "ImagePreProcessingScaler", "a": self.a, "b": self.b,
                "max_pixel": self.max_pixel}

    def load_state_dict(self, d):
        self.a, self.b, self.max_pixel = d["a"], d["b"], d["max_pixel"]


class MultiNormalizer:
    """Per-input normalizers for a MultiDataSet (reference
    MultiNormalizer / MultiDataNormalization)."""

    def __init__(self, feature_normalizers: List[DataNormalization]):
        self.feature_normalizers = feature_normalizers

    def fit(self, mds_iter):
        from .dataset import MultiDataSet
        from .iterators import ListDataSetIterator
        buf = [[] for _ in self.feature_normalizers]
        items = [mds_iter] if isinstance(mds_iter, MultiDataSet) else mds_iter
        for mds in items:
            for i, f in enumerate(mds.features):
                buf[i].append(DataSet(f, None))
        for i, norm in enumerate(self.feature_normalizers):
            norm.fit(ListDataSetIterator(buf[i]))
        return self

    def transform(self, mds):
        for i, norm in enumerate(self.feature_normalizers):
            mds.features[i] = NDArray(norm.transform_array(mds.features[i]))
        return mds


_NORMALIZER_TYPES = {
    "NormalizerStandardize": NormalizerStandardize,
    "NormalizerMinMaxScaler": NormalizerMinMaxScaler,
    "ImagePreProcessingScaler": ImagePreProcessingScaler,
}


class NormalizerSerializer:
    """Save / restore a normalizer's state (reference
    ``NormalizerSerializer.java``): a zip of ``meta.json`` and
    ``arrays.npz``, the JAX package's layout."""

    @staticmethod
    def write(normalizer: DataNormalization, path: str):
        state = normalizer.state_dict()
        arrays = {k: v for k, v in state.items()
                  if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in state.items()
                if not isinstance(v, np.ndarray)}
        meta["__array_keys__"] = sorted(arrays)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("meta.json", json.dumps(meta))
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            z.writestr("arrays.npz", buf.getvalue())

    @staticmethod
    def restore(path: str) -> DataNormalization:
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            npz = np.load(io.BytesIO(z.read("arrays.npz")))
            state = {k: v for k, v in meta.items()
                     if k != "__array_keys__"}
            for k in meta["__array_keys__"]:
                state[k] = npz[k]
        cls = _NORMALIZER_TYPES[state.pop("type")]
        obj = cls()
        for k in ("mean", "std", "label_mean", "label_std", "data_min",
                  "data_max"):
            if hasattr(obj, k):
                state.setdefault(k, None)
        obj.load_state_dict(state)
        return obj
