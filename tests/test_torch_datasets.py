"""The port's ``datasets/`` against the JAX package's:
``BenchmarkDataSetIterator``, the normalizers and ``NormalizerSerializer``
(files read both ways), the fetchers' local-cache reads and
``parse_idx``, and the Iris and Digits iterators.

Tolerances, each with its reason:
- normalizer statistics: both fit in float64 on the host from the same
  float32 data and keep float32; equal to atol 1e-6 on O(1) values
  (``STAT``), the summation order of the two numpy calls being the same;
- transforms and reverts: float32 elementwise arithmetic on both sides,
  atol 1e-6 (``STAT``).
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.datasets import iterators as jit
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS

from deeplearning4j_tpu_torch import datasets as tds
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from deeplearning4j_tpu_torch.datasets import normalizers as tnorm
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet as TMDS

STAT = 1e-6


def test_benchmark_iterator_labels_match_jax():
    j = jit.BenchmarkDataSetIterator((12, 3, 4, 4), 5, 3, seed=9)
    t = tds.BenchmarkDataSetIterator((12, 3, 4, 4), 5, 3, seed=9,
                                     device="cpu")
    assert t.batch() == j.batch() == 12
    jb = [j.next() for _ in range(3)]
    tb = []
    while t.has_next():
        tb.append(t.next())
    assert len(tb) == 3 and not j.has_next()
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.labels.numpy(),
                                      np.asarray(b.labels.jax()))
        assert a.features.shape == tuple(b.features.shape)
        assert a.features.torch().dtype == torch.float32
    assert torch.equal(tb[0].features.torch(), tb[2].features.torch())
    t.reset()
    assert t.has_next()
    again = tds.BenchmarkDataSetIterator((12, 3, 4, 4), 5, 1, seed=9,
                                         device="cpu").next()
    assert torch.equal(again.features.torch(), tb[0].features.torch())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tds.BenchmarkDataSetIterator((2, 2), 2, 1)


# -- normalizers --------------------------------------------------------

def _batches(shape, n=3, seed=0, scale=3.0, shift=2.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape).astype(np.float32) * scale + shift,
             rng.randn(shape[0], 2).astype(np.float32) * 5 - 1)
            for _ in range(n)]


NORMS = [
    ("NormalizerStandardize", {}),
    ("NormalizerStandardize", {"fit_label": True}),
    ("NormalizerMinMaxScaler", {"min_range": -1.0, "max_range": 2.0}),
    ("ImagePreProcessingScaler", {"a": 0.0, "b": 1.0, "max_bits": 8}),
]
SHAPES = [(7, 3), (5, 3, 4), (4, 2, 3, 3)]


def _fit_pair(name, kw, data):
    j = getattr(jnorm, name)(**kw).fit(
        jit.ListDataSetIterator([JDataSet(x, y) for x, y in data]))
    t = getattr(tnorm, name)(**kw).fit(
        tds.ListDataSetIterator([TDataSet(x, y) for x, y in data]))
    return j, t


def _state_close(ts, js):
    assert sorted(ts) == sorted(js)
    for k, v in js.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(ts[k], v, atol=STAT, err_msg=k)
            assert ts[k].dtype == v.dtype
        else:
            assert ts[k] == v, k


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,kw", NORMS, ids=lambda v: str(v))
def test_normalizer_stats_transform_revert_match_jax(name, kw, shape):
    data = _batches(shape)
    j, t = _fit_pair(name, kw, data)
    _state_close(t.state_dict(), j.state_dict())
    x, y = _batches(shape, n=1, seed=5)[0]
    jd, td = j.transform(JDataSet(x, y)), t.transform(TDataSet(x, y))
    np.testing.assert_allclose(td.features.numpy(),
                               np.asarray(jd.features.jax()), atol=STAT)
    np.testing.assert_allclose(td.labels.numpy(),
                               np.asarray(jd.labels.jax()), atol=STAT)
    jr, tr = j.revert(jd), t.revert(td)
    np.testing.assert_allclose(tr.features.numpy(),
                               np.asarray(jr.features.jax()), atol=1e-5)
    np.testing.assert_allclose(tr.features.numpy(), x, atol=1e-4)
    # arrays in, arrays out (numpy for numpy, a tensor for a tensor)
    np.testing.assert_allclose(t.transform_array(x), j.transform_array(x),
                               atol=STAT)
    assert isinstance(t.transform_array(torch.from_numpy(x)), torch.Tensor)


@pytest.mark.parametrize("name,kw", NORMS, ids=lambda v: str(v))
def test_normalizer_files_read_both_ways(tmp_path, name, kw):
    data = _batches((6, 3))
    j, t = _fit_pair(name, kw, data)
    tnorm.NormalizerSerializer.write(t, str(tmp_path / "t.zip"))
    jnorm.NormalizerSerializer.write(j, str(tmp_path / "j.zip"))
    from_t = jnorm.NormalizerSerializer.restore(str(tmp_path / "t.zip"))
    from_j = tnorm.NormalizerSerializer.restore(str(tmp_path / "j.zip"))
    assert type(from_t).__name__ == type(from_j).__name__ == name
    _state_close(from_j.state_dict(), j.state_dict())
    _state_close(t.state_dict(), from_t.state_dict())
    x = data[0][0]
    np.testing.assert_allclose(from_j.transform_array(x),
                               from_t.transform_array(x), atol=STAT)


def test_normalizer_on_a_dataset_keeps_its_device_and_fits_a_dataset():
    x, y = _batches((6, 3), n=1)[0]
    t = tnorm.NormalizerStandardize().fit(TDataSet(x, y))
    j = jnorm.NormalizerStandardize().fit(JDataSet(x, y))
    _state_close(t.state_dict(), j.state_dict())
    out = t.transform(TDataSet(torch.from_numpy(x), y))
    assert out.features.torch().device.type == "cpu"
    np.testing.assert_allclose(out.features.numpy().mean(0), 0, atol=1e-5)


def test_multi_normalizer_matches_jax():
    rng = np.random.RandomState(3)
    feats = [[rng.randn(5, 3).astype(np.float32) * 2 + 1,
              rng.rand(5, 4).astype(np.float32) * 9] for _ in range(2)]
    j = jnorm.MultiNormalizer([jnorm.NormalizerStandardize(),
                               jnorm.NormalizerMinMaxScaler()])
    t = tnorm.MultiNormalizer([tnorm.NormalizerStandardize(),
                               tnorm.NormalizerMinMaxScaler()])
    j.fit([JMDS(f, []) for f in feats])
    t.fit([TMDS(f, []) for f in feats])
    for a, b in zip(t.feature_normalizers, j.feature_normalizers):
        _state_close(a.state_dict(), b.state_dict())
    tm, jm = t.transform(TMDS(feats[0], [])), j.transform(JMDS(feats[0], []))
    for a, b in zip(tm.features, jm.features):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.jax()), atol=STAT)


# -- fetchers -----------------------------------------------------------

def _write_idx(path, arr, gz=False):
    codes = {np.uint8: 0x08, np.int32: 0x0C, np.float32: 0x0D}
    head = struct.pack(">I", (codes[arr.dtype.type] << 8) | arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    body = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(body)


@pytest.mark.parametrize("dtype,gz", [(np.uint8, False), (np.uint8, True),
                                      (np.int32, False), (np.float32, True)])
def test_parse_idx_matches_jax(tmp_path, dtype, gz):
    arr = (np.arange(24).reshape(2, 3, 4) * 3).astype(dtype)
    path = str(tmp_path / "a-idx3-ubyte")
    _write_idx(path + (".gz" if gz else ""), arr, gz)
    got = tfetch.parse_idx(path)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jfetch.parse_idx(path))


def test_fetchers_read_the_local_cache_and_raise_without_it(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path))
    for mod in (tfetch, jfetch):
        with pytest.raises(FileNotFoundError, match="no network"):
            mod.MnistDataFetcher()
        with pytest.raises(FileNotFoundError):
            mod.Cifar10Fetcher()
        with pytest.raises(FileNotFoundError):
            mod.EmnistDataFetcher("letters")
    d = tmp_path / "mnist"
    d.mkdir()
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (10, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, 10).astype(np.uint8)
    _write_idx(str(d / "train-images-idx3-ubyte"), imgs)
    _write_idx(str(d / "train-labels-idx1-ubyte.gz"), labs, gz=True)
    tx, ty = tfetch.MnistDataFetcher().fetch()
    jx, jy = jfetch.MnistDataFetcher().fetch()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    it = tfetch.MnistDataSetIterator(4, shuffle=False, binarize=True)
    b = it.next()
    assert b.features.shape == (4, 784) and b.labels.shape == (4, 10)
    jb = jfetch.MnistDataSetIterator(4, shuffle=False, binarize=True).next()
    np.testing.assert_array_equal(b.features.numpy(),
                                  np.asarray(jb.features.jax()))


@pytest.mark.parametrize("cls,kw", [
    ("IrisDataSetIterator", {"batch_size": 50}),
    ("IrisDataSetIterator", {"batch_size": 32, "num_examples": 100,
                             "shuffle": True, "seed": 4}),
    ("DigitsDataSetIterator", {"batch_size": 64, "train": False}),
    ("DigitsDataSetIterator", {"batch_size": 128, "as_image": True,
                               "seed": 7}),
])
def test_iris_and_digits_match_jax(cls, kw):
    t = getattr(tfetch, cls)(**kw)
    j = getattr(jfetch, cls)(**kw)
    n = 0
    while j.has_next():
        a, b = t.next(), j.next()
        np.testing.assert_array_equal(a.features.numpy(),
                                      np.asarray(b.features.jax()))
        np.testing.assert_array_equal(a.labels.numpy(),
                                      np.asarray(b.labels.jax()))
        n += 1
    assert n > 0 and not t.has_next()


def test_cifar10_reads_pickled_batches(tmp_path, monkeypatch):
    import pickle
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path))
    base = tmp_path / "cifar10" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.RandomState(1)
    with open(base / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (4, 3072)),
                     b"labels": [1, 2, 3, 4]}, f)
    tx, ty = tfetch.Cifar10Fetcher(train=False).fetch()
    jx, jy = jfetch.Cifar10Fetcher(train=False).fetch()
    assert tx.shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert os.path.exists(base / "test_batch")
