"""The port's ``native/`` (its own copy of the C++ host-IO library, built
with ``g++`` at first use) against the JAX package's, on the same files
and arrays: ``read_csv``, ``read_idx``, the batch ring, the
``NativeBatchDataSetIterator`` over it and ``fetchers.parse_idx``'s
native route.

Both libraries are built here by the same ``g++`` with the same flags,
so the ring's shuffle (``std::uniform_int_distribution`` over
``std::mt19937_64``) draws the same order: batches are held bit for bit.
The parsers are held exactly too (the same ``strtof`` on both sides, and
numpy's ``loadtxt`` rounds the same decimal strings to the same float32).
"""
import os
import struct
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.datasets import iterators as jiters
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from deeplearning4j_tpu_torch.datasets import iterators as titers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _both_libraries():
    if not (tnative.available() and jnative.available()):
        pytest.skip(f"g++ cannot build the library: {tnative.build_error()}"
                    f" / {jnative.build_error()}")


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 8, arr.ndim]))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


CSVS = {
    "plain": ("1.5,2,3\n-4,5.25,6e2\n7,8,9\n", {}),
    "header": ("a,b\n1,2\n3,4", {"skip_lines": 1}),
    "semicolon_crlf": ("1;2\r\n\r\n3;-0.5\r\n", {"delimiter": ";"}),
}


@pytest.mark.parametrize("name", sorted(CSVS) + ["random"])
def test_read_csv_matches_jax_and_numpy(name, tmp_path):
    p = str(tmp_path / "d.csv")
    kw = {}
    if name == "random":
        arr = np.random.RandomState(0).randn(50, 7).astype(np.float32)
        np.savetxt(p, arr, delimiter=",", fmt="%.6g")
    else:
        text, kw = CSVS[name]
        with open(p, "w", newline="") as f:
            f.write(text)
    got = tnative.read_csv(p, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.read_csv(p, **kw))
    if name != "semicolon_crlf":   # loadtxt reads the blank CRLF line apart
        np.testing.assert_array_equal(got, np.loadtxt(
            p, delimiter=kw.get("delimiter", ","),
            skiprows=kw.get("skip_lines", 0), dtype=np.float32, ndmin=2))


@pytest.mark.parametrize("shape", [(5,), (5, 4, 4), (3, 2, 4, 4)])
@pytest.mark.parametrize("normalize", [False, True])
def test_read_idx_matches_jax_and_numpy(shape, normalize, tmp_path):
    arr = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    p = str(tmp_path / "a.idx")
    _write_idx(p, arr)
    got = tnative.read_idx(p, normalize=normalize)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, jnative.read_idx(p, normalize))
    ref = arr.astype(np.float32) * (np.float32(1 / 255) if normalize else 1)
    np.testing.assert_array_equal(got, ref)
    if not normalize:
        np.testing.assert_array_equal(got, tnative._read_idx_py(p, False))


@pytest.mark.parametrize("gz", [False, True])
def test_parse_idx_takes_the_native_route_as_jax(gz, tmp_path):
    arr = np.random.RandomState(2).randint(0, 256, (6, 3, 3)).astype(np.uint8)
    p = str(tmp_path / "imgs-idx3-ubyte")
    _write_idx(p, arr)
    if gz:
        import gzip
        with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
            g.write(f.read())
        os.remove(p)
    got, want = tfetch.parse_idx(p), jfetch.parse_idx(p)
    # plain u8: the native decoder's float32; gzipped: numpy's u8
    assert got.dtype == want.dtype == (np.uint8 if gz else np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


RINGS = {
    # (n, x trailing shape, y width or None, batch, shuffle, epochs,
    #  drop_last, n_slots)
    "shuffled": (64, (5,), 3, 8, True, 1, False, 4),
    "partial": (22, (1,), None, 8, False, 1, False, 4),
    "partial_shuffled": (22, (2,), 2, 8, True, 2, False, 2),
    "drop_last": (22, (1,), 4, 8, True, 3, True, 4),
    "conv": (12, (1, 4, 4), 2, 4, True, 1, False, 1),
}


def _ring_batches(native, case, seed):
    n, xs, yw, b, shuffle, epochs, drop, slots = RINGS[case]
    rs = np.random.RandomState(3)
    x = rs.randn(n, *xs).astype(np.float32)
    y = None if yw is None else rs.randn(n, yw).astype(np.float32)
    it = native.NativeBatchIterator(x, y, batch_size=b, shuffle=shuffle,
                                    seed=seed, num_epochs=epochs,
                                    n_slots=slots, drop_last=drop)
    return list(it), x, y


@pytest.mark.parametrize("case", sorted(RINGS))
def test_ring_gives_the_jax_batches_bit_for_bit(case):
    got, x, y = _ring_batches(tnative, case, seed=7)
    want, _, _ = _ring_batches(jnative, case, seed=7)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == wx.shape and gx.dtype == np.float32
        assert gx.tobytes() == wx.tobytes()
        assert (gy is None) == (wy is None)
        if gy is not None:
            assert gy.tobytes() == wy.tobytes()
    n, _, _, b, shuffle, epochs, drop, _ = RINGS[case]
    per_epoch = n // b if drop else -(-n // b)
    assert len(got) == per_epoch * epochs
    # every row once an epoch, features paired with their labels
    first = np.concatenate([gx for gx, _ in got[:per_epoch]])
    rows = [int(np.argmin(np.abs(x.reshape(n, -1) - r.reshape(1, -1))
                          .sum(axis=1))) for r in first]
    assert len(set(rows)) == len(rows) == (b * per_epoch if drop else n)
    if y is not None:
        labels = np.concatenate([gy for _, gy in got[:per_epoch]])
        np.testing.assert_array_equal(labels, y[rows])
    assert (rows != sorted(rows)) == shuffle


def test_ring_next_into_checks_the_buffer():
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    for kw in ({"labels": x[:7]}, {"batch_size": 0}, {"n_slots": 0}):
        with pytest.raises(ValueError):
            tnative.NativeBatchIterator(
                x, kw.get("labels"), kw.get("batch_size", 4),
                n_slots=kw.get("n_slots", 4))
    it = tnative.NativeBatchIterator(x, None, batch_size=4, shuffle=False)
    with pytest.raises(ValueError, match="float32 C-contiguous"):
        it.next_into(np.empty((4, 2), np.float64), np.empty(4, np.float32))
    with pytest.raises(ValueError, match="at least 8"):
        it.next_into(torch.empty(3, 2), torch.empty(4))
    bx = torch.full((4, 2), -1.0)
    assert it.next_into(bx, torch.empty(4)) == 4
    np.testing.assert_array_equal(bx.numpy(), x[:4])
    assert it.next_into(bx, torch.empty(4)) == 4
    assert it.next_into(bx, torch.empty(4)) == 0     # exhausted, closed
    assert it._handle is None


@pytest.mark.parametrize("drop_last", [None, False, True])
def test_native_dataset_iterator_gives_the_jax_batches(drop_last):
    rs = np.random.RandomState(0)
    x = rs.randn(30, 1, 3, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 30)]

    def make(mod, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            it = mod.NativeBatchDataSetIterator(x, y, 8, seed=5,
                                                drop_last=drop_last, **kw)
        return it, [str(w.message) for w in caught]
    t, t_warn = make(titers, device="cpu")
    j, j_warn = make(jiters)
    assert t_warn == j_warn and len(t_warn) == (drop_last is None)
    for _ in range(2):      # two epochs: seeds seed + 1, then seed + 2
        tb = [(d.features.numpy(), d.labels.numpy()) for d in t]
        jb = [(np.asarray(d.features.numpy()), np.asarray(d.labels.numpy()))
              for d in j]
        assert len(tb) == len(jb) == (4 if drop_last is False else 3)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            assert tx.tobytes() == jx.tobytes()
            assert ty.tobytes() == jy.tobytes()
    t.close()
    j.close()


def test_native_dataset_iterator_refuses_as_jax():
    x = np.zeros((5, 2), np.float32)
    for mod, kw in ((titers, {"device": "cpu"}), (jiters, {})):
        with pytest.raises(ValueError, match="zero batches"):
            mod.NativeBatchDataSetIterator(x, x, 8, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            titers.NativeBatchDataSetIterator(x, x, 2)


def test_without_the_library_readers_fall_back_and_the_ring_raises(
        tmp_path, monkeypatch):
    csv = str(tmp_path / "d.csv")
    with open(csv, "w") as f:
        f.write("a,b\n1,2.5\n3,4\n")
    idx = str(tmp_path / "i.idx")
    arr = np.arange(12, dtype=np.uint8).reshape(3, 2, 2)
    _write_idx(idx, arr)
    native_csv = tnative.read_csv(csv, skip_lines=1)
    native_idx = tnative.read_idx(idx, normalize=True)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", "g++ unavailable: test")
    assert not tnative.available()
    assert tnative.build_error() == "g++ unavailable: test"
    np.testing.assert_array_equal(tnative.read_csv(csv, skip_lines=1),
                                  native_csv)
    np.testing.assert_allclose(tnative.read_idx(idx, normalize=True),
                               native_idx, rtol=1e-7)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tnative.NativeBatchIterator(arr.astype(np.float32), None, 2)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        titers.NativeBatchDataSetIterator(arr, arr, 2, device="cpu",
                                           drop_last=True)
    # parse_idx keeps numpy's u8 where the decoder is missing
    assert tfetch.parse_idx(idx).dtype == np.uint8


def test_library_is_built_into_the_git_ignored_directory():
    path = tnative._lib_path()
    build = os.path.join(ROOT, "deeplearning4j_tpu_torch", "native", "build")
    assert os.path.dirname(path) == build and os.path.exists(path)
    with open(tnative._SRC, "rb") as f:
        import hashlib
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(path) == f"libdl4jtpu_io-{digest}.so"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert "deeplearning4j_tpu_torch/native/build/" in ignored
    # the port's own copy of the source, not the JAX package's file
    assert os.path.realpath(tnative._SRC) != os.path.realpath(jnative._SRC)
