"""Native IO runtime: ctypes bindings over the C++ data-loading library.

Counterpart of ``deeplearning4j_tpu/native/`` (the native side of the
reference's input pipeline: DataVec record readers + AsyncDataSetIterator
copy threads; libnd4j host loaders). It keeps host-side ETL (CSV parse,
IDX decode, shuffled minibatch assembly) off the Python interpreter and
outside the GIL: ``ctypes`` releases the GIL around every call, so the
ring's C++ thread gathers the next batch while Python runs the step.

The shared library is this package's own copy of the C++ source
(``src/dl4jtpu_io.cpp``), built with ``g++`` at first use into
``build/`` beside it (git-ignored), under a name keyed by the source's
digest. ``read_csv`` and ``read_idx`` fall back to numpy where it cannot
be built; ``NativeBatchIterator`` raises. ``available()`` reports the
state and ``build_error()`` why it is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "dl4jtpu_io.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
#: the JAX package's flags: the ring's shuffle draws from
#: std::uniform_int_distribution, whose algorithm is the standard
#: library's, so the same compiler and flags give the same batch order
_CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None
#: seconds ``g++`` took in this process (None: loaded a library built
#: earlier, or nothing loaded yet)
build_seconds: Optional[float] = None


def _lib_path() -> str:
    """Build path keyed by a hash of the source, so a changed .cpp can
    never be shadowed by a stale binary (mtimes are unreliable after git
    checkout — git does not preserve them)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return os.path.join(_BUILD_DIR, f"libdl4jtpu_io-{digest}.so")


def _build(lib_path: str) -> Optional[str]:
    """Compile the shared library; returns an error string or None."""
    global build_seconds
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = ["g++", *_CXXFLAGS, _SRC, "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, lib_path)  # atomic vs concurrent builders
    build_seconds = time.perf_counter() - t0
    return None


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib_path = _lib_path()
        except OSError as e:
            _build_error = f"no build directory: {e}"
            return None
        if not os.path.exists(lib_path):
            err = _build(lib_path)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError as e:
            _build_error = str(e)
            return None
        c = ctypes.c_char_p
        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(i64)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        lib.csv_dims.argtypes = [c, ctypes.c_char, ctypes.c_int, p_i64,
                                 p_i64]
        lib.csv_dims.restype = ctypes.c_int
        lib.csv_parse.argtypes = [c, ctypes.c_char, ctypes.c_int, p_f32,
                                  i64, i64]
        lib.csv_parse.restype = ctypes.c_int
        lib.idx_dims.argtypes = [c, p_i64, p_i64]
        lib.idx_dims.restype = ctypes.c_int
        lib.idx_read_f32.argtypes = [c, p_f32, i64, ctypes.c_int]
        lib.idx_read_f32.restype = ctypes.c_int
        lib.ring_create.argtypes = [p_f32, p_f32, i64, i64, i64, i64,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_uint64, i64, ctypes.c_int]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_next.argtypes = [ctypes.c_void_p, p_f32, p_f32, p_i64]
        lib.ring_next.restype = ctypes.c_int
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_destroy.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------- CSV
def read_csv(path: str, delimiter: str = ",",
             skip_lines: int = 0) -> np.ndarray:
    """Numeric CSV -> float32 matrix via the native parser."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, delimiter=delimiter, skiprows=skip_lines,
                          dtype=np.float32, ndmin=2)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    d = delimiter.encode()[0:1]
    rc = lib.csv_dims(path.encode(), d, skip_lines, ctypes.byref(rows),
                      ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"csv_dims({path}) failed: {rc}")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.csv_parse(path.encode(), d, skip_lines, _fptr(out), rows.value,
                       cols.value)
    if rc != 0:
        raise IOError(f"csv_parse({path}) failed: {rc}")
    return out


# ---------------------------------------------------------------- IDX
def read_idx(path: str, normalize: bool = False) -> np.ndarray:
    """MNIST/EMNIST IDX (u8) file -> float32 array."""
    lib = _load()
    if lib is None:
        return _read_idx_py(path, normalize)
    ndim = ctypes.c_int64()
    dims = (ctypes.c_int64 * 4)()
    rc = lib.idx_dims(path.encode(), ctypes.byref(ndim), dims)
    if rc != 0:
        raise IOError(f"idx_dims({path}) failed: {rc}")
    shape = tuple(dims[i] for i in range(ndim.value))
    out = np.empty(shape, np.float32)
    rc = lib.idx_read_f32(path.encode(), _fptr(out), out.size,
                          1 if normalize else 0)
    if rc != 0:
        raise IOError(f"idx_read_f32({path}) failed: {rc}")
    return out


def _read_idx_py(path, normalize):
    with open(path, "rb") as f:
        hdr = f.read(4)
        nd = hdr[3]
        shape = tuple(int.from_bytes(f.read(4), "big") for _ in range(nd))
        data = np.frombuffer(f.read(int(np.prod(shape))), np.uint8)
    out = data.astype(np.float32).reshape(shape)
    return out / 255.0 if normalize else out


# ------------------------------------------------------------- BatchRing
class NativeBatchIterator:
    """Shuffled minibatch iterator backed by the C++ assembler thread
    (AsyncDataSetIterator analog: batches are gathered off-GIL while the
    previous step runs on the device).

    The ring keeps raw pointers to ``features`` and ``labels`` until
    ``close()``: this object holds the float32 C-contiguous arrays it
    passed (``self.features``, ``self.labels``), never a temporary."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_epochs: int = 1, n_slots: int = 4,
                 drop_last: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self.features = np.ascontiguousarray(features, np.float32)
        self.labels = np.ascontiguousarray(labels, np.float32) \
            if labels is not None else None
        n = self.features.shape[0]
        # the C++ side trusts these: rows it gathers from both arrays, a
        # loop that steps by the batch, a thread that waits for a slot
        if self.labels is not None and self.labels.shape[0] != n:
            raise ValueError(f"{self.labels.shape[0]} label rows for {n} "
                             f"feature rows")
        if int(batch_size) < 1 or int(n_slots) < 1:
            raise ValueError(f"batch_size ({batch_size}) and n_slots "
                             f"({n_slots}) must be at least 1")
        self.xf = int(np.prod(self.features.shape[1:]) or 1)
        self.yf = int(np.prod(self.labels.shape[1:]) or 1) \
            if self.labels is not None else 0
        self.batch = int(batch_size)
        self._x_shape = (self.batch,) + self.features.shape[1:]
        self._y_shape = (self.batch,) + (self.labels.shape[1:]
                                         if self.labels is not None else ())
        self._handle = lib.ring_create(
            _fptr(self.features),
            _fptr(self.labels) if self.labels is not None
            else _fptr(self.features),
            n, self.xf, self.yf, self.batch, n_slots, 1 if shuffle else 0,
            seed, num_epochs, 1 if drop_last else 0)

    def __iter__(self):
        return self

    def next_into(self, out_x, out_y) -> int:
        """Pop the next batch into caller-owned float32 C-contiguous
        buffers of ``batch * xf`` and ``batch * max(yf, 1)`` elements (numpy
        arrays or CPU tensors, pinned or not); returns its row count (the
        batch size but for a trailing partial batch), 0 once the ring is
        exhausted (then closed)."""
        if self._handle is None:
            return 0
        ptrs = [_buffer_ptr(b, n, name) for b, n, name in (
            (out_x, self.batch * self.xf, "out_x"),
            (out_y, self.batch * max(self.yf, 1), "out_y"))]
        rows = ctypes.c_int64(0)
        if not self._lib.ring_next(self._handle, *ptrs, ctypes.byref(rows)):
            self.close()
            return 0
        return int(rows.value)

    def __next__(self):
        bx = np.empty((self.batch, self.xf), np.float32)
        by = np.empty((self.batch, max(self.yf, 1)), np.float32)
        r = self.next_into(bx, by)
        if not r:
            raise StopIteration
        x = bx[:r].reshape((r,) + self._x_shape[1:])
        if self.yf:
            return x, by[:r].reshape((r,) + self._y_shape[1:])
        return x, None

    def close(self):
        if self._handle is not None:
            self._lib.ring_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _buffer_ptr(buf, numel: int, name: str):
    """A float pointer into ``buf`` after checking what the C side will
    write: float32, C-contiguous, on the host, ``numel`` elements or more."""
    if isinstance(buf, np.ndarray):
        ok = (buf.dtype == np.float32 and buf.flags.c_contiguous
              and buf.size >= numel)
        addr = buf.ctypes.data
    else:  # a torch tensor (imported by the caller, not here)
        ok = (str(buf.dtype) == "torch.float32" and buf.is_contiguous()
              and buf.device.type == "cpu" and buf.numel() >= numel)
        addr = buf.data_ptr()
    if not ok:
        raise ValueError(f"{name} must be a float32 C-contiguous host "
                         f"buffer of at least {numel} elements")
    return ctypes.cast(addr, ctypes.POINTER(ctypes.c_float))
