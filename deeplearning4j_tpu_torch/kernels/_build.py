"""Build and load the port's CUDA C++ kernels.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(it may include the shared ``csrc/*.cuh`` headers). At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``kernels/build/`` (git-ignored) and loaded with ``ctypes``; pointers and
the stream cross as ``c_void_p``. The library's file name carries a hash
of its source, the headers and the flags, so an edited source never
loads a stale build.
:func:`build` starts one ``nvcc`` per missing library, all at once.

:func:`counters` keeps the zeroed int32 buffers that kernels finishing a
reduction in their last-arriving block count in.

Nothing here runs at import: the CPU tests import every kernel module on
a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("paged_flash_decode", "dequant_matmul", "flash_attention_fwd",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_counters: Dict[tuple, object] = {}
#: counter buffers a larger one replaced: a CUDA graph captured with one
#: still launches on it, and holds its address, not the tensor
_retired: List[object] = []


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    # the digest covers the shared headers too: a source may include any
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said about the library's kernels (registers,
    shared memory, spills), saved beside the library when it was built."""
    p = library_path(name).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc``
    each, all started together. Returns the seconds each build took
    (0.0 for one already built). Raises with the compiler's output when
    a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first when
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(lib: ctypes.CDLL, status: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error code
    (``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        lib.dl4j_error_string.restype = ctypes.c_char_p
        lib.dl4j_error_string.argtypes = [ctypes.c_int]
        msg = lib.dl4j_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} "
                           f"(error {status})")


def counters(device, n: int):
    """A zeroed int32 buffer of at least ``n`` entries on ``device`` for
    the kernels whose last-arriving block finishes a reduction: a kernel
    counts its blocks in, and the last one resets its counter to 0, so the
    buffer is all zeros between launches and one buffer per stream serves
    every launch on that stream. Made with ``torch.zeros`` once, and again
    only when a launch needs more entries; the smaller buffer is kept
    (``_retired``), never freed, since a graph captured before may still
    replay on it.

    A CUDA graph bakes in the buffer of the stream it was captured on.
    Each set of graphs (``runtime/cuda_graphs.py``) captures on a stream
    of its own, after running the step once on it, so graphs that may
    replay at the same time never share a buffer, and none is first made
    inside a capture: this raises if one would be."""
    import torch
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (torch.device(device).index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"kernel counters of {n} entries first needed inside a "
                "CUDA-graph capture: run the step once on the capture "
                "stream before capturing it")
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
