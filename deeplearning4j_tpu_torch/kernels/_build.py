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

Every build goes through the artifact store
(``runtime/compile_cache.py``): a library already in ``kernels/build/``
is used as it is; otherwise a store hit writes its bytes there and runs
no compiler; otherwise ``nvcc`` runs and the library is put into the
store. So a replica pointed at a warm image (``runtime/warm_image.py``)
serves with no CUDA toolkit installed. A corrupt entry is dropped with
one warning and rebuilt; with no entry and no ``nvcc`` the build raises.
:func:`stats` counts compiler runs, store hits and store misses.

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


def store_key(name: str) -> str:
    """The artifact-store key of kernel ``name``'s library: a sha256 over
    its file name (a digest of the source, the headers and the flags) and
    the CUDA version torch was built for. Computable with no ``nvcc``."""
    import torch
    h = hashlib.sha256(library_path(name).name.encode())
    h.update(b"\x00")
    h.update(str(torch.version.cuda).encode())
    return h.hexdigest()


def _nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build)."""
    try:
        out = subprocess.run([nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return ""
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def _write(path: Path, data) -> None:
    """``data`` into ``path`` through a temporary file and ``os.replace``:
    a reader never sees half a file."""
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    if isinstance(data, bytes):
        tmp.write_bytes(data)
    else:
        tmp.write_text(data)
    os.replace(tmp, path)


#: what this process's builds did: compiler runs, store hits and misses,
#: the seconds ``nvcc`` took, and each library's latest source
_stats_lock = threading.Lock()
_stats = {"compiler_runs": 0, "store_hits": 0, "store_misses": 0,
          "compile_seconds": 0.0}
_sources: Dict[str, str] = {}


def stats() -> dict:
    """This process's build counts (``compiler_runs``, ``store_hits``,
    ``store_misses``, ``compile_seconds``) and ``sources``: where each
    library it asked for came from — ``"present"`` (already in
    ``kernels/build/``), ``"hit"`` (the store) or ``"miss"`` (``nvcc``)."""
    with _stats_lock:
        return {**_stats, "sources": dict(_sources)}


def reset_stats() -> None:
    with _stats_lock:
        _stats.update(compiler_runs=0, store_hits=0, store_misses=0,
                      compile_seconds=0.0)
        _sources.clear()


def _from_store(cc, name: str, out: Path) -> bool:
    """Write kernel ``name``'s library from the store into ``out``; False
    on a miss (a corrupt entry is a miss: the store drops it and warns
    once)."""
    t0 = time.perf_counter()
    entry = cc.get(store_key(name))
    if entry is None:
        with _stats_lock:
            _stats["store_misses"] += 1
        return False
    payload, meta = entry
    _write(out.with_suffix(".ptxas.txt"), meta.get("ptxas", ""))
    _write(out, payload)
    from ..runtime.compile_cache import observe_compile
    observe_compile("kernel", "hit", time.perf_counter() - t0)
    with _stats_lock:
        _stats["store_hits"] += 1
    return True


def _to_store(cc, name: str, out: Path, log: str, nvcc_version: str):
    cc.put(store_key(name), out.read_bytes(),
           {"tag_kind": "kernel", "kernel": name, "nvcc": nvcc_version,
            "ptxas": log, "created": time.time()})


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Make every named library present in ``kernels/build/``: used as it
    is when there, else written from the artifact store, else compiled by
    ``nvcc`` (one each, all started together) and put into the store.
    Returns the seconds each library took (0.0 for one already present).
    Raises with the compiler's output when a build fails."""
    from ..runtime.compile_cache import cache, observe_compile
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = cache()
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            with _stats_lock:
                _sources[name] = "present"
            continue
        if cc is not None and _from_store(cc, name, out):
            seconds[name] = time.perf_counter() - t0
            with _stats_lock:
                _sources[name] = "hit"
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        with _stats_lock:
            _stats["compiler_runs"] += 1
            _sources[name] = "miss"
    failed, built = [], []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        _write(out.with_suffix(".ptxas.txt"), log)
        os.replace(tmp, out)  # atomic: a reader never sees half a file
        observe_compile("kernel", "miss", seconds[name])
        built.append((name, out, log))
    if procs:
        with _stats_lock:
            _stats["compile_seconds"] += time.perf_counter() - t0
    if built and cc is not None:
        version = _nvcc_version()
        for name, out, log in built:
            _to_store(cc, name, out, log, version)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def warm(device) -> str:
    """Pull or build every kernel library through the store ahead of
    first use (``warm_compile``). Returns ``"hit"`` when each was already
    present or came from the store, ``"miss"`` when ``nvcc`` ran, and
    ``"bypass"`` with no store configured or for a ``device`` that is not
    CUDA, where no kernel runs and nothing is built."""
    import torch
    from ..runtime.compile_cache import cache
    if torch.device(device).type != "cuda" or cache() is None:
        return "bypass"
    build(KERNELS)
    with _stats_lock:
        fresh = [_sources[name] for name in KERNELS]
    return "miss" if "miss" in fresh else "hit"


def publish(names: Iterable[str]) -> List[str]:
    """Put each named library that is present in ``kernels/build/`` into
    the store, where it is not there yet (``warm_image.bake``). Returns
    the names the store holds afterwards."""
    from ..runtime.compile_cache import cache
    cc = cache()
    if cc is None:
        return []
    held = []
    for name in names:
        key, out = store_key(name), library_path(name)
        if not cc.store.contains(key):
            if not out.exists():
                continue
            _to_store(cc, name, out, ptxas_report(name), _nvcc_version())
        held.append(name)
    return held


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
