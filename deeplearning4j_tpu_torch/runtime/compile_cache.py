"""The serving-manifest half of the JAX package's
``runtime/compile_cache.py``.

What the port keeps: where the serving registry persists per-model warmup
manifests (:func:`serving_manifest_dir`), their push-on-drain /
pull-on-boot copy through a fleet-shared directory
(``DL4J_TPU_REMOTE_CACHE``), and the ``dl4j_compile_seconds`` histogram
(:func:`observe_compile`).

The executable store (``AOTCompileCache``, the local/remote/tiered stores,
``aot_entry``, ``inventory``) waits for ``ROADMAP.md`` queue 1 item 11:
the port's compiled steps are CUDA graphs (``runtime/cuda_graphs.py``),
which cannot be written to disk, and :func:`push_to_remote` /
:func:`pull_from_remote` move manifests only (``executables`` is always
0).
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Dict, Optional

from ..common.environment import environment

log = logging.getLogger(__name__)


def serving_manifest_dir(create: bool = True) -> Optional[str]:
    """Directory where the serving registry persists per-model warmup
    manifests. ``DL4J_TPU_SERVING_MANIFEST_DIR`` overrides; the default is
    ``<DL4J_TPU_CACHE_DIR>/manifests``. None when both are disabled
    (manifests then live only in process memory)."""
    d = environment().serving_manifest_dir()
    if not d:
        base = environment().cache_dir()
        if not base:
            return None
        d = os.path.join(base, "manifests")
    if create:
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            log.warning("serving manifest dir %s unusable (%s); manifests "
                        "stay in-memory", d, e)
            return None
    return d


def _remote_manifest_dir(create: bool = False) -> Optional[str]:
    """``<DL4J_TPU_REMOTE_CACHE>/manifests``, or None without a shared
    store."""
    root = environment().remote_cache()
    if not root:
        return None
    d = os.path.join(root, "manifests")
    if create:
        os.makedirs(d, exist_ok=True)
    return d


def _tmp_suffix() -> str:
    return f".tmp{os.getpid()}.{threading.get_ident()}"


def _copy_manifests(src: Optional[str], dst: Optional[str]) -> int:
    """Atomic-copy every ``*.warmup.json`` from src into dst; returns the
    count copied."""
    if not src or not dst or not os.path.isdir(src):
        return 0
    try:
        os.makedirs(dst, exist_ok=True)
        names = [n for n in os.listdir(src) if n.endswith(".warmup.json")]
    except OSError:
        return 0
    copied = 0
    for name in names:
        try:
            tmp = os.path.join(dst, name + _tmp_suffix())
            shutil.copyfile(os.path.join(src, name), tmp)
            os.replace(tmp, os.path.join(dst, name))
            copied += 1
        except OSError as e:
            log.warning("manifest copy %s failed (%s)", name, e)
    return copied


def push_to_remote() -> Dict[str, int]:
    """Publish this replica's serving manifests to the shared store
    (``GracefulLifecycle.drain`` calls it). No-op without one."""
    remote = _remote_manifest_dir(create=True)
    if remote is None:
        return {"executables": 0, "manifests": 0}
    n = _copy_manifests(serving_manifest_dir(create=False), remote)
    if n:
        log.info("pushed %d manifests to the remote store", n)
    return {"executables": 0, "manifests": n}


def pull_manifests() -> int:
    """Copy the shared store's warmup manifests into the local manifest
    dir (overwriting). No-op without a shared store."""
    remote = _remote_manifest_dir()
    if remote is None:
        return 0
    return _copy_manifests(remote, serving_manifest_dir(create=True))


def pull_from_remote() -> Dict[str, int]:
    """Boot-time restore of the fleet's manifests (the port has no
    executables to pull)."""
    return {"executables": 0, "manifests": pull_manifests()}


#: buckets of dl4j_compile_seconds: 1 ms .. ~17 min
COMPILE_SECONDS_BUCKETS = tuple(1e-3 * 2.0 ** i for i in range(20))


def observe_compile(kind: str, cache_label: str, seconds: float):
    """Record one step's materialization (its first run and its CUDA-graph
    capture) in ``dl4j_compile_seconds{kind,cache}``: ``cache`` is
    ``captured``, ``eager`` or ``eager:<reason>``
    (``runtime/cuda_graphs.py``)."""
    try:
        from ..common.metrics import registry
        registry().histogram(
            "dl4j_compile_seconds",
            "Wall time to materialize + first-run an executable, by cache "
            "outcome", labels=("kind", "cache"),
            buckets=COMPILE_SECONDS_BUCKETS).labels(
                kind=kind, cache=cache_label).observe(seconds)
    except Exception:
        pass  # observability must never break the dispatch path
