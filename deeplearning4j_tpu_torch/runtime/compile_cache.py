"""The persistent artifact store: kernel libraries and serving manifests.

Counterpart of ``deeplearning4j_tpu/runtime/compile_cache.py``. The
deployment restarts constantly (autoscaling, rollouts, preemption), and a
fresh replica pays its compile bill before it serves a token. What the
JAX package stores is serialized XLA executables. A CUDA graph cannot be
written to disk, so what a port process compiles, and a second process
can reuse, is the set of ``nvcc``-built kernel libraries
(``kernels/_build.py``): the "executable" of this store is one library.

- **key**: ``kernels._build.store_key(name)``, a sha256 over the
  library's file name (which carries a digest of its source, the shared
  headers and the flags) and ``torch.version.cuda``. A replica with no
  ``nvcc`` can compute it; ``nvcc --version`` goes into the meta.
- **payload**: the ``.so`` bytes.
- **meta**: the integrity fields every store validates on read
  (``_stamp_meta`` / ``_validate_entry``: format version, payload size,
  payload sha256), plus the kernel's name, the ``nvcc`` version that
  built it, its ``ptxas`` report, ``tag_kind="kernel"`` and ``created``.

``_build`` goes through :func:`cache`: a library already in
``kernels/build/`` is used as it is; otherwise a store hit writes the
bytes there (temporary file, then ``os.replace``) and runs no compiler;
otherwise ``nvcc`` runs and the result is put into the store. A corrupt
entry is dropped with a one-time warning and rebuilt: a corrupt cache
costs a compile, never an exception.

The stores are the JAX package's: :class:`LocalDirStore` (flat
``<DL4J_TPU_CACHE_DIR>/aot/<key>.bin|.json``, mtime LRU under
``DL4J_TPU_CACHE_MAX_BYTES``), :class:`RemoteStore` (the fleet-shared
``<DL4J_TPU_REMOTE_CACHE>/objects/<key[:2]>/<key>.bin|.json``, plus
``manifests/``) and :class:`TieredStore` (local then remote,
write-populating both), chosen by ``DL4J_TPU_CACHE_TIER``. A warm image
(``runtime/warm_image.py``) is a directory in the remote layout.
``push_to_remote`` (on drain) and ``pull_from_remote`` (on boot) move
libraries and warmup manifests; ``inventory`` is the
``/debug/compile_cache`` document.

What has no counterpart here, each for one reason:

- the ``jax_compilation_cache_dir`` backstop (``_backstop_wanted``,
  ``_configure_backstop``, ``_disable_backstop``): there is no XLA;
- ``cost_analysis``: XLA's cost model of a compiled program; a kernel
  library has none (``chip_smoke.py`` states each kernel's bound);
- ``_sharding_meta``, ``_serialize``, ``_load_executor``, ``aot_entry``,
  ``_ineligible_reason`` (and ``_eligible``, ``warm``, ``cache_key``,
  ``env_fingerprint``, the placement fingerprint): they serialize and
  reload XLA executables per traced signature, and the port's compiled
  steps are CUDA graphs, which cannot be serialized.

Observability: ``dl4j_compile_seconds{kind,cache}`` (each library's
source: ``kind="kernel"``, ``cache="hit"`` from the store or ``"miss"``
from ``nvcc``; a step's CUDA-graph capture: ``captured`` / ``eager``),
``dl4j_cache_pull_seconds{outcome}`` and the
``dl4j_cache_store_bytes|entries{tier}`` gauges. Disable the store with
``DL4J_TPU_CACHE_DIR=""``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common import faults
from ..common.environment import environment
from ..common.locks import ordered_lock

log = logging.getLogger(__name__)

#: bump to invalidate every existing on-disk entry (layout change)
FORMAT_VERSION = 2

_PAYLOAD_EXT = ".bin"
_META_EXT = ".json"


# ---------------------------------------------------------------------------
# pluggable raw artifact stores
# ---------------------------------------------------------------------------

class CorruptEntryError(Exception):
    """A stored entry failed validation (format/size/digest) and was
    deleted by the store before raising. The cache layer turns this into
    a one-time warning + a miss — never an exception to the caller."""

    def __init__(self, why: str):
        super().__init__(why)
        self.why = why


_TMP_COUNTER = itertools.count()


def _tmp_suffix() -> str:
    """Unique-per-writer tmp suffix: two replicas (or two threads of one
    replica) pushing the same key must never collide on the tmp file —
    each writes its own and the last ``os.replace`` wins atomically."""
    return ".tmp%d-%d-%d" % (os.getpid(), threading.get_ident(),
                             next(_TMP_COUNTER))


def _stamp_meta(payload: bytes, meta: dict) -> dict:
    """Copy of ``meta`` stamped with the integrity fields every store
    validates on read."""
    meta = dict(meta)
    meta["format"] = FORMAT_VERSION
    meta["payload_bytes"] = len(payload)
    meta["payload_sha"] = hashlib.sha256(payload).hexdigest()
    return meta


def _validate_entry(payload: bytes, meta: dict):
    """Raise ValueError when (payload, meta) fail the integrity check."""
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"format {meta.get('format')} != {FORMAT_VERSION}")
    if len(payload) != meta.get("payload_bytes"):
        raise ValueError("payload truncated")
    if hashlib.sha256(payload).hexdigest() != meta.get("payload_sha"):
        raise ValueError("payload checksum mismatch")


class _FilesystemStore:
    """Shared machinery of the filesystem-rooted stores: an entry is
    ``<key>.bin`` + ``<key>.json`` under ``_entry_dir(key)``, written via
    a unique tmp file + ``os.replace`` (atomic on POSIX, so concurrent
    writers of the same key cannot interleave partial content) and
    digest-verified on every read (a failed check deletes the entry and
    raises :class:`CorruptEntryError`)."""

    tier = "local"

    def _entry_dir(self, key: str, create: bool = False) -> str:
        raise NotImplementedError

    def _paths(self, key: str, create: bool = False) -> Tuple[str, str]:
        d = self._entry_dir(key, create=create)
        return (os.path.join(d, key + _PAYLOAD_EXT),
                os.path.join(d, key + _META_EXT))

    def contains(self, key: str) -> bool:
        return os.path.exists(self._paths(key)[1])

    def get(self, key: str) -> Optional[Tuple[bytes, dict]]:
        payload_p, meta_p = self._paths(key)
        if not os.path.exists(meta_p):
            return None
        try:
            with open(meta_p, "r") as f:
                meta = json.load(f)
            with open(payload_p, "rb") as f:
                payload = f.read()
            _validate_entry(payload, meta)
        except Exception as e:
            self.delete(key)
            raise CorruptEntryError(f"{type(e).__name__}: {e}") from e
        self.touch(key)
        return payload, meta

    def put(self, key: str, payload: bytes, meta: dict) -> bool:
        """``meta`` must already be stamped (``_stamp_meta``)."""
        try:
            payload_p, meta_p = self._paths(key, create=True)
            for path, data, mode in ((payload_p, payload, "wb"),
                                     (meta_p, json.dumps(meta), "w")):
                tmp = path + _tmp_suffix()
                with open(tmp, mode) as f:
                    f.write(data)
                os.replace(tmp, path)
        except OSError as e:
            log.warning("artifact store write failed (%s); continuing "
                        "uncached", e)
            return False
        return True

    def delete(self, key: str):
        for p in self._paths(key):
            try:
                os.remove(p)
            except OSError:
                pass

    def touch(self, key: str):
        """LRU recency hint; overridden to a no-op where mtime churn is
        unwanted (the shared remote)."""
        now = time.time()
        try:
            os.utime(self._paths(key)[0], (now, now))
        except OSError:
            pass

    def entry_meta(self, key: str) -> Optional[dict]:
        try:
            with open(self._paths(key)[1], "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def last_used(self, key: str) -> Optional[float]:
        try:
            return os.stat(self._paths(key)[0]).st_mtime
        except OSError:
            return None

    def _iter_dirs(self):
        raise NotImplementedError

    def keys(self) -> List[str]:
        out = []
        for d in self._iter_dirs():
            try:
                names = os.listdir(d)
            except OSError:
                continue
            out.extend(n[:-len(_META_EXT)] for n in names
                       if n.endswith(_META_EXT))
        return out

    def stat(self) -> Dict[str, int]:
        """{"entries", "bytes"} of the tier, by payload files."""
        entries = 0
        total = 0
        for d in self._iter_dirs():
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in names:
                if n.endswith(_META_EXT):
                    entries += 1
                elif n.endswith(_PAYLOAD_EXT):
                    try:
                        total += os.stat(os.path.join(d, n)).st_size
                    except OSError:
                        pass
        return {"entries": entries, "bytes": total}

    def clear(self):
        for d in self._iter_dirs():
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in names:
                try:
                    os.remove(os.path.join(d, n))
                except OSError:
                    pass
        return self

    def tiers(self) -> List["_FilesystemStore"]:
        return [self]

    def enforce_cap(self, max_bytes: int) -> int:
        """Evict LRU entries beyond ``max_bytes``; returns evicted count.
        Only the local tier caps — see the overrides."""
        return 0


class LocalDirStore(_FilesystemStore):
    """The per-machine layout: flat ``<base_dir>/aot/<key>.bin|.json``
    with mtime-LRU eviction. The default store when no remote is
    configured."""

    tier = "local"

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.aot_dir = os.path.join(base_dir, "aot")
        os.makedirs(self.aot_dir, exist_ok=True)

    def _entry_dir(self, key: str, create: bool = False) -> str:
        return self.aot_dir

    def _iter_dirs(self):
        yield self.aot_dir

    def enforce_cap(self, max_bytes: int) -> int:
        if max_bytes <= 0:
            return 0
        evicted = 0
        try:
            entries = []
            total = 0
            for name in os.listdir(self.aot_dir):
                if not name.endswith(_PAYLOAD_EXT):
                    continue
                p = os.path.join(self.aot_dir, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                total += st.st_size
                entries.append((st.st_mtime, st.st_size,
                                name[:-len(_PAYLOAD_EXT)]))
            if total <= max_bytes:
                return 0
            entries.sort()  # oldest first
            for _, size, key in entries:
                if total <= max_bytes:
                    break
                self.delete(key)
                total -= size
                evicted += 1
        except OSError:
            pass  # capping is best-effort; never fail the build path
        return evicted

    def describe(self) -> dict:
        return {"tier": self.tier, "backend": "local-dir",
                "path": self.aot_dir}


class RemoteStore(_FilesystemStore):
    """Content-addressed shared store the whole fleet reads and writes:
    sha256-keyed objects under ``<root>/objects/<key[:2]>/`` (the two-hex
    fan-out keeps any one directory small at fleet scale). Writes are
    unique-tmp + ``os.replace`` and reads digest-verify, so N replicas
    pushing the same key concurrently converge on one valid entry and a
    torn write can never be served.

    This filesystem-rooted implementation is both the test double and a
    real deployment path (``DL4J_TPU_REMOTE_CACHE`` pointed at an NFS /
    FUSE-mounted bucket, or at a baked warm image). An object-store
    client is the extension point: subclass and override ``get`` /
    ``put`` / ``delete`` / ``contains`` / ``keys`` / ``stat`` (and
    ``manifest_dir``) with its transport. No LRU here: recency touches
    and byte caps are per-machine policies (``LocalDirStore``)."""

    tier = "remote"

    def __init__(self, root: str):
        self.root = root
        self.objects_dir = os.path.join(root, "objects")
        os.makedirs(self.objects_dir, exist_ok=True)

    def _entry_dir(self, key: str, create: bool = False) -> str:
        d = os.path.join(self.objects_dir, key[:2] or "_")
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def _iter_dirs(self):
        try:
            shards = sorted(os.listdir(self.objects_dir))
        except OSError:
            shards = []
        for s in shards:
            yield os.path.join(self.objects_dir, s)

    def touch(self, key: str):
        pass  # shared mtimes stay put: every replica would churn them

    def manifest_dir(self, create: bool = False) -> str:
        """Where pushed warmup manifests live (``<root>/manifests``) —
        the pull-on-boot counterpart of ``serving_manifest_dir``."""
        d = os.path.join(self.root, "manifests")
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def describe(self) -> dict:
        return {"tier": self.tier, "backend": "remote-fs",
                "path": self.objects_dir}


class TieredStore:
    """Read local-then-remote, write-populate both.

    A local miss falls through to the shared remote; a remote hit is
    written back into the local dir so the next restart never leaves the
    machine. A *corrupt* local entry is deleted and transparently
    refetched from the remote (``on_corrupt`` is still told, so the
    cache's corruption stats see it); a corrupt remote entry is deleted
    for the whole fleet and reported as a miss. Remote fetch latency
    lands on ``dl4j_cache_pull_seconds{outcome=hit|miss|error}``."""

    tier = "tiered"

    def __init__(self, local: LocalDirStore, remote: RemoteStore):
        self.local = local
        self.remote = remote
        #: set by the owning cache to route corruption into its
        #: warn-once + stats path
        self.on_corrupt: Optional[Callable[[str, str], None]] = None

    def _corrupt(self, key: str, why: str):
        if self.on_corrupt is not None:
            self.on_corrupt(key, why)
        else:
            log.warning("compile cache entry %s.. dropped (%s)",
                        key[:12], why)

    def contains(self, key: str) -> bool:
        return self.local.contains(key) or self.remote.contains(key)

    def get(self, key: str) -> Optional[Tuple[bytes, dict]]:
        local_why = None
        try:
            entry = self.local.get(key)
            if entry is not None:
                return entry
        except CorruptEntryError as e:
            local_why = e.why  # deleted; try to refetch from the remote
        t0 = time.perf_counter()
        try:
            entry = self.remote.get(key)
        except CorruptEntryError as e:
            observe_pull("error", time.perf_counter() - t0)
            self._corrupt(key, f"remote entry: {e.why}")
            return None
        if entry is None:
            observe_pull("miss", time.perf_counter() - t0)
            if local_why is not None:
                # nothing to refetch: surface the local corruption
                raise CorruptEntryError(local_why)
            return None
        observe_pull("hit", time.perf_counter() - t0)
        if local_why is not None:
            self._corrupt(key, f"{local_why}; refetched from remote store")
        self.local.put(key, entry[0], entry[1])
        return entry

    def put(self, key: str, payload: bytes, meta: dict) -> bool:
        local_ok = self.local.put(key, payload, meta)
        remote_ok = self.remote.put(key, payload, meta)
        return local_ok or remote_ok

    def delete(self, key: str):
        self.local.delete(key)
        self.remote.delete(key)

    def keys(self) -> List[str]:
        """Local-tier keys (what the inventory lists as resident)."""
        return self.local.keys()

    def entry_meta(self, key: str) -> Optional[dict]:
        return self.local.entry_meta(key) or self.remote.entry_meta(key)

    def last_used(self, key: str) -> Optional[float]:
        return self.local.last_used(key)

    def stat(self) -> Dict[str, int]:
        return self.local.stat()

    def clear(self):
        """Clears the *local* tier only: the shared remote outlives any
        one replica (use ``RemoteStore.clear()`` deliberately)."""
        self.local.clear()
        return self

    def tiers(self) -> List[Any]:
        return [self.local, self.remote]

    def enforce_cap(self, max_bytes: int) -> int:
        return self.local.enforce_cap(max_bytes)

    def describe(self) -> dict:
        return {"tier": self.tier, "backend": "tiered"}


#: buckets of dl4j_compile_seconds and dl4j_cache_pull_seconds: 1 ms ..
#: ~17 min
COMPILE_SECONDS_BUCKETS = tuple(1e-3 * 2.0 ** i for i in range(20))


def observe_pull(outcome: str, seconds: float):
    """Record one remote-store fetch on
    ``dl4j_cache_pull_seconds{outcome}`` (hit = object downloaded, miss =
    not in the remote, error = corrupt/unreadable remote entry) — the
    boot-time pull latency of a joining replica."""
    try:
        from ..common.metrics import registry
        registry().histogram(
            "dl4j_cache_pull_seconds",
            "Remote artifact-store fetch latency by outcome "
            "(hit|miss|error)", labels=("outcome",),
            buckets=COMPILE_SECONDS_BUCKETS).labels(
                outcome=outcome).observe(seconds)
    except Exception:
        pass  # observability must never break the load path


# ---------------------------------------------------------------------------
# the artifact cache (policy layer over a store)
# ---------------------------------------------------------------------------

class AOTCompileCache:
    """Artifact cache: validation stats, corruption warnings, and LRU
    policy over a pluggable raw store.

    Default store is :class:`LocalDirStore` — entry = ``<key>.bin`` (a
    kernel library) + ``<key>.json`` (integrity + build metadata) under
    ``<dir>/aot``, LRU by file mtime, capped at ``max_bytes``
    (``DL4J_TPU_CACHE_MAX_BYTES``). With ``DL4J_TPU_REMOTE_CACHE`` set
    the store is a :class:`TieredStore` (local + content-addressed
    shared remote). Every read validates format version, payload size,
    and payload sha256; anything off is deleted and reported as a miss —
    a corrupt cache can cost a compile, never an exception."""

    def __init__(self, base_dir: str, max_bytes: int, store=None):
        self.base_dir = base_dir
        self.store = store if store is not None else LocalDirStore(base_dir)
        local = next((t for t in self.store.tiers() if t.tier == "local"),
                     None)
        #: the local tier's flat entry dir (tests poke files here); None
        #: for a remote-only store
        self.aot_dir = local.aot_dir if local is not None else None
        self.max_bytes = int(max_bytes)
        self._lock = ordered_lock("cache.store")
        self._warned_keys: set = set()
        self.stats = {"hits": 0, "misses": 0, "puts": 0, "corrupt": 0,
                      "evictions": 0, "put_errors": 0}
        if isinstance(self.store, TieredStore):
            self.store.on_corrupt = self._warn_once
        self._refresh_store_gauges()

    def _drop(self, key: str):
        self.store.delete(key)

    def _warn_once(self, key: str, why: str):
        with self._lock:
            self.stats["corrupt"] += 1
            if key in self._warned_keys:
                return
            self._warned_keys.add(key)
        log.warning("compile cache entry %s.. dropped (%s); recompiling",
                    key[:12], why)

    def _refresh_store_gauges(self):
        """Per-tier size gauges, refreshed on every store mutation."""
        try:
            from ..common.metrics import registry
            reg = registry()
            g_bytes = reg.gauge(
                "dl4j_cache_store_bytes",
                "Payload bytes resident per artifact-store tier",
                labels=("tier",))
            g_entries = reg.gauge(
                "dl4j_cache_store_entries",
                "Artifact entries resident per artifact-store tier",
                labels=("tier",))
            for t in self.store.tiers():
                st = t.stat()
                g_bytes.labels(tier=t.tier).set(st["bytes"])
                g_entries.labels(tier=t.tier).set(st["entries"])
        except Exception:
            pass  # observability must never break the build path

    # -- read --------------------------------------------------------------
    def get(self, key: str) -> Optional[Tuple[bytes, dict]]:
        """(payload, meta) for a valid entry, else None. Corrupt entries
        are deleted with a one-time warning (a tiered store transparently
        refetches a locally corrupt entry from the remote first)."""
        entry = None
        mutated = False
        try:
            entry = self.store.get(key)
            if entry is not None and faults.active():
                # injected read fault: exercises the corrupt-entry
                # recovery path (drop + warn + rebuild) on demand
                faults.check("cache.load", key=key)
        except CorruptEntryError as e:
            self._warn_once(key, e.why)
            entry = None
            mutated = True
        except Exception as e:
            self.store.delete(key)
            self._warn_once(key, f"{type(e).__name__}: {e}")
            entry = None
            mutated = True
        if mutated:
            self._refresh_store_gauges()
        if entry is None:
            with self._lock:
                self.stats["misses"] += 1
            return None
        with self._lock:
            self.stats["hits"] += 1
        return entry

    # -- write -------------------------------------------------------------
    def put(self, key: str, payload: bytes, meta: dict) -> bool:
        """Atomic write (unique tmp + rename), then LRU cap
        enforcement on the local tier."""
        meta = _stamp_meta(payload, meta)
        if not self.store.put(key, payload, meta):
            with self._lock:
                self.stats["put_errors"] += 1
            return False
        with self._lock:
            self.stats["puts"] += 1
        evicted = self.store.enforce_cap(self.max_bytes)
        if evicted:
            with self._lock:
                self.stats["evictions"] += evicted
        self._refresh_store_gauges()
        return True

    # -- maintenance -------------------------------------------------------
    def clear(self):
        self.store.clear()
        self._refresh_store_gauges()
        return self

    def entry_count(self) -> int:
        try:
            return len(self.store.keys())
        except OSError:
            return 0


# ---------------------------------------------------------------------------
# singleton resolution (env-driven, re-resolved when the conf changes)
# ---------------------------------------------------------------------------

_CACHE: Optional[AOTCompileCache] = None
_CACHE_CONF_USED: Optional[Tuple] = None
_CACHE_LOCK = ordered_lock("cache.global")


def _store_conf() -> Tuple[Optional[str], Optional[str], str]:
    """(cache_dir, remote_cache, cache_tier) — the env triple the
    singleton is keyed on."""
    env = environment()
    return (env.cache_dir(), env.remote_cache(), env.cache_tier())


def _build_store(cache_dir: str, remote: Optional[str], tier: str):
    """Store for the resolved conf: no remote (or tier=local) keeps the
    LocalDirStore; tier=remote serves straight off the shared store;
    auto/tiered with a remote configured reads local-then-remote and
    write-populates both."""
    if tier == "local" or not remote:
        return LocalDirStore(cache_dir)
    if tier == "remote":
        return RemoteStore(remote)
    return TieredStore(LocalDirStore(cache_dir), RemoteStore(remote))


def cache() -> Optional[AOTCompileCache]:
    """The process-wide store, or None when caching is disabled
    (``DL4J_TPU_CACHE_DIR=""``). Re-resolves if the configured dir,
    remote root, or tier changed since the last call (tests,
    ``Environment.set_cache_dir`` / ``set_remote_cache`` /
    ``set_cache_tier``)."""
    global _CACHE, _CACHE_CONF_USED
    conf = _store_conf()
    if conf == _CACHE_CONF_USED:
        return _CACHE
    with _CACHE_LOCK:
        if conf != _CACHE_CONF_USED:
            d, remote, tier = conf
            if d:
                try:
                    _CACHE = AOTCompileCache(
                        d, environment().cache_max_bytes(),
                        store=_build_store(d, remote, tier))
                except OSError as e:
                    log.warning("compile cache dir %s unusable (%s); "
                                "caching disabled", d, e)
                    _CACHE = None
            else:
                _CACHE = None
            _CACHE_CONF_USED = conf
    return _CACHE


def reset_cache():
    """Drop the singleton and immediately re-resolve the store conf
    (DL4J_TPU_CACHE_DIR / _REMOTE_CACHE / _CACHE_TIER)."""
    global _CACHE, _CACHE_CONF_USED
    with _CACHE_LOCK:
        _CACHE = None
        _CACHE_CONF_USED = None
    cache()


# ---------------------------------------------------------------------------
# serving warmup-manifest handoff
# ---------------------------------------------------------------------------

def serving_manifest_dir(create: bool = True) -> Optional[str]:
    """Directory where the serving registry persists per-model warmup
    manifests so the next replica (or the incoming version of a hot swap)
    replays the shapes live traffic exercised before taking traffic.
    ``DL4J_TPU_SERVING_MANIFEST_DIR`` overrides; the default is
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


# ---------------------------------------------------------------------------
# fleet handoff: push-on-drain / pull-on-boot over the shared store
# ---------------------------------------------------------------------------

def _tiered() -> Optional[TieredStore]:
    if not environment().remote_cache():
        return None  # no shared store: resolve (and create) nothing
    cc = cache()
    if cc is not None and isinstance(cc.store, TieredStore):
        return cc.store
    return None


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
    """Publish this replica's warm state to the shared store: every local
    kernel library the remote does not have yet, plus the serving warmup
    manifests. Called by ``GracefulLifecycle.drain`` so a draining
    replica's builds outlive it; safe under concurrent pushers (unique
    tmp + atomic rename per object). No-op without a tiered store.
    ``executables`` counts the libraries pushed."""
    store = _tiered()
    if store is None:
        return {"executables": 0, "manifests": 0}
    pushed = 0
    for key in store.local.keys():
        if store.remote.contains(key):
            continue
        try:
            entry = store.local.get(key)
        except CorruptEntryError:
            continue  # deleted by the read; nothing to publish
        if entry is not None and store.remote.put(key, entry[0], entry[1]):
            pushed += 1
    manifests = _copy_manifests(serving_manifest_dir(create=False),
                                store.remote.manifest_dir(create=True))
    cc = cache()
    if cc is not None:
        cc._refresh_store_gauges()
    if pushed or manifests:
        log.info("pushed %d kernel libraries, %d manifests to remote "
                 "store", pushed, manifests)
    return {"executables": pushed, "manifests": manifests}


def pull_manifests() -> int:
    """Copy the shared store's warmup manifests into the local serving
    manifest dir (overwriting), so ``registry.deploy`` replays the fleet's
    observed shapes instead of starting blind. No-op without a tiered
    store."""
    store = _tiered()
    if store is None:
        return 0
    return _copy_manifests(store.remote.manifest_dir(create=False),
                           serving_manifest_dir(create=True))


def pull_from_remote(keys: Optional[List[str]] = None) -> Dict[str, int]:
    """Boot-time warm restore: download manifests plus every remote
    kernel library not already local (or just ``keys``) into the local
    tier. Run this *before* ``/readyz`` flips — a replica advertised
    ready with a cold store would compile under live traffic. Each fetch
    lands on ``dl4j_cache_pull_seconds``. No-op without a tiered store.
    ``executables`` counts the libraries pulled."""
    store = _tiered()
    if store is None:
        return {"executables": 0, "manifests": 0}
    manifests = pull_manifests()
    pulled = 0
    for key in (keys if keys is not None else store.remote.keys()):
        if store.local.contains(key):
            continue
        try:
            if store.get(key) is not None:  # tiered get write-populates
                pulled += 1
        except CorruptEntryError:
            pass  # deleted from the fleet store; the next build republishes
    cc = cache()
    if cc is not None:
        cc._refresh_store_gauges()
    if pulled or manifests:
        log.info("pulled %d kernel libraries, %d manifests from remote "
                 "store", pulled, manifests)
    return {"executables": pulled, "manifests": manifests}


# ---------------------------------------------------------------------------
# artifact inventory (the /debug/compile_cache endpoint)
# ---------------------------------------------------------------------------

def inventory() -> dict:
    """The artifact store as a JSON-able listing: per entry the key, tag
    kind, payload size, creation/last-use times and, for a kernel
    library, its kernel name and the ``nvcc`` version that built it;
    plus per-tier backend/entry-count/byte totals under ``"tiers"``.
    Entries (from the primary tier) sort most-recently-used first."""
    cc = cache()
    if cc is None:
        return {"enabled": False, "entries": [], "stats": {},
                "tiers": []}
    entries = []
    for key in cc.store.keys():
        meta = cc.store.entry_meta(key)
        if meta is None:
            continue
        entry = {"key": key, "tag_kind": meta.get("tag_kind"),
                 "payload_bytes": meta.get("payload_bytes"),
                 "created": meta.get("created"),
                 "last_used": cc.store.last_used(key)}
        for field in ("kernel", "nvcc"):
            if meta.get(field):
                entry[field] = meta[field]
        entries.append(entry)
    entries.sort(key=lambda e: e.get("last_used") or 0, reverse=True)
    tiers = []
    for t in cc.store.tiers():
        st = t.stat()
        tiers.append({**t.describe(), "entry_count": st["entries"],
                      "payload_bytes": st["bytes"]})
    with cc._lock:
        stats = dict(cc.stats)
    return {"enabled": True, "dir": cc.base_dir,
            "max_bytes": cc.max_bytes, "entry_count": len(entries),
            "total_payload_bytes": sum(e.get("payload_bytes") or 0
                                       for e in entries),
            "stats": stats, "tiers": tiers, "entries": entries}


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def observe_compile(kind: str, cache_label: str, seconds: float):
    """Record one materialization in ``dl4j_compile_seconds{kind,cache}``:
    a kernel library's source (``kind="kernel"``, ``cache`` ``hit`` from
    the store or ``miss`` from ``nvcc``), or a step's first run and its
    CUDA-graph capture (``cache`` ``captured``, ``eager`` or
    ``eager:<reason>``, ``runtime/cuda_graphs.py``)."""
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
