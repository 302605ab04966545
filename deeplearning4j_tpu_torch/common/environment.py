"""Runtime configuration: the layered properties of the JAX package.

Counterpart of ``deeplearning4j_tpu/common/environment.py``: every name
of its ``SystemProperties`` resolves here under the same ``DL4J_TPU_*``
variable(s) and default, so one deployment's environment configures
either package. Resolution order is the reference's: a programmatic
``set_property`` override, else the first environment variable set, else
the default.

``matmul_precision`` is applied where the JAX package applies it, in
``set_property``: "high" / "tensorfloat32" lets the f32 products inside
``nn.fit_fastpath.full_f32`` scopes (the layer API and SameDiff) run on
TF32 tensor cores; "highest" / "float32" and the default keep them in
full f32. As in the JAX package, the environment variable alone applies
nothing.

The JAX package's TPU switches (``flash_min_seq``, ``paged_kernel``,
``fused_dequant``, ``xla_cache``, ``eager_jit``) and their setters are
carried as readable properties that change nothing: in the port the
tensor's device decides, a CUDA tensor always takes the hand-written
kernel and a CPU tensor its plain PyTorch version. ``backend()``,
``num_devices()`` and ``memory_stats()`` report torch's device (a card,
or the CPU), never a TPU.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

#: property name -> (environment variable(s), default); a tuple of
#: variables means "first one set wins" (legacy spellings trail), None no
#: variable, and a None default resolves to the getter's own fallback
_PROPS: Dict[str, tuple] = {
    "dtype": (("DL4J_TPU_DEFAULT_DTYPE", "DL4J_TPU_DTYPE"), "float32"),
    "debug": ("DL4J_TPU_DEBUG", "0"),
    "verbose": ("DL4J_TPU_VERBOSE", "0"),
    "max_threads": ("DL4J_TPU_MAX_THREADS", None),
    "matmul_precision": ("DL4J_TPU_MATMUL_PRECISION", "default"),
    "nan_panic": ("DL4J_TPU_NAN_PANIC", "0"),
    "inf_panic": ("DL4J_TPU_INF_PANIC", "0"),
    "profiling": ("DL4J_TPU_PROFILING", "0"),
    "eager_jit": ("DL4J_TPU_EAGER_JIT", "1"),
    "home": ("DL4J_TPU_HOME", "~/.deeplearning4j_tpu"),
    "lock_check": ("DL4J_TPU_LOCK_CHECK", "0"),
    "resources_dir": ("ND4J_RESOURCES_DIR", None),
    "log_initialization": (None, "1"),
    "cache_max_bytes": ("DL4J_TPU_CACHE_MAX_BYTES", str(2 << 30)),
    "cache_tier": ("DL4J_TPU_CACHE_TIER", "auto"),
    "xla_cache": ("DL4J_TPU_XLA_CACHE", "auto"),
    "warmup_threads": ("DL4J_TPU_WARMUP_THREADS", "0"),
    "flash_min_seq": ("DL4J_TPU_FLASH_MIN_SEQ", "1024"),
    "paged_kernel": ("DL4J_TPU_PAGED_KERNEL", "auto"),
    "fused_dequant": ("DL4J_TPU_FUSED_DEQUANT", "auto"),
    "training_zero1": ("DL4J_TPU_ZERO1", "0"),
    "faults": ("DL4J_TPU_FAULTS", ""),
    "decode_slots": ("DL4J_TPU_DECODE_SLOTS", "8"),
    "decode_max_ctx": ("DL4J_TPU_DECODE_MAX_CTX", "256"),
    "decode_max_tokens": ("DL4J_TPU_DECODE_MAX_TOKENS", "128"),
    "kv_block_size": ("DL4J_TPU_KV_BLOCK_SIZE", None),
    "spec_draft_k": ("DL4J_TPU_SPEC_DRAFT_K", None),
    "prefix_cache": ("DL4J_TPU_PREFIX_CACHE", "1"),
    "slo_latency_ms": ("DL4J_TPU_SLO_LATENCY_MS", "0"),
    "engine_max_restarts": ("DL4J_TPU_ENGINE_MAX_RESTARTS", "5"),
    "metrics": ("DL4J_TPU_METRICS", "1"),
    "trace_buffer": ("DL4J_TPU_TRACE_BUFFER", "16384"),
    # "" = no executable/manifest volume; the default rides the user cache
    "cache_dir": ("DL4J_TPU_CACHE_DIR", "~/.cache/deeplearning4j_tpu"),
    "remote_cache": ("DL4J_TPU_REMOTE_CACHE", ""),
    # "" = quantized deploys opt-in
    "quant": ("DL4J_TPU_QUANT", ""),
    "quant_max_divergence": ("DL4J_TPU_QUANT_MAX_DIVERGENCE", "0.25"),
    "quant_min_top1": ("DL4J_TPU_QUANT_MIN_TOP1", "0.99"),
    "serving_max_concurrent": ("DL4J_TPU_SERVING_MAX_CONCURRENT", "8"),
    "serving_queue_depth": ("DL4J_TPU_SERVING_QUEUE_DEPTH", "64"),
    # 0 = auto (3/4 of the queue depth)
    "serving_high_water": ("DL4J_TPU_SERVING_HIGH_WATER", "0"),
    "serving_timeout_s": ("DL4J_TPU_SERVING_TIMEOUT_S", "30"),
    "serving_drain_timeout_s": ("DL4J_TPU_SERVING_DRAIN_TIMEOUT_S", "30"),
    "serving_retain": ("DL4J_TPU_SERVING_RETAIN", "2"),
    # "" = <cache_dir>/manifests
    "serving_manifest_dir": ("DL4J_TPU_SERVING_MANIFEST_DIR", ""),
    "slo_objective": ("DL4J_TPU_SLO_OBJECTIVE", "0.999"),
    "slo_windows": ("DL4J_TPU_SLO_WINDOWS", "300:14.4,3600:6"),
    "slo_readyz": ("DL4J_TPU_SLO_READYZ", "1"),
    "request_ring": ("DL4J_TPU_REQUEST_RING", "256"),
    "debug_endpoints": ("DL4J_TPU_DEBUG_ENDPOINTS", "1"),
    "breaker_threshold": ("DL4J_TPU_BREAKER_THRESHOLD", "5"),
    "breaker_probe_s": ("DL4J_TPU_BREAKER_PROBE_S", "1"),
    "auto_rollback": ("DL4J_TPU_AUTO_ROLLBACK", "0"),
    "auto_rollback_opens": ("DL4J_TPU_AUTO_ROLLBACK_OPENS", "2"),
    "watchdog_factor": ("DL4J_TPU_WATCHDOG_FACTOR", "3"),
    # "" = <cache_dir>/profiles and <cache_dir>/flight
    "profile_dir": ("DL4J_TPU_PROFILE_DIR", ""),
    "flight_recorder_dir": ("DL4J_TPU_FLIGHT_RECORDER_DIR", ""),
    "training_remat": ("DL4J_TPU_REMAT", "none"),
    "training_grad_accum": ("DL4J_TPU_GRAD_ACCUM", "1"),
    "inference_bucketing": ("DL4J_TPU_INFERENCE_BUCKETING", "1"),
    "inference_max_batch": ("DL4J_TPU_INFERENCE_MAX_BATCH", "128"),
    "fleet_poll_s": ("DL4J_TPU_FLEET_POLL_S", "2.0"),
    "fleet_retries": ("DL4J_TPU_FLEET_RETRIES", "1"),
    "fleet_timeout_s": ("DL4J_TPU_FLEET_TIMEOUT_S", "30.0"),
    "fleet_retry_budget": ("DL4J_TPU_FLEET_RETRY_BUDGET", "0.2"),
    "fleet_hedge_pctl": ("DL4J_TPU_FLEET_HEDGE_PCTL", "95"),
    "fleet_brownout_frac": ("DL4J_TPU_FLEET_BROWNOUT_FRAC", "0.5"),
    "fleet_default_priority": ("DL4J_TPU_FLEET_DEFAULT_PRIORITY", "5"),
    "fleet_agg_retention_s": ("DL4J_TPU_FLEET_AGG_RETENTION_S", "600"),
    "fleet_agg_max_samples": ("DL4J_TPU_FLEET_AGG_MAX_SAMPLES", "512"),
}


class SystemProperties:
    """Programmatic property keys (``ND4JSystemProperties`` analog): one
    upper-case attribute per property name, as the JAX package's."""


class EnvironmentVars:
    """The environment variables the properties read
    (``ND4JEnvironmentVars`` analog), each under its own name."""


for _name, (_envs, _) in _PROPS.items():
    setattr(SystemProperties, _name.upper(), _name)
    for _env in (_envs,) if isinstance(_envs, str) else _envs or ():
        setattr(EnvironmentVars, _env, _env)


def _int(v, default: int, lo: int) -> int:
    try:
        return max(int(v), lo)
    except (TypeError, ValueError):
        return default


def _float(v, default: float) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


class Environment:
    """Process-wide configuration singleton. Resolution order:
    ``set_property`` override > environment variable > default."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._overrides: Dict[str, str] = {}
        self._compile_lock = threading.Lock()
        self._compile_keys: set = set()
        self._compile_count = 0
        self._compile_listeners: list = []
        self._listener_errors_logged: set = set()

    @classmethod
    def get(cls) -> "Environment":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = Environment()
        return cls._instance

    def property(self, key: str, default: Optional[str] = None
                 ) -> Optional[str]:
        if key in self._overrides:
            return self._overrides[key]
        env_names, fallback = _PROPS.get(key, (None, default))
        if isinstance(env_names, str):
            env_names = (env_names,)
        for env_name in env_names or ():
            if env_name in os.environ:
                return os.environ[env_name]
        return default if fallback is None else fallback

    def set_property(self, key: str, value: Any):
        if key not in _PROPS:
            raise KeyError(f"unknown property {key!r}")
        self._overrides[key] = str(value)
        if key == "matmul_precision":
            _apply_matmul_precision(str(value))
        return self

    def property_override(self, key: str) -> Optional[str]:
        """The programmatic override for ``key``, or None when the value
        resolves from the environment variable or the default."""
        return self._overrides.get(key)

    def clear_property(self, key: str):
        """Drop a programmatic override."""
        self._overrides.pop(key, None)
        return self

    def _flag(self, key: str) -> bool:
        return self.property(key) not in ("0", "false", None)

    def _on(self, key: str) -> bool:
        """The JAX package's ``_flag``: "" reads as off too."""
        return self.property(key) not in ("0", "false", "", None)

    # -- the reference Environment getters (common/config.py reads them) --
    def is_debug(self) -> bool:
        return self._flag("debug")

    def is_verbose(self) -> bool:
        return self._flag("verbose")

    def set_debug(self, v: bool):
        return self.set_property("debug", "1" if v else "0")

    def set_verbose(self, v: bool):
        return self.set_property("verbose", "1" if v else "0")

    def max_threads(self) -> int:
        """Host threads for the data pipeline (``DL4J_TPU_MAX_THREADS``;
        unset: the CPU count)."""
        v = self.property("max_threads")
        return int(v) if v else os.cpu_count() or 1

    def default_float_dtype(self) -> str:
        """Default float dtype (``DL4J_TPU_DEFAULT_DTYPE``, the legacy
        ``DL4J_TPU_DTYPE`` second in line)."""
        return self.property("dtype")

    def set_default_float_dtype(self, dtype: str):
        return self.set_property("dtype", dtype)

    def matmul_precision(self) -> str:
        """The ``matmul_precision`` property as resolved; what the products
        run in is the level last applied by ``set_property`` (see the
        module docstring)."""
        return self.property("matmul_precision")

    def nan_panic(self) -> bool:
        """Halt on NaN outputs (reference OpExecutioner.ProfilingMode); a
        flag the port carries, as the JAX package does."""
        return self._on("nan_panic")

    def inf_panic(self) -> bool:
        return self._on("inf_panic")

    def profiling_enabled(self) -> bool:
        """Op-level profiling collection (``DL4J_TPU_PROFILING``)."""
        return self._on("profiling")

    def eager_jit(self) -> bool:
        """The JAX package's per-op jit cache toggle
        (``DL4J_TPU_EAGER_JIT``). The port compiles nothing per op, so the
        property changes nothing here."""
        return self._on("eager_jit")

    def home_dir(self) -> str:
        """Root of user-local artifacts, the pretrained-model cache
        (``DL4J_TPU_HOME``, default ``~/.deeplearning4j_tpu``)."""
        return os.path.expanduser(self.property("home")
                                  or "~/.deeplearning4j_tpu")

    def resources_dir(self) -> Optional[str]:
        """``ND4J_RESOURCES_DIR``, expanded; None when unset."""
        d = self.property("resources_dir")
        return os.path.expanduser(d) if d else None

    def lock_check(self) -> bool:
        """Whether the ``common.locks`` lock-order tracker is armed
        (``DL4J_TPU_LOCK_CHECK``; the tracker reads it at import, flip it
        at run time with ``locks.set_lock_check``)."""
        return self._on("lock_check")

    def log_initialization(self) -> bool:
        """The reference's log-on-init switch (no variable, default on)."""
        return self._on("log_initialization")

    def faults_spec(self) -> str:
        """The ``DL4J_TPU_FAULTS`` rule spec that ``faults.load_env``
        arms ("" = no injection)."""
        return self.property("faults") or ""

    def warmup_threads(self) -> int:
        """Thread-pool width for ``InferenceEngine.warmup``; 0 = auto
        (``DL4J_TPU_WARMUP_THREADS``)."""
        return _int(self.property("warmup_threads"), 0, 0)

    # -- artifact store and parallelism -----------------------------------
    def cache_max_bytes(self) -> int:
        """LRU size cap of the local artifact store's kernel libraries
        (``DL4J_TPU_CACHE_MAX_BYTES``; ``runtime/compile_cache.py``)."""
        try:
            return int(self.property("cache_max_bytes"))
        except (TypeError, ValueError):
            return 2 << 30

    def cache_tier(self) -> str:
        """Store-tier policy (``DL4J_TPU_CACHE_TIER``): "auto", "local",
        "remote" or "tiered"; ``compile_cache.cache()`` builds its store
        by it."""
        v = str(self.property("cache_tier") or "auto").lower()
        return v if v in ("auto", "local", "remote", "tiered") else "auto"

    def training_zero1(self) -> bool:
        """ZeRO-1 optimizer-state sharding (``DL4J_TPU_ZERO1``); applied by
        ``parallel.trainer.ParallelWrapper``."""
        return self.property("training_zero1") not in (
            "0", "false", "off", None)

    # -- TPU and XLA switches: read, applied to nothing ------------------
    def xla_cache(self) -> str:
        """The JAX package's ``jax_compilation_cache_dir`` policy
        (``DL4J_TPU_XLA_CACHE``). The port has no XLA; the property
        changes nothing."""
        v = str(self.property("xla_cache") or "auto").lower()
        return v if v in ("auto", "on", "off") else "auto"

    def flash_min_seq(self) -> int:
        """The JAX package's shortest sequence for its Pallas flash kernel
        (``DL4J_TPU_FLASH_MIN_SEQ``). It changes nothing in the port: a
        CUDA tensor always takes the flash kernels."""
        try:
            return int(self.property("flash_min_seq"))
        except (TypeError, ValueError):
            return 1024

    def paged_kernel(self) -> str:
        """The JAX package's Pallas paged-decode policy
        (``DL4J_TPU_PAGED_KERNEL``). It changes nothing in the port: a
        CUDA tensor always takes the paged-decode kernel."""
        v = str(self.property("paged_kernel") or "auto").lower()
        return v if v in ("auto", "on", "off") else "auto"

    def fused_dequant(self) -> str:
        """The JAX package's Pallas int8 dequant-matmul policy
        (``DL4J_TPU_FUSED_DEQUANT``). It changes nothing in the port: a
        CUDA tensor always takes the dequant-matmul kernel."""
        v = str(self.property("fused_dequant") or "auto").lower()
        return v if v in ("auto", "on", "off") else "auto"

    # -- generative decode knobs (runtime/generation.py) -------------------
    def decode_slots(self) -> int:
        """Concurrent sequences a DecodeEngine's KV cache holds — the
        continuous-batching width (``DL4J_TPU_DECODE_SLOTS``)."""
        return _int(self.property("decode_slots"), 8, 1)

    def decode_max_ctx(self) -> int:
        """Per-sequence context window (prompt + generation)
        (``DL4J_TPU_DECODE_MAX_CTX``; capped by the model's position
        table)."""
        return _int(self.property("decode_max_ctx"), 256, 2)

    def decode_max_tokens(self) -> int:
        """Default/maximum generated tokens per request when the caller
        passes no ``max_tokens`` (``DL4J_TPU_DECODE_MAX_TOKENS``)."""
        return _int(self.property("decode_max_tokens"), 128, 1)

    def kv_block_size(self) -> int:
        """Rows per KV-cache block of the paged pool
        (``DL4J_TPU_KV_BLOCK_SIZE``); engines clamp it to their context
        window."""
        return _int(self.property("kv_block_size"), 16, 1)

    def spec_draft_k(self) -> int:
        """Draft tokens proposed per speculative step
        (``DL4J_TPU_SPEC_DRAFT_K``); 0 disables speculation."""
        return _int(self.property("spec_draft_k"), 0, 0)

    def prefix_cache_enabled(self) -> bool:
        """Whether DecodeEngine reuses KV blocks across requests by token
        prefix (``DL4J_TPU_PREFIX_CACHE``, on by default)."""
        return self.property("prefix_cache") not in (
            "0", "false", "off", None)

    def engine_max_restarts(self) -> int:
        """Supervised-restart burst budget of the decode loop thread
        (``DL4J_TPU_ENGINE_MAX_RESTARTS``); <= 0 = unbounded."""
        try:
            return int(self.property("engine_max_restarts"))
        except (TypeError, ValueError):
            return 5

    # -- the typed setters and device reports of the JAX package ----------
    # Each setter writes the property its reader above resolves, with the
    # JAX package's conversion (``int()`` / ``float()`` raise on a bad
    # value, before anything is written).
    def set_decode_slots(self, n: int):
        return self.set_property("decode_slots", int(n))

    def set_decode_max_ctx(self, n: int):
        return self.set_property("decode_max_ctx", int(n))

    def set_decode_max_tokens(self, n: int):
        return self.set_property("decode_max_tokens", int(n))

    def set_kv_block_size(self, n: int):
        return self.set_property("kv_block_size", int(n))

    def set_spec_draft_k(self, n: int):
        return self.set_property("spec_draft_k", int(n))

    def set_prefix_cache(self, v: bool):
        return self.set_property("prefix_cache", "1" if v else "0")

    def set_quant_max_divergence(self, v: float):
        return self.set_property("quant_max_divergence", float(v))

    def set_training_remat(self, mode: str):
        return self.set_property("training_remat", mode)

    def set_training_grad_accum(self, k: int):
        return self.set_property("training_grad_accum", int(k))

    def set_training_zero1(self, v: bool):
        return self.set_property("training_zero1", "1" if v else "0")

    def set_auto_rollback(self, v: bool):
        return self.set_property("auto_rollback", "1" if v else "0")

    def set_cache_dir(self, d: Optional[str]):
        """Programmatic override; "" or None disables the cache volume:
        the local artifact store of kernel libraries
        (``<dir>/aot``) and the serving manifests (``<dir>/manifests``).
        ``compile_cache.cache()`` re-resolves on its next call."""
        return self.set_property("cache_dir", d or "")

    def set_remote_cache(self, d: Optional[str]):
        """Programmatic override; "" or None disables the fleet-shared
        store (a bucket mount or a warm image) that
        ``compile_cache.cache()`` tiers behind the local one, and that
        ``push_to_remote`` / ``pull_from_remote`` move libraries and
        manifests through."""
        return self.set_property("remote_cache", d or "")

    def set_cache_tier(self, tier: Optional[str]):
        """Programmatic override; None restores "auto". Picks the store
        ``compile_cache.cache()`` builds: "local" (no remote), "remote"
        (the shared store alone) or "auto"/"tiered" (local then remote,
        write-populating both)."""
        return self.set_property("cache_tier", tier or "auto")

    def set_flash_min_seq(self, n: int):
        """Stores the JAX package's flash threshold (:meth:`flash_min_seq`
        reads it back). No effect in the port: which attention runs is
        decided by the tensor's device, never by the sequence length."""
        return self.set_property("flash_min_seq", int(n))

    def set_paged_kernel(self, mode: Optional[str]):
        """Stores the JAX package's paged-decode policy; None restores
        "auto". No effect in the port: a CUDA pool always takes the
        paged-decode kernel, a CPU pool its plain version."""
        return self.set_property("paged_kernel", mode or "auto")

    def set_fused_dequant(self, mode: Optional[str]):
        """Stores the JAX package's int8 dequant-matmul policy; None
        restores "auto". No effect in the port: a CUDA tensor always
        takes the dequant-matmul kernel, a CPU tensor its plain
        version."""
        return self.set_property("fused_dequant", mode or "auto")

    def metrics_enabled(self) -> bool:
        return self.metrics().enabled

    def set_metrics_enabled(self, v: bool):
        self.set_property("metrics", "1" if v else "0")
        self.metrics().set_enabled(v)
        return self

    def backend(self) -> str:
        """The port's device platform: "cuda" where torch sees a card,
        else "cpu"."""
        import torch
        return "cuda" if torch.cuda.is_available() else "cpu"

    def num_devices(self) -> int:
        """Cards torch sees (1 for the CPU where it sees none)."""
        import torch
        return torch.cuda.device_count() if torch.cuda.is_available() \
            else 1

    def memory_stats(self) -> Dict[str, int]:
        """``torch.cuda.memory_stats()`` of the current card; {} on the
        CPU."""
        import torch
        if not torch.cuda.is_available():
            return {}
        return {k: int(v) for k, v in torch.cuda.memory_stats().items()}

    # -- telemetry (common/metrics.py, common/tracing.py) ------------------
    def metrics(self):
        """The process-wide MetricsRegistry (``DL4J_TPU_METRICS`` gates
        every instrumentation write)."""
        from .metrics import registry
        return registry()

    def trace_buffer(self) -> int:
        """Span ring-buffer capacity (``DL4J_TPU_TRACE_BUFFER``)."""
        return _int(self.property("trace_buffer"), 16384, 1)


    # -- inference-serving knobs (runtime/inference.py) --------------------
    def inference_bucketing(self) -> bool:
        """Whether batched inference pads the batch dim up to a bucket of
        the ladder (``DL4J_TPU_INFERENCE_BUCKETING``, on by default;
        exact shapes when off)."""
        return self._flag("inference_bucketing")

    def set_inference_bucketing(self, v: bool):
        return self.set_property("inference_bucketing", "1" if v else "0")

    def inference_max_batch(self) -> int:
        """Top rung of the default bucket ladder for the direct
        ``output()``/``predict()`` paths (``DL4J_TPU_INFERENCE_MAX_BATCH``)."""
        return _int(self.property("inference_max_batch"), 128, 1)

    def set_inference_max_batch(self, n: int):
        return self.set_property("inference_max_batch", int(n))

    # -- dispatch census (runtime/inference.py counted_dispatch) ------------
    # One event = one new (tag, padded input signature) pair reaching an
    # inference entry or a decode step. The JAX package counts XLA
    # compiles here; the port counts the signatures it captures as CUDA
    # graphs (runtime/cuda_graphs.py), or runs eagerly. The ladder
    # invariant holds unchanged: K distinct request batch sizes give at
    # most ceil(log2(max_batch)) + 1 events per network.

    def record_compile(self, key, cache: str = "eager") -> bool:
        """Register a first-seen dispatch signature; returns False if
        ``key`` was already seen. New keys notify the listeners and bump
        ``dl4j_compiles_total{kind,cache}`` (``cache="captured"``: one
        CUDA graph replays it; ``"eager"``: the signature runs eagerly,
        on the CPU or with no graph; ``"eager:<reason>"``: its capture
        was refused, or its collectives cross ranks)."""
        with self._compile_lock:
            if key in self._compile_keys:
                return False
            self._compile_keys.add(key)
            self._compile_count += 1
            listeners = list(self._compile_listeners)
        try:
            from .metrics import registry
            kind = key[0] if isinstance(key, (tuple, list)) and key else key
            registry().counter(
                "dl4j_compiles_total",
                "First-seen dispatch signatures recorded by "
                "counted_dispatch",
                labels=("kind", "cache")).labels(
                    kind=str(kind).split(":")[0], cache=cache).inc()
        except Exception:
            pass  # observability must never break the inference path
        for fn in listeners:
            try:
                fn(key)
            except Exception:
                # swallowed so a bad listener cannot break serving; logged
                # once per listener
                if id(fn) not in self._listener_errors_logged:
                    self._listener_errors_logged.add(id(fn))
                    import logging
                    logging.getLogger(__name__).exception(
                        "dispatch listener %r raised (logged once; later "
                        "exceptions from it are dropped)", fn)
        return True

    def compile_count(self) -> int:
        return self._compile_count

    def reset_compile_count(self):
        """Zero the census and forget its keys."""
        with self._compile_lock:
            self._compile_keys.clear()
            self._compile_count = 0
        return self

    def add_compile_listener(self, fn: Callable[[Any], None]):
        """``fn(key)`` is called once per new census event."""
        with self._compile_lock:
            self._compile_listeners.append(fn)
        return self

    def remove_compile_listener(self, fn: Callable[[Any], None]):
        with self._compile_lock:
            if fn in self._compile_listeners:
                self._compile_listeners.remove(fn)
        return self

    # -- fleet routing (serving/fleet) ------------------------------------
    def fleet_poll_s(self) -> float:
        """FleetRouter replica-poll interval in seconds
        (``DL4J_TPU_FLEET_POLL_S``): how often each replica's ``/readyz``
        and ``/metrics.json`` are refreshed for the least-loaded score."""
        return max(_float(self.property("fleet_poll_s"), 2.0), 0.05)

    def fleet_retries(self) -> int:
        """Failover retries on a *different* replica after a
        replica-level failure: 503, connection refused, timeout
        (``DL4J_TPU_FLEET_RETRIES``)."""
        return _int(self.property("fleet_retries"), 1, 0)

    def fleet_timeout_s(self) -> float:
        """Per-attempt HTTP timeout of routed requests
        (``DL4J_TPU_FLEET_TIMEOUT_S``)."""
        return max(_float(self.property("fleet_timeout_s"), 30.0), 0.1)

    def fleet_retry_budget(self) -> float:
        """Fleet retry-budget ratio (``DL4J_TPU_FLEET_RETRY_BUDGET``):
        failovers and hedges may add at most this fraction of recent
        primary dispatches; 0 = one request, one attempt."""
        return min(max(_float(self.property("fleet_retry_budget"), 0.2),
                       0.0), 1.0)

    def fleet_hedge_pctl(self) -> float:
        """Percentile of the router's observed per-model dispatch
        latencies used as the hedge delay (``DL4J_TPU_FLEET_HEDGE_PCTL``);
        <= 0 disables hedging."""
        return min(_float(self.property("fleet_hedge_pctl"), 95.0), 100.0)

    def fleet_brownout_frac(self) -> float:
        """Ready-capacity fraction below which the front door browns out
        (``DL4J_TPU_FLEET_BROWNOUT_FRAC``); <= 0 disables brownout."""
        return min(max(_float(self.property("fleet_brownout_frac"), 0.5),
                       0.0), 1.0)

    def fleet_default_priority(self) -> int:
        """Priority of a request without ``X-Priority``
        (``DL4J_TPU_FLEET_DEFAULT_PRIORITY``), clamped to [0, 9]."""
        return min(_int(self.property("fleet_default_priority"), 5, 0), 9)

    def fleet_agg_retention_s(self) -> float:
        """Seconds the fleet aggregator's signal ring keeps
        (``DL4J_TPU_FLEET_AGG_RETENTION_S``)."""
        return max(_float(self.property("fleet_agg_retention_s"), 600.0),
                   1.0)

    def fleet_agg_max_samples(self) -> int:
        """Hard cap on samples in the aggregator's signal ring
        (``DL4J_TPU_FLEET_AGG_MAX_SAMPLES``)."""
        return _int(self.property("fleet_agg_max_samples"), 512, 1)

    # -- training knobs (nn/fit_fastpath.py) --------------------------------
    def training_remat(self) -> str:
        """Default activation-checkpointing policy of layer-API training:
        "none" | "layer" | "dots_saveable" (``DL4J_TPU_REMAT``)."""
        return self.property("training_remat") or "none"

    def training_grad_accum(self) -> int:
        """Default gradient-accumulation factor when a network conf leaves
        grad_accum unset (``DL4J_TPU_GRAD_ACCUM``)."""
        return _int(self.property("training_grad_accum"), 1, 1)

    # -- executable/manifest volume (runtime/compile_cache.py) -------------
    def cache_dir(self) -> Optional[str]:
        """Root of the persistent cache volume, expanded; None when it is
        disabled (``DL4J_TPU_CACHE_DIR=""``): kernel libraries under
        ``aot/`` and serving manifests under ``manifests/``."""
        d = self.property("cache_dir")
        return os.path.expanduser(d) if d else None

    def remote_cache(self) -> Optional[str]:
        """Root of the fleet-shared artifact store, expanded
        (``DL4J_TPU_REMOTE_CACHE``); None when none is configured."""
        d = self.property("remote_cache")
        return os.path.expanduser(d) if d else None

    # -- quantized-serving knobs (quant/, serving/registry.py) -------------
    def quant_mode(self) -> str:
        """Fleet default for ``ModelRegistry.deploy(quantize=None)``: ""
        (off), "int8" or "fp8" (``DL4J_TPU_QUANT``; truthy spellings map to
        int8)."""
        v = (self.property("quant") or "").strip().lower()
        if v in ("", "0", "off", "none", "false"):
            return ""
        if v in ("1", "true", "on"):
            return "int8"
        return v

    def set_quant_mode(self, mode: str):
        return self.set_property("quant", mode or "")

    def quant_max_divergence(self) -> float:
        """Divergence-gate budget: the largest logit abs error a quantized
        twin may show against its full-precision original on the gate
        batch (``DL4J_TPU_QUANT_MAX_DIVERGENCE``)."""
        return max(_float(self.property("quant_max_divergence"), 0.25), 0.0)

    def quant_min_top1(self) -> float:
        """Divergence-gate floor on top-1 (and, for generative models,
        per-token) agreement (``DL4J_TPU_QUANT_MIN_TOP1``)."""
        return min(max(_float(self.property("quant_min_top1"), 0.99), 0.0),
                   1.0)

    def set_quant_min_top1(self, v: float):
        return self.set_property("quant_min_top1", float(v))

    # -- model serving knobs (serving/) ------------------------------------
    def serving_max_concurrent(self) -> int:
        """Per-model concurrent-dispatch limit of the admission controller
        (``DL4J_TPU_SERVING_MAX_CONCURRENT``)."""
        return _int(self.property("serving_max_concurrent"), 8, 1)

    def serving_queue_depth(self) -> int:
        """Hard bound on requests waiting for a dispatch slot per model
        (``DL4J_TPU_SERVING_QUEUE_DEPTH``); arrivals beyond it shed."""
        return _int(self.property("serving_queue_depth"), 64, 1)

    def serving_high_water(self) -> int:
        """Queue depth at which load shedding engages
        (``DL4J_TPU_SERVING_HIGH_WATER``); <= 0 resolves to 3/4 of
        ``serving_queue_depth``."""
        try:
            hw = int(self.property("serving_high_water"))
        except (TypeError, ValueError):
            hw = 0
        if hw <= 0:
            hw = max(1, (3 * self.serving_queue_depth()) // 4)
        return hw

    def serving_default_timeout_s(self) -> Optional[float]:
        """Default per-request deadline in seconds
        (``DL4J_TPU_SERVING_TIMEOUT_S``); <= 0 means none."""
        t = _float(self.property("serving_timeout_s"), 30.0)
        return t if t > 0 else None

    def serving_drain_timeout_s(self) -> float:
        """How long a graceful drain waits for in-flight work
        (``DL4J_TPU_SERVING_DRAIN_TIMEOUT_S``)."""
        return max(_float(self.property("serving_drain_timeout_s"), 30.0),
                   0.0)

    def serving_retain(self) -> int:
        """Previous model versions the registry keeps warm for rollback
        (``DL4J_TPU_SERVING_RETAIN``)."""
        return _int(self.property("serving_retain"), 2, 0)

    def serving_manifest_dir(self) -> Optional[str]:
        """Explicit warmup-manifest directory
        (``DL4J_TPU_SERVING_MANIFEST_DIR``); None defers to
        ``runtime.compile_cache.serving_manifest_dir``."""
        d = self.property("serving_manifest_dir")
        return os.path.expanduser(d) if d else None

    # -- SLO / debug-observability knobs (serving/slo.py, /debug/*) --------
    def slo_objective(self) -> float:
        """Per-model success-rate objective (``DL4J_TPU_SLO_OBJECTIVE``)."""
        return min(max(_float(self.property("slo_objective"), 0.999), 0.0),
                   0.999999)

    def slo_latency_s(self) -> Optional[float]:
        """Optional per-request latency (for generation: TTFT) objective
        in seconds (``DL4J_TPU_SLO_LATENCY_MS``); <= 0 (default) means
        only errors and deadline misses count against the SLO."""
        ms = _float(self.property("slo_latency_ms"), 0.0)
        return ms / 1e3 if ms > 0 else None

    def slo_windows(self):
        """Multi-window burn-rate policy (``DL4J_TPU_SLO_WINDOWS`` =
        ``"<seconds>:<burn>,..."``): ((window_s, burn), ...) sorted short
        to long."""
        out = []
        for part in (self.property("slo_windows") or "").split(","):
            if ":" not in part:
                continue
            w, b = part.split(":", 1)
            try:
                out.append((float(w), float(b)))
            except ValueError:
                continue
        if not out:
            out = [(300.0, 14.4), (3600.0, 6.0)]
        return tuple(sorted(out))

    def slo_gate_readyz(self) -> bool:
        """Whether a fast-burning SLO flips ``/readyz`` to 503
        (``DL4J_TPU_SLO_READYZ``, on by default)."""
        return self._flag("slo_readyz")

    def request_ring_size(self) -> int:
        """Capacity of the recent-requests ring behind
        ``/debug/requests`` and the flight recorder
        (``DL4J_TPU_REQUEST_RING``)."""
        return _int(self.property("request_ring"), 256, 1)

    def debug_endpoints_enabled(self) -> bool:
        """Whether ``/debug/*`` is served (``DL4J_TPU_DEBUG_ENDPOINTS``, on
        by default)."""
        return self._flag("debug_endpoints")

    def profile_dir(self) -> str:
        """Where ``/debug/profile`` captures land
        (``DL4J_TPU_PROFILE_DIR``); defaults under the cache dir, else the
        system tmpdir."""
        d = self.property("profile_dir")
        if d:
            return os.path.expanduser(d)
        base = self.cache_dir()
        if base:
            return os.path.join(base, "profiles")
        import tempfile
        return os.path.join(tempfile.gettempdir(), "dl4j_tpu_profiles")

    def flight_recorder_dir(self) -> Optional[str]:
        """Where SIGTERM/SIGQUIT flight-recorder dumps land
        (``DL4J_TPU_FLIGHT_RECORDER_DIR``); defaults under the cache dir;
        None (recorder off) when neither is set."""
        d = self.property("flight_recorder_dir")
        if d:
            return os.path.expanduser(d)
        base = self.cache_dir()
        return os.path.join(base, "flight") if base else None

    # -- resilience knobs (serving/resilience.py, serving/registry.py) -----
    def breaker_threshold(self) -> int:
        """Consecutive dispatch failures that open a model version's
        circuit breaker (``DL4J_TPU_BREAKER_THRESHOLD``)."""
        return _int(self.property("breaker_threshold"), 5, 1)

    def breaker_probe_s(self) -> float:
        """How long an open breaker fails fast before one half-open probe
        (``DL4J_TPU_BREAKER_PROBE_S``)."""
        return max(_float(self.property("breaker_probe_s"), 1.0), 0.001)

    def auto_rollback(self) -> bool:
        """Whether a persistently open breaker with a warm parked previous
        version rolls back (``DL4J_TPU_AUTO_ROLLBACK``, off by default)."""
        return self._flag("auto_rollback")

    def auto_rollback_opens(self) -> int:
        """Consecutive breaker opens that count as persistently open
        (``DL4J_TPU_AUTO_ROLLBACK_OPENS``)."""
        return _int(self.property("auto_rollback_opens"), 2, 1)

    def watchdog_factor(self) -> float:
        """Dispatch-watchdog budget as a multiple of the default serving
        deadline (``DL4J_TPU_WATCHDOG_FACTOR``); <= 0 disables it."""
        return _float(self.property("watchdog_factor"), 3.0)

#: the level ``set_property("matmul_precision", ...)`` last applied: True
#: lets ``full_f32`` scopes run f32 products on TF32 tensor cores
_TF32 = False
#: the process's TF32 flags before the first explicit level, which the
#: default level restores
_FLAGS_BEFORE = None

_TF32_LEVELS = ("high", "tensorfloat32")
_F32_LEVELS = ("highest", "float32")
_DEFAULT_LEVELS = ("default", "bfloat16", "fastest")


def _apply_matmul_precision(precision: str):
    """Map a JAX precision level onto the TF32 flags. "default" keeps the
    port's behaviour (full f32 in ``full_f32`` scopes, the flags as they
    were elsewhere): on a TPU it means bf16 passes, a fact of the MXU the
    port does not carry over. An unknown level applies nothing, as in the
    JAX package."""
    global _TF32, _FLAGS_BEFORE
    import torch
    if precision not in _TF32_LEVELS + _F32_LEVELS + _DEFAULT_LEVELS:
        return
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if precision in _DEFAULT_LEVELS:
        _TF32 = False
        if _FLAGS_BEFORE is not None:
            flags, _FLAGS_BEFORE = _FLAGS_BEFORE, None
    else:
        if _FLAGS_BEFORE is None:
            _FLAGS_BEFORE = flags
        _TF32 = precision in _TF32_LEVELS
        flags = (_TF32, _TF32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def tf32_applied() -> bool:
    """Whether the applied ``matmul_precision`` level allows TF32."""
    return _TF32


def environment() -> Environment:
    return Environment.get()
