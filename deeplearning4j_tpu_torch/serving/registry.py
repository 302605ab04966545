"""Versioned multi-model registry with warm-before-cutover hot swap.

Counterpart of the JAX package's ``serving/registry.py``: each deployed
version runs behind the port's ``InferenceEngine`` (a layer-API network:
a ``MultiLayerNetwork`` or a ``ComputationGraph``; or a ``SameDiff``
graph deployed with ``outputs=[...]``) or ``DecodeEngine`` (a generative
model).

1. ``deploy(name, version, model)`` builds the version's engine and warms
   it BEFORE any traffic sees it: an ``InferenceEngine`` runs its bucket
   ladder, replaying (in priority order) the explicit ``example``, the
   live traffic shapes of the outgoing version
   (``InferenceEngine.observed_entries()``) or the on-disk warmup
   manifest a previous replica saved; a ``DecodeEngine`` runs one
   prefill per prompt bucket and batch rung, plus the decode step. A
   quantized deploy (``quantize="int8"``/``"fp8"``/a ``QuantSpec``)
   calibrates and quantizes the model on its own device first, and the
   twin must pass the divergence gate (``quant.validate``) between
   warmup and cutover.
2. The registry then atomically repoints the model's current version.
   The outgoing engine drains its in-flight requests and is *parked*
   (drained, but retained warm) so that…
3. ``rollback(name)`` repoints to the previous retained version at once.
   Retention is bounded by ``DL4J_TPU_SERVING_RETAIN``; evicted versions
   are closed for good.

``predict()`` (micro-batched) and ``generate()`` route a request to the
current (or a pinned) version and retry a request that raced a cutover.
Each dispatch is accounted against the version's circuit breaker
(``resilience.CircuitBreaker``), with the JAX package's env-gated
auto-rollback.

A sharded deploy (``mesh=``, ``param_spec=``) is made on every rank of
the mesh with the same arguments; the mesh's first rank serves it, the
others follow its steps (``runtime/sharded.py``).
"""
from __future__ import annotations

import logging
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence

from ..common.environment import environment
from ..common.locks import ordered_rlock
from ..common.mesh import mesh_shape, spec_desc
from ..common.metrics import registry as metrics_registry
from ..common.tracing import span
from ..quant.calibrate import QuantSpec, calibrate as quant_calibrate
from ..quant.calibrate import ids_on, model_device
from ..quant.transforms import (param_bytes_of, precision_of_model,
                                quantize_model)
from ..quant.validate import validate as quant_validate
from ..runtime import compile_cache
from ..runtime.generation import DecodeEngine, is_generative_model
from ..runtime.inference import (EngineClosedError, InferenceEngine,
                                 _make_adapter)
from . import resilience
from .resilience import CircuitBreaker

log = logging.getLogger(__name__)

#: ModelVersion lifecycle states
WARMING = "warming"   # deployed but not yet warmed: /readyz stays false
READY = "ready"       # warmed and serving (or parked warm for rollback)
RETIRED = "retired"   # drained after a cutover/rollback; warm, re-admittable


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", name)


class ModelVersion:
    """One deployed (name, version) pair and its serving engine."""

    __slots__ = ("name", "version", "engine", "state", "deployed_at",
                 "precision", "param_bytes", "divergence", "mesh_shape",
                 "param_spec")

    def __init__(self, name: str, version: str, engine):
        self.name = name
        self.version = version
        self.engine = engine
        self.state = WARMING
        self.deployed_at = time.time()
        #: serving precision ("float32"/"bfloat16"/"int8"/"fp8") and param
        #: footprint, filled by deploy() for every version (quantized or
        #: not); divergence is the gate report of a quantized deploy
        self.precision: Optional[str] = None
        self.param_bytes: Optional[int] = None
        self.divergence: Optional[Dict[str, float]] = None
        #: sharded deploys only: {"data": d, "model": m} and the spec's
        #: description ("auto(model)", "P(None, 'model')", ...)
        self.mesh_shape: Optional[Dict[str, int]] = None
        self.param_spec: Optional[str] = None

    def describe(self) -> Dict[str, Any]:
        d = {"version": self.version, "state": self.state,
             "deployed_at": self.deployed_at,
             "buckets": list(self.engine.ladder),
             "max_batch": self.engine.max_batch,
             "generative": isinstance(self.engine, DecodeEngine),
             "precision": self.precision,
             "param_bytes": self.param_bytes}
        if self.mesh_shape is not None:
            d["mesh_shape"] = dict(self.mesh_shape)
            d["param_spec"] = self.param_spec
        if self.divergence is not None:
            d["quant_divergence"] = self.divergence
        return d


class ModelRegistry:
    """Named, versioned models behind one object; thread-safe."""

    def __init__(self, *, retain: Optional[int] = None,
                 manifest_dir: Optional[str] = "auto",
                 breaker_threshold: Optional[int] = None,
                 breaker_probe_s: Optional[float] = None):
        self.retain = (environment().serving_retain()
                       if retain is None else int(retain))
        # "auto" = ride the executable cache volume; None disables disk
        # manifests entirely (hot-swap handoff still works in-process)
        if manifest_dir == "auto":
            # with a fleet store configured, sync down the fleet's
            # observed-traffic manifests first so deploy() warms the
            # shapes other replicas served, not just this machine's past
            try:
                compile_cache.pull_manifests()
            except Exception:
                log.exception("fleet manifest pull failed; using local "
                              "manifests only")
            self._manifest_dir = compile_cache.serving_manifest_dir()
        else:
            self._manifest_dir = manifest_dir
        self._lock = ordered_rlock("registry")
        self._versions: Dict[str, List[ModelVersion]] = {}
        self._current: Dict[str, ModelVersion] = {}
        self._draining = False
        # per-version circuit breakers (None knobs = env defaults) and
        # the one-shot auto-rollback guard per (model, version)
        self._breaker_threshold = breaker_threshold
        self._breaker_probe_s = breaker_probe_s
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        self._auto_rolled: set = set()
        reg = metrics_registry()
        self._m_deploys = reg.counter(
            "dl4j_serving_deploys_total", "Model versions deployed",
            labels=("model",))
        self._m_rollbacks = reg.counter(
            "dl4j_serving_rollbacks_total", "Model rollbacks",
            labels=("model",))
        self._m_auto_rollbacks = reg.counter(
            "dl4j_auto_rollbacks_total",
            "Rollbacks triggered by a persistently open circuit breaker",
            labels=("model",))
        self._m_model_bytes = reg.gauge(
            "dl4j_model_bytes",
            "Parameter bytes at rest of a deployed model version",
            labels=("model", "version"))
        self._m_quant_deploys = reg.counter(
            "dl4j_quant_deploys_total",
            "Quantized deploys that passed the divergence gate",
            labels=("model", "mode"))

    # -- manifests --------------------------------------------------------
    def manifest_path(self, name: str) -> Optional[str]:
        """Per-model warmup-manifest file (shared across versions: the
        incoming version replays what the model — not the executable —
        was serving)."""
        if not self._manifest_dir:
            return None
        return os.path.join(self._manifest_dir,
                            f"{_safe_name(name)}.warmup.json")

    def save_manifests(self) -> List[str]:
        """Persist the current versions' observed traffic shapes so the
        next replica warms before taking traffic. Returns written paths."""
        written = []
        with self._lock:
            currents = list(self._current.values())
        for mv in currents:
            path = mv.engine.manifest_path
            if not path:
                continue
            try:
                written.append(mv.engine.save_manifest(path))
            except (OSError, ValueError) as e:
                log.warning("warmup manifest save for %s:%s failed (%s)",
                            mv.name, mv.version, e)
        return written

    # -- deployment -------------------------------------------------------
    def deploy(self, name: str, version: str, model, *,
               outputs: Optional[Sequence[Any]] = None,
               max_batch: Optional[int] = None,
               buckets: Optional[Sequence[int]] = None,
               max_delay_ms: float = 2.0,
               warm: bool = True,
               example=None,
               batch_sizes: Optional[Sequence[int]] = None,
               drain_timeout_s: Optional[float] = None,
               decode_slots: Optional[int] = None,
               decode_max_ctx: Optional[int] = None,
               decode_prompt_buckets: Optional[Sequence[int]] = None,
               decode_eos_token: Optional[int] = None,
               decode_kv_block_size: Optional[int] = None,
               decode_kv_blocks: Optional[int] = None,
               decode_prefill_batch: Optional[int] = None,
               decode_draft_model=None,
               decode_spec_k: Optional[int] = None,
               decode_prefix_cache: Optional[bool] = None,
               quantize=None,
               calibration_batch=None,
               quant_max_divergence: Optional[float] = None,
               quant_min_top1: Optional[float] = None,
               mesh=None,
               param_spec=None) -> ModelVersion:
        """Deploy ``model`` as ``name``:``version`` with warm-before-
        cutover; returns the new (current) ModelVersion.

        A layer-API network (``nn.MultiLayerNetwork``) deploys behind an
        ``InferenceEngine`` sized by ``max_batch``, ``buckets`` and
        ``max_delay_ms``; with ``warm=True`` (default) it runs its
        buckets before the swap, from the first available source:
        ``example`` (optionally narrowed by ``batch_sizes``) > the live
        observed shapes of the outgoing version > the model's on-disk
        warmup manifest. A model that follows the generative protocol
        (``models.causal_lm.CausalLM``) deploys behind a ``DecodeEngine``
        on the model's own device; the ``decode_*`` knobs size its slot
        count, context window, prompt bucket ladder, default EOS, paged
        KV pool, prefill batch, speculative draft and prefix cache (env
        defaults otherwise), and warmup runs every step shape.
        ``warm=False`` cuts over in the ``warming`` state and
        ``/readyz`` stays false until ``warm()``. The outgoing version
        drains in-flight requests and is parked warm for rollback.

        ``quantize`` opts this deploy into post-training quantization:
        ``True``/``"int8"``/``"fp8"`` pick the storage mode, a
        :class:`~deeplearning4j_tpu_torch.quant.QuantSpec` is used as-is,
        ``None`` defers to ``DL4J_TPU_QUANT`` (off by default), ``False``
        forces full precision. A quantized deploy REQUIRES a gate batch
        (``calibration_batch`` or ``example``: token ids ``[B, T]`` or a
        network's input batch), moved to the model's device once, and
        runs the divergence gate between
        warmup and cutover: ``QuantizationRejectedError`` aborts the swap
        with the incoming engine closed and the current version still
        live. ``quant_max_divergence``/``quant_min_top1`` override the env
        budgets for this deploy only.

        A ``SameDiff`` graph deploys behind an ``InferenceEngine`` with
        ``outputs=`` (the variable names to serve); its requests are
        placeholder dicts.

        ``mesh`` deploys the version *sharded* over a mesh built with
        :func:`~deeplearning4j_tpu_torch.common.mesh.serving_mesh`,
        after quantization: a generative model's params take the
        Megatron layout over ``model`` (``param_spec=None``) or are
        stored under ``param_spec`` (a single ``P`` or a tree of them)
        and gathered at use, its paged KV pool splits its heads over
        ``model``; a predict model's params are stored per
        ``param_spec`` (None: the last dim that divides over ``model``)
        and gathered at use, its batches split over ``data``. Every rank
        of the mesh deploys with the same arguments; the first serves,
        the others follow (``runtime/sharded.py``)."""
        name, version = str(name), str(version)
        with self._lock:
            if self._draining:
                raise RuntimeError("registry is draining; no new deploys")
            for mv in self._versions.get(name, ()):
                if mv.version == version:
                    raise ValueError(
                        f"model '{name}' version '{version}' is already "
                        "deployed (versions are immutable; bump the "
                        "version)")
            outgoing = self._current.get(name)
        generative = is_generative_model(model)
        if not generative:
            _make_adapter(model, outputs)  # an unservable model raises
        device = model_device(model)
        # -- optional PTQ: quantize BEFORE the engine is built, fail closed
        # on a missing gate batch (nothing allocated yet)
        full_model, spec, mode = model, None, quantize
        if isinstance(mode, QuantSpec):
            spec, mode = mode, mode.mode
        if mode is None:
            mode = environment().quant_mode() or None
        if mode is True:
            mode = "int8"
        elif mode is False or mode == "":
            mode = None
        gate_batch = (calibration_batch if calibration_batch is not None
                      else example)
        if mode:
            if gate_batch is None:
                raise ValueError(
                    f"deploy of '{name}:{version}' with quantize={mode!r} "
                    "needs a calibration_batch (or example) to run the "
                    "divergence gate — refusing to serve an unvalidated "
                    "quantized model")
            # the gate batch goes to the model's device once; calibration
            # and the gate both read it there
            gate_batch = ids_on(gate_batch, device)
            if spec is None:
                spec = quant_calibrate(full_model, gate_batch, mode=mode)
            # the twin lands on the full model's device: a CPU deploy
            # never reaches for a card, a card deploy never lands on the
            # CPU
            model = quantize_model(full_model, spec, device=device)
        if generative:
            engine = DecodeEngine(model, slots=decode_slots,
                                  max_ctx=decode_max_ctx,
                                  prompt_buckets=decode_prompt_buckets,
                                  eos_token=decode_eos_token,
                                  kv_block_size=decode_kv_block_size,
                                  kv_blocks=decode_kv_blocks,
                                  prefill_batch=decode_prefill_batch,
                                  draft_model=decode_draft_model,
                                  spec_k=decode_spec_k,
                                  prefix_cache=decode_prefix_cache,
                                  model_name=name, device=device,
                                  mesh=mesh, param_spec=param_spec)
        else:
            engine = InferenceEngine(model, max_batch=max_batch,
                                     buckets=buckets,
                                     max_delay_ms=max_delay_ms,
                                     outputs=outputs,
                                     manifest_path=self.manifest_path(name),
                                     mesh=mesh, param_spec=param_spec)
        mv = ModelVersion(name, version, engine)
        if mesh is not None:
            mv.mesh_shape = mesh_shape(mesh)
            mv.param_spec = spec_desc(param_spec)
        mv.precision = precision_of_model(model)
        mv.param_bytes = param_bytes_of(model)
        if warm:
            try:
                self._warm_engine(engine, outgoing, example, batch_sizes)
            except BaseException:
                # a deploy that dies mid-warmup must not leak the incoming
                # engine's worker thread / decode slots — it never became
                # current, so nobody else will ever close it
                engine.close(0.0)
                raise
            mv.state = READY
        if mode:
            # the divergence gate runs AFTER warmup and BEFORE cutover: a
            # rejected twin aborts the swap (engine closed, nothing
            # registered) with the full-precision current version live
            try:
                mv.divergence = quant_validate(
                    full_model, model, gate_batch,
                    max_divergence=quant_max_divergence,
                    min_top1=quant_min_top1,
                    model_name=name, version=version)
            except BaseException:
                engine.close(0.0)
                raise
        # atomic cutover: one pointer swap under the lock
        with self._lock:
            if self._draining:
                engine.close(0.0)
                raise RuntimeError("registry is draining; no new deploys")
            self._versions.setdefault(name, []).append(mv)
            self._current[name] = mv
        self._m_deploys.labels(model=name).inc()
        if mv.param_bytes is not None:
            self._m_model_bytes.labels(
                model=name, version=version).set(mv.param_bytes)
        if mode:
            self._m_quant_deploys.labels(model=name, mode=mode).inc()
        self._watch(mv)
        # the outgoing engine finishes its in-flight work, then parks
        if outgoing is not None:
            outgoing.engine.drain(
                drain_timeout_s if drain_timeout_s is not None
                else environment().serving_drain_timeout_s())
            outgoing.state = RETIRED
            self._unwatch(outgoing)
        self._prune(name)
        log.info("deployed %s:%s (%s)%s", name, version, mv.state,
                 f", replacing {outgoing.version}" if outgoing else "")
        return mv

    @staticmethod
    def _warm_engine(engine, outgoing: Optional[ModelVersion],
                     example, batch_sizes) -> List[int]:
        if isinstance(engine, DecodeEngine):
            # generative warmup is fully shape-determined: prefill bucket
            # ladder + the one decode step; nothing to replay from traffic
            return engine.warmup()
        if example is not None:
            return engine.warmup(example, batch_sizes=batch_sizes)
        if outgoing is not None and isinstance(outgoing.engine,
                                               InferenceEngine):
            entries = outgoing.engine.observed_entries()
            if entries:
                return engine.warmup(entries=entries)
        return engine.warmup()  # on-disk manifest of a previous replica

    def warm(self, name: str, example=None,
             batch_sizes: Optional[Sequence[int]] = None) -> List[int]:
        """Warm the *current* version of ``name`` (the deferred half of a
        ``deploy(warm=False)``) and flip it ready."""
        mv = self.get(name)
        buckets = self._warm_engine(mv.engine, None, example, batch_sizes)
        mv.state = READY
        return buckets

    # -- resolution -------------------------------------------------------
    def get(self, name: str, version: Optional[str] = None) -> ModelVersion:
        """The current ModelVersion of ``name``, or a pinned version.
        Raises KeyError when unknown."""
        with self._lock:
            if version is None:
                mv = self._current.get(name)
                if mv is None:
                    raise KeyError(f"no model '{name}' deployed")
                return mv
            for mv in self._versions.get(name, ()):
                if mv.version == str(version):
                    return mv
        raise KeyError(f"model '{name}' has no version '{version}'")

    def models(self) -> Dict[str, Dict[str, Any]]:
        """Listing for ``GET /v1/models``."""
        with self._lock:
            return {name: {
                "current": self._current[name].version
                if name in self._current else None,
                "versions": [mv.describe() for mv in versions],
            } for name, versions in sorted(self._versions.items())}

    def decode_snapshots(self) -> List[Dict[str, Any]]:
        """Live decode-engine state for ``GET /debug/decode`` and the
        flight recorder: one entry per generative model, the current
        version's slot map, block tables, pool occupancy, queue depth,
        and speculative acceptance (``DecodeEngine.debug_snapshot()``)."""
        with self._lock:
            currents = sorted(self._current.items())
        out = []
        for name, mv in currents:
            snap_fn = getattr(mv.engine, "debug_snapshot", None)
            if callable(snap_fn):
                snap = snap_fn()
                snap["model"] = name
                snap["version"] = mv.version
                out.append(snap)
        return out

    def ready(self) -> bool:
        """Readiness: not draining, and every deployed model's current
        version is warmed. (An empty registry is ready — liveness is
        /healthz's job.)"""
        with self._lock:
            return not self._draining and all(
                mv.state == READY for mv in self._current.values())

    # -- dispatch watchdog -------------------------------------------------
    @staticmethod
    def _watch(mv: ModelVersion):
        """Register the (now current) version's engine with the dispatch
        watchdog: a dispatch stuck past deadline × factor marks it
        unhealthy and flips /readyz. No-op when the watchdog is disabled
        (DL4J_TPU_WATCHDOG_FACTOR <= 0)."""
        budget = resilience.watchdog_budget_s()
        if budget is not None:
            resilience.watchdog().register(f"{mv.name}:{mv.version}",
                                           mv.engine, budget)

    @staticmethod
    def _unwatch(mv: ModelVersion):
        resilience.watchdog().unregister(f"{mv.name}:{mv.version}")

    # -- circuit breakers -------------------------------------------------
    def breaker_for(self, name: str, version: str) -> CircuitBreaker:
        """The (lazily created) circuit breaker of one model version."""
        key = (str(name), str(version))
        br = self._breakers.get(key)
        if br is None:
            with self._lock:
                br = self._breakers.get(key)
                if br is None:
                    br = CircuitBreaker(
                        key[0], key[1],
                        threshold=self._breaker_threshold,
                        probe_s=self._breaker_probe_s)
                    self._breakers[key] = br
        return br

    def breaker_snapshot(self) -> Dict[str, dict]:
        """Every breaker's state, for /readyz, /debug and the flight
        recorder."""
        with self._lock:
            breakers = dict(self._breakers)
        return {f"{n}:{v}": br.snapshot()
                for (n, v), br in sorted(breakers.items())}

    #: dispatch outcomes that must NOT count as breaker failures: drain
    #: races (the swap retry handles them), deadline/shed pressure (load,
    #: not fault), quarantined poison (the request's own fault), and
    #: client-side input errors
    _BREAKER_EXEMPT = (EngineClosedError, TimeoutError, KeyError, TypeError,
                       ValueError)

    def _dispatch_guarded(self, mv: ModelVersion, fn):
        """One breaker-accounted dispatch attempt against ``mv``. A
        quarantined poison request counts as a failure too — a *flood*
        of consecutive quarantines with no success in between is a sick
        executable, and failing fast beats grinding through isolated
        retries — but any success in between resets the count, so one
        poison rider never opens a healthy version's breaker."""
        br = self.breaker_for(mv.name, mv.version)
        br.preflight()
        try:
            out = fn()
        except self._BREAKER_EXEMPT:
            raise
        except Exception:
            if br.record_failure():
                self._maybe_auto_rollback(mv.name, br)
            raise
        br.record_success()
        return out

    def _maybe_auto_rollback(self, name: str, br: CircuitBreaker):
        """Env-gated last resort: a breaker that re-opens
        ``auto_rollback_opens`` times in a row while a warm parked
        previous version exists repoints to that version — degraded
        service beats no service. Fires at most once per (model,
        version)."""
        env = environment()
        if not env.auto_rollback():
            return
        if br.consecutive_opens < env.auto_rollback_opens():
            return
        key = (name, br.version)
        with self._lock:
            if key in self._auto_rolled:
                return
            versions = self._versions.get(name, [])
            cur = self._current.get(name)
            if cur is None or cur.version != br.version:
                return  # an older version's breaker; nothing to do
            idx = versions.index(cur)
            target = versions[idx - 1] if idx > 0 else None
            if target is None or target.engine.closed:
                return  # no warm parked version to fall back to
            self._auto_rolled.add(key)
        log.error("auto-rollback: %s:%s breaker persistently open "
                  "(%d consecutive opens); rolling back", name,
                  br.version, br.consecutive_opens)
        try:
            self.rollback(name)
            self._m_auto_rollbacks.labels(model=name).inc()
        except Exception:
            log.exception("auto-rollback of %s failed", name)

    # -- prediction -------------------------------------------------------
    def predict(self, name: str, request,
                version: Optional[str] = None,
                timeout_s: Optional[float] = None):
        """Route one request through the micro-batcher of the resolved
        version. A request that races a hot swap (the engine drains
        between resolution and dispatch) is retried against the
        replacement: in-flight traffic never fails on a deploy or
        rollback. TimeoutError propagates when ``timeout_s`` expires
        before dispatch. Runs in a ``serving/predict`` span of the
        caller's trace (the engine's queue/dispatch spans nest under
        it). Each attempt is accounted against the version's circuit
        breaker: an open breaker fails fast with ``BreakerOpenError``
        (503 + Retry-After at the HTTP layer). A generative version
        raises TypeError (400)."""
        with span("serving/predict", model=name,
                  version=str(version) if version is not None else ""):
            last_exc: Optional[Exception] = None
            for _ in range(4):
                mv = self.get(name, version)
                if isinstance(mv.engine, DecodeEngine):
                    raise TypeError(
                        f"model '{name}' is generative; use generate() "
                        "(POST /v1/models/<name>/generate)")

                def attempt(mv=mv):
                    try:
                        return mv.engine.submit(
                            request, timeout_s=timeout_s).result()
                    except ValueError:
                        # batch larger than max_batch: the chunked sync
                        # path (re-raises genuine bad-request errors)
                        return mv.engine.infer(request)

                try:
                    return self._dispatch_guarded(mv, attempt)
                except EngineClosedError as e:
                    last_exc = e
                    if version is not None:
                        raise  # pinned to a retired/closed version
                    continue  # current swapped mid-flight; re-resolve
            raise last_exc  # registry is shutting down (drain_all)

    # -- generation -------------------------------------------------------
    def generate(self, name: str, prompt,
                 version: Optional[str] = None,
                 timeout_s: Optional[float] = None, **opts):
        """Route one generation request to the resolved version's
        ``DecodeEngine`` and block for the result dict. Same hot-swap
        contract as ``predict()``: a request that races a cutover is
        transparently retried against the replacement. ``timeout_s``
        bounds the wait for a decode slot; ``opts`` pass through to
        ``DecodeEngine.generate`` (max_tokens, temperature, top_k,
        eos_token, on_token)."""
        with span("serving/generate", model=name,
                  version=str(version) if version is not None else ""):
            last_exc: Optional[Exception] = None
            for _ in range(4):
                mv = self.get(name, version)
                if not isinstance(mv.engine, DecodeEngine):
                    raise TypeError(
                        f"model '{name}' is not generative; use predict()")
                try:
                    return self._dispatch_guarded(
                        mv, lambda mv=mv: mv.engine.generate(
                            prompt, timeout_s=timeout_s, **opts).result())
                except EngineClosedError as e:
                    last_exc = e
                    if version is not None:
                        raise  # pinned to a retired/closed version
                    continue  # current swapped mid-flight; re-resolve
            raise last_exc

    # -- rollback / retention ---------------------------------------------
    def rollback(self, name: str,
                 drain_timeout_s: Optional[float] = None) -> ModelVersion:
        """Repoint ``name`` to the previous retained version (its engine
        re-admits instantly — executables never left the process). The
        rolled-away-from version drains and is parked."""
        with self._lock:
            versions = self._versions.get(name)
            if not versions:
                raise KeyError(f"no model '{name}' deployed")
            cur = self._current[name]
            idx = versions.index(cur)
            if idx == 0:
                raise RuntimeError(
                    f"model '{name}' has no retained version to roll "
                    f"back to (current: {cur.version})")
            target = versions[idx - 1]
            target.engine.start()  # reverse the park-drain
            target.state = READY
            self._current[name] = target
        self._watch(target)
        cur.engine.drain(drain_timeout_s if drain_timeout_s is not None
                         else environment().serving_drain_timeout_s())
        cur.state = RETIRED
        self._unwatch(cur)
        self._m_rollbacks.labels(model=name).inc()
        log.info("rolled back %s: %s -> %s", name, cur.version,
                 target.version)
        return target

    def _prune(self, name: str):
        """Close and drop the oldest non-current versions beyond the
        retention cap."""
        to_close: List[ModelVersion] = []
        with self._lock:
            versions = self._versions.get(name, [])
            cur = self._current.get(name)
            others = [mv for mv in versions if mv is not cur]
            excess = len(others) - self.retain
            if excess > 0:
                for mv in others[:excess]:
                    versions.remove(mv)
                    to_close.append(mv)
        for mv in to_close:
            mv.engine.close(environment().serving_drain_timeout_s())
            log.info("evicted %s:%s beyond retain=%d", name, mv.version,
                     self.retain)

    def undeploy(self, name: str,
                 drain_timeout_s: Optional[float] = None):
        """Drain and permanently close every version of ``name``."""
        with self._lock:
            versions = self._versions.pop(name, [])
            self._current.pop(name, None)
        t = (drain_timeout_s if drain_timeout_s is not None
             else environment().serving_drain_timeout_s())
        for mv in versions:
            mv.engine.close(t)
            mv.state = RETIRED
            self._unwatch(mv)
        return self

    # -- graceful drain ---------------------------------------------------
    def drain_all(self, timeout_s: Optional[float] = None,
                  save_manifests: bool = True) -> bool:
        """SIGTERM path: stop serving, flush every engine's micro-batcher,
        and (by default) save the warmup manifests the next replica warms
        from. Idempotent. Returns True when everything drained in time."""
        t = (timeout_s if timeout_s is not None
             else environment().serving_drain_timeout_s())
        with self._lock:
            self._draining = True
            versions = [mv for vs in self._versions.values() for mv in vs]
        if save_manifests:
            self.save_manifests()
        ok = True
        for mv in versions:
            ok = mv.engine.close(t) and ok
            mv.state = RETIRED
            self._unwatch(mv)
        return ok
