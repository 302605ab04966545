"""The port's ``common/`` against the JAX package's: the layered
properties and ``get_environment()``, ``matmul_precision`` and
``full_f32``, fault injection and the retry policy, the metrics registry,
the lock-order tracker, chrome-trace export read back by both profile
analyzers, and ``NativeRandom``.

The fault rules and the backoff jitter draw from ``random.Random(seed)``
on both sides, so their sequences are compared for equality. The port's
``NativeRandom`` draws from Philox, not threefry, so its values are held
to determinism, counting, shapes, bounds and moments instead (``MOMENT``:
the mean of 20,000 draws is within 0.02 of its expectation, over four
standard errors).
"""
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jpkg
from deeplearning4j_tpu.common import faults as jfaults
from deeplearning4j_tpu.common import locks as jlocks
from deeplearning4j_tpu.common import metrics as jmetrics
from deeplearning4j_tpu.common import profile_analyzer as jpa
from deeplearning4j_tpu.common import tracing as jtracing

import deeplearning4j_tpu_torch as tpkg
from deeplearning4j_tpu_torch.common import faults as tfaults
from deeplearning4j_tpu_torch.common import locks as tlocks
from deeplearning4j_tpu_torch.common import metrics as tmetrics
from deeplearning4j_tpu_torch.common import profile_analyzer as tpa
from deeplearning4j_tpu_torch.common import tracing as ttracing
from deeplearning4j_tpu_torch.common.rng import (NativeRandom, get_random,
                                                 set_default_seed)
from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32

# ``common.environment`` is both a submodule and, on both packages'
# ``common``, the function that returns the singleton
jenv = importlib.import_module("deeplearning4j_tpu.common.environment")
tenv = importlib.import_module("deeplearning4j_tpu_torch.common.environment")

ROOT = Path(__file__).resolve().parent.parent
MOMENT = 0.02

JAX_PROPS = sorted(v for k, v in vars(jenv.SystemProperties).items()
                   if not k.startswith("_"))


# -- properties ---------------------------------------------------------

def _envs(v):
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def test_every_jax_property_is_in_the_port():
    assert len(JAX_PROPS) == 69
    assert sorted(tenv._PROPS) == JAX_PROPS
    assert {k: v for k, v in vars(tenv.SystemProperties).items()
            if not k.startswith("_")} == \
        {k: v for k, v in vars(jenv.SystemProperties).items()
         if not k.startswith("_")}


@pytest.mark.parametrize("name", JAX_PROPS)
def test_property_env_vars_and_default_match_jax(name, monkeypatch):
    envs, default = tenv._PROPS[name]
    assert _envs(envs) == _envs(jenv._ENV_FOR_PROP.get(name))
    assert default == jenv._DEFAULTS.get(name)
    for e in _envs(envs):
        monkeypatch.delenv(e, raising=False)
    j, t = jenv.Environment(), tenv.Environment()
    assert t.property(name) == j.property(name)
    for e in reversed(_envs(envs)):   # the first variable set wins
        monkeypatch.setenv(e, f"from-{e}")
        assert t.property(name) == j.property(name) == f"from-{e}"
    t.set_property(name, "over")
    assert t.property(name) == "over" and t.property_override(name) == "over"
    t.clear_property(name)
    assert t.property_override(name) is None


def test_getters_match_jax(monkeypatch, tmp_path):
    for name in JAX_PROPS:
        for e in _envs(tenv._PROPS[name][0]):
            monkeypatch.delenv(e, raising=False)
    j, t = jenv.Environment(), tenv.Environment()
    getters = ["is_debug", "is_verbose", "max_threads", "default_float_dtype",
               "matmul_precision", "nan_panic", "inf_panic",
               "profiling_enabled", "eager_jit", "home_dir", "lock_check",
               "faults_spec", "warmup_threads", "cache_max_bytes",
               "cache_tier", "training_zero1", "xla_cache", "flash_min_seq",
               "paged_kernel", "fused_dequant", "kv_block_size",
               "spec_draft_k"]
    for g in getters:
        assert getattr(t, g)() == getattr(j, g)(), g
    monkeypatch.setenv("DL4J_TPU_HOME", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_DTYPE", "bfloat16")
    monkeypatch.setenv("DL4J_TPU_NAN_PANIC", "")
    monkeypatch.setenv("DL4J_TPU_CACHE_TIER", "bogus")
    monkeypatch.setenv("DL4J_TPU_FLASH_MIN_SEQ", "-3")
    for g in getters:
        assert getattr(t, g)() == getattr(j, g)(), g
    t.set_debug(True)
    j.set_debug(True)
    assert t.is_debug() and j.is_debug()


def test_get_environment_matches_jax():
    assert tpkg.get_environment is not None
    j, t = jpkg.get_environment(), tpkg.get_environment()
    assert sorted(vars(t)) == sorted(vars(j))
    for k in vars(j):
        assert getattr(t, k) == getattr(j, k), k
    # unset attributes resolve on the layered Environment
    assert t.decode_slots() == j.decode_slots()
    with pytest.raises(AttributeError):
        t.no_such_knob


# -- matmul_precision ---------------------------------------------------

@pytest.fixture
def precision():
    """The port's Environment with its applied level and the TF32 flags
    restored after the test."""
    env = tenv.environment()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield env
    env.set_property("matmul_precision", "default")
    env.clear_property("matmul_precision")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _in_scope():
    with full_f32():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("level,tf32", [
    ("high", True), ("tensorfloat32", True), ("highest", False),
    ("float32", False), ("default", False), ("bfloat16", False),
    ("fastest", False)])
def test_full_f32_reads_the_applied_level(precision, level, tf32):
    torch.backends.cuda.matmul.allow_tf32 = not tf32
    precision.set_property("matmul_precision", level)
    assert tenv.tf32_applied() is tf32
    assert _in_scope() == (tf32, tf32)


def test_default_level_restores_the_flags(precision):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    assert _in_scope() == (False, False)
    precision.set_property("matmul_precision", "high")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)
    precision.set_property("matmul_precision", "highest")
    assert _in_scope() == (False, False)
    precision.set_property("matmul_precision", "default")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (False, True)
    precision.set_property("matmul_precision", "no-such-level")
    assert tenv.tf32_applied() is False


def test_env_var_alone_applies_no_precision_as_in_jax(precision,
                                                      monkeypatch):
    """Reference fault 5 (``ROADMAP.md`` queue 3): the JAX package applies
    ``matmul_precision`` only in ``set_property``; the variable alone is
    read but never applied. The port keeps that alike."""
    import jax
    monkeypatch.setenv("DL4J_TPU_MATMUL_PRECISION", "high")
    before = jax.config.jax_default_matmul_precision
    j = jenv.Environment()
    assert j.matmul_precision() == "high"
    assert jax.config.jax_default_matmul_precision == before
    t = tenv.Environment()
    assert t.matmul_precision() == "high"
    assert _in_scope() == (False, False)


# -- faults -------------------------------------------------------------

SPEC = ("engine.dispatch:error:0.5:7, decode.step:delay5:0.25:3,"
        "http.handler::0.75,bad:oops:1:1,:error,decode.loop:error:x")


@pytest.fixture
def no_rules():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _fire_sequence(mod, sites, n):
    out = []
    for i in range(n):
        for site in sites:
            try:
                mod.check(site, i=i)
                out.append(0)
            except mod.InjectedFault as e:
                assert e.site == site
                out.append(1)
    return out


def _stats(mod):
    return sorted((s["site"], s["kind"], s["rate"], s["seed"], s["checked"],
                   s["triggered"]) for s in mod.stats())


def test_configure_grammar_and_sequences_match_jax(no_rules):
    assert tfaults.configure(SPEC) == jfaults.configure(SPEC) == 3
    assert _stats(tfaults) == _stats(jfaults)
    sites = ["engine.dispatch", "http.handler", "decode.loop"]
    assert _fire_sequence(tfaults, sites, 40) == \
        _fire_sequence(jfaults, sites, 40)
    assert _stats(tfaults) == _stats(jfaults)
    rule = [r for rules in tfaults._RULES.values() for r in rules
            if r.site == "decode.step"][0]
    assert rule.kind == "delay" and rule.delay_s == 0.005
    tfaults.clear("engine.dispatch")
    jfaults.clear("engine.dispatch")
    assert _stats(tfaults) == _stats(jfaults)
    assert tfaults.configure("") == 0 and not tfaults.active()


def test_fire_returns_the_kind_or_none(no_rules):
    """A repair: the port's rule answered a bool where the JAX rule gives
    the kind to apply, or None."""
    for mod in (tfaults, jfaults):
        err = mod._FaultRule("s", "error")
        delay = mod._FaultRule("s", "delay", times=1)
        assert err.fire({}) == "error"
        assert delay.fire({}) == "delay" and delay.fire({}) is None


def test_raising_predicate_never_injects(no_rules):
    """A repair: the port let a raising predicate propagate out of
    ``check``; in the JAX package such a predicate never injects."""
    def broken(ctx):
        raise KeyError("payload")
    for mod in (tfaults, jfaults):
        rule = mod.inject("engine.dispatch", predicate=broken)
        mod.check("engine.dispatch", payload=None)   # neither raises
        assert rule.fire({}) is None and rule.triggered == 0
        mod.remove(rule)


def test_faults_env_armed_at_import_in_a_subprocess():
    code = (
        "import json\n"
        "from deeplearning4j_tpu.common import faults as j\n"
        "from deeplearning4j_tpu_torch.common import faults as t\n"
        "def seq(m):\n"
        "    out = []\n"
        "    for _ in range(30):\n"
        "        try:\n"
        "            m.check('engine.dispatch'); out.append(0)\n"
        "        except m.InjectedFault:\n"
        "            out.append(1)\n"
        "    return out\n"
        "print(json.dumps([t.active(), len(t.stats()), seq(t) == seq(j),"
        " sum(seq(t))]))\n")
    env = dict(os.environ, DL4J_TPU_FAULTS="engine.dispatch:error:0.3:11",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    active, n, same, fired = eval(out.stdout.strip().splitlines()[-1]
                                  .replace("true", "True")
                                  .replace("false", "False"))
    assert active and n == 1 and same and 0 < fired < 30


def test_backoff_peek_reset_and_retry_call_match_jax():
    seqs = []
    for mod in (tfaults, jfaults):
        b = mod.ExponentialBackoff(base_s=0.1, factor=3.0, max_s=2.0,
                                   jitter=0.5, seed=5)
        seq = [b.peek()] + [b.next_delay() for _ in range(5)] + [b.peek()]
        b.reset()
        seq += [b.attempt, b.peek(), b.next_delay()]
        slept, retried = [], []
        policy = mod.RetryPolicy(3, base_s=0.01, seed=2,
                                 sleep=slept.append)
        calls = iter([ValueError("a"), ValueError("b"), 42])

        def flaky():
            v = next(calls)
            if isinstance(v, Exception):
                raise v
            return v
        assert mod.retry_call(flaky, policy=policy,
                              on_retry=lambda e, n: retried.append(n)) == 42
        policy = mod.RetryPolicy(1, base_s=0.01, sleep=slept.append)
        with pytest.raises(mod.RetryBudgetExceeded) as exc:
            mod.retry_call(lambda: 1 / 0, policy=policy,
                           retry_on=ZeroDivisionError)
        assert isinstance(exc.value.__cause__, ZeroDivisionError)
        seqs.append((seq, slept, retried, policy.restarts))
    assert seqs[0] == seqs[1]
    assert str(tfaults.InjectedFault("s", "why")) == "why"


# -- metrics and locks --------------------------------------------------

def test_registry_clear_get_set_enabled_match_jax():
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry(enabled=True)
        c = reg.counter("x_total", "x")
        assert reg.get("x_total") is c and reg.get("nope") is None
        assert reg.set_enabled(False) is reg and not reg.enabled
        c.inc(3)
        assert c.value() == 0
        reg.set_enabled(True)
        c.inc(2)
        assert c.value() == 2
        assert reg.clear() is reg and reg.get("x_total") is None
        assert reg.snapshot() == {}


def test_lock_check_functions_match_jax(monkeypatch):
    for mod in (tlocks, jlocks):
        prev = mod.lock_check_enabled()
        try:
            monkeypatch.setenv("DL4J_TPU_LOCK_CHECK", "1")
            assert mod.refresh_lock_check() and mod.lock_check_enabled()
            mod.clear_violations()
            a, b = mod.ordered_lock("test.a"), mod.ordered_lock("test.b")
            with a:
                with b:
                    pass
            assert ("test.a", "test.b") in mod.acquisition_edges()
            with b:
                with a:
                    pass
            assert len(mod.violations()) == 1
            mod.clear_violations(edges=False)
            assert mod.violations() == []
            assert ("test.a", "test.b") in mod.acquisition_edges()
            mod.clear_violations()
            assert mod.acquisition_edges() == {}
            monkeypatch.setenv("DL4J_TPU_LOCK_CHECK", "0")
            assert not mod.refresh_lock_check()
        finally:
            mod.set_lock_check(prev)
            mod.clear_violations()


# -- tracing and the profile analyzers ----------------------------------

def _spans(tr):
    for name, n in (("train/step", 3), ("serde/save", 2), ("cg/output", 1)):
        for _ in range(n):
            with tr.span(name, k=1):
                pass


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_exported_traces_aggregate_alike_in_both_analyzers(tmp_path,
                                                           suffix):
    paths = {}
    for tag, mod in (("t", ttracing), ("j", jtracing)):
        tr = mod.Tracer(capacity=64)
        _spans(tr)
        paths[tag] = str(tmp_path / "sub" / f"{tag}{suffix}")
        assert tr.export(paths[tag]) == 6
        assert tr.clear() is tr and tr.events() == []
    for pa in (tpa, jpa):
        ta = pa.aggregate(pa.load_trace(paths["t"]))
        ja = pa.aggregate(pa.load_trace(paths["j"]))
        assert {k: v["count"] for k, v in ta.items()} == \
            {k: v["count"] for k, v in ja.items()} == \
            {"train/step": 3, "serde/save": 2, "cg/output": 1}
        assert ta.unmatched == ja.unmatched == 0
        rows = pa.compare(paths["t"], paths["j"])
        assert sorted(r["name"] for r in rows) == sorted(ta)
    lines = []
    tpa.print_comparison(paths["t"], paths["j"], log_fn=lines.append)
    assert len(lines) == 4


def test_module_export_writes_the_process_tracer(tmp_path):
    ttracing.tracer().clear()
    with ttracing.span("one"):
        pass
    path = str(tmp_path / "p.json")
    assert ttracing.export(path) == 1
    assert [e["name"] for e in tpa.load_trace(path)] == ["one"]
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def test_aggregate_matches_jax_on_begin_end_pairs():
    events = [{"ph": "B", "name": "a", "ts": 0, "tid": 1},
              {"ph": "E", "name": "a", "ts": 5, "tid": 1},
              {"ph": "E", "name": "b", "ts": 9, "tid": 1},
              {"ph": "X", "name": "a", "ts": 0, "dur": 2.5}]
    assert tpa.aggregate(events) == jpa.aggregate(events)
    assert tpa.aggregate(events).unmatched == 1


# -- NativeRandom -------------------------------------------------------

def test_native_random_determinism_position_and_seed():
    a, b = NativeRandom(7), NativeRandom(7)
    for name, args in (("next_int", (10, (5,))), ("next_long", ((3,),)),
                       ("next_double", ((4,),)), ("next_float", ((4,),)),
                       ("next_gaussian", ((2, 3),)),
                       ("next_boolean", ((6,),)),
                       ("uniform", ((3,), -2.0, 2.0)),
                       ("normal", ((3,), 1.0, 0.5))):
        x, y = getattr(a, name)(*args), getattr(b, name)(*args)
        assert torch.equal(x, y), name
    assert a.position == 8 and a.get_seed() == 7
    a.set_seed(7)
    assert a.position == 0
    assert torch.equal(a.next_int(10, (5,)), NativeRandom(7).next_int(
        10, (5,)))
    c = NativeRandom(8)
    assert not torch.equal(NativeRandom(7).next_float((16,)),
                           c.next_float((16,)))
    set_default_seed(3)
    x = get_random().next_float((4,))
    set_default_seed(3)
    assert torch.equal(get_random().next_float((4,)), x)


def test_native_random_shapes_dtypes_bounds_and_moments():
    r = NativeRandom(11)
    n = 20000
    i = r.next_int(10, (n,))
    assert i.dtype == torch.int32 and i.shape == (n,)
    assert int(i.min()) >= 0 and int(i.max()) <= 9
    assert abs(float(i.float().mean()) - 4.5) < 10 * MOMENT
    assert r.next_long((2,)).dtype == torch.int64
    u = r.uniform((n,), -2.0, 2.0)
    assert u.dtype == torch.float32 and float(u.min()) >= -2.0 \
        and float(u.max()) < 2.0 and abs(float(u.mean())) < 2 * MOMENT
    g = r.normal((n,), 1.0, 0.5)
    assert abs(float(g.mean()) - 1.0) < MOMENT
    assert abs(float(g.std()) - 0.5) < MOMENT
    bern = r.next_boolean((n,))
    assert bern.dtype == torch.bool
    assert abs(float(bern.float().mean()) - 0.5) < MOMENT
    d = r.next_double(())
    assert d.shape == () and 0.0 <= float(d) < 1.0
    assert np.isfinite(r.next_gaussian((3, 2)).numpy()).all()


# -- the typed setters and device reports (queue 3, fault 1) -------------------

#: (setter, property it writes, reader, a value, a value that fails)
SETTERS = [
    ("set_decode_slots", "decode_slots", "decode_slots", 3, "three"),
    ("set_decode_max_ctx", "decode_max_ctx", "decode_max_ctx", 96, "x"),
    ("set_decode_max_tokens", "decode_max_tokens", "decode_max_tokens", 17,
     None),
    ("set_kv_block_size", "kv_block_size", "kv_block_size", 8, "8.5"),
    ("set_prefix_cache", "prefix_cache", "prefix_cache_enabled", False,
     None),
    ("set_spec_draft_k", "spec_draft_k", "spec_draft_k", 2, []),
    ("set_quant_max_divergence", "quant_max_divergence",
     "quant_max_divergence", 0.5, "lots"),
    ("set_training_remat", "training_remat", "training_remat", "layer",
     None),
    ("set_training_grad_accum", "training_grad_accum",
     "training_grad_accum", 4, "x"),
    ("set_training_zero1", "training_zero1", "training_zero1", True, None),
    ("set_auto_rollback", "auto_rollback", "auto_rollback", True, None),
    ("set_cache_dir", "cache_dir", "cache_dir", "~/dl4j-cache", None),
    ("set_remote_cache", "remote_cache", "remote_cache", None, None),
    ("set_cache_tier", "cache_tier", "cache_tier", "tiered", None),
    ("set_flash_min_seq", "flash_min_seq", "flash_min_seq", 64, "x"),
    ("set_paged_kernel", "paged_kernel", "paged_kernel", "off", None),
    ("set_fused_dequant", "fused_dequant", "fused_dequant", None, None),
    ("set_metrics_enabled", "metrics", "metrics_enabled", False, None),
]


@pytest.mark.parametrize("setter,prop,reader,value,bad", SETTERS,
                         ids=[s[0] for s in SETTERS])
def test_typed_setter_matches_jax(setter, prop, reader, value, bad,
                                  monkeypatch):
    """Each setter writes the JAX package's property with its conversion,
    its reader returns what the JAX reader returns, and a value the
    conversion refuses raises the same error on both sides."""
    for e in _envs(tenv._PROPS[prop][0]):
        monkeypatch.delenv(e, raising=False)
    j, t = jenv.Environment(), tenv.Environment()
    try:
        assert getattr(t, setter)(value) is t
        getattr(j, setter)(value)
        assert t.property_override(prop) == j.property_override(prop)
        assert getattr(t, reader)() == getattr(j, reader)()
    finally:
        if setter == "set_metrics_enabled":
            t.set_metrics_enabled(True)
            j.set_metrics_enabled(True)
    if bad is not None:
        with pytest.raises(Exception) as te:
            getattr(t, setter)(bad)
        with pytest.raises(Exception) as je:
            getattr(j, setter)(bad)
        assert te.type is je.type
        assert t.property_override(prop) == j.property_override(prop)


def test_device_reports_are_the_ports_own():
    """``backend`` and ``memory_stats`` agree with JAX's on a CPU-only
    host; ``num_devices`` counts torch's cards (1 for the CPU), not the
    JAX package's virtual devices."""
    j, t = jenv.Environment(), tenv.Environment()
    assert t.backend() == j.backend() == "cpu"
    assert t.memory_stats() == j.memory_stats() == {}
    assert t.num_devices() == 1


@pytest.mark.parametrize("setter,value", [
    ("set_flash_min_seq", 1 << 30), ("set_paged_kernel", "off"),
    ("set_fused_dequant", "off")])
def test_tpu_switch_changes_no_kernel(setter, value):
    """The three TPU switches are stored and read back, and change
    nothing: no kernel module reads them (so no CUDA tensor's route
    depends on them) and a CPU call's output and recorded route stay
    the same."""
    import inspect
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.quant import transforms as qt
    # the package's functions shadow their modules' names
    kfa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")
    kpd = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.paged_flash_decode")
    prop = setter[len("set_"):]
    reads = re.compile(rf"['\"]{prop}['\"]|\.{prop}\(")
    for mod in (K, kfa, kpd, qt):
        assert not reads.search(inspect.getsource(mod)), mod.__name__
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 2, 16, generator=g)
    pool = torch.randn(4, 4, 2, 16, generator=g)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    w = qt.quantize_tensor(torch.randn(16, 8, generator=g))

    def run():
        outs = (kfa.flash_attention(q, q, q, causal=True),
                kpd.paged_flash_decode(q[:, :1].contiguous(), pool, pool,
                                       tables, lengths),
                qt.dequant_matmul(q[0, :, 0], w))
        return outs, K.dispatch_snapshot()
    env = tenv.environment()
    saved = env.property_override(prop)
    before = run()
    try:
        getattr(env, setter)(value)
        assert env.property_override(prop) == str(value)
        after = run()
    finally:
        if saved is None:
            env.clear_property(prop)
        else:
            env.set_property(prop, saved)
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    assert before[1] == after[1]


def test_serving_methods_match_jax():
    """``RequestRing.find``, ``AdmissionController.ewma_service_s`` /
    ``reopen`` and ``HealthRegistry.reset``, side by side."""
    from deeplearning4j_tpu.serving import admission as jadm
    from deeplearning4j_tpu.serving import resilience as jres
    from deeplearning4j_tpu.serving import server as jsrv
    from deeplearning4j_tpu_torch.serving import admission as tadm
    from deeplearning4j_tpu_torch.serving import resilience as tres
    from deeplearning4j_tpu_torch.serving import server as tsrv
    for srv in (jsrv, tsrv):
        ring = srv.RequestRing(3)
        for i, tid in enumerate(["a", "b", "a", "c"]):
            ring.add({"trace_id": tid, "i": i})
        assert ring.find("a") == {"trace_id": "a", "i": 2}
        assert ring.find("b") == {"trace_id": "b", "i": 1}
        assert ring.find("zz") is None
    ctl = [m.AdmissionController("m", max_concurrent=1, queue_depth=1,
                                 default_timeout_s=None)
           for m in (jadm, tadm)]
    assert ctl[0].ewma_service_s() == ctl[1].ewma_service_s()
    for c, m in zip(ctl, (jadm, tadm)):
        with c.admit(timeout_s=1.0):
            pass
        assert c.close() is c and c.closed
        with pytest.raises(m.ShedError):
            c.admit(timeout_s=0.1)
        assert c.reopen() is c and not c.closed
        with c.admit(timeout_s=1.0):
            pass
    assert ctl[0].ewma_service_s() > 0 and ctl[1].ewma_service_s() > 0
    for m in (jres, tres):
        h = m.HealthRegistry()
        h.set_unhealthy("lm:v1", "watchdog")
        assert not h.healthy() and h.snapshot() == {"lm:v1": "watchdog"}
        h.reset()
        assert h.healthy() and h.snapshot() == {}
