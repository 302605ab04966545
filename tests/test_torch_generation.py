"""The port's ``DecodeEngine`` against the JAX package's, on the same
weights (bridged as in ``test_torch_causal_lm.py``).

Greedy output must be token-identical in four cases: a cold prefill, a
prefix-warm attach, a pool small enough to force LIFO preemption, and
speculative decoding with a truncated draft. Temperature and top-k
sampling draw their Gumbel noise from different generators on the two
sides, so they get shape and distribution checks only. The engines are
the reference tests' size: ``slots=2, max_ctx=64, prompt_buckets=[16]``.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import causal_lm as jcl
from deeplearning4j_tpu.runtime.generation import DecodeEngine as JaxEngine
from deeplearning4j_tpu_torch.common import faults, locks
from deeplearning4j_tpu_torch.common.metrics import registry
from deeplearning4j_tpu_torch.common.tracing import (TraceContext,
                                                    new_trace_id,
                                                    pop_disposition, tracer,
                                                    use_context)
from deeplearning4j_tpu_torch.models import causal_lm as tcl
from deeplearning4j_tpu_torch.runtime.generation import (DecodeEngine,
                                                         sample_tokens)
from test_torch_causal_lm import model_pair

V = 97
ENGINE_KW = {"slots": 2, "max_ctx": 64, "prompt_buckets": [16]}


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, V, n).astype(np.int32)


def _run(engine, prompts, max_tokens, concurrent=False):
    """Greedy tokens per prompt: one after another, or all submitted at
    once when ``concurrent``. Closes the engine."""
    try:
        if concurrent:
            futs = [engine.generate(p, max_tokens=max_tokens)
                    for p in prompts]
            return [f.result(timeout=120)["tokens"] for f in futs]
        return [engine.generate(p, max_tokens=max_tokens)
                .result(timeout=120)["tokens"] for p in prompts]
    finally:
        engine.close(10)


def _both(pair, prompts, max_tokens, concurrent=False, draft_pair=None,
          **kw):
    """(JAX tokens, port tokens, port stats) for one engine config."""
    jm, tm = pair
    jkw, tkw = dict(ENGINE_KW, **kw), dict(ENGINE_KW, **kw)
    if draft_pair is not None:
        jkw["draft_model"], tkw["draft_model"] = draft_pair
    ref = _run(JaxEngine(jm, **jkw), prompts, max_tokens, concurrent)
    eng = DecodeEngine(tm, device="cpu", **tkw)
    got = _run(eng, prompts, max_tokens, concurrent)
    return ref, got, eng.stats()


def test_cold_prefill_token_identical(pair):
    prompts = [_prompt(7, seed=11), _prompt(13, seed=12)]
    ref, got, stats = _both(pair, prompts, 8)
    assert got == ref
    assert len(set(got[0] + got[1])) > 2     # not one repeated token
    assert stats["prefix_hits"] == 0 and stats["decode_steps"] > 0


def test_prefix_warm_attach_token_identical(pair):
    """The second prompt shares the first one's two full blocks: it
    attaches them and prefills only its tail."""
    base = _prompt(24, seed=31)
    prompts = [base, np.concatenate([base[:16], _prompt(4, seed=32)])]
    ref, got, stats = _both(pair, prompts, 8, kv_block_size=8)
    assert got == ref
    assert stats["prefix_hits"] == 1 and stats["prefix_reused_rows"] == 16


def test_preemption_token_identical(pair):
    """A pool of 5 blocks of 8 rows: each request's worst case (8 + 24
    rows = 4 blocks) fits alone but not beside the other, so the later
    admitted one is preempted and recomputed."""
    prompts = [_prompt(8, seed=84), _prompt(8, seed=85)]
    ref, got, stats = _both(pair, prompts, 24, concurrent=True,
                            kv_block_size=8, kv_blocks=5)
    assert got == ref
    assert stats["preempted"] >= 1
    assert stats["kv_blocks_free"] + stats["prefix_cached_blocks"] == 5


def test_speculative_token_identical(pair):
    """A one-layer draft sharing the target's embeddings and first layer
    proposes 3 tokens a step; the Q=4 verify keeps the target's greedy
    output."""
    jm, tm = pair
    jdraft = jcl.CausalLM(
        jcl.CausalLMConfig(**{**jm.config.__dict__, "num_layers": 1}),
        params={"embeddings": jm.params["embeddings"],
                "layers": jm.params["layers"][:1]})
    tdraft = tcl.CausalLM(
        tcl.CausalLMConfig(**{**tm.config.__dict__, "num_layers": 1}),
        params={"embeddings": tm.params["embeddings"],
                "layers": tm.params["layers"][:1]}, device="cpu")
    prompts = [_prompt(9, seed=21)]
    ref, got, stats = _both(pair, prompts, 10, draft_pair=(jdraft, tdraft),
                            spec_k=3)
    assert got == ref
    assert stats["spec_steps"] > 0 and stats["spec_proposed"] > 0
    assert 0.0 <= stats["spec_acceptance"] <= 1.0


def test_eos_stop_and_streaming(pair):
    """``on_token`` sees every token as it is sampled; the EOS token ends
    the request and is kept as its last token."""
    _, tm = pair
    eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
    try:
        prompt = _prompt(6, seed=90)
        full = eng.generate(prompt, max_tokens=8).result(120)["tokens"]
        eos = full[3]
        stop = full.index(eos)
        seen = []
        res = eng.generate(prompt, max_tokens=8, eos_token=eos,
                           on_token=seen.append).result(120)
    finally:
        eng.close(10)
    assert res["tokens"] == full[:stop + 1] == seen
    assert res["finish_reason"] == "eos"


def test_sampled_requests_shape_and_vocab(pair):
    _, tm = pair
    eng = DecodeEngine(tm, device="cpu", seed=3, **ENGINE_KW)
    try:
        futs = [eng.generate(_prompt(6, seed=s), max_tokens=9,
                             temperature=t, top_k=k)
                for s, t, k in ((40, 0.8, 5), (41, 1.5, 0))]
        for f in futs:
            r = f.result(timeout=120)
            assert len(r["tokens"]) == 9 and r["finish_reason"] == "length"
            assert all(0 <= t < V for t in r["tokens"])
    finally:
        eng.close(10)


def test_sample_tokens_distribution():
    """Top-k Gumbel-max draws follow the softmax renormalised over the
    top k: 4000 draws, each frequency within 0.04 of its probability
    (about five standard deviations)."""
    n, k = 4000, 3
    base = torch.from_numpy(
        np.random.RandomState(0).randn(V).astype(np.float32) * 2)
    logits = base.repeat(n, 1)
    temp = torch.full((n,), 0.7)
    got = sample_tokens(logits, temp, torch.full((n,), k, dtype=torch.int32),
                        5, 0)
    top = torch.topk(base, k).indices
    assert set(got.tolist()) <= set(top.tolist())
    want = torch.softmax(base[top] / 0.7, dim=0)
    freq = torch.stack([(got == t).float().mean() for t in top])
    assert (freq - want).abs().max().item() < 0.04
    greedy = sample_tokens(logits[:4], torch.zeros(4),
                           torch.zeros(4, dtype=torch.int32), 5, 1)
    assert greedy.tolist() == [int(base.argmax())] * 4


def test_stats_metrics_and_debug_snapshot(pair):
    _, tm = pair
    reg = registry()
    tokens = reg.counter("dl4j_decode_tokens_total",
                         "Tokens sampled across prefill + decode steps")
    requests = reg.counter(
        "dl4j_decode_requests_total",
        "Generation requests accepted by DecodeEngine.generate()")
    t0, r0 = tokens.value(), requests.value()
    eng = DecodeEngine(tm, device="cpu", model_name="torch-tiny",
                       **ENGINE_KW)
    try:
        eng.warmup()
        for s in (50, 51):
            eng.generate_sync(_prompt(5, seed=s), max_tokens=6)
        stats = eng.stats()
        snap = eng.debug_snapshot()
    finally:
        eng.close(10)
    assert stats["requests"] == 2 and stats["tokens"] == 12
    assert stats["decode_steps"] >= 5
    assert tokens.value() == t0 + 12 and requests.value() == r0 + 2
    assert stats["kv_blocks_free"] + stats["prefix_cached_blocks"] \
        == eng.kv_blocks
    assert snap["device"] == "cpu" and snap["pool"]["scratch_block"] == 0
    assert snap["kernels"]["paged_decode"]["path"] == "paged"
    ttft = reg.histogram("dl4j_decode_ttft_seconds",
                         "Time from generate() to the first sampled token",
                         labels=("model",)).labels(model="torch-tiny")
    assert ttft.count() == 2
    assert 'dl4j_decode_ttft_seconds_count{model="torch-tiny"} 2' \
        in reg.prometheus_text()


def test_step_fault_fails_only_its_riders(pair):
    """A decode step that raises fails the requests riding it and frees
    their slots and blocks; the next request is served."""
    _, tm = pair
    eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
    trace_id = new_trace_id()
    try:
        with faults.injected("decode.step", times=1), \
                use_context(TraceContext(trace_id)):
            fut = eng.generate(_prompt(5, seed=60), max_tokens=4)
            with pytest.raises(faults.InjectedFault):
                fut.result(timeout=120)
        r = eng.generate(_prompt(5, seed=61), max_tokens=4).result(120)
        assert len(r["tokens"]) == 4
        stats = eng.stats()
    finally:
        eng.close(10)
    assert stats["active_slots"] == 0
    assert stats["kv_blocks_free"] + stats["prefix_cached_blocks"] \
        == eng.kv_blocks
    assert pop_disposition(trace_id) == "engine_restart"


def test_request_trace_gets_prefill_and_decode_spans(pair):
    """The decode loop records the request's spans on its behalf, as
    children of the submitter's span."""
    _, tm = pair
    ctx = TraceContext(new_trace_id(), "00ff00ff00ff00ff")
    eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
    try:
        with use_context(ctx):
            res = eng.generate(_prompt(5, seed=70), max_tokens=3).result(120)
    finally:
        eng.close(10)
    spans = {e["name"]: e["args"] for e in tracer().events_for(ctx.trace_id)}
    assert set(spans) == {"generation/prefill", "generation/decode"}
    assert all(a["parent_span_id"] == ctx.span_id for a in spans.values())
    assert spans["generation/decode"]["tokens"] == 3
    assert set(res["phases"]) == {"queue_s", "prefill_s", "decode_s"}
    ttft = registry().histogram(
        "dl4j_decode_ttft_seconds",
        "Time from generate() to the first sampled token",
        labels=("model",)).labels(model="default")
    assert ctx.trace_id in {e["trace_id"] for e in ttft.exemplars()}


def test_concurrent_requests_take_locks_in_one_order(pair):
    """With the lock-order tracker armed, four concurrent requests (two
    more than the slots, so admission queues) record no inversion."""
    _, tm = pair
    prev = locks.set_lock_check(True)
    locks.clear_violations()
    try:
        eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
        got = _run(eng, [_prompt(4 + i, seed=80 + i) for i in range(4)], 5,
                   concurrent=True)
        assert [len(t) for t in got] == [5] * 4
        assert locks.violations() == []
    finally:
        locks.set_lock_check(prev)
        locks.clear_violations()


def test_engine_reads_the_jax_package_knobs(pair, monkeypatch):
    """The engine's defaults come from the JAX package's ``DL4J_TPU_*``
    variables, with the same defaults when they are unset."""
    _, tm = pair
    for name in ("DL4J_TPU_DECODE_SLOTS", "DL4J_TPU_DECODE_MAX_CTX",
                 "DL4J_TPU_KV_BLOCK_SIZE", "DL4J_TPU_SPEC_DRAFT_K",
                 "DL4J_TPU_PREFIX_CACHE"):
        monkeypatch.delenv(name, raising=False)
    eng = DecodeEngine(tm, device="cpu")
    assert (eng.slots, eng.max_ctx, eng.block_size, eng.spec_k) \
        == (8, 256, 16, 0)
    assert eng.stats()["prefix_cache"] is True
    eng.close(10)
    monkeypatch.setenv("DL4J_TPU_DECODE_SLOTS", "3")
    monkeypatch.setenv("DL4J_TPU_DECODE_MAX_CTX", "48")
    monkeypatch.setenv("DL4J_TPU_KV_BLOCK_SIZE", "8")
    monkeypatch.setenv("DL4J_TPU_PREFIX_CACHE", "0")
    eng = DecodeEngine(tm, device="cpu")
    assert (eng.slots, eng.max_ctx, eng.block_size) == (3, 48, 8)
    assert eng.stats()["prefix_cache"] is False
    eng.close(10)


def test_engine_refuses_a_model_on_another_device(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="device"):
        DecodeEngine(tm, **ENGINE_KW)           # engine defaults to cuda


def test_tensor_parallel_decode_waits_for_its_slice(pair):
    """``mesh=`` is now taken (``test_torch_sharded_serving.py`` holds
    it on two ranks); a mesh without the ``data`` axis is refused as the
    reference refuses it, before anything runs. The name is kept from
    the refusal of every ``mesh=``."""
    from deeplearning4j_tpu_torch.common.mesh import Mesh, serving_mesh
    _, tm = pair
    eng = DecodeEngine(tm, device="cpu", mesh=serving_mesh(device="cpu"),
                       **ENGINE_KW)
    assert eng.stats()["mesh_shape"] == {"data": 1, "model": 1}
    eng.close(5)
    with pytest.raises(ValueError, match="missing required"):
        DecodeEngine(tm, device="cpu", mesh=Mesh([0], ("model",), "cpu"),
                     **ENGINE_KW)


def test_registry_compat_surface_matches_jax(pair):
    """What ``serving/registry.py`` reads of an engine (``describe``,
    manifest save, the watchdog): ``max_batch``, ``manifest_path``,
    ``observed_entries()`` and the idle dispatch instant, as the JAX
    package's engine has them."""
    jm, tm = pair
    ref = JaxEngine(jm, **ENGINE_KW)
    eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
    try:
        for e in (ref, eng):
            assert e.max_batch == e.slots == 2
            assert e.manifest_path is None
            assert e.observed_entries() == []
            assert e._dispatch_started_at is None
        assert eng.ladder == ref.ladder
    finally:
        ref.close(10)
        eng.close(10)


def test_block_pool_used_count_matches_jax(pair):
    """``used_count`` is the number of outstanding blocks, beside
    ``free_count``, on both sides, through a request's life."""
    jm, tm = pair
    ref = JaxEngine(jm, **ENGINE_KW)
    eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
    try:
        for e in (ref, eng):
            a = e._alloc
            assert a.used_count == 0 and a.free_count == a.total
            blocks = a.alloc(3)
            assert a.used_count == 3 and a.free_count == a.total - 3
            a.incref(blocks[:1])
            assert a.used_count == 3          # one block, two refs
            a.decref(blocks)
            assert a.used_count == 1
            a.decref(blocks[:1])
            assert a.used_count == 0
            e.generate(_prompt(5, seed=70), max_tokens=3).result(120)
            assert e._alloc.used_count + e._alloc.free_count \
                == e._alloc.total
        assert eng._alloc.used_count == ref._alloc.used_count
    finally:
        ref.close(10)
        eng.close(10)


def test_warmup_observes_each_step_on_the_compile_histogram(pair):
    """Each warmed step signature lands once on
    ``dl4j_compile_seconds{kind,cache}``: ``cache="eager"`` on a CPU
    engine, whose steps run eagerly on their static buffers (a CUDA
    engine's captures land as ``cache="captured"``)."""
    _, tm = pair
    hist = registry().histogram(
        "dl4j_compile_seconds",
        "Wall time to materialize + first-run an executable, by cache "
        "outcome", labels=("kind", "cache"))
    before = {k: hist.labels(kind=k, cache="eager").count()
              for k in ("prefill", "decode")}
    eng = DecodeEngine(tm, device="cpu", **ENGINE_KW)
    try:
        eng.warmup()
    finally:
        eng.close(10)
    n_prefill = len(eng.ladder) * len(eng.batch_ladder)
    assert hist.labels(kind="prefill", cache="eager").count() \
        == before["prefill"] + n_prefill
    assert hist.labels(kind="decode", cache="eager").count() \
        == before["decode"] + 1
