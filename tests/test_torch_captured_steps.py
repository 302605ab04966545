"""The captured serving steps (``runtime/cuda_graphs.py``) against the
JAX package's compiled-executable contract, on the CPU.

On a CPU engine every step signature runs eagerly on its static buffers,
bound to the params of its last capture, so these cases exercise what a
CUDA engine captures: the census, the packed step inputs, the sampling
noise as a function of (seed, request, position), and the keys that keep
a graph from reading stale params. The replays themselves run on the card
(``tests/test_torch_captured_steps_cuda.py``).

- (a) the decode census: ``len(ladder) * len(batch ladder) + 1`` events
  at warmup (+1 with a draft), as the JAX engine's
  (``tests/test_generation.py::TestCompileCounting``), idempotent, and
  none after traffic;
- (b) greedy tokens through the static-buffer step bodies identical to
  the JAX engine's, with and without a draft;
- (c) sampled tokens a function of (seed, request, position): the same
  whatever else the engine runs beside a request;
- (d) a network's predict after ``fit``, ``set_params`` and a
  ``matmul_precision`` change: its forward on the new params, and the
  JAX network's;
- (e) the predict census of the three adapters, as the JAX engine's;
- the params a captured forward held, and a closed engine's steps, freed
  as soon as nothing else holds them.

Tolerances: f32 predictions against an eager forward of the same params
on the same device, atol 1e-6 (the same ops in the same order; the 1e-6
covers a BLAS that picks its blocking by the batch); port against JAX,
rtol 1e-5 / atol 1e-6 as ``tests/test_torch_inference.py`` (the same ops
summed in another order).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.common.environment import environment as jenv
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import causal_lm as jcl
from deeplearning4j_tpu.runtime import inference as jinf
from deeplearning4j_tpu.runtime.generation import DecodeEngine as JaxEngine

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.common.environment import environment as tenv
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import causal_lm as tcl
from deeplearning4j_tpu_torch.nn.fit_fastpath import _leaves, full_f32
from deeplearning4j_tpu_torch.runtime import inference as tinf
from deeplearning4j_tpu_torch.runtime.generation import (DecodeEngine,
                                                         sample_tokens,
                                                         step_uniforms)
from test_torch_causal_lm import model_pair
from test_torch_inference import _graph_pair, _pair, _x

V = 97
#: tests/test_generation.py::TestCompileCounting's engine
CENSUS_KW = {"slots": 2, "max_ctx": 64, "prompt_buckets": [8, 32],
             "prefill_batch": 2}
SPEC_K = 3
#: the JAX test's traffic: prompts of 3, 8, 20 and 5 tokens
TRAFFIC = (3, 8, 20, 5)
ATOL_SAME = 1e-6
RTOL, ATOL = 1e-5, 1e-6


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, V, n).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _drafts(pair):
    """A one-layer draft sharing each side's embeddings and first
    layer."""
    jm, tm = pair
    jdraft = jcl.CausalLM(
        jcl.CausalLMConfig(**{**jm.config.__dict__, "num_layers": 1}),
        params={"embeddings": jm.params["embeddings"],
                "layers": jm.params["layers"][:1]})
    tdraft = tcl.CausalLM(
        tcl.CausalLMConfig(**{**tm.config.__dict__, "num_layers": 1}),
        params={"embeddings": tm.params["embeddings"],
                "layers": tm.params["layers"][:1]}, device="cpu")
    return jdraft, tdraft


@pytest.fixture(scope="module")
def census(pair):
    """Each side's engine, with and without a draft, warmed twice with
    the census counted from zero, then fed the JAX test's traffic:
    ``{(side, draft): {"expected", "warm", "rewarm", "traffic",
    "tokens", "stats"}}``."""
    drafts = _drafts(pair)
    out = {}
    for draft in (False, True):
        for i, side in enumerate(("jax", "torch")):
            env = jenv() if side == "jax" else tenv()
            kw = dict(CENSUS_KW)
            if draft:
                kw.update(draft_model=drafts[i], spec_k=SPEC_K)
            eng = (JaxEngine(pair[0], **kw) if side == "jax"
                   else DecodeEngine(pair[1], device="cpu", **kw))
            try:
                rec = {"expected": len(eng.ladder) * len(eng.batch_ladder)
                       + 1 + int(draft)}
                env.reset_compile_count()
                eng.warmup()
                rec["warm"] = env.compile_count()
                eng.warmup()
                rec["rewarm"] = env.compile_count()
                env.reset_compile_count()
                futs = [eng.generate(_prompt(n, seed=50 + n), max_tokens=4)
                        for n in TRAFFIC]
                rec["tokens"] = [f.result(timeout=120)["tokens"]
                                 for f in futs]
                rec["traffic"] = env.compile_count()
                if side == "torch":
                    rec["stats"] = eng.stats()
            finally:
                eng.close(10)
                env.reset_compile_count()
            out[(side, draft)] = rec
    return out


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
def test_decode_census_matches_jax(census, draft):
    """(a) One event per prefill (bucket, batch rung), the decode step
    and the verify step at warmup, on both sides; a second warmup and
    the traffic add none."""
    jax_rec, rec = census[("jax", draft)], census[("torch", draft)]
    assert rec["expected"] == jax_rec["expected"] == 3 * 2 + 1 + int(draft)
    assert rec["warm"] == jax_rec["warm"] == rec["expected"]
    assert rec["rewarm"] == jax_rec["rewarm"] == rec["expected"]
    assert rec["traffic"] == jax_rec["traffic"] == 0
    graphs = rec["stats"]["graphs"]
    assert len(graphs) == rec["expected"]
    assert {g["cache"] for g in graphs} == {"eager"}   # no capture on CPU
    assert {g["tag"] for g in graphs} \
        == {"prefill", "decode"} | ({"spec"} if draft else set())
    assert sum(g["replays"] for g in graphs) > 0


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
def test_greedy_tokens_through_the_step_bodies_match_jax(census, draft):
    """(b) The JAX test's four requests, greedy, token for token."""
    got, ref = census[("torch", draft)], census[("jax", draft)]
    assert got["tokens"] == ref["tokens"]
    assert all(len(t) == 4 for t in got["tokens"])
    if draft:
        assert got["stats"]["spec_steps"] > 0


def test_twin_census_tags_carry_its_precision(pair):
    """The int8 twin's steps are census events of their own, tagged
    ``prefill:int8`` / ``decode:int8``: the JAX engine suffixes a twin's
    tags with its precision alike (JAX ``runtime/generation.py``,
    ``_build_steps``)."""
    from deeplearning4j_tpu_torch.quant import quantize_model
    twin = quantize_model(pair[1], device="cpu")
    eng = DecodeEngine(twin, device="cpu", **CENSUS_KW)
    try:
        tenv().reset_compile_count()
        eng.warmup()
        tags = {g["tag"] for g in eng.stats()["graphs"]}
        assert tenv().compile_count() == len(eng.ladder) \
            * len(eng.batch_ladder) + 1
    finally:
        eng.close(10)
        tenv().reset_compile_count()
    assert tags == {"prefill:int8", "decode:int8"}


def _sampled(pair, seed):
    eng = DecodeEngine(pair[1], device="cpu", seed=seed, slots=2,
                       max_ctx=64, prompt_buckets=[16])
    try:
        return [eng.generate(_prompt(n, seed=n), max_tokens=8,
                             temperature=1.5, top_k=0).result(120)["tokens"]
                for n in (5, 9)]
    finally:
        eng.close(10)


def test_sampled_tokens_are_a_function_of_seed_and_step(pair):
    """(c) Two engines with one seed and the same requests sample the
    same tokens; another seed samples others. The noise is a function of
    (seed, step) whether they come as numbers or as the 0-d tensors a
    captured step reads."""
    a, b, c = _sampled(pair, 7), _sampled(pair, 7), _sampled(pair, 8)
    assert a == b
    assert a != c
    u = step_uniforms(7, 3, (2, V), "cpu")
    assert torch.equal(u, step_uniforms(torch.tensor(7, dtype=torch.int32),
                                        torch.tensor(3, dtype=torch.int32),
                                        (2, V), "cpu"))
    assert not torch.equal(u, step_uniforms(7, 4, (2, V), "cpu"))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    logits, hot = torch.zeros(2, V), torch.ones(2)
    no_k = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(sample_tokens(logits, hot, no_k, 7, 3),
                       sample_tokens(logits, hot, no_k, torch.tensor(7),
                                     torch.tensor(3)))


def _sampled_rounds(model, together):
    """Four sampled requests through one engine: submitted while its
    scheduler is held (admitted and stepped together), or each only
    after the one before has its first token (admitted one by one, so
    every request is sampled at other engine steps)."""
    import threading
    eng = DecodeEngine(model, device="cpu", seed=5, slots=4, max_ctx=64,
                       prompt_buckets=[16], prefill_batch=2)
    prompts = [_prompt(n, seed=20 + n) for n in (5, 9, 7, 12)]
    try:
        eng.warmup()
        if together:
            with eng._cv:
                futs = [eng.generate(p, max_tokens=8, temperature=1.5)
                        for p in prompts]
        else:
            futs = []
            for p in prompts:
                first = threading.Event()
                futs.append(eng.generate(p, max_tokens=8, temperature=1.5,
                                         on_token=lambda t, e=first: e.set()))
                assert first.wait(60)
        return [f.result(120)["tokens"] for f in futs], eng.stats()
    finally:
        eng.close(10)


def test_sampled_tokens_do_not_depend_on_the_co_scheduled_traffic(pair):
    """(c) A request's sampled tokens are a function of the engine's
    seed, its submission order and its own tokens: the same whether the
    engine admits the four requests in one group or one by one, though
    the engine's steps differ. Keyed on the engine's step count instead,
    the tokens followed the host's timing, and a captured engine, whose
    steps run faster, served other tokens than the eager reference on
    the card (``test_decode_replays_after_the_verify_step_grew_the_
    counters``)."""
    together, s1 = _sampled_rounds(pair[1], True)
    apart, s2 = _sampled_rounds(pair[1], False)
    assert s1["prefill_dispatches"] != s2["prefill_dispatches"]
    assert together == apart


# -- predict ------------------------------------------------------------------

def _eager(tnet, x):
    """The network's forward on its current params, outside any
    captured signature."""
    with torch.no_grad(), full_f32():
        return tnet._forward(tnet._params, torch.from_numpy(x),
                             False).numpy()


def _captures(engine):
    return {g["signature"]: g["captures"] for g in engine.stats()["graphs"]}


def test_predict_after_fit_set_params_and_precision_reads_new_params():
    """(d) A network warmed through the engine, then changed three ways:
    each predict equals its forward on the new params, each change
    captures the served signature again, and the port follows the JAX
    network through ``fit`` and ``set_params``."""
    jnet, tnet = _pair(seed=5)
    te = tinf.InferenceEngine(tnet, max_batch=8)
    te.warmup(_x(1))
    x = _x(3, seed=11)
    before = te.infer(x).numpy()
    np.testing.assert_allclose(before, _eager(tnet, x), atol=ATOL_SAME,
                               rtol=0)
    caps0 = _captures(te)
    feats, labels = _x(4, seed=12), np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    jnet.fit(JDataSet(feats, labels))
    tnet.fit(TDataSet(feats, labels))
    after = te.infer(x).numpy()
    assert not np.allclose(after, before, atol=1e-4)   # fit moved them
    np.testing.assert_allclose(after, _eager(tnet, x), atol=ATOL_SAME,
                               rtol=0)
    np.testing.assert_allclose(after, np.asarray(jnet.output(x).jax()),
                               rtol=RTOL, atol=ATOL)
    caps1 = _captures(te)
    assert any(caps1[s] > caps0[s] for s in caps0)

    flat = np.asarray(jnet.params().jax()) * 0.5
    jnet.set_params(flat)
    tnet.set_params(flat)
    got = te.infer(x).numpy()
    np.testing.assert_allclose(got, _eager(tnet, x), atol=ATOL_SAME, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x).jax()),
                               rtol=RTOL, atol=ATOL)
    caps2 = _captures(te)
    assert any(caps2[s] > caps1[s] for s in caps1)

    env = tenv()
    prev = env.matmul_precision()
    env.set_property("matmul_precision", "high")
    try:
        got = te.infer(x).numpy()
        np.testing.assert_allclose(got, _eager(tnet, x), atol=ATOL_SAME,
                                   rtol=0)
        caps3 = _captures(te)
    finally:
        env.set_property("matmul_precision", prev)
        te.close()
    assert any(caps3[s] > caps2[s] for s in caps2)


def _sd_pair():
    """softmax(x @ w + b) as a SameDiff graph on each side, one set of
    weights."""
    rs = np.random.RandomState(4)
    w = rs.randn(6, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    out = []
    for sd in (JSameDiff.create(), TSameDiff.create(device="cpu")):
        x = sd.placeholder("x", (None, 6))
        y = sd.nn.softmax(x.mmul(sd.var("w", w)) + sd.var("b", b))
        out.append((sd, y))
    return out


@pytest.mark.parametrize("adapter", ["multilayer", "graph", "samediff"])
def test_predict_census_unchanged_for_every_adapter(adapter):
    """(e) Warmup records one event a bucket on both sides, the traffic
    none, and the port's answers match the JAX engine's; on the CPU each
    bucket's signature runs eagerly on its buffers."""
    if adapter == "multilayer":
        jm, tm = _pair()
        jkw = tkw = {}
        example = {"x": _x(1)}
    elif adapter == "graph":
        jm, tm = _graph_pair()
        jkw = tkw = {}
        example = {"in": _x(1)}
    else:
        (jm, jy), (tm, ty) = _sd_pair()
        jkw, tkw = {"outputs": [jy]}, {"outputs": [ty]}
        example = {"x": _x(1)}

    def request(n, seed):
        data = {k: _x(n, seed=seed) for k in example}
        return data["x"] if adapter == "multilayer" else data

    def arrays(out):
        if isinstance(out, dict):
            out = list(out.values())
        if not isinstance(out, list):
            out = [out]
        return [np.asarray(o.numpy() if hasattr(o, "torch") else o.jax())
                for o in out]

    je = jinf.InferenceEngine(jm, max_batch=8, **jkw)
    te = tinf.InferenceEngine(tm, max_batch=8, **tkw)
    try:
        counts = []
        for env, eng in ((jenv(), je), (tenv(), te)):
            env.reset_compile_count()
            eng.warmup(request(1, 0))
            warm = env.compile_count()
            outs = [eng.infer(request(n, 20 + n)) for n in (1, 3, 6, 8)]
            counts.append((warm, env.compile_count() - warm))
            if eng is je:
                ref = [arrays(o) for o in outs]
            else:
                got = [arrays(o) for o in outs]
        assert counts[0] == counts[1] == (len(te.ladder), 0)
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        graphs = te.stats()["graphs"]
        assert len(graphs) == len(te.ladder)
        assert {g["cache"] for g in graphs} == {"eager"}
    finally:
        je.close()
        te.close()
        jenv().reset_compile_count()
        tenv().reset_compile_count()


def test_replaced_params_and_closed_engines_go_without_a_collection(pair):
    """A step holds the params it was bound to (a graph reads their
    addresses), but only until they are replaced: ``fit`` and
    ``set_array`` let go of the served forwards' steps, so the old
    tensors are freed at once. A closed engine lets go of its steps, and
    neither a network nor an engine is kept by a cycle through its step
    bodies: each goes when its last reference does, with the collector
    off."""
    _, tnet = _pair(seed=5)
    (_, _), (sd, y) = _sd_pair()
    feats, labels = _x(4, seed=12), np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    gc.collect()
    gc.disable()
    try:
        te = tinf.InferenceEngine(tnet, max_batch=8)
        te.warmup(_x(1))
        old = [weakref.ref(t) for t in _leaves(tnet._params)]
        tnet.fit(TDataSet(feats, labels))
        assert [r() for r in old] == [None] * len(old)
        te.close()
        net = weakref.ref(tnet)
        del te, tnet
        assert net() is None

        se = tinf.InferenceEngine(sd, max_batch=8, outputs=[y])
        se.warmup({"x": _x(1)})
        w = weakref.ref(sd.get_arr_for_var("w").torch())
        sd.set_array("w", np.zeros((6, 3), np.float32))
        assert w() is None
        se.close()
        assert all(g["captures"] == 1 for g in se.stats()["graphs"])

        eng = DecodeEngine(pair[1], device="cpu", **CENSUS_KW)
        eng.warmup()
        eng.generate(_prompt(5, seed=1), max_tokens=2).result(timeout=120)
        eng.close(10)
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()
