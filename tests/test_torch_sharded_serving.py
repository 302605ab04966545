"""The port's sharded serving against the JAX package's and its own
unsharded engines (``runtime/sharded.py``, the ``mesh=``/``param_spec=``
arguments of ``DecodeEngine``, ``InferenceEngine`` and
``ModelRegistry.deploy``).

The contract is the reference's ``tests/test_fleet.py::TestShardedServing``:
a 1x1 mesh (one process, no process group) is bitwise; sharded predict
is within rtol 1e-5 / atol 1e-6 of the unsharded and the JAX sharded
engines, with identical argmax; tensor-parallel decode gives identical
greedy tokens; ``mesh_shape`` and ``"auto(model)"`` are reported where
the reference reports them and nowhere else.

The port's side runs on two gloo ranks (one module-scoped pool): every
rank builds the same engine from the same numpy weights, rank 0 leads
and rank 1 follows. The JAX side is the reference engine on
``serving_mesh(devices=jax.devices()[:2])``. The CausalLM is the tiny
config (f32, 4 heads, 2 layers) with its dense weights scaled by 10, as
``test_torch_causal_lm.py`` bridges it; the predict networks are
``test_torch_inference.py``'s MLP and graph and a one-layer SameDiff
graph.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.models import causal_lm as jcl
from deeplearning4j_tpu.quant import quantize_model as jquantize_model
from deeplearning4j_tpu.runtime.generation import DecodeEngine as JDecode
from deeplearning4j_tpu.runtime.inference import InferenceEngine as JInfer

from deeplearning4j_tpu_torch.bridge import params_from_numpy
from deeplearning4j_tpu_torch.common import mesh as tmesh
from deeplearning4j_tpu_torch.models import causal_lm as tcl
from deeplearning4j_tpu_torch.runtime import sharded
from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine

from test_torch_causal_lm import scaled_jax_params
from test_torch_inference import _graph_pair, _pair
from torch_parallel_cases import Ranks

RTOL, ATOL = 1e-5, 1e-6
V = 97
ENGINE_KW = {"slots": 2, "max_ctx": 64, "prompt_buckets": [16]}
CFG_KW = {"vocab_size": V, "hidden_size": 64, "num_heads": 4,
          "intermediate_size": 128, "max_position_embeddings": 256}
#: batch sizes of a predict case: bucket 1 runs whole on every rank,
#: buckets 4 and 8 split over data=2
SIZES = (1, 3, 8)


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(2)
    yield r
    r.close()


@pytest.fixture(scope="module")
def lm():
    """(JAX CausalLM, numpy params tree) of the scaled tiny config, with
    random biases (the init's are 0): a bias that a head-parallel rank
    adds before the all-reduce would enter twice."""
    jcfg, tree = scaled_jax_params(0, 2)
    r = np.random.RandomState(9)
    for layer in tree["layers"]:
        for group in (layer["attn"], layer["mlp"]):
            for k, v in group.items():
                if k.startswith("b"):
                    group[k] = (0.1 * r.randn(*v.shape)).astype(v.dtype)
    return jcl.CausalLM(jcfg, params=jax.tree_util.tree_map(jnp.asarray,
                                                            tree)), tree


def _prompts():
    return [np.random.RandomState(s).randint(0, V, n).astype(np.int32)
            for n, s in ((7, 11), (13, 12))]


def _jax_tokens(engine, prompts, max_tokens):
    try:
        futs = [engine.generate(p, max_tokens=max_tokens) for p in prompts]
        return [f.result(timeout=120)["tokens"] for f in futs]
    finally:
        engine.close(10)


def _port_lm(tree, layers=2):
    cfg = tcl.CausalLMConfig(**dict(CFG_KW, num_layers=layers,
                                    dtype=torch.float32))
    return tcl.CausalLM(cfg, params=params_from_numpy(
        {"embeddings": tree["embeddings"],
         "layers": tree["layers"][:layers]}, device="cpu"), device="cpu")


def _jmesh(model_parallel=None):
    return jmesh.serving_mesh(model_parallel, devices=jax.devices()[:2])


# -- one process, no process group -------------------------------------------

@pytest.mark.parametrize("kind", ["decode", "predict"])
def test_1x1_mesh_is_bitwise(lm, kind):
    """A 1x1 mesh without a process group is the single-process engine:
    every collective is the identity and the numbers are bitwise."""
    mesh = tmesh.serving_mesh(1, devices=[0], device="cpu")
    if kind == "predict":
        _, net = _pair()
        x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
        ref = InferenceEngine(net, max_batch=8)
        eng = InferenceEngine(net, max_batch=8, mesh=mesh)
        try:
            np.testing.assert_array_equal(eng.infer(x).numpy(),
                                          ref.infer(x).numpy())
            assert eng.stats()["mesh_shape"] == {"data": 1, "model": 1}
            assert "mesh_shape" not in ref.stats()
        finally:
            eng.close(5)
            ref.close(5)
        return
    _, tree = lm
    model = _port_lm(tree)
    ids = torch.as_tensor(np.stack([p[:7] for p in _prompts()]))
    placed = sharded.place_causal_lm(mesh, model.params)
    assert torch.equal(tcl.forward(placed, ids, model.config),
                       tcl.forward(model.params, ids, model.config))
    ref = DecodeEngine(model, device="cpu", **ENGINE_KW)
    eng = DecodeEngine(model, device="cpu", mesh=mesh, **ENGINE_KW)
    assert eng._link is None
    assert _jax_tokens(eng, _prompts(), 8) == _jax_tokens(ref, _prompts(), 8)


# -- sharded predict ---------------------------------------------------------

def _predict_case(kind):
    """(JAX model, outputs, a request of a batch, payload for the ranks)."""
    if kind == "samediff":
        r = np.random.RandomState(5)
        w = r.randn(6, 3).astype(np.float32)
        b = r.randn(3).astype(np.float32)
        sd = JSameDiff.create()
        x = sd.placeholder("x", (None, 6))
        y = sd.nn.softmax(sd.nn.tanh(x @ sd.var("w", w) + sd.var("b", b)))
        return sd, [y.name], (lambda a: {"x": a}), {"w": w, "b": b}
    jnet, _ = _graph_pair() if kind == "graph" else _pair()
    payload = {"conf": jnet.conf.to_json(),
               "params": jax.tree_util.tree_map(np.asarray, jnet._params)}
    if kind == "mlp_int8":
        jnet = jquantize_model(jnet)
    return jnet, None, (lambda a: a), payload


def _jax_np(out):
    if isinstance(out, dict):
        return [np.asarray(out[k].jax()) for k in sorted(out)]
    if isinstance(out, list):
        return [np.asarray(o.jax()) for o in out]
    return [np.asarray(out.jax())]


@pytest.mark.parametrize("kind,model_parallel", [
    ("mlp", 2), ("mlp", 1), ("mlp_int8", 2), ("graph", 2),
    ("samediff", 2)])
def test_sharded_predict_matches_jax(ranks, kind, model_parallel):
    """Rank 0's sharded predict (params stored over ``model`` and
    gathered at use, an int8 twin's quantized weights with their scales;
    with model_parallel=1 the mesh is data=2 and the buckets of 4 and 8
    rows split over it) against JAX's sharded engine and the port's
    unsharded one."""
    jmodel, outputs, req, payload = _predict_case(kind)
    xs = [np.random.RandomState(n).randn(n, 6).astype(np.float32)
          for n in SIZES]
    je = JInfer(jmodel, max_batch=8, outputs=outputs,
                mesh=_jmesh(model_parallel))
    try:
        ref = [_jax_np(je.infer(req(x))) for x in xs]
    finally:
        je.close(5)
    res, follower = ranks.run("sharded_predict", kind, payload, xs,
                              model_parallel)
    assert follower == {"joined": True}
    for got, want, jref in zip(res["got"], res["want"], ref):
        for g, w, j in zip(got, want, jref):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g, j, rtol=RTOL, atol=ATOL)
            assert (g.argmax(-1) == j.argmax(-1)).all()
    assert res["stats"]["mesh_shape"] == {"data": 2 // model_parallel,
                                          "model": model_parallel}
    assert res["stats"]["param_spec"] == "auto(model)"


def test_a_poison_request_leaves_the_mesh_serving(ranks):
    """A request of the wrong feature width fails on the leader and on
    the follower at the same point: it is quarantined, the follower's
    channel goes on, and the next good request gets the unsharded
    engine's answer. A mesh of one rank in the process group has no step
    link and answers alike."""
    jnet, _ = _pair()
    mlp = (jnet.conf.to_json(),
           jax.tree_util.tree_map(np.asarray, jnet._params))
    good = np.random.RandomState(4).randn(2, 6).astype(np.float32)
    bad = np.random.RandomState(5).randn(1, 5).astype(np.float32)
    lead, follow = ranks.run("sharded_poison", mlp, good, bad)
    assert lead["bad"].startswith("quarantined")
    assert lead["good_err"] <= ATOL and lead["closed"]
    assert follow["joined"]
    for r in (lead, follow):
        assert not r["solo_link"] and r["solo_err"] == 0.0


# -- tensor-parallel decode --------------------------------------------------

@pytest.mark.parametrize("draft", [False, True])
def test_tp_decode_tokens_match_jax(ranks, lm, draft):
    """Head-parallel decode at model=2 (2 of 4 heads a rank): greedy
    tokens identical to JAX's sharded and unsharded engines, with and
    without a one-layer draft (k=2); two all-reduces a layer and step;
    each rank's pool half the unsharded one; the follower refuses
    ``generate`` and ends when the leader closes."""
    jm, tree = lm
    kw = dict(ENGINE_KW)
    if draft:
        jdraft = jcl.CausalLM(
            jcl.CausalLMConfig(**{**jm.config.__dict__, "num_layers": 1}),
            params={"embeddings": jm.params["embeddings"],
                    "layers": jm.params["layers"][:1]})
        kw.update(draft_model=jdraft, spec_k=2)
    prompts = _prompts()
    jref = _jax_tokens(JDecode(jm, **kw), prompts, 8)
    jshard = _jax_tokens(JDecode(jm, mesh=_jmesh(), **kw), prompts, 8)
    lead, follow = ranks.run("sharded_decode", tree, CFG_KW, prompts, 8,
                             ENGINE_KW, draft_layers=1 if draft else 0)
    assert lead["tokens"] == jshard == jref == lead["ref_tokens"]
    assert len(set(sum(jref, []))) > 2
    assert lead["pool_bytes"] * 2 == lead["ref_pool_bytes"] \
        == follow["pool_bytes"] * 2
    s = lead["stats"]
    if draft:
        assert s["spec_steps"] > 0 and s["spec_proposed"] > 0
    else:
        steps = s["prefill_dispatches"] + s["decode_steps"]
        assert lead["all_reduces"] == 2 * 2 * steps
    for d in (s, lead["snapshot"]):
        assert d["mesh_shape"] == {"data": 1, "model": 2}
        assert d["param_spec"] == "auto(model)"
    assert "mesh_shape" not in lead["ref_stats"]
    assert "follower" in follow["refused"] and follow["joined"]
    assert lead["closed"]


@pytest.mark.parametrize("case", ["int8", "heads3", "explicit_spec",
                                  "data2"])
def test_tp_decode_matches_the_unsharded_port(ranks, lm, case):
    """Greedy tokens identical to the port's unsharded engine: the int8
    twin (quantized whole, then sharded with its scales); a 3-head config
    at model=2, whose attention and pool stay whole on every rank (one
    all-reduce a layer, the MLP's); an explicit ``P(None, "model")``,
    stored as given and gathered at each step; a (2, 1) mesh, whose two
    data replicas run every step whole, with no all-reduce."""
    _, tree = lm
    cfg_kw, kw = CFG_KW, {}
    if case == "heads3":
        cfg_kw = dict(CFG_KW, hidden_size=48, num_heads=3)
        cfg = tcl.CausalLMConfig(**dict(cfg_kw, num_layers=2,
                                        dtype=torch.float32))
        tree = jax.tree_util.tree_map(
            lambda t: (t.float() * (10.0 if t.dim() >= 2 else 1.0)).numpy(),
            tcl.init_params(cfg, seed=4, device="cpu"))
    elif case == "int8":
        kw["quantize"] = True
    elif case == "data2":
        kw["model_parallel"] = 1
    else:
        kw["param_spec"] = tmesh.P(None, "model")
    lead, follow = ranks.run("sharded_decode", tree, cfg_kw, _prompts(),
                             8, ENGINE_KW, **kw)
    assert lead["tokens"] == lead["ref_tokens"]
    assert follow["joined"]
    s = lead["stats"]
    steps = s["prefill_dispatches"] + s["decode_steps"]
    if case == "data2":
        assert lead["pool_bytes"] == lead["ref_pool_bytes"]
        assert lead["all_reduces"] == 0
        assert s["mesh_shape"] == {"data": 2, "model": 1}
    elif case == "heads3":
        assert lead["pool_bytes"] == lead["ref_pool_bytes"]
        assert lead["all_reduces"] == 2 * steps
    else:
        assert lead["pool_bytes"] * 2 == lead["ref_pool_bytes"]
        assert lead["all_reduces"] == 2 * 2 * steps
    assert s["param_spec"] == ("P(None, 'model')" if case == "explicit_spec"
                               else "auto(model)")


# -- the registry and the HTTP surface ---------------------------------------

def test_sharded_deploys_report_their_mesh(ranks, lm):
    """A sharded CausalLM and a sharded MLP beside an unsharded MLP,
    deployed on both ranks and served by rank 0: ``/v1/models`` and the
    engines' stats carry ``mesh_shape`` and ``"auto(model)"`` for the
    sharded versions only, ``/debug/decode`` for the sharded engine; the
    greedy tokens and the predictions are the unsharded engines'."""
    _, tree = lm
    jnet, tnet = _pair()
    mlp = (jnet.conf.to_json(),
           jax.tree_util.tree_map(np.asarray, jnet._params))
    x = np.random.RandomState(3).randn(3, 6).astype(np.float32)
    prompt = [int(t) for t in _prompts()[0]]
    lead, follow = ranks.run("sharded_registry", tree, CFG_KW, prompt,
                             mlp, x)
    assert lead["drained"] and follow["drained"]
    versions = {n: m["versions"][0] for n, m in lead["models"]["models"]
                .items()}
    for name in ("lm", "toy"):
        assert versions[name]["mesh_shape"] == {"data": 1, "model": 2}
        assert versions[name]["param_spec"] == "auto(model)"
    assert "mesh_shape" not in versions["plain"]
    assert lead["toy_stats"]["mesh_shape"] == {"data": 1, "model": 2}
    assert "mesh_shape" not in lead["plain_stats"]
    (snap,) = lead["decode"]["decode"]
    assert snap["model"] == "lm" and snap["param_spec"] == "auto(model)"
    assert snap["mesh_shape"] == {"data": 1, "model": 2}
    ref = DecodeEngine(_port_lm(tree), device="cpu", slots=2, max_ctx=64,
                       prompt_buckets=[16])
    assert lead["generated"]["tokens"] == \
        _jax_tokens(ref, [np.asarray(prompt, np.int32)], 6)[0]
    np.testing.assert_allclose(np.asarray(lead["predicted"]["outputs"]),
                               tnet.output(x).numpy(), rtol=RTOL,
                               atol=ATOL)


def test_two_sharded_engines_under_concurrent_callers(ranks, lm):
    """A sharded DecodeEngine and a sharded InferenceEngine on one mesh,
    the leader's generate calls and 8 threads' infer calls at once: both
    engines' steps keep one order on both ranks (nothing hangs) and
    every result is the unsharded engines'."""
    _, tree = lm
    jnet, _ = _pair()
    mlp = (jnet.conf.to_json(),
           jax.tree_util.tree_map(np.asarray, jnet._params))
    xs = [np.random.RandomState(i).randn(1 + i % 5, 6).astype(np.float32)
          for i in range(8)]
    lead, follow = ranks.run("sharded_concurrent", tree, CFG_KW,
                             _prompts(), mlp, xs)
    assert follow["joined"] and not lead["threads_alive"]
    assert lead["tokens"] == lead["ref_tokens"]
    assert lead["predict_max_err"] <= ATOL
