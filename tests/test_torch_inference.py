"""The port's ``InferenceEngine`` and predict route against the JAX
package's, on the same weights.

The network is ``tests/test_inference_engine.py``'s MLP (dense 6->8 tanh,
softmax 8->3), built on the JAX side and carried to the port with
``bridge.load_multilayer``; inputs come from ``np.random.RandomState``.
Every port call runs on the CPU (``device="cpu"``).

Tolerances:
- f32 outputs, port against JAX: the same ops summed in another order,
  rtol 1e-5 / atol 1e-6 (``RTOL``, ``ATOL``).
- padded bucket against exact shape, on one side: the same tolerance.
  This is allclose, not bitwise: a padded batch is a larger product,
  which a BLAS (or, on the card, the dequant kernel's plan by M) may sum
  in another order.

Timing is never asserted: coalescing is made deterministic by holding the
first dispatch at a fault-injection predicate until the queue is full.
"""
import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import serving as jserving
from deeplearning4j_tpu.common import faults as jfaults
from deeplearning4j_tpu.common.environment import environment as jenv
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.runtime import inference as jinf

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch import quant as tquant
from deeplearning4j_tpu_torch import serving as tserving
from deeplearning4j_tpu_torch.common import faults as tfaults
from deeplearning4j_tpu_torch.common import locks
from deeplearning4j_tpu_torch.common.environment import environment as tenv
from deeplearning4j_tpu_torch.common.metrics import registry as tregistry
from deeplearning4j_tpu_torch.common.tracing import (TraceContext,
                                                     new_span_id,
                                                     new_trace_id,
                                                     pop_disposition,
                                                     use_context)
from deeplearning4j_tpu_torch.nn import fit_fastpath
from deeplearning4j_tpu_torch.nn.conf.config import \
    MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import \
    ComputationGraphConfiguration as TGraphConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.runtime import inference as tinf

N_IN, N_OUT = 6, 3
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _port_lock_order_check():
    locks.clear_violations()
    prev = locks.set_lock_check(True)
    try:
        yield
    finally:
        locks.set_lock_check(prev)
        found = locks.violations()
        locks.clear_violations()
    assert not found, f"port lock-order inversions: {found}"


@pytest.fixture(autouse=True)
def _envs():
    """Both sides' bucketing knobs and census, restored after each
    test."""
    saved = [(e, e.inference_bucketing(), e.inference_max_batch())
             for e in (jenv(), tenv())]
    for e, _, _ in saved:
        e.reset_compile_count()
    yield
    for e, b, m in saved:
        e.set_inference_bucketing(b)
        e.set_inference_max_batch(m)
        e.reset_compile_count()


_JPARAMS = {}


def _pair(seed=0):
    """(JAX network, port network on the CPU) over one set of weights."""
    conf = (JNNC.builder().seed(seed).list()
            .layer(JDense(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(JOutput(n_in=8, n_out=N_OUT))
            .build())
    if seed not in _JPARAMS:
        _JPARAMS[seed] = jax.tree_util.tree_map(
            np.asarray, JMLN(conf).init()._params)
    jnet = JMLN(conf).init(params=jax.tree_util.tree_map(
        jnp.asarray, _JPARAMS[seed]))
    tnet = TMLN(TConf.from_json(conf.to_json()), device="cpu")
    bridge.load_multilayer(tnet, _JPARAMS[seed])
    return jnet, tnet


def _graph_pair():
    """``tests/test_inference_engine.py``'s ``_graph()`` (dense 6->8 relu,
    softmax 8->3 as a ComputationGraph), bridged into the port."""
    conf = (JNNC.builder().seed(1)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", JDense(n_in=N_IN, n_out=8, activation="relu"),
                       "in")
            .add_layer("out", JOutput(n_in=8, n_out=N_OUT), "d1")
            .set_outputs("out")
            .build())
    jnet = JGraph(conf).init()
    tnet = TGraph(TGraphConf.from_json(conf.to_json()), device="cpu")
    bridge.load_graph(tnet, jax.tree_util.tree_map(np.asarray, jnet._params))
    return jnet, tnet


def _x(n, seed=0, n_in=N_IN):
    return np.random.RandomState(seed + n).randn(n, n_in).astype(np.float32)


def _np(out):
    return np.asarray(out.numpy() if hasattr(out, "torch")
                      else out.jax())


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# -- the bucket helpers --------------------------------------------------------

LADDER_CASES = [(16, None), (1, None), (24, None), (99, [8, 2, 8, 32]),
                (128, None), (5, [3])]


@pytest.mark.parametrize("max_batch,buckets", LADDER_CASES)
def test_bucket_ladder_and_bucket_for_match_jax(max_batch, buckets):
    t = tinf.bucket_ladder(max_batch, buckets)
    assert t == jinf.bucket_ladder(max_batch, buckets)
    for n in range(0, max(t) + 2):
        assert tinf.bucket_for(n, t) == jinf.bucket_for(n, t)


PAD_CASES = [((3, 5), 8), ((3, 5), 3), ((1, 2, 2), 4), ((7,), 16),
             ((0, 4), 2)]


@pytest.mark.parametrize("shape,target", PAD_CASES)
def test_pad_batch_matches_jax(shape, target):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    tx = torch.from_numpy(x)
    got = tinf.pad_batch(tx, target)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jinf.pad_batch(jnp.asarray(x),
                                                            target)))
    if shape[0] == target:
        assert got is tx


def _tree_cases():
    r = np.random.RandomState(2)
    a5 = r.randn(5, 3).astype(np.float32)
    return [
        ("array", a5, {}),
        ("list", [a5, r.randn(5, 2).astype(np.float32)], {}),
        ("dict", {"b": a5, "a": r.randn(5).astype(np.float32)}, {}),
        ("on_bucket", r.randn(4, 3).astype(np.float32), {}),
        ("above_ladder", r.randn(17, 3).astype(np.float32), {}),
        ("mismatched", [a5, r.randn(4, 3).astype(np.float32)], {}),
        ("scalar_leaf", [a5, np.float32(1.0)], {}),
        ("training", a5, {"training": True}),
        ("bucketing_off", a5, {"off": True}),
    ]


def _to_torch(tree):
    return tinf._tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _leaves_np(tree):
    return [np.asarray(v) for v in tinf._tree_leaves(tree)]


@pytest.mark.parametrize("name,tree,kw", _tree_cases(),
                         ids=[c[0] for c in _tree_cases()])
def test_maybe_pad_tree_matches_jax(name, tree, kw):
    for e in (jenv(), tenv()):
        e.set_inference_max_batch(16)
        e.set_inference_bucketing(not kw.get("off"))
    training = kw.get("training", False)
    jt, jpad = jinf.maybe_pad_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                                   training=training)
    tt, tpad = tinf.maybe_pad_tree(_to_torch(tree), training=training)
    assert tpad == jpad
    jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(jt)]
    tl = _leaves_np(tt)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)


SLICE_CASES = [(3, 4), (5, 8), (8, 8), (1, 2)]


@pytest.mark.parametrize("n,bucket", SLICE_CASES)
def test_slice_batch_matches_jax(n, bucket):
    r = np.random.RandomState(n)
    outs = [r.randn(bucket, 3).astype(np.float32), np.float32(2.5),
            r.randn(7, 2).astype(np.float32)]
    t = tinf.slice_batch([torch.from_numpy(np.asarray(o)) for o in outs],
                         n, bucket)
    j = jinf.slice_batch([jnp.asarray(o) for o in outs], n, bucket)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the engine against the JAX engine ----------------------------------------

@pytest.fixture(scope="module")
def nets():
    return _pair()


def test_infer_matches_jax_at_every_size(nets):
    jnet, tnet = nets
    je = jinf.InferenceEngine(jnet, max_batch=16)
    te = tinf.InferenceEngine(tnet, max_batch=16)
    for n in (1, 3, 5, 7, 11, 16):
        x = _x(n)
        got = te.infer(x)
        assert tuple(got.shape) == (n, N_OUT)
        _close(_np(got), _np(je.infer(x)))
    assert te.stats()["bucket_dispatches"] == \
        je.stats()["bucket_dispatches"]
    te.close()
    je.close()


def test_padded_matches_exact_shape(nets):
    _, tnet = nets
    for n in (1, 3, 5, 7, 11):
        x = _x(n)
        tenv().set_inference_bucketing(False)
        exact = tnet.output(x).numpy()
        tenv().set_inference_bucketing(True)
        _close(tnet.output(x).numpy(), exact)


def test_chunked_oversize_batch(nets):
    jnet, tnet = nets
    te = tinf.InferenceEngine(tnet, max_batch=4)
    je = jinf.InferenceEngine(jnet, max_batch=4)
    x = _x(10)
    got = _np(te.infer(x))
    assert got.shape == (10, N_OUT)
    _close(got, _np(je.infer(x)))
    s = te.stats()
    assert s["bucket_dispatches"] == {4: 2, 2: 1}
    assert s["rows_real"] == 10 and s["rows_padded"] == 0
    assert tenv().compile_count() <= math.ceil(math.log2(4)) + 1


def _gate(faults, site="engine.dispatch"):
    """Hold the next dispatch at ``site`` until the returned event is set
    (the predicate blocks, then declines to fire)."""
    release, entered = threading.Event(), threading.Event()

    def hold(ctx):
        if not entered.is_set():
            entered.set()
            release.wait(60)
        return False
    return faults.inject(site, predicate=hold), release, entered


def _wait(fn, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if fn():
            return True
        time.sleep(0.01)
    return fn()


def _coalesced_burst(eng, faults, n_threads=8, rows=2):
    """One 1-row request held at its dispatch while ``n_threads`` threads
    submit ``rows`` rows each; then the batcher drains the queue. Returns
    (inputs, results) of the burst."""
    rule, release, entered = _gate(faults)
    try:
        blocker = eng.submit(_x(1, seed=99))
        assert entered.wait(30)
        xs = [_x(rows, seed=100 + i) for i in range(n_threads)]
        outs = [None] * n_threads

        def worker(i):
            outs[i] = eng.submit(xs[i])
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert _wait(lambda: len(eng._pending) == n_threads)
    finally:
        release.set()
        faults.remove(rule)
    blocker.result(timeout=30)
    return xs, [f.result(timeout=30) for f in outs]


def test_submit_from_8_threads_coalesces_like_jax(nets):
    jnet, tnet = nets
    te = tinf.InferenceEngine(tnet, max_batch=16, max_delay_ms=2.0)
    je = jinf.InferenceEngine(jnet, max_batch=16, max_delay_ms=2.0)
    xs, touts = _coalesced_burst(te, tfaults)
    _, jouts = _coalesced_burst(je, jfaults)
    for x, t, j in zip(xs, touts, jouts):
        assert t.torch().device.type == "cpu"
        _close(_np(t), _np(j))
        _close(_np(t), tnet.output(x).numpy())
    ts, js = te.stats(), je.stats()
    for k in ("requests", "dispatches", "rows_real", "rows_padded",
              "coalesced", "bucket_dispatches"):
        assert ts[k] == js[k], k
    assert ts["coalesced"] == 8
    assert max(ts["bucket_dispatches"]) <= te.max_batch
    te.close()
    je.close()


def test_window_respects_max_batch(nets):
    """3-row requests cannot pair up under max_batch=4."""
    _, tnet = nets
    te = tinf.InferenceEngine(tnet, max_batch=4)
    _coalesced_burst(te, tfaults, n_threads=4, rows=3)
    assert te.stats()["bucket_dispatches"] == {1: 1, 4: 4}
    with pytest.raises(ValueError, match="exceeds max_batch"):
        te.submit(_x(5))
    te.close()


def test_warmup_census_then_no_new_event():
    jnet, tnet = _pair()  # fresh networks: nothing of theirs is counted
    for e in (jenv(), tenv()):
        e.reset_compile_count()
    te = tinf.InferenceEngine(tnet, max_batch=16)
    je = jinf.InferenceEngine(jnet, max_batch=16)
    assert te.warmup(_x(1)) == je.warmup(_x(1)) == [1, 2, 4, 8, 16]
    warmed = tenv().compile_count()
    assert warmed == jenv().compile_count() == len(te.ladder)
    assert warmed <= math.ceil(math.log2(16)) + 1
    for n in (1, 2, 3, 5, 7, 9, 11, 13, 15, 16):
        te.infer(_x(n))
        te.submit(_x(n)).result(timeout=30)
    assert tenv().compile_count() == warmed
    assert te.warmup(_x(1), batch_sizes=[3, 12]) == [4, 16]
    assert tenv().compile_count() == warmed
    te.close()
    je.close()


def test_census_listener_and_metric():
    _, tnet = _pair()
    seen = []
    tenv().add_compile_listener(seen.append)
    try:
        tenv().set_inference_max_batch(16)
        tnet.output(_x(3))   # bucket 4
        tnet.output(_x(4))   # same shape: no new event
        tnet.output(_x(9))   # bucket 16
    finally:
        tenv().remove_compile_listener(seen.append)
    assert len(seen) == tenv().compile_count() == 2
    fam = tregistry().counter("dl4j_compiles_total", labels=("kind",
                                                             "cache"))
    assert fam.labels(kind="mln", cache="eager").value() >= 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_written_by_one_side_warms_the_other(nets, tmp_path,
                                                      writer):
    jnet, tnet = nets
    paths = {s: str(tmp_path / f"{s}.warmup.json") for s in ("jax", "torch")}
    engines = {"jax": jinf.InferenceEngine(jnet, max_batch=16,
                                           manifest_path=paths["jax"]),
               "torch": tinf.InferenceEngine(tnet, max_batch=16,
                                             manifest_path=paths["torch"])}
    for eng in engines.values():
        for n in (3, 5, 9):
            eng.infer(_x(n))
        eng.close()
    docs = {s: json.load(open(p)) for s, p in paths.items()}
    assert docs["torch"] == docs["jax"]
    assert docs["torch"]["entries"] == [
        {"inputs": [{"shape": [N_IN], "dtype": "float32"}],
         "buckets": [4, 8, 16]}]
    reader = "jax" if writer == "torch" else "torch"
    jnew, tnew = _pair()
    fresh = (jinf.InferenceEngine(jnew, max_batch=16) if reader == "jax"
             else tinf.InferenceEngine(tnew, max_batch=16))
    env = jenv() if reader == "jax" else tenv()
    env.reset_compile_count()
    assert fresh.warmup(manifest=paths[writer]) == [4, 8, 16]
    assert env.compile_count() == 3
    if reader == "torch":
        assert fresh.observed_entries() == engines["jax"].observed_entries()
    fresh.close()


def test_warmup_from_observed_entries_and_missing_manifest(nets, tmp_path):
    _, tnet = nets
    src = tinf.InferenceEngine(tnet, max_batch=8)
    src.infer(_x(3))
    dst = tinf.InferenceEngine(tnet, max_batch=8)
    assert dst.warmup(entries=src.observed_entries()) == [4]
    assert dst.warmup(manifest=str(tmp_path / "absent.json")) == []
    (tmp_path / "junk.json").write_text("{not json")
    assert tinf.InferenceEngine.load_manifest(
        str(tmp_path / "junk.json")) == []
    src.close()
    dst.close()


def test_stats_keys_match_jax(nets):
    jnet, tnet = nets
    te = tinf.InferenceEngine(tnet, max_batch=8)
    je = jinf.InferenceEngine(jnet, max_batch=8)
    te.infer(_x(3))
    je.infer(_x(3))
    ts, js = te.stats(), je.stats()
    # the port adds its captured signatures (runtime/cuda_graphs.py)
    assert set(ts) == set(js) | {"graphs"}
    assert ts["graphs"] and {g["cache"] for g in ts["graphs"]} == {"eager"}
    assert ts["requests"] == 1 and ts["dispatches"] == 1
    assert ts["rows_real"] == 3 and ts["rows_padded"] == 1
    assert ts["bucket_dispatches"] == js["bucket_dispatches"] == {4: 1}
    assert ts["buckets"] == js["buckets"] == [1, 2, 4, 8]
    assert ts["padding_overhead"] == pytest.approx(js["padding_overhead"])


def test_unservable_models_refused(graphs):
    """A ComputationGraph is served (the graph cases below); a SameDiff
    graph is served with ``outputs=`` (``tests/test_torch_samediff_bert.py``)
    and refused without, as the JAX engine refuses it; anything else is
    no model."""
    class SameDiffish:
        _vars = {}

        def make_function(self):
            pass
    assert isinstance(tinf._make_adapter(graphs[1], None),
                      tinf._GraphAdapter)
    assert isinstance(tinf._make_adapter(SameDiffish(), ["y"]),
                      tinf._SameDiffAdapter)
    with pytest.raises(ValueError, match="outputs"):
        tinf.InferenceEngine(SameDiffish())
    with pytest.raises(TypeError, match="cannot serve"):
        tinf.InferenceEngine(torch.nn.Linear(4, 2))


# -- the ComputationGraph adapter ---------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    return _graph_pair()


def test_graph_infer_matches_jax_for_array_list_and_dict(graphs):
    """One array, a list in input order and a name -> array dict give the
    same list of outputs, on both sides, at every size."""
    jnet, tnet = graphs
    je = jinf.InferenceEngine(jnet, max_batch=16)
    te = tinf.InferenceEngine(tnet, max_batch=16)
    for n in (1, 3, 5, 16):
        x = _x(n)
        ref = je.infer(x)
        for req in (x, [x], {"in": x}):
            got = te.infer(req)
            assert isinstance(got, list) and len(got) == len(ref) == 1
            assert tuple(got[0].shape) == (n, N_OUT)
            _close(_np(got[0]), _np(ref[0]))
    with pytest.raises(ValueError, match="expects 1 inputs"):
        te.infer([_x(2), _x(2)])
    # three request forms a size on the port's side, one on JAX's
    assert te.stats()["bucket_dispatches"] == {
        b: 3 * c for b, c in je.stats()["bucket_dispatches"].items()}
    te.close()
    je.close()


def test_graph_padded_matches_exact_shape(graphs):
    """``tests/test_inference_engine.py::test_graph_bitwise``'s cases,
    held with allclose (see the module docstring)."""
    jnet, tnet = graphs
    for n in (3, 5, 9):
        x = _x(n)
        tenv().set_inference_bucketing(False)
        exact = tnet.output(x)[0].numpy()
        tenv().set_inference_bucketing(True)
        _close(tnet.output(x)[0].numpy(), exact)
        _close(exact, np.asarray(jnet.output(x)[0].jax()))


def test_graph_submit_and_warmup_census(graphs):
    """The micro-batcher over a graph: a future resolves to the list of
    outputs on the host; after warmup the ladder adds no dispatch shape."""
    _, tnet = graphs
    te = tinf.InferenceEngine(tnet, max_batch=8)
    assert te.warmup({"in": _x(1)}) == [1, 2, 4, 8]
    c0 = tenv().compile_count()
    futs = [te.submit({"in": _x(n, seed=n)}) for n in (1, 2, 3)]
    for n, f in zip((1, 2, 3), futs):
        out = f.result(timeout=30)
        assert out[0].torch().device.type == "cpu"
        _close(out[0].numpy(), tnet.output(_x(n, seed=n))[0].numpy())
    assert tenv().compile_count() == c0
    te.close()


def test_sharded_engine_refused(nets):
    """A serving mesh is now taken; what is refused is a mesh without
    the ``data`` axis, as by the reference. The name is kept from the
    refusal of every ``mesh=``."""
    from deeplearning4j_tpu_torch.common.mesh import Mesh, serving_mesh
    eng = tinf.InferenceEngine(nets[1], mesh=serving_mesh(device="cpu"))
    assert eng.stats()["param_spec"] == "auto(model)"
    eng.close(5)
    with pytest.raises(ValueError, match="missing required"):
        tinf.InferenceEngine(nets[1], mesh=Mesh([0], ("model",), "cpu"))


# -- poison isolation, device faults, deadlines, drain -----------------------

def _nan_predicate(ctx):
    """Poison marker: the dispatch's inputs carry a NaN."""
    return any(torch.isnan(torch.as_tensor(i)).any()
               for i in ctx.get("inputs", ()))


def test_poison_rider_quarantined_innocents_succeed(nets):
    _, tnet = nets
    eng = tinf.InferenceEngine(tnet, max_batch=16, max_delay_ms=50.0)
    eng.warmup(_x(1))
    expected = eng.infer(_x(2, seed=2)).numpy()
    q = tregistry().counter("dl4j_quarantined_requests_total")
    q_before = q.value()
    rule, release, entered = _gate(tfaults)
    poison_rule = tfaults.inject("engine.dispatch",
                                 predicate=_nan_predicate)
    try:
        blocker = eng.submit(_x(1))
        assert entered.wait(30)
        poison = _x(2, seed=1)
        poison[0, 0] = np.nan
        f_poison = eng.submit(poison)
        f_a = eng.submit(_x(2, seed=2))
        f_b = eng.submit(_x(2, seed=3))
        assert _wait(lambda: len(eng._pending) == 3)
        release.set()
        blocker.result(timeout=30)
        _close(f_a.result(timeout=30).numpy(), expected)
        assert f_b.result(timeout=30).numpy().shape == (2, N_OUT)
        with pytest.raises(tinf.PoisonRequestError, match="quarantined"):
            f_poison.result(timeout=30)
    finally:
        release.set()
        tfaults.remove(rule)
        tfaults.remove(poison_rule)
    assert q.value() == q_before + 1
    assert eng.stats()["coalesced"] == 3
    assert not eng.worker_dead
    eng.close()


def test_transient_fault_retried_disposition_recorded(nets):
    _, tnet = nets
    eng = tinf.InferenceEngine(tnet, max_batch=16, max_delay_ms=20.0)
    eng.warmup(_x(1))
    ctx = TraceContext(new_trace_id(), new_span_id(), None)
    with tfaults.injected("engine.dispatch", times=1):
        with use_context(ctx):
            fut = eng.submit(_x(2, seed=4))
        assert fut.result(timeout=30).numpy().shape == (2, N_OUT)
    assert pop_disposition(ctx.trace_id) == "retried"
    eng.close()


def test_device_fault_is_not_a_poison_request(nets):
    """A card-side error fails its riders as it is and stops the batcher:
    it is neither quarantined nor retried."""
    _, tnet = nets
    eng = tinf.InferenceEngine(tnet, max_batch=8)
    eng.warmup(_x(1))

    def crash(padded):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    q = tregistry().counter("dl4j_quarantined_requests_total")
    q_before = q.value()
    # the card fails inside the dispatch (a raising fault predicate never
    # injects, as in the JAX package)
    eng._adapter.run = crash
    fut = eng.submit(_x(2))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fut.result(timeout=30)
    assert _wait(lambda: eng.worker_dead)
    assert q.value() == q_before
    with pytest.raises(tinf.EngineClosedError, match="dead"):
        eng.submit(_x(2))
    assert tinf.is_device_fault(RuntimeError(
        "dequant_matmul: CUDA launch failed: unspecified launch failure"))
    assert not tinf.is_device_fault(RuntimeError("mat1 and mat2 shapes"))
    eng.close()


def test_batcher_crash_restarts_and_serves(nets):
    _, tnet = nets
    eng = tinf.InferenceEngine(tnet, max_batch=8, max_delay_ms=1.0)
    eng.warmup(_x(1))
    child = tregistry().counter("dl4j_engine_restarts_total",
                                labels=("engine",)).labels(
                                    engine="inference")
    before = child.value()
    with tfaults.injected("engine.batcher", times=2):
        outs = [eng.submit(_x(2, seed=i)).result(timeout=30)
                for i in range(3)]
    assert all(o.numpy().shape == (2, N_OUT) for o in outs)
    assert child.value() >= before + 1
    assert not eng.worker_dead
    eng.close()


def test_deadline_expires_before_dispatch(nets):
    _, tnet = nets
    eng = tinf.InferenceEngine(tnet, max_batch=8)
    expired = tregistry().counter("dl4j_inference_deadline_expired_total")
    before = expired.value()
    rule, release, entered = _gate(tfaults)
    try:
        blocker = eng.submit(_x(1))
        assert entered.wait(30)
        late = eng.submit(_x(2), timeout_s=0.0)
    finally:
        release.set()
        tfaults.remove(rule)
    blocker.result(timeout=30)
    with pytest.raises(TimeoutError, match="deadline"):
        late.result(timeout=30)
    assert expired.value() == before + 1
    eng.close()


def test_drain_then_start_then_close(nets):
    _, tnet = nets
    eng = tinf.InferenceEngine(tnet, max_batch=8)
    assert eng.submit(_x(2)).result(timeout=30).numpy().shape == (2, N_OUT)
    assert eng.drain(timeout_s=10) is True
    assert eng.draining
    with pytest.raises(tinf.EngineClosedError, match="draining"):
        eng.submit(_x(2))
    with pytest.raises(tinf.EngineClosedError):
        eng.infer(_x(2))
    eng.start()
    assert eng.submit(_x(2)).result(timeout=30).numpy().shape == (2, N_OUT)
    assert eng.close(timeout_s=10) is True
    assert eng.closed
    with pytest.raises(tinf.EngineClosedError, match="closed"):
        eng.start()


# -- the layer API's bucketed output ------------------------------------------

def test_output_bucketed_matches_jax_and_census_bound():
    jnet, tnet = _pair()
    for e in (jenv(), tenv()):
        e.set_inference_max_batch(16)
        e.reset_compile_count()
    sizes = [1, 2, 3, 5, 7, 9, 11, 13, 15, 16, 20]
    for n in sizes:
        x = _x(n)
        _close(tnet.output(x).numpy(), np.asarray(jnet.output(x).jax()))
        np.testing.assert_array_equal(tnet.predict(x).numpy(),
                                      np.asarray(jnet.predict(x).jax()))
    # 20 rows is above the ladder: one exact-shape event on each side
    assert tenv().compile_count() == jenv().compile_count() \
        <= math.ceil(math.log2(16)) + 2


def test_warm_buckets_returns_the_jax_list(nets):
    jnet, tnet = nets
    for e in (jenv(), tenv()):
        e.set_inference_max_batch(8)
    assert tnet.warm_buckets(_x(1)) == jnet.warm_buckets(_x(1)) == \
        [1, 2, 4, 8]
    assert tnet.warm_buckets(_x(1), batch_sizes=[3, 5]) == \
        jnet.warm_buckets(_x(1), batch_sizes=[3, 5]) == [4, 8]
    with pytest.raises(NotImplementedError, match="item 12"):
        tnet.warm_compile(_x(2))


# -- full_f32 with concurrent holders -----------------------------------------

def test_full_f32_holds_for_two_overlapping_threads():
    """Thread A enters, thread B enters, A leaves: TF32 must stay off
    until B leaves too, then come back as it was."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = tuple(f.allow_tf32 for f in flags)
    for f in flags:
        f.allow_tf32 = True
    a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with fit_fastpath.full_f32():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with fit_fastpath.full_f32():
            b_in.set()
            a_out.wait(10)
            seen["after_a_left"] = tuple(f.allow_tf32 for f in flags)
            b_go.wait(10)
    try:
        ta, tb = threading.Thread(target=a), threading.Thread(target=b)
        ta.start()
        tb.start()
        assert a_out.wait(10)
        assert _wait(lambda: "after_a_left" in seen, 10)
        assert seen["after_a_left"] == (False, False)
        b_go.set()
        ta.join(10)
        tb.join(10)
        assert not ta.is_alive() and not tb.is_alive()
        assert tuple(f.allow_tf32 for f in flags) == (True, True)
        with fit_fastpath.full_f32():
            with fit_fastpath.full_f32():
                assert tuple(f.allow_tf32 for f in flags) == (False, False)
            assert tuple(f.allow_tf32 for f in flags) == (False, False)
        assert tuple(f.allow_tf32 for f in flags) == (True, True)
    finally:
        b_go.set()
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


# -- the predict route, JAX server and port server side by side --------------

def _post(url, body, headers=None, timeout=60):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json",
                                 **(headers or {})})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _get(url, timeout=30):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture(scope="module")
def served(nets):
    """{"jax": (registry, server, base url), "torch": (...)}, each
    serving the bridged MLP as ``mlp:v1`` (max_batch 16, warmed)."""
    out = {}
    for side, pkg, net in (("jax", jserving, nets[0]),
                           ("torch", tserving, nets[1])):
        reg = pkg.ModelRegistry(manifest_dir=None, retain=1)
        reg.deploy("mlp", "v1", net, example=_x(1), max_batch=16)
        srv = pkg.ModelServer(reg)
        out[side] = (reg, srv, f"http://127.0.0.1:{srv.start()}")
    yield out
    for side in ("jax", "torch"):
        reg, srv, _ = out[side]
        srv.stop()
        reg.drain_all(timeout_s=10, save_manifests=False)


def _both(served, fn):
    return {s: fn(*served[s]) for s in ("jax", "torch")}


@pytest.mark.parametrize("n", [1, 3, 16, 21])
def test_predict_json_matches_jax(served, n):
    x = _x(n, seed=7)
    got = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp/predict", {"inputs": x.tolist()}))
    docs = {}
    for s, (status, headers, body) in got.items():
        assert status == 200 and headers.get("X-Trace-Id"), s
        docs[s] = json.loads(body)
    assert set(docs["torch"]) == set(docs["jax"])
    assert docs["torch"]["model"] == "mlp"
    assert docs["torch"]["version"] == docs["jax"]["version"] == "v1"
    _close(np.asarray(docs["torch"]["outputs"], np.float32),
           np.asarray(docs["jax"]["outputs"], np.float32))


def test_predict_npy_payload_matches_jax(served):
    import io
    x = _x(5, seed=8)
    buf = io.BytesIO()
    np.save(buf, x)
    got = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp/predict", buf.getvalue(),
        headers={"Content-Type": "application/x-npy"}))
    arrs = {}
    for s, (status, headers, body) in got.items():
        assert status == 200 and headers["X-Model-Version"] == "v1", s
        arrs[s] = np.load(io.BytesIO(body), allow_pickle=False)
    assert arrs["torch"].dtype == arrs["jax"].dtype == np.float32
    _close(arrs["torch"], arrs["jax"])


STATUS_CASES = [
    ("unknown_model", "/v1/models/nope/predict", {"inputs": [[1.0] * 6]}),
    ("unknown_version", "/v1/models/mlp:v9/predict", {"inputs": [[1.0] * 6]}),
    ("no_inputs", "/v1/models/mlp/predict", {}),
    ("ragged_inputs", "/v1/models/mlp/predict", {"inputs": [[1.0], [1, 2]]}),
    ("wrong_width", "/v1/models/mlp/predict", {"inputs": [[1.0] * 5]}),
    ("generate_on_predictive", "/v1/models/mlp/generate", {"prompt": [1]}),
    ("unknown_route", "/v1/nothing", {}),
]


@pytest.mark.parametrize("path,body", [c[1:] for c in STATUS_CASES],
                         ids=[c[0] for c in STATUS_CASES])
def test_error_status_matches_jax(served, path, body):
    got = _both(served, lambda reg, srv, base: _post(base + path, body))
    assert got["torch"][0] == got["jax"][0] >= 400, \
        (got["torch"][0], got["jax"][0])


def test_poison_answers_422_with_trace_id(served):
    got = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp/predict", {"inputs": [[1.0] * 5] * 2}))
    for s, (status, headers, body) in got.items():
        doc = json.loads(body)
        assert status == 422, s
        assert doc["quarantined"] is True
        assert doc["trace_id"] == headers["X-Trace-Id"]
    ok = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp/predict", {"inputs": _x(2).tolist()}))
    assert ok["torch"][0] == ok["jax"][0] == 200


def test_overload_429_matches_jax(served):
    got = {}
    for s, pkg in (("jax", jserving), ("torch", tserving)):
        reg, srv, base = served[s]
        ctrl = pkg.AdmissionController("mlp", max_concurrent=1,
                                       queue_depth=1, high_water=0,
                                       default_timeout_s=None)
        srv.set_admission("mlp", ctrl)
        permit = ctrl.admit()  # hold the only slot; high_water=0 -> shed
        try:
            got[s] = _post(base + "/v1/models/mlp/predict",
                           {"inputs": _x(2).tolist()})
        finally:
            permit.__exit__(None, None, None)
            srv.set_admission("mlp", pkg.AdmissionController("mlp"))
    for s, (status, headers, body) in got.items():
        assert status == 429, s
        assert int(headers["Retry-After"]) >= 1
        assert json.loads(body)["retry_after_s"] > 0


def test_models_listing_keys_match_jax(served):
    docs = _both(served, lambda reg, srv, base: json.loads(
        _get(base + "/v1/models")[2]))
    t, j = docs["torch"]["models"]["mlp"], docs["jax"]["models"]["mlp"]
    assert set(t) == set(j)
    tv, jv = t["versions"][0], j["versions"][0]
    assert set(tv) == set(jv)
    for k in ("version", "state", "buckets", "max_batch", "generative",
              "precision", "param_bytes"):
        assert tv[k] == jv[k], k
    assert tv["generative"] is False


def test_hot_swap_pins_retired_409_and_rollback(served, nets):
    """A v2 deploy warms from v1's observed traffic; v1 pinned answers
    409 once parked; rollback restores it."""
    for s, net in (("jax", nets[0]), ("torch", nets[1])):
        reg, _, _ = served[s]
        reg.deploy("mlp", "v2", net, max_batch=16)
        assert reg.get("mlp").state == "ready"
    got = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp:v1/predict", {"inputs": _x(2).tolist()}))
    assert got["torch"][0] == got["jax"][0] == 409
    got = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp/predict", {"inputs": _x(3).tolist()}))
    for s, (status, _, body) in got.items():
        assert status == 200 and json.loads(body)["version"] == "v2", s
    for s in ("jax", "torch"):
        assert served[s][0].rollback("mlp").version == "v1"
    got = _both(served, lambda reg, srv, base: _post(
        base + "/v1/models/mlp/predict", {"inputs": _x(3).tolist()}))
    for s, (status, _, body) in got.items():
        assert status == 200 and json.loads(body)["version"] == "v1", s


def test_registry_predict_chunks_oversize_and_warm(served, nets):
    """registry.predict over max_batch takes the chunked sync path;
    deploy(warm=False) stays not-ready until warm()."""
    reg, _, _ = served["torch"]
    out = reg.predict("mlp", _x(40, seed=3))
    assert out.numpy().shape == (40, N_OUT)
    _close(out.numpy(), nets[1].output(_x(40, seed=3)).numpy())
    cold = tserving.ModelRegistry(manifest_dir=None)
    cold.deploy("cold", "v1", nets[1], warm=False, max_batch=8)
    assert not cold.ready()
    assert cold.warm("cold", example=_x(1)) == [1, 2, 4, 8]
    assert cold.ready()
    cold.drain_all(timeout_s=10, save_manifests=False)


def test_quantized_mln_deploy_serves_the_twin(nets):
    """deploy(quantize="int8") of a layer-API network: the twin passes
    the gate and answers through the predict route."""
    reg = tserving.ModelRegistry(manifest_dir=None)
    try:
        calib = _x(32, seed=11)
        # min_size=1: the toy network's weights are below the default
        mv = reg.deploy("q", "v1", nets[1],
                        quantize=tquant.QuantSpec(min_size=1),
                        calibration_batch=calib, max_batch=16,
                        quant_max_divergence=1.0, quant_min_top1=0.5)
        assert mv.precision == "int8" and mv.divergence
        out = reg.predict("q", _x(5, seed=12)).numpy()
        assert out.shape == (5, N_OUT) and np.isfinite(out).all()
        assert np.allclose(out.sum(-1), 1.0, atol=1e-5)
    finally:
        reg.drain_all(timeout_s=10, save_manifests=False)


def test_engine_manifest_lands_in_the_registry_dir(tmp_path, nets):
    reg = tserving.ModelRegistry(manifest_dir=str(tmp_path))
    try:
        reg.deploy("m", "v1", nets[1], example=_x(1), max_batch=4)
        reg.predict("m", _x(3))
        path = reg.manifest_path("m")
        assert os.path.exists(path)
        # the warmed ladder and the live bucket, as the JAX package's
        assert json.load(open(path))["entries"][0]["buckets"] == [1, 2, 4]
    finally:
        reg.drain_all(timeout_s=10, save_manifests=False)


def test_graph_deploy_and_predict_over_http_match_jax(graphs):
    """A ComputationGraph deploys, warms and answers ``POST /predict`` with
    its list of outputs, as the JAX package's server does; a request it
    cannot run (wrong width) answers 422 on both."""
    out = {}
    try:
        for side, pkg, net in (("jax", jserving, graphs[0]),
                               ("torch", tserving, graphs[1])):
            reg = pkg.ModelRegistry(manifest_dir=None)
            mv = reg.deploy("cg", "v1", net, example=_x(1), max_batch=8)
            assert mv.state == "ready"
            srv = pkg.ModelServer(reg)
            out[side] = (reg, srv, f"http://127.0.0.1:{srv.start()}")
        x = _x(3, seed=9)
        docs = {}
        for side, (_, _, base) in out.items():
            status, _, body = _post(base + "/v1/models/cg/predict",
                                    {"inputs": x.tolist()})
            assert status == 200, side
            docs[side] = json.loads(body)
        t = np.asarray(docs["torch"]["outputs"], np.float32)
        assert t.shape == (1, 3, N_OUT)
        _close(t, np.asarray(docs["jax"]["outputs"], np.float32))
        _close(t[0], graphs[1].output(x)[0].numpy())
        for side, (_, _, base) in out.items():
            status, _, body = _post(base + "/v1/models/cg/predict",
                                    {"inputs": [[1.0] * (N_IN - 1)] * 2})
            assert status == 422, side
            assert json.loads(body)["quarantined"] is True
    finally:
        for reg, srv, _ in out.values():
            srv.stop()
            reg.drain_all(timeout_s=10, save_manifests=False)
