"""The port's serving fleet (``serving/fleet/``) against the JAX package's.

The routing arithmetic (session hashing, the consistent-hash ring,
prompt fingerprints, priorities, the retry budget), the poll parser and
the metrics aggregator run on the same inputs on both sides and must
agree exactly: they are host code with no float tolerance to allow.
Least-loaded choice runs over stub replicas (``tests/test_fleet.py``'s
``_stub_replica``). The live cases run two port replicas (each a port
``ModelServer`` over ``tests/test_inference_engine.py``'s MLP on the CPU)
behind the port's router and front door: failover on a stopped replica,
the front door's merged ``/metrics`` and a mid-stream error.

No wall-clock threshold is asserted; hedging and poll-jitter timing stay
in the JAX package's own tests. Every HTTP call carries a timeout.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.serving.fleet import aggregator as jagg
from deeplearning4j_tpu.serving.fleet import router as jrouter

from deeplearning4j_tpu_torch import serving as tserving
from deeplearning4j_tpu_torch.common import faults as tfaults
from deeplearning4j_tpu_torch.common.metrics import registry as tregistry
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.serving.fleet import aggregator as tagg
from deeplearning4j_tpu_torch.serving.fleet import router as trouter

N_IN, N_OUT = 6, 3
SIDES = (("jax", jrouter), ("torch", trouter))


# -- routing arithmetic --------------------------------------------------------

SESSION_KEYS = ["sess-0", "sess-1", "user/42", "", "pfx:" + "ab" * 20,
                "ünïcode-key"]


@pytest.mark.parametrize("key", SESSION_KEYS)
def test_session_hash_matches_jax(key):
    assert trouter.FleetRouter.session_hash(key) == \
        jrouter.FleetRouter.session_hash(key)


REPLICA_SETS = [["http://r0:1"], ["http://r0:1", "http://r1:1"],
                [f"http://10.0.0.{i}:8000" for i in range(5)]]


@pytest.mark.parametrize("urls", REPLICA_SETS,
                         ids=[f"{len(u)}_replicas" for u in REPLICA_SETS])
def test_affine_url_matches_jax(urls):
    routers = {}
    for side, mod in SIDES:
        r = mod.FleetRouter(poll_s=3600)
        for u in urls:
            r.add_replica(u, poll=False)
        routers[side] = r
    keys = [f"sess-{i}" for i in range(200)]
    assert [routers["torch"].affine_url(k) for k in keys] == \
        [routers["jax"].affine_url(k) for k in keys]
    assert routers["torch"].snapshot()["affinity"] == \
        routers["jax"].snapshot()["affinity"]
    routers["torch"].remove_replica(urls[0])
    routers["jax"].remove_replica(urls[0])
    assert [routers["torch"].affine_url(k) for k in keys] == \
        [routers["jax"].affine_url(k) for k in keys]


FINGERPRINT_CASES = [("lm", [1, 2, 3]), (None, []), ("lm", list(range(40))),
                     ("other", list(range(40))), ("lm", list(range(33)))]


@pytest.mark.parametrize("model,prompt", FINGERPRINT_CASES)
def test_prompt_fingerprint_matches_jax(model, prompt):
    assert trouter.prompt_fingerprint(model, prompt) == \
        jrouter.prompt_fingerprint(model, prompt)


PRIORITY_CASES = [(None, 5), ("7", 5), (" 3 ", 5), ("12", 5), ("-4", 2),
                  ("high", 5), ("0", 9)]


@pytest.mark.parametrize("raw,default", PRIORITY_CASES)
def test_parse_priority_matches_jax(raw, default):
    assert trouter._parse_priority(raw, default) == \
        jrouter._parse_priority(raw, default)


BUDGET_CASES = [(0.5, 2.0), (0.0, None), (0.2, None), (3.0, None),
                (-1.0, None), (1.0, 1.0)]


@pytest.mark.parametrize("ratio,burst", BUDGET_CASES)
def test_retry_budget_arithmetic_matches_jax(ratio, burst):
    """The same sequence of dispatches and spends on both sides gives the
    same decisions and the same token counts."""
    budgets = {s: m.RetryBudget(ratio, burst=burst) for s, m in SIDES}
    trace = {s: [] for s in budgets}
    ops = ["spend"] * 3 + ["dispatch", "spend"] * 4 + ["dispatch"] * 100 \
        + ["spend"] * 60
    for side, b in budgets.items():
        for op in ops:
            if op == "spend":
                trace[side].append(b.try_spend())
            else:
                b.record_dispatch()
            trace[side].append(round(b.tokens, 9))
        trace[side].append(b.snapshot())
    assert trace["torch"] == trace["jax"]
    b = budgets["torch"]
    assert 0.0 <= b.ratio <= 1.0 and b.tokens <= b.burst


# -- the poll parser and the aggregator ----------------------------------------

def _metrics_docs():
    good = {
        "dl4j_serving_ewma_service_seconds": {"type": "gauge", "series": [
            {"labels": {"model": "toy"}, "value": 0.25},
            {"labels": {"model": "other"}, "value": "0.5"}]},
        "dl4j_serving_waiters": {"type": "gauge", "series": [
            {"labels": {"model": "toy"}, "value": 3}]},
        "dl4j_serving_queue_depth": {"type": "gauge", "series": [
            {"labels": {"model": "toy"}, "value": 2}]},
        "dl4j_serving_active": {"type": "gauge", "series": [
            {"labels": {"model": "toy"}, "value": 1}]},
    }
    junk = {
        "dl4j_serving_ewma_service_seconds": {"series": [
            {"labels": {"model": "toy"}, "value": "0.25"},
            {"labels": {"model": "bad"}, "value": "wat"},
            {"labels": {"model": "nan"}, "value": float("nan")},
            {"labels": "junk"},
            "junk",
        ]},
        "dl4j_serving_waiters": "junk",
        "dl4j_serving_queue_depth": {"series": "junk"},
    }
    return [("good", good), ("junk", junk), ("empty", {}),
            ("unrelated", {"dl4j_other": {"series": []}})]


@pytest.mark.parametrize("name,doc", _metrics_docs(),
                         ids=[d[0] for d in _metrics_docs()])
def test_parse_metrics_json_matches_jax(name, doc):
    assert trouter._parse_metrics_json(doc) == \
        jrouter._parse_metrics_json(doc)


def test_parse_metrics_json_rejects_non_objects():
    for mod in (trouter, jrouter):
        with pytest.raises(ValueError, match="non-object"):
            mod._parse_metrics_json([1, 2, 3])


def _replica_doc(requests, lat_counts, waiters):
    bounds = [0.001, 0.01, 0.1, 1.0]
    return {
        "dl4j_serving_requests_total": {
            "type": "counter", "help": "requests", "series": [
                {"labels": {"model": "toy", "outcome": "ok"},
                 "value": requests}]},
        "dl4j_serving_waiters": {
            "type": "gauge", "help": "waiters", "series": [
                {"labels": {"model": "toy"}, "value": waiters}]},
        "dl4j_serving_latency_seconds": {
            "type": "histogram", "help": "latency", "series": [
                {"labels": {"model": "toy"}, "bounds": bounds,
                 "bucket_counts": lat_counts, "count": sum(lat_counts),
                 "sum": 0.01 * sum(lat_counts)}]},
    }


def test_aggregator_merge_matches_jax():
    """Two replicas' scrapes, one of them restarting (its counter snaps
    back), folded by both aggregators: the same merged exposition, the
    same Prometheus text and the same signals."""
    scrapes = [("http://a:1", _replica_doc(10, [1, 4, 2, 0, 0], 3)),
               ("http://b:1", _replica_doc(5, [0, 1, 1, 1, 0], 1)),
               ("http://a:1", _replica_doc(14, [1, 6, 3, 0, 1], 2)),
               ("http://b:1", _replica_doc(2, [0, 1, 0, 0, 0], 0)),
               ("http://b:1", "not a dict")]
    aggs = {"jax": jagg.FleetAggregator(retention_s=600, max_samples=16),
            "torch": tagg.FleetAggregator(retention_s=600, max_samples=16)}
    for agg in aggs.values():
        for rep, doc in scrapes:
            agg.ingest(rep, doc)
    t, j = aggs["torch"].snapshot(), aggs["jax"].snapshot()
    assert t == j
    merged = next(s for s in t["dl4j_serving_requests_total"]["series"]
                  if "replica" not in s["labels"])
    assert merged["value"] == 14 + 5 + 2   # b's restart adds, not subtracts
    assert tagg.render_prometheus_text(t) == jagg.render_prometheus_text(j)
    local = {"dl4j_router_dispatch_total": {
        "type": "counter", "help": "", "series": [
            {"labels": {"replica": "http://a:1", "outcome": "ok"},
             "value": 3}]}}
    assert aggs["torch"].merged_with(local) == aggs["jax"].merged_with(local)
    aggs["torch"].forget("http://b:1")
    aggs["jax"].forget("http://b:1")
    assert aggs["torch"].snapshot() == aggs["jax"].snapshot()


QUANTILE_CASES = [((0.1, 1.0, 10.0), [0, 0, 0, 0], 0.5),
                  ((0.1, 1.0, 10.0), [5, 5, 0, 0], 0.5),
                  ((0.1, 1.0, 10.0), [1, 2, 3, 4], 0.99),
                  ((0.1, 1.0, 10.0), [1, 2, 3, 4], 0.0),
                  ((0.001,), [3, 1], 0.9),
                  ((), [2], 0.5)]


@pytest.mark.parametrize("bounds,counts,q", QUANTILE_CASES)
def test_histogram_quantile_matches_jax(bounds, counts, q):
    assert tagg.histogram_quantile(bounds, counts, q) == \
        jagg.histogram_quantile(bounds, counts, q)


# -- least-loaded choice over stub replicas ------------------------------------

def _stub_replica(mod, router, url, model="toy", ewma=0.01, waiters=0,
                  ready=True):
    """Inject a polled view without HTTP (pure routing-policy tests)."""
    rep = mod.Replica(url)
    rep.ready = ready
    rep.models = [model]
    rep.load = {model: {"ewma_s": ewma, "queue_depth": 0.0,
                        "active": 0.0, "waiters": float(waiters)}}
    router._replicas[rep.url] = rep
    return rep


STUB_FLEETS = [
    ("skewed", [("http://busy:1", 0.5, 20, True),
                ("http://idle:1", 0.01, 0, True)]),
    ("not_ready", [("http://down:1", 0.001, 0, False),
                   ("http://up:1", 0.5, 4, True)]),
    ("ties", [("http://a:1", 0.1, 0, True), ("http://b:1", 0.1, 0, True),
              ("http://c:1", 0.2, 1, True)]),
]


@pytest.mark.parametrize("name,stubs", STUB_FLEETS,
                         ids=[f[0] for f in STUB_FLEETS])
def test_least_loaded_choice_matches_jax(name, stubs):
    order = {}
    for side, mod in SIDES:
        router = mod.FleetRouter(poll_s=3600, retries=1)
        for url, ewma, waiters, ready in stubs:
            _stub_replica(mod, router, url, ewma=ewma, waiters=waiters,
                          ready=ready)
        order[side] = [r.url for r in router._candidates("toy")]
        if name == "ties":
            # router-side in-flight work spreads a burst between polls
            router._replicas[order[side][0]].inflight += 1
            order[side + "_after"] = [r.url for r in
                                      router._candidates("toy")]
    assert order["torch"] == order["jax"]
    if name == "skewed":
        assert order["torch"][0] == "http://idle:1"
    if name == "not_ready":
        assert order["torch"] == ["http://up:1"]
    if name == "ties":
        assert order["torch_after"] == order["jax_after"]
        assert order["torch_after"][0] != order["torch"][0]


def test_no_replica_raises_on_both_sides():
    for _, mod in SIDES:
        router = mod.FleetRouter(poll_s=3600)
        with pytest.raises(mod.NoReplicaError):
            router.route("POST", "/v1/models/toy/predict", b"{}",
                         model="toy")


# -- live: two port replicas behind the port's router --------------------------

def _mlp():
    conf = (TNNC.builder().seed(0).list()
            .layer(DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=N_OUT))
            .build())
    return TMLN(conf, device="cpu").init()


def _x(n=4, seed=0):
    return np.random.RandomState(seed).randn(n, N_IN).astype(np.float32)


_CT = [("Content-Type", "application/json")]


class _Fleet:
    """N live port replicas + the port's router, torn down in reverse."""

    def __init__(self, n, **router_kw):
        self.net = _mlp()
        self.members = []
        urls = []
        for _ in range(n):
            reg = tserving.ModelRegistry(manifest_dir=None)
            reg.deploy("toy", "v1", self.net, example=_x(), max_batch=16)
            srv = tserving.ModelServer(reg)
            port = srv.start()
            self.members.append((reg, srv))
            urls.append(f"http://127.0.0.1:{port}")
        router_kw.setdefault("poll_s", 3600)
        router_kw.setdefault("timeout_s", 30)
        self.router = trouter.FleetRouter(urls, **router_kw)
        self.router.poll_once()

    def member_of(self, url):
        return next(i for i, (_, s) in enumerate(self.members)
                    if url.endswith(f":{s.port}"))

    def close(self):
        self.router.stop_polling()
        for reg, srv in self.members:
            try:
                srv.stop()
            except Exception:
                pass
            reg.drain_all(timeout_s=10, save_manifests=False)


@pytest.fixture
def fleet():
    f = _Fleet(2, retries=1)
    yield f
    f.close()


def _dispatches(url, outcome):
    return tregistry().counter(
        "dl4j_router_dispatch_total", labels=("replica", "outcome")).labels(
            replica=url, outcome=outcome).value()


def test_failover_on_a_stopped_replica(fleet):
    victim = fleet.router._candidates("toy")[0]
    fleet.members[fleet.member_of(victim.url)][1].stop()
    pre = _dispatches(victim.url, "failover")
    x = _x(4, seed=1)
    doc = fleet.router.predict("toy", x.tolist())
    np.testing.assert_allclose(np.asarray(doc["outputs"], np.float32),
                               fleet.net.output(x).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert _dispatches(victim.url, "failover") == pre + 1
    assert not victim.ready  # out of rotation until a poll
    fleet.router.poll_once()
    assert [r.url for r in fleet.router._candidates("toy")] != [victim.url]


def _urlopen(req, timeout=30):
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_front_door_proxies_and_merges_metrics(fleet):
    front = trouter.FleetServer(fleet.router)
    port = front.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for i in range(6):
            req = urllib.request.Request(
                base + "/v1/models/toy/predict",
                data=json.dumps({"inputs": _x(2, seed=i).tolist()}).encode(),
                headers=dict(_CT))
            status, headers, body = _urlopen(req)
            assert status == 200
            assert headers.get("X-Fleet-Replica") in \
                [r.url for r in fleet.router.replicas()]
            assert np.asarray(json.loads(body)["outputs"]).shape == \
                (2, N_OUT)
        fleet.router.poll_once()  # the aggregator rides the poll
        status, _, body = _urlopen(base + "/metrics.json")
        assert status == 200
        doc = json.loads(body)
        series = doc["dl4j_inference_requests_total"]["series"]
        per_rep = {s["labels"]["replica"]: s["value"] for s in series
                   if "replica" in s["labels"]}
        merged = [s["value"] for s in series if "replica" not in s["labels"]
                  and s["value"] == sum(per_rep.values())]
        assert set(per_rep) == {r.url for r in fleet.router.replicas()}
        assert merged and merged[-1] >= 6
        status, _, body = _urlopen(base + "/metrics")
        assert status == 200
        assert b'dl4j_inference_requests_total{replica="' in body
        status, _, body = _urlopen(base + "/readyz")
        assert status == 200 and json.loads(body)["ready"] is True
        status, _, body = _urlopen(base + "/fleet/signals")
        assert status == 200 and len(json.loads(body)["replicas"]) == 2
        status, _, _ = _urlopen(base + "/v1/models")
        assert status == 200
    finally:
        front.stop()


def test_mid_stream_error_is_never_retried(fleet):
    rule = tfaults.inject("fleet.dispatch", kind="error",
                          predicate=lambda ctx: ctx.get("phase") == "body")
    try:
        with pytest.raises(trouter.MidStreamError, match="not retried") as ei:
            fleet.router.route(
                "POST", "/v1/models/toy/predict",
                json.dumps({"inputs": _x().tolist()}).encode(),
                headers=_CT, model="toy", idempotent=False)
        assert ei.value.replica_url.startswith("http://")
        assert ei.value.trace_id  # the replica's X-Trace-Id carried out
        # an idempotent request retries the same failure to another try
        victim = fleet.router._candidates("toy")[0]
        tfaults.remove(rule)
        rule = tfaults.inject(
            "fleet.dispatch", kind="error",
            predicate=lambda ctx: ctx.get("url") == victim.url
            and ctx.get("phase") == "body")
        doc = fleet.router.predict("toy", _x().tolist())
        assert np.asarray(doc["outputs"]).shape == (4, N_OUT)
    finally:
        tfaults.remove(rule)


def test_front_door_maps_mid_stream_to_502_and_empty_fleet_to_503(fleet):
    front = trouter.FleetServer(fleet.router)
    port = front.start()
    rule = tfaults.inject("fleet.dispatch", kind="error",
                          predicate=lambda ctx: ctx.get("phase") == "body")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/toy/generate",
            data=json.dumps({"prompt": [1, 2, 3]}).encode(),
            headers=dict(_CT))
        status, _, body = _urlopen(req)
        assert status == 502
        doc = json.loads(body or b"{}")
        assert "mid-stream" in doc["error"] and doc.get("trace_id")
    finally:
        tfaults.remove(rule)
        front.stop()
    empty = trouter.FleetServer(trouter.FleetRouter(poll_s=3600))
    port = empty.start()
    try:
        assert _urlopen(f"http://127.0.0.1:{port}/readyz")[0] == 503
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/toy/predict",
            data=b'{"inputs": []}', headers=dict(_CT))
        assert _urlopen(req)[0] == 503
    finally:
        empty.stop()
