"""The port's HTTP serving layer against the JAX package's, on the same
weights.

One module-scoped served registry per side: the JAX package's
``ModelRegistry`` + ``ModelServer`` and the port's, each serving the
tiny CausalLM of ``test_torch_causal_lm.model_pair`` (2 layers, vocab
97, weights bridged from the JAX side) as ``lm:v1`` with ``slots=2,
max_ctx=64``, the port on the CPU. The same request sequence goes to
both servers, and they must give the same greedy tokens (plain and
streamed), the same status codes, trace headers and span names, and the
same int8-deploy metadata (``precision`` and ``param_bytes`` equal,
``quant_divergence`` within atol 1e-4: the two f32 forwards differ by
~1e-5 in the logits, see ``test_torch_quant.py``).

The port's own lock-order tracker is armed for the module, as
``tests/conftest.py`` arms the JAX package's for its serving tests: any
inversion among the HTTP handler threads, the admission condition, the
registry lock and the decode scheduler fails the module.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.quant as jquant
import deeplearning4j_tpu.serving as jserving
import deeplearning4j_tpu_torch.quant as tquant
from deeplearning4j_tpu_torch import serving as tserving
from deeplearning4j_tpu_torch.common import locks
from deeplearning4j_tpu_torch.models import causal_lm as tcl
from test_torch_causal_lm import model_pair

V = 97
DEPLOY_KW = {"decode_slots": 2, "decode_max_ctx": 64,
             "decode_prompt_buckets": [64], "decode_prefill_batch": 1}
#: a budget the scaled tiny model's int8 twin meets on the 2-row gate
#: batch: its max logit error is ~0.3, its per-token agreement ~0.9, and
#: one of the two last positions flips (top-1 0.5)
GATE_KW = {"quant_max_divergence": 1.0, "quant_min_top1": 0.5}


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


def _gate_batch():
    return np.random.RandomState(5).randint(0, V, (2, 12)).astype(np.int32)


def _serve(pkg, model):
    reg = pkg.ModelRegistry(manifest_dir=None, retain=1)
    reg.deploy("lm", "v1", model, **DEPLOY_KW)
    srv = pkg.ModelServer(reg)
    port = srv.start()
    return reg, srv, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def sides():
    """{"jax": (registry, server, base url), "torch": (...)}."""
    jm, tm = model_pair()
    out = {"jax": _serve(jserving, jm), "torch": _serve(tserving, tm)}
    out["models"] = (jm, tm)
    yield out
    for side in ("jax", "torch"):
        reg, srv, _ = out[side]
        srv.stop()
        reg.drain_all(timeout_s=10, save_manifests=False)


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


def _both(sides, fn):
    return {s: fn(*sides[s]) for s in ("jax", "torch")}


def _wait_until(fn, timeout=10.0):
    """Poll for an eventually-true read (ring records are written after
    the response bytes reach the client)."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        v = fn()
        if v:
            return v
        time.sleep(0.02)
    return fn()


def _prompt(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(0, V, n)]


def test_greedy_generate_matches_jax(sides):
    prompt = _prompt(9, seed=1)
    got = _both(sides, lambda reg, srv, base: _post(
        base + "/v1/models/lm/generate",
        {"prompt": prompt, "max_tokens": 8}))
    docs = {}
    for s, (status, headers, body) in got.items():
        assert status == 200 and headers.get("X-Trace-Id"), s
        docs[s] = json.loads(body)
    assert docs["torch"]["tokens"] == docs["jax"]["tokens"]
    assert len(set(docs["torch"]["tokens"])) > 1
    assert all(type(t) is int for t in docs["torch"]["tokens"])
    for k in ("model", "version", "finish_reason", "prompt_tokens",
              "completion_tokens"):
        assert docs["torch"][k] == docs["jax"][k], k
    assert set(docs["torch"]) == set(docs["jax"])
    assert docs["torch"]["ttft_s"] > 0


def _stream(base, prompt, max_tokens):
    req = urllib.request.Request(
        base + "/v1/models/lm/generate",
        data=json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=60)
    assert r.status == 200 and r.headers.get("X-Trace-Id")
    assert "ndjson" in r.headers.get("Content-Type", "")
    return [json.loads(ln) for ln in r.read().splitlines() if ln.strip()]


def test_streamed_generate_matches_jax(sides):
    prompt = _prompt(6, seed=2)
    lines = _both(sides, lambda reg, srv, base: _stream(base, prompt, 7))
    streamed = {s: [ln["token"] for ln in v if "token" in ln]
                for s, v in lines.items()}
    assert streamed["torch"] == streamed["jax"]
    tail = lines["torch"][-1]
    assert tail["done"] is True and tail["tokens"] == streamed["torch"]
    assert set(tail) == set(lines["jax"][-1])


ERROR_CASES = [
    ("unknown_model", "/v1/models/nope/generate", {"prompt": [1]}),
    ("no_prompt", "/v1/models/lm/generate", {}),
    ("prompt_not_ids", "/v1/models/lm/generate", {"prompt": "not ids"}),
    ("predict_on_generative", "/v1/models/lm/predict",
     {"inputs": [[1.0]]}),
    ("unknown_version", "/v1/models/lm:v9/generate", {"prompt": [1]}),
    ("prompt_fills_context", "/v1/models/lm/generate",
     {"prompt": list(range(64))}),
    ("unknown_route", "/v1/nothing", {}),
]


@pytest.mark.parametrize("path,body", [c[1:] for c in ERROR_CASES],
                         ids=[c[0] for c in ERROR_CASES])
def test_error_status_matches_jax(sides, path, body):
    got = _both(sides, lambda reg, srv, base: _post(base + path, body))
    assert got["torch"][0] == got["jax"][0] >= 400
    if path.endswith("/predict"):
        assert got["torch"][0] == 400 and b"generative" in got["torch"][2]


def test_traceparent_joined(sides):
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    got = _both(sides, lambda reg, srv, base: _post(
        base + "/v1/models/lm/generate", {"prompt": [1, 2, 3],
                                          "max_tokens": 2},
        headers={"traceparent": tp}))
    for s, (status, headers, _) in got.items():
        assert status == 200 and headers.get("X-Trace-Id") == "ab" * 16, s


def _span_names(base, trace_id):
    doc = _wait_until(lambda: (lambda d: d["count"] == 1 and d)(json.loads(
        _get(base + f"/debug/requests?trace_id={trace_id}")[2])))
    assert doc and doc["count"] == 1
    rec = doc["requests"][0]
    names = []

    def walk(spans):
        for s in spans:
            names.append(s["name"])
            walk(s.get("children", []))
    walk(rec["spans"])
    return rec, set(names)


def test_debug_requests_span_tree_matches_jax(sides):
    want = {"serving/request", "serving/admission", "serving/generate",
            "generation/prefill", "generation/decode"}
    recs = {}
    for s in ("jax", "torch"):
        _, _, base = sides[s]
        status, headers, _ = _post(base + "/v1/models/lm/generate",
                                   {"prompt": _prompt(5, seed=3),
                                    "max_tokens": 4})
        assert status == 200
        rec, names = _span_names(base, headers["X-Trace-Id"])
        assert want <= names, (s, names)
        recs[s] = rec
    assert recs["torch"]["kind"] == "generate"
    assert recs["torch"]["status"] == 200
    assert set(recs["torch"]) == set(recs["jax"])
    assert set(recs["torch"]["phases"]) == set(recs["jax"]["phases"])


def test_debug_decode_snapshot(sides):
    snaps = {}
    for s in ("jax", "torch"):
        _, _, base = sides[s]
        status, _, body = _get(base + "/debug/decode")
        assert status == 200
        snaps[s] = next(x for x in json.loads(body)["decode"]
                        if x["model"] == "lm")
    t = snaps["torch"]
    assert t["version"] == "v1" and len(t["slots"]) == 2
    assert t["pool"]["scratch_block"] == 0
    assert t["pool"]["free_blocks"] <= t["pool"]["total_blocks"]
    assert t["speculative"]["enabled"] is False
    assert set(t["pool"]) == set(snaps["jax"]["pool"])


def test_slo_fed_with_ttft(sides):
    for s in ("jax", "torch"):
        reg, srv, base = sides[s]
        assert _post(base + "/v1/models/lm/generate",
                     {"prompt": [1, 2], "max_tokens": 2})[0] == 200
        assert _wait_until(lambda: any(
            w["total"] >= 1 for w in srv.slo_for("lm").snapshot()["windows"]
        )), s
        status, _, body = _get(base + "/readyz")
        assert status == 200 and json.loads(body)["ready"] is True


def test_metrics_endpoints(sides):
    _, _, base = sides["torch"]
    status, _, body = _get(base + "/metrics")
    assert status == 200
    assert b"dl4j_build_info" in body and b"torch_version" in body
    assert b"dl4j_serving_deploys_total" in body
    status, _, body = _get(base + "/metrics.json")
    doc = json.loads(body)
    assert doc["dl4j_decode_ttft_seconds"]["series"][0]["count"] >= 1
    assert _get(base + "/healthz")[0] == 200


def test_int8_deploy_describe_matches_jax_then_rollback(sides):
    """A quantized hot swap (v2, int8, gated on the same batch) and its
    rollback, on both sides."""
    models = dict(zip(("jax", "torch"), sides["models"]))
    desc = {}
    for s in ("jax", "torch"):
        reg, _, base = sides[s]
        mv = reg.deploy("lm", "v2", models[s], quantize="int8",
                        calibration_batch=_gate_batch(), **GATE_KW,
                        **DEPLOY_KW)
        desc[s] = mv.describe()
    t, j = desc["torch"], desc["jax"]
    assert t["precision"] == j["precision"] == "int8"
    assert t["param_bytes"] == j["param_bytes"]
    assert set(t["quant_divergence"]) == set(j["quant_divergence"])
    for k, v in j["quant_divergence"].items():
        assert t["quant_divergence"][k] == pytest.approx(v, abs=1e-4), k
    prompt = _prompt(8, seed=4)
    got = _both(sides, lambda reg, srv, base: json.loads(_post(
        base + "/v1/models/lm/generate",
        {"prompt": prompt, "max_tokens": 6})[2]))
    assert got["torch"]["version"] == "v2"
    assert got["torch"]["tokens"] == got["jax"]["tokens"]
    listing = json.loads(_get(sides["torch"][2] + "/v1/models")[2])
    assert listing["models"]["lm"]["current"] == "v2"
    for s in ("jax", "torch"):
        assert sides[s][0].rollback("lm").version == "v1"
    got = _both(sides, lambda reg, srv, base: json.loads(_post(
        base + "/v1/models/lm/generate",
        {"prompt": prompt, "max_tokens": 6})[2]))
    assert got["torch"]["version"] == "v1"
    assert got["torch"]["tokens"] == got["jax"]["tokens"]


def test_rejected_deploy_is_invisible(sides):
    models = dict(zip(("jax", "torch"), sides["models"]))
    before = threading.active_count()
    for s, (pkg, q) in {"jax": (jserving, jquant),
                        "torch": (tserving, tquant)}.items():
        reg, _, base = sides[s]
        with pytest.raises(q.QuantizationRejectedError,
                           match="full-precision version stays live"):
            reg.deploy("lm", "v3", models[s], calibration_batch=_gate_batch(),
                       quantize=q.QuantSpec(scale_overrides={"": 64.0}),
                       **DEPLOY_KW)
        doc = json.loads(_get(base + "/v1/models")[2])["models"]["lm"]
        assert doc["current"] == "v1"
        assert "v3" not in [v["version"] for v in doc["versions"]]
    # the rejected engines were closed: no decode-loop thread was left
    assert _wait_until(lambda: threading.active_count() <= before)


def test_streaming_client_disconnect_keeps_the_slot(sides):
    """A client that hangs up mid-stream costs its handler a suppressed
    write error, not the engine: the request runs to its end, the slot
    frees, and the next request is served."""
    reg, srv, base = sides["torch"]
    eng = reg.get("lm").engine
    done0 = eng.stats()["tokens"]
    port = int(base.rsplit(":", 1)[1])
    body = json.dumps({"prompt": _prompt(5, seed=6), "max_tokens": 40,
                       "stream": True}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"POST /v1/models/lm/generate HTTP/1.1\r\n"
                  b"Host: 127.0.0.1\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        assert b"200" in s.recv(64)
    assert _wait_until(lambda: eng.stats()["tokens"] >= done0 + 40
                       and eng.stats()["active_slots"] == 0, timeout=60)
    status, _, out = _post(base + "/v1/models/lm/generate",
                           {"prompt": [1, 2, 3], "max_tokens": 3})
    assert status == 200 and len(json.loads(out)["tokens"]) == 3
    httpd = srv._httpd
    before = httpd.client_disconnects
    try:
        raise BrokenPipeError("peer went away")
    except BrokenPipeError:
        httpd.handle_error(None, ("127.0.0.1", 12345))
    assert httpd.client_disconnects == before + 1


def test_debug_profile_and_memory(sides, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PROFILE_DIR", str(tmp_path))
    _, _, base = sides["torch"]
    status, _, body = _post(base + "/debug/profile?seconds=0.05", b"")
    assert status == 200
    files = [f["file"] for f in json.loads(body)["files"]]
    assert "trace.json" in files
    status, _, body = _get(base + "/debug/memory")
    assert status == 200
    assert json.loads(body)["devices"] == (
        [] if not torch.cuda.is_available() else json.loads(body)["devices"])
    assert _get(base + "/debug/nothing")[0] == 404


class TestPortOnlyDeploys:
    """What the port refuses before anything is allocated or
    registered."""

    def _reg(self):
        return tserving.ModelRegistry(manifest_dir=None)

    def test_non_generative_model_refused_naming_its_item(self):
        """A layer-API network, sequential or graph, deploys
        (``tests/test_torch_inference.py``), and so does a SameDiff graph
        with ``outputs=`` (``tests/test_torch_samediff_bert.py``); one
        without ``outputs=`` is refused before anything is registered, as
        the JAX registry refuses it, and anything else is no model the
        registry can serve."""
        class SameDiffish:
            _vars = {}

            def make_function(self):
                pass
        reg = self._reg()
        with pytest.raises(ValueError, match="outputs"):
            reg.deploy("sd", "v1", SameDiffish())
        with pytest.raises(TypeError, match="cannot serve"):
            reg.deploy("mlp", "v1", torch.nn.Linear(4, 2))
        assert reg.models() == {}
        with pytest.raises(KeyError):
            reg.get("mlp")

    def test_sharded_deploy_refused_naming_its_item(self, sides):
        """A sharded deploy is now taken (its listing is held in
        ``test_torch_sharded_serving.py``); what is still refused is a
        mesh without the ``data`` axis, before anything is registered.
        The name is kept from the refusal of every ``mesh=``."""
        from deeplearning4j_tpu_torch.common.mesh import Mesh
        reg = self._reg()
        with pytest.raises(ValueError, match="missing required"):
            reg.deploy("lm", "v1", sides["models"][1],
                       mesh=Mesh([0], ("model",), "cpu"))
        assert reg.models() == {}

    def test_quantize_requires_a_gate_batch(self, sides):
        reg = self._reg()
        with pytest.raises(ValueError, match="calibration_batch"):
            reg.deploy("lm", "v1", sides["models"][1], quantize="int8")
        assert reg.models() == {}

    def test_card_model_without_a_card_raises(self, sides):
        """A model that says it lives on the card deploys there, or
        fails: it never lands on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the deploy succeeds")
        tm = sides["models"][1]
        card = tcl.CausalLM(tm.config, params=tm.params)   # device="cuda"
        reg = self._reg()
        with pytest.raises((RuntimeError, AssertionError)):
            reg.deploy("lm", "v1", card, **DEPLOY_KW)
        assert reg.models() == {}


class TestPortOnlyLifecycle:
    """The registry's undeploy and the lifecycle's signal wiring, on a
    registry of the port's own (the JAX side's are its own tests')."""

    def _served(self, sides):
        reg = tserving.ModelRegistry(manifest_dir=None)
        reg.deploy("lm", "v1", sides["models"][1], **DEPLOY_KW)
        return reg

    def test_undeploy_closes_every_version(self, sides):
        reg = self._served(sides)
        eng = reg.get("lm").engine
        reg.undeploy("lm")
        assert reg.models() == {} and eng.closed
        with pytest.raises(KeyError):
            reg.generate("lm", [1, 2, 3], max_tokens=2)

    def test_sigterm_drains_and_dumps_the_flight_recorder(self, sides,
                                                          tmp_path,
                                                          monkeypatch):
        import signal
        monkeypatch.setenv("DL4J_TPU_FLIGHT_RECORDER_DIR", str(tmp_path))
        reg = self._served(sides)
        srv = tserving.ModelServer(reg)
        base = f"http://127.0.0.1:{srv.start()}"
        assert _post(base + "/v1/models/lm/generate",
                     {"prompt": [4, 5], "max_tokens": 2})[0] == 200
        # the handler records the request in the ring after its response
        # has gone out: the client can hold the 200 before the server has
        # finished the request, and a SIGTERM in that window dumps an
        # empty ring. Wait for the server's own record first.
        deadline = time.monotonic() + 10
        while not srv.request_ring.records() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(srv.request_ring.records()) == 1
        lc = tserving.GracefulLifecycle(reg, srv, drain_timeout_s=10)
        lc.install(dump_signals=())
        try:
            signal.raise_signal(signal.SIGTERM)
            assert lc.wait_drained(30) and lc.drained
        finally:
            lc.uninstall()
        assert not reg.ready()
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(base + "/healthz", timeout=2)
        dumps = list(tmp_path.glob("flight-*.json"))
        assert len(dumps) == 1
        doc = json.loads(dumps[0].read_text())
        assert doc["draining"] is True
        assert [r["status"] for r in doc["requests"]] == [200]
        assert doc["decode"][0]["model"] == "lm"


def test_listen_backlog_takes_a_burst_of_16_clients():
    """16 connections opened while the accept loop is not running all
    complete their handshake at once: the port's server listens with a
    backlog of 128, where socketserver's 5 makes the kernel drop the
    extra SYNs and those clients wait a second for the retransmission."""
    from deeplearning4j_tpu_torch.common.httpserver import (
        JsonRequestHandler, QuietThreadingHTTPServer)
    httpd = QuietThreadingHTTPServer(("127.0.0.1", 0), JsonRequestHandler)
    socks = []
    try:
        for _ in range(16):
            s = socket.socket()
            s.settimeout(0.5)
            socks.append(s)
            s.connect(httpd.server_address)
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
    assert len(socks) == 16


def test_http_burst_round_on_the_cpu(capsys):
    """``benchmarks/http_burst`` at the server's own backlog: one round
    of 16 concurrent generate clients, each answered 200, none raising,
    none waiting for a SYN retransmission."""
    from deeplearning4j_tpu_torch.benchmarks import http_burst
    http_burst.main(["--device", "cpu", "--backlogs", "128",
                     "--rounds", "1"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert len(rows) == 1
    row = rows[0]
    assert (row["backlog"], row["exceptions"], row["not_ok"]) == (128, [], 0)
    assert row["connects_over_0.9s"] == 0


def test_drain_all_and_graceful_lifecycle(sides):
    """The SIGTERM sequence, called directly, on both sides: readiness
    flips, engines drain, late work fails fast, the socket closes."""
    for s, pkg in (("jax", jserving), ("torch", tserving)):
        reg, srv, base = sides[s]
        lc = pkg.GracefulLifecycle(reg, srv, drain_timeout_s=10)
        assert lc.drain() is True
        assert lc.drain() is True            # idempotent
        assert not reg.ready()
        assert reg.drain_all(timeout_s=5, save_manifests=False) is True
        with pytest.raises(RuntimeError, match="draining"):
            reg.deploy("lm", "v9", sides["models"][s == "torch"],
                       **DEPLOY_KW)
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(base + "/healthz", timeout=2)
