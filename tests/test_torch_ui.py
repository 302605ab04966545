"""The port's training UI (``ui/``) against the JAX package's, on the CPU.

- ``StatsListener`` over the same LeNet ``fit`` on both sides (the JAX
  zoo LeNet's params and updater state bridged into the port's): the
  records have the same keys; scores within ``SCORE``, each param's l2
  and mean magnitude within ``STATS`` (relative), update ratios within
  ``RATIO``, histogram
  edges within ``STATS`` of the range's width and counts within one of the
  JAX package's per
  bin, with the same total. The listener brings each update's statistics
  to the host in one copy.
- ``FileStatsStorage`` round-trips its JSONL file.
- ``UIServer`` and ``RemoteUIStatsStorageRouter``: the port's server and
  the JAX package's serve the same JSON for the same records, and each
  package's router posts into the other's server.
"""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch import bridge, ui
from deeplearning4j_tpu_torch.zoo import LeNet

#: the same steps' records, relative. The scores: f32 reductions summed
#: in other orders. Each param's statistics: the biases start at 0 and
#: Adam moves each element by ~lr in its gradient's sign, so an element
#: whose gradient is ~0 may step either way on the two sides (the first
#: conv's bias reads up to 7.7e-5 apart); the update ratios sum over all
#: params (up to 1.9e-5 apart)
SCORE = dict(rtol=1e-5, atol=1e-7)
STATS = dict(rtol=2e-4, atol=1e-7)
RATIO = dict(rtol=1e-4, atol=1e-9)
STEPS, B = 6, 8


def _data():
    rs = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        x = rs.randn(B, 1, 28, 28).astype(np.float32)
        y = np.zeros((B, 10), np.float32)
        y[np.arange(B), rs.randint(0, 10, B)] = 1.0
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def records():
    """(port storage, JAX storage, port net): the same 6 LeNet steps
    under a StatsListener each (histograms every 2 steps)."""
    jnet = JLeNet().init_model()
    tnet = LeNet().init_model(device="cpu")
    bridge.load_multilayer(
        tnet, [{k: np.asarray(v) for k, v in p.items()}
               for p in jnet._params],
        jax.tree_util.tree_map(np.asarray, jnet._updater_state))
    jst, tst = jui.InMemoryStatsStorage(), ui.InMemoryStatsStorage()
    jnet._listeners.append(jui.StatsListener(jst, session_id="s",
                                             histogram_frequency=2))
    tnet._listeners.append(ui.StatsListener(tst, session_id="s",
                                            histogram_frequency=2))
    for x, y in _data():
        jnet.fit(x, y)
        tnet.fit(x, y)
    return tst, jst, tnet


def test_static_info_as_jax(records):
    tst, jst, tnet = records
    t, j = tst.get_static_info("s"), jst.get_static_info("s")
    assert sorted(t) == sorted(j)
    for k in ("model_class", "n_layers", "n_params", "backend"):
        assert t[k] == j[k], k
    assert t["device_count"] == 1


def test_updates_match_the_jax_records(records):
    tst, jst, _ = records
    tu, ju = tst.get_updates("s"), jst.get_updates("s")
    assert [u["iteration"] for u in tu] == [u["iteration"] for u in ju] \
        == list(range(STEPS))
    for t, j in zip(tu, ju):
        assert sorted(t) == sorted(j)            # no "memory" on the CPU
        np.testing.assert_allclose(t["score"], j["score"], **SCORE)
        assert sorted(t["params"]) == sorted(j["params"])
        for name, js in j["params"].items():
            ts = t["params"][name]
            assert sorted(ts) == sorted(js), name
            for k in ("l2", "mean_mag"):
                np.testing.assert_allclose(ts[k], js[k], **STATS)
            if "histogram" in js:
                th, jh = ts["histogram"], js["histogram"]
                # edges from min and max: relative to the range's width
                span = jh["edges"][-1] - jh["edges"][0]
                np.testing.assert_allclose(th["edges"], jh["edges"], rtol=0,
                                           atol=STATS["rtol"] * span)
                assert sum(th["counts"]) == sum(jh["counts"])
                assert np.abs(np.subtract(th["counts"],
                                          jh["counts"])).max() <= 1
        if "update_param_ratio" in j:
            np.testing.assert_allclose(t["update_param_ratio"],
                                       j["update_param_ratio"], **RATIO)
    assert "histogram" in tu[0]["params"]["layer0/W"]
    assert "histogram" not in tu[1]["params"]["layer0/W"]
    assert all("update_param_ratio" in u for u in tu[1:])


def test_one_host_copy_per_update(records, monkeypatch):
    """The statistics of an update cross to the host in one copy."""
    _, _, tnet = records
    copies = []
    real = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    st = ui.InMemoryStatsStorage()
    lst = ui.StatsListener(st, session_id="c", histogram_frequency=1)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    lst.iteration_done(tnet, 0, loss=1.0)
    lst.iteration_done(tnet, 1, loss=torch.tensor(0.5))
    assert len(copies) == 2 and len(st.get_updates("c")) == 2
    assert st.get_updates("c")[1]["score"] == 0.5
    n_leaves = len(st.get_updates("c")[0]["params"])
    assert copies[0] == (n_leaves * 24,)        # l2, mean, min, max, 20 bins


def test_file_storage_round_trips(records, tmp_path):
    tst, _, _ = records
    path = str(tmp_path / "stats.jsonl")
    fst = ui.FileStatsStorage(path)
    fst.put_static_info("s", tst.get_static_info("s"))
    for u in tst.get_updates("s"):
        fst.put_update("s", u)
    back = ui.FileStatsStorage(path)
    assert back.list_session_ids() == ["s"]
    assert back.get_static_info("s") == json.loads(json.dumps(
        tst.get_static_info("s")))
    assert back.get_updates("s") == json.loads(json.dumps(
        tst.get_updates("s")))
    assert back.get_updates("s", since_iteration=3)[0]["iteration"] == 4
    assert back.get_latest_update("s")["iteration"] == STEPS - 1
    # the JAX package's storage reads the port's file
    assert jui.FileStatsStorage(path).get_updates("s") == \
        back.get_updates("s")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_servers_serve_the_same_json_and_routers_cross(records):
    tst, _, _ = records
    static, updates = tst.get_static_info("s"), tst.get_updates("s")
    servers = {}
    for name, mod in (("port", ui), ("jax", jui)):
        st = mod.InMemoryStatsStorage()
        st.put_static_info("s", static)
        for u in updates:
            st.put_update("s", u)
        servers[name] = mod.UIServer(port=0).attach(st)
    ports = {k: s.start() for k, s in servers.items()}
    try:
        for path in ("/train/sessions", "/train/overview?sid=s",
                     "/train/overview", "/nope"):
            (ct, tb), (cj, jb) = _get(ports["port"], path), \
                _get(ports["jax"], path)
            assert ct == cj and json.loads(tb) == json.loads(jb), path
        code, page = _get(ports["port"], "/")
        assert code == 200 and b"Training Dashboard" in page
        for port in ports.values():
            code, body = _get(port, "/metrics.json")
            assert code == 200 and isinstance(json.loads(body), dict)
        # each package's router posts into the other's server
        for router_mod, target in ((ui, "jax"), (jui, "port")):
            r = router_mod.RemoteUIStatsStorageRouter(
                f"http://127.0.0.1:{ports[target]}")
            r.put_static_info("remote", {"model_class": "X"})
            r.put_update("remote", {"iteration": 0, "score": 1.0})
            st = servers[target].storage
            assert "remote" in st.list_session_ids()
            assert st.get_latest_update("remote")["score"] == 1.0
            assert r.list_session_ids() == [] and \
                r.get_static_info("remote") is None
    finally:
        for s in servers.values():
            s.stop()
