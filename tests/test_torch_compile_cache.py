"""The port's artifact store, kernel builds through it, warm images,
``warm_compile``, ``/debug/compile_cache`` and the workspace shims,
against the JAX package's.

- The stores (``LocalDirStore``, ``RemoteStore``, ``TieredStore``,
  ``AOTCompileCache``) are held against the JAX package's classes on the
  same raw bytes: file layout, keys, ``stat``, ``inventory``, LRU
  evictions under a cap, corruption handling and tiered push and pull.
  The JAX package's payloads are XLA executables and the port's kernel
  libraries; a store sees bytes either way.
- ``kernels/_build.py`` goes through the store. A stand-in ``nvcc`` (a
  script under ``tmp_path``, reached through ``CUDA_HOME``) counts its
  builds: a miss runs it once and puts the library into the store; a
  fresh build directory then hits, with no run and the same bytes; a
  corrupt entry costs one run; with no entry and a failing compiler the
  build raises.
- The warm-image CLI keeps the JAX package's flags and summary keys; on
  the CPU a bake writes the manifest and zero entries. A replica pointed
  at an image that holds a library builds it with no compiler run.
"""
import json
import logging
import os
import re
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.common.environment import environment as jenv
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.runtime import compile_cache as jcc
from deeplearning4j_tpu.runtime import warm_image as jwarm
from deeplearning4j_tpu.runtime import workspace as jws

import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu_torch import runtime as truntime
from deeplearning4j_tpu_torch.common.environment import (SystemProperties,
                                                         environment as tenv)
from deeplearning4j_tpu_torch.common.metrics import registry as tregistry
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer as TDense
from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer as TOutput
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.runtime import compile_cache as tcc
from deeplearning4j_tpu_torch.runtime import warm_image as twarm
from deeplearning4j_tpu_torch.runtime import workspace as tws
from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
from deeplearning4j_tpu_torch.serving import lifecycle as tlifecycle

N_IN, N_OUT = 6, 3
CONF_PROPS = (SystemProperties.CACHE_DIR, SystemProperties.REMOTE_CACHE,
              SystemProperties.CACHE_TIER)
KEYS = ("ab" * 32, "cd" * 32, "ef" * 32)


@pytest.fixture
def conf():
    """Set the store conf on both sides with ``conf(dir, remote, tier)``;
    the overrides are restored afterwards."""
    envs = (jenv(), tenv())
    saved = [{p: e.property_override(p) for p in CONF_PROPS} for e in envs]

    def set_conf(cache_dir, remote=None, tier="auto"):
        for e in envs:
            e.set_cache_dir(cache_dir)
            e.set_remote_cache(remote)
            e.set_cache_tier(tier)
        jcc.reset_cache()
        tcc.reset_cache()
        return jcc.cache(), tcc.cache()
    yield set_conf
    for e, s in zip(envs, saved):
        for prop, value in s.items():
            if value is None:
                e.clear_property(prop)
            else:
                e.set_property(prop, value)
    jcc.reset_cache()
    tcc.reset_cache()


def _layout(root):
    """Every file under ``root``, relative, sorted."""
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _payload(i):
    return bytes([i]) * (40 + 10 * i)


# -- the stores against the JAX package's ------------------------------------

@pytest.mark.parametrize("kind", ["local", "remote"])
def test_store_layout_keys_and_stat_match_jax(kind, tmp_path):
    stores = []
    for side, mod in (("jax", jcc), ("port", tcc)):
        root = str(tmp_path / side)
        store = mod.LocalDirStore(root) if kind == "local" \
            else mod.RemoteStore(root)
        for i, key in enumerate(KEYS):
            assert store.put(key, _payload(i),
                             mod._stamp_meta(_payload(i), {"tag": i}))
        stores.append((root, store))
    (jroot, js), (troot, ts) = stores
    assert _layout(troot) == _layout(jroot)
    assert sorted(ts.keys()) == sorted(js.keys()) == sorted(KEYS)
    assert ts.stat() == js.stat()
    assert ts.describe()["backend"] == js.describe()["backend"]
    for key in KEYS:
        assert ts.entry_meta(key) == js.entry_meta(key)
        assert ts.get(key) == js.get(key)
    # a torn payload: both delete the entry and raise
    for root, store, mod in ((jroot, js, jcc), (troot, ts, tcc)):
        p = store._paths(KEYS[0])[0]
        with open(p, "wb") as fh:
            fh.write(b"torn")
        with pytest.raises(mod.CorruptEntryError):
            store.get(KEYS[0])
        assert not store.contains(KEYS[0])
    assert _layout(troot) == _layout(jroot)


def _lru_oldest_evicted(cc):
    cc.put("k1", b"x" * 80, {"kept_var_idx": [0]})
    os.utime(os.path.join(cc.aot_dir, "k1.bin"), (1.0, 1.0))
    cc.put("k2", b"y" * 80, {"kept_var_idx": [0]})


def _lru_hit_refreshes(cc):
    cc.put("k1", b"x" * 80, {"kept_var_idx": [0]})
    cc.put("k2", b"y" * 80, {"kept_var_idx": [0]})
    for key in ("k1", "k2"):
        os.utime(os.path.join(cc.aot_dir, key + ".bin"), (1.0, 1.0))
    assert cc.get("k1") is not None      # k2 becomes the LRU entry
    cc.put("k3", b"z" * 80, {"kept_var_idx": [0]})


def _lru_uncapped(cc):
    for i in range(5):
        cc.put(f"k{i}", b"x" * 1000, {"kept_var_idx": [0]})


@pytest.mark.parametrize("cap,scenario,want", [
    (100, _lru_oldest_evicted, {"k2"}),
    (180, _lru_hit_refreshes, {"k1", "k3"}),
    (0, _lru_uncapped, {"k0", "k1", "k2", "k3", "k4"}),
], ids=["oldest_evicted", "hit_refreshes", "uncapped"])
def test_lru_evictions_match_jax(cap, scenario, want, tmp_path):
    got = []
    for side, mod in (("jax", jcc), ("port", tcc)):
        cc = mod.AOTCompileCache(str(tmp_path / side), max_bytes=cap)
        scenario(cc)
        got.append((set(cc.store.keys()), cc.stats["evictions"]))
    assert got[1] == got[0]
    assert got[1][0] == want


def test_corrupt_payload_dropped_and_warned_once(tmp_path, caplog):
    results = []
    for side, mod, logger in (
            ("jax", jcc, "deeplearning4j_tpu.runtime.compile_cache"),
            ("port", tcc, "deeplearning4j_tpu_torch.runtime.compile_cache")):
        cc = mod.AOTCompileCache(str(tmp_path / side), max_bytes=0)
        caplog.clear()
        for _ in range(2):      # corrupted twice: one warning per key
            cc.put(KEYS[0], b"payload", {})
            with open(os.path.join(cc.aot_dir, KEYS[0] + ".bin"),
                      "wb") as fh:
                fh.write(b"garbage")
            with caplog.at_level(logging.WARNING, logger=logger):
                assert cc.get(KEYS[0]) is None
        warned = [r for r in caplog.records if r.name == logger
                  and "dropped" in r.getMessage()]
        results.append((len(warned), dict(cc.stats),
                        cc.store.contains(KEYS[0])))
    assert results[1] == results[0]
    assert results[1][0] == 1 and results[1][1]["corrupt"] == 2


def test_tiered_store_and_inventory_match_jax(tmp_path, conf):
    docs = []
    for side in ("jax", "port"):
        jc, tc = conf(str(tmp_path / side / "local"),
                      str(tmp_path / side / "remote"))
        cc, mod = (jc, jcc) if side == "jax" else (tc, tcc)
        assert isinstance(cc.store, mod.TieredStore)
        cc.put(KEYS[0], b"x" * 100, {"kept_var_idx": [0]})
        cc.put(KEYS[1], b"y" * 50, {"kept_var_idx": [0]})
        cc.store.local.delete(KEYS[1])          # a remote-only entry
        got = cc.get(KEYS[1])                   # backfilled from the remote
        assert got is not None and got[0] == b"y" * 50
        inv = mod.inventory()
        docs.append({
            "entry_count": inv["entry_count"],
            "total_payload_bytes": inv["total_payload_bytes"],
            "stats": inv["stats"], "max_bytes": inv["max_bytes"],
            "tiers": [{k: v for k, v in t.items() if k != "path"}
                      for t in inv["tiers"]],
            "entry_keys": sorted(e["key"] for e in inv["entries"])})
    assert docs[1] == docs[0]
    assert set(tcc.inventory()) == set(jcc.inventory())
    gauges = tregistry().get("dl4j_cache_store_entries")
    assert gauges.labels(tier="remote").value() == 2


def test_push_and_pull_counts_match_jax(tmp_path, conf):
    counts = []
    for side, mod in (("jax", jcc), ("port", tcc)):
        base = tmp_path / side
        conf(str(base / "replica1"))
        cc = mod.cache()
        cc.put(KEYS[0], b"one", {"kept_var_idx": [0]})
        cc.put(KEYS[1], b"two", {"kept_var_idx": [0]})
        with open(os.path.join(mod.serving_manifest_dir(),
                               "toy.warmup.json"), "w") as fh:
            json.dump([{"inputs": [], "buckets": [1]}], fh)
        conf(str(base / "replica1"), str(base / "shared"))
        pushed = (mod.push_to_remote(), mod.push_to_remote())
        conf(str(base / "joiner"), str(base / "shared"))
        pulled = (mod.pull_from_remote(), mod.pull_from_remote())
        local = mod.cache().store.local
        counts.append((pushed, pulled, sorted(local.keys()),
                       _layout(str(base / "shared"))))
        conf(str(base / "alone"))          # no shared store: no-ops
        assert mod.push_to_remote() == mod.pull_from_remote() == {
            "executables": 0, "manifests": 0}
    assert counts[1] == counts[0]
    assert counts[1][0][0] == {"executables": 2, "manifests": 1}
    assert counts[1][1][0] == {"executables": 2, "manifests": 1}
    assert counts[1][1][1] == {"executables": 0, "manifests": 1}


# -- kernel builds through the store -------------------------------------------

STAND_IN = """#!{python}
import os, sys
args = sys.argv[1:]
if "--version" in args:
    print("Cuda compilation tools, release 12.4, V12.4.131 (stand-in)")
    sys.exit(0)
if {fail}:
    print("stand-in compiler refuses to build")
    sys.exit(1)
with open({count!r}, "a") as f:
    f.write(args[-1] + "\\n")
out = args[args.index("-o") + 1]
with open(args[-1], "rb") as src, open(out, "wb") as f:
    f.write(b"SO:" + src.read()[:64])
print("ptxas info    : Used 32 registers, 0 bytes spill stores")
"""


def _stand_in(root, fail=False):
    """A fake CUDA home under ``root`` whose ``bin/nvcc`` copies the
    source's head into ``-o`` and logs each build; returns (home, log)."""
    home, count = root / "cuda", root / "nvcc-runs.txt"
    (home / "bin").mkdir(parents=True, exist_ok=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STAND_IN.format(python=sys.executable, fail=fail,
                                    count=str(count)))
    nvcc.chmod(0o755)
    return str(home), count


def _runs(count):
    return len(count.read_text().splitlines()) if count.exists() else 0


@pytest.fixture
def builds(tmp_path, monkeypatch, conf):
    """A stand-in compiler, a build dir of its own and a local store."""
    home, count = _stand_in(tmp_path)
    monkeypatch.setenv("CUDA_HOME", home)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build1")
    conf(str(tmp_path / "store"))
    _build.reset_stats()
    yield count
    _build.reset_stats()


NAME = "paged_flash_decode"


def test_build_miss_then_hit_then_corrupt(builds, tmp_path, monkeypatch,
                                          caplog):
    count = builds
    _build.build([NAME])
    assert _runs(count) == 1
    st = _build.stats()
    assert (st["compiler_runs"], st["store_hits"], st["store_misses"]) == \
        (1, 0, 1)
    assert st["sources"] == {NAME: "miss"}
    cc = tcc.cache()
    key = _build.store_key(NAME)
    assert cc.store.contains(key)
    meta = cc.store.entry_meta(key)
    assert meta["kernel"] == NAME and "stand-in" in meta["nvcc"]
    assert "registers" in meta["ptxas"] and meta["tag_kind"] == "kernel"
    first = _build.library_path(NAME).read_bytes()
    # already present: used as it is
    _build.build([NAME])
    assert _runs(count) == 1 and _build.stats()["sources"][NAME] == "present"
    # a fresh build directory: the store hit writes the same bytes
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
    _build.build([NAME])
    assert _runs(count) == 1
    assert _build.library_path(NAME).read_bytes() == first
    assert "registers" in _build.ptxas_report(NAME)
    assert _build.stats()["store_hits"] == 1
    # a corrupt entry: dropped with one warning, one compiler run
    with open(os.path.join(cc.aot_dir, key + ".bin"), "wb") as fh:
        fh.write(b"garbage")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build3")
    with caplog.at_level(logging.WARNING):
        _build.build([NAME])
    assert _runs(count) == 2
    assert _build.library_path(NAME).read_bytes() == first
    assert sum("dropped" in r.getMessage() for r in caplog.records) == 1
    assert cc.stats["corrupt"] == 1 and cc.store.contains(key)
    fam = tregistry().get("dl4j_compile_seconds")
    labels = {k for k, c in fam.children() if k[0] == "kernel"}
    assert {("kernel", "hit"), ("kernel", "miss")} <= labels


def test_build_without_store_or_compiler_raises(builds, tmp_path,
                                                monkeypatch, conf):
    home, count = _stand_in(tmp_path / "failing", fail=True)
    monkeypatch.setenv("CUDA_HOME", home)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build([NAME])
    conf("")                                   # no store at all
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build([NAME])
    assert not _build.library_path(NAME).exists()


def test_warm_labels_and_replica_boots_from_an_image(builds, tmp_path,
                                                     monkeypatch, conf):
    """``_build.warm`` (what ``warm_compile`` calls on the card): "miss"
    when the compiler ran, "hit" from the store; then an image holding
    the libraries boots a replica whose compiler always fails."""
    count = builds
    assert _build.warm("cpu") == "bypass"
    assert _build.warm("cuda") == "miss"
    assert _runs(count) == len(_build.KERNELS)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
    assert _build.warm("cuda") == "hit"
    assert _runs(count) == len(_build.KERNELS)
    # bake the libraries into an image (remote layout), as warm_image does
    image = str(tmp_path / "image")
    conf(image, image, "remote")
    assert _build.publish([NAME, "dequant_matmul"]) == [NAME,
                                                       "dequant_matmul"]
    # the replica: a fresh build dir, an empty local store, the image as
    # its remote and a compiler that always fails
    failing, _ = _stand_in(tmp_path / "failing", fail=True)
    monkeypatch.setenv("CUDA_HOME", failing)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "replica")
    conf(str(tmp_path / "replica-cache"), image)
    _build.reset_stats()
    assert tlifecycle.restore_on_boot() == {"executables": 2,
                                            "manifests": 0}
    _build.build([NAME, "dequant_matmul"])
    st = _build.stats()
    assert (st["compiler_runs"], st["store_misses"], st["store_hits"]) == \
        (0, 0, 2)
    conf("")
    assert _build.warm("cuda") == "bypass"    # no store configured


# -- the warm-image CLI ----------------------------------------------------------

def _jax_mlp():
    conf = (JNNC.builder().seed(0).list()
            .layer(JDense(n_in=N_IN, n_out=8, activation="relu"))
            .layer(JOutput(n_in=8, n_out=N_OUT)).build())
    return JMLN(conf).init(), jnp.zeros((1, N_IN), "float32")


def _port_mlp():
    conf = (TNNC.builder().seed(0).list()
            .layer(TDense(n_in=N_IN, n_out=8, activation="relu"))
            .layer(TOutput(n_in=8, n_out=N_OUT)).build())
    return TMLN(conf, device="cpu").init(), torch.zeros((1, N_IN))


@pytest.fixture
def factories():
    mods = {"_warm_jax_fixture": _jax_mlp, "_warm_port_fixture": _port_mlp,
            "_warm_port_noex": lambda: _port_mlp()[0]}
    for name, fn in mods.items():
        mod = types.ModuleType(name)
        mod.build = fn
        sys.modules[name] = mod
    yield
    for name in mods:
        sys.modules.pop(name, None)


def _flags(mod, capsys):
    with pytest.raises(SystemExit):
        mod.main(["--help"])
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


def test_warm_image_cli_matches_jax(factories, tmp_path, capsys, conf):
    assert _flags(twarm, capsys) == _flags(jwarm, capsys)
    before = {p: tenv().property_override(p) for p in CONF_PROPS}
    args = ["--name", "tinymlp", "--max-batch", "2"]
    assert jwarm.main(["--model", "_warm_jax_fixture:build", "--output",
                       str(tmp_path / "j")] + args) == 0
    jsum = json.loads(capsys.readouterr().out)
    assert twarm.main(["--model", "_warm_port_fixture:build", "--output",
                       str(tmp_path / "t")] + args) == 0
    tsum = json.loads(capsys.readouterr().out)
    assert set(tsum) == set(jsum) | {"kernels"}
    assert tsum["buckets"] == jsum["buckets"] == [1, 2]
    # on the CPU no kernel runs: the manifest, and zero entries
    assert tsum["entries"] == 0 and tsum["kernels"] == []
    assert os.path.exists(tmp_path / "t" / "manifests" /
                          "tinymlp.warmup.json")
    assert os.path.isdir(tmp_path / "t" / "objects")
    assert {p: tenv().property_override(p) for p in CONF_PROPS} == before
    for mod, spec in ((jwarm, "no_colon_here"), (twarm, "no_colon_here")):
        with pytest.raises(ValueError, match="pkg.module:factory"):
            mod.main(["--model", spec, "--output", str(tmp_path / "x")])
    with pytest.raises(ValueError, match="example"):
        twarm.main(["--model", "_warm_port_noex:build",
                    "--output", str(tmp_path / "n")])


# -- warm_compile ------------------------------------------------------------

def _state(net):
    """Clones of every param and updater-state tensor."""
    from deeplearning4j_tpu_torch.learning import tree_map
    leaves = []
    tree_map(lambda t: t is None or leaves.append(t.clone()),
             [net._params, net._updater_state])
    return leaves


def _port_graph():
    conf = (TNNC.builder().seed(1).graph_builder().add_inputs("in")
            .add_layer("d", TDense(n_in=N_IN, n_out=8), "in")
            .add_layer("out", TOutput(n_in=8, n_out=N_OUT), "d")
            .set_outputs("out").build())
    return TG.ComputationGraph(conf, device="cpu").init()


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_warm_compile_touches_nothing_and_counts_one_train_event(
        kind, tmp_path, conf):
    """On the CPU nothing is built ("bypass", with or without a store);
    the params and updater state stay bit for bit; the train step's
    event is recorded once, and the per-step fit of that batch records
    nothing new."""
    net = _port_graph() if kind == "graph" else _port_mlp()[0]
    x = np.random.RandomState(0).randn(4, N_IN).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[[0, 1, 2, 0]]
    before = _state(net)
    got = []
    tenv().add_compile_listener(got.append)
    try:
        conf("")
        assert net.warm_compile(TDataSet(x, y)) == "bypass"
        conf(str(tmp_path / "store"))
        assert net.warm_compile(x, y) == "bypass"
        after = _state(net)
        assert len(after) == len(before) > 0
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        assert [str(k[0]).split(":")[0] for k in got] == ["train"]
        net.fit(iter([TDataSet(x, y)]))
        assert [str(k[0]).split(":")[0] for k in got] == ["train"]
    finally:
        tenv().remove_compile_listener(got.append)
    assert tcc.cache().entry_count() == 0     # nothing was built
    with pytest.raises(ValueError, match="at least one batch"):
        net.warm_compile([])


# -- /debug/compile_cache ----------------------------------------------------

def test_debug_compile_cache_endpoint(tmp_path, conf):
    conf(str(tmp_path / "local"), str(tmp_path / "remote"))
    tcc.cache().put(KEYS[2], b"z" * 64, {"tag_kind": "kernel",
                                         "kernel": NAME})
    srv = ModelServer(ModelRegistry(manifest_dir=None))
    port = srv.start()
    url = f"http://127.0.0.1:{port}/debug/compile_cache"
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert set(doc) == set(jcc.inventory())
        assert doc["entry_count"] == 1
        assert doc["entries"][0]["kernel"] == NAME
        assert {t["tier"] for t in doc["tiers"]} == {"local", "remote"}
        tenv().set_property("debug_endpoints", "0")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url, timeout=5)
        assert e.value.code == 404
    finally:
        tenv().clear_property("debug_endpoints")
        srv.stop()


# -- the workspace shims -----------------------------------------------------

def test_workspace_shims_match_jax():
    from deeplearning4j_tpu import runtime as jruntime
    assert truntime.MemoryWorkspace is tws.MemoryWorkspace
    assert set(truntime.__all__) <= set(jruntime.__all__)
    assert {n for n in jruntime.__all__ if hasattr(jws, n)} <= \
        set(truntime.__all__)
    cfg = {}
    for side, mod in (("jax", jws), ("port", tws)):
        conf = (mod.WorkspaceConfiguration.builder().initial_size(10)
                .max_size(100).policy_learning("OVER_TIME").build())
        ws = mod.workspace_manager.get_workspace_for_current_thread(
            conf, "WS_T")
        assert mod.workspace_manager.get_workspace_for_current_thread(
            conf, "WS_T") is ws
        with ws as entered:
            assert entered is ws and ws.is_scope_active()
            assert mod.Nd4jWorkspaceManager.current_workspace() is ws
            with pytest.raises(AssertionError):
                mod.Nd4jWorkspaceManager.assert_no_workspaces_open()
        mod.Nd4jWorkspaceManager.assert_no_workspaces_open()
        ws.notify_scope_entered()
        ws.notify_scope_left()
        mgr = mod.LayerWorkspaceMgr.builder().build()
        assert mod.LayerWorkspaceMgr.no_workspaces().mode == "NONE"
        arr = mgr.leverage_to("ACTIVATIONS", "x")
        cfg[side] = (vars(conf), ws.generation, ws.get_current_size(),
                     ws.get_current_offset(), arr,
                     mgr.validate_array_location("INPUT", arr),
                     mod.LayerWorkspaceMgr.TYPES)
    assert cfg["port"] == cfg["jax"]
    t = tws.LayerWorkspaceMgr().create("ACTIVATIONS", (2, 3), "bfloat16",
                                       device="cpu")
    j = jws.LayerWorkspaceMgr().create("ACTIVATIONS", (2, 3), "bfloat16")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert tuple(t.shape) == j.shape and str(t.dtype) == "torch." + str(
        j.dtype)
    assert not t.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tws.LayerWorkspaceMgr().create("ACTIVATIONS", (2, 3))
