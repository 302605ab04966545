"""The port's per-op sweep (``deeplearning4j_tpu_torch/benchmarks/opbench.py``)
on the CPU (``device="cpu"``, a few iterations): the mirror of
``tests/test_opbench.py``, plus its CPU-only rules (no capture, so every
``jit_us`` is null and the gate compares ``eager_us``), its refusal to
run without a card when asked for one, and, for the families this port
slice added, the same benched names as the JAX sweep's
``OPBENCH_cpu_baseline.json``.

The sweep's square operands are N x N; here N is 64, not the card's
512: the candidate tables and the names they bench are the same at any
N, and at 512 the CPU's decompositions alone took minutes of a loaded
test worker."""
import json
import os

import pytest
import torch

from deeplearning4j_tpu_torch.benchmarks import opbench
from deeplearning4j_tpu_torch.benchmarks.opbench import (compare_runs, main,
                                                         run_opbench,
                                                         summary)

SMALL_N = 64


@pytest.fixture(scope="module", autouse=True)
def small_operands():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(opbench, "N", SMALL_N)
        yield


BASELINE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "OPBENCH_cpu_baseline.json")


def sweep(**kw):
    return run_opbench(device="cpu", n_iter=kw.pop("n_iter", 2), **kw)


@pytest.fixture(scope="module")
def blas():
    return sweep(filter_category="blas")


def test_sweep_small_categories():
    out = sweep(filter_category="activations")
    assert out["n_benched"] >= 15
    rec = next(iter(out["results"].values()))
    assert set(rec) >= {"category", "eager_us", "jit_us", "args"}
    assert rec["eager_us"] > 0 and rec["jit_us"] is None
    assert (out["platform"], out["device_name"], out["nvidia_smi"]) == \
        ("cpu", "cpu", None)
    assert out["capture_failures"] == {}


def test_pairwise_and_reduce_covered():
    out = sweep(filter_category="pairwise")
    assert out["n_benched"] >= 30
    out2 = sweep(filter_category="reduce")
    assert out2["n_benched"] >= 15


def test_matmul_benched():
    out = sweep(filter_category="blas", filter_name="matmul")
    assert "matmul" in out["results"]
    assert out["results"]["matmul"]["args"] == [[SMALL_N, SMALL_N]] * 2


def test_regression_gate(blas):
    out = blas
    # identical run: clean
    assert compare_runs(out, out) == []
    # a 3x regression on one op above the jitter floor, on eager_us (no
    # capture on the CPU)
    cur = json.loads(json.dumps(out))
    name = next(iter(cur["results"]))
    cur["results"][name]["eager_us"] = max(
        out["results"][name]["eager_us"] * 3, 200.0)
    regs = compare_runs(out, cur)
    assert len(regs) == 1 and regs[0]["op"] == name
    assert regs[0]["timing"] == "eager_us"
    # below the min_us floor: jitter never flags
    tiny = json.loads(json.dumps(out))
    tiny["results"][name]["eager_us"] = 40.0
    base_tiny = json.loads(json.dumps(out))
    base_tiny["results"][name]["eager_us"] = 10.0
    assert compare_runs(base_tiny, tiny) == []
    # where both runs have a captured time, that is what is compared
    both = json.loads(json.dumps(out))
    both["results"][name].update(jit_us=100.0, eager_us=1e6)
    slow = json.loads(json.dumps(both))
    slow["results"][name]["jit_us"] = 300.0
    regs = compare_runs(both, slow)
    assert [(r["op"], r["timing"]) for r in regs] == [(name, "jit_us")]
    assert compare_runs(both, slow, threshold=3.5) == []


def test_json_roundtrip(tmp_path, blas):
    p = tmp_path / "ops.json"
    p.write_text(json.dumps(blas))
    loaded = json.loads(p.read_text())
    assert compare_runs(loaded, blas) == []


def test_excluded_and_skipped_reported():
    """No silent caps: everything not benched is named."""
    out = sweep(filter_category="controlflow")
    assert out["n_benched"] == 0
    assert len(out["excluded"]) >= 8
    lines = summary(out)
    assert lines[0].startswith("benched 0 ops (0 skipped, ")


def test_summary_names_skips_and_the_slowest(blas):
    out = json.loads(json.dumps(blas))
    out["skipped"] = ["some_op"]
    out["skip_reasons"] = {"some_op": "TypeError: no candidate"}
    out["capture_failures"] = {"matmul": "RuntimeError: sync in capture"}
    lines = summary(out, top=2)
    assert "  SKIP some_op: TypeError: no candidate" in lines
    assert "  NO CAPTURE matmul: RuntimeError: sync in capture" in lines
    assert len([ln for ln in lines if "eager  [blas]" in ln]) == 2


@pytest.mark.parametrize("category", ["bitwise", "segment", "compression",
                                      "linalg"])
def test_tail_categories_bench_the_jax_sweeps_names(category):
    """The port's CPU sweep benches exactly the names the JAX sweep
    benched in these families, or names each one it cannot bench with
    its reason."""
    with open(BASELINE) as f:
        base = json.load(f)
    want = {n for n, r in base["results"].items() if r["category"] == category}
    out = sweep(filter_category=category, n_iter=1)
    got = set(out["results"])
    assert got <= want
    assert want - got <= set(out["skip_reasons"])
    assert got == want, {n: out["skip_reasons"][n] for n in want - got}


def test_no_card_no_fallback(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_opbench(filter_category="blas", n_iter=1)
    assert main(["--category", "blas", "--iters", "1",
                 "--out", str(tmp_path / "x.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


def test_cli_on_the_cpu_writes_and_compares(tmp_path, capsys):
    path = str(tmp_path / "ops.json")
    assert main(["--device", "cpu", "--category", "compression",
                 "--iters", "1", "--out", path]) == 0
    assert main(["--device", "cpu", "--category", "compression",
                 "--iters", "1", "--compare", path,
                 "--threshold", "1000"]) == 0
    printed = capsys.readouterr().out
    assert "benched 4 ops" in printed and "no per-op regressions" in printed
