"""The port's static analysis (``deeplearning4j_tpu_torch/analysis``)
against the JAX package's, on the CPU.

- ``python -m deeplearning4j_tpu_torch.analysis`` exits 0 on the port: every
  finding fixed or in ``analysis/baseline.json`` with a justification, no
  stale entry.
- DL102, DL104 and DL105 keep the JAX package's logic: the fixture
  sources of ``tests/test_analysis.py`` give the same findings (rule, line,
  message) from both analyzers.
- DL101 and DL103 name the port's idioms: torch fixture sources pin their
  true positives (a bare CUDA graph capture or ``torch.compile``; host
  syncs in a function handed to ``captured_dispatch``,
  ``captured_train_step`` or a ``StepGraphs``' ``run``) and their
  false-positive guards (``runtime/cuda_graphs.py``, the sanctioned
  capture site; shape arithmetic; code that is not captured).
"""
import json
import subprocess
import sys
import textwrap

import pytest

from deeplearning4j_tpu.analysis import analyze_source as j_analyze
from deeplearning4j_tpu_torch.analysis import (RULES, analyze_source,
                                               checkers, load_baseline,
                                               run_analysis)
from deeplearning4j_tpu_torch.analysis.__main__ import main
from deeplearning4j_tpu_torch.common import metrics


def _rules(findings, rule):
    return [f for f in findings if f.rule == rule]


def _port(src, relpath="deeplearning4j_tpu_torch/fixture.py"):
    return analyze_source(textwrap.dedent(src), relpath)


# ---------------------------------------------------------------------------
# DL102, DL104, DL105: the JAX package's logic, finding for finding
# ---------------------------------------------------------------------------

_LOCKS_INVERTED = """
    import threading

    class Engine:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def _inner(self):
            with self._b:
                pass

        def forward(self):
            with self._a:
                self._inner()

        def backward(self):
            with self._b:
                with self._a:
                    pass
"""

#: name -> (fixture source, its path under the package, rule)
SHARED = {
    "dl102_reads": ("""
        import os
        a = os.environ["DL4J_TPU_FOO"]
        b = os.environ.get("DL4J_TPU_BAR", "1")
        c = os.getenv("DL4J_TPU_BAZ")
        d = "DL4J_TPU_QUX" in os.environ
    """, "fixture.py", "DL102"),
    "dl102_declared_knob": ("""
        import os
        v = os.environ.get("DL4J_TPU_METRICS")
        w = os.environ.get("HOME")
    """, "fixture.py", "DL102"),
    "dl102_environment_exempt": ("""
        import os
        v = os.environ.get("DL4J_TPU_DEBUG")
    """, "common/environment.py", "DL102"),
    "dl102_helper": ("""
        def _env_bool(name, default=False):
            return False
        v = _env_bool("DL4J_TPU_SOMETHING")
    """, "fixture.py", "DL102"),
    "dl104_names_labels_spans": ("""
        from x.tracing import span
        def setup(reg):
            reg.counter("requests_total", "d")
            reg.histogram("dl4j_x_seconds", "d", labels=("model", "user_id"))
            reg.counter("dl4j_things_total", "d",
                        labels=("model", "version", "outcome"))
        def work():
            span("serving/thing")
            with span("serving/thing", model="m"):
                return 1
    """, "fixture.py", "DL104"),
    "dl104_metrics_flag": ("""
        import os
        def enabled():
            return os.environ.get("DL4J_TPU_METRICS", "1") != "0"
    """, "fixture.py", "DL104"),
    "dl104_metrics_impl_exempt": ("""
        import os
        def enabled():
            return os.environ.get("DL4J_TPU_METRICS", "1") != "0"
    """, "common/metrics.py", "DL104"),
    "dl105_cycle_through_call": (_LOCKS_INVERTED, "fixture.py", "DL105"),
    "dl105_self_deadlock_and_rlock": ("""
        import threading

        class Engine:
            def __init__(self):
                self._a = threading.Lock()
                self._r = threading.RLock()

            def work(self):
                with self._a:
                    with self._a:
                        pass

            def again(self):
                with self._r:
                    with self._r:
                        pass
    """, "fixture.py", "DL105"),
    "dl105_ordered_wrappers": ("""
        from x.locks import ordered_lock, ordered_rlock

        class Engine:
            def __init__(self):
                self._a = ordered_lock("a")
                self._b = ordered_rlock("b")
                self._thread = None

            def forward(self):
                with self._a:
                    with self._b:
                        self._thread.start()

            def backward(self):
                with self._b:
                    with self._a:
                        pass
    """, "fixture.py", "DL105"),
}


@pytest.mark.parametrize("name", list(SHARED))
def test_shared_rules_find_what_the_jax_analyzer_finds(name):
    src, rel, rule = SHARED[name]
    src = textwrap.dedent(src)
    ours = _rules(analyze_source(src, f"deeplearning4j_tpu_torch/{rel}"),
                  rule)
    theirs = _rules(j_analyze(src, f"deeplearning4j_tpu/{rel}"), rule)
    assert [(f.line, f.message.replace("deeplearning4j_tpu_torch/",
                                       "deeplearning4j_tpu/"))
            for f in ours] == [(f.line, f.message) for f in theirs]
    if rel == "fixture.py" or rule == "DL105":
        assert ours, "the fixture must find something"


@pytest.mark.parametrize("rel,found", [("runtime/x.py", 1),
                                       ("serving/x.py", 1),
                                       ("nn/x.py", 0)])
def test_lock_order_scope_as_jax(rel, found):
    """DL105 reads the concurrent stack only (runtime/, serving/,
    common/), on both sides."""
    import ast
    from deeplearning4j_tpu.analysis import Module as JModule
    from deeplearning4j_tpu.analysis import lockgraph as jlockgraph
    from deeplearning4j_tpu_torch.analysis import Module, lockgraph
    src = textwrap.dedent(_LOCKS_INVERTED)
    for mod_cls, lg, pkg in ((Module, lockgraph, "deeplearning4j_tpu_torch"),
                             (JModule, jlockgraph, "deeplearning4j_tpu")):
        m = mod_cls(path=rel, relpath=f"{pkg}/{rel}", tree=ast.parse(src),
                    source=src)
        assert len(lg.check_lock_order([m])) == found


def test_the_ports_build_labels_are_registered():
    assert set(metrics._build_labels()) <= checkers.REGISTERED_LABELS


# ---------------------------------------------------------------------------
# DL101: bare captures and torch.compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,form", [
    ("""
        import torch
        def cap(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return g
     """, "torch.cuda.CUDAGraph"),
    ("""
        import torch
        def cap(m, x):
            return torch.cuda.make_graphed_callables(m, (x,))
     """, "torch.cuda.make_graphed_callables"),
    ("""
        import torch
        fast = torch.compile(lambda x: x * 2)
     """, "torch.compile"),
    ("""
        import torch
        @torch.compile(mode="reduce-overhead")
        def step(x):
            return x
     """, "@torch.compile"),
    ("""
        import functools, torch
        c = functools.partial(torch.compile, fullgraph=True)
     """, "functools.partial(torch.compile"),
], ids=["graph", "make_graphed_callables", "compile", "decorator",
        "partial"])
def test_dl101_flags_a_bare_capture(src, form):
    f = _rules(_port(src), "DL101")
    assert f and form in f[0].message and "captured_dispatch" in f[0].message


def test_dl101_false_positive_guards():
    src = """
        import torch
        from deeplearning4j_tpu_torch.runtime.inference import \\
            captured_dispatch
        def cap(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            pool = torch.cuda.graph_pool_handle()
            return captured_dispatch(fn, "t", "cuda")
    """
    # the one sanctioned capture site
    assert _rules(_port(src, "deeplearning4j_tpu_torch/runtime/"
                             "cuda_graphs.py"), "DL101") == []
    assert len(_rules(_port(src), "DL101")) == 2   # elsewhere: both
    assert _rules(_port("""
        from deeplearning4j_tpu_torch.runtime.inference import \\
            captured_dispatch
        def make(fn):
            return captured_dispatch(fn, "t", "cuda")
    """), "DL101") == []


# ---------------------------------------------------------------------------
# DL103: host syncs in captured bodies
# ---------------------------------------------------------------------------

_HAZARDS = """
    import random, time
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.runtime.inference import (
        captured_dispatch, captured_train_step, eager_dispatch)

    def build(net):
        def forward(params, x):
            a = x.sum().item()
            b = x.cpu()
            c = x.numpy()
            d = x.tolist()
            e = float(x.mean())
            f = int(x.max())
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = random.random()
            n = np.random.rand()
            return x
        return captured_dispatch(forward, "t", "cuda")

    def train(step):
        return captured_train_step(step, "bert")

    def step(params, opt, batch, it):
        return params, opt, float(batch.sum())

    class Engine:
        def __init__(self):
            self._graphs = None
            self._run = captured_dispatch(self._execute, "tflite", "cuda")

        def _execute(self, params, x):
            return x.tolist()

        def decode(self, s, body):
            return self._graphs.run(s, lambda: lambda: body().item())
"""


def test_dl103_flags_host_syncs_in_captured_bodies():
    f = _rules(_port(_HAZARDS), "DL103")
    by_fn = {}
    for x in f:
        by_fn.setdefault(x.message.split("'")[1], []).append(x.message)
    assert len(by_fn["forward"]) == 10
    for what in (".item()", ".cpu()", ".numpy()", ".tolist()", "float()",
                 "int()", "torch.cuda.synchronize()",
                 "time.perf_counter()", "random.random()",
                 "np.random.rand()"):
        assert any(what in m for m in by_fn["forward"]), what
    assert len(by_fn["step"]) == 1                  # captured_train_step
    assert len(by_fn["_execute"]) == 1              # self.<method>
    assert len(by_fn["<lambda>"]) == 1              # a StepGraphs body


def test_dl103_false_positive_guards():
    assert _rules(_port("""
        import time, torch
        from deeplearning4j_tpu_torch.runtime.inference import (
            captured_dispatch, eager_dispatch)

        def forward(params, x):
            n = int(x.shape[0]) + int(x.size(0)) + int(x.dim())
            k = float(x.numel())
            return x.reshape(n, -1)

        def host_side(x):
            return x.cpu().numpy().tolist(), time.time(), x.item()

        def eager(params, x):
            return x.item()

        f = captured_dispatch(forward, "t", "cuda")
        g = eager_dispatch(eager, "t", None, "host_value")
    """), "DL103") == []


# ---------------------------------------------------------------------------
# the gate: the port's own package, its baseline and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repo_result():
    return run_analysis()


def test_the_port_has_zero_unbaselined_findings(repo_result):
    assert repo_result.ok, "unbaselined findings:\n" + "\n".join(
        f.render() for f in repo_result.findings)
    assert repo_result.modules > 150
    assert repo_result.unused_baseline == []
    assert {f.path.split("/")[0] for f, _ in repo_result.baselined} == \
        {"deeplearning4j_tpu_torch"}


def test_every_baseline_entry_is_justified(tmp_path):
    entries = load_baseline()
    assert entries and all(len(e["justification"]) > 40 for e in entries)
    assert all(e["path"].startswith("deeplearning4j_tpu_torch/")
               for e in entries)
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps([{"rule": "DL101", "path": "x.py",
                              "justification": "  "}]))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(p))


def test_cli_exits_zero_on_the_port_and_nonzero_on_a_capture(tmp_path,
                                                             capsys):
    out = subprocess.run([sys.executable, "-m",
                          "deeplearning4j_tpu_torch.analysis",
                          "--strict-baseline"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 unbaselined finding(s)" in out.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nf = torch.compile(lambda x: x)\n")
    assert main([str(bad)]) == 1
    assert "DL101" in capsys.readouterr().out
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(rule in listed for rule in RULES) and len(RULES) == 5
    assert main([str(bad), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is False and report["findings"][0]["rule"] == "DL101"
