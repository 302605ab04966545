"""Framework-invariant static analysis (``python -m deeplearning4j_tpu_torch.analysis``).

Counterpart of ``deeplearning4j_tpu/analysis/``, run over the port. The
port's load-bearing conventions, turned into CI-gated rules: every CUDA
graph capture goes through ``runtime/cuda_graphs.py`` (``StepGraphs``,
reached through ``runtime.inference.counted_dispatch`` /
``captured_dispatch`` / ``captured_train_step``) or it bypasses the
dispatch census and ``StepGraphs``' eager reasons; every ``DL4J_TPU_*``
knob is declared on ``Environment``; a captured body never syncs the host;
metrics stay inside the ``dl4j_*`` namespace with bounded label
cardinality; and the locks across ``runtime/``/``serving/``/``common/``
keep a consistent acquisition order. An AST pass in the spirit of a
ThreadSanitizer-style lock-order graph applied statically:

======  =================================================================
DL101   a bare ``torch.cuda.graph`` / ``torch.cuda.CUDAGraph`` /
        ``torch.cuda.make_graphed_callables`` / ``torch.compile`` outside
        ``runtime/cuda_graphs.py`` — bypasses the census and the eager
        reasons of ``StepGraphs``
DL102   ``os.environ`` reads of ``DL4J_TPU_*`` knobs that bypass
        ``Environment`` (and knobs read but never declared on it)
DL103   host syncs inside the functions handed to ``captured_dispatch``,
        ``captured_train_step`` or a ``StepGraphs``' ``run``:
        ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()``,
        ``float()`` / ``int()`` of a tensor, ``torch.cuda.synchronize()``,
        Python-time ``random``/``time`` calls
DL104   metrics/tracing hygiene: ``dl4j_*`` metric names, labels from the
        registered set (bounded cardinality), ``span()`` used as a
        context manager, no private re-reads of ``DL4J_TPU_METRICS``
DL105   static lock-order analysis: acquisition graph over nested
        ``with <lock>:`` / ``acquire()`` scopes, cycles reported (the
        runtime half lives in ``common.locks.OrderedLock``)
======  =================================================================

Findings are suppressible via the checked-in ``analysis/baseline.json``
(every entry carries a justification string) so the pass lands green and
*ratchets*: new violations fail tier-1 (``tests/test_torch_analysis.py``);
baselined ones are visible debt, never silent.
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "Module", "AnalysisResult", "run_analysis", "analyze_source",
    "load_baseline", "baseline_path", "RULES", "PACKAGE_ROOT",
]

#: rule id -> one-line summary (the CLI's --list-rules output)
RULES: Dict[str, str] = {
    "DL101": "bare CUDA graph capture or torch.compile outside "
             "runtime/cuda_graphs.py (bypasses the census and StepGraphs' "
             "eager reasons)",
    "DL102": "os.environ read of a DL4J_TPU_* knob bypassing Environment "
             "(or an undeclared knob)",
    "DL103": "host-sync hazard inside a captured body (.item()/.cpu()/"
             ".numpy()/.tolist()/float()/synchronize/time/random)",
    "DL104": "metrics/tracing hygiene (dl4j_* names, registered labels, "
             "span() as context manager, one metrics flag)",
    "DL105": "lock-order hazard (acquisition-graph cycle or nested "
             "non-reentrant self-acquire)",
}

#: absolute path of the package this pass defends
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str          # repo-relative posix path (baseline key)
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Module:
    """One parsed source file handed to every checker."""
    path: str          # absolute
    relpath: str       # relative to the package parent, posix separators
    tree: ast.AST
    source: str

    @classmethod
    def parse(cls, path: str, relpath: Optional[str] = None) -> "Module":
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        rel = relpath if relpath is not None else _relpath(path)
        return cls(path=path, relpath=rel,
                   tree=ast.parse(src, filename=path), source=src)


def _relpath(path: str) -> str:
    root = os.path.dirname(PACKAGE_ROOT)
    rel = os.path.relpath(os.path.abspath(path), root)
    return rel.replace(os.sep, "/")


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)        # unbaselined
    baselined: List[Tuple[Finding, dict]] = field(default_factory=list)
    unused_baseline: List[dict] = field(default_factory=list)
    modules: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "modules": self.modules,
            "findings": [vars(f) for f in self.findings],
            "baselined": [dict(vars(f), justification=e.get("justification"))
                          for f, e in self.baselined],
            "unused_baseline": list(self.unused_baseline),
        }


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[dict]:
    """The checked-in suppression list. Every entry must carry ``rule``,
    ``path`` and a non-empty ``justification``; ``match`` (optional)
    narrows the suppression to findings whose message contains it —
    without it the entry suppresses every finding of that rule in that
    file. Line numbers are deliberately NOT part of the key so unrelated
    edits above a baselined site do not invalidate the baseline."""
    p = path or baseline_path()
    if not os.path.exists(p):
        return []
    with open(p, "r", encoding="utf-8") as f:
        entries = json.load(f)
    for e in entries:
        if not e.get("rule") or not e.get("path"):
            raise ValueError(f"baseline entry missing rule/path: {e}")
        if not str(e.get("justification", "")).strip():
            raise ValueError(
                f"baseline entry for {e['rule']} {e['path']} has no "
                "justification — suppressions must say WHY "
                "(the add-with-justification rule)")
    return entries


def _match(entry: dict, finding: Finding) -> bool:
    if entry["rule"] != finding.rule or entry["path"] != finding.path:
        return False
    m = entry.get("match")
    return m is None or m in finding.message


def apply_baseline(findings: Iterable[Finding],
                   entries: Sequence[dict]) -> AnalysisResult:
    res = AnalysisResult()
    used = [False] * len(entries)
    for f in findings:
        hit = None
        for i, e in enumerate(entries):
            if _match(e, f):
                hit, used[i] = e, True
                break
        if hit is None:
            res.findings.append(f)
        else:
            res.baselined.append((f, hit))
    res.unused_baseline = [e for e, u in zip(entries, used) if not u]
    return res


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _iter_sources(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def collect_findings(paths: Optional[Sequence[str]] = None) -> Tuple[
        List[Finding], int]:
    """Run every checker over ``paths`` (default: the installed package
    itself). Returns (findings sorted by location, module count)."""
    from . import checkers, lockgraph

    targets = list(paths) if paths else [PACKAGE_ROOT]
    modules: List[Module] = []
    findings: List[Finding] = []
    for src in _iter_sources(targets):
        try:
            modules.append(Module.parse(src))
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                "DL100", _relpath(src), getattr(e, "lineno", 0) or 0,
                f"unparseable source: {e.msg if hasattr(e, 'msg') else e}"))
    for mod in modules:
        findings.extend(checkers.check_module(mod))
    findings.extend(lockgraph.check_lock_order(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, len(modules)


def run_analysis(paths: Optional[Sequence[str]] = None,
                 baseline: Optional[str] = "default") -> AnalysisResult:
    """The library entry the CLI and the tier-1 test share. ``baseline``:
    "default" loads ``analysis/baseline.json``; None disables
    suppression; any other string is an explicit baseline path."""
    findings, n = collect_findings(paths)
    entries = ([] if baseline is None
               else load_baseline(None if baseline == "default"
                                  else baseline))
    res = apply_baseline(findings, entries)
    res.modules = n
    return res


def analyze_source(source: str, relpath: str = "snippet.py") -> List[Finding]:
    """Checker access for tests/fixtures: analyze one in-memory module
    (all rules, no baseline)."""
    from . import checkers, lockgraph

    mod = Module(path=relpath, relpath=relpath,
                 tree=ast.parse(source), source=source)
    out = list(checkers.check_module(mod))
    # fixtures opt out of the runtime/serving/common scope filter: every
    # rule must be testable on an in-memory snippet
    out.extend(lockgraph.check_lock_order([mod], scope_filter=False))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out
