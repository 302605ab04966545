"""AST checkers DL101–DL104 (DL105 lives in ``lockgraph.py``).

Counterpart of ``deeplearning4j_tpu/analysis/checkers.py``: DL102 and
DL104 keep their logic; DL101 and DL103 name the port's idioms (CUDA graph
captures and the functions handed to a captured dispatch) where the JAX
package's name ``jax.jit`` and traced functions.

Each checker is a pure function over one parsed :class:`~.Module`; the
driver in ``__init__.py`` concatenates their findings and applies the
baseline. Checkers are deliberately *syntactic* — they encode the
framework's conventions, not a type system — so every rule documents its
known false-positive guards and the baseline carries the rest.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set

from . import Finding, Module, PACKAGE_ROOT

#: label keys metric families may use — the bounded-cardinality contract
#: (DL104). Every key here is either a closed enum (kind/cache/outcome/
#: reason/state/good/window/path/site/engine/mode/tier/priority/slo —
#: mode is the quantization storage format, int8|fp8; tier is the
#: artifact-store layer, local|remote; priority is the X-Priority
#: request class, the ten values "0".."9"; slo is the goodput split on
#: ``dl4j_tokens_total``, ok|violated; outcome enums are per-family,
#: e.g. the router dispatch set and the session-affinity pair
#: hit|fallback on ``dl4j_fleet_affinity_total``; kernel is the
#: hand-written-kernel family on ``dl4j_kernel_dispatch_total`` —
#: attention|paged_decode|dequant_matmul), a deploy-bounded identity
#: (model/version/bucket/worker/name/replica — replica is a fleet
#: member's URL, bounded by the router's configured replica set), or
#: process identity (the build-info labels: torch and CUDA versions,
#: platform, cache). A request-scoped value (trace id, user id, prompt)
#: must ride on exemplars or spans, never on labels.
REGISTERED_LABELS: Set[str] = {
    "bucket", "cache", "engine", "good", "kernel", "kind", "mode", "model",
    "name", "outcome", "path", "priority", "reason", "replica", "site",
    "slo", "state", "tier", "version", "window", "worker", "torch_version",
    "cuda_version", "platform",
}

#: callables that capture the function handed to them (DL103): its body
#: runs inside a CUDA graph capture on the card (and is replayed), where a
#: host sync breaks the capture and host randomness/time freezes into the
#: graph.
_CAPTURE_ENTRY_NAMES = {"captured_dispatch", "captured_train_step"}

#: receivers whose ``.run(step, make_body, ...)`` captures ``make_body``'s
#: body: a ``StepGraphs`` bound to ``graphs`` or ``self._graphs``
_STEP_GRAPHS_RECEIVERS = ("graphs", "_graphs")

#: modules whose helper wrappers read env vars on behalf of a caller
#: (DL102 treats a literal DL4J_TPU_* first argument as a read)
_ENV_HELPER_NAMES = {"_env_bool", "_env_int", "_env_float", "getenv"}


# ---------------------------------------------------------------------------
# shared AST utilities
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


#: the bare capture and compile entry points DL101 flags
_CAPTURE_CALLS = {
    "torch.cuda.graph", "torch.cuda.graphs.graph", "torch.cuda.CUDAGraph",
    "torch.cuda.graphs.CUDAGraph", "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables", "torch.compile",
}

#: the one sanctioned capture site
_DL101_EXEMPT = ("deeplearning4j_tpu_torch/runtime/cuda_graphs.py",)


def _is_capture(node: ast.AST) -> bool:
    return _dotted(node) in _CAPTURE_CALLS


class _ScopeVisitor(ast.NodeVisitor):
    """Tracks the enclosing function qualname while walking."""

    def __init__(self):
        self.stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


# ---------------------------------------------------------------------------
# DL101 — bare CUDA graph capture / torch.compile outside cuda_graphs.py
# ---------------------------------------------------------------------------

class _DL101(_ScopeVisitor):
    def __init__(self, mod: Module):
        super().__init__()
        self.mod = mod
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, form: str):
        self.findings.append(Finding(
            "DL101", self.mod.relpath, node.lineno,
            f"bare {form} in {self.qualname} bypasses the dispatch census "
            "and StepGraphs' eager reasons — route the step through "
            "runtime.inference.captured_dispatch(fn, tag, device) (or "
            "runtime.cuda_graphs.StepGraphs)"))

    def visit_Call(self, node: ast.Call):
        if _is_capture(node.func):
            self._flag(node, f"{_dotted(node.func)}(...)")
        elif _dotted(node.func) in ("functools.partial", "partial") \
                and node.args and _is_capture(node.args[0]):
            self._flag(node, f"functools.partial({_dotted(node.args[0])}, "
                       "...)")
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _is_capture(target):
                self._flag(dec, f"@{_dotted(target)}")
        super().visit_FunctionDef(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def check_dl101(mod: Module) -> List[Finding]:
    if mod.relpath in _DL101_EXEMPT:
        return []
    v = _DL101(mod)
    v.visit(mod.tree)
    return v.findings


# ---------------------------------------------------------------------------
# DL102 — os.environ reads of DL4J_TPU_* bypassing Environment
# ---------------------------------------------------------------------------

_DECLARED_ENV: Optional[Set[str]] = None


def declared_env_names() -> Set[str]:
    """Env-var names declared in ``common/environment.py`` — the knob
    registry DL102 checks reads against: the environment variables of
    ``_PROPS`` (each property's name or names, which ``EnvironmentVars``
    is built from) and any string constant assigned in the
    ``EnvironmentVars`` class body. Parsed from source (not imported) so
    the pass works on any checkout without importing torch."""
    global _DECLARED_ENV
    if _DECLARED_ENV is None:
        names: Set[str] = set()
        path = os.path.join(PACKAGE_ROOT, "common", "environment.py")
        try:
            with open(path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            _DECLARED_ENV = set()
            return _DECLARED_ENV
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) \
                    and node.name == "EnvironmentVars":
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) \
                            and isinstance(stmt.value, ast.Constant) \
                            and isinstance(stmt.value.value, str):
                        names.add(stmt.value.value)
            target = node.target if isinstance(node, ast.AnnAssign) else (
                node.targets[0] if isinstance(node, ast.Assign)
                and len(node.targets) == 1 else None)
            if isinstance(target, ast.Name) and target.id == "_PROPS" \
                    and isinstance(node.value, ast.Dict):
                for spec in node.value.values:
                    if isinstance(spec, ast.Tuple) and spec.elts:
                        for sub in ast.walk(spec.elts[0]):
                            if isinstance(sub, ast.Constant) \
                                    and isinstance(sub.value, str):
                                names.add(sub.value)
        _DECLARED_ENV = names
    return _DECLARED_ENV


#: the Environment implementation itself is the one sanctioned reader
_DL102_EXEMPT = ("deeplearning4j_tpu_torch/common/environment.py",)


def _env_read_name(node: ast.Call) -> Optional[ast.AST]:
    """The name-expression of an env read call, or None."""
    fn = _dotted(node.func)
    if fn in ("os.environ.get", "os.getenv") and node.args:
        return node.args[0]
    if isinstance(node.func, ast.Name) \
            and node.func.id in _ENV_HELPER_NAMES and node.args:
        return node.args[0]
    return None


def check_dl102(mod: Module) -> List[Finding]:
    if mod.relpath in _DL102_EXEMPT:
        return []
    out: List[Finding] = []
    declared = declared_env_names()

    def flag(node: ast.AST, name: str, how: str):
        extra = ("" if name in declared else
                 " — and the knob is not even declared on "
                 "EnvironmentVars (undocumented)")
        out.append(Finding(
            "DL102", mod.relpath, node.lineno,
            f"{how} of {name!r} bypasses Environment's layered resolution "
            f"(programmatic override > env > default){extra}; read it "
            "through a common.environment.Environment property"))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Subscript) \
                and _dotted(node.value) == "os.environ":
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str) \
                    and sl.value.startswith("DL4J_TPU_"):
                flag(node, sl.value, "os.environ[...] read")
        elif isinstance(node, ast.Call):
            arg = _env_read_name(node)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and arg.value.startswith("DL4J_TPU_"):
                flag(node, arg.value,
                     f"{_dotted(node.func) or 'env-helper'} read")
        elif isinstance(node, ast.Compare) \
                and len(node.comparators) == 1 \
                and _dotted(node.comparators[0]) == "os.environ" \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str) \
                and node.left.value.startswith("DL4J_TPU_"):
            flag(node, node.left.value, "membership test against os.environ")
    return out


# ---------------------------------------------------------------------------
# DL103 — host-sync hazards inside captured bodies
# ---------------------------------------------------------------------------

def _captured_function_nodes(mod: Module) -> List[ast.AST]:
    """Function/lambda nodes whose bodies run inside a CUDA graph
    capture: handed (by name, as ``self.<method>``, or inline) to
    ``captured_dispatch`` / ``captured_train_step``, or given as the body
    factory of a ``StepGraphs``' ``run`` (``graphs.run(step, make_body,
    ...)``). One module-local level — callees in other modules are out of
    scope by design."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)

    captured: List[ast.AST] = []
    seen = set()

    def mark(arg: ast.AST):
        nodes: List[ast.AST] = []
        if isinstance(arg, ast.Lambda):
            nodes = [arg]
        elif isinstance(arg, ast.Name):
            nodes = defs.get(arg.id, [])
        elif isinstance(arg, ast.Attribute) \
                and isinstance(arg.value, ast.Name) \
                and arg.value.id == "self":
            nodes = defs.get(arg.attr, [])
        for node in nodes:
            if id(node) not in seen:
                seen.add(id(node))
                captured.append(node)

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None:
            continue
        leaf = d.rsplit(".", 1)[-1]
        if leaf in _CAPTURE_ENTRY_NAMES and node.args:
            mark(node.args[0])
        elif leaf == "run" and "." in d \
                and d.rsplit(".", 2)[-2] in _STEP_GRAPHS_RECEIVERS \
                and len(node.args) > 1:
            mark(node.args[1])
    return captured


#: method calls that copy a tensor to the host (and wait for the card)
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}

#: attributes whose values are static (shape arithmetic is capture-safe)
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "dim", "numel"}


def _dl103_hazard(node: ast.Call) -> Optional[str]:
    d = _dotted(node.func)
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS and not node.args:
        if node.func.attr == "synchronize":
            return (f"{d or '.synchronize'}() waits for the card inside "
                    "a capture")
        return (f".{node.func.attr}() copies a tensor to the host (a "
                "device->host sync)")
    if isinstance(node.func, ast.Name) \
            and node.func.id in ("float", "int", "bool") \
            and len(node.args) == 1 \
            and not isinstance(node.args[0], ast.Constant):
        # static-shape arithmetic is capture-safe: int(x.shape[0]) etc.
        for sub in ast.walk(node.args[0]):
            if isinstance(sub, ast.Attribute) \
                    and sub.attr in _STATIC_ATTRS:
                return None
        return (f"{node.func.id}() of a tensor forces a device->host "
                "sync")
    if d in ("time.time", "time.perf_counter", "time.monotonic",
             "time.sleep"):
        return (f"{d}() runs once, at capture — it freezes into the "
                "replayed graph")
    if d is not None and (d.startswith("random.")
                          or d.startswith("np.random.")
                          or d.startswith("numpy.random.")):
        return (f"{d}() draws host randomness once, at capture — draw "
                "from common.rng's device keys")
    return None


def check_dl103(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    for fn in _captured_function_nodes(mod):
        name = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                why = _dl103_hazard(node)
                if why:
                    out.append(Finding(
                        "DL103", mod.relpath, node.lineno,
                        f"host-sync hazard in captured function "
                        f"'{name}': {why}"))
    return out


# ---------------------------------------------------------------------------
# DL104 — metrics/tracing hygiene
# ---------------------------------------------------------------------------

#: the one module allowed to read the metrics flag (it caches it as
#: MetricsRegistry.enabled — everything else must consult that)
_DL104_METRICS_IMPL = ("deeplearning4j_tpu_torch/common/metrics.py",)

_METRIC_CTORS = {"counter", "gauge", "histogram"}


def check_dl104(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            fn = call.func
            leaf = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if leaf == "span":
                out.append(Finding(
                    "DL104", mod.relpath, node.lineno,
                    "span(...) called as a bare statement — the context "
                    "manager never runs, so the span times nothing; use "
                    "`with span(...):`"))
        if not isinstance(node, ast.Call):
            continue
        leaf = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if leaf in _METRIC_CTORS and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            name = node.args[0].value
            if not name.startswith("dl4j_"):
                out.append(Finding(
                    "DL104", mod.relpath, node.lineno,
                    f"metric name {name!r} is outside the dl4j_* "
                    "namespace — all framework series share the prefix "
                    "so dashboards/alerts can scope on it"))
            for kw in node.keywords:
                if kw.arg != "labels" or not isinstance(
                        kw.value, (ast.Tuple, ast.List)):
                    continue
                for elt in kw.value.elts:
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str) \
                            and elt.value not in REGISTERED_LABELS:
                        out.append(Finding(
                            "DL104", mod.relpath, node.lineno,
                            f"label key {elt.value!r} on metric {name!r} "
                            "is not in analysis.checkers."
                            "REGISTERED_LABELS — register it (with a "
                            "cardinality bound) or carry the value on an "
                            "exemplar/span instead"))
        if mod.relpath not in _DL104_METRICS_IMPL:
            arg = _env_read_name(node) if isinstance(node, ast.Call) else None
            if isinstance(arg, ast.Constant) \
                    and arg.value == "DL4J_TPU_METRICS":
                out.append(Finding(
                    "DL104", mod.relpath, node.lineno,
                    "private re-read of DL4J_TPU_METRICS — the flag is "
                    "cached once on MetricsRegistry.enabled; check that "
                    "(or registry().enabled) so set_metrics_enabled() "
                    "stays authoritative"))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def check_module(mod: Module) -> Iterator[Finding]:
    for checker in (check_dl101, check_dl102, check_dl103, check_dl104):
        yield from checker(mod)
