"""DL105 — static lock-acquisition-order analysis (a copy of the JAX
package's ``analysis/lockgraph.py``, scoped to the port's packages).

A ThreadSanitizer-style lock-order graph built *statically*: every lock
the serving stack owns (``threading.Lock/RLock/Condition`` or the
``common.locks`` ordered wrappers, bound to a module global or a
``self.<attr>``) becomes a node; acquiring lock B while holding lock A —
via nested ``with`` blocks, bare ``acquire()`` calls, or a call to a
same-module function that itself acquires B — adds the edge A→B. A cycle
in the resulting graph means two code paths acquire the same pair of
locks in opposite orders: with the right thread interleaving that is a
deadlock on the serving path, found here without ever running it. A
non-reentrant lock re-acquired under itself is reported as a guaranteed
self-deadlock.

Deliberate limits (the runtime tracker in ``common.locks`` covers what
static analysis cannot see):

- calls on *other* objects (``engine.drain()`` under the registry lock)
  are expanded **by method name** over every analyzed class: the callee
  is taken to acquire the union of what any analyzed class's same-named
  method may acquire. Conservative — a false edge is possible when two
  unrelated classes share a method name, a missed edge is not (within
  the analyzed modules). Ubiquitous container-method names (``get``,
  ``append``, ...) are excluded from the expansion;
- ``Condition.wait()`` releasing its lock mid-block is ignored — the
  lock is treated as held for the whole ``with``, which is conservative
  (may add edges, never miss them);
- lock identity is per class/module, not per instance — two instances
  of one class share a node, which is exactly the granularity an
  ordering discipline is defined at.

Scope: ``runtime/``, ``serving/`` and ``common/`` (the concurrent
serving stack); other packages hold locks too but are single-subsystem.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from . import Finding, Module
from .checkers import _dotted

#: constructors that create a lock we track; value = reentrant?
_LOCK_CTORS = {
    "threading.Lock": False,
    "threading.RLock": True,
    "threading.Condition": True,   # default/ordered condition wraps an RLock
    "Lock": False, "RLock": True, "Condition": True,
    "ordered_lock": False, "ordered_rlock": True, "ordered_condition": True,
    "locks.ordered_lock": False, "locks.ordered_rlock": True,
    "locks.ordered_condition": True,
    "OrderedLock": False,
}

_SCOPE_PREFIXES = ("deeplearning4j_tpu_torch/runtime/",
                   "deeplearning4j_tpu_torch/serving/",
                   "deeplearning4j_tpu_torch/common/")

#: method names never expanded cross-class — they collide with the
#: stdlib container/str protocol on every other line of the codebase
_COMMON_METHODS = {
    "get", "set", "add", "pop", "append", "remove", "clear", "update",
    "copy", "setdefault", "discard", "extend", "insert", "count",
    "index", "sort", "split", "rsplit", "strip", "lstrip", "rstrip",
    "encode", "decode", "format", "join", "read", "write", "flush",
    "items", "keys", "values", "acquire", "release", "wait", "notify",
    "notify_all", "is_set", "match", "search", "sub", "group", "lower",
    "upper", "startswith", "endswith", "replace", "isoformat", "mktemp",
    "mkdir", "exists", "close",
}


def _lock_ctor_reentrant(node: ast.AST) -> Optional[bool]:
    """None if ``node`` is not a lock constructor call, else whether the
    constructed lock is reentrant."""
    if not isinstance(node, ast.Call):
        return None
    d = _dotted(node.func)
    if d is None or d not in _LOCK_CTORS:
        return None
    reentrant = _LOCK_CTORS[d]
    if d.rsplit(".", 1)[-1] == "OrderedLock":
        for kw in node.keywords:
            if kw.arg == "reentrant" and isinstance(kw.value, ast.Constant):
                reentrant = bool(kw.value.value)
    return reentrant


@dataclass
class _FuncSummary:
    qualname: str
    relpath: str
    acquires: Set[str] = field(default_factory=set)
    # direct nesting edges: (held, acquired, line)
    edges: Set[Tuple[str, str, int]] = field(default_factory=set)
    # calls made while holding locks: (held frozenset, callee key, line)
    calls: List[Tuple[FrozenSet[str], str, int]] = field(
        default_factory=list)


class _ModuleLocks:
    """Lock inventory + per-function summaries for one module."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.reentrant: Dict[str, bool] = {}
        self.module_locks: Dict[str, str] = {}          # varname -> node id
        self.class_locks: Dict[str, Dict[str, str]] = {}  # cls -> attr -> id
        # self.<attr> ever assigned threading.Thread(...): calls through
        # these receivers are Thread.start()/join(), NOT an analyzed
        # class's method — excluded from the by-name expansion
        self.thread_attrs: Dict[str, Set[str]] = {}
        self.funcs: Dict[str, _FuncSummary] = {}        # callee key -> summary
        self._collect_locks()
        self._summarize()

    # -- lock inventory ---------------------------------------------------
    def _node(self, scope: str, name: str) -> str:
        return f"{self.mod.relpath}::{scope}{name}"

    def _collect_locks(self):
        tree = self.mod.tree
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign):
                r = _lock_ctor_reentrant(stmt.value)
                if r is None:
                    continue
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        nid = self._node("", tgt.id)
                        self.module_locks[tgt.id] = nid
                        self.reentrant[nid] = r
            elif isinstance(stmt, ast.ClassDef):
                attrs: Dict[str, str] = {}
                tattrs: Set[str] = set()
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Assign) \
                            and isinstance(sub.value, ast.Call) \
                            and _dotted(sub.value.func) in (
                                "threading.Thread", "Thread"):
                        for tgt in sub.targets:
                            if isinstance(tgt, ast.Attribute) \
                                    and isinstance(tgt.value, ast.Name) \
                                    and tgt.value.id == "self":
                                tattrs.add(tgt.attr)
                if tattrs:
                    self.thread_attrs[stmt.name] = tattrs
                for sub in ast.walk(stmt):
                    # class-body assigns (cls._lock = Lock()) and
                    # self.<attr> = Lock() anywhere in the class's methods
                    if not isinstance(sub, ast.Assign):
                        continue
                    r = _lock_ctor_reentrant(sub.value)
                    if r is None:
                        continue
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            nid = self._node(f"{stmt.name}.", tgt.id)
                            attrs[tgt.id] = nid
                            self.reentrant[nid] = r
                        elif isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id in ("self", "cls"):
                            nid = self._node(f"{stmt.name}.", tgt.attr)
                            attrs[tgt.attr] = nid
                            self.reentrant[nid] = r
                if attrs:
                    self.class_locks[stmt.name] = attrs

    # -- acquisition-expression resolution --------------------------------
    def _resolve(self, expr: ast.AST, cls: Optional[str]) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and cls:
                    return self.class_locks.get(cls, {}).get(expr.attr)
                if base.id in self.class_locks:   # C._lock class attribute
                    return self.class_locks[base.id].get(expr.attr)
        return None

    # -- function summaries ------------------------------------------------
    def _summarize(self):
        for stmt in self.mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._summarize_func(stmt, cls=None)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._summarize_func(sub, cls=stmt.name)

    def _summarize_func(self, fn: ast.AST, cls: Optional[str]):
        key = f"{cls}.{fn.name}" if cls else fn.name
        s = _FuncSummary(qualname=key, relpath=self.mod.relpath)
        self._walk_block(fn.body, [], s, cls)
        self.funcs[key] = s

    def _callee_key(self, call: ast.Call, cls: Optional[str]
                    ) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name) and f.id in self.funcs_declared():
            return f.id
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) \
                    and f.value.id in ("self", "cls") and cls:
                return f"{cls}.{f.attr}"
            if isinstance(f.value, ast.Attribute) \
                    and isinstance(f.value.value, ast.Name) \
                    and f.value.value.id == "self" and cls \
                    and f.value.attr in self.thread_attrs.get(cls, ()):
                return None  # Thread.start()/join(), not an engine method
            if f.attr not in _COMMON_METHODS:
                # cross-object call: resolved by method name over every
                # analyzed class (build_graph unions their summaries)
                return f"~{f.attr}"
        return None

    _declared: Optional[Set[str]] = None

    def funcs_declared(self) -> Set[str]:
        if self._declared is None:
            names: Set[str] = set()
            for stmt in self.mod.tree.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(stmt.name)
            self._declared = names
        return self._declared

    def _acquire(self, node: str, line: int, held: List[str],
                 s: _FuncSummary):
        for h in held:
            if h != node:
                s.edges.add((h, node, line))
        if node in held and not self.reentrant.get(node, False):
            # guaranteed self-deadlock, recorded as a self-edge
            s.edges.add((node, node, line))
        s.acquires.add(node)

    def _scan_calls(self, expr: ast.AST, held: List[str], s: _FuncSummary,
                    cls: Optional[str]):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                key = self._callee_key(sub, cls)
                if key is not None:
                    s.calls.append((frozenset(held), key, sub.lineno))

    def _walk_block(self, stmts: Iterable[ast.stmt], held: List[str],
                    s: _FuncSummary, cls: Optional[str]):
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                acquired = []
                for item in stmt.items:
                    node = self._resolve(item.context_expr, cls)
                    if node is not None:
                        self._acquire(node, stmt.lineno, held, s)
                        acquired.append(node)
                    else:
                        self._scan_calls(item.context_expr, held, s, cls)
                self._walk_block(stmt.body, held + acquired, s, cls)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # deferred execution: not under the held locks
            elif isinstance(stmt, (ast.If, ast.For, ast.While,
                                   ast.AsyncFor)):
                for expr in ast.iter_child_nodes(stmt):
                    if isinstance(expr, ast.expr):
                        self._scan_expr(expr, held, s, cls)
                self._walk_block(stmt.body, held, s, cls)
                self._walk_block(getattr(stmt, "orelse", []) or [],
                                 held, s, cls)
            elif isinstance(stmt, ast.Try):
                self._walk_block(stmt.body, held, s, cls)
                for h in stmt.handlers:
                    self._walk_block(h.body, held, s, cls)
                self._walk_block(stmt.orelse, held, s, cls)
                self._walk_block(stmt.finalbody, held, s, cls)
            else:
                self._scan_stmt(stmt, held, s, cls)

    def _scan_stmt(self, stmt: ast.stmt, held: List[str], s: _FuncSummary,
                   cls: Optional[str]):
        for expr in ast.walk(stmt):
            if not isinstance(expr, ast.Call):
                continue
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr == "acquire":
                node = self._resolve(f.value, cls)
                if node is not None and not _nonblocking(expr):
                    self._acquire(node, expr.lineno, held, s)
                    if node not in held:
                        held.append(node)  # held for the rest of the block
                    continue
            if isinstance(f, ast.Attribute) and f.attr == "release":
                node = self._resolve(f.value, cls)
                if node is not None and node in held:
                    held.remove(node)
                    continue
            key = self._callee_key(expr, cls)
            if key is not None and held:
                s.calls.append((frozenset(held), key, expr.lineno))

    def _scan_expr(self, expr: ast.expr, held: List[str], s: _FuncSummary,
                   cls: Optional[str]):
        self._scan_calls(expr, held, s, cls)


def _nonblocking(call: ast.Call) -> bool:
    """acquire(False) / acquire(blocking=False) cannot deadlock."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is False:
        return True
    return any(kw.arg == "blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is False for kw in call.keywords)


# ---------------------------------------------------------------------------
# whole-program graph + cycle detection
# ---------------------------------------------------------------------------

def build_graph(modules: Iterable[Module]
                ) -> Tuple[Dict[Tuple[str, str], Tuple[str, int, str]],
                           Dict[str, bool]]:
    """All acquisition-order edges across ``modules``:
    ``{(held, acquired): (relpath, line, function)}`` plus the
    per-lock reentrancy map. Callee resolution is global: same-module
    names resolve exactly; ``~method`` keys resolve to the union of
    every analyzed class's same-named method (conservative)."""
    mls = [_ModuleLocks(m) for m in modules]
    reentrant: Dict[str, bool] = {}
    # global function table: exact keys are (relpath, local key); the
    # method-name index unions C.m across classes and modules
    funcs: Dict[Tuple[str, str], _FuncSummary] = {}
    by_method: Dict[str, List[Tuple[str, str]]] = {}
    for ml in mls:
        reentrant.update(ml.reentrant)
        for key, s in ml.funcs.items():
            funcs[(ml.mod.relpath, key)] = s
            if "." in key:
                by_method.setdefault(key.split(".", 1)[1],
                                     []).append((ml.mod.relpath, key))

    def resolve(relpath: str, callee: str) -> List[Tuple[str, str]]:
        if callee.startswith("~"):
            return by_method.get(callee[1:], [])
        k = (relpath, callee)
        return [k] if k in funcs else []

    # transitive may-acquire over the global call graph
    may: Dict[Tuple[str, str], Set[str]] = {
        k: set(s.acquires) for k, s in funcs.items()}
    changed = True
    while changed:
        changed = False
        for k, s in funcs.items():
            for _, callee, _ in s.calls:
                for ck in resolve(k[0], callee):
                    if not may[ck] <= may[k]:
                        may[k] |= may[ck]
                        changed = True

    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for k, s in funcs.items():
        for a, b, line in s.edges:
            edges.setdefault((a, b), (s.relpath, line, s.qualname))
        for held, callee, line in s.calls:
            for ck in resolve(k[0], callee):
                for b in may[ck]:
                    for a in held:
                        if a != b:
                            edges.setdefault(
                                (a, b),
                                (s.relpath, line,
                                 f"{s.qualname} -> {callee.lstrip('~')}"))
    return edges, reentrant


def _cycles(edges: Dict[Tuple[str, str], Tuple[str, int, str]]
            ) -> List[List[str]]:
    """Elementary cycles via SCC + shortest closing path; one cycle
    reported per strongly connected component (enough to fail the gate
    and name the locks involved)."""
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())

    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan (recursion depth is unbounded on big graphs)
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return sccs


def check_lock_order(modules: Iterable[Module],
                     scope_filter: bool = True) -> List[Finding]:
    in_scope = [m for m in modules
                if not scope_filter
                or m.relpath.startswith(_SCOPE_PREFIXES)
                or not m.relpath.startswith("deeplearning4j_tpu_torch/")]
    if not in_scope:
        return []
    edges, reentrant = build_graph(in_scope)
    out: List[Finding] = []
    for (a, b), (relpath, line, fn) in sorted(edges.items()):
        if a == b and not reentrant.get(a, False):
            out.append(Finding(
                "DL105", relpath, line,
                f"non-reentrant lock {_short(a)} acquired while already "
                f"held in {fn} — guaranteed self-deadlock"))
    for comp in _cycles(edges):
        witnesses = []
        for a, b in sorted(edges):
            if a in comp and b in comp and a != b:
                relpath, line, fn = edges[(a, b)]
                witnesses.append(
                    f"{_short(a)} -> {_short(b)} at {relpath}:{line} "
                    f"({fn})")
        relpath, line, _ = edges[next(
            (a, b) for a, b in sorted(edges)
            if a in comp and b in comp and a != b)]
        out.append(Finding(
            "DL105", relpath, line,
            "lock-order cycle between {" + ", ".join(
                _short(c) for c in comp) + "}: opposite-order "
            "acquisitions can deadlock under the right interleaving; "
            "witnesses: " + "; ".join(witnesses)))
    return out


def _short(node: str) -> str:
    return node.split("::", 1)[-1]
