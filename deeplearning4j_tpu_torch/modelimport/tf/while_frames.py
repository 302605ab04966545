"""TF1 while-loop frame conversion: Enter/Merge/Switch/Exit cycles ->
one `while_loop` node with SubGraph cond/body.

Counterpart of ``deeplearning4j_tpu/modelimport/tf/while_frames.py``,
over the port's ``autodiff/subgraph.py``. Reference: the session
interpreter executes these frames directly with FrameIter bookkeeping
(`InferenceSession.java:828`); the importer instead *recognizes* each
frame statically and lowers it to the registered `while_loop` op — the
frame ops disappear into one loop node whose cond and body are
SubGraphs on the import's device.

Frame anatomy (per TF control-flow spec, one frame per while):
  Enter_i(init_i) -> Merge_i(Enter_i, NextIteration_i) ->
  cond nodes -> LoopCond -> Switch_i(Merge_i, LoopCond)
  Switch_i:1 -> body nodes -> NextIteration_i        (loop taken)
  Switch_i:0 -> Exit_i                               (loop done)
Nested frames lower innermost-first: each planned frame is replaced in the
graph by a synthetic `_TF1WhileFrame` node, so an outer frame's body simply
contains an already-lowered inner `while_loop` (arbitrary nesting depth,
matching the reference interpreter's FrameIter stack semantics).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ...autodiff.samediff import SameDiff
from ...autodiff.subgraph import SubGraph
from ...ops.registry import OpRegistry
from ..ir import IRGraph, IRNode, ImportContext, ImportException, get_mapper


def find_frames(nodes: List[IRNode]) -> Dict[str, List[IRNode]]:
    """frame_name -> Enter nodes."""
    frames: Dict[str, List[IRNode]] = {}
    for n in nodes:
        if n.op_type == "Enter":
            fname = n.attrs.get("frame_name")
            fname = fname if isinstance(fname, str) else str(fname)
            frames.setdefault(fname, []).append(n)
    return frames


class WhileFrame:
    """One recognized while frame + its structural nodes."""

    def __init__(self, frame_name: str, nodes: List[IRNode]):
        self.frame_name = frame_name
        by_out = {o: n for n in nodes for o in n.outputs}
        all_enters = [n for n in nodes if n.op_type == "Enter" and
                      str(n.attrs.get("frame_name")) == frame_name]
        enter_outs = {n.outputs[0] for n in all_enters}
        # loop-variable Enters feed a Merge; is_constant Enters carry
        # loop-invariant captures and stay in the outer graph (identity)
        self.merges = [n for n in nodes if n.op_type == "Merge" and
                       any(i in enter_outs for i in n.inputs)]
        self.enters = []
        for m in self.merges:
            e = next(by_out[i] for i in m.inputs if i in enter_outs)
            self.enters.append(e)
        merge_outs = {m.outputs[0] for m in self.merges}
        self.loop_conds = [n for n in nodes if n.op_type == "LoopCond" and
                           self._feeds_from(n, merge_outs, by_out)]
        if len(self.loop_conds) != 1:
            raise ImportException(
                f"while frame {frame_name!r}: expected 1 LoopCond, found "
                f"{len(self.loop_conds)} (nested/irregular frames are not "
                f"supported)")
        self.loop_cond = self.loop_conds[0]
        lc_out = self.loop_cond.outputs[0]
        self.switches = [n for n in nodes if n.op_type == "Switch" and
                         lc_out in n.inputs]
        # map each switch to its loop-var index via its Merge input
        merge_idx = {m.outputs[0]: i for i, m in enumerate(self.merges)}
        self.switch_for_var: Dict[int, IRNode] = {}
        for s in self.switches:
            for i in s.inputs:
                if i in merge_idx:
                    self.switch_for_var[merge_idx[i]] = s
        switch_names = {s.name for s in self.switches}
        self.exits = {}
        self.next_iters = {}
        for n in nodes:
            if n.op_type == "Exit":
                src = n.inputs[0].split(":")[0]
                if src in switch_names:
                    idx = next(i for i, s in self.switch_for_var.items()
                               if s.name == src)
                    self.exits[idx] = n
            if n.op_type == "NextIteration":
                for m_i, m in enumerate(self.merges):
                    if n.outputs[0] in m.inputs:
                        self.next_iters[m_i] = n
        self.structural = ({n.name for n in self.enters} |
                          {n.name for n in self.merges} |
                          {self.loop_cond.name} | switch_names |
                          {n.name for n in self.exits.values()} |
                          {n.name for n in self.next_iters.values()})

    @staticmethod
    def _feeds_from(node, sources, by_out):
        """Backward reachability within the frame: memoized, and stops at
        Enter nodes (frame boundaries) so sibling loops upstream don't
        alias into this frame."""
        seen = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if n.name in seen:
                continue
            seen.add(n.name)
            for i in n.inputs:
                if i in sources:
                    return True
                prod = by_out.get(i)
                if prod is not None and prod.op_type != "Enter":
                    stack.append(prod)
        return False

    def n_vars(self) -> int:
        return len(self.merges)


def _interior(frame: WhileFrame, nodes: List[IRNode],
              start_tensors, stop_names) -> List[IRNode]:
    """Nodes forward-reachable from start_tensors up to (exclusive) the
    structural stop set, in original order."""
    by_out = {o: n for n in nodes for o in n.outputs}
    consumers: Dict[str, List[IRNode]] = {}
    for n in nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)
    seen = set()
    work = list(start_tensors)
    while work:
        t = work.pop()
        for n in consumers.get(t, []):
            if n.name in stop_names or n.name in seen:
                continue
            seen.add(n.name)
            work.extend(n.outputs)
    return [n for n in nodes if n.name in seen]


def _build_subgraph(graph: IRGraph, interior: List[IRNode],
                    var_aliases: Dict[str, int], n_vars: int,
                    out_tensors: List[str], prefix: str,
                    plans: List["FramePlan"] = (), device="cuda"
                    ) -> Tuple[SubGraph, List[str]]:
    """Map interior TF nodes into a SubGraph whose placeholders are the
    loop variables; external tensors become captured names. `plans` holds
    already-lowered inner frames (`_TF1WhileFrame` interior nodes)."""
    sub_sd = SameDiff.create(device=device)
    ctx = ImportContext(
        IRGraph(framework="tensorflow", nodes=interior,
                initializers=graph.initializers, inputs={}, outputs=[]),
        sub_sd)
    phs = [sub_sd.placeholder(f"{prefix}{i}") for i in range(n_vars)]
    for tensor, idx in var_aliases.items():
        ctx.bind(tensor, phs[idx])

    produced = {o for n in interior for o in n.outputs} | set(var_aliases)
    captured: List[str] = []
    # interior inputs AND requested outputs may live outside the frame
    # (e.g. a loop var whose update is a loop-invariant outer expression)
    for t in [i for n in interior for i in n.inputs] + list(out_tensors):
        if t not in produced and t not in graph.initializers and \
                t not in captured:
            captured.append(t)
    # captured outer tensors appear as extra placeholders named verbatim
    for c in captured:
        ctx.bind(c, sub_sd.placeholder(c.replace(":", "_")))

    # graph-rewriting (nested frames) can leave interior out of order
    from .importer import _toposort
    for node in _toposort(interior, set(var_aliases) | set(captured)):
        if node.op_type == "_TF1WhileFrame":
            plans[node.attrs["plan"]].emit(ctx)
            continue
        rule = get_mapper("tensorflow", node.op_type)
        if rule is None:
            raise ImportException(
                f"no mapping rule for {node.op_type!r} inside while frame")
        rule(node, ctx)

    reg = OpRegistry.get()
    sg_nodes = []
    for name in sub_sd._op_order:
        op_node = sub_sd._ops[name]
        if not reg.has(op_node.op_name):
            raise ImportException(
                f"unserializable op {op_node.op_name!r} in while frame")
        sg_nodes.append({"name": op_node.name, "op": op_node.op_name,
                         "inputs": op_node.inputs,
                         "outputs": op_node.outputs,
                         "kwargs": op_node.kwargs})
    outs = [ctx.get(t).name for t in out_tensors]
    # loop-var placeholders are positional; captures ride the while_loop
    # op's capture mechanism (values appended after the loop vars)
    sg = SubGraph(placeholders=[p.name for p in phs], outputs=outs,
                  nodes=sg_nodes, constants=dict(sub_sd._arrays),
                  captured=[c.replace(":", "_") for c in captured])
    return sg, captured


class _NestedFrame(Exception):
    """Raised when a frame's interior still contains another (un-lowered)
    frame — plan_frames defers it until the inner frame is rewritten."""


class FramePlan:
    """Pre-built lowering of one while frame (SubGraphs are static — only
    the init/capture VALUES need the outer import context)."""

    _STRUCTURAL_OPS = ("Enter", "Merge", "Switch", "Exit", "NextIteration",
                       "LoopCond")

    def __init__(self, graph: IRGraph, frame: WhileFrame,
                 plans: List["FramePlan"] = (), device="cuda"):
        n = frame.n_vars()
        nodes = graph.nodes

        merge_alias = {m.outputs[0]: i for i, m in enumerate(frame.merges)}
        cond_stop = frame.structural
        cond_interior = _interior(frame, nodes, list(merge_alias), cond_stop)

        body_alias = dict(merge_alias)
        for idx, s in frame.switch_for_var.items():
            body_alias[f"{s.name}:1"] = idx
        body_interior = _interior(frame, nodes, list(body_alias), cond_stop)

        for node in cond_interior + body_interior:
            if node.op_type in self._STRUCTURAL_OPS and \
                    node.name not in frame.structural:
                # an is_constant Enter of an ALREADY-lowered inner frame is
                # a plain identity pass-through (the Enter mapper handles
                # it); a live inner frame also exposes Merge/LoopCond here
                # and still defers
                if node.op_type == "Enter":
                    continue
                raise _NestedFrame(frame.frame_name)

        self.cond_sg, cond_caps = _build_subgraph(
            graph, cond_interior, merge_alias, n,
            [frame.loop_cond.inputs[0]], "c", plans, device)

        body_outs = []
        for i in range(n):
            t = frame.next_iters[i].inputs[0] if i in frame.next_iters \
                else frame.merges[i].outputs[0]  # un-advanced var
            body_outs.append(t)
        self.body_sg, body_caps = _build_subgraph(
            graph, body_interior, body_alias, n, body_outs, "b", plans,
            device)

        self.cap_union: List[str] = []
        for c in cond_caps + body_caps:
            if c not in self.cap_union:
                self.cap_union.append(c)
        self.cap_names = [c.replace(":", "_") for c in self.cap_union]
        self.n = n
        self.init_tensors = [e.inputs[0] for e in frame.enters]
        self.exit_binds = {i: x.outputs[0] for i, x in frame.exits.items()}
        self.consumed = (frame.structural |
                         {x.name for x in cond_interior} |
                         {x.name for x in body_interior})
        self.out_tensors = [self.exit_binds[i]
                            for i in sorted(self.exit_binds)]

    def emit(self, ctx: ImportContext):
        init_vars = [ctx.get(t) for t in self.init_tensors]
        cap_vars = [ctx.get(c) for c in self.cap_union]
        outs = ctx.sd._record("while_loop", init_vars + cap_vars,
                              n_outputs=self.n, cond_graph=self.cond_sg,
                              body_graph=self.body_sg, n_loop_vars=self.n,
                              cap_names=self.cap_names)
        if self.n == 1:
            outs = (outs,)
        for i, tensor in self.exit_binds.items():
            ctx.bind(tensor, outs[i])


def plan_frames(graph: IRGraph, device="cuda"
                ) -> Tuple[List[FramePlan], IRGraph]:
    """Recognize and pre-lower every while frame, innermost-first.

    Each planned frame's nodes are replaced by one synthetic
    `_TF1WhileFrame` node, so outer frames see inner loops as ordinary
    single nodes (arbitrary nesting). Returns (plans, rewritten graph);
    the synthetic node's attrs["plan"] indexes into plans.
    """
    plans: List[FramePlan] = []
    while True:
        pending = find_frames(graph.nodes)
        # a lowered frame leaves its is_constant (loop-invariant) Enters
        # behind as identity pass-throughs — only frames that still have a
        # Merge-fed loop variable remain to be planned
        merges_in = {i for n in graph.nodes if n.op_type == "Merge"
                     for i in n.inputs}
        pending = {f: ens for f, ens in pending.items()
                   if any(e.outputs[0] in merges_in for e in ens)}
        if not pending:
            return plans, graph
        progressed = False
        for fname in list(pending):
            try:
                plan = FramePlan(graph, WhileFrame(fname, graph.nodes),
                                 plans, device)
            except _NestedFrame:
                continue  # an inner frame must lower first
            idx = len(plans)
            plans.append(plan)
            kept = [n for n in graph.nodes if n.name not in plan.consumed]
            kept.append(IRNode(
                name=f"__while_frame_{idx}", op_type="_TF1WhileFrame",
                inputs=list(plan.init_tensors) + list(plan.cap_union),
                outputs=list(plan.out_tensors), attrs={"plan": idx}))
            graph = IRGraph(framework=graph.framework, nodes=kept,
                            initializers=graph.initializers,
                            inputs=graph.inputs, outputs=graph.outputs)
            progressed = True
        if not progressed:
            raise ImportException(
                f"could not lower while frames {sorted(pending)} — "
                f"mutually nested or irregular frame structure")
