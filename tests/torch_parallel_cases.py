"""Rank-side cases of the port's parallel tests.

Each function runs on every rank of a ``launch.RankPool`` (gloo on the
CPU) with the same arguments, builds what it needs from numpy inputs
and returns numpy results (rank 0's, or every rank's where the test
reads them all). This module imports torch and the port only, never
JAX: the rank processes must not start a JAX runtime.
"""
from __future__ import annotations

import copy

import torch

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common.mesh import (MeshConfig, gather,
                                                   gather_tree, global_rank,
                                                   make_mesh, place)
from deeplearning4j_tpu_torch.models import _optim
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.parallel import collectives as C

ALL = ("data", "fsdp", "tensor", "seq", "pipe")


def _np(t):
    return t.detach().float().cpu().numpy()


def _tree_np(tree):
    return _optim.tree_unflatten(tree, [_np(t) for t in
                                        _optim.tree_leaves(tree)])


def _mesh(world, **axes):
    return make_mesh(MeshConfig(**axes), devices=range(world), device="cpu")


# -- mesh and collectives -------------------------------------------------------

def mesh_layout(axes):
    """This rank's coordinates and the ranks of a few groups."""
    m = _mesh(4, **axes)
    return {"coords": m.coords(), "data": m.group_ranks("data"),
            "tensor": m.group_ranks("tensor"),
            "dp": m.group_ranks(("data", "tensor")),
            "index": m.axis_index(("data", "tensor"))}


#: op -> (callable on the local shard, whether the output is replicated)
def _op(name, m):
    ax = "data"
    return {
        "psum": (lambda x: C.all_reduce_sum(x, ax, mesh=m), True),
        "pmean": (lambda x: C.all_reduce_mean(x, ax, mesh=m), True),
        "all_gather": (lambda x: C.all_gather(x, ax, gather_axis=1,
                                              mesh=m), True),
        "psum_scatter": (lambda x: C.reduce_scatter(x, ax, scatter_axis=0,
                                                    mesh=m), False),
        "ppermute": (lambda x: C.ppermute_next(x, ax, mesh=m), False),
        "all_to_all": (lambda x: C.all_to_all(x, ax, 1, 0, mesh=m), False),
        "broadcast": (lambda x: C.broadcast_from(x, ax, root=2, mesh=m),
                      True),
    }[name]


def collective(name, x, c):
    """Value and gradient of ``sum(op(x_shard) * c)``, x sharded on dim 0
    over data=4: each rank's loss is its part (a replicated output's
    cotangent split over the ranks), the gradient gathered back."""
    m = _mesh(4, data=4)
    fn, replicated = _op(name, m)
    n, i = 4, m.axis_index("data")
    w = x.shape[0] // n
    xl = torch.tensor(x[i * w:(i + 1) * w], requires_grad=True)
    out = fn(xl)
    ct = torch.tensor(c) / n if replicated else \
        torch.tensor(c[i * out.shape[0]:(i + 1) * out.shape[0]])
    (out * ct).sum().backward()
    value = out if replicated else C.all_gather_raw(out.detach(), "data", m)
    grad = C.all_gather_raw(xl.grad, "data", m)
    return _np(value), _np(grad), C.transport(m.group("data"), "cpu")


def batch_moments(x, c1, c2):
    """Mean and biased variance over dims (0, 2) of a [B, C, L] batch
    sharded on dim 0 over data=4 (``batch_moments`` inside a batch
    context), and the gradient of ``sum(mean * c1 + var * c2)`` gathered
    back (each rank's loss its quarter, as in :func:`collective`)."""
    from deeplearning4j_tpu_torch.common.mesh import (batch_context,
                                                       batch_moments as bm)
    m = _mesh(4, data=4)
    n, i = 4, m.axis_index("data")
    w = x.shape[0] // n
    xl = torch.tensor(x[i * w:(i + 1) * w], requires_grad=True)
    with batch_context(m, x.shape[0]):
        mean, var = bm(xl, (0, 2))
    ((mean * torch.tensor(c1)).sum() + (var * torch.tensor(c2)).sum()
     ).div(n).backward()
    return _np(mean), _np(var), _np(C.all_gather_raw(xl.grad, "data", m))


def zero1_layout(shapes):
    """The ZeRO-1 spec and this rank's shard shape of each leaf."""
    from deeplearning4j_tpu_torch.common.mesh import zero1_spec, zero1_place
    m = _mesh(4, data=2, fsdp=2)
    tree = [torch.zeros(s) for s in shapes]
    placed = zero1_place(m, tree)
    back = [tuple(gather(t).shape) for t in placed]
    return ([repr(zero1_spec(m, t)) for t in tree],
            [tuple(t.shape) for t in placed], back)


# -- ring attention -------------------------------------------------------------

def ring(kind, q, k, v, mask, c, causal, use_flash):
    """The global output of ``ring_attention`` (or Ulysses) over
    data=2 x seq=2 and the gradients of ``sum(out * c)`` (each rank its
    part, summed over the ranks)."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_attention, ulysses_attention)
    m = _mesh(4, data=2, seq=2)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    if kind == "ring":
        out = ring_attention(*ts, m, mask=None if mask is None
                             else torch.tensor(mask), causal=causal,
                             use_flash=use_flash)
    else:
        out = ulysses_attention(*ts, m, causal=causal)
    ((out * torch.tensor(c)).sum() / m.size).backward()
    grads = [C.all_reduce_raw(t.grad, ALL, m) for t in ts]
    return _np(out), [_np(g) for g in grads]


# -- BERT on a mesh -------------------------------------------------------------

def _bert_config(dtype):
    c = tb.BertConfig.tiny()
    c.dtype = getattr(torch, dtype)
    return c


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def bert_step(params_np, batch, axes, use_flash, n_steps, lr, dtype):
    """``n_steps`` sharded MLM steps (seq_parallel where seq > 1) and the
    port's single-process steps from the same weights: both loss
    trajectories and both final param trees (rank 0)."""
    c = _bert_config(dtype)
    m = _mesh(8, **axes)
    full = bridge.params_from_numpy(params_np, "cpu")
    ref = copy.deepcopy(full)
    ro = tb.init_opt_state(ref)
    placed = tb.place_params(full, c, m)
    po = tb.init_opt_state(placed)
    step = tb.make_train_step(c, m, learning_rate=lr,
                              seq_parallel=axes.get("seq", 1) > 1,
                              use_flash=use_flash)
    rstep = tb.make_train_step(c, learning_rate=lr, remat=False,
                               use_flash=use_flash)
    b = _torch_batch(batch)
    got, want = [], []
    for it in range(n_steps):
        got.append(float(step(placed, po, b, it)[2]))
        want.append(float(rstep(ref, ro, b, it)[2]))
    return got, want, _tree_np(gather_tree(placed)), _tree_np(ref)


def bert_qa_step(all_np, batch, axes, n_steps, lr):
    """The QA fine-tune step on a mesh and in one process (f32)."""
    c = _bert_config("float32")
    m = _mesh(8, **axes)
    full = bridge.params_from_numpy(all_np, "cpu")
    ref = copy.deepcopy(full)
    ro = tb.init_opt_state(ref)
    placed = {"bert": tb.place_params(full["bert"], c, m),
              "qa": {k: place(v, m) for k, v in full["qa"].items()}}
    po = tb.init_opt_state(placed)
    step = tb.make_qa_train_step(c, m, learning_rate=lr)
    rstep = tb.make_qa_train_step(c, learning_rate=lr)
    b = _torch_batch(batch)
    got, want = [], []
    for it in range(n_steps):
        got.append(float(step(placed, po, b, it)[2]))
        want.append(float(rstep(ref, ro, b, it)[2]))
    return got, want, _tree_np(gather_tree(placed)), _tree_np(ref)


def bert_mesh_reports(all_np, batch, qa_batch):
    """The scanned MLM step (2 steps), the QA step and the pipeline step
    on a 2-rank mesh (data, data, pipe): every step's report (each runs
    eagerly, with the mesh's backend as the reason)."""
    c = _bert_config("float32")
    m = _mesh(2, data=2)
    full = bridge.params_from_numpy(all_np, "cpu")
    placed = {"bert": tb.place_params(full["bert"], c, m),
              "qa": {k: place(v, m) for k, v in full["qa"].items()}}
    b, qb = _torch_batch(batch), _torch_batch(qa_batch)
    train = tb.make_scanned_train_step(c, 2, m, learning_rate=1e-3)
    train(placed["bert"], tb.init_opt_state(placed["bert"]), b, 0)
    qa = tb.make_qa_train_step(c, m, learning_rate=1e-3)
    qa(placed, tb.init_opt_state(placed), qb, 0)
    pm = _mesh(2, pipe=2)
    staged = tb.place_pipeline_params(tb.to_pipeline_params(
        bridge.params_from_numpy(all_np["bert"], "cpu"), 2), pm)
    pipe = tb.make_pipeline_train_step(c, pm, 2, learning_rate=1e-3)
    pipe(staged, tb.init_opt_state(staged), b, 0)
    return [r for s in (train, qa, pipe) for r in s.graphs.report()]


# -- pipelines ------------------------------------------------------------------------

def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _head_fn(hp, y, aux):
    err = (y @ hp["v"] - aux["t"]) ** 2
    return (err.sum(-1) * aux["wt"]).sum(), aux["wt"].sum()


def pipe_apply(ws, bs, x, n_micro):
    """``pipeline_apply`` over data=2 x pipe=2 (ranks 0-3)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import pipeline_apply
    # every rank builds the mesh (its groups); ranks 4-7 do not use it
    m = make_mesh(MeshConfig(data=2, pipe=2), devices=range(4),
                  device="cpu")
    if global_rank() >= 4:
        return None
    s = m.axis_index("pipe")
    stacked = {"w": torch.tensor(ws[s:s + 1]), "b": torch.tensor(bs[s:s + 1])}
    return _np(pipeline_apply(_stage_fn, stacked, torch.tensor(x), m,
                              n_micro))


def pipe_loss(schedule, ws, bs, v, x, t, wt, n_micro):
    """(loss sum, weight) and the gradients of ``loss_sum / weight`` in
    the stage params (gathered over pipe), head params and x."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        make_pipeline_loss, make_pipeline_loss_1f1b)
    m = make_mesh(MeshConfig(data=2, pipe=2), devices=range(4),
                  device="cpu")
    if global_rank() >= 4:
        return None
    s = m.axis_index("pipe")
    sp = {"w": torch.tensor(ws[s:s + 1], requires_grad=True),
          "b": torch.tensor(bs[s:s + 1], requires_grad=True)}
    hp = {"v": torch.tensor(v, requires_grad=True)}
    xx = torch.tensor(x, requires_grad=True)
    make = make_pipeline_loss_1f1b if schedule == "1f1b" \
        else make_pipeline_loss
    loss = make(_stage_fn, _head_fn, m, n_micro)
    ls, w = loss(sp, hp, xx, {"t": torch.tensor(t),
                              "wt": torch.tensor(wt)})
    (ls / w).backward()
    gw = C.all_gather_raw(sp["w"].grad, "pipe", m)
    gb = C.all_gather_raw(sp["b"].grad, "pipe", m)
    return (float(ls), float(w), _np(gw), _np(gb), _np(hp["v"].grad),
            _np(xx.grad))


def bert_pipe_step(params_np, batch, axes, n_micro, schedule, tp, lr,
                   n_steps):
    """The BERT pipeline step (dp x [tp x] pp) and the single-process
    step from the same weights: losses and final params (rank 0)."""
    c = _bert_config("float32")
    m = _mesh(8, **axes)
    full = bridge.params_from_numpy(params_np, "cpu")
    ref = copy.deepcopy(full)
    ro = tb.init_opt_state(ref)
    placed = tb.place_pipeline_params(
        tb.to_pipeline_params(full, axes["pipe"]), m, tensor_parallel=tp)
    po = tb.init_opt_state(placed)
    step = tb.make_pipeline_train_step(c, m, n_micro, learning_rate=lr,
                                       schedule=schedule,
                                       tensor_parallel=tp)
    rstep = tb.make_train_step(c, learning_rate=lr, remat=False)
    b = _torch_batch(batch)
    got, want = [], []
    for it in range(n_steps):
        got.append(float(step(placed, po, b, it)[2]))
        want.append(float(rstep(ref, ro, b, it)[2]))
    back = tb.from_pipeline_params(gather_tree(placed))
    return got, want, _tree_np(back), _tree_np(ref)


# -- the layer API ---------------------------------------------------------------

def _mln(conf_json, params_np):
    from deeplearning4j_tpu_torch.nn.conf.config import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = MultiLayerConfiguration.from_json(conf_json)
    return bridge.load_multilayer(MultiLayerNetwork(conf, device="cpu"),
                                  params_np)


def _datasets(xs, ys):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(x, y) for x, y in zip(xs, ys)]


def _net_np(net):
    return [{k: _np(v) for k, v in p.items()}
            for p in net._full_params(net._params)]


def parallel_wrapper(conf_json, params_np, xs, ys, zero1, axes):
    """ParallelWrapper.fit over ``axes`` and the single-process fit from
    the same weights: both param trees (running stats included), both
    updater states and the scores."""
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
    m = _mesh(4, **axes)
    net = _mln(conf_json, params_np)
    ref = _mln(conf_json, params_np)
    ParallelWrapper(net, m, prefetch_buffer=0, zero1=zero1).fit(
        _datasets(xs, ys))
    ref.fit(_datasets(xs, ys))
    us = _optim.tree_leaves(net._updater_state)
    ur = _optim.tree_leaves(ref._updater_state)
    return (_net_np(net), _net_np(ref), [_np(a) for a in us],
            [_np(a) for a in ur], net.score_value, ref.score_value)


def distribute_mln(conf_json, params_np, xs, ys, axes):
    """``distribute`` + ``fit`` against the single-process fit; the
    output and score after, and the stored shard shapes."""
    m = _mesh(4, **axes)
    net = _mln(conf_json, params_np).distribute(m)
    ref = _mln(conf_json, params_np)
    shapes = [tuple(v.shape) for p in net._params for v in p.values()]
    net.fit(_datasets(xs, ys))
    ref.fit(_datasets(xs, ys))
    return (_net_np(net), _net_np(ref), net.output(xs[0]).numpy(),
            ref.output(xs[0]).numpy(), shapes)


def mesh_fit_report(conf_json, xs, ys):
    """``fit`` of a distributed network and a ``ParallelWrapper`` fit on
    a 2-rank data mesh: the network's training-step report (every step
    eager, with the mesh's backend as the reason)."""
    from deeplearning4j_tpu_torch.nn.conf.config import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
    m = _mesh(2, data=2)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                            device="cpu").init().distribute(m)
    net.fit(_datasets(xs, ys))
    ParallelWrapper(net, m, prefetch_buffer=0).fit(_datasets(xs, ys))
    return net.train_graphs_report()


def distribute_graph(conf_json, params_np, xs, ys, axes):
    """The same for a ComputationGraph."""
    from deeplearning4j_tpu_torch.nn.graph.computation_graph import (
        ComputationGraph, ComputationGraphConfiguration)
    conf = ComputationGraphConfiguration.from_json(conf_json)

    def make():
        return bridge.load_graph(ComputationGraph(conf, device="cpu"),
                                 params_np)
    m = _mesh(4, **axes)
    net = make().distribute(m)
    ref = make()
    net.fit(_datasets(xs, ys))
    ref.fit(_datasets(xs, ys))

    def np_tree(n):
        return {k: {kk: _np(vv) for kk, vv in p.items()}
                for k, p in n._full_params(n._params).items()}
    return (np_tree(net), np_tree(ref), net.output(xs[0])[0].numpy(),
            ref.output(xs[0])[0].numpy())


def parallel_inference(conf_json, params_np, x):
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelInference
    m = _mesh(4, data=4)
    net = _mln(conf_json, params_np)
    return (ParallelInference(net, m).output(x).numpy(),
            net.output(x).numpy())


def save_restore(directory, params_np, save_axes, load_axes, seed):
    """Save placed BERT params and Adam state on one mesh; restore onto
    another mesh (``load_axes``; None: no mesh, rank 0 only) and gather."""
    from deeplearning4j_tpu_torch.nn.checkpoint import ShardedCheckpointer
    c = _bert_config("float32")
    full = bridge.params_from_numpy(params_np, "cpu")
    m = _mesh(4, **save_axes)
    placed = tb.place_params(full, c, m)
    opt = tb.init_opt_state(placed)
    for u in opt[0]:
        u.add_(1.5)
    ck = ShardedCheckpointer(directory)
    ck.save_tree(seed, {"params": placed, "opt": opt, "note": "x"})
    fresh = tb.init_params(c, seed=seed + 1, device="cpu")
    if load_axes is None:
        if global_rank() != 0:
            return None
        target = {"params": fresh, "opt": tb.init_opt_state(fresh)}
        state = ck.restore_tree(seed, target=target)
        return _tree_np(state["params"]), _np(state["opt"][0][0]), \
            state["note"], None
    m2 = _mesh(4, **load_axes)
    tp = tb.place_params(fresh, c, m2)
    target = {"params": tp, "opt": tb.init_opt_state(tp)}
    state = ck.restore_tree(seed, target=target)
    local = [tuple(t.shape) for t in _optim.tree_leaves(state["params"])]
    return (_tree_np(gather_tree(state["params"])),
            _np(gather(state["opt"][0][0])), state["note"], local)


def fault_tolerant(directory, conf_json, params_np, xs, ys, fail_at):
    """FaultTolerantTrainer over 3 epochs with a failure injected at
    epoch ``fail_at``: the mesh rebuilt (tensor=3 does not divide 4
    ranks, so pure data parallelism), the checkpoint restored, training
    resumed; against 3 uninterrupted epochs in one process."""
    from deeplearning4j_tpu_torch.common.faults import RetryPolicy
    from deeplearning4j_tpu_torch.parallel.fault_tolerance import (
        FaultTolerantTrainer, rebuild_mesh)
    net = _mln(conf_json, params_np)
    ref = _mln(conf_json, params_np)
    mesh = rebuild_mesh(MeshConfig(tensor=3), device="cpu")
    net.distribute(mesh)
    failed, restarts = [], []

    def fit_fn(n, epoch):
        if epoch == fail_at and not failed:
            failed.append(epoch)
            # half an epoch's damage that the restore must undo
            n.fit(_datasets(xs[:1], ys[:1]))
            raise RuntimeError("injected failure")
        n.fit(_datasets(xs, ys))

    ft = FaultTolerantTrainer(net, directory, mesh_config=MeshConfig(
        tensor=3), on_restart=lambda e, k: restarts.append(str(e)),
        retry_policy=RetryPolicy(3, base_s=0.001, max_s=0.001, seed=0))
    ft.fit(fit_fn, 3)
    for _ in range(3):
        ref.fit(_datasets(xs, ys))
    return (_net_np(net), _net_np(ref), restarts, dict(mesh.shape),
            dict(net._mesh.shape), net._epoch, net._iteration,
            ref._iteration)


# -- sharded serving ------------------------------------------------------------

def _lm(tree, cfg_kw, layers=None):
    """A port CausalLM on the CPU over a numpy params tree (the first
    ``layers`` layers: a truncated draft)."""
    from deeplearning4j_tpu_torch.models import causal_lm as tcl
    layers = len(tree["layers"]) if layers is None else layers
    cfg = tcl.CausalLMConfig(**dict(cfg_kw, num_layers=layers,
                                    dtype=torch.float32))
    return tcl.CausalLM(cfg, params=bridge.params_from_numpy(
        {"embeddings": tree["embeddings"],
         "layers": tree["layers"][:layers]}, device="cpu"), device="cpu")


def _tokens(engine, prompts, max_tokens):
    futs = [engine.generate(p, max_tokens=max_tokens) for p in prompts]
    return [f.result(timeout=120)["tokens"] for f in futs]


def sharded_decode(tree, cfg_kw, prompts, max_tokens, engine_kw,
                   draft_layers=0, quantize=False, param_spec=None,
                   model_parallel=None):
    """Greedy tokens of a sharded ``DecodeEngine`` on a serving mesh over
    every rank, and (on the leader) of the same engine unsharded, with
    each engine's KV pool bytes, the leader's all-reduces and snapshots;
    a follower reports its refusal of ``generate`` and whether the
    leader's ``close()`` ended its engine."""
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.quant import quantize_model
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    from deeplearning4j_tpu_torch.runtime.sharded import pool_bytes
    model = _lm(tree, cfg_kw)
    if quantize:
        model = quantize_model(model, device="cpu")
    kw = dict(engine_kw, device="cpu")
    if draft_layers:
        kw.update(draft_model=_lm(tree, cfg_kw, draft_layers), spec_k=2)
    mesh = serving_mesh(model_parallel, device="cpu")
    C.issued.clear()
    eng = DecodeEngine(model, mesh=mesh, param_spec=param_spec, **kw)
    out = {"pool_bytes": pool_bytes(eng._cache)}
    if not eng._link.is_leader:
        try:
            eng.generate(prompts[0], max_tokens=1)
        except RuntimeError as e:
            out["refused"] = str(e)
        out["joined"] = eng.join(60)
        return out
    out["tokens"] = _tokens(eng, prompts, max_tokens)
    out["all_reduces"] = sum(n for (op, _), n in C.issued.items()
                             if op == "all_reduce")
    out["stats"], out["snapshot"] = eng.stats(), eng.debug_snapshot()
    out["closed"] = eng.close(30)
    ref = DecodeEngine(model, **kw)
    out["ref_tokens"] = _tokens(ref, prompts, max_tokens)
    out["ref_pool_bytes"] = pool_bytes(ref._cache)
    out["ref_stats"] = ref.stats()
    ref.close(30)
    return out


def _predict_model(kind, payload):
    """(model, outputs, a request of a batch) of a tiny predict network."""
    if kind == "samediff":
        from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
        sd = SameDiff.create(device="cpu")
        x = sd.placeholder("x", (None, payload["w"].shape[0]))
        y = sd.nn.softmax(sd.nn.tanh(x @ sd.var("w", payload["w"])
                                     + sd.var("b", payload["b"])))
        return sd, [y.name], lambda a: {"x": a}
    if kind == "graph":
        from deeplearning4j_tpu_torch.nn.graph import (
            ComputationGraph, ComputationGraphConfiguration)
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            payload["conf"]), device="cpu")
        return bridge.load_graph(net, payload["params"]), None, \
            lambda a: a
    net = _mln(payload["conf"], payload["params"])
    if kind == "mlp_int8":
        from deeplearning4j_tpu_torch.quant import quantize_model
        net = quantize_model(net, device="cpu")
    return net, None, lambda a: a


def _outputs_np(out):
    if isinstance(out, dict):
        return [_np(out[k].torch()) for k in sorted(out)]
    if isinstance(out, list):
        return [_np(o.torch()) for o in out]
    return [_np(out.torch())]


def sharded_predict(kind, payload, xs, model_parallel, param_spec=None):
    """Rank 0's outputs of a sharded ``InferenceEngine`` (a serving mesh
    over every rank, ``model_parallel`` on ``model``) for each batch of
    ``xs``, its stats, and the unsharded engine's outputs."""
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    model, outputs, req = _predict_model(kind, payload)
    mesh = serving_mesh(model_parallel, device="cpu")
    eng = InferenceEngine(model, mesh=mesh, param_spec=param_spec,
                          max_batch=8, outputs=outputs)
    if not eng._link.is_leader:
        return {"joined": eng.join(60)}
    got = [_outputs_np(eng.infer(req(x))) for x in xs]
    stats = eng.stats()
    eng.close(30)
    ref = InferenceEngine(model, max_batch=8, outputs=outputs)
    want = [_outputs_np(ref.infer(req(x))) for x in xs]
    ref.close(30)
    return {"got": got, "want": want, "stats": stats}


def sharded_poison(mlp, good, bad):
    """A sharded MLP's ``submit`` of a request the model cannot run (the
    wrong feature width) on the leader, then of a good one: the bad one
    fails on both ranks and is quarantined, and the follower goes on to
    serve the good one. Each rank also serves ``good`` on a mesh of its
    own rank alone, which has no step link."""
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.runtime.inference import (
        InferenceEngine, PoisonRequestError)
    net = _mln(*mlp)
    plain = InferenceEngine(net, max_batch=4)
    want = _np(plain.infer(good).torch())
    plain.close(30)
    solo = InferenceEngine(net, max_batch=4, mesh=serving_mesh(
        devices=[global_rank()], device="cpu"))
    out = {"solo_link": solo._link is not None,
           "solo_err": float(abs(_np(solo.infer(good).torch())
                                 - want).max())}
    solo.close(30)
    eng = InferenceEngine(net, mesh=serving_mesh(device="cpu"), max_batch=4)
    if global_rank() != 0:
        out["joined"] = eng.join(60)
        return out
    try:
        eng.submit(bad).result(timeout=60)
        out["bad"] = "answered"
    except PoisonRequestError as e:
        out["bad"] = "quarantined: " + str(e)
    out["good_err"] = float(abs(_np(eng.submit(good).result(timeout=60)
                                    .torch()) - want).max())
    out["closed"] = eng.close(30)
    return out


def sharded_concurrent(tree, cfg_kw, prompts, mlp, xs):
    """A sharded DecodeEngine and a sharded InferenceEngine on one mesh,
    driven at once on the leader: every prompt's generate and, from 8
    threads (the switch interval shortened), every batch's infer. The
    records of both engines share one channel, so every step keeps its
    place on both ranks; the results are the unsharded engines'."""
    import sys
    import threading
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    mesh = serving_mesh(device="cpu")
    kw = dict(slots=2, max_ctx=64, prompt_buckets=[16], device="cpu")
    lm, net = _lm(tree, cfg_kw), _mln(*mlp)
    dec = DecodeEngine(lm, mesh=mesh, **kw)
    inf = InferenceEngine(net, mesh=mesh, max_batch=8)
    if global_rank() != 0:
        return {"joined": dec.join(60) and inf.join(60)}
    got = {}
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        futs = [dec.generate(p, max_tokens=6) for p in prompts]

        def predict(i):
            got[i] = _np(inf.infer(xs[i]).torch())
        threads = [threading.Thread(target=predict, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        tokens = [f.result(timeout=60)["tokens"] for f in futs]
        alive = any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    dec.close(30)
    inf.close(30)
    ref = DecodeEngine(lm, **kw)
    want = [ref.generate(p, max_tokens=6).result(timeout=60)["tokens"]
            for p in prompts]
    ref.close(30)
    plain = InferenceEngine(net, max_batch=8)
    out = {"threads_alive": alive, "tokens": tokens, "ref_tokens": want,
           "predict_max_err": max(
               float(abs(got[i] - _np(plain.infer(x).torch())).max())
               for i, x in enumerate(xs))}
    plain.close(30)
    return out


def sharded_registry(tree, cfg_kw, prompt, mlp, x):
    """A sharded CausalLM and a sharded MLP deployed on every rank beside
    an unsharded MLP; the leader serves them over HTTP: ``/v1/models``,
    a greedy ``generate`` and ``/debug/decode``."""
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    mesh = serving_mesh(device="cpu")
    reg = ModelRegistry(manifest_dir=None)
    reg.deploy("lm", "v1", _lm(tree, cfg_kw), mesh=mesh, decode_slots=2,
               decode_max_ctx=64, decode_prompt_buckets=[16])
    reg.deploy("toy", "v1", _mln(*mlp), example=x, max_batch=4, mesh=mesh)
    reg.deploy("plain", "v1", _mln(*mlp), example=x, max_batch=4)
    out = {}
    if global_rank() == 0:
        srv = ModelServer(reg)
        port = srv.start()
        base = f"http://127.0.0.1:{port}"

        def get(path, body=None):
            r = urllib.request.Request(
                base + path, data=None if body is None
                else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=60) as f:
                return json.loads(f.read())
        try:
            out["models"] = get("/v1/models")
            out["generated"] = get("/v1/models/lm/generate",
                                   {"prompt": prompt, "max_tokens": 6})
            out["predicted"] = get("/v1/models/toy/predict",
                                   {"inputs": x.tolist()})
            out["decode"] = get("/debug/decode")
            out["toy_stats"] = reg.get("toy").engine.stats()
            out["plain_stats"] = reg.get("plain").engine.stats()
        finally:
            srv.stop()
    out["drained"] = reg.drain_all(30, save_manifests=False)
    return out


# -- the parent side ----------------------------------------------------------------

class Ranks:
    """A test module's rank pool: started on first use, restarted after a
    case that failed (a failure ends a ``RankPool``)."""

    def __init__(self, world: int, timeout: float = 240.0):
        self.world, self.timeout, self.pool = world, timeout, None

    def run(self, name, *args, **kwargs):
        from deeplearning4j_tpu_torch.parallel.launch import RankPool
        if self.pool is None or self.pool.closed:
            self.pool = RankPool(self.world, "cpu", timeout=self.timeout)
        return self.pool.run(f"torch_parallel_cases:{name}", *args,
                             **kwargs)

    def close(self):
        if self.pool is not None:
            self.pool.close()
