"""The port's pipeline parallelism against sequential application, the
unpipelined step and the JAX package's pipeline losses.

A stage ``tanh(x @ w + b)`` (2 stages of width 6) and a weighted
squared-error head: ``pipeline_apply`` and the GPipe and 1F1B losses run
on ranks 0-3 of an 8-rank gloo pool as data=2 x pipe=2; the JAX
``make_pipeline_loss`` / ``make_pipeline_loss_1f1b`` over the same mesh
shape on 4 virtual CPU devices, on the same numpy inputs. The BERT
pipeline steps (dp4 x pp2 under both schedules, and dp2 x tp2 x pp2 with
Megatron TP inside the 1F1B stages) run on all 8 ranks against the
port's single-process step from the same bridged weights.

Tolerances: f32 sums over microbatches, ranks and stages in another
order; losses and values atol 1e-5, gradients atol 1e-5; BERT losses and
params after 2 Adam steps (lr 1e-3) atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu.parallel import pipeline as jpipe

from deeplearning4j_tpu_torch.models import _optim
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.parallel import pipeline as tpipe

from torch_parallel_cases import Ranks

ATOL = 1e-5
W, BATCH, N_MICRO = 6, 8, 2
LR = 1e-3


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(8)
    yield r
    r.close()


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    ws = (rs.randn(2, W, W) * 0.5).astype(np.float32)
    bs = (rs.randn(2, W) * 0.1).astype(np.float32)
    v = rs.randn(W, 3).astype(np.float32)
    x = rs.randn(BATCH, W).astype(np.float32)
    t = rs.randn(BATCH, 3).astype(np.float32)
    wt = (rs.rand(BATCH) < 0.7).astype(np.float32)
    return ws, bs, v, x, t, wt


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jhead(hp, y, aux):
    err = (y @ hp["v"] - aux["t"]) ** 2
    return jnp.sum(jnp.sum(err, -1) * aux["wt"]), jnp.sum(aux["wt"])


def unpipelined(ws, bs, v, x, t, wt):
    """loss sum, weight and the gradients of their ratio, in one
    process (torch autograd)."""
    tw, tbias, tv, tx = (torch.tensor(a, requires_grad=True)
                         for a in (ws, bs, v, x))
    y = tx
    for s in range(2):
        y = torch.tanh(y @ tw[s] + tbias[s])
    err = (y @ tv - torch.tensor(t)) ** 2
    ls = (err.sum(-1) * torch.tensor(wt)).sum()
    w = torch.tensor(wt).sum()
    (ls / w).backward()
    return (float(ls), float(w), tw.grad.numpy(), tbias.grad.numpy(),
            tv.grad.numpy(), tx.grad.numpy())


def test_pipeline_apply_matches_sequential(ranks, data):
    ws, bs, _, x, _, _ = data
    want = x
    for s in range(2):
        want = np.tanh(want @ ws[s] + bs[s])
    for out in ranks.run("pipe_apply", ws, bs, x, 4)[:4]:
        np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def jax_losses(data):
    ws, bs, v, x, t, wt = data
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=2, pipe=2),
                           devices=jax.devices()[:4])
    out = {}
    for schedule, make in (("gpipe", jpipe.make_pipeline_loss),
                           ("1f1b", jpipe.make_pipeline_loss_1f1b)):
        loss = make(_jstage, _jhead, mesh, N_MICRO)
        args = ({"w": jnp.asarray(ws), "b": jnp.asarray(bs)},
                {"v": jnp.asarray(v)}, jnp.asarray(x),
                {"t": jnp.asarray(t), "wt": jnp.asarray(wt)})
        ls, w = loss(*args)

        def ratio(sp, hp, xx):
            a, b = loss(sp, hp, xx, args[3])
            return a / b
        gs, gh, gx = jax.grad(ratio, argnums=(0, 1, 2))(*args[:3])
        out[schedule] = (float(ls), float(w), np.asarray(gs["w"]),
                         np.asarray(gs["b"]), np.asarray(gh["v"]),
                         np.asarray(gx))
    return out


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_loss_matches_unpipelined_and_jax(ranks, data, jax_losses,
                                                   schedule):
    want = unpipelined(*data)
    outs = ranks.run("pipe_loss", schedule, *data, N_MICRO)[:4]
    for got in outs:
        for g, w, j in zip(got, want, jax_losses[schedule]):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
            np.testing.assert_allclose(g, j, atol=ATOL, rtol=0)


def test_schedules_agree_with_each_other(ranks, data):
    a = ranks.run("pipe_loss", "gpipe", *data, 4)[0]
    b = ranks.run("pipe_loss", "1f1b", *data, 4)[0]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=0)


def jax_params(seed):
    c = jb.BertConfig.tiny()
    c.dtype = jnp.float32
    return jax.tree_util.tree_map(
        np.asarray, jb.init_params(jax.random.key(seed), c))


def mlm_batch(seed, rows, T=16):
    rs = np.random.RandomState(seed)
    labels = np.where(rs.rand(rows, T) < 0.3,
                      rs.randint(0, 1024, (rows, T)), -100).astype(np.int32)
    labels[0, 0] = 7
    return {"input_ids": rs.randint(0, 1024, (rows, T)).astype(np.int32),
            "labels": labels}


@pytest.mark.parametrize("axes,schedule,tp,n_micro", [
    ({"data": 4, "pipe": 2}, "1f1b", False, 2),
    ({"data": 4, "pipe": 2}, "gpipe", False, 2),
    ({"data": 2, "tensor": 2, "pipe": 2}, "1f1b", True, 2),
    ({"data": 2, "tensor": 2, "pipe": 2}, "gpipe", True, 4)],
    ids=["dp4-pp2-1f1b", "dp4-pp2-gpipe", "dp2-tp2-pp2-1f1b",
         "dp2-tp2-pp2-gpipe"])
def test_bert_pipeline_step_matches_single_process(ranks, axes, schedule,
                                                   tp, n_micro):
    rows = axes["data"] * n_micro * 2
    got, want, p_got, p_want = ranks.run(
        "bert_pipe_step", jax_params(1), mlm_batch(2, rows), axes, n_micro,
        schedule, tp, LR, 2)[0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for g, w in zip(_optim.tree_leaves(p_got), _optim.tree_leaves(p_want)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_pipeline_params_round_trip_and_match_jax():
    tree = jax_params(5)
    jpp = jax.tree_util.tree_map(np.asarray, jb.to_pipeline_params(
        jax.tree_util.tree_map(jnp.asarray, tree), 2))
    tp = tb.to_pipeline_params(
        _optim.tree_unflatten(tree, [torch.from_numpy(np.array(a)) for a in
                                     _optim.tree_leaves(tree)]), 2)
    for g, w in zip(_optim.tree_leaves(tp), jax.tree_util.tree_leaves(jpp)):
        np.testing.assert_array_equal(g.numpy(), w)
    back = tb.from_pipeline_params(tp)
    for g, w in zip(_optim.tree_leaves(back), _optim.tree_leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.split_stages([1, 2, 3], 2)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        from deeplearning4j_tpu_torch.common.mesh import (MeshConfig,
                                                           make_mesh)
        tb.make_pipeline_train_step(tb.BertConfig.tiny(),
                                    make_mesh(MeshConfig(), device="cpu"),
                                    2, schedule="zb")
