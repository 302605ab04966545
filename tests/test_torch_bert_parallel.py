"""The port's BERT on a mesh against its own single-process step and the
JAX package's sharded step, on the same bridged weights.

Tiny BERT (vocab 1024, hidden 64, 2 layers, 4 heads of 16), f32, with
``wq``/``wk`` scaled by 10 so attention is far from uniform, a batch
with padded keys (``np.random.RandomState``). The mesh steps run on 8
gloo ranks: dp2 x tp2 x sp2 with the flash ring (``use_flash=True``:
its plain flash version per block on CPU tensors), dp2 x fsdp2 x tp2
without sequence parallelism, and the QA step over dp2 x fsdp2 x tp2.
The JAX reference is ``make_train_step(mesh, seq_parallel=True)`` over
the same mesh shape on 8 virtual CPU devices (its XLA ring).

Tolerances, each with its reason:
- against the port's single-process step: the same f32 ops, with the
  tensor-parallel sums and the ring's merge taken in another order;
  losses atol 1e-5, params after 2 Adam steps (lr 1e-3) atol 1e-5;
- against JAX: the BERT tests' f32 tolerances, losses atol 1e-4 and
  params atol 0.1 * lr;
- the QA step: the head's bias has a gradient that is exactly 0 in exact
  arithmetic, so rounding noise moves it by up to lr a step: QA params
  atol 2 * steps * lr, as in the BERT tests.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.models import bert as jb

from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
from deeplearning4j_tpu_torch.models import _optim
from deeplearning4j_tpu_torch.models import bert as tb

from torch_parallel_cases import Ranks

B, T = 4, 32
LR, STEPS = 1e-3, 2


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(8)
    yield r
    r.close()


def jax_config():
    c = jb.BertConfig.tiny()
    c.dtype = jnp.float32
    return c


def jax_params(seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jb.init_params(jax.random.key(seed), jax_config()))
    for layer in tree["layers"]:
        for k in ("wq", "wk"):
            layer["attn"][k] = layer["attn"][k] * 10
    return tree


def mlm_batch(seed):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, T), np.int32)
    mask[1, 20:] = 0
    mask[3, 9:] = 0
    labels = np.where(rs.rand(B, T) < 0.3, rs.randint(0, 1024, (B, T)),
                      -100).astype(np.int32)
    labels[0, 0] = 5
    return {"input_ids": rs.randint(0, 1024, (B, T)).astype(np.int32),
            "token_type_ids": (rs.rand(B, T) < 0.5).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def leaves(tree):
    return [np.asarray(a, np.float32)
            for a in jax.tree_util.tree_leaves(tree)]


def assert_trees(got, want, atol):
    for g, w in zip(_optim.tree_leaves(got), leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32), w, atol=atol,
                                   rtol=0)


@pytest.fixture(scope="module")
def sharded_run(ranks):
    params, batch = jax_params(), mlm_batch(1)
    out = ranks.run("bert_step", params, batch,
                    {"data": 2, "tensor": 2, "seq": 2}, True, STEPS, LR,
                    "float32")[0]
    return params, batch, out


def test_dp_tp_sp_flash_step_matches_single_process(sharded_run):
    _, _, (got, want, p_got, p_want) = sharded_run
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert_trees(p_got, p_want, 1e-5)


def test_dp_tp_sp_flash_step_matches_jax_sharded_step(sharded_run):
    params, batch, (got, _, p_got, _) = sharded_run
    jc = jax_config()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=2, tensor=2, seq=2))
    jp = jb.place_params(jax.tree_util.tree_map(jnp.asarray, params), jc,
                         mesh)
    opt = jb.init_opt_state(jp)
    step = jb.make_train_step(jc, mesh, learning_rate=LR,
                              seq_parallel=True, remat=False)
    jb_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for it in range(STEPS):
        jp, opt, loss = step(jp, opt, jb_batch, it)
        losses.append(float(loss))
    np.testing.assert_allclose(got, losses, atol=1e-4, rtol=0)
    assert_trees(p_got, jax.tree_util.tree_map(np.asarray, jp), 0.1 * LR)


def test_dp_fsdp_tp_step_matches_single_process(ranks):
    out = ranks.run("bert_step", jax_params(2), mlm_batch(3),
                    {"data": 2, "fsdp": 2, "tensor": 2}, False, STEPS, LR,
                    "float32")[0]
    got, want, p_got, p_want = out
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert_trees(p_got, p_want, 1e-5)


def test_qa_step_on_a_mesh_matches_single_process_and_jax(ranks):
    jc = jax_config()
    qa = jax.tree_util.tree_map(np.asarray,
                                jb.init_qa_params(jax.random.key(1), jc))
    all_np = {"bert": jax_params(4), "qa": qa}
    rs = np.random.RandomState(5)
    batch = {k: v for k, v in mlm_batch(6).items() if k != "labels"}
    batch["start_positions"] = rs.randint(0, 20, B).astype(np.int32)
    batch["end_positions"] = rs.randint(0, 20, B).astype(np.int32)
    got, want, p_got, p_want = ranks.run(
        "bert_qa_step", all_np, batch, {"data": 2, "fsdp": 2, "tensor": 2},
        STEPS, LR)[0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert_trees(p_got, p_want, 2 * STEPS * LR)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=2, fsdp=2, tensor=2))
    step = jb.make_qa_train_step(jc, mesh, learning_rate=LR)
    jp = jax.tree_util.tree_map(jnp.asarray, all_np)
    opt = jb.init_opt_state(jp)
    losses = []
    for it in range(STEPS):
        jp, opt, loss = step(jp, opt, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, it)
        losses.append(float(loss))
    np.testing.assert_allclose(got, losses, atol=1e-4, rtol=0)
    assert_trees(p_got, jax.tree_util.tree_map(np.asarray, jp),
                 2 * STEPS * LR)


def test_mesh_that_is_not_a_port_mesh_raises():
    c = tb.BertConfig.tiny()
    c.dtype = torch.float32
    p = tb.init_params(c, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: tb.encode(p, ids, config=c, mesh=object()),
                 lambda: tb.make_train_step(c, object()),
                 lambda: tb.make_qa_train_step(c, object()),
                 lambda: tb.place_params(p, c, object()),
                 lambda: tb.make_pipeline_train_step(c, object(), 2)):
        with pytest.raises(TypeError, match="common.mesh.Mesh"):
            call()


def test_one_rank_mesh_step_equals_the_plain_step():
    """A mesh of one rank with no process group: placement is the
    identity and the step the single-process step."""
    c = tb.BertConfig.tiny()
    c.dtype = torch.float32
    mesh = make_mesh(MeshConfig(), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in mlm_batch(7).items()}
    p1 = tb.init_params(c, seed=3, device="cpu")
    p2 = tb.place_params(tb.init_params(c, seed=3, device="cpu"), c, mesh)
    s1 = tb.make_train_step(c, learning_rate=LR, remat=False)
    s2 = tb.make_train_step(c, mesh, learning_rate=LR, seq_parallel=True)
    o1, o2 = tb.init_opt_state(p1), tb.init_opt_state(p2)
    for it in range(2):
        l1 = s1(p1, o1, batch, it)[2]
        l2 = s2(p2, o2, batch, it)[2]
        assert float(l1) == pytest.approx(float(l2), abs=1e-6)
