"""The port's BERT against the JAX package's, on the same weights.

Weights come from ``deeplearning4j_tpu.models.bert.init_params`` (tiny
config: vocab 1024, hidden 64, 2 layers, 4 heads of 16) and cross into
the port through ``bridge.params_from_numpy``; ``wq``/``wk`` are scaled
by 10 on both sides first, so that attention is far from uniform and the
masked keys matter. Batches come from ``np.random.RandomState``. With
``use_flash`` the JAX side runs its Pallas flash kernels through the
Pallas interpreter (``DL4J_TPU_FLASH_MIN_SEQ`` lowered so that the JAX
dispatch takes them at T=32), the port its plain flash version.

Tolerances, each with its reason:
- f32 (``dtype`` set to float32 on both sides): the same graph summed in
  another order. Logits and losses atol 1e-4 (O(1) values);
  gradients rtol 1e-3 + atol 1e-3 of the leaf's largest entry (sums over
  the batch of products, some leaves near 0).
- Adam, 3 chained steps at lr 1e-3: Adam divides each gradient by its
  own magnitude, so an element whose gradient is ~0 on both sides could
  move by up to lr per step in either direction. In the MLM steps none
  does on these batches: post-step params are held to atol
  0.1 * lr = 1e-4, the loss trajectory to atol 1e-4. The QA head's bias gets a gradient that is exactly 0 in
  exact arithmetic (a shift of every position's logit leaves the softmax
  unchanged), so its rounding noise moves it by up to lr per step:
  QA params are held to atol 2 * 3 steps * lr.
- bf16 (the default dtype): both sides round activations to bf16 at
  other places; logits are O(0.1), held to atol 2e-2 (a few bf16 ulps of
  the O(1) hidden states they come from).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common.environment import (SystemProperties,
                                                   environment)
from deeplearning4j_tpu.models import _optim as j_optim
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.bridge import params_from_numpy
from deeplearning4j_tpu_torch.models import _optim as t_optim
from deeplearning4j_tpu_torch.models import bert as tb

B, T = 2, 32
F32_ATOL = 1e-4
LR = 1e-3
N_STEPS = 3
PARAM_ATOL = 0.1 * LR


@pytest.fixture(scope="module", autouse=True)
def jax_flash_at_short_seq():
    """Let the JAX dispatch take the Pallas flash kernels at T=32."""
    env = environment()
    prev = env.property_override(SystemProperties.FLASH_MIN_SEQ)
    env.set_flash_min_seq(2)
    yield
    if prev is None:
        env.clear_property(SystemProperties.FLASH_MIN_SEQ)
    else:
        env.set_property(SystemProperties.FLASH_MIN_SEQ, prev)


def configs(dtype):
    jc, tc = jb.BertConfig.tiny(), tb.BertConfig.tiny()
    jc.dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tc.dtype = getattr(torch, dtype)
    return jc, tc


def jax_params(jc, seed=0):
    """JAX init as numpy, with wq/wk scaled by 10."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jb.init_params(jax.random.key(seed), jc))
    for layer in tree["layers"]:
        for k in ("wq", "wk"):
            layer["attn"][k] = (layer["attn"][k].astype(np.float32)
                                * 10).astype(layer["attn"][k].dtype)
    return tree


def make_batch(seed=0, vocab=1024, masked_keys=True):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, T), np.int32)
    if masked_keys:
        mask[1, 20:] = 0
    labels = np.where(rs.rand(B, T) < 0.3, rs.randint(0, vocab, (B, T)),
                      -100).astype(np.int32)
    labels[0, 0] = 5                     # at least one masked position
    return {"input_ids": rs.randint(0, vocab, (B, T)).astype(np.int32),
            "token_type_ids": (rs.rand(B, T) < 0.5).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def f32():
    jc, tc = configs("float32")
    tree = jax_params(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jc, tc, tree, jp


def fresh_port_params(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("use_flash", [False, True])
def test_encode_and_mlm_logits_f32(f32, use_flash):
    jc, tc, tree, jp = f32
    batch = make_batch(1)

    @jax.jit
    def jfwd(p, b):
        enc = jb.encode(p, b["input_ids"], b["token_type_ids"],
                        b["attention_mask"], config=jc, use_flash=use_flash)
        return enc, jb.mlm_logits(p, enc, jc)

    enc_j, logits_j = jfwd(jp, to_jax(batch))
    tp, tbt = fresh_port_params(tree), to_torch(batch)
    enc = tb.encode(tp, tbt["input_ids"], tbt["token_type_ids"],
                    tbt["attention_mask"], config=tc, use_flash=use_flash)
    logits = tb.mlm_logits(tp, enc, tc)
    assert logits.shape == (B, T, tc.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(as_f32(enc), as_f32(enc_j), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(as_f32(logits), as_f32(logits_j),
                               atol=F32_ATOL, rtol=0)
    pooled_j = jb.pooled(jp, enc_j)
    np.testing.assert_allclose(as_f32(tb.pooled(tp, enc)), as_f32(pooled_j),
                               atol=F32_ATOL, rtol=0)


def test_flash_and_plain_attention_agree_in_the_port(f32):
    _, tc, tree, _ = f32
    tp, tbt = fresh_port_params(tree), to_torch(make_batch(2))
    outs = [tb.encode(tp, tbt["input_ids"], None, tbt["attention_mask"],
                      config=tc, use_flash=uf) for uf in (False, True)]
    np.testing.assert_allclose(as_f32(outs[1]), as_f32(outs[0]),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("use_flash", [False, True])
def test_mlm_logits_bf16(use_flash):
    jc, tc = configs("bfloat16")
    tree = jax_params(jc, seed=3)
    batch = make_batch(3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)

    @jax.jit
    def jfwd(p, b):
        enc = jb.encode(p, b["input_ids"], None, b["attention_mask"],
                        config=jc, use_flash=use_flash)
        return jb.mlm_logits(p, enc, jc)

    want = jfwd(jp, to_jax(batch))
    tp, tbt = fresh_port_params(tree), to_torch(batch)
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    got = tb.mlm_logits(tp, tb.encode(tp, tbt["input_ids"], None,
                                      tbt["attention_mask"], config=tc,
                                      use_flash=use_flash), tc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=2e-2, rtol=0)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        w = as_f32(w)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(as_f32(g), w, rtol=1e-3,
                                   atol=1e-3 * scale + 1e-8)


@pytest.mark.parametrize("use_flash", [False, True])
def test_mlm_loss_and_gradients(f32, use_flash):
    jc, tc, tree, jp = f32
    batch = make_batch(4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jb.mlm_loss(p, b, jc, use_flash=use_flash)))(
        jp, to_jax(batch))
    tp = fresh_port_params(tree)
    loss, grads = t_optim.value_and_grad(
        lambda p, b: tb.mlm_loss(p, b, tc, use_flash=use_flash), tp,
        to_torch(batch))
    np.testing.assert_allclose(float(loss), float(loss_j), atol=F32_ATOL)
    leaves_j = jax.tree_util.tree_leaves(grads_j)
    grads = t_optim.tree_leaves(grads)
    assert len(grads) == len(leaves_j)
    assert [tuple(g.shape) for g in grads] == [w.shape for w in leaves_j]
    _assert_grads_close(grads, leaves_j)


@pytest.fixture(scope="module")
def jax_trained(f32):
    """JAX: 3 chained steps of the scanned train step (f32, lr 1e-3,
    use_flash, no remat) from the bridged params."""
    jc, _, tree, _ = f32
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    step = jb.make_scanned_train_step(jc, N_STEPS, learning_rate=LR,
                                      remat=False, use_flash=True)
    p, o, losses = step(jp, jb.init_opt_state(jp), to_jax(make_batch(5)), 0)
    return (jax.tree_util.tree_map(np.asarray, p),
            jax.tree_util.tree_map(np.asarray, o), np.asarray(losses))


def _port_train(f32, remat):
    _, tc, tree, _ = f32
    tp = fresh_port_params(tree)
    opt = tb.init_opt_state(tp)
    step = tb.make_scanned_train_step(tc, N_STEPS, learning_rate=LR,
                                      remat=remat, use_flash=True)
    out_p, out_o, losses = step(tp, opt, to_torch(make_batch(5)), 0)
    assert out_p is tp and out_o is opt        # updated in place
    return tp, opt, losses


def test_scanned_train_step_matches_jax(f32, jax_trained):
    pj, (uj, mj), losses_j = jax_trained
    tp, (u, m), losses = _port_train(f32, remat=False)
    assert losses.shape == (N_STEPS,)
    np.testing.assert_allclose(as_f32(losses), losses_j, atol=1e-4, rtol=0)
    assert len(set(as_f32(losses).tolist())) == N_STEPS   # it stepped
    for got, want in zip(t_optim.tree_leaves(tp),
                         jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   atol=PARAM_ATOL, rtol=0)
    # the first moments follow the gradients: no sign flips to absorb
    for got, want in zip(m, mj):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(as_f32(got), want, rtol=1e-2,
                                   atol=1e-2 * scale + 1e-8)


def test_remat_matches_no_remat(f32):
    tp0, _, losses0 = _port_train(f32, remat=False)
    tp1, _, losses1 = _port_train(f32, remat=True)
    np.testing.assert_allclose(as_f32(losses1), as_f32(losses0), atol=1e-6,
                               rtol=0)
    for a, b in zip(t_optim.tree_leaves(tp1), t_optim.tree_leaves(tp0)):
        np.testing.assert_allclose(as_f32(a), as_f32(b), atol=1e-6, rtol=0)


def test_make_train_step_is_one_scanned_step(f32):
    _, tc, tree, _ = f32
    batch = to_torch(make_batch(6))
    tp1 = fresh_port_params(tree)
    _, _, loss = tb.make_train_step(tc, learning_rate=LR, remat=False)(
        tp1, tb.init_opt_state(tp1), batch, 0)
    tp2 = fresh_port_params(tree)
    _, _, losses = tb.make_scanned_train_step(
        tc, 1, learning_rate=LR, remat=False)(
        tp2, tb.init_opt_state(tp2), batch, 0)
    assert float(loss) == float(losses[0])
    for a, b in zip(t_optim.tree_leaves(tp1), t_optim.tree_leaves(tp2)):
        assert torch.equal(a, b)


# -- the QA head (cases of tests/test_bert_qa.py) ---------------------------

def qa_batch(seed, vocab=1024, Tq=16, masked=True):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, Tq), np.int32)
    if masked:
        mask[:, 10:] = 0
    return {"input_ids": rs.randint(0, vocab, (B, Tq)).astype(np.int32),
            "attention_mask": mask,
            "start_positions": rs.randint(0, 10, B).astype(np.int32),
            "end_positions": rs.randint(0, 10, B).astype(np.int32)}


@pytest.fixture(scope="module")
def qa_pair(f32):
    jc, _, tree, _ = f32
    qa = jax.tree_util.tree_map(
        np.asarray, jb.init_qa_params(jax.random.key(1), jc))
    return {"bert": tree, "qa": qa}


def test_qa_logits_and_loss(f32, qa_pair):
    jc, tc, _, _ = f32
    batch = qa_batch(7)
    jall = jax.tree_util.tree_map(jnp.asarray, qa_pair)
    s_j, e_j = jb.qa_logits(jall["bert"], jall["qa"], to_jax(batch), jc)
    loss_j = jb.qa_loss(jall["bert"], jall["qa"], to_jax(batch), jc)
    tall = params_from_numpy(qa_pair, device="cpu")
    s, e = tb.qa_logits(tall["bert"], tall["qa"], to_torch(batch), tc)
    assert s.shape == (B, 16) and e.shape == (B, 16)
    np.testing.assert_allclose(as_f32(s), as_f32(s_j), atol=F32_ATOL)
    np.testing.assert_allclose(as_f32(e), as_f32(e_j), atol=F32_ATOL)
    loss = tb.qa_loss(tall["bert"], tall["qa"], to_torch(batch), tc)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=F32_ATOL)


def test_qa_train_step_matches_jax(f32, qa_pair):
    jc, tc, _, _ = f32
    batch = qa_batch(8)
    jall = jax.tree_util.tree_map(jnp.asarray, qa_pair)
    jstep = jb.make_qa_train_step(jc, learning_rate=LR)
    jopt = jb.init_opt_state(jall)
    tall = params_from_numpy(qa_pair, device="cpu")
    tstep = tb.make_qa_train_step(tc, learning_rate=LR)
    topt = tb.init_opt_state(tall)
    losses_j, losses = [], []
    for i in range(N_STEPS):
        jall, jopt, lj = jstep(jall, jopt, to_jax(batch), i)
        tall, topt, lt = tstep(tall, topt, to_torch(batch), i)
        losses_j.append(float(lj))
        losses.append(float(lt))
    np.testing.assert_allclose(losses, losses_j, atol=F32_ATOL)
    assert losses[-1] < losses[0]
    for got, want in zip(t_optim.tree_leaves(tall),
                         jax.tree_util.tree_leaves(jall)):
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   atol=2 * N_STEPS * LR, rtol=0)


# -- Adam ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_apply_matches_jax(dtype):
    """Three steps of ``adam_apply`` on a small tree with gradients far
    from 0: f32 state and f32 params agree to f32 rounding; bf16 params
    to one bf16 ulp (the f32 result is rounded once on either side)."""
    rs = np.random.RandomState(9)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tree = {"b": [rs.randn(3, 4).astype(np.float32)],
            "a": {"w": rs.randn(5).astype(np.float32),
                  "g": rs.randn(2, 2).astype(np.float32)}}
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), tree)
    jopt = j_optim.adam_init(jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    topt = t_optim.adam_init(tp)
    for it in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rs.randn(*x.shape).astype(np.float32), tree)
        jp, jopt = j_optim.adam_apply(
            jp, jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), grads),
            jopt, 0.01, it)
        t_optim.adam_apply(
            tp, params_from_numpy(jax.tree_util.tree_map(
                lambda x: np.asarray(jnp.asarray(x, jdt)), grads),
                device="cpu"), topt, 0.01, it)
    atol = 1e-6 if dtype == "float32" else 2 ** -7 * 4
    for got, want in zip(t_optim.tree_leaves(tp),
                         jax.tree_util.tree_leaves(jp)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(as_f32(got), as_f32(want), atol=atol,
                                   rtol=0)
    for got, want in zip(topt[0] + topt[1], jopt[0] + jopt[1]):
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5,
                                   atol=1e-7)


# -- layout, bridge and refusals ----------------------------------------------

def test_init_params_layout_matches_jax():
    for name in ("tiny", "base", "large"):
        jc, tc = getattr(jb.BertConfig, name)(), getattr(tb.BertConfig,
                                                          name)()
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position_embeddings",
                  "type_vocab_size", "layer_norm_eps"):
            assert getattr(jc, f) == getattr(tc, f), (name, f)
        assert tc.dtype == torch.bfloat16 and tc.head_dim == jc.head_dim
    jc, tc = jb.BertConfig.tiny(), tb.BertConfig.tiny()
    jp = jb.init_params(jax.random.key(0), jc)
    tp = tb.init_params(tc, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = t_optim.tree_leaves(tp)
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    assert tb.count_params(tp) == jb.count_params(jp)
    assert tb.flops_per_token(tb.BertConfig.base()) == \
        jb.flops_per_token(jb.BertConfig.base())
    qa = tb.init_qa_params(tc, device="cpu")
    assert qa["w"].shape == (64, 2) and qa["b"].dtype == torch.float32


def test_bridge_carries_params_and_adam_state(f32):
    """A BERT params tree and its Adam state (u_list, m_list) cross as
    they are: same nesting, leaf for leaf in tree_leaves order."""
    _, _, tree, jp = f32
    jopt = jax.tree_util.tree_map(np.asarray, jb.init_opt_state(jp))
    jopt = (list(jopt[0]), list(jopt[1]))
    tp = params_from_numpy(tree, device="cpu")
    topt = params_from_numpy(jopt, device="cpu")
    assert isinstance(topt, tuple) and len(topt) == 2
    assert isinstance(topt[0], list)
    assert tp.keys() == tree.keys()
    assert len(tp["layers"]) == len(tree["layers"])
    leaves = t_optim.tree_leaves(tp)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in topt[0]]
    # a train step accepts the bridged state directly
    step = tb.make_train_step(tb.BertConfig(**{**tb.BertConfig.tiny()
                                                .__dict__,
                                                "dtype": torch.float32}),
                              remat=False)
    _, _, loss = step(tp, topt, to_torch(make_batch(10)), 0)
    assert torch.isfinite(loss)


def test_mesh_and_sequence_parallel_are_not_ported(f32):
    """mesh= and seq_parallel= are ported (item 10a,
    test_torch_bert_parallel.py): a mesh that is not the port's raises
    TypeError, and seq_parallel without a mesh is the plain step, as in
    the JAX package."""
    _, tc, tree, _ = f32
    tp, batch = fresh_port_params(tree), to_torch(make_batch(11))
    with pytest.raises(TypeError, match="common.mesh.Mesh"):
        tb.encode(tp, batch["input_ids"], config=tc, mesh=object())
    loss_sp = tb.make_train_step(tc, seq_parallel=True, remat=False)(
        fresh_port_params(tree), tb.init_opt_state(tp), batch, 0)[2]
    loss = tb.make_train_step(tc, remat=False)(
        fresh_port_params(tree), tb.init_opt_state(tp), batch, 0)[2]
    assert float(loss_sp) == float(loss)
