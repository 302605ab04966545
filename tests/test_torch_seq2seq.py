"""The port's Seq2Seq LSTM (``models/seq2seq.py``) against the JAX
package's, on the same weights (``bridge.seq2seq_params_from_numpy`` of
the JAX params and Adam state) and the same numpy batches; the port runs
on the CPU.

Tolerances, each with its reason:
- logits and the loss: atol 1e-5 / rtol 1e-5 (``F32``), the same f32
  products over 5-7 LSTM steps summed in another order;
- gradients: atol 1e-5 plus rtol 1e-4 (``GRAD``): backward through the
  decoder and encoder, ~100 partial products a weight;
- params after 3 Adam steps at lr 1e-2: Adam divides each gradient by
  its own magnitude, so a weight whose gradient is ~0 on both sides may
  move by up to lr a step either way; on this batch none does, and params
  are held to atol 0.1 * lr (``ADAM_ATOL``), the losses to rtol 1e-5;
- decoded tokens: exact. The cached decode and the recompute loop run the
  same products in the same shapes, so they agree bit for bit; against
  the JAX decode, the logits' top two stay apart by far more than the
  1e-5 the sides differ by on these weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import seq2seq as js

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common.environment import environment
from deeplearning4j_tpu_torch.models import seq2seq as ts
from deeplearning4j_tpu_torch.models._optim import value_and_grad

F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
LR = 1e-2
ADAM_ATOL = 0.1 * LR

C = ts.Seq2SeqConfig.tiny()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, B=4, S=5, T=6, pad=True):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, C.vocab_size, (B, S)).astype(np.int32)
    tgt = rs.randint(2, C.vocab_size, (B, T)).astype(np.int32)
    if pad:  # padded targets do not count in the loss
        tgt[1, 4:] = C.pad_token
        tgt[3, 2:] = C.pad_token
    tgt_in = np.concatenate([np.full((B, 1), C.bos_token, np.int32),
                             tgt[:, :-1]], axis=1)
    return {"src": src, "tgt_in": tgt_in, "tgt_out": tgt}


def _pair(seed=3):
    jp = js.init_params(jax.random.key(seed), js.Seq2SeqConfig.tiny())
    return jp, bridge.seq2seq_params_from_numpy(_np_tree(jp), "cpu")


def _close(t_tree, j_tree, **tol):
    tl = [v for _, v in sorted(_flat(t_tree), key=lambda kv: kv[0])]
    jl = [v for _, v in sorted(_flat(_np_tree(j_tree)),
                               key=lambda kv: kv[0])]
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_logits_loss_and_gradients_match_jax():
    jp, tp = _pair()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(
        ts.teacher_forcing_logits(tp, tb["src"], tb["tgt_in"]).numpy(),
        np.asarray(js.teacher_forcing_logits(jp, jb["src"], jb["tgt_in"])),
        **F32)
    jloss, jgrads = jax.value_and_grad(js.loss_fn)(jp, jb, js.Seq2SeqConfig
                                                   .tiny())
    tloss, tgrads = value_and_grad(lambda p, b: ts.loss_fn(p, b, C), tp,
                                   tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    _close(tgrads, jgrads, **GRAD)
    # near ln V at the start; an all-pad batch divides by max(#valid, 1)
    assert abs(float(tloss) - np.log(C.vocab_size)) < 0.5
    allpad = dict(tb, tgt_out=torch.zeros_like(tb["tgt_out"]))
    assert float(ts.loss_fn(tp, allpad, C)) == 0.0


def test_three_adam_steps_match_jax():
    jp, tp = _pair()
    jopt = js.init_opt_state(jp)
    topt = bridge.seq2seq_params_from_numpy(_np_tree(jopt), "cpu")
    jstep = js.make_train_step(js.Seq2SeqConfig.tiny(), learning_rate=LR)
    tstep = ts.make_train_step(C, learning_rate=LR)
    env = environment()
    c0 = env.compile_count()
    jl, tl = [], []
    for i in range(3):
        b = _batch(seed=10 + i)
        jp, jopt, jloss = jstep(jp, jopt, {k: jnp.asarray(v)
                                           for k, v in b.items()}, i)
        tp, topt, tloss = tstep(tp, topt, {k: torch.from_numpy(v)
                                           for k, v in b.items()}, i)
        jl.append(float(jloss))
        tl.append(float(tloss))
    # one dispatch signature: the census counts it once
    assert env.compile_count() - c0 == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(tp, jp, atol=ADAM_ATOL, rtol=0)


def test_cached_decode_matches_recompute_and_jax():
    jp, tp = _pair(seed=3)
    src = np.random.RandomState(7).randint(2, C.vocab_size, (8, 6)) \
        .astype(np.int32)
    cached = ts.greedy_decode(tp, torch.from_numpy(src), 12, C)
    naive = ts.greedy_decode_recompute(tp, torch.from_numpy(src), 12, C)
    assert cached.dtype == torch.int32 and tuple(cached.shape) == (8, 12)
    assert torch.equal(cached, naive)
    np.testing.assert_array_equal(
        cached.numpy(), np.asarray(js.greedy_decode(jp, jnp.asarray(src),
                                                    12, js.Seq2SeqConfig
                                                    .tiny())))


def test_decode_step_is_incremental():
    """One decode_step from the encoder state equals the first column of
    the teacher-forcing forward fed BOS."""
    _, tp = _pair(seed=5)
    src = torch.from_numpy(np.random.RandomState(2).randint(
        2, C.vocab_size, (3, 4)).astype(np.int32))
    bos = torch.full((3,), C.bos_token, dtype=torch.int32)
    _, logits = ts.decode_step(tp, ts._encode(tp, src), bos)
    tf = ts.teacher_forcing_logits(tp, src, bos[:, None])
    np.testing.assert_allclose(logits.numpy(), tf[:, 0].numpy(), **F32)


def test_trains_on_the_reverse_task_and_decodes_it():
    """The JAX package's own convergence test (400 steps of B=32)."""
    params, losses = ts.fit_copy_task(C, steps=400, B=32, S=6, seed=0,
                                      device="cpu")
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])
    src = np.random.RandomState(99).randint(2, C.vocab_size, (16, 6)) \
        .astype(np.int32)
    decoded = ts.greedy_decode(params, torch.from_numpy(src), 6, C).numpy()
    assert float((decoded == src[:, ::-1]).mean()) > 0.8
    assert torch.equal(ts.greedy_decode_recompute(params, src, 6, C),
                       torch.from_numpy(decoded))


def test_entry_points_need_a_device_they_can_use():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.init_params(C)
    with pytest.raises(ValueError, match="not a Seq2Seq"):
        bridge.seq2seq_params_from_numpy({"W": np.zeros(2)}, "cpu")
