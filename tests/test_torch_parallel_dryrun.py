"""The port's multi-rank dry run against the JAX package's on the same
weights and batches.

``python -m deeplearning4j_tpu_torch.parallel.dryrun --world 8 --device
cpu --weights DIR`` runs its four legs on 8 gloo ranks (dp2 x tp2 x sp2
with the flash ring, dp4 x pp2 1F1B, dp2 x tp2 x pp2 1F1B with Megatron
TP, and the 8 -> 4 elastic restore), each leg from the JAX package's
``init_params(jax.random.key(leg))`` written to ``DIR``, and prints the
JAX dry run's lines. The references are computed here, in this process,
by the JAX package's train step on the same weights and the same
``RandomState(0)`` batches (its single-device ``make_train_step``: the
JAX package's own tests hold its sharded and pipelined steps equal to
it, and compiling the sharded programs here would cost a minute): the
loss before the first update for legs 1-3, and for the elastic leg the
loss of leg 1's updated params and Adam state.

Tolerance: bf16 (the dry run's dtype) on both sides, which round
activations at other places; the losses are O(7), held to atol 3e-2 as
the dry run holds its own legs against the port's single-process step.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 3e-2
LEG = re.compile(r"^dryrun_multichip\(n=8\): (.*), loss=([-0-9.]+) OK$")


def batch(rng, c, B, T, mask=True):
    ids = rng.randint(0, c.vocab_size, (B, T))
    labels = np.where(rng.rand(B, T) < 0.15,
                      rng.randint(0, c.vocab_size, (B, T)), -100)
    out = {"input_ids": jnp.asarray(ids, jnp.int32),
           "labels": jnp.asarray(labels, jnp.int32)}
    if mask:
        out["attention_mask"] = jnp.ones((B, T), jnp.int32)
    return out


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    c = jb.BertConfig.tiny()
    params = [jb.init_params(jax.random.key(i), c) for i in range(3)]
    for i, p in enumerate(params):
        leaves = jax.tree_util.tree_leaves(p)
        np.savez(d / f"leg{i}.npz", **{f"leaf{k}": np.asarray(a, np.float32)
                                       for k, a in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.dryrun",
         "--world", "8", "--device", "cpu", "--weights", str(d)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    return c, params, proc


@pytest.fixture(scope="module")
def jax_losses(dryrun):
    """The JAX package's losses for the four legs (dry run order)."""
    c, params, _ = dryrun
    step = jb.make_train_step(c, remat=False)
    rng = np.random.RandomState(0)
    b1 = batch(rng, c, 4, 32)                 # dp=2: B = max(2, 2 * dp)
    opt = jb.init_opt_state(params[0])
    p1, o1, l1 = step(params[0], opt, b1, 0)
    b2 = batch(rng, c, 16, 32, mask=False)    # dp=4: max(2 * 4, 2) * 2
    _, _, l2 = step(params[1], jb.init_opt_state(params[1]), b2, 0)
    b3 = batch(rng, c, 8, 32, mask=False)     # dp=2: max(2 * 2, 2) * 2
    _, _, l3 = step(params[2], jb.init_opt_state(params[2]), b3, 0)
    _, _, l4 = step(p1, o1, b1, 0)            # leg 1's state, restored
    return [float(l1), float(l2), float(l3), float(l4)]


def test_dryrun_exits_zero_with_four_legs(dryrun):
    _, _, proc = dryrun
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if LEG.match(ln)]
    assert [LEG.match(ln).group(1) for ln in lines] == [
        "mesh dp=2 tp=2 sp=2", "pipeline dp=4 pp=2",
        "3-axis dp=2 tp=2 pp=2 (1f1b, megatron-tp)",
        "elastic restore 8->4 devices (dp=2 tp=2)"]


@pytest.mark.parametrize("leg", range(4), ids=["dp2-tp2-sp2-flash",
                                               "dp4-pp2", "dp2-tp2-pp2",
                                               "elastic-8-to-4"])
def test_leg_loss_matches_jax(dryrun, jax_losses, leg):
    _, _, proc = dryrun
    lines = [ln for ln in proc.stdout.splitlines() if LEG.match(ln)]
    loss = float(LEG.match(lines[leg]).group(2))
    assert np.isfinite(loss)
    assert loss == pytest.approx(jax_losses[leg], abs=ATOL)
