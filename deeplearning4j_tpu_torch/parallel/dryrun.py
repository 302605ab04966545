"""The multi-rank dry run: one training step on each parallel layout.

Counterpart of the JAX package's ``dryrun_multichip`` (the repo's
``__graft_entry__.py``), with the same four legs at ``BertConfig.tiny()``,
the same batches (``np.random.RandomState(0)`` drawn in the same order)
and the same mesh factorisation of ``--world`` ranks:

1. BERT at dp x tp x sp (tp = 2 and sp = 2 where they divide), with the
   flash ring (``use_flash=True``) whenever sp > 1;
2. a dp x pp pipeline step (``make_pipeline_train_step``'s default
   1F1B schedule, 2 microbatches);
3. dp x tp x pp with Megatron TP inside the 1F1B stages (world % 8 == 0);
4. the state of leg 1 saved on every rank and restored onto a sub-mesh
   of half the ranks (dp x tp), then one step there.

Each leg's loss is checked against the port's own single-process step
on the same weights and batch (:data:`LOSS_ATOL`, bf16), and one line
per leg is printed in the JAX dry run's format::

    python -m deeplearning4j_tpu_torch.parallel.dryrun --world 8 --device cpu

spawns the ranks itself (``launch.RankPool``: gloo on the CPU; on the
card NCCL where each rank has a card, else gloo through host memory).
``--weights DIR`` reads each leg's initial weights from ``DIR/leg{i}.npz``
(the params' leaves in ``tree_leaves`` order, as ``leaf0``, ``leaf1``,
...) instead of the port's seeded init, so the losses can be held
against another implementation's on the same weights. Exits non-zero
on any failed check.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import numpy as np

#: bf16 loss tolerance against the single-process step: both round the
#: activations to bf16, the sharded one at other places (a row-parallel
#: product is summed over ranks after rounding), and the loss is O(7)
LOSS_ATOL = 3e-2

SEQ_LEN = 32


def _init(config, leg, weights, device):
    from ..models import _optim, bert
    params = bert.init_params(config, seed=leg, device="cpu")
    if weights:
        import torch
        with np.load(os.path.join(weights, f"leg{leg}.npz")) as z:
            leaves = [torch.as_tensor(z[f"leaf{i}"]).to(t.dtype)
                      for i, t in enumerate(_optim.tree_leaves(params))]
        params = _optim.tree_unflatten(params, leaves)
    return _optim.tree_unflatten(
        params, [t.to(device) for t in _optim.tree_leaves(params)])


def _mlm_batch(rng, config, B, T, device, mask=True):
    import torch
    ids = rng.randint(0, config.vocab_size, (B, T))
    labels = np.where(rng.rand(B, T) < 0.15,
                      rng.randint(0, config.vocab_size, (B, T)), -100)
    out = {"input_ids": torch.as_tensor(ids, dtype=torch.int32,
                                        device=device),
           "labels": torch.as_tensor(labels, dtype=torch.int32,
                                     device=device)}
    if mask:
        out["attention_mask"] = torch.ones((B, T), dtype=torch.int32,
                                           device=device)
    return out


def _clone(tree):
    from ..models import _optim
    return _optim.tree_unflatten(tree, [t.detach().clone() for t in
                                        _optim.tree_leaves(tree)])


def _reference(config, params, batch, use_flash, opt=None):
    """The port's single-process step's loss from the same state."""
    from ..models import bert
    params = _clone(params)
    opt = bert.init_opt_state(params) if opt is None else _clone(opt)
    step = bert.make_train_step(config, remat=False, use_flash=use_flash)
    return float(step(params, opt, batch, 0)[2])


def _check(name, loss, ref):
    if not math.isfinite(loss):
        raise RuntimeError(f"{name}: non-finite loss {loss}")
    if abs(loss - ref) > LOSS_ATOL:
        raise RuntimeError(f"{name}: loss {loss} vs the single-process "
                           f"step's {ref} (atol {LOSS_ATOL})")


def rank_main(n: int, device: str, weights, ckpt_dir):
    """Every rank's part of the four legs; returns rank 0's lines and
    the legs' (loss, single-process loss)."""
    from ..common.mesh import MeshConfig, gather_tree, make_mesh
    from ..models import bert
    from ..nn.checkpoint import ShardedCheckpointer
    config = bert.BertConfig.tiny()
    lines, losses = [], {}

    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (tp * 2) == 0 else 1
    dp = n // (tp * sp)
    mesh = make_mesh(MeshConfig(data=dp, tensor=tp, seq=sp),
                     devices=range(n), device=device)
    full = _init(config, 0, weights, device)
    params = bert.place_params(full, config, mesh)
    opt = bert.init_opt_state(params)
    step = bert.make_train_step(config, mesh, seq_parallel=sp > 1,
                                use_flash=sp > 1)
    B, T = max(2, 2 * dp), SEQ_LEN
    rng = np.random.RandomState(0)
    batch = _mlm_batch(rng, config, B, T, device)
    params, opt, loss = step(params, opt, batch, 0)
    loss = float(loss)
    ref = _reference(config, full, batch, sp > 1)
    _check("dp x tp x sp", loss, ref)
    losses["mesh"] = (loss, ref)
    lines.append(f"dryrun_multichip(n={n}): mesh dp={dp} tp={tp} sp={sp}, "
                 f"loss={loss:.4f} OK")

    pp = next((p for p in (4, 2) if n % p == 0
               and config.num_layers % p == 0), 1)
    if pp > 1:
        dp2 = n // pp
        mesh_pp = make_mesh(MeshConfig(data=dp2, pipe=pp), devices=range(n),
                            device=device)
        full1 = _init(config, 1, weights, device)
        pp_params = bert.place_pipeline_params(
            bert.to_pipeline_params(full1, pp), mesh_pp)
        pp_opt = bert.init_opt_state(pp_params)
        pp_step = bert.make_pipeline_train_step(config, mesh_pp,
                                                n_microbatches=2)
        B2 = max(2 * dp2, 2) * 2
        batch_pp = _mlm_batch(rng, config, B2, T, device, mask=False)
        pp_val = float(pp_step(pp_params, pp_opt, batch_pp, 0)[2])
        ref = _reference(config, full1, batch_pp, False)
        _check("pipeline", pp_val, ref)
        losses["pipeline"] = (pp_val, ref)
        lines.append(f"dryrun_multichip(n={n}): pipeline dp={dp2} pp={pp}, "
                     f"loss={pp_val:.4f} OK")

    if n % 8 == 0 and config.num_layers % 2 == 0:
        dp3 = n // 4
        mesh3 = make_mesh(MeshConfig(data=dp3, tensor=2, pipe=2),
                          devices=range(n), device=device)
        full2 = _init(config, 2, weights, device)
        p3 = bert.place_pipeline_params(bert.to_pipeline_params(full2, 2),
                                        mesh3, tensor_parallel=True)
        o3 = bert.init_opt_state(p3)
        step3 = bert.make_pipeline_train_step(config, mesh3,
                                              n_microbatches=2,
                                              tensor_parallel=True)
        B3 = max(2 * dp3, 2) * 2
        batch3 = _mlm_batch(rng, config, B3, T, device, mask=False)
        l3v = float(step3(p3, o3, batch3, 0)[2])
        ref = _reference(config, full2, batch3, False)
        _check("3-axis", l3v, ref)
        losses["3-axis"] = (l3v, ref)
        lines.append(f"dryrun_multichip(n={n}): 3-axis dp={dp3} tp=2 pp=2 "
                     f"(1f1b, megatron-tp), loss={l3v:.4f} OK")

    if n % 2 == 0 and n >= 4:
        ck = ShardedCheckpointer(ckpt_dir)
        ck.save_tree(1, {"params": params, "opt": opt})
        saved = {"params": gather_tree(params), "opt": gather_tree(opt)}
        half = n // 2
        from ..common.mesh import global_rank
        # every rank builds the sub-mesh (its groups); half of them use it
        mesh_b = make_mesh(MeshConfig(data=half // tp, tensor=tp),
                           devices=range(half), device=device)
        if global_rank() < half:
            target = {"params": bert.place_params(
                _init(config, 3, None, device), config, mesh_b)}
            target["opt"] = bert.init_opt_state(target["params"])
            state = ck.restore_tree(1, target=target)
            step_b = bert.make_train_step(config, mesh_b)
            lbv = float(step_b(state["params"], state["opt"], batch, 0)[2])
            ref = _reference(config, saved["params"], batch, False,
                             saved["opt"])
            _check("elastic", lbv, ref)
            losses["elastic"] = (lbv, ref)
            lines.append(f"dryrun_multichip(n={n}): elastic restore "
                         f"{n}->{half} devices (dp={half // tp} tp={tp}), "
                         f"loss={lbv:.4f} OK")
    return lines, losses


def dryrun(n: int, device: str = "cuda", weights=None):
    """Spawn ``n`` ranks and run the four legs; rank 0's lines and its
    losses ``{leg: (loss, single-process loss)}``."""
    from .launch import spawn
    if not str(device).startswith("cuda") and str(device) != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if str(device).startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda asked for but "
                               "torch.cuda.is_available() is False; pass "
                               "--device cpu to run on the CPU")
    with tempfile.TemporaryDirectory(prefix="dl4j_dryrun_") as td:
        out = spawn("deeplearning4j_tpu_torch.parallel.dryrun:rank_main", n,
                    n, device, weights, td, device=device)
    return out[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    lines, _ = dryrun(args.world, args.device, args.weights)
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
