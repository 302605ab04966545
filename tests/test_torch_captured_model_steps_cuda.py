"""The captured model-level train steps on the card: BERT's MLM (remat
on and off, one call a step and the scanned form), QA and the Seq2Seq
step, each replaying one CUDA graph a signature
(``runtime/inference.py::captured_train_step``), against the same body
kept eager (``eager="reference"``) from the same start. Every test here
carries the ``cuda`` marker and skips where there is no CUDA device; the
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_captured_model_steps_cuda.py -q

What a replay must keep:
- the params, the Adam moments and every loss, bit for bit, where two
  eager runs from one start agree bit for bit (the same kernels on the
  same inputs in the same order give the same bits); where they do not,
  within twice their own spread, with the op that differs named in
  ``PERF.md`` (an accumulation whose order the card picks at run time);
- the flash kernels' launches: each replay adds what its capture
  recorded, so a step counts one forward, dq and dk/dv launch per layer
  (two forwards under remat, whose backward recomputes the forward);
- memory: ``release()`` hands the graphs' pool back, and so does
  dropping the step, with the collector off.
"""
import gc
import importlib
import weakref

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import _optim
from deeplearning4j_tpu_torch.models import bert
from deeplearning4j_tpu_torch.models import seq2seq
from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32

pytestmark = pytest.mark.cuda

CALLS = 3                 # calls of each step: one capture, two replays
B, T = 8, 128             # BERT-base widths, a short batch
SCANNED = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


# the wrapper module (the package's ``flash_attention`` is its function)
_fa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")
FLASH = (_fa._flash_fwd, _fa._flash_bwd_dq, _fa._flash_bwd_dkv)


def _mlm_batch(cfg, seed):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, T), np.int32)
    mask[1, 100:] = 0
    labels = np.where(rs.rand(B, T) < 0.15,
                      rs.randint(0, cfg.vocab_size, (B, T)), -100)
    return {"input_ids": torch.as_tensor(
                rs.randint(0, cfg.vocab_size, (B, T)), device="cuda"),
            "labels": torch.as_tensor(labels, device="cuda"),
            "attention_mask": torch.as_tensor(mask, device="cuda")}


def _qa_batch(cfg, seed):
    rs = np.random.RandomState(seed)
    return {"input_ids": torch.as_tensor(
                rs.randint(0, cfg.vocab_size, (B, T)), device="cuda"),
            "attention_mask": torch.ones((B, T), dtype=torch.int32,
                                         device="cuda"),
            "start_positions": torch.as_tensor(
                rs.randint(0, T, B).astype(np.int32), device="cuda"),
            "end_positions": torch.as_tensor(
                rs.randint(0, T, B).astype(np.int32), device="cuda")}


def _s2s_batch(c, seed, B=32, S=8):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, c.vocab_size, (B, S)).astype(np.int32)
    tgt = src[:, ::-1].copy()
    tgt_in = np.concatenate([np.full((B, 1), c.bos_token, np.int32),
                             tgt[:, :-1]], axis=1)
    return {k: torch.from_numpy(v).cuda() for k, v in
            (("src", src), ("tgt_in", tgt_in), ("tgt_out", tgt))}


def _case(kind):
    """(make a step, make a fresh (params, opt) from one seed, batch of
    call i, flash forwards a layer and step, flash layers)."""
    cfg = bert.BertConfig.base()
    if kind == "seq2seq":
        c = seq2seq.Seq2SeqConfig()

        def fresh():
            p = seq2seq.init_params(c, seed=0, device="cuda")
            return p, seq2seq.init_opt_state(p)
        return (lambda: seq2seq.make_train_step(c), fresh,
                lambda i: _s2s_batch(c, i), 0, 0)
    if kind == "qa":
        def fresh():
            p = {"bert": bert.init_params(cfg, seed=0, device="cuda"),
                 "qa": bert.init_qa_params(cfg, seed=1, device="cuda")}
            return p, bert.init_opt_state(p)
        # the QA step's attention is the plain branch (no use_flash)
        return (lambda: bert.make_qa_train_step(cfg), fresh,
                lambda i: _qa_batch(cfg, i), 0, 0)

    def fresh():
        p = bert.init_params(cfg, seed=0, device="cuda")
        return p, bert.init_opt_state(p)
    remat = kind == "remat"
    if kind == "scanned":
        make = lambda: bert.make_scanned_train_step(  # noqa: E731
            cfg, SCANNED, remat=False, use_flash=True)
    else:
        make = lambda: bert.make_train_step(  # noqa: E731
            cfg, remat=remat, use_flash=True)
    return make, fresh, lambda i: _mlm_batch(cfg, i), 2 if remat else 1, \
        cfg.num_layers


def _train(make, fresh, batch, eager=None):
    """CALLS calls of a new step on fresh state: (state leaves, losses,
    the step's report, the flash launches of the calls)."""
    params, opt = fresh()
    step = make()
    for f in FLASH:
        f.launches = 0
    losses = []
    with full_f32():
        for i in range(CALLS):
            params, opt, loss = step(params, opt, batch(i), 10 * i,
                                     eager=eager)
            losses.append(loss)
    torch.cuda.synchronize()
    launches = [f.launches for f in FLASH]
    state = [t.clone() for t in _optim.tree_leaves([params, opt])]
    report = step.graphs.report()
    step.graphs.release()
    return state, torch.stack([torch.atleast_1d(l) for l in losses]), \
        report, launches


def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["mlm", "remat", "scanned", "qa",
                                  "seq2seq"])
def test_replay_holds_the_eager_state_and_counts_the_flash_launches(
        cuda, kind):
    make, fresh, batch, fwd_per_layer, layers = _case(kind)
    rep, rep_losses, report, launches = _train(make, fresh, batch)
    e1, e1_losses, eager_report, _ = _train(make, fresh, batch,
                                            eager="reference")
    e2, e2_losses, _, _ = _train(make, fresh, batch, eager="reference")
    entry, = report
    assert (entry["cache"], entry["error"]) == ("captured", None)
    assert [g["cache"] for g in eager_report] == ["eager:reference"]
    steps = CALLS * (SCANNED if kind == "scanned" else 1)
    assert launches == [fwd_per_layer * layers * steps,
                        layers * steps, layers * steps]
    if all(torch.equal(x, y) for x, y in zip(e1, e2)) and \
            torch.equal(e1_losses, e2_losses):
        assert all(torch.equal(x, y) for x, y in zip(rep, e1)), kind
        assert torch.equal(rep_losses, e1_losses), kind
    else:
        spread = max(_max_diff(e1, e2), _max_diff([e1_losses], [e2_losses]))
        assert _max_diff(rep, e1) <= 2 * spread, kind
        assert _max_diff([rep_losses], [e1_losses]) <= 2 * spread, kind


def _settled():
    """(allocated, reserved) bytes once the allocator has handed back
    what it caches, the cuBLAS workspaces torch caches a stream too."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


@pytest.mark.parametrize("how", ["release", "drop"])
def test_release_and_drop_hand_the_pool_back(cuda, how):
    make, fresh, batch, _, _ = _case("mlm")
    params, opt = fresh()
    data = batch(0)
    base = _settled()
    step = make()
    for i in range(CALLS):
        step(params, opt, data, i)
    # the graph's private pool keeps the step's activations while the
    # graph lives: the allocator cannot hand it back
    pool = _settled()[1] - base[1]
    # the allocator hands out blocks of 512-byte multiples
    static = sum(-(-t.numel() * t.element_size() // 512) * 512
                 for t in _optim.tree_leaves(
                     [s.inputs for s in step.graphs._steps.values()]))
    ref = weakref.ref(step.graphs)
    collecting = gc.isenabled()
    gc.disable()
    try:
        if how == "release":
            step.graphs.release()
        else:
            del step
            assert ref() is None
        allocated, reserved = _settled()
    finally:
        if collecting:
            gc.enable()
    assert pool > 64 << 20, pool
    # what stays: the static batch while the step lives, in the small
    # blocks' 2 MiB segments
    assert allocated - base[0] <= (static if how == "release" else 0)
    assert reserved - base[1] <= 2 << 20, (reserved - base[1], pool)
