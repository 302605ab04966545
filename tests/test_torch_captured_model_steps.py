"""The captured model-level train steps (``runtime/inference.py::
captured_train_step`` over ``runtime/cuda_graphs.py``) against the JAX
package's jitted steps, on the CPU.

On the CPU every step signature runs eagerly on its static buffers (the
caller's params and Adam state, the batch copied in, the iteration as a
0-d tensor filled before each run), so these cases exercise everything
the card captures but the replay itself
(``tests/test_torch_captured_model_steps_cuda.py``):

- (a) BERT's ``make_train_step`` (remat on and off),
  ``make_scanned_train_step`` (3 steps) and ``make_qa_train_step``
  against the JAX steps, with ``use_flash`` both ways (the port's plain
  flash version on CPU tensors);
- (b) the Seq2Seq step against the JAX step over 3 Adam steps;
- (c) Adam's bias correction advances every step: a step that froze the
  iteration lands outside the tolerance, and the case shows it;
- (d) the census per kind equal to the JAX package's, each signature
  listed once in ``step.graphs.report()``;
- (e) a second params tree is stepped on, not the first; a dropped step
  goes without a collection;
- (f) the mesh and pipeline steps of a 2-rank gloo pool report their
  eager reason.

Tolerances, those of ``tests/test_torch_bert.py`` and
``tests/test_torch_seq2seq.py`` (each file states its reasons): BERT
tiny in f32 at lr 1e-3, losses within atol 1e-4, MLM params within atol
0.1 * lr, QA params within atol 2 * 3 steps * lr (the QA bias's exact
gradient is 0, so rounding moves it by up to lr a step); Seq2Seq tiny
at lr 1e-2, losses within rtol 1e-5, params within atol 0.1 * lr.
"""
import gc
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common.environment import environment as jenv
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu.models import seq2seq as js
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common.environment import environment as tenv
from deeplearning4j_tpu_torch.models import _optim as t_optim
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models import seq2seq as ts

B, T, TQ = 2, 16, 12
LR = 1e-3
N_STEPS = 3
LOSS_ATOL = 1e-4
PARAM_ATOL = 0.1 * LR
QA_ATOL = 2 * N_STEPS * LR
S2S_LR = 1e-2
S2S_ATOL = 0.1 * S2S_LR


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def configs():
    jc, tc = jb.BertConfig.tiny(), tb.BertConfig.tiny()
    jc.dtype, tc.dtype = jnp.float32, torch.float32
    return jc, tc


@pytest.fixture(scope="module")
def trees():
    """The JAX init of BERT tiny (f32) and of its QA head, as numpy."""
    jc, _ = configs()
    np_tree = jax.tree_util.tree_map(np.asarray,
                                     jb.init_params(jax.random.key(0), jc))
    qa = jax.tree_util.tree_map(np.asarray,
                                jb.init_qa_params(jax.random.key(1), jc))
    return {"mlm": np_tree, "qa": {"bert": np_tree, "qa": qa}}


def mlm_batch(seed):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, T), np.int32)
    mask[1, 12:] = 0
    labels = np.where(rs.rand(B, T) < 0.3, rs.randint(0, 1024, (B, T)),
                      -100).astype(np.int32)
    labels[0, 0] = 5
    return {"input_ids": rs.randint(0, 1024, (B, T)).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def qa_batch(seed):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, TQ), np.int32)
    mask[:, 9:] = 0
    return {"input_ids": rs.randint(0, 1024, (B, TQ)).astype(np.int32),
            "attention_mask": mask,
            "start_positions": rs.randint(0, 9, B).astype(np.int32),
            "end_positions": rs.randint(0, 9, B).astype(np.int32)}


class Events:
    """Census events recorded on each side in the block, by kind."""

    def __enter__(self):
        self.got = {"jax": Counter(), "port": Counter()}
        self.on = {side: (lambda s: lambda key: self.got[s].update(
            [str(key[0]).split(":")[0]]))(side) for side in self.got}
        jenv().add_compile_listener(self.on["jax"])
        tenv().add_compile_listener(self.on["port"])
        return self.got

    def __exit__(self, *exc):
        jenv().remove_compile_listener(self.on["jax"])
        tenv().remove_compile_listener(self.on["port"])


#: every step made here, kept to the end of the module: a step made after
#: another was dropped could take its id(), and with it its census tag
#: (the JAX package's too)
KEEP = []


def _make(kind, use_flash, jc, tc):
    """(JAX step, port step, batch maker, tree, census kind, params
    tolerance) of one ``kind``."""
    made = _steps(kind, use_flash, jc, tc)
    KEEP.append(made[:2])
    return made


def _steps(kind, use_flash, jc, tc):
    if kind == "qa":
        return (jb.make_qa_train_step(jc, learning_rate=LR),
                tb.make_qa_train_step(tc, learning_rate=LR),
                qa_batch, "qa", "bert_qa", QA_ATOL)
    kw = dict(learning_rate=LR, remat=kind == "train_remat",
              use_flash=use_flash)
    if kind == "scanned":
        return (jb.make_scanned_train_step(jc, N_STEPS, **kw),
                tb.make_scanned_train_step(tc, N_STEPS, **kw),
                mlm_batch, "mlm", "bert_train", PARAM_ATOL)
    return (jb.make_train_step(jc, **kw), tb.make_train_step(tc, **kw),
            mlm_batch, "mlm", "bert_train", PARAM_ATOL)


def run_both(kind, use_flash, trees, iterations):
    """The JAX step and the port's from the same weights over the same
    batches at ``iterations`` (the port's may differ from the JAX
    package's 0, 1, 2): losses, final params of each side, the census of
    each side and the port step's report."""
    jc, tc = configs()
    jstep, tstep, make_batch, tree, census, atol = _make(kind, use_flash,
                                                         jc, tc)
    jp = jax.tree_util.tree_map(jnp.asarray, trees[tree])
    tp = bridge.params_from_numpy(trees[tree], device="cpu")
    jo, to = jb.init_opt_state(jp), tb.init_opt_state(tp)
    calls = 1 if kind == "scanned" else N_STEPS
    jl, tl = [], []
    with Events() as got:
        for i in range(calls):
            batch = make_batch(20 + i)
            jp, jo, lj = jstep(jp, jo, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, i)
            out = tstep(tp, to, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, iterations[i])
            assert out[0] is tp and out[1] is to        # in place
            jl.append(np.asarray(lj))
            tl.append(as_f32(out[2]))
    return {"jax_losses": np.ravel(jl), "losses": np.ravel(tl), "jp": jp,
            "tp": tp, "census": got, "kind": census, "atol": atol,
            "report": tstep.graphs.report()}


def assert_params_close(r):
    for got, want in zip(t_optim.tree_leaves(r["tp"]),
                         jax.tree_util.tree_leaves(r["jp"])):
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   atol=r["atol"], rtol=0)


# -- (a) and (d): the BERT steps against the JAX package's ------------------

# the QA step has no use_flash argument on either side
@pytest.mark.parametrize("kind,use_flash", [
    ("train", False), ("train", True), ("train_remat", False),
    ("train_remat", True), ("scanned", False), ("scanned", True),
    ("qa", False)])
def test_bert_steps_match_jax_with_the_jax_census(kind, use_flash, trees):
    r = run_both(kind, use_flash, trees, iterations=[0, 1, 2])
    assert len(r["losses"]) == N_STEPS
    np.testing.assert_allclose(r["losses"], r["jax_losses"], atol=LOSS_ATOL,
                               rtol=0)
    assert len(set(r["losses"].tolist())) == N_STEPS      # it stepped
    assert_params_close(r)
    assert r["census"]["port"] == r["census"]["jax"] == \
        Counter({r["kind"]: 1})
    step, = r["report"]
    assert step["tag"].split(":")[0] == r["kind"]
    # the first run binds the body, each later one reuses it
    assert (step["cache"], step["captures"], step["replays"]) == \
        ("eager", 1, N_STEPS - 1)


# -- (b): the Seq2Seq step -----------------------------------------------------

def s2s_batch(seed, B=4, S=5, T=6):
    c = ts.Seq2SeqConfig.tiny()
    rs = np.random.RandomState(seed)
    src = rs.randint(2, c.vocab_size, (B, S)).astype(np.int32)
    tgt = rs.randint(2, c.vocab_size, (B, T)).astype(np.int32)
    tgt[1, 4:] = c.pad_token
    tgt_in = np.concatenate([np.full((B, 1), c.bos_token, np.int32),
                             tgt[:, :-1]], axis=1)
    return {"src": src, "tgt_in": tgt_in, "tgt_out": tgt}


def s2s_run(iterations):
    jc, tc = js.Seq2SeqConfig.tiny(), ts.Seq2SeqConfig.tiny()
    jp = js.init_params(jax.random.key(3), jc)
    tp = bridge.seq2seq_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jo, to = js.init_opt_state(jp), ts.init_opt_state(tp)
    jstep = js.make_train_step(jc, learning_rate=S2S_LR)
    tstep = ts.make_train_step(tc, learning_rate=S2S_LR)
    KEEP.append((jstep, tstep))
    jl, tl = [], []
    with Events() as got:
        for i, it in enumerate(iterations):
            b = s2s_batch(10 + i)
            jp, jo, lj = jstep(jp, jo, {k: jnp.asarray(v)
                                        for k, v in b.items()}, i)
            tp, to, lt = tstep(tp, to, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, it)
            jl.append(float(lj))
            tl.append(float(lt))
    return jl, tl, jp, tp, got, tstep.graphs.report()


def s2s_params_far(jp, tp):
    """The largest gap between the two sides' params."""
    return max(float(np.abs(as_f32(t) - np.asarray(j)).max())
               for t, j in zip(t_optim.tree_leaves(tp),
                               jax.tree_util.tree_leaves(jp)))


def test_seq2seq_step_matches_jax_with_the_jax_census():
    jl, tl, jp, tp, got, report = s2s_run([0, 1, 2])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert s2s_params_far(jp, tp) <= S2S_ATOL
    assert got["port"] == got["jax"] == Counter({"seq2seq_train": 1})
    step, = report
    assert (step["cache"], step["captures"], step["replays"]) == \
        ("eager", 1, 2)


# -- (c): the bias correction advances ----------------------------------------

def test_a_frozen_iteration_lands_outside_the_tolerance(trees):
    """The steps above pass their iteration through a tensor filled
    before each run; one filled with 0 every step (a value baked into a
    graph) misses the JAX package's params by far more than the
    tolerance, so those cases would catch it."""
    r = run_both("train", True, trees, iterations=[0, 0, 0])
    far = max(float(np.abs(as_f32(t) - as_f32(j)).max())
              for t, j in zip(t_optim.tree_leaves(r["tp"]),
                              jax.tree_util.tree_leaves(r["jp"])))
    assert far > 2 * PARAM_ATOL
    jl, tl, jp, tp, _, _ = s2s_run([0, 0, 0])
    assert s2s_params_far(jp, tp) > 2 * S2S_ATOL


# -- (e): whose tensors a step writes, and its lifetime -------------------------

def test_a_second_params_tree_is_stepped_on_not_the_first(trees):
    _, tc = configs()
    step = tb.make_train_step(tc, learning_rate=LR, remat=False,
                              use_flash=True)
    batch = {k: torch.from_numpy(v) for k, v in mlm_batch(5).items()}
    first = bridge.params_from_numpy(trees["mlm"], device="cpu")
    second = bridge.params_from_numpy(trees["mlm"], device="cpu")
    o1, o2 = tb.init_opt_state(first), tb.init_opt_state(second)
    _, _, l1 = step(first, o1, batch, 0)
    stepped = [t.clone() for t in t_optim.tree_leaves([first, o1])]
    _, _, l2 = step(second, o2, batch, 0)
    # the first tree was left as its own step wrote it, the second got
    # the same step from the same start
    assert all(torch.equal(a, b) for a, b in
               zip(t_optim.tree_leaves([first, o1]), stepped))
    assert all(torch.equal(a, b) for a, b in
               zip(t_optim.tree_leaves([second, o2]), stepped))
    assert torch.equal(l1, l2)
    entry, = step.graphs.report()
    assert (entry["captures"], entry["replays"]) == (2, 1)


def test_a_dropped_step_goes_without_a_collection():
    c = ts.Seq2SeqConfig.tiny()
    params = ts.init_params(c, seed=0, device="cpu")
    opt = ts.init_opt_state(params)
    step = ts.make_train_step(c)
    batch = {k: torch.from_numpy(v) for k, v in s2s_batch(1).items()}
    for i in range(2):
        step(params, opt, batch, i)
    inputs = next(iter(step.graphs._steps.values())).inputs
    refs = [weakref.ref(step), weakref.ref(step.graphs),
            weakref.ref(inputs["batch"]["src"])]
    del inputs
    collecting = gc.isenabled()
    gc.disable()
    try:
        del step
        assert [r() for r in refs] == [None, None, None]
    finally:
        if collecting:
            gc.enable()


def _garbage_tensors(fn):
    """The tensors that only a collection would free after ``fn()``."""
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        fn()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        return [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if collecting:
            gc.enable()


@pytest.mark.parametrize("kind", ["train", "train_remat", "qa",
                                  "seq2seq"])
def test_a_step_leaves_no_cycle_holding_its_tensors(kind, trees):
    """A step's gradients and activations are freed when the step returns,
    not at the next collection: on the card they come from the captured
    graph's pool, which a release or a dropped step could not hand back
    while a cycle held them."""
    _, tc = configs()
    if kind == "seq2seq":
        c = ts.Seq2SeqConfig.tiny()
        params = ts.init_params(c, seed=0, device="cpu")
        step = ts.make_train_step(c)
        batch = {k: torch.from_numpy(v) for k, v in s2s_batch(4).items()}
    else:
        step = _steps(kind, False, configs()[0], tc)[1]
        params = bridge.params_from_numpy(
            trees["qa" if kind == "qa" else "mlm"], device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in
                 (qa_batch if kind == "qa" else mlm_batch)(4).items()}
    opt = t_optim.adam_init(params)
    # the process's first checkpoint imports torch's compiler modules,
    # whose import keeps the calling frames in a cycle once
    step(params, opt, batch, 0)
    for i in (1, 2):
        assert _garbage_tensors(lambda: step(params, opt, batch, i)) == []


def test_release_lets_go_of_the_params_and_the_next_call_binds_again():
    c = ts.Seq2SeqConfig.tiny()
    params = ts.init_params(c, seed=0, device="cpu")
    opt = ts.init_opt_state(params)
    step = ts.make_train_step(c)
    batch = {k: torch.from_numpy(v) for k, v in s2s_batch(2).items()}
    step(params, opt, batch, 0)
    ref = weakref.ref(params["embed"])
    step.graphs.release()
    del params, opt
    assert ref() is None
    params = ts.init_params(c, seed=0, device="cpu")
    step(params, ts.init_opt_state(params), batch, 0)
    entry, = step.graphs.report()
    assert (entry["captures"], entry["replays"]) == (2, 0)


# -- (f): mesh and pipeline steps stay eager with their reason ----------------

def test_two_rank_gloo_mesh_and_pipeline_steps_report_their_eager_reason(
        trees):
    from deeplearning4j_tpu_torch.parallel.launch import RankPool
    with RankPool(2, "cpu") as pool:
        reports = pool.run("torch_parallel_cases:bert_mesh_reports",
                           trees["qa"], mlm_batch(3), qa_batch(4))
    for report in reports:
        assert sorted((g["tag"].split(":")[0], g["cache"], g["replays"])
                      for g in report) == [
            ("bert_pipeline", "eager:gloo", 1),
            ("bert_qa", "eager:gloo", 1),
            ("bert_train", "eager:gloo", 2)]


# -- the launch record of a capture -------------------------------------------

def test_a_launch_on_the_captured_stream_from_another_thread_is_recorded():
    """Autograd runs a captured step's backward on a worker thread of its
    own, on the forward's stream: the flash backward's launches there go
    into the capture's record (a replay adds them), not onto the count
    at capture time, when the card ran nothing."""
    import threading
    from deeplearning4j_tpu_torch.kernels._counts import (LaunchRecord,
                                                          count_launch,
                                                          recording)

    def kernel():
        pass
    kernel.launches, kernel.library = 0, "test"
    captured, other = 0x5EED, 0x0DD
    rec = LaunchRecord()
    with recording(rec, captured):
        worker = threading.Thread(target=lambda: (
            count_launch(kernel, captured), count_launch(kernel, other)))
        worker.start()
        worker.join(10)
    assert not worker.is_alive()
    assert rec.counts() == {"kernel": 1} and kernel.launches == 1
    count_launch(kernel, captured)        # the capture has ended
    assert kernel.launches == 2
    rec.replay()
    assert kernel.launches == 3


def test_an_empty_capture_is_seen_and_other_warnings_pass_on():
    """torch only warns when a capture ends with an empty graph (whose
    replay would run nothing); ``empty_capture`` turns that warning into
    the flag a capture is judged by (``eager:empty_graph`` in
    ``StepGraphs``, ``EmptyGraph`` in the op sweep) and lets every other
    warning through."""
    import warnings
    from deeplearning4j_tpu_torch.runtime.cuda_graphs import empty_capture
    with pytest.warns(UserWarning, match="another"):
        with empty_capture() as seen:
            warnings.warn("The CUDA Graph is empty. This usually means that "
                          "the graph was attempted to be captured on wrong "
                          "device or stream.")
            warnings.warn("another")
    assert seen.empty
    with empty_capture() as seen:
        pass
    assert not seen.empty
