"""The captured serving steps (``runtime/cuda_graphs.py``) on the card.
Every test here carries the ``cuda`` marker and skips where there is no
CUDA device; the file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_captured_steps_cuda.py -q

What a replay must keep, each held exactly (the same kernels on the same
inputs in the same order give the same bits):
- a decode engine's tokens (bf16, its int8 twin, with a draft; greedy
  and sampled) equal to the same step bodies run eagerly by an engine
  whose steps are kept eager;
- a predict bucket's outputs equal to the eager forward's, also after
  ``fit`` replaced the params;
- the kernels' launch counts: a replay adds what its capture recorded;
- two engines warming and serving on two threads at once;
- a graph replaying on the merge counters it captured after a later step
  needed a larger buffer (``kernels/_build.py::counters``).
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import paged_flash_decode
from deeplearning4j_tpu_torch.kernels.paged_flash_decode import split_rows
from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                       CausalLMConfig)
from deeplearning4j_tpu_torch.quant.transforms import (_fused_dequant_matmul,
                                                       quantize_model)
from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine

pytestmark = pytest.mark.cuda

V, LAYERS = 97, 2
ENGINE_KW = {"slots": 4, "max_ctx": 128, "prompt_buckets": [16, 64],
             "kv_block_size": 16, "prefill_batch": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(seed=0):
    cfg = CausalLMConfig(vocab_size=V, hidden_size=64, num_layers=LAYERS,
                         num_heads=4, intermediate_size=128,
                         max_position_embeddings=256, dtype=torch.bfloat16)
    return CausalLM(cfg, seed=seed, device="cuda")


def _prompts():
    rs = np.random.RandomState(3)
    return [rs.randint(0, V, n).astype(np.int32) for n in (5, 17, 40, 9)]


def _serve(model, eager=False, seed=0, **kw):
    """Tokens of four requests (two sampled) and the engine's stats."""
    eng = DecodeEngine(model, device="cuda", seed=seed,
                       **{**ENGINE_KW, **kw})
    if eager:
        eng._eager_reason = "check"   # the same bodies, no graphs
    try:
        eng.warmup()
        futs = [eng.generate(p, max_tokens=12,
                             temperature=0.9 if i % 2 else 0.0)
                for i, p in enumerate(_prompts())]
        return [f.result(timeout=120)["tokens"] for f in futs], eng.stats()
    finally:
        eng.close(30)


@pytest.mark.parametrize("variant", ["bf16", "int8", "spec"])
def test_decode_replay_equals_eager(cuda, variant):
    model = _model()
    kw = {}
    if variant == "int8":
        model = quantize_model(model, device="cuda")
    if variant == "spec":
        draft = CausalLM(
            CausalLMConfig(**{**model.config.__dict__, "num_layers": 1}),
            params={"embeddings": model.params["embeddings"],
                    "layers": model.params["layers"][:1]}, device="cuda")
        kw = {"draft_model": draft, "spec_k": 3}
    got, stats = _serve(model, **kw)
    ref, ref_stats = _serve(model, eager=True, **kw)
    assert got == ref
    assert {g["cache"] for g in stats["graphs"]} == {"captured"}
    assert {g["cache"] for g in ref_stats["graphs"]} == {"eager:check"}
    assert sum(g["replays"] for g in stats["graphs"]) > 0


def test_launch_counts_count_replays(cuda):
    """After warmup every step replays: the paged read launches once a
    layer and decode step, the dequant kernel twice a layer (w1, w2) and
    step, prefills included."""
    twin = quantize_model(_model(), device="cuda")
    eng = DecodeEngine(twin, device="cuda", **ENGINE_KW)
    try:
        eng.warmup()
        s0 = eng.stats()
        paged_flash_decode.launches = 0
        _fused_dequant_matmul.launches = 0
        for p in _prompts():
            eng.generate(p, max_tokens=8).result(timeout=120)
        s1 = eng.stats()
    finally:
        eng.close(30)
    steps = s1["decode_steps"] - s0["decode_steps"]
    prefills = s1["prefill_dispatches"] - s0["prefill_dispatches"]
    assert steps > 0 and prefills > 0
    assert paged_flash_decode.launches == LAYERS * steps
    assert _fused_dequant_matmul.launches == 2 * LAYERS * (steps + prefills)
    decode = next(g for g in s1["graphs"] if g["tag"] == "decode:int8")
    assert decode["launches"] == {"paged_flash_decode": LAYERS,
                                  "_fused_dequant_matmul": 2 * LAYERS}


def _mlp(seed=0):
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer(n_in=32, n_out=64, activation="gelu"))
            .layer(OutputLayer(n_in=64, n_out=8)).build())
    return MultiLayerNetwork(conf, device="cuda").init()


def _eager_forward(net, x):
    from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32
    with torch.no_grad(), full_f32():
        return net._forward(net._params, x, False)


@pytest.mark.parametrize("twin", [False, True], ids=["f32", "int8"])
def test_predict_replay_equals_eager_and_follows_fit(cuda, twin):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    net = _mlp()
    served = quantize_model(net, device="cuda") if twin else net
    eng = InferenceEngine(served, max_batch=8)
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 32)
                         .astype(np.float32)).cuda()
    try:
        eng.warmup(x[:1].cpu().numpy())
        for n in (1, 2, 4, 8):
            n0 = _fused_dequant_matmul.launches
            got = eng.infer(x[:n]).torch()
            # the twin's 2 quantized products, counted on replay
            assert _fused_dequant_matmul.launches - n0 == (2 if twin else 0)
            assert torch.equal(got, _eager_forward(served, x[:n])), n
        assert {g["cache"] for g in eng.stats()["graphs"]} == {"captured"}
        if not twin:
            y = torch.eye(8)[np.random.RandomState(2).randint(0, 8, 8)]
            net.fit(DataSet(x.cpu().numpy(), y.numpy()))
            got = eng.infer(x[:4]).torch()
            assert torch.equal(got, _eager_forward(net, x[:4]))
    finally:
        eng.close()


def test_two_engines_capture_on_two_threads(cuda):
    models = [_model(seed=s) for s in (0, 1)]
    out, errors = {}, []

    def run(i):
        try:
            out[i] = _serve(models[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in (0, 1):
        tokens, stats = out[i]
        assert {g["cache"] for g in stats["graphs"]} == {"captured"}
        assert tokens == _serve(models[i], eager=True)[0]


def _serve_rounds(model, eager=False, **kw):
    """Tokens of two rounds of four requests of 140-190 tokens: the
    first with two sampled riders (every step a plain decode step), the
    second greedy (verify steps); and the engine's stats."""
    eng = DecodeEngine(model, device="cuda", seed=0, **kw)
    if eager:
        eng._eager_reason = "check"
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V, n).astype(np.int32)
               for n in (150, 170, 190, 140)]
    try:
        eng.warmup()
        tokens = []
        for sampled in (True, False):
            futs = [eng.generate(p, max_tokens=12, temperature=0.9
                                 if sampled and i % 2 else 0.0)
                    for i, p in enumerate(prompts)]
            tokens.append([f.result(timeout=120)["tokens"] for f in futs])
        return tokens, eng.stats()
    finally:
        eng.close(30)


def test_decode_replays_after_the_verify_step_grew_the_counters(cuda):
    """The paged kernel's merge counters (slots x heads x query rows
    entries, used where a slot's rows span more than one split of 128)
    come from one buffer a stream, 1024 entries at first. Here warmup
    captures the decode step (64 x 4 x 1 = 256 entries) on it, and then
    the verify step (64 x 4 x 5 = 1280) needs a larger one: the decode
    graph goes on replaying on the buffer it captured, which must stay
    allocated and zeroed. Its tokens over contexts of 140-200 rows equal
    the eager engine's, and so do the verify steps'."""
    model = _model()
    draft = CausalLM(
        CausalLMConfig(**{**model.config.__dict__, "num_layers": 1}),
        params={"embeddings": model.params["embeddings"],
                "layers": model.params["layers"][:1]}, device="cuda")
    kw = {"slots": 64, "max_ctx": 256, "prompt_buckets": [16, 256],
          "kv_block_size": 16, "prefill_batch": 2, "draft_model": draft,
          "spec_k": 4}
    heads = model.config.num_heads
    assert 64 * heads <= 1024 < 64 * heads * (4 + 1)
    assert split_rows() < 140
    got, stats = _serve_rounds(model, **kw)
    ref, _ = _serve_rounds(model, eager=True, **kw)
    assert got == ref
    assert {g["cache"] for g in stats["graphs"]} == {"captured"}
    assert 0 < stats["spec_steps"] < stats["decode_steps"]
