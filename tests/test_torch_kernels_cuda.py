"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips where there
is no CUDA device; the file imports neither JAX nor the JAX package, so
on a machine with a card it runs without them:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances, each with its reason:
- f32: the kernels and the plain versions sum the same products in
  another order; 1e-4 absolute on O(1) outputs.
- bf16 paged read: the plain version rounds the softmax probabilities to
  bf16 before the value product; the kernel keeps them in f32 at Q = 1
  and rounds them after a split-local max on its tensor-core path (Q >
  1); 3e-2 absolute covers a few bf16 ulps at O(1).
- bf16 dequant-matmul: one final rounding to bf16 on either side of an
  f32 sum; rtol 1e-2 (about two bf16 ulps) plus atol 1e-2 near 0.
- fp8 dequant-matmul on ``torch._scaled_mm`` against the f32-upcast
  plain product of the same fp8 operands: exact products summed in
  another order (Hopper's fp8 accumulator keeps fewer bits between its
  promotions to f32), one final rounding to ``x``'s dtype; rtol 1e-2 plus
  atol 1e-2 on O(1) outputs.
- flash attention, against autograd through the plain version: o, dq,
  dk and dv elementwise within an atol plus an rtol, and the error's RMS
  within a fraction of the reference's RMS (``FLASH_TOL``, reasons
  there); lse atol 1e-4.
"""
import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                              flash_attention_plain,
                                              flash_attention_with_lse,
                                              flash_attention_with_lse_plain,
                                              paged_flash_decode,
                                              paged_flash_decode_plain)
from deeplearning4j_tpu_torch.kernels import dispatch_snapshot
from deeplearning4j_tpu_torch.quant.transforms import (
    _FP8_QMAX, _fused_dequant_matmul, crossover_m, dequant_matmul,
    dequant_matmul_plain, fp8_matmul_plain, fp8_supported, quantize_tensor,
    whole_k_max_m)

pytestmark = pytest.mark.cuda

# the module (the package exports its function under the same name)
_paged = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.paged_flash_decode")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # the f32 plain versions must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(Q, dtype, device, S=4, MB=5, Bs=16, L=3, H=4, D=64,
                  seed=0):
    """Layer 1 of a [N, L, Bs, H, D] pool (a strided view), a permuted
    table with block 0 left as scratch, and lengths from empty to nearly
    full."""
    rng = np.random.RandomState(seed)
    N = S * MB + 1
    pool = {k: torch.from_numpy(rng.randn(N, L, Bs, H, D).astype(
        np.float32)).to(device, dtype) for k in "kv"}
    q = torch.from_numpy(rng.randn(S, Q, H, D).astype(np.float32)).to(
        device, dtype)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N)).reshape(
        S, MB).astype(np.int32)).to(device)
    lengths = torch.tensor([0, 7, 40, MB * Bs - Q], dtype=torch.int32,
                           device=device)
    return q, pool["k"][:, 1], pool["v"][:, 1], tables, lengths


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("Q", [1, 3])
def test_paged_flash_decode_matches_plain(cuda, dtype, atol, Q):
    args = _paged_inputs(Q, dtype, cuda)
    assert not args[1].is_contiguous()
    before = paged_flash_decode.launches
    got = paged_flash_decode(*args)
    ref = paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("Q,Bs,D", [(16, 8, 256), (2, 48, 128),
                                     (5, 16, 32)])
def test_paged_flash_decode_other_shapes(cuda, Q, Bs, D):
    """Blocks smaller and larger than the kernel's 32-row tile, and the
    largest Q and D it takes (whose shared memory passes 48 KB)."""
    args = _paged_inputs(Q, torch.float32, cuda, Bs=Bs, D=D)
    got = paged_flash_decode(*args)
    ref = paged_flash_decode_plain(*args)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def _split_boundary_inputs(Q, Bs, D, dtype, device, seed=0):
    """A table of about 320 rows (two and a half splits of the kernel's
    128), and slot lengths around every edge: empty, one row, Bs-1, Bs,
    the last query row ending exactly on the first split boundary and one
    past it, the first query row ending on it and one past it, full."""
    sr = _paged.split_rows()
    MB = -(-320 // Bs)
    C = MB * Bs
    lens = [0, 1, Bs - 1, Bs, sr - Q, sr - Q + 1, sr - 1, sr, C - Q]
    S, H, L = len(lens), 2, 2
    rng = np.random.RandomState(seed)
    N = S * MB + 1
    pool = {k: torch.from_numpy(rng.randn(N, L, Bs, H, D).astype(
        np.float32)).to(device, dtype) for k in "kv"}
    q = torch.from_numpy(rng.randn(S, Q, H, D).astype(np.float32)).to(
        device, dtype)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N)).reshape(
        S, MB).astype(np.int32)).to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, pool["k"][:, 1], pool["v"][:, 1], tables, lengths


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Q", [1, 5, 16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Bs", [8, 16, 48])
def test_paged_flash_decode_split_boundaries(cuda, Bs, D, Q, dtype, atol):
    """Split-and-merge at the lengths where a split boundary matters:
    the kernel against the plain read, and two calls bit for bit."""
    args = _split_boundary_inputs(Q, Bs, D, dtype, cuda)
    got = paged_flash_decode(*args)
    again = paged_flash_decode(*args)
    ref = paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


def test_paged_flash_decode_masks_the_scratch_block(cuda):
    q, k, v, tables, lengths = _paged_inputs(1, torch.float32, cuda)
    tables[:, 3:] = 0
    lengths = torch.clamp(lengths, max=3 * 16 - 1)
    clean = paged_flash_decode(q, k, v, tables, lengths)
    k[0], v[0] = 1e4, -1e4
    torch.testing.assert_close(paged_flash_decode(q, k, v, tables, lengths),
                               clean, atol=0, rtol=0)


def test_paged_flash_decode_refuses_what_it_cannot_run(cuda):
    q, k, v, tables, lengths = _paged_inputs(1, torch.float32, cuda)
    with pytest.raises(TypeError):
        paged_flash_decode(q.half(), k.half(), v.half(), tables, lengths)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 0.0, 1e-4), (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("M,K,N", [(1, 768, 3072), (8, 3072, 768),
                                   (33, 100, 70), (130, 256, 200)])
def test_dequant_matmul_matches_plain(cuda, dtype, rtol, atol, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    qt = quantize_tensor(0.02 * torch.randn((K, N), generator=g,
                                            device=cuda))
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(-1)
    before = _fused_dequant_matmul.launches
    got = _fused_dequant_matmul(x, qt.q, scale)
    ref = dequant_matmul_plain(x, qt.q, scale)
    torch.cuda.synchronize()
    assert _fused_dequant_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


def _resolve_m(M):
    """An M of the sweep: an int, or "x-1" / "x" / "x+1" around the
    library's split-K/tiled crossover, "w" / "w+1" around its whole-K one
    (both read from the library, so only on the card)."""
    if isinstance(M, int):
        return M
    base = whole_k_max_m() if M.startswith("w") else crossover_m()
    return base + int(M[1:] or 0)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 0.0, 1e-4), (torch.bfloat16, 1e-2, 1e-2)],
    ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", [(768, 3072), (3072, 768), (1000, 3000)])
@pytest.mark.parametrize("M", [1, 7, 8, 40, "x-1", "x", "x+1", "w", "w+1",
                               4096])
def test_dequant_matmul_both_designs(cuda, M, K, N, dtype, rtol, atol):
    """Every M of the serving path (decode 8, spec verify 40, prefill
    4096) and the M around the crossover between the split-K and the
    tiled design, at the MLP's shapes and a ragged one; two calls give
    identical bits (the split-K sums run in a fixed order)."""
    M = _resolve_m(M)
    g = torch.Generator(device=cuda).manual_seed(M * 7 + K + N)
    qt = quantize_tensor(0.02 * torch.randn((K, N), generator=g,
                                            device=cuda))
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(-1)
    before = _fused_dequant_matmul.launches
    got = _fused_dequant_matmul(x, qt.q, scale)
    again = _fused_dequant_matmul(x, qt.q, scale)
    ref = dequant_matmul_plain(x, qt.q, scale)
    torch.cuda.synchronize()
    assert _fused_dequant_matmul.launches == before + 2
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 0.0, 1e-4), (torch.bfloat16, 1e-2, 1e-2)],
    ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(128, 512, 2048), (128, 2048, 2048),
                                   (128, 2048, 64)])
def test_dequant_matmul_mlp_shapes(cuda, M, K, N, dtype, rtol, atol):
    """The shapes a layer-API MLP's int8 twin gives the kernel at B=128
    (512->2048, 2048->2048, and the 2048->64 head, which runs f32); two
    calls give identical bits."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    qt = quantize_tensor(0.02 * torch.randn((K, N), generator=g,
                                            device=cuda))
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(-1)
    before = _fused_dequant_matmul.launches
    got = _fused_dequant_matmul(x, qt.q, scale)
    again = _fused_dequant_matmul(x, qt.q, scale)
    ref = dequant_matmul_plain(x, qt.q, scale)
    torch.cuda.synchronize()
    assert _fused_dequant_matmul.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


def test_multilayer_twin_output_matches_the_cpu(cuda):
    """A MultiLayerNetwork's int8 twin on the card (f32 activations, so
    every dense layer takes the kernel's f32 route) against the same twin
    on the CPU (the plain version): 1e-4 on softmax outputs, and one
    kernel launch per dense layer."""
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.quant import QuantSpec, quantize_model
    conf = (NeuralNetConfiguration.builder().seed(0).list()
            .layer(DenseLayer(n_in=96, n_out=256, activation="gelu"))
            .layer(DenseLayer(n_in=256, n_out=256, activation="relu"))
            .layer(OutputLayer(n_in=256, n_out=10)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    spec = QuantSpec(act_dtype="float32")
    on_cpu = quantize_model(net, spec, device="cpu")
    on_card = quantize_model(net, spec, device=cuda)
    x = np.random.RandomState(0).randn(128, 96).astype(np.float32)
    before = _fused_dequant_matmul.launches
    got = on_card.output(x).numpy()
    assert _fused_dequant_matmul.launches == before + 3
    np.testing.assert_allclose(got, on_cpu.output(x).numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("K,N,dtype,rtol,atol", [
    (512, 2048, torch.bfloat16, 1e-2, 1e-2),
    (2048, 2048, torch.bfloat16, 1e-2, 1e-2),
    (2048, 64, torch.float32, 0.0, 1e-4)],
    ids=["512x2048_bf16", "2048x2048_bf16", "2048x64_f32"])
@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 32, 64, 128])
def test_dequant_matmul_predict_ladder(cuda, M, K, N, dtype, rtol, atol):
    """Every rung of the predict path's bucket ladder (max_batch 128) at
    the quantized MLP twin's three shapes, in the twin's dtypes (bf16
    body, f32 head); two calls give identical bits."""
    g = torch.Generator(device=cuda).manual_seed(M * 3 + K + N)
    qt = quantize_tensor(0.02 * torch.randn((K, N), generator=g,
                                            device=cuda))
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(-1)
    before = _fused_dequant_matmul.launches
    got = _fused_dequant_matmul(x, qt.q, scale)
    again = _fused_dequant_matmul(x, qt.q, scale)
    ref = dequant_matmul_plain(x, qt.q, scale)
    torch.cuda.synchronize()
    assert _fused_dequant_matmul.launches == before + 2
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


def test_inference_engine_serves_a_twin_on_the_card(cuda):
    """The micro-batcher over an int8 twin on the card: each dispatch
    launches the kernel once per dense layer, futures resolve on the
    host, and the rows agree with the same twin on the CPU (1e-4 on
    softmax outputs, the f32 route)."""
    import threading
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.quant import QuantSpec, quantize_model
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_in=96, n_out=256, activation="gelu"))
            .layer(OutputLayer(n_in=256, n_out=10)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    spec = QuantSpec(act_dtype="float32")
    on_cpu = quantize_model(net, spec, device="cpu")
    eng = InferenceEngine(quantize_model(net, spec, device=cuda),
                          max_batch=16, max_delay_ms=5.0)
    eng.warmup(np.zeros((1, 96), np.float32))
    xs = [np.random.RandomState(i).randn(1 + i % 4, 96).astype(np.float32)
          for i in range(12)]
    outs = [None] * len(xs)
    before = _fused_dequant_matmul.launches
    d0 = eng.stats()["dispatches"]

    def client(i):
        outs[i] = eng.submit(xs[i]).result(timeout=60)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    dispatches = eng.stats()["dispatches"] - d0
    assert _fused_dequant_matmul.launches - before == 2 * dispatches
    for x, out in zip(xs, outs):
        assert out.torch().device.type == "cpu"
        np.testing.assert_allclose(out.numpy(), on_cpu.output(x).numpy(),
                                   atol=1e-4, rtol=0)
    eng.close()


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 0.0, 1e-4), (torch.bfloat16, 1e-2, 1e-2)],
    ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 8, 16, 128])
def test_dequant_matmul_resnet50_head(cuda, M, dtype, rtol, atol):
    """ResNet-50's 2048->1000 head (N % 16 != 0: the unaligned loads and
    a ragged last column tile) at rungs of the predict ladder; the twin
    runs it f32, the bf16 route is held too; two calls give identical
    bits."""
    g = torch.Generator(device=cuda).manual_seed(M + 1000)
    qt = quantize_tensor(0.02 * torch.randn((2048, 1000), generator=g,
                                            device=cuda))
    x = torch.randn((M, 2048), generator=g, device=cuda).to(dtype)
    scale = qt.scale.reshape(-1)
    before = _fused_dequant_matmul.launches
    got = _fused_dequant_matmul(x, qt.q, scale)
    again = _fused_dequant_matmul(x, qt.q, scale)
    ref = dequant_matmul_plain(x, qt.q, scale)
    torch.cuda.synchronize()
    assert _fused_dequant_matmul.launches == before + 2
    assert got.dtype == dtype and got.shape == (M, 1000)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


def test_resnet50_twin_output_matches_the_cpu(cuda):
    """The full-width ResNet-50's int8 twin on the card (f32 activations:
    cuDNN convolutions over the dequantized 4-D weights, the head through
    the kernel's f32 route, one launch an output()) against the same twin
    on the CPU (the plain version) at B=4: 1e-4 on softmax outputs."""
    from deeplearning4j_tpu_torch.quant import QuantSpec, quantize_model
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50().init_model(device="cpu")
    spec = QuantSpec(act_dtype="float32")
    on_cpu = quantize_model(net, spec, device="cpu")
    on_card = quantize_model(net, spec, device=cuda)
    x = np.random.RandomState(0).randn(4, 3, 224, 224).astype(np.float32)
    before = _fused_dequant_matmul.launches
    got = on_card.output(x)
    assert _fused_dequant_matmul.launches == before + 1
    assert len(got) == 1 and got[0].shape == (4, 1000)
    np.testing.assert_allclose(got[0].numpy(), on_cpu.output(x)[0].numpy(),
                               atol=1e-4, rtol=0)


def test_dequant_matmul_refuses_what_it_cannot_run(cuda):
    qt = quantize_tensor(torch.randn((64, 32), device=cuda))
    with pytest.raises(TypeError):
        _fused_dequant_matmul(torch.randn((4, 64), device=cuda).half(),
                              qt.q, qt.scale.reshape(-1))


# -- flash attention: forward, dq and dk/dv kernels --------------------------

# the module (the package exports its function under the same name)
_flash = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")
# (atol, rtol, relative RMS) per dtype, for o, dq, dk and dv alike. f32:
# the same f32 sums in another order (FMA tiles, no TF32). bf16: the
# kernels round p and ds to bf16 before their products, as the Pallas
# kernels do, where the plain version keeps them f32, and each result is
# rounded once to bf16: rtol 1e-2 is about two bf16 ulps, atol 3e-2
# covers entries near 0 (inputs of unit scale). The error's RMS over the
# whole tensor must also stay under the last number times the reference's
# RMS, which a systematic error on some rows would break.
FLASH_TOL = {torch.float32: (2e-4, 1e-4, 1e-4),
             torch.bfloat16: (3e-2, 1e-2, 2e-2)}


def _flash_inputs(B, S, H, D, dtype, device, masked=False, seed=0):
    """q, k, v [B, S, H, D], a cotangent g, and a key mask whose last
    batch row hides its tail (None when not ``masked``)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, S, H, D).astype(
        np.float32)).to(device, dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.ones((B, S), dtype=torch.int32, device=device)
        mask[-1, S * 2 // 3:] = 0
    return q, k, v, g, mask


def _flash_grads(fn, q, k, v, g, **kw):
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*ts, **kw)
    dq, dk, dv = torch.autograd.grad(o, ts, g)
    return o.detach(), dq, dk, dv


def _assert_flash_close(got, ref, tol):
    atol, rtol, rel_rms = tol
    assert got.dtype == ref.dtype and torch.isfinite(got).all()
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    err_rms = (got - ref).pow(2).mean().sqrt().item()
    assert err_rms <= rel_rms * ref.pow(2).mean().sqrt().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,D,causal,masked", [
    (2, 128, 3, 64, False, False),    # BERT's tile shape
    (2, 128, 3, 64, False, True),
    (2, 200, 2, 64, True, False),     # odd S, causal
    (1, 77, 2, 32, True, True),       # causal and masked together
    (2, 150, 2, 128, False, True),
    (1, 64, 2, 8, False, False),      # the narrowest head it takes
])
def test_flash_attention_matches_plain(cuda, dtype, B, S, H, D, causal,
                                       masked):
    q, k, v, g, mask = _flash_inputs(B, S, H, D, dtype, cuda, masked)
    counts = [f.launches for f in (_flash._flash_fwd, _flash._flash_bwd_dq,
                                   _flash._flash_bwd_dkv)]
    got = _flash_grads(flash_attention, q, k, v, g, mask=mask,
                       causal=causal)
    torch.cuda.synchronize()
    assert [f.launches for f in (_flash._flash_fwd, _flash._flash_bwd_dq,
                                 _flash._flash_bwd_dkv)] == \
        [n + 1 for n in counts]
    ref = _flash_grads(flash_attention_plain, q, k, v, g, mask=mask,
                       causal=causal)
    for a, b in zip(got, ref):
        _assert_flash_close(a, b, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_with_lse_matches_plain(cuda, dtype):
    """lse itself, and a loss that reads it (the lse cotangent)."""
    q, k, v, g, mask = _flash_inputs(2, 100, 2, 64, dtype, cuda, True)
    w = torch.randn((2, 2, 100), device=cuda)
    res = []
    for fn in (flash_attention_with_lse, flash_attention_with_lse_plain):
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = fn(*ts, mask=mask)
        loss = (o.float() * g.float()).sum() + (lse * w).sum()
        res.append((o.detach(), lse.detach()) + torch.autograd.grad(
            loss, ts))
    _assert_flash_close(res[0][0], res[1][0], FLASH_TOL[dtype])
    torch.testing.assert_close(res[0][1], res[1][1], atol=1e-4, rtol=0)
    for a, b in zip(res[0][2:], res[1][2:]):
        _assert_flash_close(a, b, FLASH_TOL[dtype])


def test_flash_attention_fully_masked_row(cuda):
    """A batch row with no visible key: the uniform softmax over all S
    keys forward, and the masked softmax's gradient backward."""
    q, k, v, g, _ = _flash_inputs(2, 96, 2, 32, torch.float32, cuda)
    mask = torch.ones((2, 96), dtype=torch.int32, device=cuda)
    mask[1] = 0
    got = _flash_grads(flash_attention, q, k, v, g, mask=mask)
    ref = _flash_grads(flash_attention_plain, q, k, v, g, mask=mask)
    torch.testing.assert_close(got[0][1], v[1].mean(0).expand(96, 2, 32),
                               atol=1e-4, rtol=0)
    for a, b in zip(got, ref):
        _assert_flash_close(a, b, FLASH_TOL[torch.float32])


def test_flash_attention_takes_strided_inputs(cuda):
    """q, k, v as views of one packed [B, S, H, 3D] projection (strided,
    d-stride 1): no copy is made and the result matches the plain one."""
    qkv = torch.randn((2, 130, 4, 3 * 64), device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    _assert_flash_close(got, ref, FLASH_TOL[torch.bfloat16])


def test_flash_attention_refuses_what_it_cannot_run(cuda):
    q, k, v, _, _ = _flash_inputs(1, 16, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                  # D not a multiple of 8
        flash_attention(q[..., :60], k[..., :60], v[..., :60])
    wide = torch.zeros((1, 16, 1, 136), device=cuda)
    with pytest.raises(ValueError):                  # D over 128
        flash_attention(wide, wide, wide)
    step2 = torch.zeros((1, 16, 2, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError):                  # D stride not 1
        flash_attention(step2, step2, step2)


def _flash_lse_grads(fn, q, k, v, g, w, **kw):
    """(o, lse, dq, dk, dv) of ``fn`` under the loss sum(o * g) +
    sum(lse * w): a cotangent for o and one for lse."""
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fn(*ts, **kw)
    loss = (o.float() * g.float()).sum() + (lse * w).sum()
    return (o.detach(), lse.detach()) + torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("D", [8, 24, 64, 128])
@pytest.mark.parametrize("S", [1, 15, 17, 65, 129, 513])
def test_flash_backward_bf16_ragged_edges(cuda, S, D):
    """S that straddles a 16-row fragment or a 64-row tile, D that is
    zero-padded to k16 (8, 24) or fills it (64, 128), with a key mask.
    The loss also reads lse, so that at S = 1, where p = 1 and dq and dk
    are 0 in exact arithmetic, the lse cotangent makes them nonzero."""
    q, k, v, g, mask = _flash_inputs(2, S, 2, D, torch.bfloat16, cuda,
                                     masked=S > 1)
    w = torch.from_numpy(np.random.RandomState(1).randn(2, 2, S).astype(
        np.float32)).to(cuda)
    got = _flash_lse_grads(flash_attention_with_lse, q, k, v, g, w,
                           mask=mask)
    ref = _flash_lse_grads(flash_attention_with_lse_plain, q, k, v, g, w,
                           mask=mask)
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
    for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
        _assert_flash_close(a, b, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("S,D", [(17, 64), (65, 24), (200, 64),
                                 (129, 128)])
def test_flash_backward_bf16_causal(cuda, S, D, masked):
    """Causal without a key mask (the kernels skip the tiles past the
    diagonal) and with one (they walk every tile)."""
    q, k, v, g, mask = _flash_inputs(2, S, 2, D, torch.bfloat16, cuda,
                                     masked)
    got = _flash_grads(flash_attention, q, k, v, g, mask=mask, causal=True)
    ref = _flash_grads(flash_attention_plain, q, k, v, g, mask=mask,
                       causal=True)
    for a, b in zip(got, ref):
        _assert_flash_close(a, b, FLASH_TOL[torch.bfloat16])


def test_flash_backward_bf16_fully_masked_row(cuda):
    """A batch row with no visible key, in bf16: its dq and dk are 0 and
    its dv is g averaged over the S queries, as the plain gradient."""
    q, k, v, g, _ = _flash_inputs(2, 96, 2, 64, torch.bfloat16, cuda)
    mask = torch.ones((2, 96), dtype=torch.int32, device=cuda)
    mask[1] = 0
    got = _flash_grads(flash_attention, q, k, v, g, mask=mask)
    ref = _flash_grads(flash_attention_plain, q, k, v, g, mask=mask)
    assert not got[1][1].any() and not got[2][1].any()
    for a, b in zip(got, ref):
        _assert_flash_close(a, b, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_bf16_lse_cotangent(cuda, causal):
    """A loss that reads lse at a ragged S and a padded D: the cotangent
    folds into the delta the dq kernel computes."""
    q, k, v, g, mask = _flash_inputs(2, 129, 2, 24, torch.bfloat16, cuda,
                                     True)
    w = torch.randn((2, 2, 129), device=cuda)
    got = _flash_lse_grads(flash_attention_with_lse, q, k, v, g, w,
                           mask=mask, causal=causal)
    ref = _flash_lse_grads(flash_attention_with_lse_plain, q, k, v, g, w,
                           mask=mask, causal=causal)
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
    for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
        _assert_flash_close(a, b, FLASH_TOL[torch.bfloat16])


def test_flash_backward_bf16_unaligned_views(cuda):
    """q, k, v and the cotangent as views whose base is 2 bytes past a
    16-byte boundary: the wrapper copies them for the backward's 16-byte
    cp.async loads, and the result matches the plain one."""
    B, S, H, D = 2, 77, 2, 64
    n = B * S * H * D

    def unaligned(seed):
        buf = torch.from_numpy(np.random.RandomState(seed).randn(
            n + 1).astype(np.float32)).to(cuda, torch.bfloat16)
        t = buf[1:].view(B, S, H, D)
        assert t.data_ptr() % 16 != 0
        return t
    q, k, v, g = (unaligned(s) for s in range(4))
    got = _flash_grads(flash_attention, q, k, v, g)
    ref = _flash_grads(flash_attention_plain, q, k, v, g)
    for a, b in zip(got, ref):
        _assert_flash_close(a, b, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_same_bits_twice(cuda, dtype):
    """No float atomics and sums in a fixed order: two calls give the
    same dq, dk and dv bits."""
    q, k, v, g, mask = _flash_inputs(2, 300, 3, 64, dtype, cuda, True)
    first = _flash_grads(flash_attention, q, k, v, g, mask=mask)
    again = _flash_grads(flash_attention, q, k, v, g, mask=mask)
    for a, b in zip(first[1:], again[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_forward_same_bits_twice(cuda, dtype):
    """Every output has one writer and sums run in a fixed order: two
    forward calls give the same o and lse bits."""
    q, k, v, _, mask = _flash_inputs(2, 300, 3, 64, dtype, cuda, True)
    with torch.no_grad():
        first = flash_attention_with_lse(q, k, v, mask=mask)
        again = flash_attention_with_lse(q, k, v, mask=mask)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _flash_forward_close(q, k, v, **kw):
    """o within ``FLASH_TOL`` of the plain version, lse within 1e-4."""
    with torch.no_grad():
        got = flash_attention_with_lse(q, k, v, **kw)
        ref = flash_attention_with_lse_plain(q, k, v, **kw)
    _assert_flash_close(got[0], ref[0], FLASH_TOL[q.dtype])
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
    return got


def test_flash_forward_bf16_leading_masked_keys(cuda):
    """A row whose mask hides keys [0, 64), a whole key tile, and shows
    the rest: p = 1 over the hidden tile until the first visible one
    resets it through alpha = exp(-1e30 - m) = 0."""
    q, k, v, _, _ = _flash_inputs(2, 200, 2, 64, torch.bfloat16, cuda)
    mask = torch.ones((2, 200), dtype=torch.int32, device=cuda)
    mask[1, :64] = 0
    _flash_forward_close(q, k, v, mask=mask)


def test_flash_forward_bf16_fully_masked_row(cuda):
    """A batch row with no visible key: o is v's mean over all S keys
    (nothing padded) and lse is at or below the backward's fully-masked
    mark, -5e29."""
    q, k, v, _, _ = _flash_inputs(2, 150, 2, 64, torch.bfloat16, cuda)
    mask = torch.ones((2, 150), dtype=torch.int32, device=cuda)
    mask[1] = 0
    o, lse = _flash_forward_close(q, k, v, mask=mask)
    mean = v[1].float().mean(0).expand(150, 2, 64).to(torch.bfloat16)
    _assert_flash_close(o[1], mean, FLASH_TOL[torch.bfloat16])
    assert (lse[1] <= -5e29).all() and (lse[0] > -5e29).all()


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_flash_forward_bf16_causal_long(cuda, masked):
    """Causal at T = 1024: without a key mask the kernel stops at the
    diagonal tile and a warp skips the tiles after its rows; with one it
    walks every tile."""
    q, k, v, _, mask = _flash_inputs(1, 1024, 2, 64, torch.bfloat16, cuda,
                                     masked)
    _flash_forward_close(q, k, v, mask=mask, causal=True)


def test_flash_forward_bf16_unaligned_views(cuda):
    """q, k and v as views whose base is 2 bytes past a 16-byte boundary:
    the wrapper copies them for the forward's 16-byte cp.async loads, and
    o and lse match the plain ones."""
    B, S, H, D = 2, 77, 2, 64
    n = B * S * H * D

    def unaligned(seed):
        buf = torch.from_numpy(np.random.RandomState(seed).randn(
            n + 1).astype(np.float32)).to(cuda, torch.bfloat16)
        t = buf[1:].view(B, S, H, D)
        assert t.data_ptr() % 16 != 0
        return t
    q, k, v = (unaligned(s) for s in range(3))
    _flash_forward_close(q, k, v)


@pytest.mark.parametrize("scale", [0.3, -0.2], ids=["pos", "neg"])
def test_flash_forward_bf16_explicit_scale(cuda, scale):
    """A caller's scale multiplies the f32 scores: a positive one takes the
    whole-tile path (raw max, then scaled), a negative one the masked
    path, where the max is taken on the scaled scores."""
    q, k, v, _, mask = _flash_inputs(2, 130, 2, 64, torch.bfloat16, cuda,
                                     True)
    _flash_forward_close(q, k, v, mask=mask, scale=scale)


# -- the fp8 branch of dequant_matmul (torch._scaled_mm) --------------------

def _fp8_case(device, M, K, N, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = (0.02 * torch.randn((K, N), generator=g)).to(device)
    x = torch.randn((M, K), generator=g).to(device=device, dtype=dtype)
    return x, quantize_tensor(w, mode="fp8")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(1, 768, 3072), (8, 768, 3072),
                                   (40, 3072, 768), (4096, 768, 3072)])
def test_fp8_dequant_matmul_matches_plain(cuda, dtype, M, K, N):
    assert fp8_supported(cuda)
    x, w = _fp8_case(cuda, M, K, N, dtype)
    assert w.q.stride() == (1, K)           # laid out for _scaled_mm
    got = dequant_matmul(x, w)
    assert dispatch_snapshot()["dequant_matmul_fp8"]["path"] == "scaled_mm"
    sx = torch.clamp_min(x.abs().amax(), 1e-12) / _FP8_QMAX
    xq = (x / sx).to(torch.float8_e4m3fn)
    ref = fp8_matmul_plain(xq, w.q, sx, w.scale.reshape(-1)).to(dtype)
    assert got.dtype == dtype and got.shape == (M, N)
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


def test_fp8_dequant_matmul_3d_activation(cuda):
    x, w = _fp8_case(cuda, 24, 768, 3072, torch.bfloat16, seed=1)
    got = dequant_matmul(x.reshape(2, 12, 768), w)
    torch.testing.assert_close(got.reshape(24, 3072), dequant_matmul(x, w))


def test_fp8_unaligned_shape_takes_the_stated_plain_route(cuda):
    """K or N off _scaled_mm's 16-granularity: the f32-upcast product on
    the card, with the reason in the dispatch record."""
    x, w = _fp8_case(cuda, 8, 100, 48, torch.bfloat16, seed=2)
    got = dequant_matmul(x, w)
    rec = dispatch_snapshot()["dequant_matmul_fp8"]
    assert rec["path"] == "plain" and "K=100" in rec["reason"]
    assert got.is_cuda and got.shape == (8, 48)


def test_fp8_quantize_on_the_card_matches_the_cpu(cuda):
    """The f32 -> float8_e4m3fn cast rounds the same on the card as on
    the CPU (where the tests hold it bit-exact against JAX)."""
    w = 0.02 * torch.randn((768, 3072),
                           generator=torch.Generator().manual_seed(3))
    on_card = quantize_tensor(w.to(cuda), mode="fp8")
    on_cpu = quantize_tensor(w, mode="fp8")
    assert torch.equal(on_card.q.cpu().contiguous().view(torch.uint8),
                       on_cpu.q.contiguous().view(torch.uint8))
    torch.testing.assert_close(on_card.scale.cpu(), on_cpu.scale,
                               rtol=1e-6, atol=0)
