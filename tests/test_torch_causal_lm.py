"""The port's CausalLM against the JAX package's, on the same weights.

The weights come from ``deeplearning4j_tpu.models.causal_lm.init_params``
(tiny config, f32, 2 layers) and cross into the port through
``bridge.params_from_numpy``. The dense weights are scaled by 10 on both
sides first, so that the logits spread out and greedy decoding does not
repeat one token. Inputs come from ``np.random.RandomState``.

Tolerance: atol 1e-4 on logits and on the KV rows written, with argmax
identical. Both sides compute the same f32 graph; they differ only in
summation order inside matmuls, softmax and layer norm, which moves
O(10) logits by ~1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import causal_lm as jcl
from deeplearning4j_tpu.quant import transforms as jt
from deeplearning4j_tpu_torch.bridge import params_from_numpy
from deeplearning4j_tpu_torch.models import causal_lm as tcl
from deeplearning4j_tpu_torch.quant import transforms as tt

ATOL = 1e-4
WEIGHT_SCALE = 10.0
BS, MB = 8, 4           # block size, table columns: 32 rows per slot


def scaled_jax_params(seed=0, num_layers=2):
    """JAX ``init_params`` of the tiny config as numpy, with every dense
    weight (embeddings, attention, MLP) scaled by ``WEIGHT_SCALE``."""
    cfg = jcl.CausalLMConfig(**{**jcl.CausalLMConfig.tiny().__dict__,
                                "num_layers": num_layers})
    tree = jax.tree_util.tree_map(
        np.asarray, jcl.init_params(jax.random.key(seed), cfg))
    for k in ("word", "position"):
        tree["embeddings"][k] = tree["embeddings"][k] * WEIGHT_SCALE
    for layer in tree["layers"]:
        for k in ("wq", "wk", "wv", "wo"):
            layer["attn"][k] = layer["attn"][k] * WEIGHT_SCALE
        for k in ("w1", "w2"):
            layer["mlp"][k] = layer["mlp"][k] * WEIGHT_SCALE
    return cfg, tree


def model_pair(seed=0, num_layers=2):
    """(JAX CausalLM, port CausalLM on the CPU) over one set of weights."""
    jcfg, tree = scaled_jax_params(seed, num_layers)
    jm = jcl.CausalLM(jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree))
    tcfg = tcl.CausalLMConfig(**{**tcl.CausalLMConfig.tiny().__dict__,
                                 "num_layers": num_layers})
    tm = tcl.CausalLM(tcfg, params=params_from_numpy(tree, device="cpu"),
                      device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _jit(fn, config):
    """``fn(*args, config, **kw)`` jitted with the config closed over:
    one compile instead of one per eager op."""
    return jax.jit(lambda *a, **kw: fn(*a, config, **kw))


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def _same_logits(got, ref):
    _close(got, ref)
    assert (got.argmax(-1).numpy() == np.asarray(ref).argmax(-1)).all()


def _random_pool(model, num_blocks, seed):
    """A paged pool filled with unit-scale noise, as numpy (the JAX step
    takes a copy, the port's step writes its own tensors in place)."""
    rng = np.random.RandomState(seed)
    c = model.config
    shape = (num_blocks, c.num_layers, BS, c.num_heads, c.head_dim)
    return {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}


def _jax_cache(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()}


def _port_cache(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def test_forward_logits(pair):
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 97, (2, 11)).astype(np.int32)
    ref = _jit(jcl.forward, jm.config)(jm.params, jnp.asarray(ids))
    got = tm.forward(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 11, 97)
    _same_logits(got, ref)


def test_forward_with_flash_matches_jax_plain_forward(pair):
    """The port's causal flash path (the plain flash version on the CPU)
    against the JAX package's plain attention branch."""
    jm, tm = pair
    ids = np.random.RandomState(1).randint(0, 97, (2, 40)).astype(np.int32)
    ref = _jit(jcl.forward, jm.config)(jm.params, jnp.asarray(ids))
    got = tcl.forward(tm.params, torch.from_numpy(ids), tm.config,
                      use_flash=True)
    _same_logits(got, ref)


def test_slab_prefill_then_decode(pair):
    """The slab cache's prefill and one decode step over both slots."""
    jm, tm = pair
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 97, (1, 16)).astype(np.int32)
    jc, tc = jm.init_kv_cache(2, 32), tm.init_kv_cache(2, 32)
    jc, jl = _jit(jcl.prefill, jm.config)(jm.params, jc, jnp.asarray(ids),
                                          1, 9)
    tc, tl = tm.prefill(tm.params, tc, torch.from_numpy(ids), 1, 9)
    _same_logits(tl, jl)
    toks = np.asarray([5, 7], np.int32)
    lengths = np.asarray([0, 9], np.int32)
    jc, jl = _jit(jcl.decode, jm.config)(jm.params, jc, jnp.asarray(toks),
                                         jnp.asarray(lengths))
    tc, tl = tm.decode(tm.params, tc, torch.from_numpy(toks),
                       torch.from_numpy(lengths))
    _same_logits(tl, jl)
    for k in ("k", "v"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_paged_prefill(pair, warm):
    """Cold: two rows of different lengths, padding rows sent to scratch
    block 0. Warm: the rows' first block is already committed
    (``start_pos`` = 8) and only the tail is prefilled."""
    jm, tm = pair
    rng = np.random.RandomState(2)
    N = 2 * MB + 1
    pool = _random_pool(tm, N, seed=3)
    tables = np.asarray([[3, 1, 7, 0], [2, 8, 0, 0]], np.int32)
    lengths = np.asarray([19 if warm else 14, 11], np.int32)
    start = np.asarray([8, 8] if warm else [0, 0], np.int32)
    ids = np.zeros((2, 16), np.int32)
    for b in range(2):
        n = lengths[b] - start[b]
        ids[b, :n] = rng.randint(0, 97, n)
    jc, jl = _jit(jcl.paged_prefill, jm.config)(
        jm.params, _jax_cache(pool), jnp.asarray(ids), jnp.asarray(tables),
        jnp.asarray(lengths), start_pos=jnp.asarray(start))
    tc, tl = tcl.paged_prefill(tm.params, _port_cache(pool),
                               torch.from_numpy(ids),
                               torch.from_numpy(tables),
                               torch.from_numpy(lengths), tm.config,
                               start_pos=torch.from_numpy(start))
    _same_logits(tl, jl)
    for k in ("k", "v"):
        # block 0 takes the padding rows' writes on both sides, in an
        # order neither defines: compare the live blocks only
        _close(tc[k][1:], np.asarray(jc[k])[1:])


@pytest.mark.parametrize("Q", [1, 3])
def test_paged_decode(pair, Q):
    """Q=1 is the decode step, Q=3 a speculative verify; the slots hold
    an empty, an unaligned and a nearly full context."""
    jm, tm = pair
    rng = np.random.RandomState(4 + Q)
    S = 3
    N = S * MB + 1
    pool = _random_pool(tm, N, seed=5)
    tables = rng.permutation(np.arange(1, N)).reshape(S, MB).astype(np.int32)
    lengths = np.asarray([0, 13, MB * BS - Q], np.int32)
    toks = rng.randint(0, 97, (S, Q)).astype(np.int32)
    jc, jl = _jit(jcl.paged_decode, jm.config)(
        jm.params, _jax_cache(pool), jnp.asarray(tables), jnp.asarray(toks),
        jnp.asarray(lengths))
    tc, tl = tcl.paged_decode(tm.params, _port_cache(pool),
                              torch.from_numpy(tables),
                              torch.from_numpy(toks),
                              torch.from_numpy(lengths), tm.config)
    assert tuple(tl.shape) == (S, Q, 97)
    _same_logits(tl, jl)
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_paged_decode_writes_pool_in_place(pair):
    """The port writes the step's K/V into the caller's pool tensors (the
    JAX package donates the buffers instead) and returns the same dict."""
    _, tm = pair
    pool = _port_cache(_random_pool(tm, MB + 1, seed=6))
    before = pool["k"].clone()
    k_ptr = pool["k"].data_ptr()
    out, _ = tcl.paged_decode(tm.params, pool,
                              torch.arange(1, MB + 1,
                                           dtype=torch.int32)[None],
                              torch.tensor([[3]], dtype=torch.int32),
                              torch.tensor([5], dtype=torch.int32),
                              tm.config)
    assert out is pool and out["k"].data_ptr() == k_ptr
    changed = (pool["k"] != before).any(dim=(2, 3, 4)).nonzero().tolist()
    assert changed == [[1, 0], [1, 1]]   # block 1, both layers


@pytest.mark.parametrize("Q", [1, 3])
def test_int8_twin_paged_decode(pair, Q):
    """``quantize_model`` on both sides: the twin's MLP goes through
    ``dequant_matmul``'s fused branch (its plain version here), the 3-D
    attention weights and the tied head through ``dequantize`` /
    ``tied_logits``. The twins' activations are f32 on the CPU."""
    jm, tm = pair
    jtwin = jt.quantize_model(jm)
    ttwin = tt.quantize_model(tm, device="cpu")
    assert ttwin.config.dtype == torch.float32
    assert tt.precision_of_model(ttwin) == "int8"
    rng = np.random.RandomState(7)
    S = 2
    N = S * MB + 1
    pool = _random_pool(tm, N, seed=8)
    tables = np.arange(1, N).reshape(S, MB).astype(np.int32)
    lengths = np.asarray([6, 20], np.int32)
    toks = rng.randint(0, 97, (S, Q)).astype(np.int32)
    _, jl = _jit(jcl.paged_decode, jtwin.config)(
        jtwin.params, _jax_cache(pool), jnp.asarray(tables),
        jnp.asarray(toks), jnp.asarray(lengths))
    _, tl = ttwin.paged_decode(ttwin.params, _port_cache(pool),
                               torch.from_numpy(tables),
                               torch.from_numpy(toks),
                               torch.from_numpy(lengths))
    _same_logits(tl, jl)


def test_block_coords_clip_to_last_column():
    tables = torch.tensor([[4, 5, 6]], dtype=torch.int32)
    blk, off = tcl._block_coords(tables, torch.tensor([[0, 9, 17, 40]]), 8)
    assert blk.tolist() == [[4, 5, 6, 6]] and off.tolist() == [[0, 1, 1, 0]]


def test_paged_pool_layout_and_scratch_block():
    c = tcl.CausalLMConfig.tiny()
    cache = tcl.init_paged_kv_cache(c, 5, 8, device="cpu")
    assert tuple(cache["k"].shape) == (5, c.num_layers, 8, c.num_heads,
                                       c.head_dim)
    with pytest.raises(ValueError, match="scratch"):
        tcl.init_paged_kv_cache(c, 1, 8, device="cpu")


@pytest.mark.parametrize("mode", [None, "int8"])
def test_count_params_matches_jax(pair, mode):
    """``count_params`` counts a quantized leaf's q and scale, as the JAX
    package's ``tree_leaves`` does."""
    jm, tm = pair
    jp, tp = jm.params, tm.params
    if mode is not None:
        jp, tp = jt.quantize_params(jp), tt.quantize_params(tp)
    assert tcl.count_params(tp) == jcl.count_params(jp) > 0
