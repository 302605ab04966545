"""The port's ``quant/`` against the JAX package's: int8 and fp8
quantization and the dequantizing ops, the params bridge, the footprint
helpers, ``QuantSpec`` / ``calibrate`` and the divergence gate, the
quantized tiny CausalLM twins, and the int8 twin of a layer-API network
(``TestQuantizedMLN``).

Inputs come from numpy with a seed. Tolerances:
- ``q`` is compared bit for bit (int8 as is, fp8 through a ``uint8``
  view): both round half to even after the same f32 division (the fp8
  cast rounds to nearest even on both sides);
- scales at rtol 1e-6 (the same f32 ops; the bound only allows for a
  differently ordered max reduction, which is exact anyway);
- the fused dequant-matmul (plain version here) against the JAX Pallas
  kernel in interpret mode at atol 1e-5 in f32: both sum the same exact
  products in f32, in another order, over K <= 256 with O(1) terms;
- the fp8 dequant-matmul against the JAX fp8 branch at atol 1e-4 in f32:
  the same fp8 operands (bit-identical casts), exact products summed in
  f32 in another order, over K <= 256 with O(10) sums;
- calibrated ranges at rtol 1e-4 and divergence reports at atol 1e-4:
  f32 forwards of the same weights, which differ by ~1e-5 in the logits;
- twin logits at atol 1e-4, as the full-precision logits in
  ``test_torch_causal_lm.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.quant as jquant
from deeplearning4j_tpu.models import causal_lm as jax_causal_lm
from deeplearning4j_tpu.quant import transforms as jt
import deeplearning4j_tpu_torch.quant as tquant
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common.environment import environment
from deeplearning4j_tpu_torch.common.metrics import registry
from deeplearning4j_tpu_torch.models import causal_lm as tcl
from deeplearning4j_tpu_torch.quant import transforms as tt
from test_torch_causal_lm import model_pair


def _w(shape, seed=0, scale=0.05):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


class TestQuantizeTensor:
    @pytest.mark.parametrize("shape,axes", [
        ((64, 48), None),          # per-output-channel, x @ W weight
        ((16, 4, 8), None),        # 3-D attention projection
        ((97, 32), (1,)),          # per-row, an embedding table
    ])
    def test_matches_jax(self, shape, axes):
        w = _w(shape, seed=len(shape))
        ref = jt.quantize_tensor(jnp.asarray(w), axes=axes)
        got = tt.quantize_tensor(torch.from_numpy(w), axes=axes)
        assert got.q.dtype == torch.int8
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                                   rtol=1e-6)
        assert got.orig_dtype == ref.orig_dtype == "float32"

    def test_round_half_to_even_ties(self):
        """Values exactly halfway between two int8 steps round to even on
        both sides."""
        w = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]],
                       np.float32).T  # scale 1 per column of one
        ref = jt.quantize_tensor(jnp.asarray(w), axes=(0,))
        got = tt.quantize_tensor(torch.from_numpy(w), axes=(0,))
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))

    @pytest.mark.parametrize("shape,axes", [
        ((64, 48), None), ((16, 4, 8), None), ((97, 32), (1,))])
    def test_fp8_matches_jax(self, shape, axes):
        w = _w(shape, seed=3 + len(shape))
        ref = jt.quantize_tensor(jnp.asarray(w), axes=axes, mode="fp8")
        got = tt.quantize_tensor(torch.from_numpy(w), axes=axes, mode="fp8")
        assert got.q.dtype == torch.float8_e4m3fn and got.mode == "fp8"
        np.testing.assert_array_equal(
            got.q.contiguous().view(torch.uint8).numpy(),
            np.asarray(ref.q).view(np.uint8))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                                   rtol=1e-6)

    def test_fp8_weight_is_laid_out_for_scaled_mm(self):
        """A per-output-channel 2-D fp8 payload is column-major (what
        ``torch._scaled_mm`` takes as its second operand); an embedding
        table keeps its rows contiguous."""
        w = torch.from_numpy(_w((64, 48)))
        assert tt.quantize_tensor(w, mode="fp8").q.stride() == (1, 64)
        assert tt.quantize_tensor(w, axes=(1,), mode="fp8").q.stride() \
            == (48, 1)

    def test_fp8_layout_is_made_by_the_constructor(self):
        """Whoever builds the weight, a row-major per-output-channel fp8
        payload comes out column-major, with the same values."""
        q = torch.from_numpy(_w((32, 16))).to(torch.float8_e4m3fn)
        w = tt.QuantizedTensor(q, torch.ones((1, 16)))
        assert w.q.stride() == (1, 32)
        np.testing.assert_array_equal(w.q.contiguous().view(torch.uint8),
                                      q.view(torch.uint8))
        assert w.to("cpu").q.stride() == (1, 32)
        per_row = tt.QuantizedTensor(q, torch.ones((32, 1)))
        assert per_row.q.stride() == (16, 1)

    def test_fp8_supported_on_the_cpu(self):
        assert tt.fp8_supported("cpu") == jt.fp8_supported() is True

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="int8"):
            tt.quantize_tensor(torch.ones(4, 4), mode="int4")

    def test_astype_is_a_noop(self):
        qt = tt.quantize_tensor(torch.from_numpy(_w((8, 8))))
        assert qt.astype(torch.bfloat16) is qt


class TestDequantOps:
    @pytest.mark.parametrize("M,K,N", [(5, 256, 128), (8, 128, 256)])
    def test_plain_matches_jax_fused_kernel_interpret(self, M, K, N):
        w = jt.quantize_tensor(jnp.asarray(_w((K, N), seed=1)))
        x = np.random.RandomState(2).randn(M, K).astype(np.float32)
        ref = np.asarray(jt._fused_dequant_matmul(
            jnp.asarray(x), w.q, w.scale.reshape(-1), True))
        got = tt.dequant_matmul_plain(
            torch.from_numpy(x), torch.from_numpy(np.array(w.q)),
            torch.from_numpy(np.array(w.scale).reshape(-1)))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    def test_dequant_matmul_3d_activation_and_dispatch_record(self):
        """Leading dims flatten through the fused branch; a CPU tensor
        takes the plain path and says why."""
        from deeplearning4j_tpu_torch.kernels import dispatch_snapshot
        w = _w((64, 32), seed=3)
        x = np.random.RandomState(4).randn(2, 3, 64).astype(np.float32)
        ref = np.asarray(jt.dequant_matmul(
            jnp.asarray(x), jt.quantize_tensor(jnp.asarray(w))))
        fam = registry().counter(
            "dl4j_kernel_dispatch_total",
            "Hand-written-kernel vs plain-version path decisions per "
            "kernel family, one per call", labels=("kernel", "path"))
        before = fam.labels(kernel="dequant_matmul", path="plain").value()
        got = tt.dequant_matmul(torch.from_numpy(x),
                                tt.quantize_tensor(torch.from_numpy(w)))
        assert got.shape == (2, 3, 32)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
        assert fam.labels(kernel="dequant_matmul",
                          path="plain").value() == before + 1
        from deeplearning4j_tpu_torch.kernels import dispatch_snapshot
        snap = dispatch_snapshot()["dequant_matmul"]
        assert snap["path"] == "plain" and "cpu" in snap["reason"]

    @pytest.mark.parametrize("x_shape,K,N", [
        ((5, 256), 256, 128), ((2, 3, 64), 64, 48)])
    def test_fp8_matches_jax_fp8_branch(self, x_shape, K, N):
        w = _w((K, N), seed=12)
        x = np.random.RandomState(13).randn(*x_shape).astype(np.float32)
        ref = jt.dequant_matmul(jnp.asarray(x), jt.quantize_tensor(
            jnp.asarray(w), mode="fp8"))
        tq = tt.quantize_tensor(torch.from_numpy(w), mode="fp8")
        got = tt.dequant_matmul(torch.from_numpy(x), tq)
        assert got.dtype == torch.float32 and got.shape == x_shape[:-1] + (N,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)

    def test_fp8_plain_route_is_recorded_with_its_reason(self):
        tq = tt.quantize_tensor(torch.from_numpy(_w((32, 16))), mode="fp8")
        fam = registry().counter(
            "dl4j_kernel_dispatch_total", labels=("kernel", "path"))
        before = fam.labels(kernel="dequant_matmul_fp8", path="plain").value()
        tt.dequant_matmul(torch.ones(2, 32), tq)
        assert fam.labels(kernel="dequant_matmul_fp8",
                          path="plain").value() == before + 1
        from deeplearning4j_tpu_torch.kernels import dispatch_snapshot
        assert "cpu tensor" in dispatch_snapshot()["dequant_matmul_fp8"][
            "reason"]
        xq = torch.ones(4, 32).to(torch.float8_e4m3fn)
        assert tt._fp8_route(xq, tq.q)[0] == "plain"

    def test_fp8_take_rows_and_tied_logits_match_jax(self):
        table = _w((97, 32), seed=14)
        jq = jt.quantize_tensor(jnp.asarray(table), axes=(1,), mode="fp8")
        tq = tt.quantize_tensor(torch.from_numpy(table), axes=(1,),
                                mode="fp8")
        ids = np.asarray([[0, 5, 96], [3, 3, 1]], np.int32)
        np.testing.assert_allclose(
            tt.take_rows(tq, torch.from_numpy(ids)).numpy(),
            np.asarray(jt.take_rows(jq, jnp.asarray(ids))), atol=1e-6,
            rtol=0)
        h = np.random.RandomState(15).randn(2, 32).astype(np.float32)
        np.testing.assert_allclose(
            tt.tied_logits(torch.from_numpy(h), tq).numpy(),
            np.asarray(jt.tied_logits(jnp.asarray(h), jq)), atol=1e-5,
            rtol=0)

    def test_plain_weight_passes_through(self):
        w = torch.from_numpy(_w((16, 8), seed=5))
        x = torch.from_numpy(_w((4, 16), seed=6, scale=1.0))
        torch.testing.assert_close(tt.dequant_matmul(x, w), x @ w)

    def test_dequantize_matches_jax(self):
        w = _w((24, 12), seed=7)
        ref = jt.dequantize(jt.quantize_tensor(jnp.asarray(w)))
        got = tt.dequantize(tt.quantize_tensor(torch.from_numpy(w)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_take_rows_and_tied_logits_match_jax(self):
        table = _w((97, 32), seed=8)
        ids = np.asarray([[0, 5, 96], [3, 3, 40]], np.int32)
        h = np.random.RandomState(9).randn(2, 3, 32).astype(np.float32)
        jq = jt.quantize_tensor(jnp.asarray(table), axes=(1,))
        tq = tt.quantize_tensor(torch.from_numpy(table), axes=(1,))
        np.testing.assert_array_equal(
            tt.take_rows(tq, torch.from_numpy(ids)).numpy(),
            np.asarray(jt.take_rows(jq, jnp.asarray(ids))))
        np.testing.assert_allclose(
            tt.tied_logits(torch.from_numpy(h), tq).numpy(),
            np.asarray(jt.tied_logits(jnp.asarray(h), jq)),
            atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_causal_lm.CausalLMConfig.tiny()
    return jax_causal_lm.init_params(jax.random.key(0), cfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class TestQuantizeParams:
    def test_same_leaves_quantized_as_jax(self, jax_params):
        ref = jt.quantize_params(jax_params)
        got = tt.quantize_params(bridge.params_from_numpy(
            _np_tree(jax_params), device="cpu"))

        def walk(r, g, path):
            if isinstance(r, dict):
                assert set(r) == set(g)
                for k in r:
                    walk(r[k], g[k], path + (k,))
            elif isinstance(r, list):
                for i, (a, b) in enumerate(zip(r, g)):
                    walk(a, b, path + (str(i),))
            elif isinstance(r, jt.QuantizedTensor):
                assert isinstance(g, tt.QuantizedTensor), path
                np.testing.assert_array_equal(g.q.numpy(), np.asarray(r.q))
                assert tuple(g.scale.shape) == tuple(r.scale.shape), path
            else:
                assert not isinstance(g, tt.QuantizedTensor), path
        walk(ref, got, ())
        emb = got["embeddings"]
        assert isinstance(emb["word"], tt.QuantizedTensor)
        assert tuple(emb["word"].scale.shape) == (97, 1)   # per row
        assert not isinstance(emb["position"], tt.QuantizedTensor)
        w1 = got["layers"][0]["mlp"]["w1"]
        assert tuple(w1.scale.shape) == (1, 128)          # per channel
        assert tt.precision_of(got) == "int8"

    def test_scale_overrides_and_min_size(self, jax_params):
        params = bridge.params_from_numpy(_np_tree(jax_params), device="cpu")
        assert tt.precision_of(tt.quantize_params(
            params, tquant.QuantSpec(min_size=10 ** 9))) == "float32"
        base = tt.quantize_params(params)
        bent = tt.quantize_params(
            params, tquant.QuantSpec(scale_overrides={"mlp.w1": 2.0}))
        torch.testing.assert_close(
            bent["layers"][1]["mlp"]["w1"].scale,
            base["layers"][1]["mlp"]["w1"].scale * 2.0)
        torch.testing.assert_close(bent["layers"][1]["mlp"]["w2"].scale,
                                   base["layers"][1]["mlp"]["w2"].scale)


class TestBridge:
    def test_bf16_round_trip_is_bit_exact(self):
        rng = np.random.RandomState(10)
        a = jnp.asarray(rng.randn(33, 7).astype(np.float32)).astype(
            jnp.bfloat16)
        host = np.asarray(a)
        assert host.dtype.name == "bfloat16"
        t = bridge.params_from_numpy({"w": host}, device="cpu")["w"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      host.view(np.int16))

    @pytest.mark.parametrize("as_dict", [False, True])
    def test_quantized_leaf_becomes_int8_quantized_tensor(self, as_dict):
        jq = jt.quantize_tensor(jnp.asarray(_w((32, 16), seed=11)))
        leaf = ({"q": np.asarray(jq.q), "scale": np.asarray(jq.scale),
                 "orig_dtype": jq.orig_dtype} if as_dict else jq)
        got = bridge.params_from_numpy({"layers": [{"w": leaf}]},
                                       device="cpu")["layers"][0]["w"]
        assert isinstance(got, tt.QuantizedTensor)
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(jq.q))

    def test_fp8_leaf_crosses_bit_exact(self):
        jq = jt.quantize_tensor(jnp.asarray(_w((32, 16), seed=16)),
                                mode="fp8")
        got = bridge.params_from_numpy({"w": jq}, device="cpu")["w"]
        assert got.q.dtype == torch.float8_e4m3fn and got.mode == "fp8"
        assert got.q.stride() == (1, 32)       # laid out for _scaled_mm
        np.testing.assert_array_equal(
            got.q.contiguous().view(torch.uint8).numpy(),
            np.asarray(jq.q).view(np.uint8))

    def test_structure_and_dtypes_kept(self, jax_params):
        got = bridge.params_from_numpy(_np_tree(jax_params), device="cpu")
        assert len(got["layers"]) == len(jax_params["layers"])
        wq = got["layers"][0]["attn"]["wq"]
        assert tuple(wq.shape) == tuple(jax_params["layers"][0]["attn"]
                                        ["wq"].shape)
        assert wq.dtype == torch.float32 and wq.device.type == "cpu"


# -- footprint, spec, calibration, the gate, the twins ----------------------

@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _ids(B=2, T=12, seed=0):
    return np.random.RandomState(seed).randint(0, 97, (B, T)).astype(
        np.int32)


def _twins(pair, spec_kw):
    jm, tm = pair
    return (jt.quantize_model(jm, jquant.QuantSpec(**spec_kw)),
            tt.quantize_model(tm, tquant.QuantSpec(**spec_kw), device="cpu"))


class TestFootprint:
    @pytest.mark.parametrize("mode", [None, "int8", "fp8"])
    def test_bytes_and_counts_equal_jax(self, pair, mode):
        jm, tm = pair if mode is None else _twins(pair, {"mode": mode})
        assert tt.param_bytes_of(tm) == jt.param_bytes_of(jm) > 0
        assert tcl.count_params(tm.params) \
            == jax_causal_lm.count_params(jm.params)
        assert tt.precision_of_model(tm) == jt.precision_of_model(jm)

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_quantized_tensor_nbytes(self, mode):
        w = _w((64, 48), seed=17)
        jq = jt.quantize_tensor(jnp.asarray(w), mode=mode)
        tq = tt.quantize_tensor(torch.from_numpy(w), mode=mode)
        assert tq.nbytes == jq.nbytes == 64 * 48 + 48 * 4


class TestQuantSpec:
    SPECS = [{}, {"mode": "fp8", "act_dtype": "bfloat16",
                  "method": "percentile", "percentile": 99.0,
                  "min_size": 64, "skip_keys": ("position",),
                  "act_ranges": {"logits": 5.823451519012451},
                  "batch_fingerprint": "int32[4, 128]",
                  "scale_overrides": {"": 64.0, "mlp.w1": 0.5}}]

    @pytest.mark.parametrize("kw", SPECS)
    def test_json_round_trip_and_matches_jax(self, kw):
        s = tquant.QuantSpec(**kw)
        text = s.to_json()
        assert tquant.QuantSpec.from_json(text).to_json() == text
        assert tquant.QuantSpec.from_json(text) == s
        assert text == jquant.QuantSpec(**kw).to_json()
        assert jquant.QuantSpec.from_json(text).to_json() == text

    def test_invalid_mode_and_method_rejected(self):
        with pytest.raises(ValueError, match="mode"):
            tquant.QuantSpec(mode="int4")
        with pytest.raises(ValueError, match="method"):
            tquant.QuantSpec(method="mean")

    @pytest.mark.parametrize("method", ["absmax", "percentile"])
    def test_calibrate_matches_jax(self, pair, method):
        jm, tm = pair
        ids = _ids()
        ref = jquant.calibrate(jm, ids, method=method)
        got = tquant.calibrate(tm, ids, method=method)
        np.testing.assert_allclose(got.act_ranges["logits"],
                                   ref.act_ranges["logits"], rtol=1e-4)
        assert got.batch_fingerprint == ref.batch_fingerprint \
            == "int32[2, 12]"
        # a batch already on the model's device gives the same spec
        again = tquant.calibrate(tm, torch.from_numpy(ids), method=method)
        assert again.to_json() == got.to_json()


class TestValidateGate:
    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_divergence_report_matches_jax(self, pair, mode):
        jm, tm = pair
        jq, tq = _twins(pair, {"mode": mode})
        ids = _ids(seed=1)
        ref = jquant.divergence_report(jm, jq, ids)
        got = tquant.divergence_report(tm, tq, ids)
        assert set(got) == set(ref) and got["generative"] is True
        for k in ("max_abs_err", "mean_abs_err", "top1_agreement",
                  "per_token_agreement"):
            assert got[k] == pytest.approx(ref[k], abs=1e-4), k

    def test_validate_accepts_as_jax_does(self, pair):
        jm, tm = pair
        jq, tq = _twins(pair, {})
        ids = _ids(seed=2)
        kw = {"max_divergence": 1.0, "min_top1": 0.8}
        ref = jquant.validate(jm, jq, ids, **kw)
        got = tquant.validate(tm, tq, ids, model_name="gate",
                              version="v1", **kw)
        assert got["max_abs_err"] == pytest.approx(ref["max_abs_err"],
                                                   abs=1e-4)
        text = registry().prometheus_text()
        assert 'dl4j_quant_divergence{model="gate",version="v1"}' in text

    def test_mis_scaled_twin_rejected_as_jax_does(self, pair):
        jm, tm = pair
        jq, tq = _twins(pair, {"scale_overrides": {"": 64.0}})
        ids = _ids(seed=3)
        msg = "full-precision version stays live"
        with pytest.raises(jquant.QuantizationRejectedError, match=msg):
            jquant.validate(jm, jq, ids)
        with pytest.raises(tquant.QuantizationRejectedError, match=msg):
            tquant.validate(tm, tq, ids)

    def test_budget_overrides(self, pair):
        jm, tm = pair
        tq = _twins(pair, {})[1]
        with pytest.raises(tquant.QuantizationRejectedError, match="budget"):
            tquant.validate(tm, tq, _ids(), max_divergence=0.0,
                            min_top1=0.0)

    def test_env_knobs(self):
        env = environment()
        prev = [env.property_override(k) for k in
                ("quant", "quant_max_divergence", "quant_min_top1")]
        try:
            assert env.quant_mode() == ""          # opt-in: off by default
            assert env.quant_max_divergence() == pytest.approx(0.25)
            assert env.quant_min_top1() == pytest.approx(0.99)
            env.set_quant_mode("1")
            assert env.quant_mode() == "int8"      # truthy -> default mode
            env.set_quant_mode("fp8")
            assert env.quant_mode() == "fp8"
            env.set_quant_min_top1(2.0)
            assert env.quant_min_top1() == 1.0     # clamped to [0, 1]
        finally:
            for k, v in zip(("quant", "quant_max_divergence",
                             "quant_min_top1"), prev):
                if v is None:
                    env.clear_property(k)
                else:
                    env.set_property(k, v)


class TestQuantizedCausalLM:
    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_twin_logits_match_jax_twin(self, pair, mode):
        jq, tq = _twins(pair, {"mode": mode})
        assert tq._precision == jq._precision == mode
        assert tq.config.dtype == torch.float32    # CPU activations
        ids = _ids(seed=4)
        ref = np.asarray(jq.forward(jnp.asarray(ids)))
        with torch.no_grad():
            got = tq.forward(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# -- the layer-API branches: a MultiLayerNetwork's int8 twin -----------------

MLN_IN, MLN_OUT = 16, 4


def _mlp_pair(seed=0, hidden=32):
    """The JAX package's ``test_quant._mlp`` (dense gelu + softmax head)
    and the port network over its weights, on the CPU."""
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu_torch.nn import MultiLayerConfiguration as TConf
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork as TMLN
    conf = (JNNC.builder().seed(seed).list()
            .layer(JL.DenseLayer(n_in=MLN_IN, n_out=hidden,
                                 activation="gelu"))
            .layer(JL.OutputLayer(n_in=hidden, n_out=MLN_OUT))
            .build())
    jm = JMLN(conf).init()
    tm = TMLN(TConf.from_json(conf.to_json()), device="cpu")
    bridge.load_multilayer(tm, _np_tree(jm._params))
    return jm, tm


def _mlp_x(n=8, seed=0):
    return np.random.RandomState(seed).randn(n, MLN_IN).astype(np.float32)


def _decisive(logits, cands, n):
    part = np.partition(logits, -2, axis=-1)
    return cands[np.argsort(part[:, -1] - part[:, -2])[-n:]]


class TestQuantizedMLN:
    """``tests/test_quant.py::TestQuantizedMLN``'s three checks on the
    port's twin, with the JAX twin's outputs beside them (plain kernel
    version on the CPU; atol 1e-5: the same f32 products of the same int8
    weights, summed in another order, over K <= 32)."""

    def test_twin_is_close_small_and_int8_at_rest(self):
        jm, tm = _mlp_pair()
        xb = _mlp_x(16)
        full = tm.output(xb).numpy()
        jq = jt.quantize_model(jm)
        tq = tt.quantize_model(tm, device="cpu")
        q_out = tq.output(xb).numpy()
        np.testing.assert_allclose(q_out, np.asarray(jq.output(xb).jax()),
                                   atol=1e-5, rtol=0)
        assert np.abs(full - q_out).max() < 0.05
        assert tt.precision_of_model(tq) == "int8"
        assert tt.precision_of_model(tm) == "float32"
        assert tt.param_bytes_of(tq) == jt.param_bytes_of(jq)
        assert tt.param_bytes_of(tq) < 0.6 * tt.param_bytes_of(tm)
        assert isinstance(tq._params[0]["W"], tt.QuantizedTensor)
        assert tq._params[0]["W"].q.dtype == torch.int8
        assert tq.conf.dtype == "float32"   # CPU activations
        from deeplearning4j_tpu_torch.kernels import dispatch_snapshot
        snap = dispatch_snapshot()["dequant_matmul"]
        assert snap["path"] == "plain" and "cpu tensor" in snap["reason"]

    def test_twin_does_not_mutate_the_original(self):
        _, tm = _mlp_pair()
        before = tm.params().numpy().copy()
        tq = tt.quantize_model(tm, device="cpu")
        assert tt.precision_of_model(tm) == "float32"
        assert tm.conf.dtype in ("float32", None)
        assert tq.conf is not tm.conf and tq._updater_state is None
        np.testing.assert_array_equal(tm.params().numpy(), before)

    def test_decisive_batch_agrees_at_99pct(self):
        jm, tm = _mlp_pair()
        cands = _mlp_x(4 * 32)
        batch = _decisive(tm.output(cands).numpy(), cands, 32)
        np.testing.assert_array_equal(
            batch, _decisive(np.asarray(jm.output(cands).jax()), cands, 32))
        tq = tt.quantize_model(tm, device="cpu")
        rep = tquant.divergence_report(tm, tq, batch)
        ref = jquant.divergence_report(jm, jt.quantize_model(jm), batch)
        assert rep["top1_agreement"] >= 0.99
        assert rep["generative"] is ref["generative"] is False
        for k in ("max_abs_err", "mean_abs_err", "top1_agreement"):
            np.testing.assert_allclose(rep[k], ref[k], atol=1e-4, rtol=0)
        tquant.validate(tm, tq, batch, max_divergence=0.25, min_top1=0.99)

    @pytest.mark.parametrize("method", ["absmax", "percentile"])
    def test_calibrate_feed_forward_matches_jax(self, method):
        jm, tm = _mlp_pair()
        xb = _mlp_x(16, seed=3)
        got = tquant.calibrate(tm, xb, method=method)
        ref = jquant.calibrate(jm, xb, method=method)
        assert sorted(got.act_ranges) == sorted(ref.act_ranges) == \
            ["layer0", "layer1", "layer2"]
        for k, v in ref.act_ranges.items():
            np.testing.assert_allclose(got.act_ranges[k], v, rtol=1e-4)
        assert got.to_json() == tquant.QuantSpec.from_json(
            got.to_json()).to_json()


def _graph_pair(seed=0):
    """A small residual CNN as a ComputationGraph (a 3x3 convolution of
    288 weights and a 32->10 head, both past ``min_size``, so the twin
    dequantizes a 4-D weight at use and sends its head through
    ``dequant_matmul``), built by the JAX package and bridged into the
    port on the CPU."""
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.nn.conf.config import InputType as JInputType
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JAdd
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.nn.graph import \
        ComputationGraphConfiguration as TGraphConf
    conf = (JNNC.builder().seed(seed).graph_builder()
            .add_inputs("img")
            .set_input_types(JInputType.convolutional(6, 6, 4))
            .add_layer("c", JL.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                                padding=(1, 1),
                                                has_bias=False), "img")
            .add_layer("bn", JL.BatchNormalization(), "c")
            .add_layer("act", JL.ActivationLayer(activation="relu"), "bn")
            .add_layer("sc", JL.ConvolutionLayer(n_out=8, kernel_size=(1, 1)),
                       "img")
            .add_vertex("add", JAdd(op="add"), "act", "sc")
            .add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"),
                       "add")
            .add_layer("d", JL.DenseLayer(n_out=32, activation="gelu"),
                       "pool")
            .add_layer("output", JL.OutputLayer(n_out=10), "d")
            .set_outputs("output")
            .build())
    jg = JGraph(conf).init()
    tg = TGraph(TGraphConf.from_json(conf.to_json()), device="cpu")
    bridge.load_graph(tg, _np_tree(jg._params))
    return jg, tg


def _graph_x(n=8, seed=0):
    return np.random.RandomState(seed).randn(n, 4, 6, 6).astype(np.float32)


class TestQuantizedGraph:
    """The int8 twin of a ComputationGraph against the JAX package's twin
    (plain kernel version on the CPU; atol 1e-5 on softmax outputs: the
    same f32 products of the same int8 weights, summed in another
    order), its divergence report, and ``calibrate`` on a graph."""

    def test_twin_matches_jax_twin(self):
        jg, tg = _graph_pair()
        x = _graph_x(6)
        jq = jt.quantize_model(jg)
        tq = tt.quantize_model(tg, device="cpu")
        got = tq.output(x)
        assert isinstance(got, list) and len(got) == 1
        np.testing.assert_allclose(got[0].numpy(),
                                   np.asarray(jq.output(x)[0].jax()),
                                   atol=1e-5, rtol=0)
        assert np.abs(got[0].numpy() - tg.output(x)[0].numpy()).max() < 0.05
        assert type(tq) is type(tg) and tq.conf is not tg.conf
        assert tq.conf.dtype == "float32" and tq._updater_state is None
        for vertex in ("c", "d", "output"):
            assert isinstance(tq._params[vertex]["W"], tt.QuantizedTensor)
            assert tq._params[vertex]["W"].q.dtype == torch.int8
        assert not isinstance(tq._params["sc"]["W"], tt.QuantizedTensor)
        assert tt.precision_of_model(tq) == "int8"
        assert tt.param_bytes_of(tq) == jt.param_bytes_of(jq)
        assert tt.precision_of_model(tg) == "float32"

    def test_divergence_report_matches_jax(self):
        jg, tg = _graph_pair()
        x = _graph_x(16, seed=1)
        rep = tquant.divergence_report(tg, tt.quantize_model(tg,
                                                             device="cpu"), x)
        ref = jquant.divergence_report(jg, jt.quantize_model(jg), x)
        assert rep["generative"] is ref["generative"] is False
        for k in ("max_abs_err", "mean_abs_err", "top1_agreement"):
            np.testing.assert_allclose(rep[k], ref[k], atol=1e-4, rtol=0)

    @pytest.mark.parametrize("method", ["absmax", "percentile"])
    def test_calibrate_records_each_vertex(self, method):
        """One range per activation of ``feed_forward``, keyed by vertex
        name, equal to the JAX package's ``_range_of`` over the JAX
        graph's own activations; the JAX ``calibrate`` enumerates that
        dict as a list and fails (the reference fault in ``ROADMAP.md``
        queue 3)."""
        import importlib
        jcal = importlib.import_module("deeplearning4j_tpu.quant.calibrate")
        jg, tg = _graph_pair()
        x = _graph_x(8, seed=2)
        spec = tquant.calibrate(tg, x, method=method)
        jacts = jg.feed_forward(x)
        assert list(spec.act_ranges) == list(jacts) == [
            "img", "c", "sc", "bn", "act", "add", "pool", "d", "output"]
        for k, a in jacts.items():
            np.testing.assert_allclose(
                spec.act_ranges[k],
                jcal._range_of(np.asarray(a.jax()), method, 99.9), rtol=1e-4)
        assert spec.batch_fingerprint == "float32[8, 4, 6, 6]"
        with pytest.raises(ValueError, match="could not convert"):
            jquant.calibrate(jg, x, method=method)
