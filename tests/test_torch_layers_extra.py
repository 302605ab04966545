"""The port's extended layers (``nn/conf/layers_extra.py``, and the seven
convolution and attention classes of ``nn/conf/layers.py``) against the
JAX package's, case for case with ``tests/test_layers_extra.py``.

Each layer is built on both sides with the same arguments; the JAX
layer draws its params (``jax.random.key(0)``), which cross to the port
unchanged (``bridge.params_from_numpy``), and both run the same
``np.random.RandomState`` input on the CPU: the output, its shape and
``output_type`` must agree, as the JAX tests' shape checks demand.

Tolerances, each with its reason:
- f32 forwards and losses: the same ops summed in another order, atol
  1e-5 plus rtol 1e-5 (``TOL``).
- the noise layers draw from a torch generator, not ``jax.random``:
  identity at inference on both sides; in training, same-key
  determinism and moments within 0.05 over 40 000 draws (``MOMENT``,
  several standard errors).
- one Adam step of a network (center loss, frozen layer, capsules): the
  step's loss rtol 1e-5 and the refreshed centres atol 1e-6.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.conf.layers_extra as JX
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn.conf.config import (
    InputType as JInputType, MultiLayerConfiguration as JConf,
    NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.conf.layers_extra as TX
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.learning import Adam as TAdam
from deeplearning4j_tpu_torch.learning import tree_map
from deeplearning4j_tpu_torch.nn.conf.config import (
    InputType as TInputType, MultiLayerConfiguration as TConf,
    NeuralNetConfiguration as TNNC)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN

TOL = dict(atol=1e-5, rtol=1e-5)
MOMENT = 0.05

# every class of both files by name, the seven left out of layers.py's
# re-export included
J = types.SimpleNamespace(**{**vars(JX), **vars(JL)})
T = types.SimpleNamespace(**{**vars(TX), **vars(TL)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tp(jp):
    return bridge.params_from_numpy(_np(jp), "cpu")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def check_layer(make, input_type, batch=2, training=False, seed=0):
    """``make(namespace)`` built on both sides: the JAX layer's params in
    both, one input; outputs, shapes and ``output_type`` agree. Returns
    (JAX layer, port layer, JAX params, port params, input, port out)."""
    jl, tl = make(J), make(T)
    key = jax.random.key(0)
    jp = jl.init_params(key, input_type) if jl.has_params() else {}
    tp = _tp(jp)
    x = _x((batch,) + tuple(input_type), seed)
    ref = np.asarray(jl.forward(jp, jnp.asarray(x), training=training))
    got = tl.forward(tp, torch.from_numpy(x), training=training)
    expect = tl.output_type(input_type)
    assert tuple(expect) == tuple(jl.output_type(input_type))
    assert tuple(got.shape) == (batch,) + tuple(expect) == ref.shape
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert tl.has_params() == jl.has_params()
    assert tl.needs_key() == jl.needs_key()
    return jl, tl, jp, tp, x, got


class TestConv3DFamily:
    def test_conv3d(self):
        check_layer(lambda M: M.Convolution3D(
            n_in=2, n_out=4, kernel_size=(3, 3, 3), padding="SAME"),
            (2, 6, 6, 6))

    def test_conv3d_valid(self):
        check_layer(lambda M: M.Convolution3D(
            n_in=2, n_out=4, kernel_size=(3, 3, 3), padding=(0, 0, 0)),
            (2, 6, 6, 6))

    def test_subsampling3d(self):
        check_layer(lambda M: M.Subsampling3DLayer(kernel_size=(2, 2, 2)),
                    (3, 4, 4, 4))
        check_layer(lambda M: M.Subsampling3DLayer(pooling_type="avg"),
                    (3, 4, 4, 4))
        check_layer(lambda M: M.Subsampling3DLayer(
            pooling_type="avg", kernel_size=(3, 3, 3), stride=(2, 2, 2),
            padding="SAME", avg_include_pad=False), (3, 5, 4, 5))

    def test_upsampling3d(self):
        check_layer(lambda M: M.Upsampling3D(size=(2, 2, 2)), (3, 2, 2, 2))

    def test_cropping_padding_3d(self):
        check_layer(lambda M: M.Cropping3D(cropping=(1, 1, 1, 1, 1, 1)),
                    (2, 4, 4, 4))
        check_layer(lambda M: M.ZeroPadding3DLayer(
            padding=(1, 1, 1, 1, 1, 1)), (2, 4, 4, 4))


class TestConv1DFamily:
    def test_subsampling1d(self):
        check_layer(lambda M: M.Subsampling1DLayer(kernel_size=2), (3, 8))
        check_layer(lambda M: M.Subsampling1DLayer(
            pooling_type="avg", kernel_size=3, stride=2, padding=1), (3, 8))

    def test_upsampling1d(self):
        check_layer(lambda M: M.Upsampling1D(size=3), (3, 4))

    def test_cropping1d(self):
        check_layer(lambda M: M.Cropping1D(cropping=(1, 2)), (3, 8))

    def test_zeropadding1d(self):
        check_layer(lambda M: M.ZeroPadding1DLayer(padding=(2, 1)), (3, 8))

    def test_cropping2d(self):
        check_layer(lambda M: M.Cropping2D(cropping=(1, 1, 2, 0)), (2, 6, 6))


class TestRecurrent:
    def test_simple_rnn(self):
        check_layer(lambda M: M.SimpleRnn(n_in=4, n_out=6), (4, 7))

    def test_gru(self):
        check_layer(lambda M: M.GRU(n_in=4, n_out=6), (4, 7))

    def test_last_time_step(self):
        check_layer(lambda M: M.LastTimeStep(
            underlying=M.LSTM(n_in=4, n_out=6)), (4, 7))

    def test_time_distributed(self):
        check_layer(lambda M: M.TimeDistributed(
            underlying=M.DenseLayer(n_in=4, n_out=6, activation="relu")),
            (4, 7))

    def test_mask_zero(self):
        jl = J.MaskZeroLayer(underlying=J.SimpleRnn(n_in=3, n_out=5))
        tl = T.MaskZeroLayer(underlying=T.SimpleRnn(n_in=3, n_out=5))
        jp = jl.init_params(jax.random.key(0), (3, 6))
        x = np.ones((2, 3, 6), np.float32)
        x[:, :, 4:] = 0.0  # padding timesteps
        got = tl.forward(_tp(jp), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jl.forward(jp, jnp.asarray(x))), **TOL)
        assert np.allclose(got[:, :, 4:], 0.0)
        assert not np.allclose(got[:, :, :4], 0.0)


class TestLocallyConnected:
    def test_lc2d(self):
        check_layer(lambda M: M.LocallyConnected2D(
            n_in=2, n_out=4, kernel_size=(3, 3)), (2, 6, 6))
        check_layer(lambda M: M.LocallyConnected2D(
            n_in=3, n_out=2, kernel_size=(2, 3), stride=(2, 1),
            activation="tanh"), (3, 7, 6))

    def test_lc1d(self):
        check_layer(lambda M: M.LocallyConnected1D(
            n_in=3, n_out=5, kernel_size=3), (3, 8))
        check_layer(lambda M: M.LocallyConnected1D(
            n_in=3, n_out=2, kernel_size=2, stride=3, has_bias=False),
            (3, 8))

    def test_lc2d_vs_conv_param_count(self):
        # unshared weights: param count = positions * shared-conv params
        make = (lambda M: M.LocallyConnected2D(
            n_in=2, n_out=4, kernel_size=(3, 3), has_bias=False))
        tp = make(T).init_params(torch.Generator().manual_seed(0),
                                 (2, 6, 6))
        assert tuple(tp["W"].shape) == (16, 2 * 9, 4) and set(tp) == {"W"}
        jp = make(J).init_params(jax.random.key(0), (2, 6, 6))
        assert jp["W"].shape == (16, 2 * 9, 4)


class TestElementwiseShape:
    def test_prelu(self):
        jl, tl, jp, tp, _, _ = check_layer(lambda M: M.PReLULayer(n_in=4),
                                           (4,))
        neg = -np.ones((2, 4), np.float32)
        got = tl.forward(tp, torch.from_numpy(neg)).numpy()
        assert np.allclose(got, -0.25)
        np.testing.assert_allclose(
            got, np.asarray(jl.forward(jp, jnp.asarray(neg))), **TOL)
        # per-channel alpha over NCHW, and a per-position alpha
        check_layer(lambda M: M.PReLULayer(n_in=3), (3, 4, 5))
        alpha = _x((3, 4), 5)
        x = _x((2, 3, 4), 6)
        np.testing.assert_allclose(
            tl.forward({"alpha": torch.from_numpy(alpha)},
                       torch.from_numpy(x)).numpy(),
            np.asarray(jl.forward({"alpha": jnp.asarray(alpha)},
                                  jnp.asarray(x))), **TOL)

    def test_elementwise_mult(self):
        check_layer(lambda M: M.ElementWiseMultiplicationLayer(
            n_in=5, activation="tanh"), (5,))

    def test_repeat_vector(self):
        check_layer(lambda M: M.RepeatVector(n=4), (3,))

    def test_space_depth_roundtrip(self):
        """The channel order is the JAX package's (not
        ``F.pixel_unshuffle``'s); the round trip is exact."""
        check_layer(lambda M: M.SpaceToDepthLayer(block_size=2),
                    (3, 4, 6))
        check_layer(lambda M: M.DepthToSpaceLayer(block_size=2),
                    (12, 2, 3))
        x = torch.from_numpy(_x((2, 3, 4, 4), 1))
        y = T.SpaceToDepthLayer(block_size=2).forward({}, x)
        assert y.shape == (2, 12, 2, 2)
        z = T.DepthToSpaceLayer(block_size=2).forward({}, y)
        assert torch.equal(z, x)

    def test_mask_layer(self):
        check_layer(lambda M: M.MaskLayer(), (4,))
        check_layer(lambda M: M.MaskLayer(mask_value=0.5), (3, 5))


class TestDropoutVariants:
    """The draws cannot match ``jax.random``'s: identity at inference on
    both sides, same-key determinism and the moments in training."""

    @staticmethod
    def _train(layer, x, key):
        return layer.forward({}, torch.from_numpy(x), training=True, key=key)

    def test_gaussian_dropout(self):
        check_layer(lambda M: M.GaussianDropout(rate=0.5), (8,))
        layer = T.GaussianDropout(rate=0.5)
        x = np.ones((200, 200), np.float32)
        a, b = self._train(layer, x, 3), self._train(layer, x, 3)
        assert torch.equal(a, b)
        assert not torch.equal(a, self._train(layer, x, 4))
        # x * (1 + sqrt(rate / (1 - rate)) * N(0, 1)): mean 1, var 1
        assert abs(float(a.mean()) - 1.0) < MOMENT
        assert abs(float(a.var()) - 1.0) < MOMENT
        assert layer.needs_key() and not layer.has_params()

    def test_gaussian_noise(self):
        layer = T.GaussianNoise(stddev=0.1)
        x = np.ones((2, 8), np.float32)
        out_train = self._train(layer, x, 1)
        out_infer = layer.forward({}, torch.from_numpy(x), training=False)
        assert not np.allclose(out_train.numpy(), x)
        assert np.allclose(out_infer.numpy(), x)
        big = self._train(layer, np.zeros((200, 200), np.float32), 2)
        assert abs(float(big.mean())) < MOMENT
        assert abs(float(big.std()) - 0.1) < MOMENT * 0.1
        check_layer(lambda M: M.GaussianNoise(stddev=0.1), (8,))

    def test_alpha_dropout(self):
        check_layer(lambda M: M.AlphaDropout(rate=0.3), (8,))
        layer = T.AlphaDropout(rate=0.3)
        x = _x((200, 200), 2)
        a = self._train(layer, x, 5)
        assert torch.equal(a, self._train(layer, x, 5))
        # SELU's self-normalizing dropout keeps mean 0 and variance 1
        assert abs(float(a.mean())) < MOMENT
        assert abs(float(a.var()) - 1.0) < MOMENT

    def test_spatial_dropout(self):
        check_layer(lambda M: M.SpatialDropout(rate=0.5), (4, 3, 3))
        layer = T.SpatialDropout(rate=0.5)
        x = np.ones((100, 400, 3, 3), np.float32)
        a = self._train(layer, x, 7)
        # one draw per (example, channel): each map all 0 or all 2
        per_map = a.reshape(100, 400, 9)
        assert torch.equal(per_map.amin(-1), per_map.amax(-1))
        assert set(torch.unique(a).tolist()) == {0.0, 2.0}
        assert abs(float((a > 0).float().mean()) - 0.5) < MOMENT


class TestLossHeads:
    def test_cnn_loss_layer(self):
        jl, tl, _, _, x, out = check_layer(lambda M: M.CnnLossLayer(),
                                           (3, 4, 4))
        # softmax over channels
        assert np.allclose(out.numpy().sum(1), 1.0, atol=1e-5)
        labels = np.eye(3, dtype=np.float32)[
            np.random.RandomState(3).randint(0, 3, (2, 4, 4))]
        labels = np.moveaxis(labels, -1, 1)
        ref = float(jl.compute_loss(jnp.asarray(labels),
                                    jl.forward({}, jnp.asarray(x))))
        got = float(tl.compute_loss(torch.from_numpy(labels), out))
        assert got > 0
        np.testing.assert_allclose(got, ref, **TOL)

    def test_rnn_loss_layer(self):
        jl, tl, _, _, x, out = check_layer(lambda M: M.RnnLossLayer(),
                                           (3, 5))
        labels = np.moveaxis(np.eye(3, dtype=np.float32)[
            np.random.RandomState(4).randint(0, 3, (2, 5))], -1, 1)
        ref = float(jl.compute_loss(jnp.asarray(labels),
                                    jl.forward({}, jnp.asarray(x))))
        got = float(tl.compute_loss(torch.from_numpy(labels), out))
        assert got > 0
        np.testing.assert_allclose(got, ref, **TOL)

    def test_cnn3d_loss_layer(self):
        jl, tl, _, _, x, out = check_layer(lambda M: M.Cnn3DLossLayer(),
                                           (3, 2, 4, 4))
        labels = np.moveaxis(np.eye(3, dtype=np.float32)[
            np.random.RandomState(5).randint(0, 3, (2, 2, 4, 4))], -1, 1)
        mask = (np.random.RandomState(6).rand(2, 2, 4, 4) > 0.3) \
            .astype(np.float32)
        for m in (None, mask):
            ref = float(jl.compute_loss(
                jnp.asarray(labels), jl.forward({}, jnp.asarray(x)),
                None if m is None else jnp.asarray(m)))
            got = float(tl.compute_loss(
                torch.from_numpy(labels), out,
                None if m is None else torch.from_numpy(m)))
            np.testing.assert_allclose(got, ref, **TOL)

    def test_yolo2_loss(self):
        """The loss and its gradient against the JAX layer's."""
        anchors = ((1.0, 1.0), (2.0, 2.0))
        jl = J.Yolo2OutputLayer(anchors=anchors)
        tl = T.Yolo2OutputLayer(anchors=anchors)
        B, H, W, C = 2, 4, 4, 3
        x = _x((B, 2 * (5 + C), H, W), 7)
        labels = np.zeros((B, 4 + C, H, W), np.float32)
        labels[0, :4, 1, 1] = [0.1, 0.1, 0.3, 0.3]  # one box
        labels[0, 4, 1, 1] = 1.0                     # class 0
        labels[1, :4, 2, 3] = [0.6, 0.4, 0.95, 0.7]
        labels[1, 6, 2, 3] = 1.0
        ref, jg = jax.value_and_grad(lambda v: jl.compute_loss(
            jnp.asarray(labels), jl.forward({}, v)))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        loss = tl.compute_loss(torch.from_numpy(labels), tl.forward({}, xt))
        (tg,) = torch.autograd.grad(loss, xt)
        loss = float(loss.detach())
        assert np.isfinite(loss) and loss > 0
        np.testing.assert_allclose(loss, float(ref), **TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
        assert tl.output_type((18, H, W)) == jl.output_type((18, H, W))

    def test_center_loss_trains(self):
        """One Adam step against the JAX network (the loss with its
        centre term, the centres the labels moved), then 20 epochs."""
        def conf(NNC, L, updater):
            return (NNC.builder().updater(updater).list()
                    .layer(L.DenseLayer(n_in=4, n_out=8, activation="relu"))
                    .layer(L.CenterLossOutputLayer(n_in=8, n_out=3,
                                                   lambda_=0.5))
                    .build())
        jconf = conf(JNNC, J, JAdam(1e-2))
        assert TConf.from_json(jconf.to_json()).to_json() == jconf.to_json()
        jnet = JMLN(jconf).init()
        tnet = TMLN(conf(TNNC, T, TAdam(1e-2)), device="cpu").init(
            params=bridge.params_from_numpy(_np(jnet._params), "cpu"))
        rng = np.random.RandomState(0)
        x = rng.randn(16, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
        before = tnet.score(TDataSet(x, y))
        np.testing.assert_allclose(before, jnet.score(JDataSet(x, y)),
                                   rtol=1e-5)
        jnet.fit(JDataSet(x, y))
        tnet.fit(TDataSet(x, y))
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        centers = tnet._params[1]["state_centers"]
        np.testing.assert_allclose(
            centers.numpy(), np.asarray(jnet._params[1]["state_centers"]),
            atol=1e-6)
        assert float(centers.abs().sum()) > 0
        tnet.fit(TDataSet(x, y), num_epochs=20)
        assert tnet.score(TDataSet(x, y)) < before


class TestAttentionLayers:
    def test_learned_self_attention(self):
        check_layer(lambda M: M.LearnedSelfAttentionLayer(
            n_in=6, n_out=8, n_heads=2, n_queries=3), (6, 10))

    def test_recurrent_attention(self):
        check_layer(lambda M: M.RecurrentAttentionLayer(n_in=6, n_out=8),
                    (6, 10))


class TestFrozen:
    def test_frozen_params_not_trained(self):
        def conf(NNC, L):
            return (NNC.builder().updater(
                (JAdam if L is J else TAdam)(1e-2)).list()
                .layer(L.FrozenLayer(underlying=L.DenseLayer(
                    n_in=4, n_out=8, activation="relu")))
                .layer(L.OutputLayer(n_in=8, n_out=3))
                .build())
        jnet = JMLN(conf(JNNC, J)).init()
        tnet = TMLN(conf(TNNC, T), device="cpu").init(
            params=bridge.params_from_numpy(_np(jnet._params), "cpu"))
        key = T.FrozenLayer.PREFIX + "W"
        w_before = tnet._params[0][key].clone()
        rng = np.random.RandomState(1)
        x = rng.randn(8, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
        jnet.fit(JDataSet(x, y))
        tnet.fit(TDataSet(x, y))
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        tnet.fit(TDataSet(x, y), num_epochs=4)
        assert torch.equal(tnet._params[0][key], w_before)
        # but the output layer did train
        assert tnet.score(TDataSet(x, y)) < 2.0


class TestVAE:
    def test_vae_shapes(self):
        check_layer(lambda M: M.VariationalAutoencoder(
            n_in=10, n_out=4, encoder_layer_sizes=(16,),
            decoder_layer_sizes=(16,)), (10,))

    def test_vae_elbo_decreases(self):
        """The ELBO on one noise draw against the JAX layer's, then 60
        Adam steps of the port's."""
        make = (lambda M: M.VariationalAutoencoder(
            n_in=10, n_out=3, encoder_layer_sizes=(16,),
            decoder_layer_sizes=(16,)))
        jvae, vae = make(J), make(T)
        jp = jvae.init_params(jax.random.key(0), (10,))
        x = _x((32, 10), 8)
        key = jax.random.key(1)
        eps = jax.random.normal(key, (32, 3), jnp.float32)
        ref = float(jvae.elbo_loss(jp, jnp.asarray(x), key))
        params = _tp(jp)
        got = float(vae.elbo_loss(params, torch.from_numpy(x), None,
                                  eps=torch.from_numpy(np.array(eps))))
        np.testing.assert_allclose(got, ref, **TOL)
        opt = TAdam(1e-2)
        state = opt.init(params)
        xt = torch.from_numpy(x)
        first = loss = None
        for i in range(60):
            leaves = tree_map(lambda v: v.detach().requires_grad_(True),
                              params)
            loss = vae.elbo_loss(leaves, xt, 100 + i)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            upd, state = opt.apply(grads, state, i)
            params = {k: params[k] - upd[k] for k in params}
            first = float(loss.detach()) if first is None else first
        assert float(loss.detach()) < first * 0.8

    def test_vae_reconstruct(self):
        jvae = J.VariationalAutoencoder(n_in=6, n_out=2)
        vae = T.VariationalAutoencoder(n_in=6, n_out=2)
        jp = jvae.init_params(jax.random.key(0), (6,))
        x = np.ones((3, 6), np.float32)
        got = vae.reconstruct(_tp(jp), torch.from_numpy(x))
        assert got.shape == (3, 6)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jvae.reconstruct(jp, jnp.asarray(x))),
            **TOL)
        assert set(vae.init_params(torch.Generator().manual_seed(0),
                                   (6,))) == set(jp)


class TestCapsules:
    def test_primary_capsules(self):
        check_layer(lambda M: M.PrimaryCapsules(
            n_in=2, capsules=4, capsule_dimensions=8, kernel_size=(3, 3),
            stride=(2, 2)), (2, 12, 12))

    def test_capsule_layer_routing(self):
        check_layer(lambda M: M.CapsuleLayer(
            input_capsules=6, input_capsule_dimensions=4, capsules=3,
            capsule_dimensions=8, routings=2), (6, 4))

    def test_capsule_strength(self):
        _, _, _, _, _, out = check_layer(
            lambda M: M.CapsuleStrengthLayer(), (5, 8))
        assert out.shape == (2, 5)
        # lengths are in [0, inf)
        assert bool((out >= 0).all())

    def test_capsnet_end_to_end(self):
        """Mini CapsNet from the JAX configuration's JSON and weights: the
        output and one Adam step's loss against the JAX network, then 3
        epochs."""
        jconf = (JNNC.builder().updater(JAdam(1e-2)).list()
                 .layer(JL.ConvolutionLayer(n_in=1, n_out=4,
                                            kernel_size=(3, 3),
                                            activation="relu"))
                 .layer(JL.PrimaryCapsules(n_in=4, capsules=2,
                                           capsule_dimensions=4,
                                           kernel_size=(3, 3),
                                           stride=(2, 2)))
                 .layer(JL.CapsuleLayer(capsules=2, capsule_dimensions=4,
                                        routings=2))
                 .layer(JL.CapsuleStrengthLayer())
                 .layer(JL.LossLayer(loss="mse", activation="softmax"))
                 .set_input_type(JInputType.convolutional(8, 8, 1))
                 .build())
        tconf = TConf.from_json(jconf.to_json())
        assert tconf.to_json() == jconf.to_json()
        jnet = JMLN(jconf).init()
        tnet = TMLN(tconf, device="cpu").init(
            params=bridge.params_from_numpy(_np(jnet._params), "cpu"))
        rng = np.random.RandomState(9)
        x = rng.randn(4, 1, 8, 8).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 4)]
        np.testing.assert_allclose(tnet.output(x).numpy(),
                                   np.asarray(jnet.output(x).jax()), **TOL)
        jnet.fit(JDataSet(x, y))
        tnet.fit(TDataSet(x, y))
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        tnet.fit(TDataSet(x, y), num_epochs=3)
        assert tnet.output(x).shape == (4, 2)


class TestLayersPy:
    """The seven classes of ``nn/conf/layers.py`` this slice ports."""

    @pytest.mark.parametrize("kw", [
        dict(n_in=3, n_out=4, kernel_size=3),
        dict(n_in=3, n_out=4, kernel_size=3, stride=2, dilation=2,
             activation="relu"),
        dict(n_in=3, n_out=2, kernel_size=2, padding=1, has_bias=False),
        dict(n_in=3, n_out=4, kernel_size=3, padding="CAUSAL",
             dilation=2)], ids=["same", "strided-dilated", "int-pad",
                                "causal"])
    def test_convolution1d(self, kw):
        check_layer(lambda M: M.Convolution1DLayer(**kw), (3, 9))

    def test_causal_convolution1d_sees_only_the_past(self):
        layer = T.Convolution1DLayer(n_in=2, n_out=3, kernel_size=3,
                                     padding="CAUSAL", dilation=2)
        p = layer.init_params(torch.Generator().manual_seed(0), (2, 10))
        x = torch.from_numpy(_x((1, 2, 10), 3))
        y = x.clone()
        y[:, :, 6:] = 5.0
        a, b = layer.forward(p, x), layer.forward(p, y)
        assert torch.equal(a[:, :, :6], b[:, :, :6])
        assert not torch.equal(a[:, :, 6:], b[:, :, 6:])

    def test_self_attention(self):
        check_layer(lambda M: M.SelfAttentionLayer(n_in=6, n_out=8,
                                                   n_heads=2), (6, 5))
        check_layer(lambda M: M.SelfAttentionLayer(n_in=4, n_out=4,
                                                   head_size=3), (4, 7))

    def test_upsampling2d_and_zero_padding(self):
        check_layer(lambda M: M.Upsampling2D(size=(2, 3)), (3, 2, 4))
        check_layer(lambda M: M.Upsampling2D(size=2), (2, 3, 3))
        check_layer(lambda M: M.ZeroPaddingLayer(padding=(1, 0, 2, 3)),
                    (2, 3, 4))

    @pytest.mark.parametrize("kw", [
        dict(n_out=4, kernel_size=(2, 2), stride=(2, 2),
             convolution_mode="same"),
        dict(n_out=3, kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
             activation="relu"),
        dict(n_out=2, kernel_size=(4, 3), stride=(1, 2), padding="SAME",
             has_bias=False)], ids=["same-k2-s2", "pad1-k3-s2",
                                    "same-k43-s12"])
    def test_deconvolution(self, kw):
        check_layer(lambda M: M.DeconvolutionLayer(**kw), (3, 4, 5))

    def test_deconvolution_output_type_as_jax(self):
        """Reference fault 8, pinned on both sides: with explicit padding
        (0, 0), k=3, s=2 on 4x4, ``output_type`` says 9x9 (torch's
        formula) while the forward gives 5x5 (lax's pads of the dilated
        input)."""
        make = (lambda M: M.DeconvolutionLayer(
            n_in=2, n_out=3, kernel_size=(3, 3), stride=(2, 2),
            padding=(0, 0)))
        jl, tl = make(J), make(T)
        assert tl.output_type((2, 4, 4)) == jl.output_type((2, 4, 4)) \
            == (3, 9, 9)
        jp = jl.init_params(jax.random.key(0), (2, 4, 4))
        x = _x((2, 2, 4, 4), 1)
        ref = np.asarray(jl.forward(jp, jnp.asarray(x)))
        got = tl.forward(_tp(jp), torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape == (2, 3, 5, 5)
        np.testing.assert_allclose(got, ref, **TOL)

    @pytest.mark.parametrize("mult,stride", [(1, (1, 1)), (2, (2, 2))])
    def test_separable_and_depthwise(self, mult, stride):
        for cls in ("SeparableConvolution2D", "DepthwiseConvolution2D"):
            _, tl, _, tp, _, _ = check_layer(
                lambda M: getattr(M, cls)(n_out=5, kernel_size=(3, 3),
                                          stride=stride,
                                          depth_multiplier=mult,
                                          convolution_mode="same"),
                (3, 7, 8))
            want = {"Wd", "Wp", "b"} if cls.startswith("Sep") \
                else {"W", "b"}
            assert set(tp) == want

    def test_json_of_an_unexported_layer_fails_alike(self):
        """Reference fault 4 (seven classes, not six): a configuration
        holding a layer that layers.py does not re-export writes its JSON
        on both sides, and neither reads it back."""
        for name in ("ChannelNormalizationLayer", "GRUResetAfter",
                     "LayerNormalizationLayer", "PermuteLayer",
                     "RescaleLayer", "ReshapeLayer", "SpatialDropout"):
            assert not hasattr(TL, name) and not hasattr(JL, name)
            assert hasattr(TX, name) and hasattr(JX, name)
        def conf(NNC, X, L):
            return (NNC.builder().list()
                    .layer(X.RescaleLayer(scale=2.0, offset=1.0))
                    .layer(L.OutputLayer(n_in=4, n_out=2)).build())
        js = conf(JNNC, JX, JL).to_json()
        assert conf(TNNC, TX, TL).to_json() == js
        for Conf in (JConf, TConf):
            with pytest.raises(AttributeError, match="RescaleLayer"):
                Conf.from_json(js)

    def test_every_layer_class_is_ported(self):
        """Every layer class of the JAX package's two files is a port
        ``Layer`` of the same name and fields."""
        import dataclasses
        for jmod, tmod in ((JL, TL), (JX, TX)):
            names = {n for n, c in vars(jmod).items()
                     if isinstance(c, type) and issubclass(c, JL.Layer)
                     and c.__module__ == jmod.__name__}
            for n in names:
                tc = getattr(tmod, n)
                assert isinstance(tc, type) and issubclass(tc, TL.Layer), n
                assert [(f.name, f.default) for f in
                        dataclasses.fields(tc)] == \
                    [(f.name, f.default) for f in
                     dataclasses.fields(getattr(jmod, n))], n
        assert not hasattr(TL, "UnportedLayer")
        assert TInputType.convolutional(4, 5, 3) == \
            JInputType.convolutional(4, 5, 3)


class TestBridge:
    """``bridge.load_multilayer`` / ``load_graph`` carry the new layers'
    params (``Wd`` / ``Wp``, the VAE's, the capsules', ``state_centers``)
    with the updater state and iteration: a step continued on both sides
    gives the same loss."""

    def test_multilayer_vae_capsules_center_loss(self):
        def conf(NNC, L):
            return (NNC.builder().updater(
                (JAdam if L is J else TAdam)(1e-2)).list()
                .layer(L.VariationalAutoencoder(
                    n_in=6, n_out=4, encoder_layer_sizes=(8,),
                    decoder_layer_sizes=(8,)))
                .layer(L.ReshapeLayer(target_shape=(2, 2)))
                .layer(L.CapsuleLayer(capsules=3, capsule_dimensions=4,
                                      routings=2))
                .layer(L.CapsuleStrengthLayer())
                .layer(L.CenterLossOutputLayer(n_in=3, n_out=2,
                                               lambda_=0.5))
                .set_input_type((JInputType if L is J else
                                 TInputType).feed_forward(6))
                .build())
        jnet = JMLN(conf(JNNC, J)).init()
        rng = np.random.RandomState(11)
        x = rng.randn(8, 6).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]
        jnet.fit(JDataSet(x, y))
        tnet = bridge.load_multilayer(
            TMLN(conf(TNNC, T), device="cpu"), _np(jnet._params),
            _np(jnet._updater_state), jnet._iteration)
        assert {"eW0", "dW0", "Wmu", "Wlv", "Wout"} <= set(tnet._params[0])
        assert "state_centers" in tnet._params[4]
        np.testing.assert_allclose(tnet.output(x).numpy(),
                                   np.asarray(jnet.output(x).jax()), **TOL)
        jnet.fit(JDataSet(x, y))
        tnet.fit(TDataSet(x, y))
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            tnet._params[4]["state_centers"].numpy(),
            np.asarray(jnet._params[4]["state_centers"]), atol=1e-6)

    def test_graph_separable_weights(self):
        import deeplearning4j_tpu.zoo as jzoo
        import deeplearning4j_tpu_torch.zoo as tzoo
        from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
        from deeplearning4j_tpu_torch.nn.graph import \
            ComputationGraph as TGraph
        kw = dict(num_classes=3, num_blocks=1, penultimate_filters=24,
                  input_shape=(3, 16, 16))
        jconf = jzoo.NASNet(**kw).build_conf()
        jnet = JGraph(jconf).init()
        tnet = bridge.load_graph(TGraph(tzoo.NASNet(**kw).build_conf(),
                                        device="cpu"), _np(jnet._params))
        assert any({"Wd", "Wp"} <= set(p) for p in tnet._params.values())
        x = _x((2, 3, 16, 16), 12)
        np.testing.assert_allclose(tnet.output(x)[0].numpy(),
                                   np.asarray(jnet.output(x)[0].jax()),
                                   **TOL)
