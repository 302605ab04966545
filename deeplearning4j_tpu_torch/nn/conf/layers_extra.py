"""Extended layer configurations (the reference's long tail).

Counterpart of ``deeplearning4j_tpu/nn/conf/layers_extra.py``. Ported:
the recurrent layers and their wrappers — ``SimpleRnn``, ``GRU``,
``GRUResetAfter``, ``LastTimeStep``, ``TimeDistributed``,
``MaskZeroLayer``, ``MaskLayer`` and ``RnnLossLayer`` — and transfer
learning's ``FrozenLayer``, as pure modules like ``conf/layers.py`` (see
its module docstring). The other 36 classes of the JAX file are
:class:`~.layers.UnportedLayer` stubs under their JAX names, waiting for
``ROADMAP.md`` queue 1 item 9.

Masking: ``MaskLayer`` emits a ``[B, T]`` keep-mask (``emits_mask``)
that ``MultiLayerNetwork`` threads into the layers with
``accepts_mask``; ``MaskZeroLayer`` only zeroes its wrapped layer's
output at all-``mask_value`` steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ...ops import recurrent
from ..activations import get_activation
from ..weights import init_weights
from .layers import Layer, _temporal_loss, _unported, _zeros


@dataclasses.dataclass
class SimpleRnn(Layer):
    """Elman RNN over [B, F, T] (reference conf/layers/recurrent/
    SimpleRnn.java)."""
    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    weight_init: str = "xavier"

    accepts_mask = True

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        return {"Wx": init_weights(generator, (n_in, self.n_out),
                                   self.weight_init),
                "Wh": init_weights(generator, (self.n_out, self.n_out),
                                   self.weight_init),
                "b": _zeros(generator, self.n_out)}

    def forward(self, params, x, training=False, key=None, mask=None):
        h_seq, _ = recurrent.simple_rnn(
            x.transpose(1, 2), params["Wx"], params["Wh"], params["b"],
            activation=get_activation(self.activation), mask=mask)
        return h_seq.transpose(1, 2)

    def output_type(self, input_type):
        return (self.n_out, input_type[1])


@dataclasses.dataclass
class GRU(Layer):
    """GRU over [B, F, T] on the gruCell op ([r, u] fused over [x, h],
    candidate over [x, r * h])."""
    n_in: int = 0
    n_out: int = 0
    weight_init: str = "xavier"

    accepts_mask = True

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        H = self.n_out
        return {"Wru": init_weights(generator, (n_in + H, 2 * H),
                                    self.weight_init),
                "Wc": init_weights(generator, (n_in + H, H),
                                   self.weight_init),
                "bru": _zeros(generator, 2 * H),
                "bc": _zeros(generator, H)}

    def forward(self, params, x, training=False, key=None, mask=None):
        h0 = x.new_zeros((x.shape[0], self.n_out))
        h_seq, _ = recurrent.gru(x.transpose(1, 2), h0, params["Wru"],
                                 params["Wc"], params["bru"], params["bc"],
                                 mask=mask)
        return h_seq.transpose(1, 2)

    def output_type(self, input_type):
        return (self.n_out, input_type[1])


@dataclasses.dataclass
class GRUResetAfter(Layer):
    """GRU with the reset gate applied after the recurrent product and
    separate input / recurrent biases (Keras ``reset_after=True``), on
    the ONNX layout: W [3H, In], R [3H, H], b [6H], gate rows (z, r, h).
    Runs over [B, F, T] like the other RNN layers."""
    n_in: int = 0
    n_out: int = 0
    weight_init: str = "xavier"

    accepts_mask = True

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        H = self.n_out
        return {"W": init_weights(generator, (3 * H, n_in),
                                  self.weight_init),
                "R": init_weights(generator, (3 * H, H), self.weight_init),
                "b": _zeros(generator, 6 * H)}

    def forward(self, params, x, training=False, key=None, mask=None):
        h_seq, _ = recurrent.gru_onnx(x.transpose(1, 2), params["W"],
                                      params["R"], params["b"],
                                      linear_before_reset=1,
                                      time_major=False, mask=mask)
        return h_seq.transpose(1, 2)

    def output_type(self, input_type):
        return (self.n_out, input_type[1])


@dataclasses.dataclass
class LastTimeStep(Layer):
    """The last time step of a wrapped RNN layer's [B, F, T] output
    (reference conf/layers/recurrent/LastTimeStep.java). With a mask the
    wrapped layer carries its state through masked steps, so the last
    column is the last valid step's output."""
    underlying: Layer = None
    return_sequence = False

    @property
    def accepts_mask(self):
        return getattr(self.underlying, "accepts_mask", False)

    def init_params(self, generator, input_type):
        return self.underlying.init_params(generator, input_type)

    def forward(self, params, x, training=False, key=None, mask=None):
        mk = {"mask": mask} if mask is not None else {}
        return self.underlying.forward(params, x, training, key,
                                       **mk)[:, :, -1]

    def output_type(self, input_type):
        return (self.underlying.output_type(input_type)[0],)

    def has_params(self):
        return self.underlying.has_params()

    def needs_key(self):
        return self.underlying.needs_key()


@dataclasses.dataclass
class TimeDistributed(Layer):
    """A feed-forward layer at every time step of [B, F, T] (reference
    conf/layers/recurrent/TimeDistributed.java)."""
    underlying: Layer = None

    def init_params(self, generator, input_type):
        return self.underlying.init_params(generator, (input_type[0],))

    def forward(self, params, x, training=False, key=None):
        b, f, t = x.shape
        flat = x.transpose(1, 2).reshape(b * t, f)
        out = self.underlying.forward(params, flat, training, key)
        return out.reshape(b, t, -1).transpose(1, 2)

    def output_type(self, input_type):
        return (self.underlying.output_type((input_type[0],))[0],
                input_type[1])

    def has_params(self):
        return self.underlying.has_params()

    def needs_key(self):
        return self.underlying.needs_key()


def _keep(x, mask_value):
    """[B, 1, T]: steps where some feature differs from ``mask_value``."""
    return torch.any(x != mask_value, dim=1, keepdim=True)


@dataclasses.dataclass
class MaskZeroLayer(Layer):
    """Zero the wrapped layer's output at the steps whose input is all
    ``mask_value`` (reference conf/layers/util/MaskZeroLayer.java). It
    emits no mask: the wrapped layer runs unmasked."""
    underlying: Layer = None
    mask_value: float = 0.0

    def init_params(self, generator, input_type):
        return self.underlying.init_params(generator, input_type)

    def forward(self, params, x, training=False, key=None):
        keep = _keep(x, self.mask_value)
        out = self.underlying.forward(params, x, training, key)
        return out * keep.to(out.dtype)

    def output_type(self, input_type):
        return self.underlying.output_type(input_type)

    def has_params(self):
        return self.underlying.has_params()


@dataclasses.dataclass
class MaskLayer(Layer):
    """Keras ``Masking`` (reference util/MaskLayer.java): zeroes the steps
    whose features all equal ``mask_value`` and emits the [B, T]
    keep-mask, which the network threads into the mask-aware layers after
    it and into a temporal loss head."""
    mask_value: float = 0.0
    emits_mask = True

    def forward(self, params, x, training=False, key=None):
        return x * _keep(x, self.mask_value).to(x.dtype)

    def compute_mask(self, x):
        """[B, F, T] activations -> [B, T] keep-mask."""
        return torch.any(x != self.mask_value, dim=1)

    def has_params(self):
        return False


@dataclasses.dataclass
class RnnLossLayer(Layer):
    """Per-timestep loss on [B, C, T] without params (reference
    RnnLossLayer.java)."""
    loss: Union[str, Callable] = "mcxent"
    activation: str = "softmax"

    def forward(self, params, x, training=False, key=None):
        return get_activation(self.activation)(
            x.transpose(1, 2)).transpose(1, 2)

    def compute_loss(self, labels, output, mask=None):
        return _temporal_loss(self.loss, labels, output, mask)

    def has_params(self):
        return False


@dataclasses.dataclass
class FrozenLayer(Layer):
    """Wrapper excluding the inner layer's params from training (reference
    layers/FrozenLayer.java). The inner params are stored under
    ``state_frozen__`` keys, which every network treats as not trainable,
    and the inner layer runs with ``training=False``: a frozen batch norm
    uses its running statistics and never updates them.

    Under a bf16 body the inner float params are cast to the activations'
    dtype, as the network casts an unfrozen layer's; the JAX package
    leaves them f32 and its bf16 convolution then refuses the mix
    (``ROADMAP.md`` queue 3, reference fault 6)."""
    underlying: Layer = None

    PREFIX = "state_frozen__"

    def init_params(self, generator, input_type):
        inner = self.underlying.init_params(generator, input_type)
        return {self.PREFIX + k: v for k, v in inner.items()}

    @classmethod
    def wrap_params(cls, inner_params):
        """Freeze an existing param dict (used by TransferLearning)."""
        return {k if k.startswith(cls.PREFIX) else cls.PREFIX + k: v
                for k, v in inner_params.items()}

    def forward(self, params, x, training=False, key=None):
        n = len(self.PREFIX)
        inner = {k[n:]: v for k, v in params.items()
                 if k.startswith(self.PREFIX)}
        if x.is_floating_point():
            inner = {k: (v.to(x.dtype) if not k.startswith("state_")
                         and isinstance(v, torch.Tensor)
                         and v.is_floating_point() else v)
                     for k, v in inner.items()}
        return self.underlying.forward(inner, x, training=False, key=key)

    def output_type(self, input_type):
        return self.underlying.output_type(input_type)

    def has_params(self):
        return self.underlying.has_params()


_LATER = "layers_extra.py"
(AlphaDropout, CapsuleLayer, CapsuleStrengthLayer, CenterLossOutputLayer,
 ChannelNormalizationLayer, Cnn3DLossLayer, CnnLossLayer, Convolution3D,
 Cropping1D, Cropping2D, Cropping3D, DepthToSpaceLayer,
 ElementWiseMultiplicationLayer, GaussianDropout,
 GaussianNoise, LayerNormalizationLayer, LearnedSelfAttentionLayer,
 LocallyConnected1D, LocallyConnected2D, PReLULayer, PermuteLayer,
 PrimaryCapsules, RecurrentAttentionLayer, RepeatVector, ReshapeLayer,
 RescaleLayer, SpaceToDepthLayer, SpatialDropout, Subsampling1DLayer,
 Subsampling3DLayer, Upsampling1D, Upsampling3D, VariationalAutoencoder,
 Yolo2OutputLayer, ZeroPadding1DLayer, ZeroPadding3DLayer) = (
    _unported(n, _LATER) for n in (
        "AlphaDropout", "CapsuleLayer", "CapsuleStrengthLayer",
        "CenterLossOutputLayer", "ChannelNormalizationLayer",
        "Cnn3DLossLayer", "CnnLossLayer", "Convolution3D", "Cropping1D",
        "Cropping2D", "Cropping3D", "DepthToSpaceLayer",
        "ElementWiseMultiplicationLayer", "GaussianDropout",
        "GaussianNoise", "LayerNormalizationLayer",
        "LearnedSelfAttentionLayer", "LocallyConnected1D",
        "LocallyConnected2D", "PReLULayer", "PermuteLayer",
        "PrimaryCapsules", "RecurrentAttentionLayer", "RepeatVector",
        "ReshapeLayer", "RescaleLayer", "SpaceToDepthLayer",
        "SpatialDropout", "Subsampling1DLayer", "Subsampling3DLayer",
        "Upsampling1D", "Upsampling3D", "VariationalAutoencoder",
        "Yolo2OutputLayer", "ZeroPadding1DLayer", "ZeroPadding3DLayer"))
