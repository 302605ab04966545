"""Extended layer configurations (the reference's long tail).

Counterpart of ``deeplearning4j_tpu/nn/conf/layers_extra.py``, all 45
classes, as pure modules like ``conf/layers.py`` (see its module
docstring): the recurrent layers and their wrappers, the 3-D and 1-D
convolution family, cropping and padding, space / depth, locally
connected, elementwise and normalization layers, the noise layers, the
loss heads (``CnnLossLayer``, ``CenterLossOutputLayer``,
``Yolo2OutputLayer``, ...), attention, the VAE, capsules and transfer
learning's ``FrozenLayer``. Parameter layouts and names are the JAX
package's. The noise layers draw from the layer's key through the
counter-based hash of ``common/rng.py``, so their draws differ from
``jax.random``'s; at inference they are the identity on both sides.

Masking: ``MaskLayer`` emits a ``[B, T]`` keep-mask (``emits_mask``)
that ``MultiLayerNetwork`` threads into the layers with
``accepts_mask``; ``MaskZeroLayer`` only zeroes its wrapped layer's
output at all-``mask_value`` steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ...common import rng
from ...ops import conv_ops, nn_ops, recurrent
from ..activations import get_activation
from ..losses import get_loss
from ..weights import init_weights
from .layers import Layer, OutputLayer, _pair, _temporal_loss, _zeros


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


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def _no_params(cls):
    """A layer class with no parameters."""
    cls.has_params = lambda self: False
    return cls


def _channel_shape(x, n):
    """The shape that broadcasts an ``[n]`` vector over ``x``'s channel
    axis (axis 1 of rank >= 3, else the last)."""
    shape = [1] * x.dim()
    shape[1 if x.dim() >= 3 else -1] = n
    return shape


# -- 3-D convolution family, pooling, cropping and padding --------------------

@dataclasses.dataclass
class Convolution3D(Layer):
    """3-D convolution over NCDHW (reference conf/layers/Convolution3D
    .java); ``W`` is ``[kd, kh, kw, n_in, n_out]``."""
    n_in: int = 0
    n_out: int = 0
    kernel_size: Sequence[int] = (3, 3, 3)
    stride: Sequence[int] = (1, 1, 1)
    padding: Union[str, Sequence[int]] = "SAME"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        p = {"W": init_weights(generator,
                               _triple(self.kernel_size) + (n_in,
                                                            self.n_out),
                               self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, self.n_out)
        return p

    def forward(self, params, x, training=False, key=None):
        pad = self.padding if isinstance(self.padding, str) \
            else _triple(self.padding)
        out = conv_ops.conv3d(x, params["W"], params.get("b"),
                              strides=_triple(self.stride), padding=pad,
                              data_format="NCDHW")
        return get_activation(self.activation)(out)

    def output_type(self, input_type):
        c, d, h, w = input_type
        k, s = _triple(self.kernel_size), _triple(self.stride)
        if isinstance(self.padding, str) and self.padding.upper() == "SAME":
            return (self.n_out,) + tuple(-(-n // st)
                                         for n, st in zip((d, h, w), s))
        p = _triple(self.padding) if not isinstance(self.padding, str) \
            else (0, 0, 0)
        return (self.n_out,) + tuple(
            (n + 2 * pp - kk) // st + 1
            for n, pp, kk, st in zip((d, h, w), p, k, s))


@_no_params
@dataclasses.dataclass
class Subsampling1DLayer(Layer):
    """1-D pooling over [B, C, T] through the 2-D pools (reference
    Subsampling1DLayer.java)."""
    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = None
    padding: int = 0

    def forward(self, params, x, training=False, key=None):
        s = self.stride if self.stride is not None else self.kernel_size
        pad = (self.padding, 0) if self.padding else "VALID"
        pool = conv_ops.maxpool2d if self.pooling_type.lower() == "max" \
            else conv_ops.avgpool2d
        return pool(x[:, :, :, None], (self.kernel_size, 1), (s, 1), pad,
                    "NCHW")[:, :, :, 0]

    def output_type(self, input_type):
        c, t = input_type
        s = self.stride if self.stride is not None else self.kernel_size
        return (c, (t + 2 * self.padding - self.kernel_size) // s + 1)


@_no_params
@dataclasses.dataclass
class Subsampling3DLayer(Layer):
    """3-D pooling over NCDHW (reference Subsampling3DLayer.java)."""
    pooling_type: str = "max"
    kernel_size: Sequence[int] = (2, 2, 2)
    stride: Sequence[int] = None
    padding: Union[str, Sequence[int]] = "VALID"
    #: divisor counts padded cells (reference legacy); keras/TF exclude
    avg_include_pad: bool = True

    def forward(self, params, x, training=False, key=None):
        s = self.stride if self.stride is not None else self.kernel_size
        pad = self.padding if isinstance(self.padding, str) \
            else _triple(self.padding)
        if self.pooling_type.lower() == "max":
            return conv_ops.maxpool3d(x, _triple(self.kernel_size),
                                      _triple(s), pad, "NCDHW")
        return conv_ops.avgpool3d(x, _triple(self.kernel_size), _triple(s),
                                  pad, "NCDHW",
                                  include_pad=self.avg_include_pad)

    def output_type(self, input_type):
        c, d, h, w = input_type
        k = _triple(self.kernel_size)
        s = _triple(self.stride if self.stride is not None
                    else self.kernel_size)
        if isinstance(self.padding, str):
            if self.padding.upper() == "SAME":
                return (c,) + tuple(-(-n // st)
                                    for n, st in zip((d, h, w), s))
            p = (0, 0, 0)
        else:
            p = _triple(self.padding)
        return (c,) + tuple((n + 2 * pp - kk) // st + 1
                            for n, pp, kk, st in zip((d, h, w), p, k, s))


@_no_params
@dataclasses.dataclass
class Upsampling1D(Layer):
    """Repeat along time (reference Upsampling1D.java)."""
    size: int = 2

    def forward(self, params, x, training=False, key=None):
        return torch.repeat_interleave(x, self.size, dim=2)

    def output_type(self, input_type):
        c, t = input_type
        return (c, t * self.size)


@_no_params
@dataclasses.dataclass
class Upsampling3D(Layer):
    size: Sequence[int] = (2, 2, 2)

    def forward(self, params, x, training=False, key=None):
        return conv_ops.upsampling3d(x, *_triple(self.size), "NCDHW")

    def output_type(self, input_type):
        c, d, h, w = input_type
        sd, sh, sw = _triple(self.size)
        return (c, d * sd, h * sh, w * sw)


def _crop(x, cuts):
    """``x`` cut by (low, high) on each axis after [B, C]."""
    idx = [slice(None), slice(None)]
    for ax, (lo, hi) in enumerate(cuts, start=2):
        idx.append(slice(lo, x.shape[ax] - hi))
    return x[tuple(idx)]


def _pairs(flat):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def _grown(input_type, pairs, sign):
    return (input_type[0],) + tuple(n + sign * (lo + hi) for n, (lo, hi)
                                    in zip(input_type[1:], pairs))


@_no_params
@dataclasses.dataclass
class Cropping1D(Layer):
    cropping: Sequence[int] = (1, 1)

    def forward(self, params, x, training=False, key=None):
        return _crop(x, _pairs(self.cropping))

    def output_type(self, input_type):
        return _grown(input_type, _pairs(self.cropping), -1)


@_no_params
@dataclasses.dataclass
class Cropping2D(Layer):
    cropping: Sequence[int] = (1, 1, 1, 1)  # top, bottom, left, right

    def forward(self, params, x, training=False, key=None):
        return _crop(x, _pairs(self.cropping))

    def output_type(self, input_type):
        return _grown(input_type, _pairs(self.cropping), -1)


@_no_params
@dataclasses.dataclass
class Cropping3D(Layer):
    cropping: Sequence[int] = (1, 1, 1, 1, 1, 1)

    def forward(self, params, x, training=False, key=None):
        return _crop(x, _pairs(self.cropping))

    def output_type(self, input_type):
        return _grown(input_type, _pairs(self.cropping), -1)


def _zero_pad(x, flat):
    """``x`` zero-padded by (low, high) pairs on each axis after [B, C]."""
    pads = []
    for lo, hi in reversed(_pairs(flat)):
        pads += [lo, hi]
    return F.pad(x, pads)


@_no_params
@dataclasses.dataclass
class ZeroPadding1DLayer(Layer):
    padding: Sequence[int] = (1, 1)

    def forward(self, params, x, training=False, key=None):
        return _zero_pad(x, self.padding)

    def output_type(self, input_type):
        return _grown(input_type, _pairs(self.padding), 1)


@_no_params
@dataclasses.dataclass
class ZeroPadding3DLayer(Layer):
    padding: Sequence[int] = (1, 1, 1, 1, 1, 1)

    def forward(self, params, x, training=False, key=None):
        return _zero_pad(x, self.padding)

    def output_type(self, input_type):
        return _grown(input_type, _pairs(self.padding), 1)


@_no_params
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """(reference conf/layers/SpaceToDepthLayer.java), with the JAX
    package's channel order: ``(row offset, column offset, channel)``
    (``F.pixel_unshuffle`` orders channel first)."""
    block_size: int = 2

    def forward(self, params, x, training=False, key=None):
        b, c, h, w = x.shape
        s = self.block_size
        x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)

    def output_type(self, input_type):
        c, h, w = input_type
        s = self.block_size
        return (c * s * s, h // s, w // s)


@_no_params
@dataclasses.dataclass
class DepthToSpaceLayer(Layer):
    """The inverse of :class:`SpaceToDepthLayer`."""
    block_size: int = 2

    def forward(self, params, x, training=False, key=None):
        b, c, h, w = x.shape
        s = self.block_size
        x = x.reshape(b, s, s, c // (s * s), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (s * s), h * s, w * s)

    def output_type(self, input_type):
        c, h, w = input_type
        s = self.block_size
        return (c // (s * s), h * s, w * s)


@_no_params
@dataclasses.dataclass
class PermuteLayer(Layer):
    """Permute the non-batch dims (keras Permute; ``dims`` 1-indexed over
    the feature dims)."""
    dims: tuple = (1,)

    def forward(self, params, x, training=False, key=None):
        return x.permute((0,) + tuple(int(d) for d in self.dims))

    def output_type(self, input_type):
        if input_type is None:
            return None
        return tuple(input_type[d - 1] for d in self.dims)


@_no_params
@dataclasses.dataclass
class ReshapeLayer(Layer):
    """Reshape the non-batch dims (keras Reshape)."""
    target_shape: tuple = ()

    def forward(self, params, x, training=False, key=None):
        return x.reshape((x.shape[0],) + tuple(int(s)
                                               for s in self.target_shape))

    def output_type(self, input_type):
        return tuple(int(s) for s in self.target_shape)


@_no_params
@dataclasses.dataclass
class RepeatVector(Layer):
    """[B, F] -> [B, F, n] (reference conf/layers/misc/RepeatVector.java)."""
    n: int = 1

    def forward(self, params, x, training=False, key=None):
        return x[:, :, None].expand(-1, -1, self.n)

    def output_type(self, input_type):
        return (input_type[0], self.n)


# -- locally connected ----------------------------------------------------

@dataclasses.dataclass
class LocallyConnected2D(Layer):
    """Convolution with unshared weights (reference LocallyConnected2D
    .java): ``F.unfold`` patches (channel-major, as lax's
    ``conv_general_dilated_patches``) and one batched product;
    ``W`` is ``[oh * ow, n_in * kh * kw, n_out]``."""
    n_in: int = 0
    n_out: int = 0
    kernel_size: Sequence[int] = (3, 3)
    stride: Sequence[int] = (1, 1)
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True
    input_size: Sequence[int] = None  # (h, w), required if no InputType

    def _out_hw(self, input_type):
        h, w = (input_type[1], input_type[2]) if input_type is not None \
            else self.input_size
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        kh, kw = _pair(self.kernel_size)
        oh, ow = self._out_hw(input_type)
        p = {"W": init_weights(generator, (oh * ow, n_in * kh * kw,
                                           self.n_out), self.weight_init)}
        if self.has_bias:
            p["b"] = torch.zeros((oh * ow, self.n_out),
                                 device=generator.device)
        return p

    def forward(self, params, x, training=False, key=None):
        b, _, h, w = x.shape
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        patches = F.unfold(x, (kh, kw), stride=(sh, sw))   # [B, CK, P]
        out = torch.einsum("bcp,pco->bpo", patches, params["W"])
        if self.has_bias:
            out = out + params["b"]
        out = get_activation(self.activation)(out)
        return out.transpose(1, 2).reshape(b, self.n_out, oh, ow)

    def output_type(self, input_type):
        return (self.n_out,) + self._out_hw(input_type)


@dataclasses.dataclass
class LocallyConnected1D(Layer):
    """1-D unshared convolution over [B, C, T] (reference
    LocallyConnected1D.java); ``W`` is ``[ot, n_in * k, n_out]``."""
    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True

    def _out_t(self, input_type):
        return (input_type[1] - self.kernel_size) // self.stride + 1

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        ot = self._out_t(input_type)
        p = {"W": init_weights(generator, (ot, n_in * self.kernel_size,
                                           self.n_out), self.weight_init)}
        if self.has_bias:
            p["b"] = torch.zeros((ot, self.n_out), device=generator.device)
        return p

    def forward(self, params, x, training=False, key=None):
        patches = F.unfold(x[:, :, :, None], (self.kernel_size, 1),
                           stride=(self.stride, 1))        # [B, C*k, ot]
        out = torch.einsum("bct,tco->bto", patches, params["W"])
        if self.has_bias:
            out = out + params["b"]
        return get_activation(self.activation)(out).transpose(1, 2)

    def output_type(self, input_type):
        return (self.n_out, self._out_t(input_type))


# -- elementwise and normalization ----------------------------------------

@dataclasses.dataclass
class PReLULayer(Layer):
    """Learned leaky-ReLU slope (reference conf/layers/PReLULayer.java):
    ``alpha`` per channel (1-D) or per position (the batchless shape,
    channels first)."""
    n_in: int = 0  # number of features/channels (inferred)

    def init_params(self, generator, input_type):
        n = self.n_in or input_type[0]
        return {"alpha": torch.full((n,), 0.25, device=generator.device)}

    def forward(self, params, x, training=False, key=None):
        a = params["alpha"]
        a = a[None] if a.dim() > 1 else a.reshape(_channel_shape(x,
                                                                 a.shape[0]))
        return torch.where(x >= 0, x, a * x)


@dataclasses.dataclass
class ElementWiseMultiplicationLayer(Layer):
    """out = activation(x * w + b) (reference
    ElementWiseMultiplicationLayer)."""
    n_in: int = 0
    n_out: int = 0
    activation: str = "identity"

    def init_params(self, generator, input_type):
        n = self.n_in or input_type[0]
        return {"w": torch.ones((n,), device=generator.device),
                "b": _zeros(generator, n)}

    def forward(self, params, x, training=False, key=None):
        return get_activation(self.activation)(x * params["w"] + params["b"])


@_no_params
@dataclasses.dataclass
class RescaleLayer(Layer):
    """y = x * scale + offset (keras preprocessing Rescaling)."""
    scale: float = 1.0
    offset: float = 0.0

    def forward(self, params, x, training=False, key=None):
        return x * self.scale + self.offset


@dataclasses.dataclass
class ChannelNormalizationLayer(Layer):
    """Per-channel normalization over axis 1 (keras preprocessing
    Normalization): y = (x - mean) / max(sqrt(variance), 1e-7), mean and
    variance given as weights."""

    def init_params(self, generator, input_type):
        c = input_type[0] if input_type else 1
        return {"mean": _zeros(generator, c),
                "variance": torch.ones((c,), device=generator.device)}

    def forward(self, params, x, training=False, key=None):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = params["mean"].reshape(shape)
        std = torch.clamp(torch.sqrt(params["variance"].reshape(shape)),
                          min=1e-7)
        return (x - mean) / std


@dataclasses.dataclass
class LayerNormalizationLayer(Layer):
    """Layer norm over the channel axis (axis 1 of rank >= 3, else the
    last) with learned gamma / beta, in f32 (the Keras
    LayerNormalization adapter target)."""
    n_out: int = 0  # inferred
    eps: float = 1e-3

    def init_params(self, generator, input_type):
        c = self.n_out or input_type[0]
        return {"gamma": torch.ones((c,), device=generator.device),
                "beta": _zeros(generator, c)}

    def forward(self, params, x, training=False, key=None):
        axis = 1 if x.dim() >= 3 else -1
        xf = x.float()
        mean = torch.mean(xf, dim=axis, keepdim=True)
        var = torch.var(xf, dim=axis, keepdim=True, correction=0)
        norm = (xf - mean) / torch.sqrt(var + self.eps)
        shape = _channel_shape(x, params["gamma"].shape[0])
        out = norm * params["gamma"].reshape(shape) \
            + params["beta"].reshape(shape)
        return out.to(x.dtype)


# -- dropout and noise (reference conf/dropout/) ----------------------------

class _Noise(Layer):
    """A parameterless layer that draws in training with a key and is the
    identity otherwise."""

    def forward(self, params, x, training=False, key=None):
        if not training or key is None:
            return x
        return self._draw(x, key)

    def has_params(self):
        return False

    def needs_key(self):
        return True


@dataclasses.dataclass
class SpatialDropout(_Noise):
    """Drop whole channels (reference conf/dropout/SpatialDropout.java):
    one keep draw per [B, C], over the trailing spatial / time dims."""
    rate: float = 0.5

    def forward(self, params, x, training=False, key=None):
        if self.rate <= 0:
            return x
        return super().forward(params, x, training, key)

    def _draw(self, x, key):
        keep = 1.0 - self.rate
        mask = nn_ops.uniform_like(
            x, key, x.shape[:2] + (1,) * (x.dim() - 2)) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


@dataclasses.dataclass
class GaussianDropout(_Noise):
    rate: float = 0.5

    def _draw(self, x, key):
        return nn_ops.gaussian_dropout(x, self.rate, key, training=True)


@dataclasses.dataclass
class GaussianNoise(_Noise):
    stddev: float = 0.1

    def _draw(self, x, key):
        return nn_ops.gaussian_noise(x, self.stddev, key, training=True)


@dataclasses.dataclass
class AlphaDropout(_Noise):
    rate: float = 0.5

    def _draw(self, x, key):
        return nn_ops.alpha_dropout(x, self.rate, key, training=True)


# -- loss heads -------------------------------------------------------------

def _channels_last_loss(loss, labels, output, mask):
    """A per-position loss on [B, C, ...]: every position a row."""
    c = output.shape[1]
    lab = torch.movedim(labels, 1, -1).reshape(-1, c)
    out = torch.movedim(output, 1, -1).reshape(-1, c)
    return get_loss(loss)(lab, out, mask.reshape(-1) if mask is not None
                          else None)


@_no_params
@dataclasses.dataclass
class CnnLossLayer(Layer):
    """Per-pixel loss on [B, C, H, W] (reference CnnLossLayer.java), the
    activation over the channel axis."""
    loss: Union[str, Callable] = "mcxent"
    activation: str = "softmax"

    def forward(self, params, x, training=False, key=None):
        return torch.movedim(get_activation(self.activation)(
            torch.movedim(x, 1, -1)), -1, 1)

    def compute_loss(self, labels, output, mask=None):
        return _channels_last_loss(self.loss, labels, output, mask)


@_no_params
@dataclasses.dataclass
class Cnn3DLossLayer(CnnLossLayer):
    """Per-voxel loss on [B, C, D, H, W] (reference Cnn3DLossLayer.java)."""


@dataclasses.dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss (reference CenterLossOutputLayer.java).

    Per-class feature centres are non-trainable state (``state_centers``
    ``[n_out, n_in]``) that the network moves toward each batch's class
    means at rate ``alpha`` after a step (``new_state`` with the
    labels); the training loss is mcxent + lambda/2 * mean ||f - c_y||^2
    over the layer's input features (``compute_loss_ext``)."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_params(self, generator, input_type):
        p = super().init_params(generator, input_type)
        n_in = self.n_in or input_type[0]
        p["state_centers"] = torch.zeros((self.n_out, n_in),
                                         device=generator.device)
        return p

    def new_state(self, params, x, labels=None):
        centers = params["state_centers"]
        if labels is None:
            return {"state_centers": centers}
        labels = labels.to(x.dtype)
        counts = torch.sum(labels, dim=0)                    # [n_out]
        sums = torch.einsum("bc,bf->cf", labels, x)          # [n_out, n_in]
        means = sums / torch.clamp(counts[:, None], min=1.0)
        observed = (counts > 0)[:, None]
        return {"state_centers": torch.where(
            observed, centers - self.alpha * (centers - means), centers)}

    def compute_loss(self, labels, output, mask=None):
        return get_loss(self.loss)(labels, output, mask)

    def compute_loss_ext(self, params, labels, output, features, mask=None):
        base = get_loss(self.loss)(labels, output, mask)
        if features is None:
            return base
        cls_centers = torch.matmul(labels.to(features.dtype),
                                   params["state_centers"])
        center = torch.mean(torch.sum((features - cls_centers) ** 2, dim=-1))
        return base + 0.5 * self.lambda_ * center


@_no_params
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection loss (reference objdetect/Yolo2OutputLayer.java).

    Input [B, A*(5+C), H, W], passed through; labels [B, 4+C, H, W]:
    normalized box corners [x1, y1, x2, y2] and a one-hot class at the
    cell that holds the box's centre, zero elsewhere. Per anchor: the
    sigmoid centre offsets and the log size ratios against the label's
    (lambda_coord), the sigmoid confidence (lambda_noobj where no
    object), the softmax class scores; summed, over the object count."""
    anchors: Sequence[Tuple[float, float]] = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    def forward(self, params, x, training=False, key=None):
        return x

    def compute_loss(self, labels, output, mask=None):
        B, _, H, W = output.shape
        A = len(self.anchors)
        C = labels.shape[1] - 4
        pred = output.reshape(B, A, 5 + C, H, W)
        tx, ty = torch.sigmoid(pred[:, :, 0]), torch.sigmoid(pred[:, :, 1])
        tw, th = pred[:, :, 2], pred[:, :, 3]
        conf = torch.sigmoid(pred[:, :, 4])
        cls = torch.softmax(pred[:, :, 5:], dim=2)
        obj = (torch.sum(labels[:, :4], dim=1, keepdim=True) > 0) \
            .to(output.dtype)                                 # [B, 1, H, W]
        x1, y1, x2, y2 = (labels[:, i] for i in range(4))
        cx = torch.remainder((x1 + x2) / 2 * W, 1.0)
        cy = torch.remainder((y1 + y2) / 2 * H, 1.0)
        bw, bh = (x2 - x1) * W, (y2 - y1) * H
        coord = 0.0
        for a, (aw, ah) in enumerate(self.anchors):
            coord = coord + torch.sum(obj[:, 0] * (
                (tx[:, a] - cx) ** 2 + (ty[:, a] - cy) ** 2
                + (tw[:, a] - torch.log(torch.clamp(bw / aw, min=1e-6))) ** 2
                + (th[:, a] - torch.log(torch.clamp(bh / ah, min=1e-6)))
                ** 2))
        conf_loss = torch.sum(obj * (conf - 1.0) ** 2) + \
            self.lambda_noobj * torch.sum((1 - obj) * conf ** 2)
        cls_loss = torch.sum(obj[:, :, None]
                             * (cls - labels[:, None, 4:]) ** 2)
        n = torch.clamp(torch.sum(obj), min=1.0)
        return (self.lambda_coord * coord + conf_loss + cls_loss) / n


# -- attention --------------------------------------------------------------

@dataclasses.dataclass
class LearnedSelfAttentionLayer(Layer):
    """Attention from ``n_queries`` learned queries over [B, F, T] ->
    [B, n_out, n_queries] (reference LearnedSelfAttentionLayer.java)."""
    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    n_queries: int = 1
    head_size: int = None
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        hs = self.head_size or (self.n_out // self.n_heads)
        proj = (n_in, self.n_heads, hs)
        return {"Q": init_weights(generator, (self.n_queries, n_in),
                                  self.weight_init),
                "Wq": init_weights(generator, proj, self.weight_init),
                "Wk": init_weights(generator, proj, self.weight_init),
                "Wv": init_weights(generator, proj, self.weight_init),
                "Wo": init_weights(generator, (self.n_heads * hs,
                                               self.n_out),
                                   self.weight_init)}

    def forward(self, params, x, training=False, key=None):
        xt = x.transpose(1, 2)  # [B, T, F]
        q = params["Q"].expand((x.shape[0],) + tuple(params["Q"].shape))
        out = nn_ops.multi_head_dot_product_attention(
            q, xt, xt, params["Wq"], params["Wk"], params["Wv"],
            params["Wo"])
        return out.transpose(1, 2)

    def output_type(self, input_type):
        return (self.n_out, self.n_queries)


@dataclasses.dataclass
class RecurrentAttentionLayer(Layer):
    """A recurrent cell whose input is augmented with attention of its
    state over the whole projected sequence (reference
    RecurrentAttentionLayer.java): a loop over time, one batched product
    a step."""
    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        return {"Wx": init_weights(generator, (n_in, self.n_out),
                                   self.weight_init),
                "Wh": init_weights(generator, (self.n_out, self.n_out),
                                   self.weight_init),
                "Wa": init_weights(generator, (n_in, self.n_out),
                                   self.weight_init),
                "b": _zeros(generator, self.n_out)}

    def forward(self, params, x, training=False, key=None):
        xt = x.transpose(1, 2)  # [B, T, F]
        act = get_activation(self.activation)
        proj = torch.einsum("btf,fo->bto", xt, params["Wa"])
        h = x.new_zeros((x.shape[0], self.n_out))
        outs = []
        for t in range(xt.shape[1]):
            scores = torch.einsum("bo,bto->bt", h, proj) \
                / math.sqrt(self.n_out)
            a_t = torch.einsum("bt,bto->bo", torch.softmax(scores, dim=-1),
                               proj)
            h = act(xt[:, t] @ params["Wx"] + h @ params["Wh"] + a_t
                    + params["b"])
            outs.append(h)
        return torch.stack(outs, dim=2)  # [B, n_out, T]

    def output_type(self, input_type):
        return (self.n_out, input_type[1])


# -- variational autoencoder ------------------------------------------------

@dataclasses.dataclass
class VariationalAutoencoder(Layer):
    """VAE pretrain layer (reference layers/variational/
    VariationalAutoencoder.java): flat params ``eW{i}`` / ``eb{i}``, the
    latent heads ``Wmu`` / ``Wlv``, ``dW{i}`` / ``db{i}`` and ``Wout``.
    ``forward`` is the latent mean (the supervised path); ``elbo_loss``
    the pretrain objective with a gaussian reconstruction, its noise
    drawn from ``key``."""
    n_in: int = 0
    n_out: int = 0                     # latent size
    encoder_layer_sizes: Sequence[int] = (64,)
    decoder_layer_sizes: Sequence[int] = (64,)
    activation: str = "lrelu"
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        p = {}

        def dense(w, b, a, n):
            p[w] = init_weights(generator, (a, n), self.weight_init)
            p[b] = _zeros(generator, n)

        sizes = [n_in] + list(self.encoder_layer_sizes)
        for i, (a, n) in enumerate(zip(sizes[:-1], sizes[1:])):
            dense(f"eW{i}", f"eb{i}", a, n)
        dense("Wmu", "bmu", sizes[-1], self.n_out)
        dense("Wlv", "blv", sizes[-1], self.n_out)
        dsizes = [self.n_out] + list(self.decoder_layer_sizes)
        for i, (a, n) in enumerate(zip(dsizes[:-1], dsizes[1:])):
            dense(f"dW{i}", f"db{i}", a, n)
        dense("Wout", "bout", dsizes[-1], n_in)
        return p

    def _encode(self, params, x):
        act = get_activation(self.activation)
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        return (h @ params["Wmu"] + params["bmu"],
                h @ params["Wlv"] + params["blv"])

    def _decode(self, params, z):
        act = get_activation(self.activation)
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["Wout"] + params["bout"]

    def forward(self, params, x, training=False, key=None):
        return self._encode(params, x)[0]

    def reconstruct(self, params, x):
        return self._decode(params, self._encode(params, x)[0])

    def elbo_loss(self, params, x, key, eps=None):
        """Mean over the batch of the squared reconstruction error plus
        the KL term; ``eps`` (the standard normal draw) overrides
        ``key``'s."""
        mu, logvar = self._encode(params, x)
        if eps is None:
            eps = rng.normal(key, mu.shape, mu.device, mu.dtype)
        z = mu + torch.exp(0.5 * logvar) * eps
        rec = torch.sum((self._decode(params, z) - x) ** 2, dim=-1)
        kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar),
                              dim=-1)
        return torch.mean(rec + kl)

    def output_type(self, input_type):
        return (self.n_out,)


# -- capsules ---------------------------------------------------------------

def _squash(s, dim=-1, eps=1e-8):
    n2 = torch.sum(s * s, dim=dim, keepdim=True)
    return (n2 / (1 + n2)) * s / torch.sqrt(n2 + eps)


@dataclasses.dataclass
class PrimaryCapsules(Layer):
    """Convolution -> capsules -> squash (reference PrimaryCapsules.java):
    [B, capsules * oh * ow, capsule_dimensions]."""
    n_in: int = 0
    capsules: int = 8          # capsules per spatial position
    capsule_dimensions: int = 8
    kernel_size: Sequence[int] = (9, 9)
    stride: Sequence[int] = (2, 2)
    weight_init: str = "relu"

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        kh, kw = _pair(self.kernel_size)
        cout = self.capsules * self.capsule_dimensions
        return {"W": init_weights(generator, (kh, kw, n_in, cout),
                                  self.weight_init),
                "b": _zeros(generator, cout)}

    def forward(self, params, x, training=False, key=None):
        out = conv_ops.conv2d(x, params["W"], params["b"],
                              strides=_pair(self.stride), padding="VALID",
                              data_format="NCHW")
        caps = out.reshape(out.shape[0], self.capsule_dimensions, -1)
        return _squash(caps.transpose(1, 2))

    def output_type(self, input_type):
        c, h, w = input_type
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        return (self.capsules * oh * ow, self.capsule_dimensions)


@dataclasses.dataclass
class CapsuleLayer(Layer):
    """Dynamic-routing capsule layer (reference CapsuleLayer.java):
    ``W`` ``[in_caps, capsules, capsule_dimensions, in_dim]``,
    ``routings`` unrolled rounds."""
    input_capsules: int = 0
    input_capsule_dimensions: int = 0
    capsules: int = 10
    capsule_dimensions: int = 16
    routings: int = 3
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        n_caps = self.input_capsules or input_type[0]
        in_dim = self.input_capsule_dimensions or input_type[1]
        return {"W": init_weights(
            generator, (n_caps, self.capsules, self.capsule_dimensions,
                        in_dim), self.weight_init)}

    def forward(self, params, x, training=False, key=None):
        u_hat = torch.einsum("bid,iokd->biok", x, params["W"])
        logits = u_hat.new_zeros(u_hat.shape[:3])
        for _ in range(self.routings):
            c = torch.softmax(logits, dim=2)
            v = _squash(torch.einsum("bio,biok->bok", c, u_hat))
            logits = logits + torch.einsum("biok,bok->bio", u_hat, v)
        return v

    def output_type(self, input_type):
        return (self.capsules, self.capsule_dimensions)


@_no_params
@dataclasses.dataclass
class CapsuleStrengthLayer(Layer):
    """Capsule length per class (reference CapsuleStrengthLayer.java)."""

    def forward(self, params, x, training=False, key=None):
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-8)

    def output_type(self, input_type):
        return (input_type[0],)
