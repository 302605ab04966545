"""Layer configuration classes.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``. A layer is a
config with ``init_params(generator, input_type)`` (a param dict drawn
on the generator's device) and ``forward(params, x, training, key)`` on
tensors; the backward pass is autograd over the whole network. ``key``
is the step key of the layers that draw (dropout): an int or a 0-d int64
tensor on the network's device (``common/rng.py``).

Parameters keep the JAX package's layouts and key names, so weights
cross between the two unchanged: dense ``W`` is ``[n_in, n_out]``,
convolution ``W`` is HWIO ``[kh, kw, n_in, n_out]`` (permuted to torch's
OIHW inside ``conv_ops.conv2d``), batch-norm running stats are
``state_mean`` / ``state_var``. Input types are tuples without the batch
dim: FF ``(n,)``, CNN ``(c, h, w)`` NCHW, RNN ``(features, timesteps)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ...common.mesh import batch_memo, batch_moments
from ...ops import conv_ops, nn_ops, recurrent
from ...quant.transforms import QuantizedTensor, dequant_matmul, dequantize
from ..activations import get_activation
from ..losses import get_loss
from ..weights import init_weights

IntPair = Union[int, Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _zeros(generator, n):
    return torch.zeros((n,), device=generator.device)


@dataclasses.dataclass
class Layer:
    """Base layer config (reference nn/conf/layers/Layer.java)."""
    name: Optional[str] = None
    #: per-layer IWeightNoise (reference BaseLayer.weightNoise); overrides
    #: the network-level default from Builder.weight_noise()
    weight_noise: Optional[object] = None

    def init_params(self, generator, input_type):
        return {}

    def forward(self, params, x, training=False, key=None):
        raise NotImplementedError

    def output_type(self, input_type):
        return input_type

    def has_params(self) -> bool:
        return True

    def needs_key(self) -> bool:
        return False


@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully connected (reference conf/layers/DenseLayer.java)."""
    n_in: int = 0
    n_out: int = 0
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True
    dropout: float = 0.0

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        p = {"W": init_weights(generator, (n_in, self.n_out),
                               self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, self.n_out)
        return p

    def forward(self, params, x, training=False, key=None):
        # torch.matmul for a plain weight; an int8 twin's weight goes
        # through the fused dequant-matmul kernel on the card
        out = dequant_matmul(x, params["W"])
        if self.has_bias:
            out = out + params["b"]
        out = get_activation(self.activation)(out)
        if self.dropout > 0 and training and key is not None:
            out = nn_ops.dropout(out, self.dropout, key)
        return out

    def output_type(self, input_type):
        return (self.n_out,)

    def needs_key(self):
        return self.dropout > 0


@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (reference conf/layers/OutputLayer.java)."""
    loss: Union[str, Callable] = "mcxent"
    activation: str = "softmax"

    def compute_loss(self, labels, output, mask=None):
        return get_loss(self.loss)(labels, output, mask)


@dataclasses.dataclass
class LossLayer(Layer):
    """Loss without params (reference conf/layers/LossLayer.java)."""
    loss: Union[str, Callable] = "mcxent"
    activation: str = "identity"

    def forward(self, params, x, training=False, key=None):
        return get_activation(self.activation)(x)

    def compute_loss(self, labels, output, mask=None):
        return get_loss(self.loss)(labels, output, mask)

    def has_params(self):
        return False


@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2D convolution (reference conf/layers/ConvolutionLayer.java), NCHW."""
    n_in: int = 0     # input channels (inferred if 0)
    n_out: int = 0    # output channels
    kernel_size: IntPair = (3, 3)
    stride: IntPair = (1, 1)
    padding: Union[str, IntPair] = (0, 0)
    dilation: IntPair = (1, 1)
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True
    convolution_mode: str = "truncate"  # truncate|same (reference ConvolutionMode)

    def _padding_arg(self):
        if isinstance(self.padding, str):
            return self.padding
        if self.convolution_mode.lower() == "same":
            return "SAME"
        return _pair(self.padding)

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(generator, (kh, kw, n_in, self.n_out),
                               self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, self.n_out)
        return p

    def forward(self, params, x, training=False, key=None):
        W = params["W"]
        if isinstance(W, QuantizedTensor):
            W = dequantize(W, x.dtype)
        out = conv_ops.conv2d(x, W, params.get("b"),
                              strides=_pair(self.stride),
                              padding=self._padding_arg(),
                              dilation=_pair(self.dilation),
                              data_format="NCHW")
        return get_activation(self.activation)(out)

    def output_type(self, input_type):
        c, h, w = input_type
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        pad = self._padding_arg()
        if pad == "SAME":
            oh = -(-h // sh)
            ow = -(-w // sw)
        else:
            ph, pw = (pad if isinstance(pad, tuple) else (0, 0))
            if isinstance(pad, str):
                ph = pw = 0
            oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        return (self.n_out, oh, ow)


@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling (reference conf/layers/SubsamplingLayer.java)."""
    pooling_type: str = "max"  # max|avg|pnorm
    kernel_size: IntPair = (2, 2)
    stride: IntPair = None
    #: average-pool divisor counts padded cells (reference legacy
    #: behavior); keras/TF SAME pooling excludes them (importer sets False)
    avg_include_pad: bool = True
    padding: Union[str, IntPair] = (0, 0)
    pnorm: int = 2

    def forward(self, params, x, training=False, key=None):
        stride = self.stride if self.stride is not None else self.kernel_size
        pad = self.padding if isinstance(self.padding, str) else _pair(self.padding)
        if isinstance(pad, tuple) and pad == (0, 0):
            pad = "VALID"
        pt = self.pooling_type.lower()
        if pt == "max":
            return conv_ops.maxpool2d(x, _pair(self.kernel_size), _pair(stride),
                                      pad, "NCHW")
        if pt == "avg":
            return conv_ops.avgpool2d(x, _pair(self.kernel_size), _pair(stride),
                                      pad, "NCHW",
                                      include_pad=self.avg_include_pad)
        return conv_ops.pnormpool2d(x, _pair(self.kernel_size), _pair(stride),
                                    pad, self.pnorm, "NCHW")

    def output_type(self, input_type):
        c, h, w = input_type
        kh, kw = _pair(self.kernel_size)
        stride = self.stride if self.stride is not None else self.kernel_size
        sh, sw = _pair(stride)
        if isinstance(self.padding, str):
            if self.padding.upper() == "SAME":
                return (c, -(-h // sh), -(-w // sw))
            ph = pw = 0  # "VALID"
        else:
            ph, pw = _pair(self.padding)
        return (c, (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1)

    def has_params(self):
        return False


def _stats_axes(x):
    """(channel axis, reduce axes): NCHW channel axis, or FF features."""
    axis = 1 if x.dim() >= 3 else x.dim() - 1
    return axis, tuple(i for i in range(x.dim()) if i != axis)


@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch norm (reference conf/layers/BatchNormalization.java).

    Running stats are non-trainable state in params under ``state_*``
    keys: the biased batch variance, updated as ``decay * old + (1 -
    decay) * batch`` by the network after each step (``new_state``) —
    not ``nn.BatchNorm2d``'s unbiased variance and momentum convention.
    Batch statistics are computed in f32, also under bf16 compute; inside
    a ``common.mesh.batch_context`` they are the global batch's (one
    collective over the data-parallel group a layer, as ``SyncBatchNorm``
    takes them).
    """
    n_out: int = 0  # inferred
    decay: float = 0.9
    eps: float = 1e-5
    use_gamma_beta: bool = True

    def _channels(self, input_type):
        return self.n_out or input_type[0]

    def init_params(self, generator, input_type):
        c = self._channels(input_type)
        dev = generator.device
        p = {"state_mean": torch.zeros((c,), device=dev),
             "state_var": torch.ones((c,), device=dev)}
        if self.use_gamma_beta:
            p["gamma"] = torch.ones((c,), device=dev)
            p["beta"] = torch.zeros((c,), device=dev)
        return p

    @staticmethod
    def _batch_stats(x, fresh=False):
        """(axis, mean, var) of the layer input ``x`` in f32; inside a
        batch context the running statistics reuse the forward's, so both
        share one collective."""
        def stats():
            xf = x.float()
            axis, red = _stats_axes(xf)
            return (axis,) + batch_moments(xf, red)
        return batch_memo(x, stats, fresh)

    def forward(self, params, x, training=False, key=None):
        xf = x.float()
        if training:
            axis, mean, var = self._batch_stats(x, fresh=True)
        else:
            axis, _ = _stats_axes(xf)
            mean, var = params["state_mean"], params["state_var"]
        out = nn_ops.batchnorm(xf, mean, var, params.get("gamma"),
                               params.get("beta"), self.eps, axis)
        return out.to(x.dtype)

    def new_state(self, params, x, labels=None):
        """Updated running stats given a training batch (applied by the net)."""
        _, mean, var = self._batch_stats(x)
        return {"state_mean": self.decay * params["state_mean"]
                + (1 - self.decay) * mean,
                "state_var": self.decay * params["state_var"]
                + (1 - self.decay) * var}


@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """LRN (reference conf/layers/LocalResponseNormalization.java)."""
    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def forward(self, params, x, training=False, key=None):
        xt = x.permute(0, 2, 3, 1)  # channel-last for the op
        out = nn_ops.lrn(xt, self.n // 2, self.k, self.alpha, self.beta)
        return out.permute(0, 3, 1, 2)

    def has_params(self):
        return False


@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Index → vector lookup (reference conf/layers/EmbeddingLayer.java)."""
    n_in: int = 0   # vocab
    n_out: int = 0  # embedding dim
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        return {"W": init_weights(generator, (self.n_in, self.n_out),
                                  self.weight_init)}

    def forward(self, params, x, training=False, key=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        return dequantize(params["W"])[idx]

    def output_type(self, input_type):
        return (self.n_out,)


@dataclasses.dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """A sequence of indices -> RNN-format [B, n_out, T] (reference
    EmbeddingSequenceLayer)."""

    def forward(self, params, x, training=False, key=None):
        emb = dequantize(params["W"])[x.long()]  # [B, T, E]
        return emb.transpose(1, 2)               # [B, E, T]

    def output_type(self, input_type):
        t = input_type[-1] if len(input_type) > 1 else input_type[0]
        return (self.n_out, t)


@dataclasses.dataclass
class LSTM(Layer):
    """LSTM over RNN-format input [B, features, T] (reference
    conf/layers/LSTM.java), through ``ops.recurrent.lstm_layer``: gates
    [i, f, g, o], the forget block of ``b`` initialized to
    ``forget_gate_bias_init``. Mask-aware (``accepts_mask``)."""
    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    weight_init: str = "xavier"
    forget_gate_bias_init: float = 1.0
    return_sequence: bool = True

    accepts_mask = True

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        H = self.n_out
        b = _zeros(generator, 4 * H)
        b[H:2 * H] = self.forget_gate_bias_init
        return {"Wx": init_weights(generator, (n_in, 4 * H),
                                   self.weight_init),
                "Wh": init_weights(generator, (H, 4 * H), self.weight_init),
                "b": b}

    def forward(self, params, x, training=False, key=None, mask=None):
        h_seq, h_last, _ = recurrent.lstm_layer(
            x.transpose(1, 2), params["Wx"], params["Wh"], params["b"],
            mask=mask)
        if self.return_sequence:
            return h_seq.transpose(1, 2)  # [B, n_out, T]
        return h_last

    def output_type(self, input_type):
        if self.return_sequence and len(input_type) == 2:
            return (self.n_out, input_type[1])
        return (self.n_out,)


# GravesLSTM: the reference's deprecated name for the same layer
GravesLSTM = LSTM


@dataclasses.dataclass
class Bidirectional(Layer):
    """Bidirectional wrapper (reference conf/layers/recurrent/
    Bidirectional.java): the wrapped layer over the sequence and, with
    its own params, over the time-reversed sequence (and mask), merged by
    ``mode``: concat | add | mul | ave."""
    fwd: Layer = None
    mode: str = "concat"

    def init_params(self, generator, input_type):
        return {"fwd": self.fwd.init_params(generator, input_type),
                "bwd": self.fwd.init_params(generator, input_type)}

    @property
    def accepts_mask(self):
        return getattr(self.fwd, "accepts_mask", False)

    @property
    def return_sequence(self):
        # a last-step inner layer consumes the time axis (and any mask)
        return getattr(self.fwd, "return_sequence", True)

    def forward(self, params, x, training=False, key=None, mask=None):
        mk = {"mask": mask} if mask is not None else {}
        out_f = self.fwd.forward(params["fwd"], x, training, key, **mk)
        mk_b = ({"mask": torch.flip(mask, dims=(-1,))} if mask is not None
                else {})
        out_b = self.fwd.forward(params["bwd"], torch.flip(x, dims=(-1,)),
                                 training, key, **mk_b)
        # a 2-D [B, H] inner output has no time axis to un-flip: the
        # backward half's final state is the sequence start's (Keras'
        # backward_layer output)
        if out_b.dim() == 3:
            out_b = torch.flip(out_b, dims=(-1,))
        if mask is not None and out_f.dim() == 3:
            # Keras zero_output_for_mask: masked positions are zeroed in
            # both halves, so the two sequences stay aligned
            keep = mask[:, None, :].to(out_f.dtype)
            out_f = out_f * keep
            out_b = out_b * keep
        if self.mode == "concat":
            return torch.cat([out_f, out_b], dim=1)
        if self.mode == "add":
            return out_f + out_b
        if self.mode == "mul":
            return out_f * out_b
        return (out_f + out_b) / 2

    def output_type(self, input_type):
        inner = self.fwd.output_type(input_type)
        if self.mode == "concat":
            return (inner[0] * 2,) + tuple(inner[1:])
        return inner


@dataclasses.dataclass
class RnnOutputLayer(Layer):
    """Per-timestep output head on [B, F, T] (reference RnnOutputLayer);
    its loss takes time into the batch, masked by a [B, T] mask."""
    n_in: int = 0
    n_out: int = 0
    activation: str = "softmax"
    loss: Union[str, Callable] = "mcxent"
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        return {"W": init_weights(generator, (n_in, self.n_out),
                                  self.weight_init),
                "b": _zeros(generator, self.n_out)}

    def forward(self, params, x, training=False, key=None):
        out = torch.matmul(x.transpose(1, 2), params["W"]) + params["b"]
        out = get_activation(self.activation)(out)
        return out.transpose(1, 2)  # [B, n_out, T]

    def compute_loss(self, labels, output, mask=None):
        return _temporal_loss(self.loss, labels, output, mask)

    def output_type(self, input_type):
        return ((self.n_out, input_type[1]) if len(input_type) == 2
                else (self.n_out,))


def _temporal_loss(loss, labels, output, mask):
    """A per-timestep loss on [B, C, T]: time moved into the batch, the
    [B, T] mask flattened beside it."""
    c = output.shape[1]
    lab = labels.transpose(1, 2).reshape(-1, labels.shape[1])
    out = output.transpose(1, 2).reshape(-1, c)
    m = mask.reshape(-1) if mask is not None else None
    return get_loss(loss)(lab, out, m)


@dataclasses.dataclass
class DropoutLayer(Layer):
    rate: float = 0.5

    def forward(self, params, x, training=False, key=None):
        if training and key is not None and self.rate > 0:
            return nn_ops.dropout(x, self.rate, key)
        return x

    def has_params(self):
        return False

    def needs_key(self):
        return True


@dataclasses.dataclass
class ActivationLayer(Layer):
    activation: str = "relu"

    def forward(self, params, x, training=False, key=None):
        return get_activation(self.activation)(x)

    def has_params(self):
        return False


@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over spatial/time dims (reference GlobalPoolingLayer)."""
    pooling_type: str = "max"  # max|avg|sum|pnorm
    pnorm: int = 2

    def forward(self, params, x, training=False, key=None):
        axes = tuple(range(2, x.dim()))  # pool everything after [B, C]
        pt = self.pooling_type.lower()
        if pt == "max":
            return torch.amax(x, dim=axes)
        if pt == "avg":
            return torch.mean(x, dim=axes)
        if pt == "sum":
            return torch.sum(x, dim=axes)
        return torch.sum(torch.abs(x) ** self.pnorm, dim=axes) \
            ** (1.0 / self.pnorm)

    def output_type(self, input_type):
        return (input_type[0],)

    def has_params(self):
        return False


@dataclasses.dataclass
class Convolution1DLayer(Layer):
    """1-D convolution over RNN-format input [B, features, T] (reference
    Conv1DLayer); ``W`` is ``[k, n_in, n_out]``.

    padding "CAUSAL" (keras Conv1D padding='causal'): left-pads the time
    axis with dilation*(kernel_size-1) zeros and convolves VALID, so
    output t sees only inputs <= t."""
    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: Union[str, int] = "SAME"
    dilation: int = 1
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        p = {"W": init_weights(generator, (self.kernel_size, n_in,
                                           self.n_out), self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, self.n_out)
        return p

    def _is_causal(self):
        return (isinstance(self.padding, str)
                and self.padding.upper() == "CAUSAL")

    def forward(self, params, x, training=False, key=None):
        if self._is_causal():
            left = self.dilation * (self.kernel_size - 1)
            x = torch.nn.functional.pad(x, (left, 0))
            pad = "VALID"
        else:
            pad = (self.padding if isinstance(self.padding, str)
                   else int(self.padding))
        return get_activation(self.activation)(
            conv_ops.conv1d(x, params["W"], params.get("b"),
                            strides=self.stride, padding=pad,
                            dilation=self.dilation, data_format="NCW"))

    def output_type(self, input_type):
        c, t = input_type
        if self._is_causal() or (isinstance(self.padding, str)
                                 and self.padding.upper() == "SAME"):
            ot = -(-t // self.stride)
        else:
            p = self.padding if not isinstance(self.padding, str) else 0
            span = self.dilation * (self.kernel_size - 1) + 1
            ot = (t + 2 * p - span) // self.stride + 1
        return (self.n_out, ot)


@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self attention over RNN-format input [B, F, T]
    (reference SelfAttentionLayer), through
    ``nn_ops.multi_head_dot_product_attention``."""
    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = None
    weight_init: str = "xavier"

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        hs = self.head_size or (self.n_out // self.n_heads)
        proj = (n_in, self.n_heads, hs)
        return {"Wq": init_weights(generator, proj, self.weight_init),
                "Wk": init_weights(generator, proj, self.weight_init),
                "Wv": init_weights(generator, proj, self.weight_init),
                "Wo": init_weights(generator, (self.n_heads * hs,
                                               self.n_out),
                                   self.weight_init)}

    def forward(self, params, x, training=False, key=None):
        xt = x.transpose(1, 2)  # [B, T, F]
        out = nn_ops.multi_head_dot_product_attention(
            xt, xt, xt, params["Wq"], params["Wk"], params["Wv"],
            params["Wo"])
        return out.transpose(1, 2)

    def output_type(self, input_type):
        return (self.n_out, input_type[1])


@dataclasses.dataclass
class Upsampling2D(Layer):
    """Nearest upsampling by repetition (reference Upsampling2D)."""
    size: IntPair = (2, 2)

    def forward(self, params, x, training=False, key=None):
        sh, sw = _pair(self.size)
        return conv_ops.upsampling2d(x, sh, sw, "NCHW")

    def output_type(self, input_type):
        c, h, w = input_type
        sh, sw = _pair(self.size)
        return (c, h * sh, w * sw)

    def has_params(self):
        return False


@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """Zero padding of NCHW input (reference ZeroPaddingLayer)."""
    padding: Sequence[int] = (1, 1, 1, 1)  # top, bottom, left, right

    def forward(self, params, x, training=False, key=None):
        t, b, l, r = self.padding
        return torch.nn.functional.pad(x, (l, r, t, b))

    def output_type(self, input_type):
        c, h, w = input_type
        t, b, l, r = self.padding
        return (c, h + t + b, w + l + r)

    def has_params(self):
        return False


@dataclasses.dataclass
class DeconvolutionLayer(ConvolutionLayer):
    """Transposed convolution (reference conf/layers/Deconvolution2D.java);
    ``W`` is ``[kh, kw, n_out, n_in]``.

    ``output_type`` keeps the JAX package's formula, ``s(h-1)+k-2p``
    (torch's), while the forward pads lax's way, ``s(h-1)+2p-k+2``: with
    explicit padding other than ``k // 2`` the two disagree on both
    sides (``ROADMAP.md`` queue 3, reference fault 8)."""

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(generator, (kh, kw, self.n_out, n_in),
                               self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, self.n_out)
        return p

    def forward(self, params, x, training=False, key=None):
        out = conv_ops.deconv2d(x, params["W"], params.get("b"),
                                strides=_pair(self.stride),
                                padding=self._padding_arg(),
                                data_format="NCHW")
        return get_activation(self.activation)(out)

    def output_type(self, input_type):
        c, h, w = input_type
        sh, sw = _pair(self.stride)
        kh, kw = _pair(self.kernel_size)
        pad = self._padding_arg()
        if pad == "SAME":
            return (self.n_out, h * sh, w * sw)
        ph, pw = pad if isinstance(pad, tuple) else (0, 0)
        return (self.n_out, sh * (h - 1) + kh - 2 * ph,
                sw * (w - 1) + kw - 2 * pw)


@dataclasses.dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise-separable convolution (reference
    SeparableConvolution2D): ``Wd`` ``[kh, kw, n_in, depth_multiplier]``,
    then the 1x1 ``Wp`` ``[1, 1, n_in * depth_multiplier, n_out]``."""
    depth_multiplier: int = 1

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        kh, kw = _pair(self.kernel_size)
        p = {"Wd": init_weights(generator,
                                (kh, kw, n_in, self.depth_multiplier),
                                self.weight_init),
             "Wp": init_weights(generator,
                                (1, 1, n_in * self.depth_multiplier,
                                 self.n_out), self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, self.n_out)
        return p

    def forward(self, params, x, training=False, key=None):
        out = conv_ops.sconv2d(x, params["Wd"], params["Wp"],
                               params.get("b"), strides=_pair(self.stride),
                               padding=self._padding_arg(),
                               data_format="NCHW")
        return get_activation(self.activation)(out)


@dataclasses.dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """Depthwise convolution (reference DepthwiseConvolution2D): ``W``
    ``[kh, kw, n_in, depth_multiplier]``, ``n_in * depth_multiplier``
    output channels."""
    depth_multiplier: int = 1

    def init_params(self, generator, input_type):
        n_in = self.n_in or input_type[0]
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(generator,
                               (kh, kw, n_in, self.depth_multiplier),
                               self.weight_init)}
        if self.has_bias:
            p["b"] = _zeros(generator, n_in * self.depth_multiplier)
        return p

    def forward(self, params, x, training=False, key=None):
        out = conv_ops.depthwise_conv2d(x, params["W"], params.get("b"),
                                        strides=_pair(self.stride),
                                        padding=self._padding_arg(),
                                        data_format="NCHW")
        return get_activation(self.activation)(out)

    def output_type(self, input_type):
        base = super().output_type(input_type)
        return (input_type[0] * self.depth_multiplier,) + base[1:]


# the extended layer set lives in layers_extra.py; re-exported here as the
# JAX package does, so the catalog (and the JSON's getattr on this
# module) has one namespace. The same seven classes are left out as
# there (ChannelNormalizationLayer, GRUResetAfter,
# LayerNormalizationLayer, PermuteLayer, RescaleLayer, ReshapeLayer,
# SpatialDropout): a configuration holding one writes its JSON and cannot
# read it back, on both sides (ROADMAP.md queue 3, reference fault 4)
from .layers_extra import (  # noqa: E402,F401
    AlphaDropout, CapsuleLayer, CapsuleStrengthLayer, CenterLossOutputLayer,
    Cnn3DLossLayer, CnnLossLayer, Convolution3D, Cropping1D, Cropping2D,
    Cropping3D, DepthToSpaceLayer, ElementWiseMultiplicationLayer,
    FrozenLayer, GRU, GaussianDropout, GaussianNoise, LastTimeStep,
    LearnedSelfAttentionLayer, LocallyConnected1D, LocallyConnected2D,
    MaskLayer, MaskZeroLayer, PReLULayer, PrimaryCapsules,
    RecurrentAttentionLayer, RepeatVector, RnnLossLayer, SimpleRnn,
    SpaceToDepthLayer, Subsampling1DLayer, Subsampling3DLayer,
    TimeDistributed, Upsampling1D, Upsampling3D, VariationalAutoencoder,
    Yolo2OutputLayer, ZeroPadding1DLayer, ZeroPadding3DLayer)
