"""Keras HDF5 model import -> MultiLayerNetwork / ComputationGraph.

Counterpart of ``deeplearning4j_tpu/modelimport/keras/importer.py`` (the
reference's ``KerasModelImport.java:45-151`` entry points,
``KerasModel.java:639`` getComputationGraph, ``KerasSequentialModel.java``
and the layer adapters under ``keras/layers/**``), with the same adapters,
layout bookkeeping and errors. Two things differ:

- the h5 file is read with the port's own HDF5 reader
  (``modelimport/h5.py``), not ``h5py``;
- each adapter maps Keras's weights to numpy arrays, and the imported
  network holds them as tensors on ``device`` (the card by default).

Handles both Keras 2 and Keras 3 legacy-h5 flavors (model_config JSON +
model_weights groups). Data-format note: Keras is channels-last (NHWC);
this framework's conv stack is NCHW like the reference DL4J — the importer
converts kernels (HWIO is shared) and reorders Flatten->Dense kernels from
(h,w,c) to (c,h,w) row order, the same fixup the reference applies via
KerasFlatten's preprocessor.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ...bridge import params_from_numpy
from ...nn.conf import layers as L
from ...nn.conf import layers_extra as LX
from ...nn.conf.config import InputType, NeuralNetConfiguration
from ...nn.graph.computation_graph import ComputationGraph
from ...nn.graph.vertices import ElementWiseVertex, MergeVertex
from ...nn.multilayer import MultiLayerNetwork
from .. import h5
from ..ir import ImportException

_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "softmax": "softmax", "sigmoid": "sigmoid", "tanh": "tanh",
    "elu": "elu", "selu": "selu", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid",
    "swish": "swish", "silu": "swish", "gelu": "gelu", "mish": "mish",
    "exponential": "exp", "leaky_relu": "leakyrelu",
}


def _act(name) -> str:
    if name is None:
        return "identity"
    if isinstance(name, dict):  # serialized Activation object
        name = name.get("config", {}).get("name", "linear")
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ImportException(f"unsupported Keras activation {name!r}")


def _pair(v):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def _keras_shape_to_input_type(shape) -> Optional[Tuple[int, ...]]:
    """Keras shape (no batch) -> InputType tuple. NHWC -> (C,H,W);
    [T, F] -> (F, T); [F] -> (F,)."""
    if shape is None:
        return None
    dims = [d for d in shape]
    if len(dims) == 4:
        d, h, w, c = dims
        return InputType.convolutional3d(d, h, w, c)
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(h, w, c)
    if len(dims) == 2:
        t, f = dims
        return InputType.recurrent(f, t if t is not None else -1)
    if len(dims) == 1:
        return InputType.feed_forward(dims[0]) if dims[0] else None
    return None


class _Adapted:
    """One imported layer: our config + a weight-mapping function."""

    def __init__(self, layer: Optional[L.Layer],
                 set_weights: Optional[Callable] = None):
        self.layer = layer
        self.set_weights = set_weights  # (weights, in_type) -> params dict


def _dense_adapter(cfg, keras_in_shape):
    units = int(cfg["units"])
    use_bias = bool(cfg.get("use_bias", True))
    layer = L.DenseLayer(n_out=units, activation=_act(cfg.get("activation")),
                         has_bias=use_bias, name=cfg.get("name"))

    def set_weights(weights, in_type):
        kernel = np.asarray(weights[0])
        # Flatten-after-conv fixup: Keras flattens (..., c) channels-last,
        # ours (c, ...) channels-first (2-D and 3-D conv activations)
        if keras_in_shape is not None and len(keras_in_shape) in (3, 4) and \
                kernel.shape[0] == int(np.prod(keras_in_shape)):
            nd = len(keras_in_shape)
            k = kernel.reshape(*keras_in_shape, units)
            kernel = np.moveaxis(k, nd - 1, 0).reshape(-1, units)
        p = {"W": np.asarray(kernel)}
        if use_bias:
            p["b"] = np.asarray(weights[1])
        return p

    return _Adapted(layer, set_weights)


def _conv2d_adapter(cfg, depthwise=False):
    strides = _pair(cfg.get("strides", (1, 1)))
    dilation = _pair(cfg.get("dilation_rate", (1, 1)))
    padding = "SAME" if cfg.get("padding", "valid") == "same" else "VALID"
    use_bias = bool(cfg.get("use_bias", True))
    act = _act(cfg.get("activation"))
    if depthwise:
        mult = int(cfg.get("depth_multiplier", 1))
        layer = L.DepthwiseConvolution2D(
            n_out=0, depth_multiplier=mult,
            kernel_size=_pair(cfg["kernel_size"]), stride=strides,
            padding=padding, dilation=dilation, activation=act,
            has_bias=use_bias, name=cfg.get("name"))
    else:
        layer = L.ConvolutionLayer(
            n_out=int(cfg["filters"]), kernel_size=_pair(cfg["kernel_size"]),
            stride=strides, padding=padding, dilation=dilation,
            activation=act, has_bias=use_bias, name=cfg.get("name"))

    def set_weights(weights, in_type):
        p = {"W": np.asarray(weights[0])}  # HWIO both sides
        if use_bias:
            p["b"] = np.asarray(weights[1])
        return p

    return _Adapted(layer, set_weights)


def _pool2d_adapter(cfg, pool_type):
    pool = _pair(cfg.get("pool_size", (2, 2)))
    strides = _pair(cfg.get("strides") or cfg.get("pool_size", (2, 2)))
    padding = "SAME" if cfg.get("padding", "valid") == "same" else "VALID"
    return _Adapted(L.SubsamplingLayer(
        pooling_type=pool_type, kernel_size=pool, stride=strides,
        padding=padding, avg_include_pad=False,  # keras/TF semantics
        name=cfg.get("name")))


def _bn_adapter(cfg):
    scale = bool(cfg.get("scale", True))
    center = bool(cfg.get("center", True))
    layer = L.BatchNormalization(eps=float(cfg.get("epsilon", 1e-3)),
                                 decay=float(cfg.get("momentum", 0.99)),
                                 use_gamma_beta=True, name=cfg.get("name"))

    def set_weights(weights, in_type):
        w = [np.asarray(a) for a in weights]
        i = 0
        gamma = w[i] if scale else None
        i += 1 if scale else 0
        beta = w[i] if center else None
        i += 1 if center else 0
        mean, var = w[i], w[i + 1]
        c = mean.shape[0]
        return {"gamma": np.asarray(gamma if gamma is not None
                                     else np.ones(c, np.float32)),
                "beta": np.asarray(beta if beta is not None
                                    else np.zeros(c, np.float32)),
                "state_mean": np.asarray(mean),
                "state_var": np.asarray(var)}

    return _Adapted(layer, set_weights)


def _embedding_adapter(cfg):
    layer = L.EmbeddingSequenceLayer(n_in=int(cfg["input_dim"]),
                                     n_out=int(cfg["output_dim"]),
                                     name=cfg.get("name"))

    def set_weights(weights, in_type):
        return {"W": np.asarray(weights[0])}

    return _Adapted(layer, set_weights)


def _lstm_adapter(cfg):
    units = int(cfg["units"])
    if _act(cfg.get("activation", "tanh")) != "tanh" or \
            cfg.get("recurrent_activation", "sigmoid") != "sigmoid":
        # only the tanh/sigmoid kernel exists (nn/conf/layers.py LSTM ->
        # recurrent.lstm_layer); importing anything else would silently
        # compute different outputs
        raise ImportException(
            f"Keras LSTM with activation={cfg.get('activation')!r} / "
            f"recurrent_activation={cfg.get('recurrent_activation')!r} is "
            f"not supported (only tanh/sigmoid)")
    layer = L.LSTM(n_out=units, activation="tanh",
                   return_sequence=bool(cfg.get("return_sequences", False)),
                   name=cfg.get("name"))

    def set_weights(weights, in_type):
        kernel, rec, bias = [np.asarray(a) for a in weights[:3]]
        # Keras gate order [i, f, c, o] == ours — direct copy
        return {"Wx": np.asarray(kernel), "Wh": np.asarray(rec),
                "b": np.asarray(bias)}

    return _Adapted(layer, set_weights)


def _gru_adapter(cfg):
    """Keras GRU: gate columns (z, r, h). reset_after=True (the default,
    CuDNN convention) maps to GRUResetAfter / the gru_onnx kernel;
    reset_after=False maps to the fused-gate GRU layer."""
    units = int(cfg["units"])
    if _act(cfg.get("activation", "tanh")) != "tanh" or \
            cfg.get("recurrent_activation", "sigmoid") != "sigmoid":
        raise ImportException("Keras GRU with non-default activations is "
                              "not supported")
    reset_after = bool(cfg.get("reset_after", True))
    ret_seq = bool(cfg.get("return_sequences", False))
    if reset_after:
        inner = LX.GRUResetAfter(n_out=units, name=cfg.get("name"))
    else:
        inner = LX.GRU(n_out=units, name=cfg.get("name"))
    layer = inner if ret_seq else LX.LastTimeStep(underlying=inner,
                                                  name=cfg.get("name"))

    def set_weights(weights, in_type):
        kernel, rec = np.asarray(weights[0]), np.asarray(weights[1])
        bias = np.asarray(weights[2]) if len(weights) > 2 else None
        H = units
        if reset_after:
            w = kernel.T                      # [3H, In], rows z|r|h
            r = rec.T
            if bias is None:
                b = np.zeros(6 * H, np.float32)
            elif bias.ndim == 2:              # [2, 3H]: input + recurrent
                b = np.concatenate([bias[0], bias[1]])
            else:
                b = np.concatenate([bias, np.zeros(3 * H, bias.dtype)])
            return {"W": np.asarray(w), "R": np.asarray(r),
                    "b": np.asarray(b)}
        kz, kr, kh = np.split(kernel, 3, axis=1)
        rz, rr, rh = np.split(rec, 3, axis=1)
        if bias is None:
            bias = np.zeros(3 * H, np.float32)
        bz, br, bh = np.split(bias.reshape(-1)[:3 * H], 3)
        w_ru = np.concatenate([np.concatenate([kr, kz], 1),
                               np.concatenate([rr, rz], 1)], 0)
        w_c = np.concatenate([kh, rh], 0)
        return {"Wru": np.asarray(w_ru), "Wc": np.asarray(w_c),
                "bru": np.asarray(np.concatenate([br, bz])),
                "bc": np.asarray(bh)}

    return _Adapted(layer, set_weights)


def _bidirectional_adapter(cfg):
    inner_spec = cfg.get("layer", {})
    inner_cls = inner_spec.get("class_name")
    inner_cfg = dict(inner_spec.get("config", {}))
    mode = {"concat": "concat", "sum": "add", "mul": "mul",
            "ave": "ave", None: "concat"}.get(cfg.get("merge_mode",
                                                      "concat"))
    if mode is None:
        raise ImportException(
            f"Bidirectional merge_mode={cfg.get('merge_mode')!r} "
            f"unsupported")
    inner = _adapt_layer(inner_cls, inner_cfg, None)
    layer = L.Bidirectional(fwd=inner.layer, mode=mode,
                            name=cfg.get("name"))

    def set_weights(weights, in_type):
        half = len(weights) // 2
        return {"fwd": inner.set_weights(weights[:half], in_type),
                "bwd": inner.set_weights(weights[half:], in_type)}

    return _Adapted(layer, set_weights)


def _time_distributed_adapter(cfg):
    inner_spec = cfg.get("layer", {})
    if inner_spec.get("class_name") != "Dense":
        raise ImportException("TimeDistributed only supports Dense "
                              f"(got {inner_spec.get('class_name')!r})")
    inner = _dense_adapter(dict(inner_spec.get("config", {})), None)
    layer = LX.TimeDistributed(underlying=inner.layer, name=cfg.get("name"))
    return _Adapted(layer, inner.set_weights)


def _conv1d_adapter(cfg):
    pad = cfg.get("padding", "valid")
    layer = L.Convolution1DLayer(
        n_out=int(cfg["filters"]), kernel_size=int(_pair(cfg["kernel_size"])[0]),
        stride=int(_pair(cfg.get("strides", 1))[0]),
        dilation=int(_pair(cfg.get("dilation_rate", 1))[0]),
        padding={"same": "SAME", "causal": "CAUSAL"}.get(pad, "VALID"),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))

    def set_weights(weights, in_type):
        p = {"W": np.asarray(weights[0])}  # [k, in, out] shared
        if cfg.get("use_bias", True):
            p["b"] = np.asarray(weights[1])
        return p

    return _Adapted(layer, set_weights)


def _conv3d_adapter(cfg):
    layer = LX.Convolution3D(
        n_out=int(cfg["filters"]),
        kernel_size=tuple(int(k) for k in cfg["kernel_size"]),
        stride=tuple(int(s) for s in cfg.get("strides", (1, 1, 1))),
        padding="SAME" if cfg.get("padding", "valid") == "same" else "VALID",
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))

    def set_weights(weights, in_type):
        p = {"W": np.asarray(weights[0])}  # DHWIO both sides
        if cfg.get("use_bias", True):
            p["b"] = np.asarray(weights[1])
        return p

    return _Adapted(layer, set_weights)


def _separable_conv2d_adapter(cfg):
    use_bias = bool(cfg.get("use_bias", True))
    layer = L.SeparableConvolution2D(
        n_out=int(cfg["filters"]), kernel_size=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", (1, 1))),
        padding="SAME" if cfg.get("padding", "valid") == "same" else "VALID",
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        activation=_act(cfg.get("activation")), has_bias=use_bias,
        name=cfg.get("name"))

    def set_weights(weights, in_type):
        p = {"Wd": np.asarray(weights[0]),
             "Wp": np.asarray(weights[1])}
        if use_bias:
            p["b"] = np.asarray(weights[2])
        return p

    return _Adapted(layer, set_weights)


def _conv2d_transpose_adapter(cfg):
    use_bias = bool(cfg.get("use_bias", True))
    layer = L.DeconvolutionLayer(
        n_out=int(cfg["filters"]), kernel_size=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", (1, 1))),
        padding="SAME" if cfg.get("padding", "valid") == "same" else "VALID",
        activation=_act(cfg.get("activation")), has_bias=use_bias,
        name=cfg.get("name"))

    def set_weights(weights, in_type):
        # keras kernel is [kh, kw, out, in] — ours too
        p = {"W": np.asarray(weights[0])}
        if use_bias:
            p["b"] = np.asarray(weights[1])
        return p

    return _Adapted(layer, set_weights)


def _locally_connected2d_adapter(cfg):
    if int(cfg.get("implementation", 1)) not in (1, 2, 3):
        raise ImportException("unknown LocallyConnected2D implementation")
    use_bias = bool(cfg.get("use_bias", True))
    kh, kw = _pair(cfg["kernel_size"])
    layer = LX.LocallyConnected2D(
        n_out=int(cfg["filters"]), kernel_size=(kh, kw),
        stride=_pair(cfg.get("strides", (1, 1))),
        activation=_act(cfg.get("activation")), has_bias=use_bias,
        name=cfg.get("name"))

    def set_weights(weights, in_type):
        k = np.asarray(weights[0])        # [P, kh*kw*in, out] (keras order)
        P, _, out = k.shape
        c = k.shape[1] // (kh * kw)
        # keras flattens patches (kh, kw, c); ours are channel-major (c,kh,kw)
        k = k.reshape(P, kh, kw, c, out).transpose(0, 3, 1, 2, 4) \
            .reshape(P, c * kh * kw, out)
        p = {"W": np.asarray(k)}
        if use_bias:
            p["b"] = np.asarray(weights[1]).reshape(P, out)
        return p

    return _Adapted(layer, set_weights)


def _prelu_adapter(cfg):
    layer = LX.PReLULayer(name=cfg.get("name"))

    def set_weights(weights, in_type):
        alpha = np.asarray(weights[0])
        if alpha.ndim > 1 and alpha.size == alpha.shape[-1]:
            alpha = alpha.reshape(-1)       # shared over all but channels
        elif alpha.ndim > 1:
            # per-position alpha: keras holds it channels-last (the
            # batchless input shape); our activations are channels-first
            alpha = np.moveaxis(alpha, -1, 0)
        return {"alpha": np.asarray(alpha)}

    return _Adapted(layer, set_weights)


def _layer_norm_adapter(cfg):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        if len(axis) != 1:
            raise ImportException("multi-axis LayerNormalization "
                                  "unsupported")
        axis = axis[0]
    if int(axis) not in (-1,):
        raise ImportException("only axis=-1 LayerNormalization supported")
    layer = LX.LayerNormalizationLayer(eps=float(cfg.get("epsilon", 1e-3)),
                                       name=cfg.get("name"))

    def set_weights(weights, in_type):
        ws = [np.asarray(a) for a in weights]
        if bool(cfg.get("scale", True)):
            gamma, rest = ws[0], ws[1:]
        else:
            gamma, rest = np.ones(ws[0].shape[0], np.float32), ws
        beta = rest[0] if rest and bool(cfg.get("center", True)) \
            else np.zeros(gamma.shape[0], np.float32)
        return {"gamma": np.asarray(gamma), "beta": np.asarray(beta)}

    return _Adapted(layer, set_weights)


def _cropping_tuple(val, n):
    """Keras cropping/padding spec -> flat per-side tuple of length 2n."""
    if isinstance(val, int):
        return (val, val) * n
    val = list(val)
    if all(isinstance(v, int) for v in val):
        if len(val) == n:          # symmetric per-dim
            return tuple(x for v in val for x in (v, v))
        return tuple(int(v) for v in val)  # already per-side (1-D case)
    return tuple(int(x) for pair in val for x in pair)


def _simple_rnn_adapter(cfg):
    units = int(cfg["units"])
    inner = L.SimpleRnn(n_out=units,
                        activation=_act(cfg.get("activation", "tanh")),
                        name=cfg.get("name"))
    # keras return_sequences=False -> last timestep only (same wrapping the
    # GRU adapter applies)
    layer = inner if bool(cfg.get("return_sequences", False)) \
        else LX.LastTimeStep(underlying=inner, name=cfg.get("name"))

    def set_weights(weights, in_type):
        kernel, rec, bias = [np.asarray(a) for a in weights[:3]]
        return {"Wx": np.asarray(kernel), "Wh": np.asarray(rec),
                "b": np.asarray(bias)}

    return _Adapted(layer, set_weights)


def _adapt_layer(class_name: str, cfg: Dict[str, Any],
                 keras_in_shape) -> Optional[_Adapted]:
    """One Keras layer -> framework layer + weight mapper.

    Returns None for layers that vanish (InputLayer, Flatten — handled by
    automatic preprocessors like the reference's KerasFlatten)."""
    if class_name in ("InputLayer", "Flatten"):
        return None
    if class_name == "Dense":
        return _dense_adapter(cfg, keras_in_shape)
    if class_name == "Conv2D":
        return _conv2d_adapter(cfg)
    if class_name == "DepthwiseConv2D":
        return _conv2d_adapter(cfg, depthwise=True)
    if class_name == "MaxPooling2D":
        return _pool2d_adapter(cfg, "max")
    if class_name == "AveragePooling2D":
        return _pool2d_adapter(cfg, "avg")
    if class_name == "GlobalAveragePooling2D":
        return _Adapted(L.GlobalPoolingLayer(pooling_type="avg",
                                             name=cfg.get("name")))
    if class_name == "GlobalMaxPooling2D":
        return _Adapted(L.GlobalPoolingLayer(pooling_type="max",
                                             name=cfg.get("name")))
    if class_name == "BatchNormalization":
        return _bn_adapter(cfg)
    if class_name == "Dropout":
        return _Adapted(L.DropoutLayer(rate=float(cfg.get("rate", 0.5)),
                                       name=cfg.get("name")))
    if class_name == "Activation":
        return _Adapted(L.ActivationLayer(
            activation=_act(cfg.get("activation")), name=cfg.get("name")))
    if class_name == "LeakyReLU":
        return _Adapted(L.ActivationLayer(activation="leakyrelu",
                                          name=cfg.get("name")))
    if class_name == "ReLU":
        return _Adapted(L.ActivationLayer(activation="relu",
                                          name=cfg.get("name")))
    if class_name == "ELU":
        return _Adapted(L.ActivationLayer(activation="elu",
                                          name=cfg.get("name")))
    if class_name == "Embedding":
        return _embedding_adapter(cfg)
    if class_name == "LSTM":
        return _lstm_adapter(cfg)
    if class_name == "SimpleRNN":
        return _simple_rnn_adapter(cfg)
    if class_name == "ZeroPadding2D":
        padding = _cropping_tuple(cfg.get("padding", (1, 1)), 2)
        return _Adapted(L.ZeroPaddingLayer(padding=padding,
                                           name=cfg.get("name")))
    if class_name == "GRU":
        return _gru_adapter(cfg)
    if class_name == "Bidirectional":
        return _bidirectional_adapter(cfg)
    if class_name == "TimeDistributed":
        return _time_distributed_adapter(cfg)
    if class_name == "Conv1D":
        return _conv1d_adapter(cfg)
    if class_name == "Conv3D":
        return _conv3d_adapter(cfg)
    if class_name == "SeparableConv2D":
        return _separable_conv2d_adapter(cfg)
    if class_name == "Conv2DTranspose":
        return _conv2d_transpose_adapter(cfg)
    if class_name in ("LocallyConnected2D",):
        return _locally_connected2d_adapter(cfg)
    if class_name == "PReLU":
        return _prelu_adapter(cfg)
    if class_name == "LayerNormalization":
        return _layer_norm_adapter(cfg)
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        if cfg.get("padding", "valid") == "same":
            raise ImportException(f"{class_name} padding='same' unsupported")
        pool = cfg.get("pool_size", 2)
        pool = int(pool[0]) if isinstance(pool, (list, tuple)) else int(pool)
        st = cfg.get("strides") or pool
        st = int(st[0]) if isinstance(st, (list, tuple)) else int(st)
        return _Adapted(LX.Subsampling1DLayer(
            pooling_type="max" if class_name.startswith("Max") else "avg",
            kernel_size=pool, stride=st, name=cfg.get("name")))
    if class_name in ("MaxPooling3D", "AveragePooling3D"):
        return _Adapted(LX.Subsampling3DLayer(
            pooling_type="max" if class_name.startswith("Max") else "avg",
            kernel_size=tuple(int(k) for k in cfg.get("pool_size",
                                                      (2, 2, 2))),
            stride=tuple(int(s) for s in (cfg.get("strides") or
                                          cfg.get("pool_size", (2, 2, 2)))),
            padding="SAME" if cfg.get("padding", "valid") == "same"
            else "VALID", avg_include_pad=False,  # keras/TF semantics
            name=cfg.get("name")))
    if class_name in ("GlobalAveragePooling1D", "GlobalAveragePooling3D"):
        return _Adapted(L.GlobalPoolingLayer(pooling_type="avg",
                                             name=cfg.get("name")))
    if class_name in ("GlobalMaxPooling1D", "GlobalMaxPooling3D"):
        return _Adapted(L.GlobalPoolingLayer(pooling_type="max",
                                             name=cfg.get("name")))
    if class_name == "UpSampling1D":
        return _Adapted(LX.Upsampling1D(size=int(cfg.get("size", 2)),
                                        name=cfg.get("name")))
    if class_name == "UpSampling2D":
        if cfg.get("interpolation", "nearest") != "nearest":
            raise ImportException("UpSampling2D interpolation must be "
                                  "'nearest'")
        return _Adapted(L.Upsampling2D(size=_pair(cfg.get("size", (2, 2))),
                                       name=cfg.get("name")))
    if class_name == "UpSampling3D":
        return _Adapted(LX.Upsampling3D(
            size=tuple(int(s) for s in cfg.get("size", (2, 2, 2))),
            name=cfg.get("name")))
    if class_name == "Cropping1D":
        return _Adapted(LX.Cropping1D(
            cropping=_cropping_tuple(cfg.get("cropping", (1, 1)), 1),
            name=cfg.get("name")))
    if class_name == "Cropping2D":
        return _Adapted(LX.Cropping2D(
            cropping=_cropping_tuple(cfg.get("cropping", (1, 1)), 2),
            name=cfg.get("name")))
    if class_name == "Cropping3D":
        return _Adapted(LX.Cropping3D(
            cropping=_cropping_tuple(cfg.get("cropping", (1, 1, 1)), 3),
            name=cfg.get("name")))
    if class_name == "ZeroPadding1D":
        return _Adapted(LX.ZeroPadding1DLayer(
            padding=_cropping_tuple(cfg.get("padding", (1, 1)), 1),
            name=cfg.get("name")))
    if class_name == "ZeroPadding3D":
        return _Adapted(LX.ZeroPadding3DLayer(
            padding=_cropping_tuple(cfg.get("padding", (1, 1, 1)), 3),
            name=cfg.get("name")))
    if class_name in ("SpatialDropout1D", "SpatialDropout2D",
                      "SpatialDropout3D"):
        return _Adapted(LX.SpatialDropout(rate=float(cfg.get("rate", 0.5)),
                                          name=cfg.get("name")))
    if class_name == "GaussianDropout":
        return _Adapted(LX.GaussianDropout(rate=float(cfg.get("rate", 0.5)),
                                           name=cfg.get("name")))
    if class_name == "GaussianNoise":
        return _Adapted(LX.GaussianNoise(stddev=float(cfg.get("stddev",
                                                              0.1)),
                                         name=cfg.get("name")))
    if class_name == "AlphaDropout":
        return _Adapted(LX.AlphaDropout(rate=float(cfg.get("rate", 0.5)),
                                        name=cfg.get("name")))
    if class_name == "RepeatVector":
        return _Adapted(LX.RepeatVector(n=int(cfg.get("n", 1)),
                                        name=cfg.get("name")))
    if class_name == "Softmax":
        return _Adapted(L.ActivationLayer(activation="softmax",
                                          name=cfg.get("name")))
    if class_name == "Permute":
        # Keras dims are 1-indexed over feature dims and stated in the
        # NHWC-style layout; applied on our NCHW-ordered activations the
        # same index permutation holds for the 3-D (RNN/2-D) cases we map
        return _Adapted(LX.PermuteLayer(
            dims=tuple(int(d) for d in cfg.get("dims", (1,))),
            name=cfg.get("name")))
    if class_name == "Reshape":
        target = _resolve_reshape(cfg.get("target_shape", ()),
                                  keras_in_shape)
        if len(target) == 3:
            h, w, c = target
            if h == 1 and w == 1:
                # keras (1, 1, C) is NHWC; the runtime is NCHW. With 1x1
                # spatial dims the element order is identical, so the
                # SE-block pattern (GlobalPool -> Reshape -> 1x1 Conv)
                # maps exactly
                target = (c, 1, 1)
            else:
                raise ImportException(
                    "Reshape to a conv tensor with non-1x1 spatial dims "
                    "is unsupported (NHWC/NCHW element order differs)")
        return _Adapted(LX.ReshapeLayer(target_shape=target,
                                        name=cfg.get("name")))
    if class_name == "Masking":
        # emits the timestep keep-mask; MultiLayerNetwork threads it into
        # downstream RNN layers (Keras semantics: masked steps carry state
        # and repeat the previous output) and a temporal loss head —
        # reference KerasMasking.java + per-layer mask propagation
        return _Adapted(LX.MaskLayer(
            mask_value=float(cfg.get("mask_value", 0.0)),
            name=cfg.get("name")))
    if class_name == "LocallyConnected1D":
        if cfg.get("padding", "valid") != "valid":
            raise ImportException("LocallyConnected1D padding must be "
                                  "'valid'")
        ks = cfg.get("kernel_size", 3)
        ks = int(ks[0]) if isinstance(ks, (list, tuple)) else int(ks)
        st = cfg.get("strides", 1)
        st = int(st[0]) if isinstance(st, (list, tuple)) else int(st)
        layer = LX.LocallyConnected1D(
            n_out=int(cfg["filters"]), kernel_size=ks, stride=st,
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))

        def lc1d_weights(weights, in_type):
            # keras kernel (ot, ks*F, o) flattens patches k-major/f-minor;
            # our layer consumes conv_general_dilated_patches order
            # (c-major, k-minor) — permute the middle axis accordingly
            k = np.asarray(weights[0])
            ot, kf, o = k.shape
            f = kf // ks
            k = k.reshape(ot, ks, f, o).transpose(0, 2, 1, 3).reshape(
                ot, kf, o)
            p = {"W": np.asarray(k)}
            if layer.has_bias:
                p["b"] = np.asarray(weights[1])
            return p

        return _Adapted(layer, lc1d_weights)
    if class_name == "SpaceToDepth":
        return _Adapted(LX.SpaceToDepthLayer(
            block_size=int(cfg.get("block_size", 2)), name=cfg.get("name")))
    if class_name == "Rescaling":
        sc, off = cfg.get("scale", 1.0), cfg.get("offset", 0.0)
        if isinstance(sc, (list, tuple)) or isinstance(off, (list, tuple)):
            raise ImportException(
                "Rescaling with per-element scale/offset is unsupported "
                "(NHWC->NCHW broadcast would need layout tracking)")
        return _Adapted(LX.RescaleLayer(scale=float(sc), offset=float(off),
                                        name=cfg.get("name")))
    if class_name == "Normalization":
        if cfg.get("invert"):
            raise ImportException("Normalization(invert=True) unsupported")
        axis = cfg.get("axis")
        axis = list(axis) if isinstance(axis, (list, tuple)) else [axis]
        if axis not in ([3], [-1]):
            raise ImportException(
                f"Normalization over axis {axis} unsupported (only the "
                f"channels axis)")
        layer = LX.ChannelNormalizationLayer(name=cfg.get("name"))

        def norm_weights(weights, in_type):
            # h5 weights: [mean (C,), variance (C,), count ()]
            return {"mean": np.asarray(weights[0]).ravel(),
                    "variance": np.asarray(weights[1]).ravel()}

        return _Adapted(layer, norm_weights)
    if class_name == "Lambda":
        fn = _LAMBDA_REGISTRY.get(cfg.get("name"))
        if fn is None:
            raise ImportException(
                f"Keras Lambda layer {cfg.get('name')!r} requires "
                "register_lambda(name, layer) before import (reference "
                "KerasLayer.registerLambdaLayer)")
        return _Adapted(fn() if callable(fn) and not isinstance(fn, L.Layer)
                        else fn)
    raise ImportException(f"unsupported Keras layer type {class_name!r}")


#: name -> Layer (or zero-arg factory) for Lambda layers, mirroring the
#: reference's KerasLayer.registerLambdaLayer custom-layer hook
_LAMBDA_REGISTRY: Dict[str, Any] = {}


def register_lambda(name: str, layer_or_factory) -> None:
    """Register the implementation for a Keras Lambda layer by name."""
    _LAMBDA_REGISTRY[name] = layer_or_factory


# ---------------------------------------------------------------- h5 I/O
def _read_h5(path):
    """``(model_config, {layer name: [weight arrays]})`` of a Keras h5
    file (a path or its bytes), read as the JAX package reads it with
    ``h5py``: each layer of ``model_weights``' ``layer_names`` (its keys
    when the attribute is missing), its weights in ``weight_names`` order
    or, without that attribute, every dataset in ``visititems`` order."""
    with h5.File(path) as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise ImportException(
                "h5 file has no model_config attr (weights-only file?); "
                "use import with a separate config JSON")
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        config = json.loads(raw)
        weights: Dict[str, List[np.ndarray]] = {}
        mw = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in mw.attrs.get("layer_names", list(mw.keys()))]
        for lname in layer_names:
            if lname not in mw:
                continue
            grp = mw[lname]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in grp.attrs.get("weight_names", [])]
            ws = []
            if wnames:
                for wn in wnames:
                    ws.append(grp[wn].read())
            else:
                grp.visititems(lambda name, obj: ws.append(obj.read())
                               if isinstance(obj, h5.Dataset) else None)
            if ws:
                weights[lname] = ws
    return config, weights


def _layer_entries(model_cfg: Dict) -> List[Dict]:
    cfg = model_cfg.get("config", model_cfg)
    return cfg["layers"]


def _resolve_reshape(target, in_shape):
    """Resolve a keras Reshape target with one -1 against the input size."""
    target = [int(s) for s in target]
    if -1 in target and in_shape is not None:
        known = int(np.prod([s for s in target if s != -1]))
        total = int(np.prod(in_shape))
        target[target.index(-1)] = total // max(known, 1)
    return tuple(target)


def _keras_out_shape(class_name, cfg, in_shape):
    """Track Keras-side (channels-last, batchless) shapes for weight fixups."""
    if in_shape is None:
        return None
    if class_name == "Dense":
        return (int(cfg["units"]),)
    if class_name == "Conv2D":
        h, w, c = in_shape
        sh, sw = _pair(cfg.get("strides", (1, 1)))
        kh, kw = _pair(cfg["kernel_size"])
        if cfg.get("padding", "valid") == "same":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        return (oh, ow, int(cfg["filters"]))
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        h, w, c = in_shape
        ph, pw = _pair(cfg.get("pool_size", (2, 2)))
        st = cfg.get("strides") or (ph, pw)
        sh, sw = _pair(st)
        if cfg.get("padding", "valid") == "same":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh, ow = (h - ph) // sh + 1, (w - pw) // sw + 1
        return (oh, ow, c)
    if class_name in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
        return (in_shape[-1],)
    if class_name == "Flatten":
        return (int(np.prod(in_shape)),)
    if class_name == "Reshape":
        return _resolve_reshape(cfg.get("target_shape", ()), in_shape)
    if class_name == "SpaceToDepth":
        h, w, c = in_shape
        s = int(cfg.get("block_size", 2))
        return (h // s, w // s, c * s * s)
    if class_name == "Permute":
        dims = tuple(int(d) for d in cfg.get("dims", ()))
        return tuple(in_shape[d - 1] for d in dims)
    if class_name == "Masking":
        return tuple(in_shape)
    if class_name in ("Rescaling", "Normalization"):
        return tuple(in_shape)
    if class_name == "LocallyConnected1D":
        t = in_shape[0]
        ks = cfg.get("kernel_size", 3)
        ks = int(ks[0]) if isinstance(ks, (list, tuple)) else int(ks)
        st = cfg.get("strides", 1)
        st = int(st[0]) if isinstance(st, (list, tuple)) else int(st)
        return ((t - ks) // st + 1, int(cfg["filters"]))
    if class_name == "Embedding":
        return tuple(in_shape) + (int(cfg["output_dim"]),)
    if class_name in ("LSTM", "GRU", "SimpleRNN"):
        units = int(cfg["units"])
        return (in_shape[0], units) if cfg.get("return_sequences") \
            else (units,)
    if class_name == "Bidirectional":
        inner_cfg = cfg.get("layer", {}).get("config", {})
        units = int(inner_cfg.get("units", 0))
        if cfg.get("merge_mode", "concat") == "concat":
            units *= 2
        return (in_shape[0], units) if inner_cfg.get("return_sequences") \
            else (units,)
    if class_name == "TimeDistributed":
        inner_cfg = cfg.get("layer", {}).get("config", {})
        return (in_shape[0], int(inner_cfg.get("units", in_shape[-1])))
    if class_name == "Conv1D":
        t, f = in_shape
        k = _pair(cfg["kernel_size"])[0]
        s = _pair(cfg.get("strides", 1))[0]
        d = _pair(cfg.get("dilation_rate", 1))[0]
        if cfg.get("padding", "valid") in ("same", "causal"):
            ot = -(-t // s)
        else:
            ot = (t - d * (k - 1) - 1) // s + 1
        return (ot, int(cfg["filters"]))
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        t, f = in_shape
        pool = cfg.get("pool_size", 2)
        pool = int(pool[0]) if isinstance(pool, (list, tuple)) else int(pool)
        st = cfg.get("strides") or pool
        st = int(st[0]) if isinstance(st, (list, tuple)) else int(st)
        return ((t - pool) // st + 1, f)
    if class_name in ("GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return (in_shape[-1],)
    if class_name in ("SeparableConv2D", "Conv2DTranspose"):
        h, w, c = in_shape
        sh, sw = _pair(cfg.get("strides", (1, 1)))
        kh, kw = _pair(cfg["kernel_size"])
        same = cfg.get("padding", "valid") == "same"
        if class_name == "Conv2DTranspose":
            oh = h * sh if same else sh * (h - 1) + kh
            ow = w * sw if same else sw * (w - 1) + kw
        elif same:
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        return (oh, ow, int(cfg["filters"]))
    if class_name == "UpSampling2D":
        h, w, c = in_shape
        sh, sw = _pair(cfg.get("size", (2, 2)))
        return (h * sh, w * sw, c)
    if class_name == "Cropping2D":
        h, w, c = in_shape
        t, b, l, r = _cropping_tuple(cfg.get("cropping", (1, 1)), 2)
        return (h - t - b, w - l - r, c)
    if class_name == "RepeatVector":
        return (int(cfg.get("n", 1)), in_shape[0])
    if class_name == "Conv3D":
        d, h, w, c = in_shape
        kd, kh, kw = (int(k) for k in cfg["kernel_size"])
        sd, sh, sw = (int(s) for s in cfg.get("strides", (1, 1, 1)))
        if cfg.get("padding", "valid") == "same":
            od, oh, ow = -(-d // sd), -(-h // sh), -(-w // sw)
        else:
            od, oh, ow = ((d - kd) // sd + 1, (h - kh) // sh + 1,
                          (w - kw) // sw + 1)
        return (od, oh, ow, int(cfg["filters"]))
    if class_name in ("MaxPooling3D", "AveragePooling3D"):
        d, h, w, c = in_shape
        ps = cfg.get("pool_size", (2, 2, 2))
        ps = (ps,) * 3 if isinstance(ps, int) else tuple(int(p) for p in ps)
        st = cfg.get("strides") or ps
        st = (st,) * 3 if isinstance(st, int) else tuple(int(s) for s in st)
        if cfg.get("padding", "valid") == "same":
            return (-(-d // st[0]), -(-h // st[1]), -(-w // st[2]), c)
        return ((d - ps[0]) // st[0] + 1, (h - ps[1]) // st[1] + 1,
                (w - ps[2]) // st[2] + 1, c)
    if class_name == "ZeroPadding2D":
        h, w, c = in_shape
        pad = cfg.get("padding", (1, 1))
        if isinstance(pad, (list, tuple)) and pad and \
                isinstance(pad[0], (list, tuple)):
            return (h + pad[0][0] + pad[0][1], w + pad[1][0] + pad[1][1], c)
        ph, pw = _pair(pad)
        return (h + 2 * ph, w + 2 * pw, c)
    return in_shape  # shape-preserving (BN, Dropout, Activation...)


def _input_shape_of(entries) -> Optional[Tuple]:
    for e in entries:
        cfg = e.get("config", {})
        if e["class_name"] == "InputLayer":
            shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            if shape:
                return tuple(shape[1:])
        bis = cfg.get("batch_input_shape") or cfg.get("batch_shape")
        if bis:
            return tuple(bis[1:])
    return None


#: keras layers whose 2-D (T, F) output we hold as [B, F, T] on device
_TEMPORAL_LAYERS = frozenset((
    "Embedding", "LSTM", "GRU", "SimpleRNN", "Bidirectional", "Conv1D",
    "MaxPooling1D", "AveragePooling1D", "UpSampling1D", "Cropping1D",
    "ZeroPadding1D", "LocallyConnected1D", "SpatialDropout1D",
    "TimeDistributed", "RepeatVector", "Masking"))


class KerasModelImport:
    """Entry points mirroring the reference KerasModelImport API."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path, input_shape: Optional[Tuple] = None,
            device="cuda") -> MultiLayerNetwork:
        """A Keras ``Sequential`` h5 -> ``MultiLayerNetwork`` on
        ``device``."""
        config, weights = _read_h5(path)
        if config["class_name"] not in ("Sequential",):
            raise ImportException(
                f"not a Sequential model ({config['class_name']}); use "
                f"import_keras_model_and_weights")
        entries = _layer_entries(config)
        keras_shape = input_shape or _input_shape_of(entries)
        if keras_shape is None:  # keras 3 Sequential: build_input_shape
            bis = config.get("config", {}).get("build_input_shape")
            if bis:
                keras_shape = tuple(bis[1:])
        if keras_shape is None:
            raise ImportException("could not determine input shape; pass "
                                  "input_shape=")

        lb = NeuralNetConfiguration.builder().list()
        in_type = _keras_shape_to_input_type(keras_shape)
        lb.set_input_type(in_type)
        adapted: List[Tuple[int, _Adapted, Tuple]] = []
        cur = tuple(keras_shape)
        conv_src = None  # pre-Flatten conv shape for Dense-kernel reordering
        # True while our runtime layout is [B,F,T] against keras' [B,T,F]
        # (every temporal layer); Reshape/Permute outputs are keras-identical
        transposed = len(cur) == 2
        idx = 0
        mask_alive = False  # a Masking layer's keep-mask is in flight
        for e in entries:
            cls, cfg = e["class_name"], e.get("config", {})
            if cls == "Masking":
                mask_alive = True
            elif mask_alive:
                if cls in ("GlobalAveragePooling1D", "GlobalMaxPooling1D"):
                    # keras pooling CONSUMES the mask (masked steps
                    # excluded); our pooling layers don't — refuse rather
                    # than silently diverge from the golden
                    raise ImportException(
                        f"{cls} downstream of Masking consumes the "
                        "timestep mask in keras; mask threading covers RNN "
                        "layers only — pool after an RNN with "
                        "return_sequences=False, or drop the Masking layer")
                if (cls in ("LSTM", "GRU", "SimpleRNN")
                        and not cfg.get("return_sequences", False)):
                    mask_alive = False  # consumed by last-step selection
            if cls == "Flatten" and cur is not None and len(cur) in (3, 4):
                conv_src = cur
            if cls == "Flatten" and cur is not None and len(cur) == 2:
                if any(s is None for s in cur):
                    raise ImportException(
                        "Flatten on a variable-length sequence is "
                        "unsupported (timestep dim is None)")
                # keras flattens [B,T,F]; our tensor may be [B,F,T] — line
                # the axes up first so element order matches the golden
                if transposed:
                    lb.layer(LX.PermuteLayer(dims=(2, 1)))
                    idx += 1
                lb.layer(LX.ReshapeLayer(
                    target_shape=(int(np.prod(cur)),), name=cfg.get("name")))
                idx += 1
                cur = (int(np.prod(cur)),)
                transposed = False
                continue
            if cls in ("Reshape", "Permute"):
                if cur is None:
                    raise ImportException(
                        f"{cls} with unknown input shape is unsupported")
                if len(cur) >= 3:
                    # conv activations are NCHW vs keras NHWC — a literal
                    # transpose/reshape would reorder different axes than
                    # keras did, so refuse rather than silently diverge
                    raise ImportException(
                        f"{cls} on a conv tensor is unsupported (runtime "
                        "layout differs from keras); insert Flatten or "
                        "GlobalPooling first")
                if transposed:
                    # align the [B,F,T] runtime tensor with keras' [B,T,F]
                    # before applying the keras-specified transform; the
                    # result is then keras-identical layout
                    lb.layer(LX.PermuteLayer(dims=(2, 1)))
                    idx += 1
                    transposed = False
            if cls in _TEMPORAL_LAYERS and cur is not None \
                    and len(cur) == 2 and not transposed:
                # a temporal consumer expects [B,F,T] but the tensor is in
                # keras-identical [B,T,F] layout (e.g. produced by Reshape)
                # — re-align before it, or the RNN silently reads features
                # as timesteps
                lb.layer(LX.PermuteLayer(dims=(2, 1)))
                idx += 1
                transposed = True
            shape_for_adapter = conv_src if (cls == "Dense" and conv_src) \
                else cur
            a = _adapt_layer(cls, cfg, shape_for_adapter)
            if cls == "Dense":
                conv_src = None
            if a is not None:
                lb.layer(a.layer)
                adapted.append((idx, a, shape_for_adapter))
                idx += 1
            if cls == "Lambda" and a is not None:
                # registered custom layers know their own output shape;
                # the keras-side table cannot
                try:
                    cur = a.layer.output_type(cur)
                except Exception:
                    cur = None
            else:
                cur = _keras_out_shape(cls, cfg, cur)
            if cur is not None:
                if len(cur) != 2:
                    transposed = False
                elif cls in ("Reshape", "Permute"):
                    transposed = False
                elif cls in _TEMPORAL_LAYERS:
                    transposed = True

        conf = lb.build()
        net = MultiLayerNetwork(conf, device=device)
        net.init()
        # overwrite initialized params with the imported weights
        for i, a, in_shape in adapted:
            if a.set_weights is None:
                continue
            name = a.layer.name
            if name not in weights:
                raise ImportException(f"no weights for layer {name!r} in h5")
            net._params[i] = params_from_numpy(
                a.set_weights(weights[name], in_shape), net.device)
        net._updater_state = conf.updater.init(net._trainable(net._params))
        return net

    @staticmethod
    def import_keras_model_and_weights(path,
                                       input_shape: Optional[Tuple] = None,
                                       device="cuda") -> ComputationGraph:
        """A Keras functional h5 -> ``ComputationGraph`` on ``device``."""
        config, weights = _read_h5(path)
        cls_name = config["class_name"]
        if cls_name == "Sequential":
            raise ImportException("Sequential model; use "
                                  "import_keras_sequential_model_and_weights")
        entries = _layer_entries(config)
        gcfg = config.get("config", {})

        def _ref_names(spec):
            """input/output_layers spec -> layer names (keras 2 and 3).

            Single-ref specs may be flat ['name', 0, 0]; multi-ref are
            [['a',0,0], ['b',0,0]] (or plain name lists)."""
            if not spec:
                return []
            if isinstance(spec, (list, tuple)) and len(spec) == 3 and \
                    isinstance(spec[0], str) and \
                    all(isinstance(s, int) for s in spec[1:]):
                return [spec[0]]
            out = []
            for item in spec:
                out.append(item[0] if isinstance(item, (list, tuple))
                           else item)
            return out

        builder = NeuralNetConfiguration.builder().graph_builder()
        keras_shapes: Dict[str, Tuple] = {}
        adapted: Dict[str, Tuple[_Adapted, Tuple]] = {}
        alias: Dict[str, str] = {}  # keras layer name -> vertex name used
        unflattened: Dict[str, Tuple] = {}  # Flatten name -> conv shape
        # keras names whose runtime tensor is [B,F,T] against keras' [B,T,F]
        # (temporal producers); Reshape/Permute outputs are keras-identical
        transposed: Dict[str, bool] = {}

        input_names = _ref_names(gcfg.get("input_layers", []))
        builder.add_inputs(*input_names)

        for e in entries:
            cls, cfg = e["class_name"], e.get("config", {})
            name = cfg.get("name") or e.get("name")
            inbound = _parse_inbound(e.get("inbound_nodes", []))
            if cls == "InputLayer":
                shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
                keras_shapes[name] = tuple(shape[1:]) if shape else None
                # RNN-style inputs are fed [B,F,T] by our conventions
                transposed[name] = (keras_shapes[name] is not None
                                    and len(keras_shapes[name]) == 2)
                continue
            in_names = [alias.get(n, n) for n in inbound]
            in_shape = keras_shapes.get(inbound[0]) if inbound else None

            def _mark_layout(out_shape):
                if out_shape is not None and len(out_shape) == 2:
                    if cls in _TEMPORAL_LAYERS:
                        transposed[name] = True
                    elif cls in ("Reshape", "Permute"):
                        transposed[name] = False
                    else:  # layout-preserving (dropout/activation/merge...)
                        transposed[name] = bool(
                            transposed.get(inbound[0])) if inbound else False
                else:
                    transposed[name] = False
            if cls == "Flatten":
                if in_shape is not None and len(in_shape) == 2:
                    if any(s is None for s in in_shape):
                        raise ImportException(
                            "Flatten on a variable-length sequence is "
                            "unsupported; fix the timestep dimension")
                    # when the producer is temporal our tensor is [B,F,T]
                    # vs keras [B,T,F]: line the axes up before flattening
                    # (same treatment the Sequential importer applies)
                    total = int(np.prod(in_shape))
                    src = in_names[0]
                    if transposed.get(inbound[0]):
                        builder.add_layer(f"{name}_permute",
                                          LX.PermuteLayer(dims=(2, 1)),
                                          src)
                        src = f"{name}_permute"
                    builder.add_layer(name,
                                      LX.ReshapeLayer(target_shape=(total,)),
                                      src)
                    keras_shapes[name] = (total,)
                    transposed[name] = False
                    continue
                alias[name] = in_names[0]  # vanishes; preprocessor handles
                if in_shape is not None and len(in_shape) == 3:
                    unflattened[name] = in_shape
                keras_shapes[name] = _keras_out_shape(cls, cfg, in_shape)
                _mark_layout(keras_shapes[name])
                continue
            if cls in ("Reshape", "Permute"):
                if in_shape is None:
                    raise ImportException(
                        f"{cls} with unknown input shape is unsupported")
                if len(in_shape) >= 3:
                    raise ImportException(
                        f"{cls} on a conv tensor is unsupported (runtime "
                        "layout differs from keras); insert Flatten or "
                        "GlobalPooling first")
                if len(in_shape) == 2 and transposed.get(inbound[0]):
                    # align [B,F,T] -> keras [B,T,F] before the transform
                    builder.add_layer(f"{name}_align",
                                      LX.PermuteLayer(dims=(2, 1)),
                                      in_names[0])
                    in_names = [f"{name}_align"]
            elif cls in _TEMPORAL_LAYERS and in_shape is not None \
                    and len(in_shape) == 2 and inbound \
                    and not transposed.get(inbound[0], False):
                # temporal consumer on a keras-layout tensor: re-align to
                # [B,F,T] first (mirror of the Sequential treatment)
                builder.add_layer(f"{name}_align",
                                  LX.PermuteLayer(dims=(2, 1)), in_names[0])
                in_names = [f"{name}_align"]
            if cls == "Dense" and inbound and inbound[0] in unflattened:
                in_shape = unflattened[inbound[0]]
            if cls in ("Add", "Subtract", "Multiply", "Average", "Maximum",
                       "Minimum"):
                op = {"Add": "add", "Subtract": "subtract",
                      "Multiply": "product", "Average": "average",
                      "Maximum": "max", "Minimum": "min"}[cls]
                builder.add_vertex(name, ElementWiseVertex(op=op), *in_names)
                keras_shapes[name] = in_shape
                _mark_layout(in_shape)
                continue
            if cls == "Concatenate":
                builder.add_vertex(name, MergeVertex(), *in_names)
                shapes = [keras_shapes.get(n) for n in inbound]
                if in_shape is not None and all(s is not None
                                                for s in shapes):
                    merged = list(in_shape)
                    merged[-1] = sum(s[-1] for s in shapes)
                    keras_shapes[name] = tuple(merged)
                _mark_layout(keras_shapes.get(name))
                continue
            if cls == "Masking":
                raise ImportException(
                    "Masking in functional (ComputationGraph) models is "
                    "unsupported: mask threading is implemented for the "
                    "Sequential/MultiLayerNetwork path only; re-export as "
                    "Sequential")
            a = _adapt_layer(cls, cfg, in_shape)
            if a is None:
                alias[name] = in_names[0] if in_names else name
                keras_shapes[name] = _keras_out_shape(cls, cfg, in_shape)
                _mark_layout(keras_shapes[name])
                continue
            builder.add_layer(name, a.layer, *in_names)
            adapted[name] = (a, in_shape)
            if cls == "Lambda":
                try:
                    keras_shapes[name] = a.layer.output_type(in_shape)
                except Exception:
                    keras_shapes[name] = None
            else:
                keras_shapes[name] = _keras_out_shape(cls, cfg, in_shape)
            _mark_layout(keras_shapes.get(name))

        out_names = [alias.get(n, n)
                     for n in _ref_names(gcfg.get("output_layers", []))]
        builder.set_outputs(*out_names)
        in_types = [_keras_shape_to_input_type(keras_shapes.get(n) or
                                               (input_shape if input_shape
                                                else None))
                    for n in input_names]
        if all(t is not None for t in in_types):
            builder.set_input_types(*in_types)
        conf = builder.build()
        net = ComputationGraph(conf, device=device)
        net.init()
        for name, (a, in_shape) in adapted.items():
            if a.set_weights is None:
                continue
            if name not in weights:
                raise ImportException(f"no weights for layer {name!r} in h5")
            net._params[name] = params_from_numpy(
                a.set_weights(weights[name], in_shape), net.device)
        net._updater_state = conf.updater.init(net._trainable(net._params))
        return net


def _parse_inbound(inbound_nodes) -> List[str]:
    """Inbound layer names across Keras 2/3 serialization formats."""
    names: List[str] = []
    if not inbound_nodes:
        return names
    node = inbound_nodes[0]
    if isinstance(node, dict):  # keras 3: {"args": [...], "kwargs": {}}
        def find_hist(obj):
            if isinstance(obj, dict):
                if "keras_history" in obj.get("config", {}):
                    names.append(obj["config"]["keras_history"][0])
                else:
                    for v in obj.values():
                        find_hist(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    find_hist(v)
        find_hist(node.get("args", []))
    else:  # keras 2: [["layer", node_idx, tensor_idx, {}], ...]
        for item in node:
            names.append(item[0])
    return names


def import_keras_sequential_model_and_weights(path, input_shape=None,
                                              device="cuda"):
    return KerasModelImport.import_keras_sequential_model_and_weights(
        path, input_shape, device)


def import_keras_model_and_weights(path, input_shape=None, device="cuda"):
    return KerasModelImport.import_keras_model_and_weights(
        path, input_shape, device)
