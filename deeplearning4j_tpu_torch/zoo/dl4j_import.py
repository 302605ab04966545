"""DL4J ModelSerializer zip importer — pretrained-artifact converter.

Reference formats:
- zip layout: `ModelSerializer.java` — `configuration.json` (Jackson JSON
  with `@class` typing), `coefficients.bin` (one flattened param vector via
  `Nd4j.write`, Nd4j.java:2616), optional `updaterState.bin`.
- binary arrays: `BaseDataBuffer.write` (BaseDataBuffer.java:1686) —
  java DataOutputStream big-endian: UTF allocation mode, long length, UTF
  dtype name, then raw big-endian values; shapeInfo buffer first
  (rank, shape[rank], stride[rank], extras, ews, order), data buffer next.
- flattening: parameter views are created in 'f' order
  (WeightInitUtil.DEFAULT_WEIGHT_INIT_ORDER), per layer in network order,
  per-layer keys in ParamInitializer order (W,b / gamma,beta,mean,var).

This is the `ZooModel.initPretrained` counterpart: reference-published
model zips convert into native MultiLayerNetworks (zero-egress environments
supply the artifact path; no downloader here). Counterpart of
``deeplearning4j_tpu/zoo/dl4j_import.py``: the same reader and layer
mapping; the restored network's params are tensors on ``device`` (the
card by default).
"""
from __future__ import annotations

import io
import json
import struct
import zipfile
from typing import BinaryIO, Dict, List

import numpy as np

from ..bridge import tensor_from_numpy
from ..nn.conf import layers as L
from ..nn.conf.config import (CnnToFeedForwardPreProcessor,
                              MultiLayerConfiguration)
from ..nn.multilayer import MultiLayerNetwork

_JAVA_DTYPES = {
    "FLOAT": (">f4", np.float32), "DOUBLE": (">f8", np.float64),
    "LONG": (">i8", np.int64), "INT": (">i4", np.int32),
    "HALF": (">f2", np.float16),
}


def _read_utf(f: BinaryIO) -> str:
    n = struct.unpack(">H", f.read(2))[0]
    return f.read(n).decode("utf-8")


def read_nd4j_array(f: BinaryIO) -> np.ndarray:
    """Nd4j.read format: shapeInfo LONG buffer + data buffer."""
    _read_utf(f)                                   # allocation mode
    si_len = struct.unpack(">q", f.read(8))[0]
    si_dtype = _read_utf(f)
    assert si_dtype in ("LONG", "INT"), si_dtype
    width = 8 if si_dtype == "LONG" else 4
    shape_info = np.frombuffer(f.read(si_len * width),
                               dtype=f">i{width}").astype(np.int64)
    rank = int(shape_info[0])
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[-1]))               # 'c' (99) or 'f' (102)

    _read_utf(f)                                   # allocation mode
    length = struct.unpack(">q", f.read(8))[0]
    dtype_name = _read_utf(f)
    jfmt, np_dtype = _JAVA_DTYPES[dtype_name]
    data = np.frombuffer(f.read(length * np.dtype(jfmt).itemsize),
                         dtype=jfmt).astype(np_dtype)
    return data.reshape(shape, order=order if rank > 1 else "C")


# -- DL4J JSON -> our layer configs ---------------------------------------

_ACTIVATIONS = {
    "ActivationReLU": "relu", "ActivationIdentity": "identity",
    "ActivationSoftmax": "softmax", "ActivationTanh": "tanh",
    "ActivationSigmoid": "sigmoid", "ActivationLReLU": "leakyrelu",
    "ActivationELU": "elu", "ActivationSELU": "selu",
    "ActivationSwish": "swish", "ActivationGELU": "gelu",
    "ActivationHardSigmoid": "hardsigmoid", "ActivationSoftPlus": "softplus",
    "ActivationSoftSign": "softsign", "ActivationCube": "cube",
    "ActivationRationalTanh": "rationaltanh", "ActivationReLU6": "relu6",
}

_LOSSES = {
    "LossMCXENT": "mcxent", "LossMSE": "mse", "LossBinaryXENT": "xent",
    "LossL1": "l1", "LossMAE": "mae", "LossHinge": "hinge",
    "LossPoisson": "poisson", "LossNegativeLogLikelihood": "mcxent",
}


def _cls(d) -> str:
    return d.get("@class", "").rsplit(".", 1)[-1] if isinstance(d, dict) \
        else str(d)


def _field(d: Dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


def _activation(d: Dict) -> str:
    a = _field(d, "activationFn", "activation")
    if a is None:
        return "identity"
    name = _cls(a)
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unsupported DL4J activation {name!r}")


def _pair(v, default=(1, 1)):
    if v is None:
        return default
    return tuple(int(x) for x in (v if isinstance(v, (list, tuple))
                                  else (v, v)))


def convert_layer(layer_json: Dict):
    """One DL4J layer JSON -> (our layer, param spec list).

    Param spec: [(key, dl4j_shape, converter)] in DL4J flattening order."""
    t = _cls(layer_json)
    n_in = int(_field(layer_json, "nIn", "nin", default=0) or 0)
    n_out = int(_field(layer_json, "nOut", "nout", default=0) or 0)

    if t in ("DenseLayer", "OutputLayer"):
        act = _activation(layer_json)
        if t == "OutputLayer":
            loss = _LOSSES.get(_cls(_field(layer_json, "lossFn", "lossFunction",
                                           default={})), "mcxent")
            layer = L.OutputLayer(n_in=n_in, n_out=n_out, activation=act,
                                  loss=loss)
        else:
            layer = L.DenseLayer(n_in=n_in, n_out=n_out, activation=act)
        spec = [("W", (n_in, n_out), None), ("b", (n_out,), None)]
        return layer, spec
    if t == "ConvolutionLayer":
        k = _pair(_field(layer_json, "kernelSize", "kernel_size"))
        s = _pair(_field(layer_json, "stride"))
        p = _pair(_field(layer_json, "padding"), (0, 0))
        mode = str(_field(layer_json, "convolutionMode",
                          default="Truncate")).lower()
        layer = L.ConvolutionLayer(
            n_in=n_in, n_out=n_out, kernel_size=k, stride=s, padding=p,
            activation=_activation(layer_json),
            convolution_mode="same" if mode == "same" else "truncate")
        # DL4J conv weights are [out, in, kH, kW]; ours HWIO
        spec = [("W", (n_out, n_in, k[0], k[1]),
                 lambda a: np.transpose(a, (2, 3, 1, 0))),
                ("b", (n_out,), None)]
        return layer, spec
    if t == "SubsamplingLayer":
        pt = str(_field(layer_json, "poolingType", default="MAX")).lower()
        layer = L.SubsamplingLayer(
            pooling_type="avg" if pt == "avg" else "max",
            kernel_size=_pair(_field(layer_json, "kernelSize")),
            stride=_pair(_field(layer_json, "stride")),
            padding=_pair(_field(layer_json, "padding"), (0, 0)))
        return layer, []
    if t == "BatchNormalization":
        n = n_out or n_in
        layer = L.BatchNormalization(
            n_out=n, eps=float(_field(layer_json, "eps", default=1e-5)),
            decay=float(_field(layer_json, "decay", default=0.9)))
        spec = [("gamma", (n,), None), ("beta", (n,), None),
                ("state_mean", (n,), None), ("state_var", (n,), None)]
        return layer, spec
    if t == "ActivationLayer":
        return L.ActivationLayer(activation=_activation(layer_json)), []
    if t == "DropoutLayer":
        return L.DropoutLayer(rate=0.5), []
    if t == "GlobalPoolingLayer":
        pt = str(_field(layer_json, "poolingType", default="MAX")).lower()
        return L.GlobalPoolingLayer(
            pooling_type="avg" if pt == "avg" else "max"), []
    if t == "LossLayer":
        loss = _LOSSES.get(_cls(_field(layer_json, "lossFn", default={})),
                           "mcxent")
        return L.LossLayer(loss=loss,
                           activation=_activation(layer_json)), []
    raise ValueError(f"unsupported DL4J layer type {t!r}")


def convert_preprocessors(spec) -> Dict[int, object]:
    """DL4J ``inputPreProcessors`` (layer index -> ``@class`` JSON) -> the
    port's preprocessors. The JAX package's reader ignores them, so a zip
    whose dense head follows a convolution (any DL4J LeNet) restores there
    but cannot run; the port applies the flatten such a zip carries
    (``CnnToFeedForwardPreProcessor``) and refuses any other by name."""
    out: Dict[int, object] = {}
    for idx, p in (spec or {}).items():
        name = _cls(p)
        if name != "CnnToFeedForwardPreProcessor":
            raise ValueError(f"unsupported DL4J input preprocessor {name!r}")
        out[int(idx)] = CnnToFeedForwardPreProcessor()
    return out


def restore_multi_layer_network(path, device="cuda") -> MultiLayerNetwork:
    """`ModelSerializer.restoreMultiLayerNetwork` for reference zips, onto
    ``device``."""
    with zipfile.ZipFile(path) as z:
        conf = json.loads(z.read("configuration.json"))
        coeff = read_nd4j_array(io.BytesIO(z.read("coefficients.bin")))

    layer_entries = []
    for c in conf.get("confs", []):
        layer_entries.append(c["layer"] if "layer" in c else c)

    layers: List = []
    specs: List = []
    for lj in layer_entries:
        layer, spec = convert_layer(lj)
        layers.append(layer)
        specs.append(spec)

    mlc = MultiLayerConfiguration(
        layers=layers,
        preprocessors=convert_preprocessors(conf.get("inputPreProcessors")))
    net = MultiLayerNetwork(mlc, device=device)

    flat = np.asarray(coeff, np.float32).ravel()
    offset = 0
    params = []
    for layer, spec in zip(layers, specs):
        p = {}
        for key, shape, conv in spec:
            n = int(np.prod(shape))
            seg = flat[offset:offset + n].reshape(shape, order="F") \
                if len(shape) > 1 else flat[offset:offset + n]
            offset += n
            if conv is not None:
                seg = conv(seg)
            p[key] = tensor_from_numpy(seg, net.device)
        params.append(p)
    if offset != flat.size:
        raise ValueError(f"coefficient count mismatch: consumed {offset} "
                         f"of {flat.size}")
    net.init(params=params)
    return net
