"""NeuralNetConfiguration builder DSL + MultiLayerConfiguration.

Counterpart of ``deeplearning4j_tpu/nn/conf/config.py`` (the reference's
``NeuralNetConfiguration.Builder`` → ``MultiLayerConfiguration``, with
InputType shape inference and the automatic input preprocessors), and
``graph_builder()``, the ComputationGraph's DSL (``nn/graph/``). The
fields and the JSON are the JAX package's, so one configuration's JSON
loads on either side.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

from ...learning import IUpdater, Sgd
from . import constraints as constraints_mod
from . import layers as L
from . import weightnoise as weightnoise_mod


class InputType:
    """Shape inference tokens (reference conf/inputs/InputType.java).

    Represented as plain tuples without batch dim:
    FF: (n,), RNN: (features, timesteps), CNN: (channels, h, w).
    """

    @staticmethod
    def feed_forward(n: int):
        return (int(n),)

    @staticmethod
    def recurrent(features: int, timesteps: int = -1):
        return (int(features), int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int):
        return (int(channels), int(height), int(width))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int):
        return (int(channels), int(depth), int(height), int(width))


# -- input preprocessors (auto-inserted reshapes) ------------------------
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor:
    def __call__(self, x):
        return x.reshape(x.shape[0], -1)

    def out_type(self, input_type):
        n = 1
        for d in input_type:  # (c, h, w) or (c, d, h, w)
            n *= int(d)
        return (n,)


@dataclasses.dataclass
class FeedForwardToCnnPreProcessor:
    channels: int = 1
    height: int = 1
    width: int = 1

    def __call__(self, x):
        return x.reshape(x.shape[0], self.channels, self.height, self.width)

    def out_type(self, input_type):
        return (self.channels, self.height, self.width)


@dataclasses.dataclass
class RnnToFeedForwardPreProcessor:
    """[B, F, T] → [B*T, F] (time-distributed dense)."""

    def __call__(self, x):
        return x.transpose(1, 2).reshape(-1, x.shape[1])

    def out_type(self, input_type):
        return (input_type[0],)


@dataclasses.dataclass
class FeedForwardToRnnPreProcessor:
    """[B*T, F] → [B, F, T] (reference FeedForwardToRnnPreProcessor).

    ``timesteps`` must be set (the flat batch carries no T)."""
    timesteps: int = -1

    def __call__(self, x):
        if self.timesteps <= 0:
            raise ValueError(
                "FeedForwardToRnnPreProcessor needs timesteps set (the "
                "[B*T, F] input cannot carry T)")
        t = self.timesteps
        b = x.shape[0] // t
        return x.reshape(b, t, x.shape[-1]).transpose(1, 2)

    def out_type(self, input_type):
        return (input_type[0], self.timesteps)


@dataclasses.dataclass
class CnnToRnnPreProcessor:
    def __call__(self, x):
        b, c, h, w = x.shape
        return x.reshape(b, c * h, w)

    def out_type(self, input_type):
        c, h, w = input_type
        return (c * h, w)


def _is_cnn(t):
    return t is not None and len(t) in (3, 4)  # 2-D or 3-D conv activations


def _is_rnn(t):
    return t is not None and len(t) == 2


def infer_preprocessor(prev_type, layer):
    """Auto-insert reshape preprocessors (reference
    MultiLayerConfiguration.getPreProcessorForInputType)."""
    needs_ff = isinstance(layer, (L.DenseLayer, L.OutputLayer,
                                  L.VariationalAutoencoder,
                                  L.ElementWiseMultiplicationLayer))
    needs_rnn = isinstance(layer, (L.LSTM, L.RnnOutputLayer,
                                   L.SelfAttentionLayer, L.Bidirectional,
                                   L.Convolution1DLayer, L.SimpleRnn, L.GRU,
                                   L.LearnedSelfAttentionLayer,
                                   L.RecurrentAttentionLayer,
                                   L.RnnLossLayer))
    if _is_cnn(prev_type) and needs_ff:
        return CnnToFeedForwardPreProcessor()
    if _is_cnn(prev_type) and needs_rnn:
        return CnnToRnnPreProcessor()
    if _is_rnn(prev_type) and needs_ff:
        return RnnToFeedForwardPreProcessor()
    return None


PREPROCESSORS = {c.__name__: c for c in
                 [CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor,
                  RnnToFeedForwardPreProcessor, FeedForwardToRnnPreProcessor,
                  CnnToRnnPreProcessor]}


def layer_to_dict(layer) -> dict:
    """A layer's JSON form, the JAX package's: its class name and fields,
    a wrapped layer nested, weight noise as its dict, a callable by
    name."""
    d = {"@class": type(layer).__name__}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if isinstance(v, L.Layer):
            v = layer_to_dict(v)
        elif f.name == "weight_noise" and v is not None:
            v = v.to_dict()
        elif callable(v) and not isinstance(v, str):
            v = getattr(v, "__name__", str(v))
        d[f.name] = v
    return d


def layer_from_dict(d: dict):
    """The layer of :func:`layer_to_dict`'s form."""
    d = dict(d)
    cls = getattr(L, d.pop("@class"))
    for k, v in d.items():
        if k == "weight_noise":
            d[k] = weightnoise_mod.weight_noise_from_dict(v)
        elif isinstance(v, dict) and "@class" in v:
            d[k] = layer_from_dict(v)
        elif isinstance(v, list):
            d[k] = tuple(v)
    return cls(**d)


@dataclasses.dataclass
class MultiLayerConfiguration:
    layers: List[L.Layer]
    input_type: Optional[Tuple[int, ...]] = None
    preprocessors: dict = dataclasses.field(default_factory=dict)
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd())
    seed: int = 12345
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    gradient_normalization: Optional[str] = None  # None|clip_l2|clip_value
    gradient_clip: float = 1.0
    dtype: str = "float32"
    #: activation rematerialization in the train step: "none" | "layer" |
    #: "dots_saveable"; None resolves the Environment default
    #: (DL4J_TPU_REMAT)
    remat: Optional[str] = None
    #: micro-batches per optimizer step (gradient accumulation); 0/None
    #: resolves the Environment default (DL4J_TPU_GRAD_ACCUM)
    grad_accum: int = 0
    #: [(target, constraint)] applied post-update; targets: weights|bias|all
    constraints: list = dataclasses.field(default_factory=list)
    #: network-default IWeightNoise applied pre-forward during training
    weight_noise: Optional[object] = None

    def layer_input_types(self):
        """Per-layer input types after preprocessor application."""
        types = []
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            pre = self.preprocessors.get(i)
            if pre is not None:
                cur = pre.out_type(cur)
            if cur is None and getattr(layer, "n_in", 0):
                # no explicit InputType: recover the chain from n_in
                cur = (layer.n_in,)
            types.append(cur)
            cur = layer.output_type(cur) if cur is not None else None
        return types

    def to_json(self) -> str:
        return json.dumps({
            "layers": [layer_to_dict(l) for l in self.layers],
            "input_type": self.input_type,
            "preprocessors": {str(k): {"@class": type(v).__name__,
                                       **dataclasses.asdict(v)}
                              for k, v in self.preprocessors.items()},
            "updater": self.updater.to_dict(),
            "seed": self.seed, "l1": self.l1, "l2": self.l2,
            "weight_decay": self.weight_decay,
            "gradient_normalization": self.gradient_normalization,
            "gradient_clip": self.gradient_clip, "dtype": self.dtype,
            "remat": self.remat, "grad_accum": self.grad_accum,
            "constraints": constraints_mod.specs_to_json(self.constraints),
            "weight_noise": (self.weight_noise.to_dict()
                             if self.weight_noise is not None else None),
        }, indent=1, default=str)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        data = json.loads(s)
        pres = {}
        for k, v in data.get("preprocessors", {}).items():
            v = dict(v)
            cls = PREPROCESSORS[v.pop("@class")]
            pres[int(k)] = cls(**v)
        return MultiLayerConfiguration(
            layers=[layer_from_dict(d) for d in data["layers"]],
            input_type=tuple(data["input_type"]) if data.get("input_type") else None,
            preprocessors=pres,
            updater=IUpdater.from_dict(data["updater"]),
            seed=data.get("seed", 12345), l1=data.get("l1", 0.0),
            l2=data.get("l2", 0.0), weight_decay=data.get("weight_decay", 0.0),
            gradient_normalization=data.get("gradient_normalization"),
            gradient_clip=data.get("gradient_clip", 1.0),
            dtype=data.get("dtype", "float32"),
            remat=data.get("remat"),
            grad_accum=data.get("grad_accum", 0),
            constraints=constraints_mod.specs_from_json(
                data.get("constraints")),
            weight_noise=weightnoise_mod.weight_noise_from_dict(
                data.get("weight_noise")))


class ListBuilder:
    """``.list()`` stage of the builder (reference NeuralNetConfiguration
    .Builder.list())."""

    def __init__(self, base: "NeuralNetConfigurationBuilder"):
        self._base = base
        self._layers: List[L.Layer] = []
        self._input_type = None
        self._preprocessors = {}

    def layer(self, layer_or_idx, maybe_layer=None) -> "ListBuilder":
        if maybe_layer is not None:
            self._layers.append(maybe_layer)
        else:
            self._layers.append(layer_or_idx)
        return self

    def set_input_type(self, input_type) -> "ListBuilder":
        self._input_type = tuple(input_type)
        return self

    def input_pre_processor(self, idx: int, pre) -> "ListBuilder":
        self._preprocessors[idx] = pre
        return self

    def build(self) -> MultiLayerConfiguration:
        pres = dict(self._preprocessors)
        if self._input_type is not None:
            cur = self._input_type
            for i, layer in enumerate(self._layers):
                if i not in pres:
                    auto = infer_preprocessor(cur, layer)
                    if auto is not None:
                        pres[i] = auto
                if i in pres:
                    cur = pres[i].out_type(cur)
                cur = layer.output_type(cur)
        b = self._base
        return MultiLayerConfiguration(
            layers=self._layers, input_type=self._input_type,
            preprocessors=pres, updater=b._updater, seed=b._seed,
            l1=b._l1, l2=b._l2, weight_decay=b._weight_decay,
            gradient_normalization=b._grad_norm,
            gradient_clip=b._grad_clip, dtype=b._dtype,
            remat=b._remat, grad_accum=b._grad_accum,
            constraints=list(b._constraints), weight_noise=b._weight_noise)


class NeuralNetConfigurationBuilder:
    """Reference NeuralNetConfiguration.Builder fluent DSL."""

    def __init__(self):
        self._seed = 12345
        self._updater = Sgd()
        self._l1 = 0.0
        self._l2 = 0.0
        self._weight_decay = 0.0
        self._grad_norm = None
        self._grad_clip = 1.0
        self._dtype = "float32"
        self._remat = None
        self._grad_accum = 0
        self._constraints = []
        self._weight_noise = None

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def updater(self, u: IUpdater):
        self._updater = u
        return self

    def l1(self, v: float):
        self._l1 = v
        return self

    def l2(self, v: float):
        self._l2 = v
        return self

    def weight_decay(self, v: float):
        self._weight_decay = v
        return self

    def data_type(self, dt: str):
        self._dtype = dt
        return self

    def gradient_normalization(self, mode: str, clip: float = 1.0):
        self._grad_norm = mode
        self._grad_clip = clip
        return self

    def remat(self, mode: str):
        """Activation checkpointing in the train step: "none" | "layer" |
        "dots_saveable" (recompute instead of storing activations for the
        backward pass)."""
        self._remat = mode
        return self

    def grad_accum(self, k: int):
        """Gradient accumulation: split each fit() batch into ``k``
        micro-batches, average their gradients and apply the updater
        once."""
        self._grad_accum = int(k)
        return self

    # constraint hooks (reference constrainWeights / constrainBias /
    # constrainAllParameters)
    def constrain_weights(self, *cs):
        self._constraints += [("weights", c) for c in cs]
        return self

    def constrain_bias(self, *cs):
        self._constraints += [("bias", c) for c in cs]
        return self

    def constrain_all_parameters(self, *cs):
        self._constraints += [("all", c) for c in cs]
        return self

    def weight_noise(self, wn):
        """Network-default weight noise (reference Builder.weightNoise)."""
        self._weight_noise = wn
        return self

    def list(self) -> ListBuilder:
        return ListBuilder(self)

    def graph_builder(self):
        """The ComputationGraph builder (reference
        ComputationGraphConfiguration.GraphBuilder) over this builder's
        network-wide settings."""
        from ..graph.computation_graph import GraphBuilder
        return GraphBuilder(self)


class NeuralNetConfiguration:
    @staticmethod
    def builder() -> NeuralNetConfigurationBuilder:
        return NeuralNetConfigurationBuilder()
