"""Transfer learning: fine-tune configurations, frozen feature extractors,
head replacement.

Counterpart of ``deeplearning4j_tpu/nn/transferlearning.py`` (the
reference's ``TransferLearning.java`` with its Builder and GraphBuilder,
and ``FineTuneConfiguration.java``). Freezing is structural: a frozen
layer's params move under ``state_frozen__`` keys (``FrozenLayer``),
which every train step leaves out of its gradients, so autograd records
nothing for the frozen part and the backward pass stops where the
trainable part begins.

A replaced layer and its direct consumers are re-initialised from one
``torch.Generator`` on the network's device seeded with ``conf.seed +
7`` (Builder) or ``conf.seed + 13`` (GraphBuilder), where the JAX package
splits ``jax.random.key`` of the same seed: the draws are the port's own.
The source network is left as it was; the new one shares its unchanged
tensors, which the functional train step never writes in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import torch

from ..learning import IUpdater
from .conf import layers as L
from .conf.layers_extra import FrozenLayer
from .multilayer import MultiLayerNetwork


@dataclasses.dataclass
class FineTuneConfiguration:
    """Reference FineTuneConfiguration: overrides applied network-wide."""
    updater: Optional[IUpdater] = None
    seed: Optional[int] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def l1(self, v):
            self._kw["l1"] = float(v)
            return self

        def l2(self, v):
            self._kw["l2"] = float(v)
            return self

        def weight_decay(self, v):
            self._kw["weight_decay"] = float(v)
            return self

        def build(self) -> "FineTuneConfiguration":
            return FineTuneConfiguration(**self._kw)

    @staticmethod
    def builder() -> "FineTuneConfiguration.Builder":
        return FineTuneConfiguration.Builder()

    def apply_to(self, conf):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                setattr(conf, f.name, v)


def _generator(net, seed: int) -> torch.Generator:
    return torch.Generator(device=net.device).manual_seed(int(seed))


class TransferLearning:
    """Reference TransferLearning entry: ``TransferLearning.Builder(net)``
    (MultiLayerNetwork) / ``TransferLearning.GraphBuilder(graph)``."""

    class GraphBuilder:
        """ComputationGraph transfer learning (reference
        TransferLearning.GraphBuilder): freeze up to a vertex, replace a
        layer vertex's nOut, fine-tune configuration."""

        def __init__(self, graph):
            graph._check_init()
            self._src = graph
            self._ftc: Optional[FineTuneConfiguration] = None
            self._frozen_until: Optional[str] = None
            self._nout_replace = {}

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, vertex_name: str):
            """Freeze ``vertex_name`` and everything topologically before
            it."""
            self._frozen_until = vertex_name
            return self

        def n_out_replace(self, vertex_name: str, n_out: int,
                          weight_init: str = "xavier"):
            self._nout_replace[vertex_name] = (int(n_out), weight_init)
            return self

        def build(self):
            from .graph.computation_graph import ComputationGraph, LayerVertex
            src = self._src
            conf = copy.deepcopy(src.conf)
            params = {n: dict(p) for n, p in src._params.items()}

            # nOut replacement re-initialises that vertex and its direct
            # consumers
            types = src.conf.vertex_output_types()
            gen = _generator(src, conf.seed + 13)
            for name, (n_out, w_init) in self._nout_replace.items():
                v = conf.vertices[name]
                layer = v.layer if isinstance(v, LayerVertex) else v
                layer.n_out = n_out
                if hasattr(layer, "weight_init"):
                    layer.weight_init = w_init
                in_types = [types.get(i) for i in conf.vertex_inputs[name]]
                params[name] = v.init_params(gen, in_types)
                out_type = layer.output_type(in_types[0]
                                             if in_types else None)
                for consumer, ins in conf.vertex_inputs.items():
                    if name in ins and consumer in conf.vertices:
                        cv = conf.vertices[consumer]
                        cl = cv.layer if isinstance(cv, LayerVertex) else cv
                        if hasattr(cl, "n_in"):
                            cl.n_in = n_out
                        if cv.has_params():
                            params[consumer] = cv.init_params(gen,
                                                              [out_type])

            # freeze the feature-extractor sub-DAG
            if self._frozen_until is not None:
                order = conf.topological_order()
                cutoff = order.index(self._frozen_until)
                for name in order[:cutoff + 1]:
                    if name in conf.inputs or name not in conf.vertices:
                        continue
                    v = conf.vertices[name]
                    if isinstance(v, LayerVertex) and v.layer.has_params():
                        v.layer = FrozenLayer(underlying=v.layer)
                        params[name] = FrozenLayer.wrap_params(params[name])

            if self._ftc is not None:
                self._ftc.apply_to(conf)
            return ComputationGraph(conf, device=src.device).init(
                params=params)

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            net._check_init()
            self._src = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._nout_replace = {}     # layer idx -> (n_out, weight_init)
            self._remove_from: Optional[int] = None
            self._appended: List[L.Layer] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx] (reference
            setFeatureExtractor)."""
            self._freeze_until = int(layer_idx)
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: str = "xavier"):
            """Replace a layer's output size, re-initialising its params
            and the next layer's (reference nOutReplace)."""
            self._nout_replace[int(layer_idx)] = (int(n_out), weight_init)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            self._remove_from = len(self._src.layers) - int(n)
            return self

        def add_layer(self, layer: L.Layer):
            self._appended.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._src
            layers = [copy.deepcopy(layer) for layer in src.layers]
            params = [dict(p) for p in src._params]
            if self._remove_from is not None:
                layers = layers[:self._remove_from]
                params = params[:self._remove_from]

            # nOut replacement: re-init that layer and the next one
            types = src.conf.layer_input_types()
            gen = _generator(src, src.conf.seed + 7)
            for idx, (n_out, w_init) in sorted(self._nout_replace.items()):
                if idx >= len(layers):
                    continue
                layer = layers[idx]
                layer.n_out = n_out
                if hasattr(layer, "weight_init"):
                    layer.weight_init = w_init
                params[idx] = layer.init_params(gen, types[idx])
                if idx + 1 < len(layers):
                    nxt = layers[idx + 1]
                    if hasattr(nxt, "n_in"):
                        nxt.n_in = n_out
                    params[idx + 1] = nxt.init_params(
                        gen, layer.output_type(types[idx]))

            # appended layers initialise from the current tail's output
            cur_type = None
            if layers:
                cur_type = layers[-1].output_type(
                    types[len(layers) - 1] if len(layers) - 1 < len(types)
                    else None)
            for new_layer in self._appended:
                layers.append(new_layer)
                params.append(new_layer.init_params(gen, cur_type)
                              if new_layer.has_params() else {})
                cur_type = new_layer.output_type(cur_type)

            # freeze the feature extractor
            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, len(layers))):
                    if layers[i].has_params():
                        layers[i] = FrozenLayer(underlying=layers[i])
                        params[i] = FrozenLayer.wrap_params(params[i])

            conf = copy.deepcopy(src.conf)
            conf.layers = layers
            conf.preprocessors = {i: p for i, p in conf.preprocessors.items()
                                  if i < len(layers)}
            if self._ftc is not None:
                self._ftc.apply_to(conf)
            return MultiLayerNetwork(conf, device=src.device).init(
                params=params)
