"""ComputationGraph: the DAG network of the layer API.

Counterpart of ``deeplearning4j_tpu/nn/graph/computation_graph.py`` (the
reference's ``ComputationGraph.java`` and
``ComputationGraphConfiguration.java`` with its GraphBuilder DSL). The
topological order is computed once from the configuration; a forward
walks it vertex by vertex, and a train step is that forward, the summed
losses of the output vertices and one autograd backward, then the
updater and the constraints, functionally, as ``MultiLayerNetwork``'s.

Parameters are a vertex-name -> dict of tensors on ``device`` (the card
unless the caller names another) in the JAX package's layout, so
``params()`` flattens in its order (vertex by vertex in topological
order, keys sorted) and a JAX graph's params cross unchanged
(``bridge.load_graph``). Mixed precision is the JAX package's: the body
in ``conf.dtype``, the inputs of the output vertices cast to f32 and
their params left as they are.

``output()`` pads the batch up the inference bucket ladder and
``warm_buckets`` runs that ladder ahead of traffic. ``save`` / ``load``
write and read ``nn/serde.py``'s zip. ``distribute(mesh)`` keeps each
rank's shards of the params (``nn/sharding.py``'s rules) and ``fit``
runs the sharded step on the global batches, as ``MultiLayerNetwork``'s
does.
"""
from __future__ import annotations

import dataclasses
import json
import math
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...common import rng
from ...datasets.dataset import DataSet, MultiDataSet
from ...learning import IUpdater, Sgd, tree_map
from ...ndarray.ndarray import NDArray
from ..conf import constraints as constraints_mod
from ..conf import layers as L
from ..conf import weightnoise as weightnoise_mod
from ..conf.config import (PREPROCESSORS, infer_preprocessor,
                           layer_from_dict, layer_to_dict)
from ..fit_fastpath import FitFastPathMixin, full_f32
from ..multilayer import resolve_device
from .vertices import VERTEX_CLASSES, GraphVertex, PreprocessorVertex


@dataclasses.dataclass
class LayerVertex:
    """A Layer used as a graph vertex (reference
    nn/graph/vertex/impl/LayerVertex.java)."""
    layer: L.Layer
    preprocessor: object = None

    def init_params(self, generator, input_types):
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.out_type(it)
        return self.layer.init_params(generator, it) \
            if self.layer.has_params() else {}

    def forward(self, params, inputs, training=False, key=None):
        x = inputs[0]
        if self.preprocessor is not None:
            x = self.preprocessor(x)
        return self.layer.forward(params, x, training=training, key=key)

    def output_type(self, input_types):
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.out_type(it)
        return self.layer.output_type(it)

    def has_params(self):
        return self.layer.has_params()

    def needs_key(self):
        return self.layer.needs_key()


def _layer_of(v):
    return v.layer if isinstance(v, LayerVertex) else v


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """Reference conf/ComputationGraphConfiguration.java."""
    inputs: List[str]
    outputs: List[str]
    vertices: Dict[str, Any]                  # name -> LayerVertex | GraphVertex
    vertex_inputs: Dict[str, List[str]]       # name -> input vertex names
    input_types: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd())
    seed: int = 12345
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    gradient_normalization: Optional[str] = None
    gradient_clip: float = 1.0
    dtype: str = "float32"
    #: activation checkpointing in the train step ("none" | "layer" |
    #: "dots_saveable"); None resolves the Environment default
    remat: Optional[str] = None
    #: micro-batches per optimizer step; 0/None resolves the Environment
    #: default (DL4J_TPU_GRAD_ACCUM)
    grad_accum: int = 0
    #: [(target, constraint)] applied post-update (see conf/constraints.py)
    constraints: list = dataclasses.field(default_factory=list)
    #: network-default IWeightNoise applied pre-forward during training
    weight_noise: Optional[Any] = None

    def topological_order(self) -> List[str]:
        """Kahn topological sort (reference ComputationGraph.java:484-515)."""
        indeg = {n: len(ins) for n, ins in self.vertex_inputs.items()}
        children: Dict[str, List[str]] = {}
        for n, ins in self.vertex_inputs.items():
            for i in ins:
                children.setdefault(i, []).append(n)
        order, ready = [], list(self.inputs)
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in sorted(children.get(n, [])):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        missing = set(self.vertex_inputs) - set(order)
        if missing:
            raise ValueError(
                f"graph has a cycle or unreachable vertices: {missing}")
        return order

    def vertex_output_types(self) -> Dict[str, Tuple[int, ...]]:
        types = dict(self.input_types)
        for name in self.topological_order():
            if name in self.inputs:
                continue
            ins = [types.get(i) for i in self.vertex_inputs[name]]
            try:
                types[name] = self.vertices[name].output_type(ins) \
                    if None not in ins else None
            except Exception:
                types[name] = None
        return types

    # -- serde -----------------------------------------------------------
    def to_json(self) -> str:
        def pre_dict(pre):
            if pre is None:
                return None
            return {"@class": type(pre).__name__,
                    **(dataclasses.asdict(pre)
                       if dataclasses.is_dataclass(pre) else {})}

        def vert(v):
            if isinstance(v, LayerVertex):
                return {"type": "layer", "layer": layer_to_dict(v.layer),
                        "preprocessor": pre_dict(v.preprocessor)}
            d = {"type": "vertex", "@class": type(v).__name__}
            for f in dataclasses.fields(v):
                fv = getattr(v, f.name)
                if isinstance(v, PreprocessorVertex) and \
                        f.name == "preprocessor":
                    fv = pre_dict(fv)
                elif not isinstance(fv, (int, float, str, bool, tuple, list,
                                         type(None))):
                    fv = str(fv)
                d[f.name] = fv
            return d

        return json.dumps({
            "inputs": self.inputs, "outputs": self.outputs,
            "vertices": {n: vert(v) for n, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "input_types": {k: list(v) for k, v in self.input_types.items()},
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
    def from_json(s: str) -> "ComputationGraphConfiguration":
        data = json.loads(s)

        def mk_pre(pd):
            if pd is None:
                return None
            pd = dict(pd)
            name = pd.pop("@class")
            if name not in PREPROCESSORS:
                raise ValueError(
                    f"unknown preprocessor {name!r} in saved config; "
                    f"known: {sorted(PREPROCESSORS)}")
            return PREPROCESSORS[name](**pd)

        verts = {}
        for n, d in data["vertices"].items():
            if d["type"] == "layer":
                verts[n] = LayerVertex(layer_from_dict(d["layer"]),
                                       mk_pre(d.get("preprocessor")))
            else:
                d = dict(d)
                d.pop("type")
                cls = VERTEX_CLASSES[d.pop("@class")]
                for k, v in d.items():
                    if k == "preprocessor" and isinstance(v, dict):
                        d[k] = mk_pre(v)
                    elif isinstance(v, list):
                        d[k] = tuple(v)
                verts[n] = cls(**d)
        return ComputationGraphConfiguration(
            inputs=list(data["inputs"]), outputs=list(data["outputs"]),
            vertices=verts,
            vertex_inputs={k: list(v)
                           for k, v in data["vertex_inputs"].items()},
            input_types={k: tuple(v)
                         for k, v in data.get("input_types", {}).items()},
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


class GraphBuilder:
    """Reference ComputationGraphConfiguration.GraphBuilder fluent DSL."""

    def __init__(self, base=None):
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, Any] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Dict[str, Tuple[int, ...]] = {}
        self._base = base

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types) -> "GraphBuilder":
        for name, t in zip(self._inputs, types):
            self._input_types[name] = tuple(t)
        return self

    def add_layer(self, name: str, layer: L.Layer, *inputs: str,
                  preprocessor=None) -> "GraphBuilder":
        self._vertices[name] = LayerVertex(layer, preprocessor)
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        """The configuration."""
        conf = ComputationGraphConfiguration(
            inputs=self._inputs, outputs=self._outputs,
            vertices=self._vertices, vertex_inputs=self._vertex_inputs,
            input_types=self._input_types)
        if self._base is not None:
            b = self._base
            conf.updater = b._updater
            conf.seed = b._seed
            conf.l1, conf.l2 = b._l1, b._l2
            conf.weight_decay = b._weight_decay
            conf.gradient_normalization = b._grad_norm
            conf.gradient_clip = b._grad_clip
            conf.dtype = b._dtype
            conf.remat = b._remat
            conf.grad_accum = b._grad_accum
            conf.constraints = list(b._constraints)
            conf.weight_noise = b._weight_noise
        # automatic preprocessors from the inferred types (reference
        # GraphBuilder.setInputTypes shape-inference pass)
        if self._input_types:
            types = dict(self._input_types)
            for name in conf.topological_order():
                if name in conf.inputs:
                    continue
                v = conf.vertices[name]
                ins = [types.get(i) for i in conf.vertex_inputs[name]]
                if (isinstance(v, LayerVertex) and v.preprocessor is None
                        and ins and ins[0] is not None):
                    v.preprocessor = infer_preprocessor(ins[0], v.layer)
                try:
                    types[name] = v.output_type(ins) \
                        if None not in ins else None
                except Exception:
                    types[name] = None
        return conf


class ComputationGraph(FitFastPathMixin):
    """Reference org/deeplearning4j/nn/graph/ComputationGraph.java."""

    def __init__(self, conf: ComputationGraphConfiguration, device="cuda"):
        self.device = resolve_device(device)
        self.conf = conf
        self._order = [n for n in conf.topological_order()
                       if n not in conf.inputs]
        self._params: Dict[str, Dict[str, Any]] = {}
        self._updater_state = None
        self._iteration = 0
        self._epoch = 0
        self._listeners: List[Any] = []
        #: the mesh of ``distribute`` (None: one process, whole params)
        self._mesh = None
        #: host stream of the int keys the training forwards draw from
        self._rng = torch.Generator().manual_seed(int(conf.seed))
        self._initialized = False
        self.score_value = float("nan")

    # -- init ------------------------------------------------------------
    def init(self, params=None):
        """Initialize parameters: each vertex's weights drawn in
        topological order from one generator on the device seeded with
        ``conf.seed``, or ``params`` as given."""
        if params is not None:
            self._params = params
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(self.conf.seed))
            types = self.conf.vertex_output_types()
            self._params = {}
            for name in self._order:
                v = self.conf.vertices[name]
                ins = [types.get(i) for i in self.conf.vertex_inputs[name]]
                self._params[name] = v.init_params(gen, ins) \
                    if v.has_params() else {}
        self._updater_state = self.conf.updater.init(
            self._trainable(self._params))
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("call init() first")

    def distribute(self, mesh):
        """Shard the graph over a mesh (dp/fsdp/tp); see
        ``MultiLayerNetwork.distribute`` and ``nn/sharding.py``."""
        self._check_init()
        from ..sharding import shard_layer_params
        return self._distribute(mesh, {
            name: shard_layer_params(mesh, _layer_of(self.conf.vertices[
                name]), p) if p else p
            for name, p in self._params.items()})

    def save(self, path, save_updater: bool = False):
        """The zip of ``nn/serde.py``, which the JAX package reads too."""
        from ..serde import save_computation_graph
        save_computation_graph(self, path, save_updater)

    @staticmethod
    def load(path, load_updater: bool = False, device="cuda"):
        from ..serde import restore_computation_graph
        return restore_computation_graph(path, load_updater, device)

    def _trainable(self, params):
        return {n: {k: v for k, v in p.items() if not k.startswith("state_")}
                for n, p in params.items()}

    def _states(self, params):
        return {n: {k: v for k, v in p.items() if k.startswith("state_")}
                for n, p in params.items()}

    def _merge_states(self, trainable, states):
        return {n: {**trainable[n], **states[n]} for n in trainable}

    # -- forward ---------------------------------------------------------
    def _forward(self, params, inputs: Dict[str, torch.Tensor], training,
                 key=None, collect_state=False):
        """Topological forward; returns every vertex's activation by name.
        With ``collect_state``, also each stateful vertex's layer input
        (after its preprocessor), so the train step refreshes running
        stats without a second pass."""
        cd = self._compute_dtype()
        acts: Dict[str, torch.Tensor] = dict(inputs)
        if cd is not None:
            acts = {k: self._cast_act(v, cd) for k, v in acts.items()}
        out_set = set(self.conf.outputs)
        # the i-th vertex in order draws from rng.fold(key, i, purpose)
        key = rng.as_key(key, self.device) \
            if key is not None and training else None
        state_inputs: Dict[str, torch.Tensor] = {}
        stateful = set(self._stateful_vertices()) if collect_state else ()
        remat = (self._remat_wrap if training and self._remat_mode() != "none"
                 else None)
        for vi, name in enumerate(self._order):
            v = self.conf.vertices[name]
            ins = [acts[i] for i in self.conf.vertex_inputs[name]]
            p = params[name]
            if cd is not None:
                if name in out_set:  # loss head in f32
                    ins = [self._cast_act(a, torch.float32) for a in ins]
                else:
                    p = self._cast_layer_params(p, cd)
            if name in stateful:
                pre = getattr(v, "preprocessor", None)
                state_inputs[name] = pre(ins[0]) if pre is not None \
                    else ins[0]
            wn = (getattr(getattr(v, "layer", None), "weight_noise", None)
                  or self.conf.weight_noise)
            if wn is not None and key is not None and p:
                p = wn.apply_tree(rng.fold(key, vi, rng.WEIGHT_NOISE), p)
            vkey = rng.fold(key, vi, rng.LAYER_DRAW) \
                if key is not None and v.needs_key() else None

            def fwd(p_, ins_, k_, _v=v):
                return _v.forward(p_, ins_, training=training, key=k_)
            acts[name] = (remat(fwd) if remat else fwd)(p, ins, vkey)
        if collect_state:
            return acts, state_inputs
        return acts

    def _inputs_dict(self, inputs) -> Dict[str, torch.Tensor]:
        """A request (one array, a list in ``conf.inputs`` order, or a
        name -> array dict) as staged tensors by input name."""
        if isinstance(inputs, dict):
            return {k: self._stage(v) for k, v in inputs.items()}
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return {n: self._stage(x) for n, x in zip(self.conf.inputs, inputs)}

    def _output_fn(self, training=False):
        """The census-counted forward that ``output()`` and
        ``InferenceEngine`` share, one per ``training`` flag: (params,
        {input name: tensor}) -> the output vertices' activations in
        ``conf.outputs`` order. Inference replays one CUDA graph a padded
        signature (``captured_dispatch``), the training-mode forward runs
        eagerly (``counted_dispatch``)."""
        fns = self.__dict__.setdefault("_out_fns", {})
        fn = fns.get(training)
        if fn is None:
            from ...runtime.inference import (captured_dispatch,
                                              counted_dispatch)
            # a quantized twin's tag stays apart from its original's
            tag = f"cg:{id(self)}:{int(training)}"
            prec = getattr(self, "_precision", None)
            if prec:
                tag += f":{prec}"

            # a weak reference, as MultiLayerNetwork's
            net = weakref.ref(self)

            def forward(params, ind):
                n = net()
                with torch.no_grad(), full_f32():
                    acts = n._forward(
                        n._full_params(params),
                        {k: n._stage(x) for k, x in ind.items()},
                        training)
                return [acts[o] for o in n.conf.outputs]
            fn = (counted_dispatch(forward, tag=tag) if training
                  else captured_dispatch(forward, tag, self.device))
            fns[training] = fn
        return fn

    def output(self, *inputs, training: bool = False) -> List[NDArray]:
        """Multi-output inference (reference ComputationGraph.output),
        without autograd, in ``conf.outputs`` order.

        Batch-bucketed as ``MultiLayerNetwork.output``: inputs sharing a
        leading batch dim are padded up to the bucket, outputs carrying
        it are sliced back; exact shape otherwise."""
        self._check_init()
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple, dict)):
            inputs = inputs[0]
        from ...common.tracing import span
        from ...runtime.inference import maybe_pad_tree, slice_batch
        ind, pad = maybe_pad_tree(self._inputs_dict(inputs),
                                  training=training)
        with span("cg/output"):
            outs = self._output_fn(training)(self._params, ind)
        if pad is not None:
            outs = slice_batch(outs, *pad)
        return [NDArray(o) for o in outs]

    def output_single(self, *inputs) -> NDArray:
        return self.output(*inputs)[0]

    def warm_buckets(self, example, batch_sizes=None) -> List[int]:
        """Run the inference bucket ladder of the direct ``output()``
        path ahead of traffic (see ``MultiLayerNetwork.warm_buckets``);
        ``example`` is any valid request. Returns the buckets warmed."""
        from ...common.environment import environment
        from ...runtime.inference import InferenceEngine
        return InferenceEngine(
            self, max_batch=environment().inference_max_batch()).warmup(
                example, batch_sizes=batch_sizes)

    def feed_forward(self, inputs, training: bool = False
                     ) -> Dict[str, NDArray]:
        """Every vertex's activation, inputs included (reference
        feedForward), through the mixed-precision forward as the JAX
        package's."""
        self._check_init()
        with torch.no_grad(), full_f32():
            acts = self._forward(self._params, self._inputs_dict(inputs),
                                 training)
        return {k: NDArray(v) for k, v in acts.items()}

    # -- loss ------------------------------------------------------------
    def _output_layers(self):
        outs = []
        for o in self.conf.outputs:
            layer = _layer_of(self.conf.vertices[o])
            if not hasattr(layer, "compute_loss"):
                raise ValueError(f"output vertex {o} has no loss")
            outs.append((o, layer))
        return outs

    def _stateful_vertices(self):
        """Vertices whose layer carries non-trainable state (batch-norm
        running stats, center-loss centres)."""
        return [n for n in self._order
                if hasattr(_layer_of(self.conf.vertices[n]), "new_state")]

    def _loss(self, trainable, states, inputs, labels, key):
        """The train-step loss (summed over the output vertices, plus the
        penalties) and the collected stateful-vertex inputs."""
        params = self._merge_states(trainable, states)
        acts, state_inputs = self._forward(params, inputs, training=True,
                                           key=key, collect_state=True)
        loss = 0.0
        for (name, layer), y in zip(self._output_layers(), labels):
            if hasattr(layer, "compute_loss_ext"):
                # a head whose loss reads its input features (center loss)
                loss = loss + layer.compute_loss_ext(
                    params[name], y, acts[name], state_inputs.get(name))
            else:
                loss = loss + layer.compute_loss(y, acts[name])
        return self._regularized(loss, trainable), state_inputs

    def score(self, dataset=None) -> float:
        """Loss on a dataset: the training-mode forward with no key (no
        dropout draws)."""
        self._check_init()
        if dataset is None:
            return self.score_value
        inputs, labels = self._split_dataset(dataset)
        params = self._full_params(self._params)
        with torch.no_grad(), full_f32():
            loss, _ = self._loss(self._trainable(params),
                                 self._states(params), inputs, labels, None)
        return float(loss)

    # -- training --------------------------------------------------------
    def _split_dataset(self, ds):
        """({input name: tensor}, [labels in conf.outputs order]) of a
        DataSet or MultiDataSet, staged on the network's device."""
        if isinstance(ds, MultiDataSet):
            feats = [self._stage(f) for f in ds.features]
            labs = [self._stage(y) for y in ds.labels]
        else:
            feats = [self._stage(ds.features)]
            labs = [self._stage(ds.labels)]
        return {n: x for n, x in zip(self.conf.inputs, feats)}, labs

    @torch.no_grad()
    def _refresh_states(self, states, state_inputs, labels):
        label_of = dict(zip(self.conf.outputs, labels))
        new_states = dict(states)
        for name, sx in state_inputs.items():
            new_states[name] = _layer_of(self.conf.vertices[name]).new_state(
                states[name], sx.detach(), labels=label_of.get(name))
        return new_states

    def _micro_grads(self, trainable, states, inputs, labels, key):
        """Loss + refreshed states + gradients of ONE micro-batch (no
        updater)."""
        leaves = tree_map(lambda v: v.detach().requires_grad_(True),
                          trainable)
        flat = [v for p in leaves.values() for v in p.values()]
        with torch.enable_grad(), full_f32():
            loss, state_inputs = self._loss(leaves, states, inputs, labels,
                                            key)
            gflat = torch.autograd.grad(loss, flat, allow_unused=True) \
                if flat else ()
        # a leaf the loss does not reach (allow_unused) gets a zero grad
        it = iter(torch.zeros_like(v) if g is None else g
                  for g, v in zip(gflat, flat))
        grads = {n: {k: next(it) for k in p} for n, p in leaves.items()}
        return (loss.detach(),
                self._refresh_states(states, state_inputs, labels), grads)

    def _step_fn(self):
        """One batch: gradients, then the update."""
        def step(trainable, states, updater_state, iteration, inputs, labels,
                 key):
            loss, new_states, grads = self._micro_grads(trainable, states,
                                                        inputs, labels, key)
            new_trainable, updater_state = self._apply_update(
                trainable, updater_state, iteration, grads)
            return new_trainable, new_states, updater_state, loss
        return step

    def _coerce_fit_data(self, data, labels):
        return DataSet(data, labels) if labels is not None else data

    def _stage_batch(self, item):
        return self._split_dataset(item)

    def _materialize_batches(self, data):
        """Device-resident [(inputs, labels)] if ``data`` is a finite
        reusable source (a DataSet or MultiDataSet, a list of them, a
        ListDataSetIterator); None -> stream it."""
        from ...datasets.iterators import ListDataSetIterator
        if isinstance(data, (DataSet, MultiDataSet)):
            items = [data]
        elif isinstance(data, (list, tuple)) and data and \
                all(isinstance(d, (DataSet, MultiDataSet)) for d in data):
            items = list(data)
        elif isinstance(data, ListDataSetIterator):
            items = list(data._list)
        else:
            return None
        return [self._split_dataset(d) for d in items]

    # -- evaluation ------------------------------------------------------
    def evaluate(self, iterator):
        from ..evaluation import Evaluation
        e = Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            e.eval(ds.labels, self.output_single(ds.features))
        return e

    # -- parameter access ------------------------------------------------
    def _flat_leaves(self):
        """(vertex, key) of every trainable tensor in the JAX package's
        flat order: vertices in topological order, keys sorted."""
        return [(n, k) for n in self._order for k in sorted(self._params[n])
                if not k.startswith("state_")]

    def params(self) -> NDArray:
        self._check_init()
        params = self._full_params(self._params)
        leaves = [params[n][k].reshape(-1) for n, k in self._flat_leaves()]
        if not leaves:
            return NDArray(torch.zeros((0,), device=self.device))
        return NDArray(torch.cat(leaves))

    def num_params(self) -> int:
        return int(self.params().length())

    def set_params(self, flat):
        self._check_init()
        flat = self._stage(flat)
        new_params = {n: dict(p) for n, p in self._params.items()}
        offset = 0
        for n, k in self._flat_leaves():
            old = self._params[n][k]
            size = math.prod(old.shape)
            new_params[n][k] = flat[offset:offset + size].reshape(
                old.shape).to(old.dtype).clone()
            offset += size
        self._params = new_params

    def get_param_table(self, name: str) -> Dict[str, NDArray]:
        return {k: NDArray(v) for k, v in self._params[name].items()}

    def set_listeners(self, *listeners):
        self._listeners = list(listeners)

    def get_updater_state(self):
        return self._updater_state

    def clone(self) -> "ComputationGraph":
        net = ComputationGraph(self.conf, device=self.device)
        if self._initialized:
            net.init(params=tree_map(torch.clone, self._params))
            if self._updater_state is not None:
                net._updater_state = tree_map(torch.clone,
                                              self._updater_state)
            net._iteration = self._iteration
        return net

    def summary(self) -> str:
        types = self.conf.vertex_output_types()
        lines = ["=" * 72]
        total = 0
        for name in self._order:
            v = self.conf.vertices[name]
            n = sum(math.prod(p.shape) for k, p in
                    self._params.get(name, {}).items()
                    if not k.startswith("state_")) \
                if self._initialized else 0
            total += n
            lines.append(f"{name:<20} {type(_layer_of(v)).__name__:<28} "
                         f"out={types.get(name)} params={n} "
                         f"in={self.conf.vertex_inputs[name]}")
        lines.append(f"Total params: {total}")
        lines.append("=" * 72)
        return "\n".join(lines)
