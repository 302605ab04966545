"""MultiLayerNetwork: the sequential layer-API network.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (the reference's
``MultiLayerNetwork.java``). Parameters are a list of per-layer dicts of
tensors on ``device`` (the card unless the caller names another), in the
JAX package's layout, so ``params()`` flattens in the same order and a
JAX network's params cross unchanged (``bridge.load_multilayer``). A
train step is forward, loss and autograd backward, then the updater and
the post-update constraints, functionally: each step returns new
parameter tensors, as the JAX package's donated step does.

``output()`` pads the batch up the inference bucket ladder
(``runtime.inference.maybe_pad_tree``) and ``warm_buckets`` runs that
ladder ahead of traffic, as the JAX package's do. ``save`` / ``load``
write and read ``nn/serde.py``'s zip. ``distribute(mesh)`` keeps each
rank's shards of the params (``nn/sharding.py``'s rules); ``fit`` then
takes the global batch on every rank and runs the sharded step, and
``output`` / ``score`` / ``params`` see the gathered params.
``warm_compile`` (``nn/fit_fastpath.py``) records the first train step's
census event and readies the kernel libraries through the artifact
store without stepping.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, List

import torch

from ..common import rng
from ..datasets.dataset import DataSet
from ..learning import tree_map
from ..ndarray.ndarray import NDArray
from .conf.config import MultiLayerConfiguration
from .conf.layers import LossLayer, OutputLayer, RnnOutputLayer
from .fit_fastpath import FitFastPathMixin, _leaves, full_f32


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where torch sees
    none raises (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    return dev


class MultiLayerNetwork(FitFastPathMixin):
    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        self.device = resolve_device(device)
        self.conf = conf
        self.layers = conf.layers
        self._params: List[Dict[str, Any]] = []
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
        """Initialize parameters (reference MultiLayerNetwork.init): each
        layer's weights drawn in turn from one generator on the device
        seeded with ``conf.seed``, or ``params`` as given."""
        if params is not None:
            self._params = params
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(self.conf.seed))
            types = self.conf.layer_input_types()
            self._params = [layer.init_params(gen, itype)
                            if layer.has_params() else {}
                            for layer, itype in zip(self.layers, types)]
        self._updater_state = self.conf.updater.init(
            self._trainable(self._params))
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("call init() first")

    def distribute(self, mesh):
        """Shard this network over a mesh (dp/fsdp/tp): each layer's
        params placed by its spec rule (``nn/sharding.py``), the updater
        state re-initialised, the cached steps dropped. Every rank then
        calls ``fit`` with the same global batches."""
        self._check_init()
        from .sharding import shard_layer_params
        return self._distribute(mesh, [
            shard_layer_params(mesh, layer, p) if p else p
            for layer, p in zip(self.layers, self._params)])

    def warm_buckets(self, example, batch_sizes=None) -> List[int]:
        """Run the inference bucket ladder of the direct ``output()`` /
        ``predict()`` paths ahead of traffic (without a standing
        InferenceEngine). Delegates to ``InferenceEngine.warmup``: the
        engine dispatches through the same ``_output_fn(False)`` that
        ``output()`` uses, so the shapes land in one census. Returns the
        buckets warmed."""
        from ..common.environment import environment
        from ..runtime.inference import InferenceEngine
        return InferenceEngine(
            self, max_batch=environment().inference_max_batch()).warmup(
                example, batch_sizes=batch_sizes)

    def save(self, path, save_updater: bool = False):
        """The zip of ``nn/serde.py``, which the JAX package reads too."""
        from .serde import save_multilayer
        save_multilayer(self, path, save_updater)

    @staticmethod
    def load(path, load_updater: bool = False, device="cuda"):
        from .serde import restore_multilayer
        return restore_multilayer(path, load_updater, device)

    def _trainable(self, params):
        """Trainable subset (excludes ``state_*`` running stats)."""
        return [{k: v for k, v in p.items() if not k.startswith("state_")}
                for p in params]

    def _states(self, params):
        return [{k: v for k, v in p.items() if k.startswith("state_")}
                for p in params]

    def _merge_states(self, trainable, states):
        return [{**t, **s} for t, s in zip(trainable, states)]

    def _weight_noised(self, layer, p, key, i):
        """Train-time weight noise: the layer's setting wins over the
        network default; it draws from layer ``i``'s noise key."""
        wn = getattr(layer, "weight_noise", None) or self.conf.weight_noise
        if wn is None or key is None or not p:
            return p
        return wn.apply_tree(rng.fold(key, i, rng.WEIGHT_NOISE), p)

    # -- forward ---------------------------------------------------------
    def _forward_core(self, params, x, training: bool, key=None,
                      collect_bn: bool = False):
        """THE per-layer forward loop (inference, train step and score
        all route here).

        Threads the timestep keep-mask: a layer with ``emits_mask``
        (``MaskLayer``) computes it from its input, the layers with
        ``accepts_mask`` (the RNNs and their wrappers) consume it, and it
        is dropped where a layer consumes the time axis
        (``return_sequence`` false). With ``collect_bn``, each stateful
        layer's input is kept so the train step refreshes running stats
        without a second pass. Returns (activations, mask or None,
        bn_inputs). ``key`` (an int or a 0-d tensor) is the step's: layer
        i draws from ``rng.fold(key, i, purpose)`` on the device."""
        cd = self._compute_dtype()
        last = len(self.layers) - 1
        h = self._cast_act(x, cd) if cd is not None else x
        key = rng.as_key(key, self.device) \
            if key is not None and training else None
        mask = None
        bn_inputs = {}
        remat = (self._remat_wrap if training and self._remat_mode() != "none"
                 else None)
        for i, layer in enumerate(self.layers):
            pre = self.conf.preprocessors.get(i)
            if pre is not None:
                h = pre(h)
            p = params[i]
            if cd is not None:
                if i == last:  # loss head in f32
                    h = self._cast_act(h, torch.float32)
                else:
                    p = self._cast_layer_params(p, cd)
            if collect_bn and hasattr(layer, "new_state"):
                bn_inputs[i] = h
            p = self._weight_noised(layer, p, key, i)
            layer_key = rng.fold(key, i, rng.LAYER_DRAW) \
                if key is not None and layer.needs_key() else None
            if getattr(layer, "emits_mask", False):
                mask = layer.compute_mask(h)
            if mask is not None and getattr(layer, "accepts_mask", False):
                def fwd(p_, h_, k_, m_, _l=layer):
                    return _l.forward(p_, h_, training=training, key=k_,
                                      mask=m_)
                h = (remat(fwd) if remat else fwd)(p, h, layer_key, mask)
                if not getattr(layer, "return_sequence", True):
                    mask = None  # the time axis is consumed
            else:
                def fwd(p_, h_, k_, _l=layer):
                    return _l.forward(p_, h_, training=training, key=k_)
                h = (remat(fwd) if remat else fwd)(p, h, layer_key)
        return h, mask, bn_inputs

    def _forward(self, params, x, training: bool, key=None):
        return self._forward_core(params, x, training, key)[0]

    def output(self, x, training: bool = False) -> NDArray:
        """Inference forward pass (reference MultiLayerNetwork.output),
        without autograd.

        Batch-bucketed by default (``Environment.inference_bucketing``):
        the batch dim is zero-padded up to the next bucket of the ladder
        so K distinct request sizes share at most ceil(log2(max_batch))+1
        dispatch shapes (the census CUDA-graph capture will replay,
        ``ROADMAP.md`` queue 1 #12); padded rows are sliced off. Exact
        shape when disabled, training=True, or above the ladder."""
        self._check_init()
        from ..common.tracing import span
        from ..runtime.inference import maybe_pad_tree
        xp, pad = maybe_pad_tree(self._stage(x), training=training)
        with span("mln/output"):
            out = self._output_fn(training)(self._params, xp)
        if pad is not None:
            out = out[:pad[0]]
        return NDArray(out)

    def _output_fn(self, training=False):
        """The census-counted forward that ``output()`` and
        ``InferenceEngine`` share, one per ``training`` flag: inference
        replays one CUDA graph a padded signature (``captured_dispatch``,
        re-captured after ``fit`` or ``set_params`` replace the params),
        the training-mode forward runs eagerly (``counted_dispatch``). Its
        input is staged on the network's device."""
        fns = self.__dict__.setdefault("_out_fns", {})
        fn = fns.get(training)
        if fn is None:
            from ..runtime.inference import (captured_dispatch,
                                             counted_dispatch)
            # a quantized twin carries _precision: its census tag stays
            # apart from its full-precision original's (the first tag
            # segment is the metric's kind label)
            tag = f"mln:{id(self)}:{int(training)}"
            prec = getattr(self, "_precision", None)
            if prec:
                tag += f":{prec}"

            # a weak reference: the network holds its forwards, and a
            # cycle would keep a dropped network's graphs until a
            # collection
            net = weakref.ref(self)

            def forward(params, x):
                n = net()
                with torch.no_grad(), full_f32():
                    return n._forward(n._full_params(params), n._stage(x),
                                      training)
            fn = (counted_dispatch(forward, tag=tag) if training
                  else captured_dispatch(forward, tag, self.device))
            fns[training] = fn
        return fn

    def feed_forward(self, x, training: bool = False) -> List[NDArray]:
        """All layer activations (reference feedForward), at the params'
        own dtypes (no mixed-precision cast), as the JAX package's."""
        self._check_init()
        h = self._stage(x)
        acts = [NDArray(h)]
        mask = None
        with torch.no_grad(), full_f32():
            for i, layer in enumerate(self.layers):
                pre = self.conf.preprocessors.get(i)
                if pre is not None:
                    h = pre(h)
                if getattr(layer, "emits_mask", False):
                    mask = layer.compute_mask(h)
                if mask is not None and getattr(layer, "accepts_mask",
                                                False):
                    h = layer.forward(self._params[i], h, training=training,
                                      mask=mask)
                    if not getattr(layer, "return_sequence", True):
                        mask = None
                else:
                    h = layer.forward(self._params[i], h, training=training)
                acts.append(NDArray(h))
        return acts

    def predict(self, x) -> NDArray:
        return NDArray(torch.argmax(self.output(x).torch(), dim=-1))

    # -- loss ------------------------------------------------------------
    def _loss_layer(self):
        last = self.layers[-1]
        if not isinstance(last, (OutputLayer, LossLayer, RnnOutputLayer)):
            raise ValueError("last layer must be an output/loss layer for fit()")
        return last

    def _loss_with_bn(self, trainable, states, x, y, key):
        """Loss + collected stateful-layer inputs (the train-step loss)."""
        params = self._merge_states(trainable, states)
        out, kmask, bn_inputs = self._forward_core(params, x, training=True,
                                                   key=key, collect_bn=True)
        ll = self._loss_layer()
        li = len(self.layers) - 1
        # a live MaskLayer mask masks a temporal loss head too
        mask = kmask if isinstance(ll, RnnOutputLayer) else None
        if hasattr(ll, "compute_loss_ext"):
            # a head whose loss reads its input features (center loss)
            loss = ll.compute_loss_ext(params[li], y, out, bn_inputs.get(li),
                                       mask)
        else:
            loss = ll.compute_loss(y, out, mask)
        return self._regularized(loss, trainable), bn_inputs

    def score(self, dataset: DataSet = None) -> float:
        """Loss on a dataset (reference MultiLayerNetwork.score): the
        training-mode forward with no key (no dropout draws)."""
        self._check_init()
        if dataset is None:
            return self.score_value
        x, y = self._stage(dataset.features), self._stage(dataset.labels)
        params = self._full_params(self._params)
        with torch.no_grad(), full_f32():
            loss, _ = self._loss_with_bn(self._trainable(params),
                                         self._states(params), x, y, None)
        return float(loss)

    # -- training --------------------------------------------------------
    @torch.no_grad()
    def _refresh_states(self, states, bn_inputs, y):
        """Stateful layers (batch-norm running stats, center-loss
        centres, which also read the labels) refresh from the inputs
        collected during the forward pass."""
        new_states = []
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "new_state") and i in bn_inputs:
                new_states.append(layer.new_state(states[i],
                                                  bn_inputs[i].detach(),
                                                  labels=y))
            else:
                new_states.append(states[i])
        return new_states

    def _micro_grads(self, trainable, states, x, y, key):
        """Loss + refreshed states + gradients of ONE micro-batch (no
        updater)."""
        # a wrapper layer's params nest (Bidirectional's fwd / bwd)
        leaves = tree_map(lambda v: v.detach().requires_grad_(True),
                          trainable)
        flat = _leaves(leaves)
        with torch.enable_grad(), full_f32():
            loss, bn_inputs = self._loss_with_bn(leaves, states, x, y, key)
            gflat = torch.autograd.grad(loss, flat, allow_unused=True) \
                if flat else ()
        # a leaf the loss does not reach (allow_unused) gets a zero grad
        it = iter([torch.zeros_like(v) if g is None else g
                   for g, v in zip(gflat, flat)])
        grads = tree_map(lambda v: next(it), leaves)
        return (loss.detach(), self._refresh_states(states, bn_inputs, y),
                grads)

    def _step_fn(self):
        """One batch: gradients, then the update."""
        def step(trainable, states, updater_state, iteration, x, y, key):
            loss, new_states, grads = self._micro_grads(trainable, states,
                                                        x, y, key)
            new_trainable, updater_state = self._apply_update(
                trainable, updater_state, iteration, grads)
            return new_trainable, new_states, updater_state, loss
        return step

    def _coerce_fit_data(self, data, labels):
        return DataSet(data, labels) if labels is not None else data

    def _stage_batch(self, ds):
        return self._stage(ds.features), self._stage(ds.labels)

    def _materialize_batches(self, data):
        """Device-resident [(x, y)] if ``data`` is a finite reusable
        source (DataSet, list of DataSets, ListDataSetIterator); None →
        stream it."""
        from ..datasets.iterators import ListDataSetIterator
        if isinstance(data, DataSet):
            items = [data]
        elif isinstance(data, (list, tuple)) and data and \
                all(isinstance(d, DataSet) for d in data):
            items = list(data)
        elif isinstance(data, ListDataSetIterator):
            items = list(data._list)
        else:
            return None
        return [self._stage_batch(d) for d in items]

    # -- evaluation ------------------------------------------------------
    def evaluate(self, iterator):
        from .evaluation import Evaluation
        e = Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            e.eval(ds.labels, self.output(ds.features))
        return e

    def evaluate_regression(self, iterator):
        from .evaluation import RegressionEvaluation
        e = RegressionEvaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            e.eval(ds.labels, self.output(ds.features))
        return e

    # -- parameter access (flattened-view parity) ------------------------
    def params(self) -> NDArray:
        """Flattened parameter vector (reference params() view semantics):
        layer by layer, keys sorted within a layer."""
        self._check_init()
        leaves = [v.reshape(-1) for p in self._trainable(
            self._full_params(self._params)) for _, v in sorted(p.items())]
        if not leaves:
            return NDArray(torch.zeros((0,), device=self.device))
        return NDArray(torch.cat(leaves))

    def num_params(self) -> int:
        return int(self.params().length())

    def set_params(self, flat):
        self._check_init()
        flat = self._stage(flat)
        offset = 0
        new_params = []
        for p in self._params:
            q = dict(p)
            for k in sorted(p):
                if k.startswith("state_"):
                    continue
                n = math.prod(p[k].shape)
                q[k] = flat[offset:offset + n].reshape(p[k].shape).to(
                    p[k].dtype).clone()
                offset += n
            new_params.append(q)
        self._params = new_params

    def get_param_table(self, layer_idx: int) -> Dict[str, NDArray]:
        return {k: NDArray(v) for k, v in self._params[layer_idx].items()}

    def set_listeners(self, *listeners):
        self._listeners = list(listeners)

    def add_listeners(self, *listeners):
        self._listeners.extend(listeners)

    def get_updater_state(self):
        return self._updater_state

    def clone(self) -> "MultiLayerNetwork":
        net = MultiLayerNetwork(self.conf, device=self.device)
        if self._initialized:
            net.init(params=tree_map(torch.clone, self._params))
            if self._updater_state is not None:
                net._updater_state = tree_map(torch.clone,
                                              self._updater_state)
            net._iteration = self._iteration
        return net

    def summary(self) -> str:
        types = self.conf.layer_input_types()
        lines = ["=" * 60]
        total = 0
        for i, (layer, itype) in enumerate(zip(self.layers, types)):
            n = sum(math.prod(v.shape) for k, v in self._params[i].items()
                    if not k.startswith("state_")) if self._initialized else 0
            total += n
            lines.append(f"{i:>3} {type(layer).__name__:<28} in={itype} "
                         f"out={layer.output_type(itype)} params={n}")
        lines.append(f"Total params: {total}")
        lines.append("=" * 60)
        return "\n".join(lines)
