"""Activation-range calibration -> a serializable ``QuantSpec``.

A copy of the JAX package's ``quant/calibrate.py`` (the port imports
nothing from that package). Weight quantization needs no data (the scales
come from the weights themselves); what the calibration batch buys is (a)
recorded activation ranges per observation site (absmax, or a percentile)
so an operator can see whether the traffic the gate judged resembles
production, and (b) a batch fingerprint binding the spec to the data the
divergence gate validated on. The spec is plain JSON: it round-trips to
the same bytes (``from_json(to_json(s)).to_json() == s.to_json()``), and
the same fields give the same JSON as the JAX package's.

The generative branch runs the port model's ``forward`` on the batch as a
tensor on the model's device (a batch already on that device is used as
it is); a layer-API network stages the batch itself.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_METHODS = ("absmax", "percentile")
_MODES = ("int8", "fp8")


@dataclasses.dataclass
class QuantSpec:
    """Everything a quantized deploy needs, serializable.

    - ``mode``            — ``int8`` or ``fp8`` storage;
    - ``act_dtype``       — activation compute dtype of the twin (None =
      platform default: bf16 on CUDA, f32 on the CPU);
    - ``method``/``percentile`` — activation-range statistic collected at
      calibration (absmax, or the given percentile of ``|a|``);
    - ``min_size``/``skip_keys``/``embedding_keys`` — eligibility knobs
      of :func:`~deeplearning4j_tpu_torch.quant.transforms.quantize_params`;
    - ``act_ranges``      — the calibrated per-site ranges;
    - ``batch_fingerprint`` — shape/dtype signature of the calibration
      batch the ranges (and the divergence gate) were computed on;
    - ``scale_overrides`` — path-substring -> scale multiplier, the
      deliberate-mis-scale hook for gate drills and tests.
    """

    mode: str = "int8"
    act_dtype: Optional[str] = None
    method: str = "absmax"
    percentile: float = 99.9
    min_size: int = 256
    skip_keys: Tuple[str, ...] = ("position", "token_type")
    embedding_keys: Tuple[str, ...] = ("word",)
    act_ranges: Dict[str, float] = dataclasses.field(default_factory=dict)
    batch_fingerprint: Optional[str] = None
    scale_overrides: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"QuantSpec.mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.method not in _METHODS:
            raise ValueError(f"QuantSpec.method must be one of {_METHODS}, "
                             f"got {self.method!r}")
        self.skip_keys = tuple(self.skip_keys)
        self.embedding_keys = tuple(self.embedding_keys)

    # -- serde ------------------------------------------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["skip_keys"] = list(self.skip_keys)
        d["embedding_keys"] = list(self.embedding_keys)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "QuantSpec":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _dtype_shape(a) -> str:
    if isinstance(a, torch.Tensor):
        return f"{str(a.dtype).replace('torch.', '')}{list(a.shape)}"
    a = np.asarray(a)
    return f"{a.dtype}{list(a.shape)}"


def _fingerprint(batch) -> str:
    arrs = (list(batch.values()) if isinstance(batch, dict)
            else list(batch) if isinstance(batch, (list, tuple))
            else [batch])
    return "+".join(_dtype_shape(a) for a in arrs)


def _range_of(a, method: str, percentile: float) -> float:
    """absmax (on the tensor's device) or a percentile of ``|a|`` (in
    numpy, as the JAX package computes it)."""
    mag = torch.as_tensor(a).float().abs()
    if method == "percentile":
        return float(np.percentile(mag.cpu().numpy(), percentile))
    return float(mag.max()) if mag.numel() else 0.0


def model_device(model) -> torch.device:
    """The device a model's params live on (``model.device`` where it
    has one, else the first tensor leaf's, else the CPU)."""
    dev = getattr(model, "device", None)
    if dev is not None:
        return torch.device(dev)
    from .transforms import QuantizedTensor, _leaves
    for leaf in _leaves(getattr(model, "params", None) or {}):
        if isinstance(leaf, (torch.Tensor, QuantizedTensor)):
            return leaf.device
    return torch.device("cpu")


def ids_on(batch, device) -> torch.Tensor:
    """A token-id batch as a tensor on ``device`` (numpy, lists and
    tensors alike; no copy when it already lives there)."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch), device=device)


def _generative(model) -> bool:
    return all(callable(getattr(model, m, None))
               for m in ("init_kv_cache", "forward"))


def _tensor(a) -> torch.Tensor:
    """An NDArray (``.torch()``), a tensor, or array-like as a tensor."""
    return a.torch() if hasattr(a, "torch") else torch.as_tensor(a)


def forward_logits(model, batch) -> torch.Tensor:
    """A generative model's full-sequence logits over ``batch`` (token ids
    ``[B, T]``), without autograd."""
    if not _generative(model):
        raise TypeError(
            f"cannot run {type(model).__name__} over a calibration batch: "
            "expected a generative model (the CausalLM protocol)")
    with torch.no_grad():
        return model.forward(ids_on(batch, model_device(model)))


def model_logits(model, batch) -> torch.Tensor:
    """What the divergence gate compares: a generative model's
    full-sequence logits (``[B, T, V]``), else ``model.output(batch)``
    (a layer-API network's ``[B, n_out]``)."""
    if _generative(model):
        return forward_logits(model, batch)
    if callable(getattr(model, "output", None)):
        out = model.output(batch)
        if isinstance(out, (list, tuple)):
            out = out[0]
        return _tensor(out)
    raise TypeError(f"cannot compare {type(model).__name__}: expected a "
                    "model with forward or output")


def calibrate(model, batch, *, mode: str = "int8",
              act_dtype: Optional[str] = None, method: str = "absmax",
              percentile: float = 99.9, **spec_kwargs) -> QuantSpec:
    """Run ``model`` over ``batch`` (eagerly, without autograd) and
    return a :class:`QuantSpec` carrying the observed activation ranges.

    Observation sites by model family: generative models (the CausalLM
    protocol) record the full-sequence forward logits (``logits``);
    layer-API networks every activation ``feed_forward`` gives: a
    ``MultiLayerNetwork``'s as ``layer0..layerN``, a ``ComputationGraph``'s
    by vertex name, inputs included (the JAX package's ``calibrate``
    enumerates the graph's dict and fails there); anything else with an
    ``output`` callable its output."""
    ranges: Dict[str, float] = {}
    if _generative(model):
        ranges["logits"] = _range_of(forward_logits(model, batch), method,
                                     percentile)
    elif callable(getattr(model, "feed_forward", None)):
        acts = model.feed_forward(batch)
        # a ComputationGraph's activations come keyed by vertex name
        sites = acts.items() if isinstance(acts, dict) else \
            ((f"layer{i}", a) for i, a in enumerate(acts))
        for site, a in sites:
            ranges[site] = _range_of(_tensor(a), method, percentile)
    elif callable(getattr(model, "output", None)):
        ranges["output"] = _range_of(model_logits(model, batch), method,
                                     percentile)
    else:
        raise TypeError(
            f"cannot calibrate {type(model).__name__}: expected a model "
            "with forward/feed_forward/output")
    return QuantSpec(mode=mode, act_dtype=act_dtype, method=method,
                     percentile=percentile, act_ranges=ranges,
                     batch_fingerprint=_fingerprint(batch), **spec_kwargs)
