"""The max-divergence gate between warmup and cutover.

A copy of the JAX package's ``quant/validate.py`` (the port imports
nothing from that package). A quantized twin that builds and warms is not
yet safe to serve: a mis-scaled spec gives confidently wrong logits at
full speed. So ``ModelRegistry.deploy(quantize=...)`` runs this gate
AFTER the incoming engine warms and BEFORE the pointer swap: the
full-precision and quantized models both run the gate batch, and the twin
must stay within the budget:

- ``max_abs_err``  — worst logit absolute error <= ``max_divergence``
  (``DL4J_TPU_QUANT_MAX_DIVERGENCE``);
- ``top1_agreement`` — argmax agreement >= ``min_top1``
  (``DL4J_TPU_QUANT_MIN_TOP1``); for generative models this is the
  next-token agreement at the last position, and ``per_token_agreement``
  (argmax at every position) is gated too.

Failure raises :class:`QuantizationRejectedError`; deploy aborts, the
incoming engine closes, and the full-precision version never stops
serving. The measured divergence is exported either way on the
``dl4j_quant_divergence{model,version}`` gauge.

The comparison runs on the models' device in f32, and both logit tensors
are dropped before the report returns (at full width they are
``[B, T, 32000]`` f32 each).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from ..common.environment import environment
from ..common.metrics import registry as metrics_registry
from .calibrate import model_logits

log = logging.getLogger(__name__)


class QuantizationRejectedError(RuntimeError):
    """The quantized twin diverged past the gate budget; the swap was
    aborted with the full-precision version still live."""


_GAUGE = None


def _divergence_gauge():
    global _GAUGE
    if _GAUGE is None:
        _GAUGE = metrics_registry().gauge(
            "dl4j_quant_divergence",
            "Max logit abs error of the last gated quantized deploy",
            labels=("model", "version"))
    return _GAUGE


def divergence_report(full_model, quant_model, batch) -> Dict[str, float]:
    """Compare the two models on ``batch`` (generative models by their
    full-sequence logits, predict models by ``output``). Keys:
    ``max_abs_err``, ``mean_abs_err``, ``top1_agreement``, ``generative``,
    and (generative only) ``per_token_agreement``."""
    a = model_logits(full_model, batch).float()
    b = model_logits(quant_model, batch).float().to(a.device)
    if a.shape != b.shape:
        raise ValueError(
            f"model outputs disagree in shape: full {tuple(a.shape)} vs "
            f"quantized {tuple(b.shape)} — not the same model family")
    generative = a.dim() >= 3
    err = (a - b).abs()
    rep = {
        "max_abs_err": float(err.max()) if err.numel() else 0.0,
        "mean_abs_err": float(err.mean()) if err.numel() else 0.0,
        "generative": generative,
    }
    del err
    am, bm = torch.argmax(a, dim=-1), torch.argmax(b, dim=-1)
    del a, b
    if generative:
        rep["per_token_agreement"] = _share(am == bm)
        rep["top1_agreement"] = _share(am[..., -1] == bm[..., -1])
    else:
        rep["top1_agreement"] = _share(am == bm)
    return rep


def _share(hits: torch.Tensor) -> float:
    """The share of True entries, in float64 as numpy's mean gives it."""
    return int(hits.sum()) / hits.numel() if hits.numel() else float("nan")


def validate(full_model, quant_model, batch, *,
             max_divergence: Optional[float] = None,
             min_top1: Optional[float] = None,
             model_name: str = "", version: str = "") -> Dict[str, float]:
    """Run the gate; returns the divergence report on success, raises
    :class:`QuantizationRejectedError` past budget. Env defaults:
    ``DL4J_TPU_QUANT_MAX_DIVERGENCE`` / ``DL4J_TPU_QUANT_MIN_TOP1``."""
    env = environment()
    if max_divergence is None:
        max_divergence = env.quant_max_divergence()
    if min_top1 is None:
        min_top1 = env.quant_min_top1()
    rep = divergence_report(full_model, quant_model, batch)
    _divergence_gauge().labels(
        model=model_name or "unnamed",
        version=version or "unversioned").set(rep["max_abs_err"])
    failures = []
    if rep["max_abs_err"] > max_divergence:
        failures.append(
            f"max logit abs error {rep['max_abs_err']:.4g} > budget "
            f"{max_divergence:.4g}")
    if rep["top1_agreement"] < min_top1:
        failures.append(
            f"top-1 agreement {rep['top1_agreement']:.4f} < required "
            f"{min_top1:.4f}")
    if rep.get("per_token_agreement", 1.0) < min_top1:
        failures.append(
            f"per-token agreement {rep['per_token_agreement']:.4f} < "
            f"required {min_top1:.4f}")
    if failures:
        raise QuantizationRejectedError(
            "quantized model rejected by the divergence gate ("
            + "; ".join(failures) + ") — full-precision version stays live")
    log.info("quantization gate passed for %s:%s (max_abs_err=%.4g, "
             "top1=%.4f)", model_name, version, rep["max_abs_err"],
             rep["top1_agreement"])
    return rep
