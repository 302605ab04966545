"""Graph vertices for the ComputationGraph.

Counterpart of ``deeplearning4j_tpu/nn/graph/vertices.py`` (the
reference's ``nn/conf/graph/``: MergeVertex, ElementWiseVertex,
StackVertex, UnstackVertex, SubsetVertex, L2NormalizeVertex, L2Vertex,
ScaleVertex, ShiftVertex, ReshapeVertex, PreprocessorVertex,
AttentionVertex). A vertex is a function of its input tensors; the
backward pass is autograd over the whole graph. Fields and names are the
JAX package's, so a configuration's JSON is the same on both sides.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..weights import init_weights


@dataclasses.dataclass
class GraphVertex:
    """Base vertex (reference conf/graph/GraphVertex.java)."""

    def init_params(self, generator, input_types):
        return {}

    def forward(self, params, inputs, training=False, key=None):
        raise NotImplementedError

    def output_type(self, input_types):
        return input_types[0]

    def has_params(self) -> bool:
        return False

    def needs_key(self) -> bool:
        return False


@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (reference MergeVertex.java)."""
    axis: int = 1

    def forward(self, params, inputs, training=False, key=None):
        return torch.cat(list(inputs), dim=self.axis)

    def output_type(self, input_types):
        t = list(input_types[0])
        ax = self.axis - 1  # input types exclude the batch dim
        t[ax] = sum(it[ax] for it in input_types)
        return tuple(t)


def _fold(fn, inputs):
    out = inputs[0]
    for x in inputs[1:]:
        out = fn(out, x)
    return out


@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine (reference ElementWiseVertex.java).
    op: add | subtract | product | average | max | min."""
    op: str = "add"

    def forward(self, params, inputs, training=False, key=None):
        if self.op == "add":
            return _fold(torch.add, inputs)
        if self.op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract requires exactly 2 inputs")
            return inputs[0] - inputs[1]
        if self.op == "product":
            return _fold(torch.mul, inputs)
        if self.op == "average":
            return _fold(torch.add, inputs) / len(inputs)
        if self.op == "max":
            return _fold(torch.maximum, inputs)
        if self.op == "min":
            return _fold(torch.minimum, inputs)
        raise ValueError(f"unknown op {self.op}")


@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Stack minibatches along dim 0 (reference StackVertex.java)."""

    def forward(self, params, inputs, training=False, key=None):
        return torch.cat(list(inputs), dim=0)


@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """The ``from_index``-th of ``stack_size`` equal slices along dim 0
    (reference UnstackVertex.java)."""
    from_index: int = 0
    stack_size: int = 1

    def forward(self, params, inputs, training=False, key=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from_idx, to_idx] inclusive (reference
    SubsetVertex.java)."""
    from_idx: int = 0
    to_idx: int = 0

    def forward(self, params, inputs, training=False, key=None):
        return inputs[0][:, self.from_idx:self.to_idx + 1]

    def output_type(self, input_types):
        t = list(input_types[0])
        t[0] = self.to_idx - self.from_idx + 1
        return tuple(t)


@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """Unit-L2-normalize each example (reference L2NormalizeVertex.java)."""
    eps: float = 1e-8

    def forward(self, params, inputs, training=False, key=None):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        n = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        return x / torch.clamp_min(n, self.eps)


@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance of two inputs (reference L2Vertex.java)."""
    eps: float = 1e-8

    def forward(self, params, inputs, training=False, key=None):
        a, b = inputs
        d = a - b
        axes = tuple(range(1, a.dim()))
        return torch.sqrt(torch.sum(d * d, dim=axes) + self.eps)[:, None]

    def output_type(self, input_types):
        return (1,)


@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar (reference ScaleVertex.java)."""
    scale: float = 1.0

    def forward(self, params, inputs, training=False, key=None):
        return inputs[0] * self.scale


@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """Add a fixed scalar (reference ShiftVertex.java)."""
    shift: float = 0.0

    def forward(self, params, inputs, training=False, key=None):
        return inputs[0] + self.shift


@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """Reshape, keeping the batch dim (reference ReshapeVertex.java)."""
    shape: Tuple[int, ...] = ()

    def forward(self, params, inputs, training=False, key=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_type(self, input_types):
        return tuple(self.shape)


@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """An InputPreProcessor as a vertex (reference
    PreprocessorVertex.java)."""
    preprocessor: object = None

    def forward(self, params, inputs, training=False, key=None):
        return self.preprocessor(inputs[0])

    def output_type(self, input_types):
        return self.preprocessor.out_type(input_types[0])


def _masked_softmax(scores, mask):
    """softmax over the last axis, masked keys filled with -1e9 as the
    JAX package fills them (a fully masked row comes out uniform)."""
    if mask is not None:
        scores = torch.where(mask.bool(), scores,
                             torch.full((), -1e9, dtype=scores.dtype,
                                        device=scores.device))
    return torch.softmax(scores, dim=-1)


@dataclasses.dataclass
class AttentionVertex(GraphVertex):
    """Multi-head dot-product attention over RNN-format inputs (reference
    conf/graph/AttentionVertex.java), as the JAX package's einsum chain.

    Inputs: (queries, keys, values[, mask]), each [B, features, T]. With
    ``project_input``, learned per-head projections ``Wq``/``Wk``/``Wv``
    and the output projection ``Wo``. Plain tensor ops on purpose: flash
    attention and SDPA treat a fully masked row another way than this
    vertex's ``-1e9`` fill.
    """
    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    project_input: bool = True
    weight_init: str = "xavier"

    def __post_init__(self):
        if self.head_size == 0 and self.n_heads:
            self.head_size = max(1, self.n_out // self.n_heads)

    def has_params(self):
        return self.project_input

    def init_params(self, generator, input_types):
        if not self.project_input:
            return {}
        nq = self.n_heads * self.head_size
        return {
            "Wq": init_weights(generator, (self.n_in, nq), self.weight_init),
            "Wk": init_weights(generator, (self.n_in, nq), self.weight_init),
            "Wv": init_weights(generator, (self.n_in, nq), self.weight_init),
            "Wo": init_weights(generator, (nq, self.n_out), self.weight_init),
        }

    def forward(self, params, inputs, training=False, key=None):
        q, k, v = (x.transpose(1, 2) for x in inputs[:3])  # [B, T, F]
        mask = inputs[3] if len(inputs) > 3 else None
        if self.project_input:
            B, Tq, _ = q.shape
            H, D = self.n_heads, self.head_size
            qh = torch.einsum("btf,fe->bte", q, params["Wq"]).reshape(
                B, Tq, H, D)
            kh = torch.einsum("btf,fe->bte", k, params["Wk"]).reshape(
                B, -1, H, D)
            vh = torch.einsum("btf,fe->bte", v, params["Wv"]).reshape(
                B, -1, H, D)
            scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(D)
            attn = _masked_softmax(
                scores, mask[:, None, None, :] if mask is not None else None)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(
                B, Tq, H * D)
            out = torch.einsum("bte,eo->bto", out, params["Wo"])
        else:
            D = q.shape[-1]
            scores = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(D)
            attn = _masked_softmax(
                scores, mask[:, None, :] if mask is not None else None)
            out = torch.einsum("bqk,bkd->bqd", attn, v)
        return out.transpose(1, 2)  # back to [B, F, T]

    def output_type(self, input_types):
        f, t = input_types[0]
        return (self.n_out if self.project_input else f, t)


VERTEX_CLASSES = {c.__name__: c for c in [
    MergeVertex, ElementWiseVertex, StackVertex, UnstackVertex, SubsetVertex,
    L2NormalizeVertex, L2Vertex, ScaleVertex, ShiftVertex, ReshapeVertex,
    PreprocessorVertex, AttentionVertex]}
