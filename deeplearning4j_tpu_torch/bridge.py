"""Carry weights into the port: nested dicts/lists of numpy arrays (for
example the JAX package's params after ``np.asarray`` on every leaf) ->
the port's params on ``device``, in the same layout.

- bf16 arrays (numpy dtype name ``bfloat16``, the ``ml_dtypes`` type)
  cross through a 16-bit integer view, and fp8 arrays
  (``float8_e4m3fn``) through an 8-bit one, so both stay bit-exact;
- a quantized leaf — any object with ``.q`` / ``.scale`` /
  ``.orig_dtype``, or a dict with exactly those keys — becomes a
  ``quant.transforms.QuantizedTensor`` with ``q`` kept int8 or fp8 (a
  per-output-channel fp8 ``q`` laid out as ``QuantizedTensor`` lays it);
- other leaves (Python scalars, strings) pass through.

Beside the trees, the loaders put a JAX network's, SameDiff graph's,
Seq2Seq model's or word-vector trainer's state into its port
counterpart. Nothing here imports JAX: array-likes are read with
``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .quant.transforms import QuantizedTensor

_QT_KEYS = {"q", "scale", "orig_dtype"}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array -> a tensor on ``device``; bf16 bit-exact."""
    a = np.array(a, copy=True, order="C")  # owned and writable
    # an ml_dtypes bf16 array, or its raw 2-byte values (a ``V2`` record,
    # as the port's serializers and model importers hold bf16)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def _is_quantized(node) -> bool:
    if isinstance(node, dict):
        return set(node) == _QT_KEYS
    return all(hasattr(node, k) for k in _QT_KEYS)


def params_from_numpy(tree, device="cuda"):
    """The port's params for a nested dict/list/tuple of arrays."""
    if _is_quantized(tree):
        get = tree.get if isinstance(tree, dict) else \
            (lambda k: getattr(tree, k))
        q = tensor_from_numpy(get("q"), device)
        scale = tensor_from_numpy(get("scale"), device).to(torch.float32)
        if q.dtype != torch.float8_e4m3fn:
            q = q.to(torch.int8)
        return QuantizedTensor(q, scale, orig_dtype=str(get("orig_dtype")))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [params_from_numpy(v, device) for v in tree]
        return seq if isinstance(tree, list) else tuple(seq)
    if isinstance(tree, (str, int, float, bool)) or tree is None:
        return tree
    return tensor_from_numpy(tree, device)


def load_multilayer(net, params, updater_state=None, iteration: int = 0):
    """Carry a JAX ``MultiLayerNetwork``'s state into ``net``, a port
    network built from the same configuration, and return ``net``
    (:func:`load_graph` does the same for a ``ComputationGraph``).

    ``params`` is the JAX network's ``_params`` as numpy (a list of
    per-layer dicts, convolution weights HWIO as on both sides; every
    layer's keys as the JAX layer names them: ``W`` / ``b``, a separable
    convolution's ``Wd`` / ``Wp``, the VAE's flat ``eW{i}`` / ``dW{i}`` /
    ``Wmu`` / ``Wlv`` / ``Wout``, a capsule layer's ``W``, and the
    non-trainable ``state_*`` entries: running stats, center-loss
    ``state_centers``); ``updater_state`` its
    ``_updater_state`` likewise, else a fresh one from
    ``net.conf.updater``; ``iteration`` its ``_iteration``, so that a
    ``fit`` continued on both sides takes the same Adam bias correction.
    Nothing is re-initialized: the bridged weights are the network's."""
    net.init(params=params_from_numpy(params, net.device))
    if updater_state is not None:
        net._updater_state = params_from_numpy(updater_state, net.device)
    net._iteration = int(iteration)
    return net


def load_graph(net, params, updater_state=None, iteration: int = 0):
    """Carry a JAX ``ComputationGraph``'s state into ``net``, a port graph
    built from the same configuration, and return ``net``.

    ``params`` is the JAX graph's ``_params`` as numpy (a vertex-name ->
    dict keyed as for :func:`load_multilayer`); ``updater_state`` and
    ``iteration`` as for :func:`load_multilayer`."""
    return load_multilayer(net, params, updater_state, iteration)


def load_samediff(sd, arrays, updater_state=None, iteration: int = 0):
    """Carry a JAX ``SameDiff`` graph's state into ``sd``, a port graph
    recorded the same way, and return ``sd``.

    ``arrays`` is the JAX graph's ``_arrays`` as numpy (variable name ->
    array; bf16 bit-exact through its 16-bit view); ``updater_state`` its
    ``_updater_state`` likewise (the updater's layout, ``{"u": {name:
    array}, "m": ...}`` for Adam); ``iteration`` is kept on the graph as
    ``_iteration`` (each ``fit`` call counts its own steps from 0 on both
    sides)."""
    for name, a in arrays.items():
        sd._arrays[name] = tensor_from_numpy(a, sd.device)
    if updater_state is not None:
        sd._updater_state = params_from_numpy(updater_state, sd.device)
    sd._iteration = int(iteration)
    return sd


_SEQ2SEQ_KEYS = {"embed", "enc", "dec", "out"}


def seq2seq_params_from_numpy(tree, device="cuda"):
    """A JAX Seq2Seq params tree (``{"embed", "enc", "dec", "out"}``, the
    LSTM blocks ``Wx`` / ``Wh`` / ``b``) or its Adam state (``(u_list,
    m_list)``, each in the params' sorted-leaf order, which both packages
    walk alike) as numpy -> the port's on ``device``. Any other tree
    raises ``ValueError``."""
    is_params = isinstance(tree, dict) and set(tree) == _SEQ2SEQ_KEYS
    is_state = (isinstance(tree, (tuple, list)) and len(tree) == 2
                and all(isinstance(t, (tuple, list)) for t in tree)
                and len(tree[0]) == len(tree[1]))
    if not (is_params or is_state):
        raise ValueError("not a Seq2Seq params tree or its (u, m) Adam "
                         "state")
    out = params_from_numpy(tree, device)
    return out if is_params else (list(out[0]), list(out[1]))


def load_sequence_vectors(sv, w_in, w_out):
    """Carry a JAX ``SequenceVectors``' tables (its ``_w_in`` / ``_w_out``
    as numpy, or a ``Word2Vec``'s ``_sv``'s) into ``sv``, a port
    ``SequenceVectors`` or ``Word2Vec`` over the same vocabulary, on its
    device; returns ``sv``."""
    target = getattr(sv, "_sv", None) or sv
    shape = tuple(target._w_in.shape)
    if np.shape(w_in) != shape or np.shape(w_out) != shape:
        raise ValueError(f"tables of shape {np.shape(w_in)} / "
                         f"{np.shape(w_out)} for a model of {shape}")
    target._w_in = tensor_from_numpy(w_in, target.device)
    target._w_out = tensor_from_numpy(w_out, target.device)
    return sv
