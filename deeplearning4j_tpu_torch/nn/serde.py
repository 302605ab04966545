"""Model serialization.

Counterpart of ``deeplearning4j_tpu/nn/serde.py`` (the reference's
``ModelSerializer.java``), byte-compatible with its zip so that either
package loads what the other saved:

- ``configuration.json``: the configuration's JSON (equal on both sides);
- ``coefficients.npz``: the params, ``layer<i>__<key>`` for a
  ``MultiLayerNetwork``; ``p<i>`` for a ``ComputationGraph``, with
  ``paramManifest.json`` mapping each index to its (vertex, key);
- ``meta.json``: iteration and epoch (and ``model_type`` for a graph);
- ``updaterState.npz`` (optional): the updater state's leaves
  ``leaf<i>`` in ``jax.tree_util`` order (sorted dict keys, lists in
  order).

bf16 arrays are written as the JAX package's ``np.savez`` writes an
``ml_dtypes`` bf16 array, a ``V2`` record of the raw 2-byte values, and
read back bit-exact. The zip is ``ZIP_DEFLATED``, as the JAX package
writes it. A ``MultiLayerNetwork`` key that itself holds ``__`` (a
``FrozenLayer``'s ``state_frozen__W``) is read back whole: the layer part
ends at the first ``__``.
"""
from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from ..autodiff.serialization import _from_host, host_array
from ..common.tracing import span
from ..ops._util import tree_leaves


def _leaves(tree) -> list:
    """``tree``'s leaves in ``jax.tree_util`` order (None is no leaf)."""
    return [v for v in tree_leaves(tree) if v is not None]


def _fill(template, it):
    """``template`` with its leaves replaced from ``it``, walked in
    :func:`_leaves`' order."""
    if isinstance(template, dict):
        filled = {k: _fill(template[k], it) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        seq = [_fill(v, it) for v in template]
        return seq if isinstance(template, list) else tuple(seq)
    return None if template is None else next(it)


def _npz_bytes(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _write_updater(z, net):
    leaves = _leaves(net._updater_state)
    z.writestr("updaterState.npz", _npz_bytes(
        {f"leaf{i}": host_array(v) for i, v in enumerate(leaves)}))


def _read_updater(z, net):
    """Replace ``net``'s fresh updater state with the saved leaves."""
    with z.open("updaterState.npz") as f:
        npz = np.load(io.BytesIO(f.read()))
        saved = [npz[f"leaf{i}"] for i in range(len(npz.files))]
    want = len(_leaves(net._updater_state))
    if len(saved) != want:
        raise ValueError(f"updaterState.npz holds {len(saved)} leaves; the "
                         f"network's updater has {want}")
    net._updater_state = _fill(net._updater_state,
                               iter(_from_host(a, net.device)
                                    for a in saved))


def save_multilayer(net, path, save_updater: bool = False):
    with span("serde/save", model="MultiLayerNetwork"), \
            zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", net.conf.to_json())
        z.writestr("coefficients.npz", _npz_bytes(
            {f"layer{i}__{k}": host_array(v)
             for i, p in enumerate(net._params) for k, v in p.items()}))
        z.writestr("meta.json", json.dumps(
            {"iteration": net._iteration, "epoch": net._epoch}))
        if save_updater and net._updater_state is not None:
            _write_updater(z, net)


def restore_multilayer(path, load_updater: bool = False, device="cuda"):
    from .conf.config import MultiLayerConfiguration
    from .multilayer import MultiLayerNetwork
    with span("serde/load", model="MultiLayerNetwork"), \
            zipfile.ZipFile(path) as z:
        conf = MultiLayerConfiguration.from_json(
            z.read("configuration.json").decode())
        net = MultiLayerNetwork(conf, device=device)
        params = [dict() for _ in conf.layers]
        with z.open("coefficients.npz") as f:
            npz = np.load(io.BytesIO(f.read()))
            for name in npz.files:
                layer, key = name.split("__", 1)
                params[int(layer[5:])][key] = _from_host(npz[name],
                                                         net.device)
        meta = json.loads(z.read("meta.json"))
        net.init(params=params)
        if load_updater and "updaterState.npz" in z.namelist() \
                and net._updater_state is not None:
            _read_updater(z, net)
    net._iteration = meta.get("iteration", 0)
    net._epoch = meta.get("epoch", 0)
    return net


# ModelSerializer-compatible entry points
write_model = save_multilayer
restore_multi_layer_network = restore_multilayer


def save_computation_graph(net, path, save_updater: bool = False):
    """ComputationGraph zip (reference ModelSerializer.writeModel for a
    ComputationGraph): vertex-keyed params through a manifest, so a
    vertex name may hold any character."""
    with span("serde/save", model="ComputationGraph"), \
            zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", net.conf.to_json())
        flat, manifest = {}, []
        for name, p in net._params.items():
            for k, v in p.items():
                flat[f"p{len(manifest)}"] = host_array(v)
                manifest.append([name, k])
        z.writestr("coefficients.npz", _npz_bytes(flat))
        z.writestr("paramManifest.json", json.dumps(manifest))
        z.writestr("meta.json", json.dumps(
            {"iteration": net._iteration, "epoch": net._epoch,
             "model_type": "ComputationGraph"}))
        if save_updater and net._updater_state is not None:
            _write_updater(z, net)


def restore_computation_graph(path, load_updater: bool = False,
                              device="cuda"):
    from .graph.computation_graph import (ComputationGraph,
                                          ComputationGraphConfiguration)
    with span("serde/load", model="ComputationGraph"), \
            zipfile.ZipFile(path) as z:
        conf = ComputationGraphConfiguration.from_json(
            z.read("configuration.json").decode())
        net = ComputationGraph(conf, device=device)
        manifest = json.loads(z.read("paramManifest.json"))
        params = {}
        with z.open("coefficients.npz") as f:
            npz = np.load(io.BytesIO(f.read()))
            for i, (name, key) in enumerate(manifest):
                params.setdefault(name, {})[key] = _from_host(
                    npz[f"p{i}"], net.device)
        meta = json.loads(z.read("meta.json"))
        net.init(params={n: params.get(n, {}) for n in net._order})
        if load_updater and "updaterState.npz" in z.namelist() \
                and net._updater_state is not None:
            _read_updater(z, net)
    net._iteration = meta.get("iteration", 0)
    net._epoch = meta.get("epoch", 0)
    return net


def restore_model(path, load_updater: bool = False, device="cuda"):
    """Type-dispatching loader (reference ModelSerializer.restore*):
    ``meta.json``'s ``model_type`` picks the network class."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    if meta.get("model_type") == "ComputationGraph":
        return restore_computation_graph(path, load_updater, device)
    return restore_multilayer(path, load_updater, device)
