"""Step checkpoints of a network's full training state, with retention.

Counterpart of ``deeplearning4j_tpu/nn/checkpoint.py``
(``ShardedCheckpointer`` and ``ShardedCheckpointListener``, the
reference's ``CheckpointListener`` retention policies), single-process.
The JAX package writes orbax OCDBT directories; the port has no orbax and
writes its own: one directory a step under ``directory``, named by the
step, holding ``tree.json`` (the tree's structure and its scalars) and
``leaves.npz`` (its arrays, bf16 as ``V2`` records as ``nn/serde.py``
writes them). A step is written under a temporary name and renamed into
place, so a crash mid-save leaves no partial step. ``keep_last`` keeps
the newest steps and deletes the rest after each save.

Reading an orbax directory is out of scope. **Across meshes:** a leaf
that is a mesh shard (``common.mesh.place``) is gathered to its global
array before it is written, so a step holds global arrays whatever mesh
wrote it; every rank of that mesh calls ``save_tree`` (the gathers are
collectives), the lowest rank writes, and the others wait for it. A
restore reads the global arrays on every calling rank and places each
leaf as the matching leaf of ``target`` is placed: its shard of the
target's mesh and spec, or the target leaf's device. So a step saved
under any mesh restores under any other, or under none.
"""
from __future__ import annotations

import io
import json
import os
import shutil
from typing import Any, List, Optional

import numpy as np
import torch

from ..autodiff.serialization import _from_host, host_array
from ..common.mesh import gather, place, placement


def _encode(tree, leaves: list):
    if isinstance(tree, dict):
        return {"dict": {k: _encode(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, leaves) for v in tree]}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        leaves.append(host_array(gather(tree)))
        return {"leaf": len(leaves) - 1}
    return {"value": tree}


def _decode(node, arrays, target, device):
    """The tree of :func:`_encode`'s ``node``; each array on the device of
    ``target``'s matching leaf, or on ``device`` where it has none."""
    if "dict" in node:
        return {k: _decode(v, arrays, target.get(k)
                           if isinstance(target, dict) else None, device)
                for k, v in node["dict"].items()}
    for kind in ("list", "tuple"):
        if kind in node:
            seq = [_decode(v, arrays, target[i]
                           if isinstance(target, (list, tuple))
                           and i < len(target) else None, device)
                   for i, v in enumerate(node[kind])]
            return seq if kind == "list" else tuple(seq)
    if "leaf" in node:
        dev = target.device if isinstance(target, torch.Tensor) else device
        pl = placement(target) if isinstance(target, torch.Tensor) else None
        full = _from_host(arrays[f"leaf{node['leaf']}"],
                          "cpu" if pl is not None else dev)
        return full if pl is None else place(full, pl[0], pl[1])
    return node["value"]


def _mesh_of(tree):
    """The mesh of the first placed leaf of ``tree``, or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = _mesh_of(v)
            if m is not None:
                return m
        return None
    pl = placement(tree) if isinstance(tree, torch.Tensor) else None
    return None if pl is None else pl[0]


def _barrier(mesh):
    g = mesh.group(mesh.axis_names)
    if g is not None:
        import torch.distributed as dist
        dist.barrier(group=g)


def _net_state(net) -> dict:
    state = {"params": net._params, "iteration": net._iteration,
             "epoch": net._epoch}
    if net._updater_state is not None:
        state["updater"] = net._updater_state
    return state


class ShardedCheckpointer:
    """Save / restore a network's full training state (params, updater
    state, iteration and epoch), one directory a step."""

    def __init__(self, directory: str, keep_last: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.keep_last = keep_last
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # -- generic tree API -------------------------------------------------
    def save_tree(self, step: int, tree: Any):
        """Write ``tree`` as step ``step`` (mesh shards gathered first;
        on a mesh every rank calls, the lowest writes)."""
        leaves: list = []
        structure = _encode(tree, leaves)
        mesh = _mesh_of(tree)
        if mesh is not None and mesh.rank != int(mesh.devices.min()):
            _barrier(mesh)
            return
        try:
            self._write(step, structure, leaves)
        finally:
            if mesh is not None:
                _barrier(mesh)

    def _write(self, step, structure, leaves):
        final = self._step_dir(step)
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            buf = io.BytesIO()
            np.savez(buf, **{f"leaf{i}": a for i, a in enumerate(leaves)})
            with open(os.path.join(tmp, "leaves.npz"), "wb") as f:
                f.write(buf.getvalue())
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump(structure, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.keep_last is not None:
            for old in self.all_steps()[:-int(self.keep_last)]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore_tree(self, step: Optional[int] = None, target: Any = None,
                     device="cpu") -> Any:
        """The tree saved at ``step`` (the latest by default); each array
        placed as ``target``'s matching leaf (a shard of its mesh, or on
        its device), else on ``device``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        meta = os.path.join(d, "tree.json")
        if not os.path.exists(meta):
            raise ValueError(f"{d} is not a checkpoint this package wrote "
                             "(no tree.json; orbax directories are not "
                             "read)")
        with open(meta) as f:
            structure = json.load(f)
        with np.load(os.path.join(d, "leaves.npz")) as arrays:
            return _decode(structure, arrays, target, device)

    # -- network API ------------------------------------------------------
    def save(self, step: int, net):
        """Checkpoint params, updater state, iteration and epoch."""
        self.save_tree(step, _net_state(net))

    def restore(self, net, step: Optional[int] = None):
        """Restore in place onto the network's device."""
        state = self.restore_tree(step, target=_net_state(net),
                                  device=net.device)
        net._params = state["params"]
        if "updater" in state:
            net._updater_state = state["updater"]
        net._iteration = int(state["iteration"])
        net._epoch = int(state["epoch"])
        return net

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(
                          os.path.join(self.directory, n)))

    def close(self):
        """Nothing stays open between calls (the orbax manager's close)."""


class ShardedCheckpointListener:
    """CheckpointListener variant writing :class:`ShardedCheckpointer`
    steps (reference ``CheckpointListener.java`` policies)."""

    def __init__(self, directory: str, save_every_n_iterations: int = None,
                 save_every_n_epochs: int = None, keep_last: int = 3):
        self.ckpt = ShardedCheckpointer(directory, keep_last=keep_last)
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs

    def iteration_done(self, model, iteration, loss=None):
        if self.every_iter and iteration > 0 and \
                iteration % self.every_iter == 0:
            self.ckpt.save(iteration, model)

    def on_epoch_end(self, epoch, model):
        if self.every_epoch and epoch % self.every_epoch == 0:
            self.ckpt.save(model._iteration, model)
