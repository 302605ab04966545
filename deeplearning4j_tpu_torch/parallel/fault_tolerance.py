"""Fault-tolerant training: checkpoints, auto-resume and elastic re-mesh.

Counterpart of ``deeplearning4j_tpu/parallel/fault_tolerance.py`` (the
reference's ``MeshOrganizer.remapNode`` role): periodic checkpoints
(``nn/checkpoint.ShardedCheckpointer``, which restores across mesh
shapes) and a supervised retry loop that rebuilds the mesh from the
live ranks (:func:`rebuild_mesh`), re-distributes the network and
resumes from the last checkpoint. The retries ride the shared
``common.faults.RetryPolicy`` (exponential backoff with jitter, a
restart budget that resets after a healthy stretch).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..common.faults import RetryPolicy
from ..common.mesh import MeshConfig, make_mesh, world_size
from ..nn.checkpoint import ShardedCheckpointer


def rebuild_mesh(config: MeshConfig = None,
                 devices: Optional[Sequence[int]] = None, device="cuda"):
    """A mesh over the live ranks ``devices`` (all of the default
    group's by default): the fixed axes (fsdp * tensor * seq * pipe) kept
    where they still divide the rank count, data parallelism absorbing
    the rest; else pure data parallelism (every spec falls back to
    replicated, so training goes on)."""
    config = config or MeshConfig()
    devices = list(devices) if devices is not None \
        else list(range(world_size()))
    fixed = config.fsdp * config.tensor * config.seq * config.pipe
    if len(devices) % fixed == 0:
        return make_mesh(MeshConfig(data=-1, fsdp=config.fsdp,
                                    tensor=config.tensor, seq=config.seq,
                                    pipe=config.pipe), devices, device)
    return make_mesh(MeshConfig(), devices, device)


class FaultTolerantTrainer:
    """Supervised ``fit`` with periodic checkpoints and auto-resume:
    ``fit_fn(net, epoch)`` trains one epoch and raises on failure; the
    trainer then re-meshes over the live ranks (``mesh_config``, with
    ``live_ranks()`` when given), restores the latest checkpoint and
    retries, until the policy's budget is spent."""

    def __init__(self, net, checkpoint_dir: str,
                 mesh_config: Optional[MeshConfig] = None,
                 checkpoint_every_epochs: int = 1, keep_last: int = 2,
                 max_restarts: int = 3,
                 on_restart: Optional[Callable] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 live_ranks: Optional[Callable] = None):
        self.net = net
        self.ckpt = ShardedCheckpointer(checkpoint_dir, keep_last=keep_last)
        self.mesh_config = mesh_config
        self.every = checkpoint_every_epochs
        self.on_restart = on_restart
        self.live_ranks = live_ranks
        self.policy = (retry_policy if retry_policy is not None
                       else RetryPolicy(max_restarts, base_s=0.05,
                                        max_s=30.0, seed=0,
                                        healthy_reset_s=600.0))
        self.max_restarts = self.policy.max_restarts

    @property
    def restarts(self) -> int:
        return self.policy.restarts

    def fit(self, fit_fn: Callable, num_epochs: int):
        epoch = 0
        if self.ckpt.latest_step() is not None:
            self._restore()
            epoch = self.net._epoch
        while epoch < num_epochs:
            try:
                fit_fn(self.net, epoch)
                epoch += 1
                self.net._epoch = epoch
                if epoch % self.every == 0 or epoch == num_epochs:
                    self.ckpt.save(self.net._iteration, self.net)
            except Exception as e:  # noqa: BLE001 — supervised retry scope
                n = self.policy.note_failure()
                if self.policy.exhausted():
                    raise
                if self.on_restart is not None:
                    self.on_restart(e, n)
                self.policy.sleep()
                self._restore()
                epoch = self.net._epoch
        return self.net

    def _restore(self):
        if self.mesh_config is not None:
            live = self.live_ranks() if self.live_ranks is not None else None
            self.net.distribute(rebuild_mesh(self.mesh_config, live,
                                             self.net.device))
        if self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.net)
