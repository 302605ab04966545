"""The training vocabulary of the device mesh, re-exported from
:mod:`..common.mesh` (where the serving side reads it too), as the JAX
package's ``parallel/mesh.py`` does. ``axis_size`` is the collectives'
(the JAX module's ``shard_map`` shim has no counterpart: a rank's body is
plain code over its shards)."""
from __future__ import annotations

from ..common.mesh import (  # noqa: F401
    DATA,
    FSDP,
    MODEL,
    PIPE,
    SEQ,
    TENSOR,
    Mesh,
    MeshConfig,
    P,
    batch_spec,
    data_parallel_mesh,
    dp_size,
    local_mesh_info,
    make_mesh,
    num_devices,
    replicate,
    replicated_spec,
    shard_batch,
    zero1_place,
    zero1_spec,
)
from .collectives import axis_size  # noqa: F401

__all__ = [
    "DATA", "FSDP", "MODEL", "PIPE", "SEQ", "TENSOR", "Mesh",
    "MeshConfig", "P", "axis_size", "batch_spec", "data_parallel_mesh",
    "dp_size", "local_mesh_info", "make_mesh", "num_devices",
    "replicate", "replicated_spec", "shard_batch", "zero1_place",
    "zero1_spec",
]
