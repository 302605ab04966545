"""Distributed training on ``torch.distributed``: the mesh, collectives,
sequence and pipeline parallelism, the trainers (counterpart of
``deeplearning4j_tpu/parallel``)."""
from .mesh import (DATA, FSDP, PIPE, SEQ, TENSOR, MeshConfig,  # noqa: F401
                   make_mesh, replicate, shard_batch)
