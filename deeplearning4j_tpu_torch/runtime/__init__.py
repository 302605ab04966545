"""Runtime services: memory-workspace shims (``workspace.py``), the
shape-bucketed inference engine (``inference.py``), the paged-KV
generative decode engine with continuous batching (``generation.py``),
CUDA-graph capture of their steps (``cuda_graphs.py``), sharded serving
(``sharded.py``), the persistent artifact store that makes process
restarts start warm (``compile_cache.py``) and the warm-image bake
(``warm_image.py``). The engines are imported from their modules:
``generation`` imports the model and kernel modules, which themselves
reach into this package."""
from . import compile_cache
from .workspace import (DummyWorkspace, LayerWorkspaceMgr, MemoryWorkspace,
                        Nd4jWorkspaceManager, WorkspaceConfiguration,
                        workspace_manager)

__all__ = ["DummyWorkspace", "LayerWorkspaceMgr", "MemoryWorkspace",
           "Nd4jWorkspaceManager", "WorkspaceConfiguration",
           "workspace_manager", "compile_cache"]
