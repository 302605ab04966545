"""MemoryWorkspace API shims (reference workspace compatibility surface).

Counterpart of ``deeplearning4j_tpu/runtime/workspace.py`` (the port
imports nothing from that package). Reference:
`org/nd4j/linalg/api/memory/MemoryWorkspace.java:28` (scoped arena
allocator, AutoCloseable), `WorkspaceConfiguration` policies, and the
DL4J `LayerWorkspaceMgr` routing. SURVEY §7: "Workspaces — not needed;
keep API as no-op shims for compatibility."

On the card, PyTorch's caching allocator owns device memory: freed
blocks go back to its pool and the next allocation of that size reuses
them, and a captured CUDA graph keeps its own memory pool
(``runtime/cuda_graphs.py``). There is nothing for a user-level arena to
manage. These shims preserve the reference's scoping API (code written
against `try (MemoryWorkspace ws = ...)` patterns ports cleanly) while
recording usage statistics for observability parity.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

_thread_local = threading.local()


@dataclasses.dataclass
class WorkspaceConfiguration:
    """Reference WorkspaceConfiguration builder fields (accepted, advisory)."""
    initial_size: int = 0
    max_size: int = 0
    overallocation_limit: float = 0.0
    policy_allocation: str = "OVERALLOCATE"   # reference AllocationPolicy
    policy_spill: str = "REALLOCATE"
    policy_learning: str = "FIRST_LOOP"
    policy_mirroring: str = "FULL"

    @staticmethod
    def builder() -> "_WSConfigBuilder":
        return _WSConfigBuilder()


class _WSConfigBuilder:
    def __init__(self):
        self._kw = {}

    def initial_size(self, v):
        self._kw["initial_size"] = v
        return self

    def max_size(self, v):
        self._kw["max_size"] = v
        return self

    def policy_allocation(self, v):
        self._kw["policy_allocation"] = v
        return self

    def policy_learning(self, v):
        self._kw["policy_learning"] = v
        return self

    def build(self) -> WorkspaceConfiguration:
        return WorkspaceConfiguration(**self._kw)


class MemoryWorkspace:
    """Scoped workspace shim: context manager like the reference's
    AutoCloseable. Allocation is a no-op (the caching allocator);
    enter/exit and generation counters behave like the reference for
    code parity."""

    def __init__(self, config: WorkspaceConfiguration = None,
                 workspace_id: str = "WS"):
        self.config = config or WorkspaceConfiguration()
        self.id = workspace_id
        self.generation = 0
        self._open = False

    # reference: notifyScopeEntered / notifyScopeLeft
    def __enter__(self) -> "MemoryWorkspace":
        self._open = True
        stack = _ws_stack()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._open = False
        self.generation += 1
        stack = _ws_stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def notify_scope_entered(self):
        return self.__enter__()

    def notify_scope_left(self):
        self.__exit__()

    def is_scope_active(self) -> bool:
        return self._open

    # reference tagOutOfScopeUse / current offset introspection — constants
    # here because the caching allocator owns the memory
    def get_current_size(self) -> int:
        return 0

    def get_current_offset(self) -> int:
        return 0


class DummyWorkspace(MemoryWorkspace):
    """Reference DummyWorkspace: the no-workspace workspace."""


def _ws_stack():
    if not hasattr(_thread_local, "stack"):
        _thread_local.stack = []
    return _thread_local.stack


class Nd4jWorkspaceManager:
    """`Nd4j.getWorkspaceManager()` analog — thread-scoped named workspaces."""

    def __init__(self):
        self._spaces: Dict[str, MemoryWorkspace] = {}

    def get_workspace_for_current_thread(
            self, config: WorkspaceConfiguration = None,
            workspace_id: str = "WS") -> MemoryWorkspace:
        key = f"{threading.get_ident()}/{workspace_id}"
        if key not in self._spaces:
            self._spaces[key] = MemoryWorkspace(config, workspace_id)
        return self._spaces[key]

    def get_and_activate_workspace(self, config=None, workspace_id="WS"):
        ws = self.get_workspace_for_current_thread(config, workspace_id)
        return ws.__enter__()

    @staticmethod
    def current_workspace() -> Optional[MemoryWorkspace]:
        stack = _ws_stack()
        return stack[-1] if stack else None

    @staticmethod
    def assert_no_workspaces_open(msg: str = "workspaces still open"):
        """Reference WorkspaceUtils.assertNoWorkspacesOpen."""
        if _ws_stack():
            raise AssertionError(msg)


workspace_manager = Nd4jWorkspaceManager()


class LayerWorkspaceMgr:
    """DL4J `nn/workspace/LayerWorkspaceMgr` shim: per-array-type routing
    (ACTIVATIONS / ACT_GRAD / FF_WORKING_MEM / BP_WORKING_MEM / RNN_*).
    All types route to the caching allocator; `leverage_to` is
    identity."""

    TYPES = ("ACTIVATIONS", "ACTIVATION_GRAD", "FF_WORKING_MEM",
             "BP_WORKING_MEM", "RNN_FF_LOOP_WORKING_MEM",
             "RNN_BP_LOOP_WORKING_MEM", "INPUT", "FF_CACHE")

    def __init__(self, workspace_mode: str = "ENABLED"):
        self.mode = workspace_mode

    @staticmethod
    def no_workspaces() -> "LayerWorkspaceMgr":
        return LayerWorkspaceMgr("NONE")

    @staticmethod
    def builder() -> "LayerWorkspaceMgr":
        return LayerWorkspaceMgr()

    def build(self) -> "LayerWorkspaceMgr":
        return self

    def with_no_layer_workspaces(self) -> "LayerWorkspaceMgr":
        self.mode = "NONE"
        return self

    def create(self, array_type: str, shape, dtype="float32",
               device="cuda"):
        """A zeroed tensor of ``shape`` and ``dtype`` (a name such as
        ``"float32"``) on ``device``: the card unless the caller asks
        for the CPU (no silent fallback)."""
        import torch

        from ..nn.multilayer import resolve_device
        return torch.zeros(tuple(shape), dtype=getattr(torch, str(dtype)),
                           device=resolve_device(device))

    def leverage_to(self, array_type: str, array):
        return array

    def validate_array_location(self, array_type: str, array):
        return True
