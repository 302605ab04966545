"""The device mesh, partition specs and placement (training AND serving).

Counterpart of ``deeplearning4j_tpu/common/mesh.py``. There a
``jax.sharding.Mesh`` names the axes of a device array and one jitted
program runs over all of them; here the devices are the ranks of the
default ``torch.distributed`` process group, each a process that runs
the same Python program on its own shard (SPMD by hand):

- :class:`Mesh` names the ranks' axes, in the JAX package's order
  (``data`` outermost, then ``fsdp``, ``tensor``, ``seq``, ``pipe``;
  ``(data, model)`` for serving) and gives one process group per axis,
  or per tuple of axes (:meth:`Mesh.group`). ``mesh.shape`` is the
  name-to-size dict JAX's is. Without an initialised process group the
  mesh holds rank 0 alone and every collective is the identity, so each
  single-process path runs as it always did; with one, even at world
  size 1, the collectives go through it.
- :class:`P` is the ``PartitionSpec``: one entry a dim, ``None``, an
  axis name or a tuple of names (the first name major).
- A **placed** tensor is this rank's shard of a global array, carrying
  its ``(mesh, spec, global shape)`` (:func:`placement`). :func:`place`
  cuts it from the global array, :func:`gather` puts the global array
  back together. A spec that does not divide a dim falls back to replicated
  on that dim (``spec_fits`` / ``valid_spec``), as the JAX package's
  ``valid_sharding`` does.
- Computation goes through explicit collectives on the local shards
  (``parallel/collectives.py``), as the JAX package's ``shard_map``
  bodies do; GSPMD's propagation has no counterpart.

Entry points take global inputs: every rank calls them with the same
global batch and keeps its rows (:func:`shard_batch`), and every loss
they return is the global one.

**The batch context.** Where the JAX program reduces over the global
batch (batch-norm statistics, the mean of a loss) a rank sees only its
rows. :func:`batch_context` names the group that holds the rest of the
batch (the ``(data, fsdp)`` group) with the global row count and this
rank's first row; inside it :func:`batch_mean` / :func:`batch_sum` sum
over that group (sum and count), :func:`batch_moments` merges each
rank's mean and variance in one collective (as ``SyncBatchNorm`` does),
and a random
draw shaped like the local rows (dropout and noise masks,
:func:`rows_draw`) draws the global batch's shape from the step's key and
keeps this rank's rows, so the numbers do not depend on the world size.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA, FSDP, TENSOR, SEQ, PIPE = "data", "fsdp", "tensor", "seq", "pipe"
#: the serving-side name of the tensor-parallel axis
MODEL = "model"
TRAIN_AXES = (DATA, FSDP, TENSOR, SEQ, PIPE)


class P(tuple):
    """Partition spec: ``P(("data", "fsdp"), None, "tensor")``."""

    def __new__(cls, *entries):
        # a one-name tuple is that name, as JAX normalises it
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        # unpickled (a rank's job argument) as P(*entries), not P(entries)
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def global_rank() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


#: process groups by their sorted global ranks, shared by every mesh of
#: the process (``new_group`` once per set of ranks)
_GROUPS: Dict[Tuple[int, ...], object] = {}
_GROUPS_LOCK = threading.Lock()


def _create_group(ranks: Tuple[int, ...]):
    """``new_group`` over ``ranks``, called by every rank of the default
    group in the same order (members and not), once per set of ranks."""
    d = _dist()
    with _GROUPS_LOCK:
        if ranks not in _GROUPS:
            _GROUPS[ranks] = d.new_group(list(ranks))


def _group_of(ranks: Sequence[int]):
    """The process group over ``ranks`` (None where no group is
    initialised): the default group when ``ranks`` are the whole world,
    else the one the mesh created for them."""
    d = _dist()
    if d is None:
        return None
    ranks = tuple(sorted(int(r) for r in ranks))
    if ranks == tuple(range(d.get_world_size())):
        return d.group.WORLD
    g = _GROUPS.get(ranks)
    if g is None:
        raise RuntimeError(
            f"no process group over ranks {ranks}: every rank of the "
            "default group must build each mesh, in the same order")
    return g


class Mesh:
    """Named axes over global ranks; ``devices`` is the rank array (its
    ``.shape`` and ``.size`` are the JAX mesh's), ``device`` the torch
    device this rank's shards live on. A context manager, as JAX's: the
    collectives of ``parallel/collectives.py`` use the innermost active
    mesh when none is passed.

    Building a mesh creates the process groups of every combination of
    its axes that span more than one rank (``new_group`` must be called
    by every rank of the default group, in the same order): so **every
    rank builds every mesh**, a rank outside a sub-mesh included, which
    then does not use it."""

    def __init__(self, ranks, axis_names: Sequence[str], device="cuda"):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D rank array for axes "
                             f"{self.axis_names}")
        self.shape = {a: int(s) for a, s in zip(self.axis_names,
                                                 self.devices.shape)}
        self.device = _mesh_device(device)
        if _dist() is not None:
            self._create_groups()

    def _create_groups(self):
        """The group of every coset of every combination of the axes
        longer than 1, in one order on every rank."""
        import itertools
        big = [i for i, a in enumerate(self.axis_names)
               if self.shape[a] > 1]
        world = tuple(range(world_size()))
        for r in range(1, len(big) + 1):
            for combo in itertools.combinations(big, r):
                rest = [i for i in range(self.devices.ndim)
                        if i not in combo]
                n = math.prod(self.devices.shape[i] for i in combo)
                rows = np.transpose(self.devices, rest + list(combo))
                for row in rows.reshape(-1, n):
                    ranks = tuple(sorted(int(x) for x in row))
                    if ranks != world:
                        _create_group(ranks)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return global_rank()

    def __contains__(self, rank) -> bool:
        return bool(np.any(self.devices == int(rank)))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> this rank's (or ``rank``'s) index."""
        rank = self.rank if rank is None else int(rank)
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape.get(a, 1) for a in _names(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple,
        the first name major), as ``lax.axis_index`` gives it."""
        c = self.coords()
        idx = 0
        for a in _names(axes):
            idx = idx * self.shape.get(a, 1) + c.get(a, 0)
        return idx

    def group_ranks(self, axes) -> list:
        """The global ranks that share every coordinate but ``axes`` with
        this rank, in :meth:`axis_index` order."""
        axes = [a for a in _names(axes) if a in self.shape]
        c = self.coords()
        sel = tuple(slice(None) if a in axes else c[a]
                    for a in self.axis_names)
        sub = self.devices[sel]
        kept = [a for a in self.axis_names if a in axes]
        order = [kept.index(a) for a in axes]
        return [int(r) for r in np.transpose(sub, order).reshape(-1)]

    def group(self, axes):
        """The process group of ``axes`` (None: the identity, where no
        group is initialised or the axes hold one rank of a larger
        world)."""
        ranks = self.group_ranks(axes)
        if len(ranks) == 1 and world_size() > 1:
            return None
        return _group_of(ranks)

    def __enter__(self):
        _active().append(self)
        return self

    def __exit__(self, *exc):
        _active().pop()

    def __repr__(self):
        return local_mesh_info(self)


_local = threading.local()


def _active() -> list:
    if not hasattr(_local, "meshes"):
        _local.meshes = []
    return _local.meshes


def current_mesh() -> Optional[Mesh]:
    stack = _active()
    return stack[-1] if stack else None


@dataclasses.dataclass
class MeshConfig:
    """Declarative mesh shape; -1 on ``data`` means "all remaining
    devices"."""
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        fixed = self.fsdp * self.tensor * self.seq * self.pipe
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fsdp*tensor*seq*pipe={fixed}")
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(f"mesh {data}x{fixed} != {n_devices} devices")
        return (data, self.fsdp, self.tensor, self.seq, self.pipe)


def _mesh_device(device):
    from ..nn.multilayer import resolve_device
    return resolve_device(device)


def make_mesh(config: MeshConfig = None, devices: Sequence[int] = None,
              device="cuda") -> Mesh:
    """A named 5-D training mesh over ``devices`` (global ranks; all of
    the default group's by default), ``data`` outermost and ``seq`` /
    ``pipe`` innermost as in the JAX package. ``device`` is where this
    rank's shards live: the card unless the caller asks for the CPU."""
    config = config or MeshConfig()
    devices = list(devices) if devices is not None \
        else list(range(world_size()))
    shape = config.resolve(len(devices))
    return Mesh(np.asarray(devices).reshape(shape), TRAIN_AXES,
                _mesh_device(device))


def data_parallel_mesh(devices=None, device="cuda") -> Mesh:
    return make_mesh(MeshConfig(), devices, device)


def serving_mesh(model_parallel: Optional[int] = None,
                 devices: Sequence[int] = None, device="cuda") -> Mesh:
    """2-D ``(data, model)`` mesh for tensor-parallel serving; the
    default puts every rank on ``model``. ``DecodeEngine``,
    ``InferenceEngine`` and ``ModelRegistry.deploy`` take it as
    ``mesh=`` (``runtime/sharded.py``)."""
    devices = list(devices) if devices is not None \
        else list(range(world_size()))
    n = len(devices)
    m = n if model_parallel is None else int(model_parallel)
    if m < 1 or n % m != 0:
        raise ValueError(
            f"model_parallel={m} must be >= 1 and divide {n} devices")
    return Mesh(np.asarray(devices).reshape(n // m, m), (DATA, MODEL),
                _mesh_device(device))


def validate_mesh(mesh: Mesh, required: Sequence[str] = (DATA,)) -> Mesh:
    """Reject a mesh missing the axis names the caller is about to use."""
    missing = [a for a in required if a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"mesh axes {tuple(mesh.axis_names)} missing required "
            f"{missing}; build one with serving_mesh()/make_mesh()")
    return mesh


def batch_spec() -> P:
    """Batch sharded over data(+fsdp); everything else replicated."""
    return P((DATA, FSDP))


def replicated_spec() -> P:
    return P()


def dp_size(mesh: Mesh) -> int:
    """Size of the data-parallel group (data * fsdp axes)."""
    return mesh.axis_size((DATA, FSDP))


def num_devices(mesh: Optional[Mesh] = None) -> int:
    return mesh.size if mesh is not None else world_size()


def local_mesh_info(mesh: Mesh) -> str:
    return f"Mesh({mesh.shape}, {mesh.size} devices)"


def mesh_shape(mesh: Optional[Mesh]) -> Optional[Dict[str, int]]:
    """``{"data": 1, "model": 8}``-style dict for /v1/models reporting."""
    if mesh is None:
        return None
    return dict(mesh.shape)


def spec_desc(spec) -> str:
    """Stable JSON-able description of a param_spec deploy argument."""
    if spec is None:
        return f"auto({MODEL})"
    if isinstance(spec, P):
        return repr(spec)
    leaves = _spec_leaves(spec)
    return f"tree[{len(leaves)} specs]"


def _spec_leaves(tree) -> list:
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _spec_leaves(v)]
    return []


# -- spec arithmetic ----------------------------------------------------------

def spec_fits(arr, spec: P, mesh: Mesh) -> bool:
    """True when ``spec`` legally shards ``arr`` on ``mesh``: rank covers
    the spec and every named dim divides evenly."""
    ndim = len(arr.shape) if hasattr(arr, "shape") else 0
    if len(spec) > ndim:
        return False
    for d, entry in enumerate(spec):
        names = _names(entry)
        if any(n not in mesh.shape for n in names):
            return False
        size = mesh.axis_size(names)
        if size > 1 and arr.shape[d] % size != 0:
            return False
    return True


def valid_spec(mesh: Mesh, spec: P, shape) -> P:
    """``spec`` with every entry whose axes do not divide its dim (or
    are not on the mesh, or hold one rank) replaced by None."""
    out = []
    for i in range(len(shape)):
        names = _names(spec[i]) if i < len(spec) else ()
        names = tuple(n for n in names if n in mesh.shape)
        size = mesh.axis_size(names)
        out.append((names if len(names) > 1 else names[0])
                   if names and size > 1 and shape[i] % size == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def naive_param_spec(arr, mesh: Mesh, axis: str = MODEL) -> P:
    """Tensor-parallel spec for one leaf: the innermost dim divisible by
    ``axis``, else replicated."""
    size = mesh.shape.get(axis, 1)
    ndim = len(arr.shape)
    if size > 1 and ndim >= 2:
        for d in range(ndim - 1, -1, -1):
            if arr.shape[d] >= size and arr.shape[d] % size == 0:
                return P(*([None] * d + [axis]))
    return P()


def zero1_spec(mesh: Mesh, arr) -> P:
    """ZeRO-1 spec for one optimizer-state leaf: the leading dim over
    the data-parallel group when divisible, else replicated."""
    n = dp_size(mesh)
    if n > 1 and len(getattr(arr, "shape", ())) >= 1 \
            and arr.shape[0] % n == 0:
        return P((DATA, FSDP))
    return P()


def tree_map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and a matching spec tree; a single
    :class:`P` (or None) applies to every leaf."""
    if specs is None or isinstance(specs, P):
        return _tree_map(lambda a: fn(a, specs), tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_specs(fn, v, s) for v, s in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, specs)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return None if tree is None else fn(tree)


def param_shardings(mesh: Mesh, tree, spec=None):
    """The spec tree :func:`shard_params` places by: naive per leaf over
    ``model`` (None), one :class:`P` for every leaf it fits (else
    replicated), or a tree of them."""
    if spec is None:
        return _tree_map(lambda a: naive_param_spec(a, mesh), tree)
    return tree_map_specs(
        lambda a, s: s if spec_fits(a, s, mesh) else P(), tree, spec)


# -- placement ----------------------------------------------------------------

def placement(t):
    """``(mesh, spec, global shape)`` of a placed tensor, else None."""
    return getattr(t, "_dl4j_placement", None)


def tag(t: torch.Tensor, mesh: Mesh, spec: P, shape) -> torch.Tensor:
    """Mark ``t`` as this rank's shard of a global ``shape`` array."""
    t._dl4j_placement = (mesh, P(*spec), tuple(int(s) for s in shape))
    return t


def shard_slices(mesh: Mesh, spec: P, shape):
    """The index of this rank's shard of a global ``shape`` array."""
    idx = []
    for d, n in enumerate(shape):
        names = _names(spec[d]) if d < len(spec) else ()
        k = mesh.axis_size(names)
        if k > 1:
            w = n // k
            i = mesh.axis_index(names)
            idx.append(slice(i * w, (i + 1) * w))
        else:
            idx.append(slice(None))
    return tuple(idx)


def local_slice(x: torch.Tensor, mesh: Mesh, spec: P) -> torch.Tensor:
    """This rank's shard of the global ``x`` (a view)."""
    return x[shard_slices(mesh, spec, x.shape)]


def place(x, mesh: Mesh, spec: P = P()) -> torch.Tensor:
    """This rank's shard of the global array ``x`` under ``spec`` (with
    the divisibility fallback), on the mesh's device, tagged. A leaf
    that places itself (``quant.QuantizedTensor.placed``) does so."""
    if hasattr(x, "placed"):
        return x.placed(mesh, spec)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    spec = valid_spec(mesh, spec, t.shape)
    shard = local_slice(t, mesh, spec).to(mesh.device).contiguous()
    if shard.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr():
        shard = shard.clone()     # never alias the caller's array
    return tag(shard, mesh, spec, t.shape)


def gather(t: torch.Tensor) -> torch.Tensor:
    """The global array of a placed tensor (itself when unplaced or
    replicated); every rank of its mesh must call it."""
    if hasattr(t, "gathered"):
        return t.gathered()
    pl = placement(t)
    if pl is None:
        return t
    return gather_as(t, pl[0], pl[1])


def gather_as(t: torch.Tensor, mesh: Mesh, spec: P) -> torch.Tensor:
    """The global array of this rank's shard ``t`` under ``spec``."""
    from ..parallel import collectives as C
    out = t
    for d, entry in enumerate(spec):
        if entry is not None and mesh.axis_size(entry) > 1:
            out = C.all_gather_raw(out, entry, mesh, dim=d)
    return out


def gather_tree(tree):
    return _tree_map(gather, tree)


def shard_params(mesh: Mesh, tree, spec=None):
    """Place a global param tree into its layout (:func:`param_shardings`)."""
    specs = param_shardings(mesh, tree, spec)
    return tree_map_specs(lambda a, s: place(a, mesh, s), tree, specs)


def data_sharding(mesh: Mesh) -> P:
    """Request batches ride the ``data`` axis (replicated when absent)."""
    return P(DATA) if DATA in mesh.axis_names else P()


def replicate(mesh: Mesh, tree):
    return _tree_map(lambda a: place(a, mesh, P()), tree)


def zero1_place(mesh: Mesh, tree):
    """Place an updater-state tree into the ZeRO-1 layout."""
    return _tree_map(lambda a: place(a, mesh, zero1_spec(mesh, a)), tree)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in (DATA, FSDP) if a in mesh.shape)


def batch_divides(mesh: Mesh, rows: int) -> bool:
    n = dp_size(mesh)
    return n == 1 or rows % n == 0


def shard_batch(mesh: Mesh, batch_tree, seq_axis: Optional[str] = None):
    """This rank's rows of every array of a global batch: dim 0 over
    ``(data, fsdp)`` where it divides (else the whole batch, replicated),
    and dim 1 over ``seq_axis`` when given."""
    def one(x):
        x = x if isinstance(x, torch.Tensor) \
            else torch.as_tensor(np.asarray(x))
        spec = [batch_spec()[0]] if x.dim() >= 1 else []
        if seq_axis is not None and x.dim() >= 2:
            spec.append(seq_axis)
        return place(x, mesh, P(*spec))
    return _tree_map(one, batch_tree)


# -- the batch context ----------------------------------------------------------

@dataclasses.dataclass
class BatchShard:
    """The rows of a global batch this rank holds: ``group`` spans the
    ranks that hold the rest (None: the identity), ``rows`` is the global
    row count, ``offset`` this rank's first row."""
    group: object
    mesh: Mesh
    axes: Tuple[str, ...]
    rows: int
    offset: int
    memo: dict = dataclasses.field(default_factory=dict)


def current_batch() -> Optional[BatchShard]:
    return getattr(_local, "batch", None)


@contextmanager
def batch_context(mesh: Optional[Mesh], rows: int):
    """Within, the global batch of ``rows`` rows is sharded over the
    mesh's ``(data, fsdp)`` group (a no-op without a mesh, or where the
    rows do not divide and every rank holds them all)."""
    prev = current_batch()
    shard = None
    if mesh is not None and batch_divides(mesh, rows):
        # no group: none is initialised, or the batch axes hold this rank
        # alone in a larger world; at world size 1 the reductions still
        # go through the group
        axes = batch_axes(mesh)
        g = mesh.group(axes)
        if g is not None:
            shard = BatchShard(g, mesh, axes, rows, mesh.axis_index(axes)
                               * (rows // dp_size(mesh)))
    _local.batch = shard
    try:
        yield shard
    finally:
        _local.batch = prev


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch group (differentiable), or ``x``."""
    shard = current_batch()
    if shard is None:
        return x
    from ..parallel import collectives as C
    return C.all_reduce_sum(x, shard.axes, mesh=shard.mesh)


def batch_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``torch.mean(x, dim)`` where ``dim`` covers the batch dim 0 (all
    dims by default): over the global batch inside :func:`batch_context`."""
    shard = current_batch()
    if shard is None:
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    dims = range(x.dim()) if dim is None else \
        (dim if isinstance(dim, (tuple, list)) else (dim,))
    count = math.prod(x.shape[d] for d in dims) \
        // max(x.shape[0], 1) * shard.rows if x.dim() else shard.rows
    return batch_sum(s) / count


def batch_memo(x: torch.Tensor, fn, fresh: bool = False):
    """``fn()`` of the input ``x``; inside a batch context the result is
    kept, and a later call for ``x`` (the same storage, shape, strides and
    version: a ``detach()`` of ``x`` hits) that is not ``fresh`` reuses
    it. A forward computes fresh, so that a recomputation under
    activation checkpointing replays it. The context keeps ``x`` alive
    while it caches, so no other tensor takes its storage under the
    key."""
    shard = current_batch()
    if shard is None:
        return fn()
    key = (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x._version)
    if fresh or key not in shard.memo:
        shard.memo[key] = (x, fn())
    return shard.memo[key][1]


def batch_moments(x: torch.Tensor, dims):
    """(mean, biased variance) of ``x`` over ``dims``, which cover the
    batch dim 0: over the global batch inside :func:`batch_context`. Each
    rank's mean and sum of squared deviations go through one all-gather
    (one collective back) and merge as Chan et al.'s parallel variance:
    the ranks hold equal rows, so the global mean is the ranks' mean and
    the sum of squares adds each rank's spread about it."""
    shard = current_batch()
    if shard is None:
        return torch.mean(x, dim=dims), torch.var(x, dim=dims, correction=0)
    from ..parallel import collectives as C
    shape = [1 if d in dims else n for d, n in enumerate(x.shape)]
    mean = torch.mean(x, dim=dims)
    m2 = torch.sum(torch.square(x - mean.reshape(shape)), dim=dims)
    both = C.all_gather(torch.stack([mean, m2]), shard.axes, tiled=False,
                        mesh=shard.mesh)
    means, m2s = both[:, 0], both[:, 1]
    g_mean = torch.mean(means, dim=0)
    n = math.prod(x.shape[d] for d in dims)
    var = (torch.sum(m2s, dim=0)
           + n * torch.sum(torch.square(means - g_mean), dim=0)) \
        / (n * means.shape[0])
    return g_mean, var


def rows_draw(draw, shape, device):
    """``draw(shape)`` for a tensor of this rank's rows; inside a batch
    context whose rows it has, the global batch's draw, sliced, so a
    sharded rank sees the masks the single-process program draws."""
    shard = current_batch()
    if shard is not None and len(shape) and shard.rows != shape[0] \
            and shard.rows % shape[0] == 0:
        full = draw((shard.rows,) + tuple(shape[1:]))
        return full[shard.offset:shard.offset + shape[0]]
    return draw(tuple(shape))
