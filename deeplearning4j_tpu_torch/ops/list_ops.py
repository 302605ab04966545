"""TensorArray / NDArrayList ops (the reference's ``headers/list.h``).

Counterpart of ``deeplearning4j_tpu/ops/list_ops.py``: a list is a tuple
of tensors, which each op takes and returns anew (the reference mutates
a native NDArrayList inside its graph interpreter). Indices are read on
the host.
"""
from __future__ import annotations

import torch

from .registry import op


@op("create_list", "list", differentiable=False)
def create_list(*_, **__):
    return ()


@op("write_list", "list")
def write_list(lst, value, index):
    """``lst`` with ``value`` at ``index``, zeros filling any gap."""
    lst = tuple(lst)
    i = int(index)
    if i < len(lst):
        return lst[:i] + (value,) + lst[i + 1:]
    return lst + (torch.zeros_like(value),) * (i - len(lst)) + (value,)


@op("read_list", "list")
def read_list(lst, index):
    return lst[int(index)]


@op("pick_list", "list")
def pick_list(lst, *indices):
    """The entries at ``indices`` (given one by one or as one sequence),
    stacked."""
    if len(indices) == 1 and hasattr(indices[0], "__iter__"):
        indices = indices[0]
    return torch.stack([lst[int(i)] for i in indices])


@op("size_list", "list", differentiable=False)
def size_list(lst):
    device = lst[0].device if len(lst) else None
    return torch.tensor(len(lst), dtype=torch.int32, device=device)


@op("scatter_list", "list")
def scatter_list(lst, indices, array):
    """``array``'s rows into the list at ``indices``, zeros filling any
    gap."""
    lst = list(lst)
    for j, i in enumerate(int(x) for x in indices):
        while len(lst) <= i:
            lst.append(torch.zeros_like(array[0]))
        lst[i] = array[j]
    return tuple(lst)


@op("gather_list", "list")
def gather_list(lst, indices):
    return torch.stack([lst[int(i)] for i in indices])


@op("stack_list", "list")
def stack_list(lst):
    return torch.stack(list(lst))


@op("unstack_list", "list")
def unstack_list(array, axis=0):
    return tuple(torch.unbind(array, axis))


@op("split_list", "list")
def split_list(array, sizes):
    """Consecutive slices of ``array``'s first axis, ``sizes`` long."""
    out = []
    offset = 0
    for s in (int(x) for x in sizes):
        out.append(array[offset:offset + s])
        offset += s
    return tuple(out)


@op("clone_list", "list")
def clone_list(lst):
    return tuple(lst)


@op("delete_list", "list", differentiable=False)
def delete_list(lst):
    return ()
