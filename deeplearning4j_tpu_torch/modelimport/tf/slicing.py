"""TF StridedSlice mask resolution -> static index spec.

A copy of ``deeplearning4j_tpu/modelimport/tf/slicing.py``. TF's
StridedSlice carries five bitmasks (begin/end/ellipsis/new_axis/
shrink_axis). The reference resolves these at execution time
(`libnd4j/include/ops/declarable/generic/shape/strided_slice.cpp`); the
importer resolves them at *import* time against the static input shape
and emits the serializable `tf_strided_slice` op.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def build_index_spec(begin: Sequence[int], end: Sequence[int],
                     strides: Sequence[int], begin_mask: int = 0,
                     end_mask: int = 0, ellipsis_mask: int = 0,
                     new_axis_mask: int = 0, shrink_axis_mask: int = 0,
                     rank: int = None) -> List[Tuple]:
    """Resolve masks into a spec of ("slice",b,e,s)/("int",i)/("newaxis",)/
    ("all",) entries consumable by the `tf_strided_slice` op (and by numpy
    for constant folding)."""
    n = len(begin)
    spec: List[Tuple] = []
    # count real (non-new-axis, non-ellipsis) entries to size the ellipsis
    real = sum(1 for i in range(n)
               if not (new_axis_mask >> i) & 1 and not (ellipsis_mask >> i) & 1)
    for i in range(n):
        if (ellipsis_mask >> i) & 1:
            fill = (rank - real) if rank is not None else 0
            spec.extend([("all",)] * max(fill, 0))
            continue
        if (new_axis_mask >> i) & 1:
            spec.append(("newaxis",))
            continue
        if (shrink_axis_mask >> i) & 1:
            spec.append(("int", int(begin[i])))
            continue
        b = None if (begin_mask >> i) & 1 else int(begin[i])
        e = None if (end_mask >> i) & 1 else int(end[i])
        s = int(strides[i]) if strides is not None else 1
        if b is None and e is None and s == 1:
            spec.append(("all",))
        else:
            spec.append(("slice", b, e, s))
    return spec


def apply_spec_np(x, spec):
    idx = []
    for entry in spec:
        kind = entry[0]
        if kind == "slice":
            idx.append(slice(entry[1], entry[2], entry[3]))
        elif kind == "int":
            idx.append(int(entry[1]))
        elif kind == "newaxis":
            idx.append(None)
        else:
            idx.append(slice(None))
    return x[tuple(idx)]
