"""FlatBuffers wire format: a table reader and a minimal builder, in pure
Python over ``struct`` and numpy.

Counterpart of ``deeplearning4j_tpu/modelimport/flatbuf.py``, which walks
tables with the ``flatbuffers`` runtime's ``Table`` and whose writer
(``autodiff/serialization.py::save_flatbuffers``) builds with
``flatbuffers.Builder``. The port depends on neither: :class:`Table` and
the helpers below read what the JAX package reads, and :class:`Builder`
lays out bytes by the runtime builder's rules (back to front, each scalar
aligned to its size, vtables shared when equal), so that both writers
give the same file for the same graph.

Slot numbers are the field declaration indices of the ``.fbs`` schemas
(vtable offset = 4 + 2 * slot); the readers stay schema-less.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np


def _u32(buf, pos: int) -> int:
    return struct.unpack_from("<I", buf, pos)[0]


class Table:
    """A table at ``pos`` of ``buf``: vtable lookup and indirection."""

    __slots__ = ("Bytes", "Pos")

    def __init__(self, buf, pos: int):
        self.Bytes = buf
        self.Pos = pos

    def offset(self, vtable_offset: int) -> int:
        """The field's offset from the table start, 0 when absent."""
        vtable = self.Pos - struct.unpack_from("<i", self.Bytes, self.Pos)[0]
        vtable_end = struct.unpack_from("<H", self.Bytes, vtable)[0]
        if vtable_offset < vtable_end:
            return struct.unpack_from("<H", self.Bytes,
                                      vtable + vtable_offset)[0]
        return 0

    def get(self, fmt: str, pos: int):
        return struct.unpack_from("<" + fmt, self.Bytes, pos)[0]

    def indirect(self, pos: int) -> int:
        return pos + _u32(self.Bytes, pos)

    def string(self, pos: int) -> bytes:
        pos = self.indirect(pos)
        n = _u32(self.Bytes, pos)
        return bytes(self.Bytes[pos + 4:pos + 4 + n])

    def vector(self, field_offset: int) -> int:
        """Start of the data of the vector the field points at."""
        return self.indirect(self.Pos + field_offset) + 4

    def vector_len(self, field_offset: int) -> int:
        return _u32(self.Bytes, self.indirect(self.Pos + field_offset))


def tbl(buf, pos: int) -> Table:
    return Table(buf, pos)


def root(buf) -> Table:
    return tbl(buf, _u32(buf, 0))


def off(t: Table, slot: int) -> int:
    return t.offset(4 + 2 * slot)


def _scalar(fmt):
    def read(t, slot, default=0):
        o = off(t, slot)
        return t.get(fmt, t.Pos + o) if o else default
    return read


i8 = _scalar("b")
i32 = _scalar("i")
u32 = _scalar("I")
i64 = _scalar("q")


def f32(t, slot, default=0.0):
    o = off(t, slot)
    return t.get("f", t.Pos + o) if o else default


def f64(t, slot, default=0.0):
    o = off(t, slot)
    return t.get("d", t.Pos + o) if o else default


def string(t, slot) -> Optional[str]:
    o = off(t, slot)
    return t.string(t.Pos + o).decode("utf-8") if o else None


def subtable(t, slot) -> Optional[Table]:
    o = off(t, slot)
    return tbl(t.Bytes, t.indirect(t.Pos + o)) if o else None


def union_table(t, slot) -> Optional[Table]:
    """A union value field: same indirection as a subtable."""
    return subtable(t, slot)


def vec_len(t, slot) -> int:
    o = off(t, slot)
    return t.vector_len(o) if o else 0


def vec_table(t, slot, i) -> Table:
    o = off(t, slot)
    return tbl(t.Bytes, t.indirect(t.vector(o) + i * 4))


def vec_scalar(t, slot, dtype) -> list:
    """A vector of little-endian scalars of numpy ``dtype`` as a list."""
    o = off(t, slot)
    if not o:
        return []
    return np.frombuffer(t.Bytes, np.dtype(dtype).newbyteorder("<"),
                         count=t.vector_len(o), offset=t.vector(o)).tolist()


def vec_i32(t, slot):
    return vec_scalar(t, slot, np.int32)


def vec_i64(t, slot):
    return vec_scalar(t, slot, np.int64)


def vec_f32(t, slot):
    return vec_scalar(t, slot, np.float32)


def vec_f64(t, slot):
    return vec_scalar(t, slot, np.float64)


def vec_bool(t, slot):
    return [bool(b) for b in vec_scalar(t, slot, np.uint8)]


def vec_str(t, slot) -> List[str]:
    o = off(t, slot)
    if not o:
        return []
    v, n = t.vector(o), t.vector_len(o)
    return [t.string(v + 4 * i).decode("utf-8") for i in range(n)]


def vec_bytes(t, slot) -> bytes:
    o = off(t, slot)
    if not o:
        return b""
    v, n = t.vector(o), t.vector_len(o)
    return bytes(t.Bytes[v:v + n])


class Builder:
    """Builds one FlatBuffer back to front, as the ``flatbuffers``
    runtime's ``Builder`` does, with the calls the SameDiff writer makes:
    tables (``StartObject`` / ``Prepend*Slot`` / ``EndObject``), strings,
    byte and numpy vectors, vectors of offsets (``StartVector`` /
    ``PrependUOffsetTRelative`` / ``EndVector``) and ``Finish``."""

    def __init__(self, initial_size: int = 1024):
        self._buf = bytearray(max(int(initial_size), 1))
        self._head = len(self._buf)
        self._minalign = 1
        self._vtable: Optional[List[int]] = None
        self._object_end = 0
        self._vtables = {}
        self._nested = False
        self._vector_n = 0
        self._finished = False

    # -- layout -------------------------------------------------------------
    def Offset(self) -> int:
        """Bytes written so far: an offset from the buffer's end."""
        return len(self._buf) - self._head

    def _grow(self, needed: int):
        size = len(self._buf)
        new = size
        while self._head + (new - size) < needed:
            new *= 2
        if new > 2 ** 31:
            raise ValueError("a FlatBuffer cannot exceed 2 GB")
        grown = bytearray(new)
        grown[new - size:] = self._buf
        self._head += new - size
        self._buf = grown

    def _prep(self, size: int, additional: int):
        """Align the next ``size``-byte element, written after
        ``additional`` bytes, to ``size``."""
        self._minalign = max(self._minalign, size)
        align = -(self.Offset() + additional) & (size - 1)
        needed = align + size + additional
        if self._head < needed:
            self._grow(needed)
        self._head -= align  # the buffer starts zeroed: padding is zeros

    def _place(self, fmt: str, value):
        self._head -= struct.calcsize(fmt)
        struct.pack_into("<" + fmt, self._buf, self._head, value)

    def _prepend(self, fmt: str, value):
        self._prep(struct.calcsize(fmt), 0)
        self._place(fmt, value)

    def _put_bytes(self, data):
        self._head -= len(data)
        self._buf[self._head:self._head + len(data)] = data

    # -- scalars and offsets ------------------------------------------------
    def PrependBool(self, x):
        self._prepend("?", bool(x))

    def PrependUOffsetTRelative(self, off_: int):
        self._prep(4, 0)
        if off_ > self.Offset():
            raise ValueError("a FlatBuffer offset points past the head")
        self._place("I", self.Offset() - off_ + 4)

    def _prepend_soffset_relative(self, off_: int):
        self._prep(4, 0)
        self._place("i", self.Offset() - off_ + 4)

    # -- tables -------------------------------------------------------------
    def StartObject(self, num_fields: int):
        if self._nested:
            raise ValueError("a FlatBuffer object is already open")
        self._vtable = [0] * num_fields
        self._object_end = self.Offset()
        self._nested = True

    def _slot(self, slot: int):
        self._vtable[slot] = self.Offset()

    def _prepend_slot(self, fmt, slot, x, default):
        if x != default:
            self._prepend(fmt, x)
            self._slot(slot)

    def PrependInt8Slot(self, slot, x, default):
        self._prepend_slot("b", slot, x, default)

    def PrependInt32Slot(self, slot, x, default):
        self._prepend_slot("i", slot, x, default)

    def PrependUOffsetTRelativeSlot(self, slot, x, default):
        if x != default:
            self.PrependUOffsetTRelative(x)
            self._slot(slot)

    def EndObject(self) -> int:
        """Write the object's vtable, or point it at an equal one."""
        if not self._nested:
            raise ValueError("no FlatBuffer object is open")
        self._nested = False
        self._prepend_soffset_relative(0)
        obj = self.Offset()
        fields = list(self._vtable)
        while fields and fields[-1] == 0:
            fields.pop()
        rel = [obj - f if f else 0 for f in fields]
        size = obj - self._object_end
        key = tuple(reversed(rel)) + (size,)
        shared = self._vtables.get(key)
        if shared is None:
            for r in reversed(rel):
                self._prepend("H", r)
            self._prepend("H", size)
            self._prepend("H", (len(rel) + 2) * 2)
            struct.pack_into("<i", self._buf, len(self._buf) - obj,
                             self.Offset() - obj)
            self._vtables[key] = self.Offset()
        else:
            self._head = len(self._buf) - obj
            struct.pack_into("<i", self._buf, self._head, shared - obj)
        self._vtable = None
        return obj

    # -- vectors ------------------------------------------------------------
    def StartVector(self, elem_size: int, num_elems: int, alignment: int):
        if self._nested:
            raise ValueError("a FlatBuffer object is already open")
        self._nested = True
        self._vector_n = num_elems
        self._prep(4, elem_size * num_elems)
        self._prep(alignment, elem_size * num_elems)
        return self.Offset()

    def EndVector(self) -> int:
        if not self._nested:
            raise ValueError("no FlatBuffer vector is open")
        self._nested = False
        self._place("I", self._vector_n)
        return self.Offset()

    def CreateString(self, s) -> int:
        data = s.encode("utf-8") if isinstance(s, str) else bytes(s)
        self._nested = True
        self._prep(4, len(data) + 1)
        self._place("B", 0)
        self._put_bytes(data)
        self._vector_n = len(data)
        return self.EndVector()

    def CreateByteVector(self, data) -> int:
        self._nested = True
        self._prep(4, len(data))
        self._put_bytes(data)
        self._vector_n = len(data)
        return self.EndVector()

    def CreateNumpyVector(self, x: np.ndarray) -> int:
        """A 1-D numeric array, little-endian."""
        if x.ndim > 1 or x.dtype.kind not in "biuf":
            raise TypeError("CreateNumpyVector takes a 1-D numeric array")
        self.StartVector(x.itemsize, x.size, x.dtype.alignment)
        self._put_bytes(x.astype(x.dtype.newbyteorder("<"),
                                 copy=False).tobytes())
        self._vector_n = x.size
        return self.EndVector()

    # -- the buffer ---------------------------------------------------------
    def Finish(self, root_table: int) -> int:
        self._prep(self._minalign, 4)
        self.PrependUOffsetTRelative(root_table)
        self._finished = True
        return self._head

    def Output(self) -> bytes:
        if not self._finished:
            raise ValueError("Finish() the FlatBuffer before Output()")
        return bytes(self._buf[self._head:])
