"""Minimal protobuf wire-format codec for model import.

A copy of ``deeplearning4j_tpu/modelimport/protoio.py`` (pure Python, no
framework import), kept in the port so that the port needs nothing of
the JAX package.

The import layer parses TensorFlow GraphDef (.pb) and ONNX (.onnx) files
without requiring the tensorflow/onnx runtimes: both formats are plain
protobuf, and the wire format is simple (varint-keyed fields with four wire
types). Reference counterpart: the generated protobuf classes under
`nd4j/nd4j-backends/nd4j-api-parent/nd4j-api/src/main/java/org/nd4j/ir/`
and the shaded TF/ONNX protos the Kotlin importers consume.

This is a *schemaless* decoder: `decode()` returns `{field_number: [values]}`
where each value is an int (varint), bytes (length-delimited), or raw 4/8
byte little-endian scalars. The framework-specific importers interpret
fields by number according to the public .proto schemas.

A tiny encoder is included so tests can synthesize ONNX files without the
onnx package.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

Value = Union[int, bytes]
Fields = Dict[int, List[Value]]

# wire types
VARINT = 0
FIXED64 = 1
LENGTH = 2
FIXED32 = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def decode(buf: bytes) -> Fields:
    """Decode one message into {field_number: [raw values]}.

    varint fields -> int; fixed32/fixed64 -> bytes (4/8, little-endian);
    length-delimited -> bytes (sub-message, string, or packed array —
    caller interprets).
    """
    fields: Fields = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == LENGTH:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == FIXED32:
            val = buf[pos:pos + 4]
            pos += 4
        elif wtype == FIXED64:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {fnum})")
        fields.setdefault(fnum, []).append(val)
    return fields


# ---------------------------------------------------------------- accessors
def first(fields: Fields, num: int, default=None):
    vals = fields.get(num)
    return vals[0] if vals else default


def all_(fields: Fields, num: int) -> List[Value]:
    return fields.get(num, [])


def as_str(val, default: str = "") -> str:
    if val is None:
        return default
    return val.decode("utf-8", errors="replace")


def as_int64(val: int) -> int:
    """Interpret a raw varint as two's-complement int64."""
    if val >= 1 << 63:
        val -= 1 << 64
    return val


def as_float32(val: bytes) -> float:
    return struct.unpack("<f", val)[0]


def as_float64(val: bytes) -> float:
    return struct.unpack("<d", val)[0]


def ints(fields: Fields, num: int, signed: bool = True) -> List[int]:
    """Repeated int field: handles both packed and unpacked encodings."""
    out: List[int] = []
    for v in fields.get(num, []):
        if isinstance(v, bytes):  # packed
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(as_int64(x) if signed else x)
        else:
            out.append(as_int64(v) if signed else v)
    return out


def floats(fields: Fields, num: int) -> List[float]:
    """Repeated float field (packed fixed32 or unpacked)."""
    out: List[float] = []
    for v in fields.get(num, []):
        if isinstance(v, bytes) and len(v) != 4:
            out.extend(struct.unpack(f"<{len(v)//4}f", v))
        elif isinstance(v, bytes):
            out.append(as_float32(v))
        else:  # should not happen for float fields
            out.append(float(v))
    return out


def doubles(fields: Fields, num: int) -> List[float]:
    out: List[float] = []
    for v in fields.get(num, []):
        if isinstance(v, bytes) and len(v) != 8:
            out.extend(struct.unpack(f"<{len(v)//8}d", v))
        elif isinstance(v, bytes):
            out.append(as_float64(v))
    return out


# ---------------------------------------------------------------- encoder
class Writer:
    """Append-only protobuf message writer (for test fixtures)."""

    def __init__(self):
        self._parts: List[bytes] = []

    @staticmethod
    def _varint(v: int) -> bytes:
        if v < 0:
            v += 1 << 64
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def int_(self, num: int, v: int) -> "Writer":
        self._parts.append(self._varint(num << 3 | VARINT))
        self._parts.append(self._varint(v))
        return self

    def float_(self, num: int, v: float) -> "Writer":
        self._parts.append(self._varint(num << 3 | FIXED32))
        self._parts.append(struct.pack("<f", v))
        return self

    def bytes_(self, num: int, v: bytes) -> "Writer":
        self._parts.append(self._varint(num << 3 | LENGTH))
        self._parts.append(self._varint(len(v)))
        self._parts.append(v)
        return self

    def str_(self, num: int, v: str) -> "Writer":
        return self.bytes_(num, v.encode("utf-8"))

    def msg(self, num: int, w: "Writer") -> "Writer":
        return self.bytes_(num, w.build())

    def packed_ints(self, num: int, vals) -> "Writer":
        body = b"".join(self._varint(v) for v in vals)
        return self.bytes_(num, body)

    def build(self) -> bytes:
        return b"".join(self._parts)
