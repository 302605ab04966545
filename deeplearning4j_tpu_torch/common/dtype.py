"""Data-type system.

Counterpart of ``deeplearning4j_tpu/common/dtype.py``: the reference's
``DataType`` names and conversion semantics, mapped onto torch dtypes
(``.torch``) and numpy dtypes (``.np``). bfloat16 has no numpy dtype
here (the JAX package borrows ``ml_dtypes``' through JAX); ``.np`` of it
raises, and such tensors cross to numpy as float32 or through a 16-bit
view (``bridge.py``).
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    """Mirrors the reference's dtype enum (names kept for API parity)."""

    DOUBLE = "float64"
    FLOAT = "float32"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    LONG = "int64"
    INT = "int32"
    SHORT = "int16"
    BYTE = "int8"
    UBYTE = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    BOOL = "bool"
    # UTF8/COMPRESSED exist in the reference; strings are host-side only here.
    UTF8 = "object"

    # ------------------------------------------------------------------
    @property
    def torch(self) -> torch.dtype:
        if self is DataType.UTF8:
            raise TypeError("UTF8 is a host-side dtype; no device representation")
        return getattr(torch, self.value)

    @property
    def np(self):
        if self is DataType.UTF8:
            return np.dtype(object)
        if self is DataType.BFLOAT16:
            raise TypeError("bfloat16 has no numpy dtype here; cast to "
                            "float32 first")
        return np.dtype(self.value)

    # -- classification, mirroring DataType.java helpers ----------------
    def is_fp(self) -> bool:
        return self in _FP

    def is_int(self) -> bool:
        return self in _INT or self in _UINT

    def is_signed(self) -> bool:
        return self in _FP or self in _INT

    def is_unsigned(self) -> bool:
        return self in _UINT

    def width(self) -> int:
        return _WIDTH[self]

    # ------------------------------------------------------------------
    @staticmethod
    def from_any(x) -> "DataType":
        """A ``DataType`` from a name or alias, a torch dtype, anything
        numpy reads as a dtype, or a tensor or array (its own dtype, as
        ``jnp.dtype`` reads one)."""
        if isinstance(x, DataType):
            return x
        if isinstance(x, (torch.Tensor, np.ndarray)):
            x = x.dtype
        if isinstance(x, str):
            alias = _ALIASES.get(x.lower())
            if alias is not None:
                return alias
            raise ValueError(f"unknown dtype: {x!r}")
        if isinstance(x, torch.dtype):
            name = str(x).replace("torch.", "")
        else:
            name = np.dtype(x).name
        for dt in DataType:
            if dt is not DataType.UTF8 and dt.value == name:
                return dt
        raise ValueError(f"unknown dtype: {x!r}")


_FP = {DataType.DOUBLE, DataType.FLOAT, DataType.HALF, DataType.BFLOAT16}
_INT = {DataType.LONG, DataType.INT, DataType.SHORT, DataType.BYTE}
_UINT = {DataType.UBYTE, DataType.UINT16, DataType.UINT32, DataType.UINT64}
_WIDTH = {
    DataType.DOUBLE: 64, DataType.FLOAT: 32, DataType.HALF: 16,
    DataType.BFLOAT16: 16, DataType.LONG: 64, DataType.INT: 32,
    DataType.SHORT: 16, DataType.BYTE: 8, DataType.UBYTE: 8,
    DataType.UINT16: 16, DataType.UINT32: 32, DataType.UINT64: 64,
    DataType.BOOL: 8, DataType.UTF8: 0,
}

_ALIASES = {
    "double": DataType.DOUBLE, "float64": DataType.DOUBLE, "f64": DataType.DOUBLE,
    "float": DataType.FLOAT, "float32": DataType.FLOAT, "f32": DataType.FLOAT,
    "half": DataType.HALF, "float16": DataType.HALF, "f16": DataType.HALF,
    "bfloat16": DataType.BFLOAT16, "bf16": DataType.BFLOAT16,
    "long": DataType.LONG, "int64": DataType.LONG, "i64": DataType.LONG,
    "int": DataType.INT, "int32": DataType.INT, "i32": DataType.INT,
    "short": DataType.SHORT, "int16": DataType.SHORT,
    "byte": DataType.BYTE, "int8": DataType.BYTE,
    "ubyte": DataType.UBYTE, "uint8": DataType.UBYTE,
    "uint16": DataType.UINT16, "uint32": DataType.UINT32, "uint64": DataType.UINT64,
    "bool": DataType.BOOL, "utf8": DataType.UTF8, "string": DataType.UTF8,
}


def promote(a: DataType, b: DataType) -> DataType:
    """The result type of an operation on ``a`` and ``b`` (torch's
    promotion, which matches the reference's "max type" for the common
    cases)."""
    return DataType.from_any(torch.promote_types(a.torch, b.torch))
