"""Spark/Arrow column type model (PyTorch twin of the JAX package's
``columnar/dtypes.py``).

Same types, same constants, same storage rules: DECIMAL128 is ``[n, 2]``
int64 limbs (little-endian lo/hi) and scales follow the Spark/Java
convention (value = unscaled * 10**(-scale)). The only change is that a
fixed-width type names its torch storage dtype (``torch_dtype``) where
the JAX package named a jnp dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_TORCH_OF_NP = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


@dataclasses.dataclass(frozen=True)
class DType:
    """A Spark column type.

    kind: one of bool/int/float/string/binary/decimal/timestamp/date
    bits: storage width in bits of one element (strings: 0)
    precision/scale: decimal only (Spark convention)
    """

    kind: str
    bits: int = 0
    precision: Optional[int] = None
    scale: Optional[int] = None

    @property
    def np_dtype(self) -> np.dtype:
        if self.kind == "bool":
            return np.dtype(np.int8)  # BOOL8: one byte per value, 0/1
        if self.kind in ("int", "timestamp", "date"):
            return np.dtype(f"int{self.bits}")
        if self.kind == "float":
            return np.dtype(f"float{self.bits}")
        if self.kind == "decimal":
            return np.dtype(np.int32 if self.bits == 32 else np.int64)
        raise TypeError(f"{self} has no fixed-width storage dtype")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_OF_NP[self.np_dtype]

    @property
    def is_fixed_width(self) -> bool:
        return self.kind in ("bool", "int", "float", "decimal", "timestamp", "date")

    @property
    def size_bytes(self) -> int:
        """Bytes one element occupies in the JCUDF row format."""
        if self.kind in ("string", "binary"):
            raise TypeError("variable width")
        if self.kind == "decimal" and self.bits == 128:
            return 16
        return self.bits // 8

    @property
    def num_limbs(self) -> int:
        """Trailing storage dimension: DECIMAL128 carries [n, 2] int64."""
        return 2 if (self.kind == "decimal" and self.bits == 128) else 1

    def __repr__(self) -> str:
        if self.kind == "decimal":
            return f"DECIMAL{self.bits}({self.precision},{self.scale})"
        if self.kind in ("string", "binary"):
            return self.kind.upper()
        return f"{self.kind.upper()}{self.bits}"


BOOL8 = DType("bool", 8)
INT8 = DType("int", 8)
INT16 = DType("int", 16)
INT32 = DType("int", 32)
INT64 = DType("int", 64)
FLOAT32 = DType("float", 32)
FLOAT64 = DType("float", 64)
STRING = DType("string")
BINARY = DType("binary")  # list<int8>: JCUDF row batches, raw byte blobs
TIMESTAMP_MICROS = DType("timestamp", 64)
DATE32 = DType("date", 32)


def DECIMAL128(precision: int, scale: int) -> DType:
    if not (1 <= precision <= 38):
        raise ValueError(f"DECIMAL128 precision must be in [1, 38], got {precision}")
    return DType("decimal", 128, precision, scale)


def DECIMAL32(precision: int, scale: int) -> DType:
    if not (1 <= precision <= 9):
        raise ValueError(f"DECIMAL32 precision must be in [1, 9], got {precision}")
    return DType("decimal", 32, precision, scale)


def DECIMAL64(precision: int, scale: int) -> DType:
    if not (1 <= precision <= 18):
        raise ValueError(f"DECIMAL64 precision must be in [1, 18], got {precision}")
    return DType("decimal", 64, precision, scale)


# Max decimal precision per storage width (Spark's rules, as
# cudf::detail::max_precision).
MAX_PRECISION = {32: 9, 64: 18, 128: 38}

