"""Spark-facing logical type system of the PyTorch port.

Counterpart of `spark_rapids_tpu/dtypes.py`. The `Kind` values are the
reference's own strings, so a column moves between the two packages by
kind name. Fixed-width types map 1:1 onto torch dtypes; DECIMAL32/64 are a
physical int32/int64 plus a (precision, scale) tag; DATE32 is int32 days
and TIMESTAMP_* int64 since the epoch. Strings, DECIMAL128 and nested types
are not ported yet: `storage_dtype` raises for them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Kind(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL32 = "decimal32"
    DECIMAL64 = "decimal64"
    DECIMAL128 = "decimal128"
    STRING = "string"
    DATE32 = "date32"
    TIMESTAMP_US = "timestamp"
    TIMESTAMP_S = "timestamp_s"
    TIMESTAMP_MS = "timestamp_ms"
    LIST = "list"
    STRUCT = "struct"


MAX_DEC32_PRECISION = 9
MAX_DEC64_PRECISION = 18

_STORAGE = {
    Kind.BOOL: torch.bool,
    Kind.INT8: torch.int8,
    Kind.UINT8: torch.uint8,
    Kind.INT16: torch.int16,
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.UINT64: torch.uint64,
    Kind.FLOAT32: torch.float32,
    Kind.FLOAT64: torch.float64,
    Kind.DECIMAL32: torch.int32,
    Kind.DECIMAL64: torch.int64,
    Kind.DATE32: torch.int32,
    Kind.TIMESTAMP_US: torch.int64,
    Kind.TIMESTAMP_S: torch.int64,
    Kind.TIMESTAMP_MS: torch.int64,
}


@dataclasses.dataclass(frozen=True)
class DType:
    kind: Kind
    precision: Optional[int] = None   # decimals only
    scale: Optional[int] = None       # decimals only

    @property
    def is_decimal(self) -> bool:
        return self.kind in (Kind.DECIMAL32, Kind.DECIMAL64, Kind.DECIMAL128)

    @property
    def is_integer(self) -> bool:
        return self.kind in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64)

    @property
    def is_floating(self) -> bool:
        return self.kind in (Kind.FLOAT32, Kind.FLOAT64)

    def storage_dtype(self) -> torch.dtype:
        """Physical torch dtype of the data buffer (fixed-width kinds)."""
        try:
            return _STORAGE[self.kind]
        except KeyError:
            raise TypeError(f"{self!r} columns are not ported yet "
                            "(fixed-width kinds only)") from None

    def __repr__(self):
        if self.is_decimal:
            return f"{self.kind.value}({self.precision},{self.scale})"
        return self.kind.value


BOOL = DType(Kind.BOOL)
INT8 = DType(Kind.INT8)
INT16 = DType(Kind.INT16)
INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
DATE32 = DType(Kind.DATE32)
TIMESTAMP_US = DType(Kind.TIMESTAMP_US)


def decimal(precision: int, scale: int) -> DType:
    """Decimal storage by precision, as the reference picks it."""
    if precision <= 0 or precision > MAX_DEC64_PRECISION:
        raise ValueError(f"decimal precision {precision} is not ported "
                         f"(1..{MAX_DEC64_PRECISION})")
    kind = (Kind.DECIMAL32 if precision <= MAX_DEC32_PRECISION
            else Kind.DECIMAL64)
    return DType(kind, precision=precision, scale=scale)


def from_torch(dt: torch.dtype) -> DType:
    """Logical type of an expression result's torch dtype."""
    m = {torch.bool: BOOL, torch.int8: INT8, torch.int16: INT16,
         torch.int32: INT32, torch.int64: INT64, torch.float32: FLOAT32,
         torch.float64: FLOAT64}
    try:
        return m[dt]
    except KeyError:
        raise TypeError(f"no logical dtype for torch {dt}") from None
