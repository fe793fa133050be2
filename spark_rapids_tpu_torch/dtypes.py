"""Spark-facing logical type system of the PyTorch port.

Counterpart of `spark_rapids_tpu/dtypes.py`. The `Kind` values are the
reference's own strings, so a column moves between the two packages by
kind name. Fixed-width types map 1:1 onto torch dtypes; DECIMAL32/64 are a
physical int32/int64 plus a (precision, scale) tag; DATE32 is int32 days
and TIMESTAMP_* int64 since the epoch. DECIMAL128 is stored as the
reference stores it: `(n, 4)` little-endian 32-bit limbs of the two's
complement value, in `torch.uint32`. STRING stores its chars as
`torch.uint8` (its offsets are int32); LIST and STRUCT have no data buffer
of their own and carry their element or field types as `children`.
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
MAX_DEC128_PRECISION = 38
DECIMAL128_LIMBS = 4               # u32 limbs a DECIMAL128 value takes

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
# storage of kinds whose rows are more than one element: (n, limbs)
_LIMB_STORAGE = {Kind.DECIMAL128: (torch.uint32, DECIMAL128_LIMBS)}
# bytes a row takes in Spark's row format (the reference's `itemsize`)
_ITEMSIZE = {Kind.BOOL: 1, Kind.INT8: 1, Kind.UINT8: 1, Kind.INT16: 2,
             Kind.INT32: 4, Kind.INT64: 8, Kind.UINT64: 8, Kind.FLOAT32: 4,
             Kind.FLOAT64: 8, Kind.DECIMAL32: 4, Kind.DECIMAL64: 8,
             Kind.DECIMAL128: 16, Kind.DATE32: 4, Kind.TIMESTAMP_US: 8,
             Kind.TIMESTAMP_S: 8, Kind.TIMESTAMP_MS: 8}


@dataclasses.dataclass(frozen=True)
class DType:
    kind: Kind
    precision: Optional[int] = None   # decimals only
    scale: Optional[int] = None       # decimals only
    children: tuple = ()              # LIST: (element,), STRUCT: (fields...)
    field_names: tuple = ()           # STRUCT only

    @property
    def is_decimal(self) -> bool:
        return self.kind in (Kind.DECIMAL32, Kind.DECIMAL64, Kind.DECIMAL128)

    @property
    def is_integer(self) -> bool:
        return self.kind in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64)

    @property
    def is_floating(self) -> bool:
        return self.kind in (Kind.FLOAT32, Kind.FLOAT64)

    @property
    def is_nested(self) -> bool:
        return self.kind in (Kind.LIST, Kind.STRUCT)

    @property
    def is_string(self) -> bool:
        return self.kind == Kind.STRING

    def storage_dtype(self) -> torch.dtype:
        """Physical torch dtype of the data buffer (STRING: its chars).
        LIST and STRUCT have no data buffer and raise TypeError."""
        if self.kind in _LIMB_STORAGE:
            return _LIMB_STORAGE[self.kind][0]
        if self.kind == Kind.STRING:
            return torch.uint8
        try:
            return _STORAGE[self.kind]
        except KeyError:
            raise TypeError(f"{self!r} columns have no data buffer") \
                from None

    @property
    def row_shape(self) -> tuple:
        """Shape of one row of the data buffer: () for the fixed-width
        kinds, (4,) for DECIMAL128's limbs."""
        if self.kind in _LIMB_STORAGE:
            return (_LIMB_STORAGE[self.kind][1],)
        return ()

    def itemsize(self) -> int:
        """Bytes a row takes in Spark's row format; fixed-width kinds only
        (KeyError otherwise, as in the reference)."""
        return _ITEMSIZE[self.kind]

    def __repr__(self):
        if self.is_decimal:
            return f"{self.kind.value}({self.precision},{self.scale})"
        if self.kind == Kind.LIST:
            return f"list<{self.children[0]!r}>"
        if self.kind == Kind.STRUCT:
            inner = ", ".join(f"{n}: {c!r}" for n, c in
                              zip(self.field_names, self.children))
            return f"struct<{inner}>"
        return self.kind.value


BOOL = DType(Kind.BOOL)
INT8 = DType(Kind.INT8)
UINT8 = DType(Kind.UINT8)
INT16 = DType(Kind.INT16)
INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
UINT64 = DType(Kind.UINT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
STRING = DType(Kind.STRING)
DATE32 = DType(Kind.DATE32)
TIMESTAMP_US = DType(Kind.TIMESTAMP_US)
TIMESTAMP_S = DType(Kind.TIMESTAMP_S)
TIMESTAMP_MS = DType(Kind.TIMESTAMP_MS)


def decimal(precision: int, scale: int) -> DType:
    """Decimal storage by precision, as the reference picks it
    (`spark_rapids_tpu/dtypes.py` `decimal`)."""
    if precision <= 0 or precision > MAX_DEC128_PRECISION:
        raise ValueError(f"invalid decimal precision {precision}")
    if precision <= MAX_DEC32_PRECISION:
        kind = Kind.DECIMAL32
    elif precision <= MAX_DEC64_PRECISION:
        kind = Kind.DECIMAL64
    else:
        kind = Kind.DECIMAL128
    return DType(kind, precision=precision, scale=scale)


def list_(element: DType) -> DType:
    return DType(Kind.LIST, children=(element,))


def struct(**fields: DType) -> DType:
    return DType(Kind.STRUCT, children=tuple(fields.values()),
                 field_names=tuple(fields.keys()))


def from_torch(dt: torch.dtype) -> DType:
    """Logical type of an expression result's torch dtype."""
    m = {torch.bool: BOOL, torch.int8: INT8, torch.int16: INT16,
         torch.int32: INT32, torch.int64: INT64, torch.float32: FLOAT32,
         torch.float64: FLOAT64}
    try:
        return m[dt]
    except KeyError:
        raise TypeError(f"no logical dtype for torch {dt}") from None
