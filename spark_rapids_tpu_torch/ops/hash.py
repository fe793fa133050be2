"""Spark-exact row hashes over fixed-width columns: murmur3_32 and xxhash64
(Spark variants), in plain PyTorch.

Counterpart of `spark_rapids_tpu/ops/hash.py` for fixed-width columns. These
are the plain versions of the fused row-hash kernel (`hash_cuda.py`,
`csrc/row_hash.cu`) and keep the reference's semantics:

- column chaining: the hash of column k seeds column k+1, the row seed
  starts the chain; a null value leaves the running hash unchanged;
- Spark's byte forms: bool/int8/int16/int32/date32 hash as 4 bytes
  sign-extended; int64/timestamp_us as 8 bytes; decimal32/64 as 8 bytes
  sign-extended (a Java long);
- floats: every NaN hashes as the canonical quiet NaN (0x7FC00000,
  0x7FF8000000000000); xxhash64 also folds -0.0 into +0.0, murmur3 does not.

Torch on the CPU has no add, shift or compare on uint32/uint64, so all the
arithmetic is in int64. murmur3 keeps its 32-bit state in [0, 2^32) with a
mask after every step and multiplies by 16-bit halves of each constant, so
no product passes 2^48. xxhash64 uses int64's own wrap-around mod 2^64 for
add and multiply, and builds the logical right shift from the arithmetic
one and a mask. Float bits come from `Tensor.view`, which is exact, so
subnormal doubles hash as Spark hashes them (the reference computes the
bits arithmetically and XLA flushes f64 subnormals to zero).

Strings, decimal128 and nested columns are not in the port's `Column` yet
(ROADMAP queue A item 1); TIMESTAMP_S/MS and the unsigned kinds raise
TypeError, as in the reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import Kind

DEFAULT_XXHASH64_SEED = 42  # Hash.java:26

_M32 = 0xFFFFFFFF

# Spark's byte form of each fixed-width kind: 4 or 8 bytes
INT4_KINDS = (Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.DATE32)
INT8_KINDS = (Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64)
FLOAT_KINDS = (Kind.FLOAT32, Kind.FLOAT64)
_UNPORTED = (Kind.STRING, Kind.DECIMAL128, Kind.LIST, Kind.STRUCT)


def _s64(c: int) -> int:
    """The int64 with the bits of the unsigned 64-bit constant `c`."""
    c &= 2 ** 64 - 1
    return c - 2 ** 64 if c >= 2 ** 63 else c


# ---- murmur3_32: 32-bit state in int64, in [0, 2^32) -------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32): 16-bit halves of c keep every
    partial product below 2^48."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mm_round(h: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    k1 = _mul32(k1, 0xCC9E2D51)
    k1 = _rotl32(k1, 15)
    k1 = _mul32(k1, 0x1B873593)
    h = _rotl32(h ^ k1, 13)
    return (_mul32(h, 5) + 0xE6546B64) & _M32


def _mm_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def as_i32_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


# ---- xxhash64: 64-bit state in int64, wrapping mod 2^64 -----------------------

_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of the 64 bits of x by r in [1, 63]."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr64(x, 64 - r)


def _xx_fixed(h: torch.Tensor, w: torch.Tensor, nbytes: int) -> torch.Tensor:
    """xxhash64 of one 4- or 8-byte value per row with seed h (the small
    fixed-width path, xxhash64.cu:108-183). For nbytes == 4, w is the
    zero-extended 32-bit word."""
    h = h + (_P5 + nbytes)
    if nbytes == 8:
        k1 = _rotl64(w * _P2, 31) * _P1
        h = _rotl64(h ^ k1, 27) * _P1 + _P4
    else:
        h = _rotl64(h ^ (w * _P1), 23) * _P2 + _P3
    h = h ^ _lsr64(h, 33)
    h = h * _P2
    h = h ^ _lsr64(h, 29)
    h = h * _P3
    return h ^ _lsr64(h, 32)


# ---- Spark's byte forms -------------------------------------------------------

def _check_kind(col: Column) -> None:
    k = col.dtype.kind
    if k in _UNPORTED:
        raise TypeError(f"hashing {col.dtype!r} columns is not ported yet "
                        "(ROADMAP queue A item 1)")
    if k not in INT4_KINDS + INT8_KINDS + FLOAT_KINDS:
        raise TypeError(f"unsupported fixed-width dtype {col.dtype}")


def encode_fixed(col: Column, normalize_zero: bool) -> Tuple[torch.Tensor,
                                                              int]:
    """((n,) int64 holding the little-endian value Spark hashes, nbytes).
    For nbytes == 4 the value is the 32-bit word, zero-extended."""
    _check_kind(col)
    k, d = col.dtype.kind, col.data
    if k in INT4_KINDS:
        return d.to(torch.int64) & _M32, 4
    if k in INT8_KINDS:
        return d.to(torch.int64), 8
    if k == Kind.FLOAT32:
        bits = d.view(torch.int32).to(torch.int64) & _M32
        bits = torch.where(torch.isnan(d), 0x7FC00000, bits)
        if normalize_zero:
            bits = torch.where(d == 0, 0, bits)
        return bits, 4
    bits = d.view(torch.int64)
    bits = torch.where(torch.isnan(d), 0x7FF8000000000000, bits)
    if normalize_zero:
        bits = torch.where(d == 0, 0, bits)
    return bits, 8


def mm_column(h: torch.Tensor, col: Column) -> torch.Tensor:
    """One column's murmur3 step over every row, validity ignored: rounds
    over its 4-byte words, then fmix(h ^ nbytes)."""
    v, nbytes = encode_fixed(col, normalize_zero=False)
    h = _mm_round(h, v & _M32)
    if nbytes == 8:
        h = _mm_round(h, _lsr64(v, 32))
    return _mm_fmix(h ^ nbytes)


def as_columns(table: Union[Table, Column, Sequence[Column]]
               ) -> List[Column]:
    if isinstance(table, Table):
        return list(table.columns)
    if isinstance(table, Column):
        return [table]
    return list(table)


def check_columns(cols: Sequence[Column], what: str) -> None:
    if len(cols) < 1:
        raise ValueError(f"{what} hashing requires at least 1 column of "
                         "input")
    n = cols[0].length
    if any(c.length != n for c in cols):
        raise ValueError("all hashed columns must have equal length")
    for c in cols:
        _check_kind(c)


def _chain(cols: Sequence[Column], h: torch.Tensor, step) -> torch.Tensor:
    for c in cols:
        nh = step(h, c)
        h = nh if c.validity is None else torch.where(c.validity, nh, h)
    return h


def murmur_u32(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """(n,) int64 in [0, 2^32): Spark murmur3_32 of every row, chained over
    `cols` from `seed`."""
    h = torch.full((cols[0].length,), seed & _M32, dtype=torch.int64,
                   device=cols[0].device)
    return _chain(cols, h, mm_column)


def xx_i64(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """(n,) int64 with the bits of Spark xxhash64 of every row, chained
    over `cols` from `seed`."""
    h = torch.full((cols[0].length,), _s64(seed), dtype=torch.int64,
                   device=cols[0].device)

    def step(h, c):
        return _xx_fixed(h, *encode_fixed(c, normalize_zero=True))
    return _chain(cols, h, step)


def murmur_hash3_32(table: Union[Table, Column, Sequence[Column]],
                    seed: int = 0) -> Column:
    """Spark's 32-bit murmur3 hash of each row (Hash.java:40-58 parity)."""
    cols = as_columns(table)
    check_columns(cols, "Murmur3")
    n = cols[0].length
    return Column(dtypes.INT32, n, as_i32_bits(murmur_u32(cols, seed)))


def xxhash64(table: Union[Table, Column, Sequence[Column]],
             seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    """Spark's xxhash64 hash of each row, seed 42 default
    (Hash.java:60-86)."""
    cols = as_columns(table)
    check_columns(cols, "xxhash64")
    n = cols[0].length
    return Column(dtypes.INT64, n, xx_i64(cols, seed))
