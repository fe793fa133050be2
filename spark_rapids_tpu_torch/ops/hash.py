"""Spark-exact row hashes: murmur3_32 and xxhash64 (Spark variants), in
plain PyTorch, over every kind Spark hashes.

Counterpart of `spark_rapids_tpu/ops/hash.py`. These are the plain versions
of the row-hash kernel (`hash_cuda.py`, `csrc/row_hash.cu`) and keep the
reference's semantics:

- column chaining: the hash of column k seeds column k+1, the row seed
  starts the chain; a null value leaves the running hash unchanged;
- Spark's byte forms: bool/int8/int16/int32/date32 hash as 4 bytes
  sign-extended; int64/timestamp_us as 8 bytes; decimal32/64 as 8 bytes
  sign-extended (a Java long); DECIMAL128 as the minimal big-endian two's
  complement bytes of a Java BigDecimal (`java_bigdecimal_bytes`); a
  string as its bytes;
- floats: every NaN hashes as the canonical quiet NaN (0x7FC00000,
  0x7FF8000000000000); xxhash64 also folds -0.0 into +0.0, murmur3 does not;
- bytes: murmur3 takes 4-byte blocks, then each of the 0-3 tail bytes as a
  sign-extended signed char; xxhash64 takes 32-byte stripes from 32 bytes
  up, then 8-, 4- and 1-byte steps;
- nesting (murmur3): a STRUCT chains over its fields with its validity
  ANDed into theirs; a LIST chains over its leaf elements, nested lists
  composed, null elements skipped; a LIST of STRUCT raises TypeError.
  xxhash64 raises TypeError on nested columns (Hash.java:78).

The reference hashes bytes over a padded (rows, max_len) char matrix, a
TPU tiling device; here each step gathers the byte it needs through the
offsets, for every row at once, and loops to the longest row.

Torch on the CPU has no add, shift or compare on uint32/uint64, so all the
arithmetic is in int64. murmur3 keeps its 32-bit state in [0, 2^32) with a
mask after every step and multiplies by 16-bit halves of each constant, so
no product passes 2^48. xxhash64 uses int64's own wrap-around mod 2^64 for
add and multiply, and builds the logical right shift from the arithmetic
one and a mask. Float bits come from `Tensor.view`, which is exact, so
subnormal doubles hash as Spark hashes them (the reference computes the
bits arithmetically and XLA flushes f64 subnormals to zero).
TIMESTAMP_S/MS and the unsigned kinds raise TypeError, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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
BYTE_KINDS = (Kind.STRING, Kind.DECIMAL128)   # hashed as byte strings


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
    """TypeError for a kind Spark's hashes do not take, at any depth."""
    k = col.dtype.kind
    if k in (Kind.LIST, Kind.STRUCT):
        for c in col.children:
            _check_kind(c)
    elif k not in INT4_KINDS + INT8_KINDS + FLOAT_KINDS + BYTE_KINDS:
        raise TypeError(f"unsupported fixed-width dtype {col.dtype}")


def check_murmur_compat(col: Column) -> None:
    """LIST of STRUCT is rejected (murmur_hash.cu:163-183)."""
    if col.dtype.kind == Kind.LIST:
        if col.children[0].dtype.kind == Kind.STRUCT:
            raise TypeError("Cannot compute hash of a table with a LIST of "
                            "STRUCT columns.")
        check_murmur_compat(col.children[0])
    elif col.dtype.kind == Kind.STRUCT:
        for c in col.children:
            check_murmur_compat(c)


def encode_fixed(col: Column, normalize_zero: bool) -> Tuple[torch.Tensor,
                                                              int]:
    """((n,) int64 holding the little-endian value Spark hashes, nbytes).
    For nbytes == 4 the value is the 32-bit word, zero-extended."""
    k, d = col.dtype.kind, col.data
    if k not in INT4_KINDS + INT8_KINDS + FLOAT_KINDS:
        raise TypeError(f"unsupported fixed-width dtype {col.dtype}")
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


def _mm_value(h: torch.Tensor, v: torch.Tensor, nbytes: int
              ) -> torch.Tensor:
    """murmur3 of one 4- or 8-byte value a row: rounds over its 4-byte
    words, then fmix(h ^ nbytes)."""
    h = _mm_round(h, v & _M32)
    if nbytes == 8:
        h = _mm_round(h, _lsr64(v, 32))
    return _mm_fmix(h ^ nbytes)


def mm_column(h: torch.Tensor, col: Column) -> torch.Tensor:
    """One fixed-width column's murmur3 step over every row, validity
    ignored."""
    return _mm_value(h, *encode_fixed(col, normalize_zero=False))


# ---- byte strings -------------------------------------------------------------

class Bytes:
    """Row i's bytes are buf[start[i] : start[i] + length[i]]: a string
    column's chars through its offsets, or DECIMAL128's BigDecimal bytes."""

    def __init__(self, buf: torch.Tensor, start: torch.Tensor,
                 length: torch.Tensor):
        self.buf = buf.to(torch.int64)
        self.start = start.to(torch.int64)
        self.length = length.to(torch.int64)

    def take(self, idx: torch.Tensor) -> "Bytes":
        """The rows idx, sharing the buffer."""
        return Bytes(self.buf, self.start.index_select(0, idx),
                     self.length.index_select(0, idx))

    def max_length(self) -> int:
        return int(self.length.max()) if self.length.numel() else 0

    def byte(self, pos: torch.Tensor) -> torch.Tensor:
        """Byte pos[i] of row i as 0..255 (0 past the buffer's end)."""
        if self.buf.numel() == 0:
            return torch.zeros_like(pos)
        at = (self.start + pos).clamp(0, self.buf.numel() - 1)
        return self.buf.index_select(0, at)

    def word(self, pos: torch.Tensor, nbytes: int) -> torch.Tensor:
        """The little-endian nbytes-byte word at pos[i] of row i (int64
        wrap-around for 8 bytes)."""
        w = torch.zeros_like(pos)
        for k in range(nbytes):
            w = w | (self.byte(pos + k) << (8 * k))
        return w


def java_bigdecimal_bytes(limbs: torch.Tensor) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """DECIMAL128 (n, 4) uint32 limbs -> ((n, 16) int64 big-endian bytes,
    zero padded, (n,) int64 length): the minimal two's complement form
    java.math.BigDecimal.unscaledValue().toByteArray() produces
    (hash.cuh:54-103), as the reference computes it."""
    n = limbs.shape[0]
    w = limbs.view(torch.int32).to(torch.int64) & _M32
    shifts = torch.arange(4, device=limbs.device) * 8
    le = ((w[:, :, None] >> shifts) & 0xFF).reshape(n, 16)
    neg = (w[:, 3] >> 31).to(torch.bool)
    fill = torch.where(neg, 0xFF, 0)
    sig = le.flip(1) != fill[:, None]          # from the most significant
    first = torch.where(sig.any(1), sig.to(torch.int8).argmax(1), 16)
    length = torch.clamp(16 - first, min=1)
    top = le.gather(1, (length - 1)[:, None])[:, 0]
    # keep the sign: one more byte if the top byte's sign bit disagrees
    length = torch.where((length < 16) & (neg != (top >> 7).to(torch.bool)),
                         length + 1, length)
    j = torch.arange(16, device=limbs.device)[None, :]
    src = (length[:, None] - 1 - j).clamp(0, 15)
    be = torch.where(j < length[:, None], le.gather(1, src), 0)
    return be, length


def _byte_form(col: Column) -> Bytes:
    """The bytes Spark hashes for a STRING or DECIMAL128 column."""
    if col.dtype.is_string:
        return Bytes(col.data, col.offsets[:-1], col.string_lengths())
    be, length = java_bigdecimal_bytes(col.data)
    start = torch.arange(col.length, device=be.device) * 16
    return Bytes(be.reshape(-1), start, length)


def mm_bytes(h: torch.Tensor, b: Bytes) -> torch.Tensor:
    """Spark murmur3_32 of each row's bytes, seed h (in [0, 2^32))."""
    nblocks = b.length // 4
    for blk in range(b.max_length() // 4):
        pos = torch.full_like(b.length, 4 * blk)
        h = torch.where(blk < nblocks, _mm_round(h, b.word(pos, 4)), h)
    tail = nblocks * 4
    for j in range(3):
        pos = tail + j
        byte = b.byte(pos)
        k1 = torch.where(byte >= 128, byte - 256, byte) & _M32
        h = torch.where(pos < b.length, _mm_round(h, k1), h)
    return _mm_fmix(h ^ b.length)


def _xx_lane(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _rotl64(v + w * _P2, 31) * _P1


def _xx_merge(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (h ^ (_rotl64(v * _P2, 31) * _P1)) * _P1 + _P4


def _xx_avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr64(h, 33)
    h = h * _P2
    h = h ^ _lsr64(h, 29)
    h = h * _P3
    return h ^ _lsr64(h, 32)


def xx_bytes(h: torch.Tensor, b: Bytes) -> torch.Tensor:
    """Spark xxhash64 of each row's bytes, seed h (int64 bits)."""
    n = b.length
    nstripes = n // 32
    v = [h + _s64(_P1 + _P2), h + _P2, h, h - _P1]
    for s in range(b.max_length() // 32):
        active = s < nstripes
        for k in range(4):
            pos = torch.full_like(n, 32 * s + 8 * k)
            v[k] = torch.where(active, _xx_lane(v[k], b.word(pos, 8)), v[k])
    merged = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
              + _rotl64(v[3], 18))
    for vk in v:
        merged = _xx_merge(merged, vk)
    h = torch.where(n >= 32, merged, h + _P5) + n
    off, rem = nstripes * 32, n % 32
    for j in range(3):
        h8 = _rotl64(h ^ (_rotl64(b.word(off + 8 * j, 8) * _P2, 31) * _P1),
                     27) * _P1 + _P4
        h = torch.where(rem // 8 > j, h8, h)
    off, rem = off + (rem // 8) * 8, rem % 8
    h4 = _rotl64(h ^ (b.word(off, 4) * _P1), 23) * _P2 + _P3
    h = torch.where(rem >= 4, h4, h)
    off, rem = off + (rem // 4) * 4, rem % 4
    for j in range(3):
        h1 = _rotl64(h ^ (b.byte(off + j) * _P5), 11) * _P1
        h = torch.where(rem > j, h1, h)
    return _xx_avalanche(h)


# ---- per-column chained hashing -------------------------------------------------

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


def and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
    """The AND of two optional validities (None = all valid)."""
    if a is None or b is None:
        return b if a is None else a
    return a & b


def leaf_of_list(col: Column) -> Tuple[Column, torch.Tensor, torch.Tensor]:
    """(leaf column, (n,) int32 start, (n,) int32 end): row i's leaf
    elements are [start[i], end[i]), offsets composed through nested
    lists (murmur_hash.cu:118-131)."""
    starts, ends = col.offsets[:-1], col.offsets[1:]
    cur = col.children[0]
    while cur.dtype.kind == Kind.LIST:
        starts = cur.offsets.index_select(0, starts.to(torch.int64))
        ends = cur.offsets.index_select(0, ends.to(torch.int64))
        cur = cur.children[0]
    return cur, starts, ends


def _mm_list(col: Column, h: torch.Tensor,
             valid: Optional[torch.Tensor]) -> torch.Tensor:
    leaf, starts, ends = leaf_of_list(col)
    starts, ends = starts.to(torch.int64), ends.to(torch.int64)
    span = int((ends - starts).max()) if col.length else 0
    if leaf.dtype.kind in BYTE_KINDS:
        form = _byte_form(leaf)

        def hash_at(hh, idx):
            return mm_bytes(hh, form.take(idx))
    else:
        v, nbytes = encode_fixed(leaf, normalize_zero=False)

        def hash_at(hh, idx):
            return _mm_value(hh, v.index_select(0, idx), nbytes)
    for j in range(span):
        at = starts + j
        idx = at.clamp(0, max(leaf.length - 1, 0))
        active = at < ends
        if valid is not None:
            active = active & valid
        if leaf.validity is not None:
            active = active & leaf.validity.index_select(0, idx)
        h = torch.where(active, hash_at(h, idx), h)
    return h


def _mm_element(col: Column, h: torch.Tensor,
                parent_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """One column's murmur3 step with running hash h; rows null here or in
    a parent pass h through."""
    valid = and_valid(col.validity, parent_valid)
    k = col.dtype.kind
    if k == Kind.STRUCT:
        for c in col.children:
            h = _mm_element(c, h, valid)
        return h
    if k == Kind.LIST:
        return _mm_list(col, h, valid)
    nh = (mm_bytes(h, _byte_form(col)) if k in BYTE_KINDS
          else mm_column(h, col))
    return nh if valid is None else torch.where(valid, nh, h)


def murmur_u32(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """(n,) int64 in [0, 2^32): Spark murmur3_32 of every row, chained over
    `cols` from `seed`."""
    h = torch.full((cols[0].length,), seed & _M32, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        h = _mm_element(c, h, None)
    return h


def xx_i64(cols: Sequence[Column], seed: int) -> torch.Tensor:
    """(n,) int64 with the bits of Spark xxhash64 of every row, chained
    over `cols` from `seed`."""
    h = torch.full((cols[0].length,), _s64(seed), dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        if c.dtype.is_nested:
            raise TypeError("xxhash64 does not support nested types")
        if c.dtype.kind in BYTE_KINDS:
            nh = xx_bytes(h, _byte_form(c))
        else:
            nh = _xx_fixed(h, *encode_fixed(c, normalize_zero=True))
        h = nh if c.validity is None else torch.where(c.validity, nh, h)
    return h


def murmur_hash3_32(table: Union[Table, Column, Sequence[Column]],
                    seed: int = 0) -> Column:
    """Spark's 32-bit murmur3 hash of each row (Hash.java:40-58 parity)."""
    cols = as_columns(table)
    check_columns(cols, "Murmur3")
    for c in cols:
        check_murmur_compat(c)
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
