"""Typed key codec for the distributed relational ops.

Counterpart of `spark_rapids_tpu/parallel/keys.py`, with the same words
bit for bit. Any key column becomes a fixed tuple of (n,) int64 key
words that ride the exchange unchanged:

- equality: two rows are equal when their word tuples are;
- order: lexicographic int64 order over the tuple is the column's sort
  order (nulls first), so the sort-based grouping and the sort-merge join
  spans work on the words;
- decodable: the column (values and validity) comes back from the words.

| dtype | words |
|---|---|
| bool/int8..64/date/timestamp/decimal32/64 | 1 (the value, sign-extended) |
| float32/float64 | 1 (total-order bits; NaN canonical, -0.0 -> +0.0) |
| decimal128 | 2 (the signed high half, the low half with its sign bit flipped) |
| string | max_bytes/8 (+1 length word), big-endian, sign bit flipped |
| any nullable column | +1 leading null-flag word (nulls first, data zeroed) |

Strings take a static `max_bytes` (a multiple of 8; the longest row when
not given, one host read). `spark_partition_hash` is Spark's murmur3_32
(seed 42) of the key tuple, GpuHashPartitioning's placement: it decodes
the words and runs the port's row hash (`ops/hash_cuda.py`, the
`rh_hash` kernel on the card, its plain version on the CPU). Fixed-width
and float keys go to the hash as INT32/INT64 bit views of the decoded
values, so that the hash normalizes nothing a second time (the reference
hashes them with `normalize_zero=False`; -0.0 hashes as +0.0 because the
encoding folded it). Float keys keep their subnormals and decode to
their exact bits, where the reference flushes the one and rounds the
other (ROADMAP queue C, deviation 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .. import dtypes
from ..columnar import Column
from ..columnar.column import make_string_column
from ..dtypes import DType, Kind

_SIGN64 = -(2 ** 63)        # XOR with the sign bit: unsigned -> signed order

_ONE_WORD_KINDS = (Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
                   Kind.DATE32, Kind.TIMESTAMP_US, Kind.TIMESTAMP_S,
                   Kind.TIMESTAMP_MS, Kind.DECIMAL32, Kind.DECIMAL64)
# the kinds Spark hashes as a 4-byte int (murmur_hash.cuh:135-167)
_FOUR_BYTE_KINDS = (Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32,
                    Kind.DATE32)
_EIGHT_BYTE_KINDS = (Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32,
                     Kind.DECIMAL64)


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """The static encoding recipe of one key column."""
    dtype: DType
    n_words: int          # data words (without the null-flag word)
    nullable: bool
    max_bytes: int = 0    # strings only: the padded byte width (8k)

    @property
    def total_words(self) -> int:
        return self.n_words + (1 if self.nullable else 0)


def _i32_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 whose low 32 bits are `lo`'s and high 32 bits `hi`'s."""
    return torch.stack([lo.to(torch.int32), hi.to(torch.int32)],
                       dim=1).view(torch.int64).reshape(-1)


def _float_order_word(col: Column) -> torch.Tensor:
    """The total-order word of a float column: NaN canonical (one group),
    -0.0 folded into +0.0, order kept. FLOAT32 bits sit in the high half,
    as the reference shifts them. A subnormal keeps its own word, as in the
    port's local sort and groupby and in Spark; the reference's `x == 0`
    runs where subnormals compare as zero (XLA on the CPU) and folds them
    into +0.0 (ROADMAP queue C, deviation 12)."""
    x = col.data
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    if col.dtype.kind == Kind.FLOAT32:
        bits = _i32_pair(torch.zeros_like(x, dtype=torch.int32),
                         x.view(torch.int32))
    else:
        bits = x.view(torch.int64)
    # IEEE total order: negative floats reverse, positive ones move up;
    # then the sign flip makes the unsigned order a signed one
    return torch.where(bits < 0, ~bits, bits ^ _SIGN64) ^ _SIGN64


def _float_bits(w: torch.Tensor) -> torch.Tensor:
    """The inverse of `_float_order_word` up to the IEEE bits (int64)."""
    tot = w ^ _SIGN64
    return torch.where(tot >= 0, ~tot, tot ^ _SIGN64)


def _float_from_word(w: torch.Tensor, kind) -> torch.Tensor:
    bits = _float_bits(w)
    if kind == Kind.FLOAT32:
        return (bits >> 32).to(torch.int32).view(torch.float32)
    return bits.view(torch.float64)


def _words_from_limbs(limbs: torch.Tensor) -> List[torch.Tensor]:
    """(n, 4) LE uint32 limbs -> [signed high word, low word ^ sign]."""
    w = limbs.contiguous().view(torch.int64)
    return [w[:, 1].clone(), w[:, 0] ^ _SIGN64]


def _limbs_from_words(hi: torch.Tensor, lo_word: torch.Tensor
                      ) -> torch.Tensor:
    lo = lo_word ^ _SIGN64
    return torch.stack([lo, hi], dim=1).contiguous().view(
        torch.uint32).reshape(-1, 4)


def _padded_chars(col: Column, M: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n, M) uint8 chars, zero past each row's end; (n,) int32 lengths),
    the reference's `padded_chars(pad_to=M)`."""
    lens = col.string_lengths()
    n = col.length
    dev = col.device
    pos = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    if n == 0 or M == 0:
        return torch.zeros((n, M), dtype=torch.uint8, device=dev), lens
    chars = col.data if col.data.numel() else torch.zeros(
        1, dtype=torch.uint8, device=dev)
    idx = (col.offsets[:-1].to(torch.int64)[:, None] + pos).clamp(
        0, chars.numel() - 1)
    got = chars.index_select(0, idx.reshape(-1)).view(n, M)
    return torch.where(pos < lens[:, None].to(torch.int64), got, 0), lens


def _string_words(padded: torch.Tensor) -> List[torch.Tensor]:
    """(n, M) chars -> M/8 big-endian words with the sign bit flipped."""
    n, M = padded.shape
    w = padded.reshape(n, M // 8, 8).flip(-1).contiguous().view(
        torch.int64).reshape(n, M // 8) ^ _SIGN64
    return [w[:, i] for i in range(M // 8)]


def _unpack_string_words(wordlist: Sequence[torch.Tensor], M: int
                         ) -> torch.Tensor:
    """Words -> (n, M) uint8 chars (big-endian unpack)."""
    w = torch.stack(list(wordlist), dim=1) ^ _SIGN64
    n = w.shape[0]
    return w.contiguous().view(torch.uint8).reshape(n, -1, 8).flip(
        -1).reshape(n, -1)[:, :M]


def _strings_from_padded(padded: torch.Tensor, lengths: torch.Tensor,
                         validity: Optional[torch.Tensor]) -> Column:
    """A STRING column from padded chars and lengths (exact chars buffer;
    the total is one host read, as the reference's eager form makes)."""
    n, L = padded.shape
    lengths = lengths.to(torch.int32)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=padded.device)
    offsets[1:] = lengths.cumsum(0)
    keep = (torch.arange(L, device=padded.device)[None, :]
            < lengths[:, None])
    return make_string_column(padded[keep], offsets, validity)


def encode_key_column(col: Column, max_bytes: Optional[int] = None,
                      spec: Optional[KeySpec] = None
                      ) -> Tuple[List[torch.Tensor], KeySpec]:
    """One key column -> (its int64 words, its spec). A `spec` (the other
    join side's) forces the layout: a column without nulls under a
    nullable spec gets an all-valid flag word."""
    k = col.dtype.kind
    valid = col.null_mask
    nullable = col.validity is not None
    if spec is not None:
        if spec.dtype.kind != k:
            raise TypeError(f"spec dtype {spec.dtype} != column {col.dtype}")
        if nullable and not spec.nullable:
            raise ValueError(
                "column has nulls but the target spec is non-nullable; "
                "encode the nullable side first (its specs then force the "
                "flag word on the other side)")
        nullable = spec.nullable
        if k == Kind.STRING:
            max_bytes = spec.max_bytes
    if k in _ONE_WORD_KINDS:
        words = [col.data.to(torch.int64)]
        spec = KeySpec(col.dtype, 1, nullable)
    elif k in (Kind.FLOAT32, Kind.FLOAT64):
        words = [_float_order_word(col)]
        spec = KeySpec(col.dtype, 1, nullable)
    elif k == Kind.DECIMAL128:
        words = _words_from_limbs(col.data)
        spec = KeySpec(col.dtype, 2, nullable)
    elif k == Kind.STRING:
        longest = (int(col.string_lengths().max()) if col.length else 0)
        if max_bytes is None:
            max_bytes = max(8, longest)
        M = 8 * math.ceil(max_bytes / 8)
        if longest > M:
            raise ValueError(
                f"pad_to={M} is smaller than the longest string ({longest})")
        padded, lens = _padded_chars(col, M)
        padded = torch.where(valid[:, None], padded, 0)
        lens = torch.where(valid, lens, 0)
        words = _string_words(padded)
        words.append(lens.to(torch.int64))       # prefix-equal tiebreak
        spec = KeySpec(col.dtype, M // 8 + 1, nullable, max_bytes=M)
    else:
        raise TypeError(f"unsupported distributed key dtype {col.dtype}")
    if nullable:
        # nulls first (flag 0), their data words zeroed: one equal tuple
        words = [torch.where(valid, w, 0) for w in words]
        words.insert(0, valid.to(torch.int64))
    return words, spec


def encode_key_columns(cols: Sequence[Column],
                       max_bytes: Union[None, int,
                                        Sequence[Optional[int]]] = None,
                       specs: Optional[Sequence[KeySpec]] = None
                       ) -> Tuple[List[torch.Tensor], List[KeySpec]]:
    """Several key columns -> (the flat word list, their specs). For a
    join, encode one side, then the other with `specs=` the first's."""
    if max_bytes is None or isinstance(max_bytes, int):
        max_bytes = [max_bytes] * len(cols)
    if specs is None:
        specs = [None] * len(cols)
    words: List[torch.Tensor] = []
    out_specs: List[KeySpec] = []
    for c, mb, sp in zip(cols, max_bytes, specs):
        w, s = encode_key_column(c, mb, spec=sp)
        words.extend(w)
        out_specs.append(s)
    return words, out_specs


def decode_key_columns(words: Sequence[torch.Tensor],
                       specs: Sequence[KeySpec],
                       alive: Optional[torch.Tensor] = None) -> List[Column]:
    """The typed key columns back from their words. `alive` (a distributed
    op's valid mask) folds into each column's validity, and the dead
    slots' words (the exchange's sentinel) are zeroed first."""
    if alive is not None:
        words = [torch.where(alive, w, 0) for w in words]
    cols: List[Column] = []
    i = 0
    for spec in specs:
        validity = None
        if spec.nullable:
            validity = words[i] != 0
            i += 1
        if alive is not None:
            validity = alive if validity is None else validity & alive
        dw = words[i:i + spec.n_words]
        i += spec.n_words
        n = int(dw[0].shape[0])
        k = spec.dtype.kind
        if k in _ONE_WORD_KINDS:
            cols.append(Column(spec.dtype, n,
                               dw[0].to(spec.dtype.storage_dtype()),
                               validity))
        elif k in (Kind.FLOAT32, Kind.FLOAT64):
            cols.append(Column(spec.dtype, n, _float_from_word(dw[0], k),
                               validity))
        elif k == Kind.DECIMAL128:
            cols.append(Column(spec.dtype, n,
                               _limbs_from_words(dw[0], dw[1]), validity))
        elif k == Kind.STRING:
            lens = dw[-1].clamp(0, spec.max_bytes).to(torch.int32)
            padded = _unpack_string_words(dw[:-1], spec.max_bytes)
            cols.append(_strings_from_padded(padded, lens, validity))
        else:
            raise TypeError(f"unsupported key spec {spec}")
    return cols


def keys_null_mask(words: Sequence[torch.Tensor],
                   specs: Sequence[KeySpec]) -> torch.Tensor:
    """(n,) bool, True where any key column is null: a NULL key never
    matches in an equi-join. Dead exchange slots carry non-zero sentinel
    words and read as not null; the alive masks exclude them."""
    null = None
    i = 0
    for spec in specs:
        if spec.nullable:
            col_null = words[i] == 0
            null = col_null if null is None else (null | col_null)
        i += spec.total_words
    if null is None:
        return torch.zeros(words[0].shape, dtype=torch.bool,
                           device=words[0].device)
    return null


def _hash_column(dw: Sequence[torch.Tensor], spec: KeySpec,
                 valid: Optional[torch.Tensor]) -> Column:
    """The column the row hash sees for one key: Spark's byte form of the
    decoded value, with `valid` as its validity."""
    k = spec.dtype.kind
    n = int(dw[0].shape[0])
    if k == Kind.STRING:
        # dead slots' sentinel lengths clip to the width (their hash is
        # never used: the exchanges route them to no peer)
        lens = dw[-1].clamp(0, spec.max_bytes).to(torch.int32)
        padded = _unpack_string_words(dw[:-1], spec.max_bytes)
        return _strings_from_padded(padded, lens, valid)
    if k == Kind.DECIMAL128:
        return Column(spec.dtype, n, _limbs_from_words(dw[0], dw[1]), valid)
    if k in _FOUR_BYTE_KINDS:
        return Column(dtypes.INT32, n, dw[0].to(torch.int32), valid)
    if k in _EIGHT_BYTE_KINDS:
        return Column(dtypes.INT64, n, dw[0], valid)
    if k == Kind.FLOAT32:
        return Column(dtypes.INT32, n,
                      (_float_bits(dw[0]) >> 32).to(torch.int32), valid)
    if k == Kind.FLOAT64:
        return Column(dtypes.INT64, n, _float_bits(dw[0]), valid)
    raise TypeError(f"unsupported fixed-width dtype {spec.dtype}")


def spark_partition_hash(words: Sequence[torch.Tensor],
                         specs: Sequence[KeySpec]) -> torch.Tensor:
    """(n,) int32 Spark murmur3_32 (seed 42) of the key tuple, straight
    off the words: GpuHashPartitioning's hash (Hash.java:40-58). A null
    key passes the running hash through, as Spark's does."""
    from ..ops import hash_cuda
    cols = []
    i = 0
    for spec in specs:
        valid = None
        if spec.nullable:
            valid = words[i] != 0
            i += 1
        cols.append(_hash_column(words[i:i + spec.n_words], spec, valid))
        i += spec.n_words
    return hash_cuda.murmur_hash3_32(cols, seed=42).data
