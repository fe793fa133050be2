"""Table sort with Spark null/NaN semantics.

Counterpart of `spark_rapids_tpu/ops/sort.py`. Each key column becomes one
or more orderable integer operands (`_key_operands`, the encoding that sort,
groupby and join share):

- a null-rank operand first when the column has a validity mask (Spark:
  ascending puts nulls first, descending puts them last), with the payload
  zeroed under nulls so nulls tie and keep their input order;
- signed integers as they are, bool as int32;
- floats mapped to a monotone signed integer (NaN greatest, -0.0 == 0.0);
- DECIMAL128 as two int64 words: the top 64 bits signed, then the low 64
  bits unsigned (sign bit flipped, so signed order is unsigned order), the
  order of the reference's four limb operands;
- STRING as big-endian 64-bit words of its bytes, zero padded to the
  longest string (sign bit flipped), then the byte length: Spark's
  byte-lexicographic order over unsigned bytes, shorter first on a shared
  prefix. The reference packs 32-bit words from its padded char matrix;
  the port reads the chars through the offsets, and a 64-bit word halves
  the argsort passes. The word count is one host read, the longest
  string, as the reference's `padded_chars` makes;
- descending as bitwise NOT, which reverses signed order without overflow.

`sorted_order` is a stable lexicographic sort: one stable argsort per
operand, least significant first, so equal rows keep their input order as
the reference's stable multi-operand `lax.sort` does. Given an `alive`
mask (the capped tier's), a leading operand sinks dead rows to the end
whatever their keys; `sort_table_capped` returns the sorted alive mask
with the rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import Kind
from .gather import take_table

NULLS_FIRST = "first"
NULLS_LAST = "last"

_ORDERABLE_INTS = (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
                   Kind.DATE32, Kind.TIMESTAMP_US, Kind.TIMESTAMP_S,
                   Kind.TIMESTAMP_MS, Kind.DECIMAL32, Kind.DECIMAL64)


def _float_total_order(x: torch.Tensor) -> torch.Tensor:
    """IEEE bits -> monotone signed int; NaN sorts greatest (Spark)."""
    bits_t = torch.int32 if x.dtype == torch.float32 else torch.int64
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(bits_t)
    sign_bit = torch.iinfo(bits_t).min
    return torch.where(b < 0, ~b ^ sign_bit, b)


_SIGN64 = -(2 ** 63)


def decimal128_words(limbs: torch.Tensor) -> List[torch.Tensor]:
    """(n, 4) uint32 limbs -> [top 64 bits signed, low 64 bits with the
    sign bit flipped]: two int64 operands in the order of the value."""
    w = limbs.contiguous().view(torch.int64)        # (n, 2) little-endian
    return [w[:, 1], w[:, 0] ^ _SIGN64]


def max_string_length(col: Column) -> int:
    """The longest row of a STRING column in bytes (one host read)."""
    if col.length == 0:
        return 0
    return int(col.string_lengths().max())


def string_words(col: Column, n_words: Optional[int] = None
                 ) -> List[torch.Tensor]:
    """A STRING column's big-endian 64-bit words, zero padded, each with
    its sign bit flipped (int64 order = unsigned byte order), `n_words` of
    them (default: enough for the longest row)."""
    if n_words is None:
        n_words = -(-max_string_length(col) // 8)
    n = col.length
    dev = col.device
    if n_words == 0:
        return []
    lens = col.string_lengths().to(torch.int64)
    chars = col.data
    if chars.numel() == 0:
        return [torch.full((n,), _SIGN64, dtype=torch.int64, device=dev)
                for _ in range(n_words)]
    starts = col.offsets[:-1].to(torch.int64)
    last = chars.numel() - 1
    pos = torch.arange(8, dtype=torch.int64, device=dev)
    words = []
    for i in range(n_words):
        # a word's 8 bytes in one gather, zero past the row's end; read
        # reversed, little-endian, they are the big-endian word
        at = (starts[:, None] + (8 * i + pos)).clamp_(max=last)
        b = torch.where((8 * i + pos) < lens[:, None], chars[at], 0)
        w = b.to(torch.uint8).flip(1).contiguous().view(torch.int64)
        words.append(w.reshape(n) ^ _SIGN64)
    return words


def _key_operands(col: Column, ascending: bool,
                  null_precedence: Optional[str]) -> List[torch.Tensor]:
    """Orderable operand list for one key column."""
    k = col.dtype.kind
    if k == Kind.BOOL:
        ops = [col.data.to(torch.int32)]
    elif k in _ORDERABLE_INTS:
        ops = [col.data]
    elif col.dtype.is_floating:
        ops = [_float_total_order(col.data)]
    elif k == Kind.DECIMAL128:
        ops = decimal128_words(col.data)
    elif k == Kind.STRING:
        ops = string_words(col) + [col.string_lengths()]
    else:
        raise TypeError(f"unsupported sort key dtype {col.dtype}")
    if not ascending:
        ops = [~o for o in ops]
    if col.validity is not None:
        ops = [torch.where(col.validity, o, torch.zeros_like(o)) for o in ops]
        if null_precedence is None:
            null_precedence = NULLS_FIRST if ascending else NULLS_LAST
        first = null_precedence == NULLS_FIRST
        rank = (col.validity if first else ~col.validity).to(torch.int32)
        ops.insert(0, rank)
    return ops


def lex_order(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation that stably sorts rows by `operands`
    lexicographically (first operand most significant)."""
    n = operands[0].shape[0]
    order = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for o in reversed(operands):
        order = order.index_select(
            0, torch.argsort(o.index_select(0, order), stable=True))
    return order


def sorted_order(keys: Union[Table, Sequence[Column], Column],
                 ascending: Union[bool, Sequence[bool]] = True,
                 null_precedence: Union[None, str,
                                        Sequence[Optional[str]]] = None,
                 alive: Optional[torch.Tensor] = None) -> Column:
    """INT32 gather map that stably sorts `keys` lexicographically
    (cudf::stable_sorted_order). `alive`, an (n,) bool, sinks the dead rows
    to the end whatever their keys, so the live rows are a prefix."""
    if isinstance(keys, Column):
        cols = [keys]
    elif isinstance(keys, Table):
        cols = list(keys.columns)
    else:
        cols = list(keys)
    if not cols:
        raise ValueError("sort requires at least one key column")
    nk = len(cols)
    asc = [ascending] * nk if isinstance(ascending, bool) else list(ascending)
    if null_precedence is None or isinstance(null_precedence, str):
        nulls = [null_precedence] * nk
    else:
        nulls = list(null_precedence)
    if len(asc) != nk or len(nulls) != nk:
        raise ValueError("per-key option lists must match the key count")
    operands = []
    for c, a, npred in zip(cols, asc, nulls):
        operands.extend(_key_operands(c, a, npred))
    if alive is not None:
        operands.insert(0, (~alive).to(torch.int32))
    n = cols[0].length
    order = lex_order(operands).to(torch.int32)
    return Column(dtypes.INT32, n, order)


def sort_table(table: Table,
               key_names: Optional[Sequence[Union[int, str]]] = None,
               ascending: Union[bool, Sequence[bool]] = True,
               null_precedence: Union[None, str,
                                      Sequence[Optional[str]]] = None
               ) -> Table:
    """Sort whole rows by the given key columns (cudf::sort_by_key)."""
    keys = (list(table.columns) if key_names is None
            else [table[k] for k in key_names])
    order = sorted_order(keys, ascending, null_precedence)
    return take_table(table, order.data, _has_negative=False)


def sort_table_capped(table: Table,
                      key_names: Optional[Sequence[Union[int, str]]] = None,
                      ascending: Union[bool, Sequence[bool]] = True,
                      null_precedence: Union[None, str,
                                             Sequence[Optional[str]]] = None,
                      alive: Optional[torch.Tensor] = None
                      ) -> Tuple[Table, torch.Tensor]:
    """`sort_table` for the capped tier: dead rows sink to the end whatever
    their keys. Returns (sorted table, sorted alive mask); the live rows
    are a prefix."""
    keys = (list(table.columns) if key_names is None
            else [table[k] for k in key_names])
    order = sorted_order(keys, ascending, null_precedence, alive).data
    out = take_table(table, order, _has_negative=False)
    if alive is None:
        alive = torch.ones(table.num_rows, dtype=torch.bool,
                           device=table.device)
    return out, alive.index_select(0, order)
