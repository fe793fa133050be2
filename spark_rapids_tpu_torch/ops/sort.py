"""Table sort with Spark null/NaN semantics.

Counterpart of `spark_rapids_tpu/ops/sort.py`. Each key column becomes one
or more orderable integer operands (`_key_operands`, the encoding that sort,
groupby and join share):

- a null-rank operand first when the column has a validity mask (Spark:
  ascending puts nulls first, descending puts them last), with the payload
  zeroed under nulls so nulls tie and keep their input order;
- signed integers as they are, bool as int32;
- floats mapped to a monotone signed integer (NaN greatest, -0.0 == 0.0);
- descending as bitwise NOT, which reverses signed order without overflow.

`sorted_order` is a stable lexicographic sort: one stable argsort per
operand, least significant first, so equal rows keep their input order as
the reference's stable multi-operand `lax.sort` does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

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
                                        Sequence[Optional[str]]] = None
                 ) -> Column:
    """INT32 gather map that stably sorts `keys` lexicographically
    (cudf::stable_sorted_order)."""
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
