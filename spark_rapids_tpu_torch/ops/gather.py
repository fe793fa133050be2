"""Row gather (`take`) over columns and tables, and the boolean-mask filter.

Counterpart of `spark_rapids_tpu/ops/gather.py` for fixed-width columns.
An index of -1 yields a null output row (cudf's out-of-bounds NULLIFY).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..columnar import Column, Table


def take(col: Column, idx: torch.Tensor,
         _has_negative: Optional[bool] = None) -> Column:
    """New column with rows col[idx]; idx is an (m,) int32/int64 tensor on
    the column's device, -1 gives a null row. `_has_negative` lets a
    table-level caller hoist the one sync that decides whether a validity
    mask is needed."""
    if idx.dim() != 1:
        raise ValueError("gather map must be 1-D")
    m = int(idx.shape[0])
    if _has_negative is None:
        _has_negative = m > 0 and bool((idx < 0).any())
    if _has_negative:
        nullify = idx < 0
        safe = torch.where(nullify, torch.zeros_like(idx), idx)
    else:
        safe = idx
    validity = None
    if col.validity is not None:
        validity = col.validity.index_select(0, safe)
        if _has_negative:
            validity = validity & ~nullify
    elif _has_negative:
        validity = ~nullify
    return Column(col.dtype, m, col.data.index_select(0, safe), validity)


def take_table(table: Table, idx: torch.Tensor,
               _has_negative: Optional[bool] = None) -> Table:
    if _has_negative is None:
        _has_negative = int(idx.shape[0]) > 0 and bool((idx < 0).any())
    return Table([take(c, idx, _has_negative=_has_negative)
                  for c in table.columns], names=table.names)


def apply_boolean_mask(table_or_col: Union[Table, Column],
                       m: torch.Tensor) -> Union[Table, Column]:
    """Keep rows where the (n,) bool mask is True."""
    n = (table_or_col.num_rows if isinstance(table_or_col, Table)
         else table_or_col.length)
    if tuple(m.shape) != (n,) or m.dtype != torch.bool:
        raise ValueError(f"mask {tuple(m.shape)} {m.dtype} does not match "
                         f"{n} rows of bool")
    keep = torch.nonzero(m).reshape(-1)           # host sync: result size
    if isinstance(table_or_col, Table):
        return take_table(table_or_col, keep, _has_negative=False)
    return take(table_or_col, keep, _has_negative=False)
