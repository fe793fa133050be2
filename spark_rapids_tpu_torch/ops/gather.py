"""Row gather (`take`) over columns and tables, and the boolean-mask filter.

Counterpart of `spark_rapids_tpu/ops/gather.py`. A fixed-width gather
takes whole rows of the data buffer, so a DECIMAL128 column's (n, 4) limbs
move as a payload through `compact()` and joins. A STRING or LIST gather
takes the gathered rows' lengths, scans them into new offsets and gathers
the chars or child rows of each span (the reference's two-pass pattern,
`gather.py:55-83`); a STRUCT gathers each field. An index of -1 yields a
null output row (cudf's out-of-bounds NULLIFY) with no chars or elements.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..columnar import Column, Table
from ..dtypes import Kind


def _rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[idx] along the rows. DECIMAL128's uint32 limbs move as int32
    bits: torch's gathers take few unsigned dtypes."""
    if data.dtype == torch.uint32:
        return data.view(torch.int32).index_select(0, idx).view(torch.uint32)
    return data.index_select(0, idx)


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
    k = col.dtype.kind
    if k == Kind.STRUCT:
        kids = tuple(take(c, idx, _has_negative=_has_negative)
                     for c in col.children)
        return Column(col.dtype, m, None, validity, None, kids)
    if k in (Kind.STRING, Kind.LIST):
        offsets, src = _spans(col.offsets, safe,
                              nullify if _has_negative else None)
        if k == Kind.STRING:
            return Column(col.dtype, m, col.data.index_select(0, src),
                          validity, offsets)
        child = take(col.children[0], src, _has_negative=False)
        return Column(col.dtype, m, None, validity, offsets, (child,))
    return Column(col.dtype, m, _rows(col.data, safe), validity)


def _spans(offsets: torch.Tensor, idx: torch.Tensor,
           empty: Optional[torch.Tensor]):
    """New (m+1,) int32 offsets of rows idx of a STRING or LIST column and
    the int64 positions in its chars or child of every gathered element,
    in order; rows where `empty` is True take none."""
    starts = offsets[:-1].index_select(0, idx).to(torch.int64)
    lens = (offsets[1:].index_select(0, idx) - offsets[:-1].index_select(
        0, idx)).to(torch.int64)
    if empty is not None:
        lens = torch.where(empty, torch.zeros_like(lens), lens)
    out = torch.zeros(idx.shape[0] + 1, dtype=torch.int64,
                      device=offsets.device)
    torch.cumsum(lens, 0, out=out[1:])
    total = int(out[-1])                      # host sync: the output size
    row = torch.repeat_interleave(
        torch.arange(idx.shape[0], device=offsets.device), lens,
        output_size=total)
    src = starts.index_select(0, row) + (
        torch.arange(total, device=offsets.device)
        - out[:-1].index_select(0, row))
    return out.to(torch.int32), src


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
