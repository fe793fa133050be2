"""Copying ops: concatenation, slices and splits, null replacement,
row-wise select and distinct rows.

Counterpart of `spark_rapids_tpu/ops/copying.py`. `concat_columns`,
`concat_tables` and `slice_table` serve the plan engine's Union, Limit and
the TopK fallback's sort-then-slice; `split_table` and `halve_table` the
split-and-retry contract; `replace_nulls`, `if_else` and `drop_duplicates`
cudf's copying surface; `dead_column` the capped join's side with no rows.
They take what the reference takes: every kind for the concat, the slices
and splits (a gather); STRING, DECIMAL128 and the
fixed-width kinds for `replace_nulls` and `if_else` (nested columns
raise); every sort-key kind for `drop_duplicates`. A concat of STRING or
LIST columns shifts each later column's offsets by the chars or child rows
before it, as the reference's does (`copying.py:28-56`). The reference
rebuilds strings through padded char matrices; the port gathers them
(`take`) from the two sides end to end, which gives the same buffers: each
output row holds its source row's bytes, a null row's included.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from ..columnar import Column, Table
from ..dtypes import Kind
from .gather import take, take_table

def concat_columns(cols: Sequence[Column]) -> Column:
    """Same-dtype columns end to end (cudf::concatenate), in one copy. The
    result has a validity when any input has one; an input without one
    counts as all valid."""
    cols = list(cols)
    if not cols:
        raise ValueError("concat requires at least one column")
    first = cols[0]
    for c in cols[1:]:
        if c.dtype != first.dtype:
            raise TypeError(f"concat dtype mismatch: {first.dtype} vs "
                            f"{c.dtype}")
    n = sum(c.length for c in cols)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.cat([c.null_mask for c in cols])
    k = first.dtype.kind
    if k == Kind.STRUCT:
        kids = tuple(concat_columns([c.children[i] for c in cols])
                     for i in range(len(first.children)))
        return Column(first.dtype, n, None, validity, None, kids)
    if k in (Kind.STRING, Kind.LIST):
        # each column's offsets shift by the chars (child rows) before it;
        # one shift a column, added on the device
        sizes = [c.data.shape[0] if k == Kind.STRING else c.offsets[-1:]
                 for c in cols]
        parts, base = [cols[0].offsets], sizes[0]
        for c, size in zip(cols[1:], sizes[1:]):
            parts.append(c.offsets[1:] + base)
            base = base + size
        offsets = torch.cat(parts).to(torch.int32)
        if k == Kind.STRING:
            return Column(first.dtype, n, torch.cat([c.data for c in cols]),
                          validity, offsets)
        child = concat_columns([c.children[0] for c in cols])
        return Column(first.dtype, n, None, validity, offsets, (child,))
    return Column(first.dtype, n, torch.cat([c.data for c in cols]),
                  validity)


def dead_column(col: Column, m: int) -> Column:
    """m rows of `col`'s dtype for slots that hold no row: zero data, empty
    strings and lists, and a validity (all null) where `col` has one, so
    that the frame's columns carry what a gather from `col` would. The
    capped join's output over a zero-row side, which has no row 0 to
    gather for its dead slots."""
    dev = col.device
    validity = (None if col.validity is None
                else torch.zeros(m, dtype=torch.bool, device=dev))
    dtype = col.dtype
    k = dtype.kind
    if k == Kind.STRUCT:
        return Column(dtype, m, None, validity, None,
                      tuple(dead_column(c, m) for c in col.children))
    offsets = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    if k == Kind.LIST:
        return Column(dtype, m, None, validity, offsets,
                      (dead_column(col.children[0], 0),))
    if k == Kind.STRING:
        return Column(dtype, m, col.data[:0], validity, offsets)
    return Column(dtype, m, torch.zeros((m,) + dtype.row_shape,
                                        dtype=col.data.dtype, device=dev),
                  validity)


def concat_tables(tables: Sequence[Table]) -> Table:
    """Tables with equal column counts end to end, column by column; the
    result takes the first table's names."""
    tables = list(tables)
    if not tables:
        raise ValueError("concat requires at least one table")
    first = tables[0]
    for t in tables[1:]:
        if t.num_columns != first.num_columns:
            raise ValueError("concat column-count mismatch")
    cols = [concat_columns([t.columns[i] for t in tables])
            for i in range(first.num_columns)]
    return Table(cols, names=first.names)


def slice_table(table: Table, start: int, end: int) -> Table:
    """Rows [start, end), clamped to the table (cudf::slice, one span)."""
    n = table.num_rows
    start = max(0, min(start, n))
    end = max(start, min(end, n))
    idx = torch.arange(start, end, dtype=torch.int64, device=table.device)
    return take_table(table, idx, _has_negative=False)


def split_table(table: Table, splits: Sequence[int]) -> List[Table]:
    """Split at row indices (cudf::split): splits [s1, s2] give [0, s1),
    [s1, s2), [s2, n); the batch split of split-and-retry."""
    n = table.num_rows
    points = [0] + [int(s) for s in splits] + [n]
    for a, b in zip(points, points[1:]):
        if a > b or b > n:
            raise ValueError(f"invalid split points {splits} for {n} rows")
    return [slice_table(table, a, b) for a, b in zip(points, points[1:])]


def halve_table(table: Table) -> List[Table]:
    """The default split-and-retry policy: the batch in two halves."""
    return split_table(table, [table.num_rows // 2])


def _pick(lhs: Column, rhs: Column, sel: torch.Tensor) -> Column:
    """Row i of `lhs` where sel[i], else of `rhs` (STRING: its bytes and
    validity gathered from the two columns end to end)."""
    n = lhs.length
    at = torch.arange(n, dtype=torch.int64, device=sel.device)
    idx = torch.where(sel, at, at + n) if rhs.length == n else \
        torch.where(sel, at, n)
    return take(concat_columns([lhs, rhs]), idx, _has_negative=False)


def replace_nulls(col: Column, value) -> Column:
    """Nulls -> a scalar (cudf::replace_nulls; Spark coalesce(col, lit)).
    A DECIMAL128 value is its limbs, broadcast as the reference's
    `jnp.asarray(value, uint32)`."""
    if col.validity is None:
        return col
    k = col.dtype.kind
    if k == Kind.STRING:
        fill = value.encode() if isinstance(value, str) else bytes(value)
        one = Column.from_pylist([fill], col.dtype, device=col.device)
        out = _pick(col, one, col.validity)
        return Column(col.dtype, col.length, out.data, None, out.offsets)
    if k in (Kind.LIST, Kind.STRUCT):
        raise TypeError("nested replace_nulls is not supported")
    if k == Kind.DECIMAL128:
        v = torch.tensor(np.asarray(value, dtype=np.uint32).view(np.int32),
                         device=col.device)
        data = torch.where(col.validity[:, None], col.data.view(torch.int32),
                           v).view(torch.uint32)
    else:
        data = torch.where(col.validity, col.data,
                           torch.tensor(value, dtype=col.data.dtype,
                                        device=col.device))
    return Column(col.dtype, col.length, data, None)


def if_else(mask: Column, lhs: Column, rhs: Column) -> Column:
    """Row-wise select (cudf::copy_if_else). Spark CASE WHEN semantics: a
    null predicate chooses the ELSE side."""
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"if_else dtype mismatch: {lhs.dtype} vs {rhs.dtype}")
    if lhs.dtype.kind in (Kind.LIST, Kind.STRUCT):
        raise TypeError("nested if_else is not supported")
    sel = mask.data
    if mask.validity is not None:
        sel = sel & mask.validity
    if lhs.dtype.kind == Kind.STRING:
        return _pick(lhs, rhs, sel)
    validity = None
    if lhs.validity is not None or rhs.validity is not None:
        validity = torch.where(sel, lhs.null_mask, rhs.null_mask)
    if lhs.dtype.kind == Kind.DECIMAL128:
        data = torch.where(sel[:, None], lhs.data.view(torch.int32),
                           rhs.data.view(torch.int32)).view(torch.uint32)
    else:
        data = torch.where(sel, lhs.data, rhs.data)
    return Column(lhs.dtype, lhs.length, data, validity)


def drop_duplicates(table: Table,
                    key_names: Union[None, Sequence] = None) -> Table:
    """Distinct rows, keeping the first occurrence in row order
    (cudf::distinct KEEP_FIRST; Spark dropDuplicates)."""
    from .sort import _key_operands, lex_order
    keys = (list(table.columns) if key_names is None
            else [table[k] for k in key_names])
    operands = []
    for c in keys:
        operands.extend(_key_operands(c, True, None))
    n = table.num_rows
    if n == 0:
        return slice_table(table, 0, 0)
    order = lex_order(operands)
    first = torch.arange(n, device=table.device) == 0
    for o in operands:
        s = o.index_select(0, order)
        first[1:] |= s[1:] != s[:-1]
    rows = torch.sort(order[first]).values        # host sync: the count
    return take_table(table, rows, _has_negative=False)
