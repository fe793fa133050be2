"""Copying ops: concatenation and row slices.

Counterpart of `concat_columns`, `concat_tables` and `slice_table` in
`spark_rapids_tpu/ops/copying.py`, which serve the plan engine's Union,
Limit and the TopK fallback's sort-then-slice. Both take every kind:
`slice_table` is a gather, and a concat of STRING or LIST columns shifts
each later column's offsets by the chars or child rows before it, as the
reference's does (`copying.py:28-56`).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar import Column, Table
from ..dtypes import Kind
from .gather import take_table

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
