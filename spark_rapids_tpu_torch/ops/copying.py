"""Copying ops: row slices.

Counterpart of `slice_table` in `spark_rapids_tpu/ops/copying.py`, which
serves the plan engine's Limit and the TopK fallback's sort-then-slice.
`concat_tables` waits for Union (ROADMAP queue A item 3).
"""
from __future__ import annotations

import torch

from ..columnar import Table
from .gather import take_table


def slice_table(table: Table, start: int, end: int) -> Table:
    """Rows [start, end), clamped to the table (cudf::slice, one span)."""
    n = table.num_rows
    start = max(0, min(start, n))
    end = max(start, min(end, n))
    idx = torch.arange(start, end, dtype=torch.int64, device=table.device)
    return take_table(table, idx, _has_negative=False)
