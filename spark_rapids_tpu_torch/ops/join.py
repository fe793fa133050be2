"""Equi-join gather maps with Spark null semantics: the universal fallback.

Counterpart of `spark_rapids_tpu/ops/join.py` (`inner_join`,
`left_semi_join`, `left_anti_join`). The design is the reference's: one
stable lexicographic sort over the concatenated key operands of both sides
(`sort._key_operands`, so null rank and float total order match), runs of
equal keys, and per left row the span of matchable right rows in its run.
Pairs come out in the reference's order: left row ascending, then right
row ascending. Null keys never match.

The capped tier's forms (`inner_join_capped`, `semi_join_mask`, the
reference's `:279` and `:337`) take `lalive`/`ralive` masks that exclude
rows entirely and read no size from the device: runs are counted into
buffers as long as the union, the matchable right rows are packed to the
front by a stable sort, and the pairs fill `row_cap` slots by a search
over the running counts.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column, Table
from .sort import _key_operands, lex_order

__all__ = ["inner_join", "left_semi_join", "left_anti_join",
           "inner_join_capped", "semi_join_mask"]


def _cols(keys) -> Sequence[Column]:
    if isinstance(keys, Column):
        return [keys]
    if isinstance(keys, Table):
        return list(keys.columns)
    return list(keys)


def _side_valid(cols: Sequence[Column], n: int, device) -> torch.Tensor:
    v = torch.ones(n, dtype=torch.bool, device=device)
    for c in cols:
        if c.validity is not None:
            v = v & c.validity
    return v


def _alive_valid(cols: Sequence[Column], n: int, device,
                 alive) -> torch.Tensor:
    v = _side_valid(cols, n, device)
    return v if alive is None else v & alive


def _concat(a: Column, b: Column) -> Column:
    if a.dtype != b.dtype:
        raise TypeError(f"join key dtypes differ: {a.dtype!r} vs {b.dtype!r}")
    validity = None
    if a.validity is not None or b.validity is not None:
        validity = torch.cat([a.null_mask, b.null_mask])
    return Column(a.dtype, a.length + b.length,
                  torch.cat([a.data, b.data]), validity)


def _runs(lcols, rcols, rvalid):
    """The union sort of both sides' keys: (order, run id per sorted
    position, run id per union row, matchable flag per sorted position)."""
    nl, nr = lcols[0].length, rcols[0].length
    dev = lcols[0].device
    operands = []
    for a, b in zip(lcols, rcols):
        operands.extend(_key_operands(_concat(a, b), True, None))
    order = lex_order(operands)
    boundary = torch.arange(nl + nr, device=dev) == 0
    for o in operands:
        s = o.index_select(0, order)
        boundary[1:] |= s[1:] != s[:-1]
    run = torch.cumsum(boundary, 0) - 1                 # run id, sorted pos
    run_of_row = torch.empty_like(run).scatter_(0, order, run)
    matchable = torch.cat([torch.zeros(nl, dtype=torch.bool, device=dev),
                           rvalid]).index_select(0, order)
    return order, run, run_of_row, matchable


def _check_keys(lcols, rcols) -> None:
    if len(lcols) != len(rcols) or not lcols:
        raise ValueError("join requires equal, nonzero key column counts")


def _spans(lcols, rcols):
    """-> (counts, lo, rorder): per left row the number of matching valid
    right rows and the first match's position in `rorder`, the matchable
    right row ids grouped by run (ascending row within a run)."""
    _check_keys(lcols, rcols)
    nl, nr = lcols[0].length, rcols[0].length
    dev = lcols[0].device
    if nl == 0 or nr == 0:
        z = torch.zeros(nl, dtype=torch.int64, device=dev)
        return z, z, torch.zeros(0, dtype=torch.int64, device=dev)
    lvalid = _side_valid(lcols, nl, dev)
    rvalid = _side_valid(rcols, nr, dev)
    order, run, run_of_row, matchable = _runs(lcols, rcols, rvalid)
    n_runs = int(run[-1]) + 1
    rcount = torch.bincount(run[matchable], minlength=n_runs)
    rstart = torch.cumsum(rcount, 0) - rcount
    rorder = order[matchable] - nl
    lrun = run_of_row[:nl]
    counts = torch.where(lvalid, rcount.index_select(0, lrun),
                         torch.zeros_like(lrun))
    return counts, rstart.index_select(0, lrun), rorder


def expand(counts: torch.Tensor, lo: torch.Tensor, rorder: torch.Tensor
           ) -> Tuple[Column, Column]:
    """Gather maps (left_map, right_map) from per-left-row spans."""
    nl = counts.shape[0]
    dev = counts.device
    total = int(counts.sum())                          # the one host sync
    lsel = torch.repeat_interleave(
        torch.arange(nl, dtype=torch.int64, device=dev), counts,
        output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    k = torch.arange(total, dtype=torch.int64, device=dev) \
        - starts.index_select(0, lsel)
    rmap = rorder.index_select(0, lo.index_select(0, lsel) + k)
    return (Column(dtypes.INT32, total, lsel.to(torch.int32)),
            Column(dtypes.INT32, total, rmap.to(torch.int32)))


def inner_join(left_keys, right_keys) -> Tuple[Column, Column]:
    """Gather maps (left_map, right_map) of the inner equi-join."""
    return expand(*_spans(_cols(left_keys), _cols(right_keys)))


def _keep(mask: torch.Tensor) -> Column:
    keep = torch.nonzero(mask).reshape(-1).to(torch.int32)
    return Column(dtypes.INT32, int(keep.shape[0]), keep)


def left_semi_join(left_keys, right_keys) -> Column:
    """Left rows having >=1 match (gather map into the left table)."""
    counts, _, _ = _spans(_cols(left_keys), _cols(right_keys))
    return _keep(counts > 0)


def left_anti_join(left_keys, right_keys) -> Column:
    """Left rows having no match. Rows with a null key have no match, so
    they ARE returned (cudf behaviour)."""
    counts, _, _ = _spans(_cols(left_keys), _cols(right_keys))
    return _keep(counts == 0)


def _capped_spans(lcols, rcols, lalive, ralive):
    """`_spans` with alive masks and no size read from the device: per left
    row its matches (int64) and the first one's position in `rorder`, and
    `rorder`, as long as the union, the matchable right rows packed to its
    front in run order (past them, other rows)."""
    _check_keys(lcols, rcols)
    nl, nr = lcols[0].length, rcols[0].length
    dev = lcols[0].device
    if nl == 0 or nr == 0:
        z = torch.zeros(nl, dtype=torch.int64, device=dev)
        return z, z, torch.zeros(nl + nr, dtype=torch.int64, device=dev)
    lvalid = _alive_valid(lcols, nl, dev, lalive)
    rvalid = _alive_valid(rcols, nr, dev, ralive)
    order, run, run_of_row, matchable = _runs(lcols, rcols, rvalid)
    rcount = torch.zeros(nl + nr, dtype=torch.int64, device=dev).index_add_(
        0, run, matchable.to(torch.int64))
    rstart = torch.cumsum(rcount, 0) - rcount
    pack = torch.argsort((~matchable).to(torch.int8), stable=True)
    rorder = order.index_select(0, pack) - nl
    lrun = run_of_row[:nl]
    counts = torch.where(lvalid, rcount.index_select(0, lrun),
                         torch.zeros_like(lrun))
    return counts, rstart.index_select(0, lrun), rorder


def inner_join_capped(left_keys, right_keys, row_cap: int, *,
                      lalive=None, ralive=None):
    """The inner join into `row_cap` static slots, with no host read:
    (lmap, rmap, valid, overflow). lmap and rmap are (row_cap,) int32 gather
    maps, the first row_cap pairs in the order of `inner_join`, 0 in the
    slots past the pairs; valid is (row_cap,) bool, `arange < total`;
    overflow is a () bool, total > row_cap. `lalive`/`ralive` exclude rows
    entirely."""
    lcols, rcols = _cols(left_keys), _cols(right_keys)
    counts, lo, rorder = _capped_spans(lcols, rcols, lalive, ralive)
    nl, nr = lcols[0].length, rcols[0].length
    dev = counts.device
    total = counts.sum()
    j = torch.arange(row_cap, dtype=torch.int64, device=dev)
    valid = j < total
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if nl == 0 or nr == 0:
        z = torch.zeros(row_cap, dtype=torch.int32, device=dev)
        return z, z, valid, total > row_cap
    ends = torch.cumsum(counts, 0)
    lsel = torch.searchsorted(ends, j, right=True).clamp_(max=nl - 1)
    k = j - (ends - counts).index_select(0, lsel)
    rpos = (lo.index_select(0, lsel) + k).clamp_(0, nl + nr - 1)
    rmap = rorder.index_select(0, rpos).clamp_(0, nr - 1)
    return (torch.where(valid, lsel.to(torch.int32), zero),
            torch.where(valid, rmap.to(torch.int32), zero),
            valid, total > row_cap)


def semi_join_mask(left_keys, right_keys, *, lalive=None,
                   ralive=None) -> torch.Tensor:
    """(nl,) bool: True for the live left rows with at least one live
    right match. The capped tier's semi join is a mask AND, its anti join
    `lalive & ~mask`."""
    counts, _, _ = _capped_spans(_cols(left_keys), _cols(right_keys),
                                 lalive, ralive)
    return counts > 0
