"""Group-by aggregate with Spark semantics.

Counterpart of `spark_rapids_tpu/ops/aggregate.py::groupby_aggregate`, in
the shape of its CPU scatter design (`_groupby_kernel_scatter`): one stable
lexicographic sort of the key operands (`sort._key_operands`, so nulls
group together and floats group by total order), run boundaries, a group
id per sorted row, then one segment reduction (`index_add_` /
`scatter_reduce_`) per aggregation. Groups come out in sorted-key order.
Float sums and means fold each group in row order, as the reference does:
`index_add_` on the CPU, the segment-sum kernel on the card
(`segment_sum_cuda`), where `index_add_`'s atomics would add in another
order.

Spark semantics: sum/min/max/mean ignore nulls and an all-null group gives
null; count counts non-nulls; size is count(*); mean is a float64 sum over
the count; integer sums widen to INT64 and wrap like Java longs.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import Kind
from .gather import take
from .segment_sum_cuda import segment_sum
from .sort import _float_total_order, _key_operands, lex_order

AGG_OPS = ("sum", "count", "min", "max", "mean", "size")

_MINMAX_KINDS = (Kind.DATE32, Kind.TIMESTAMP_US, Kind.TIMESTAMP_S,
                 Kind.TIMESTAMP_MS)


def _agg_value_dtype(op: str, dt: dtypes.DType) -> dtypes.DType:
    if op in ("count", "size"):
        return dtypes.INT64
    if op == "mean":
        return dtypes.FLOAT64
    if op == "sum":
        if dt.is_integer:
            return dtypes.INT64
        if dt.is_floating:
            return dtypes.FLOAT64
        raise TypeError(f"sum unsupported for {dt}")
    return dt


def _extreme(op: str, v: torch.Tensor, ok: torch.Tensor, seg: torch.Tensor,
             g: int) -> torch.Tensor:
    """Null-ignoring per-group min/max; floats through the total order."""
    is_float = v.is_floating_point()
    tv = _float_total_order(v) if is_float else v
    info = torch.iinfo(tv.dtype)
    ident = info.max if op == "min" else info.min
    masked = torch.where(ok, tv, torch.full_like(tv, ident))
    out = torch.full((g,), ident, dtype=tv.dtype, device=v.device)
    out.scatter_reduce_(0, seg, masked, "amin" if op == "min" else "amax")
    if is_float:
        bits = torch.where(out < 0, ~(out ^ info.min), out)
        return bits.view(v.dtype)
    return out.to(v.dtype)


# the reference's keyless float sum (`jnp.sum` on XLA CPU) folds blocks of
# this many elements
SUM_BLOCK = 32


def blocked_sum(x: torch.Tensor) -> torch.Tensor:
    """0-d sum of the (n,) float tensor `x` in the order XLA CPU gives
    `jnp.sum`, so the bits equal the reference's: up to SUM_BLOCK values
    are a left fold from +0.0. Longer vectors are padded with zeros to a
    multiple of SUM_BLOCK, half the padding (rounded down) in front, each
    block of SUM_BLOCK is a left fold from +0.0, and the block sums are
    summed the same way. Elementwise IEEE adds give the same bits on the
    CPU and on CUDA."""
    x = x.reshape(-1)
    while x.shape[0] > SUM_BLOCK:
        pad = -x.shape[0] % SUM_BLOCK
        zeros = torch.zeros(pad, dtype=x.dtype, device=x.device)
        x = torch.cat([zeros[:pad // 2], x, zeros[pad // 2:]])
        x = _fold_columns(x.view(-1, SUM_BLOCK))
    return _fold_columns(x.view(1, -1))[0]


def _fold_columns(m: torch.Tensor) -> torch.Tensor:
    """(k,) left folds of the rows of `m`, each from +0.0."""
    acc = torch.zeros(m.shape[0], dtype=m.dtype, device=m.device)
    for j in range(m.shape[1]):
        acc = acc + m[:, j]
    return acc


def float_extreme(op: str, x: torch.Tensor) -> torch.Tensor:
    """0-d min or max of the non-empty (n,) float tensor `x` as the
    reference's keyless `jnp.min`/`jnp.max` give it: -0.0 orders below
    0.0, and a NaN anywhere gives the canonical quiet NaN."""
    bits_t = torch.int32 if x.dtype == torch.float32 else torch.int64
    # no NaN reaches the order words: the NaN case is chosen below
    key = _float_total_order(torch.where(torch.isnan(x), torch.zeros_like(x),
                                         x))
    neg_zero = (x == 0) & (x.view(bits_t) < 0)
    # _float_total_order folds -0.0 into 0.0; one step below 0.0 restores it
    key = torch.where(neg_zero, key - 1, key)
    k = key.min() if op == "min" else key.max()
    info = torch.iinfo(bits_t)
    bits = torch.where(k < 0, ~(k ^ info.min), k)
    nan_bits = 0x7FC00000 if bits_t == torch.int32 else 0x7FF8000000000000
    bits = torch.where(torch.isnan(x).any(), torch.full_like(bits, nan_bits),
                       bits)
    return bits.view(x.dtype)


def groupby_aggregate(table: Table,
                      key_names: Sequence[Union[int, str]],
                      aggs: Sequence[Tuple[Union[int, str], str]]) -> Table:
    """Group by `key_names`, apply `aggs` [(column, op)] with op in
    sum|count|min|max|mean|size. Returns keys + one column per agg, named
    "op(col)", groups in key sort order."""
    keys = [table[k] for k in key_names]
    if not keys:
        raise ValueError("groupby requires at least one key column")
    operands = []
    for c in keys:
        operands.extend(_key_operands(c, True, None))
    n = table.num_rows
    dev = table.device
    order = lex_order(operands)
    boundary = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        boundary[0] = True
    for o in operands:
        s = o.index_select(0, order)
        boundary[1:] |= s[1:] != s[:-1]
    seg = torch.cumsum(boundary, 0) - 1               # group id, sorted pos
    g = int(seg[-1]) + 1 if n else 0                  # the one host sync
    first_rows = order[boundary]
    out_cols = [take(c, first_rows, _has_negative=False) for c in keys]
    names = [table.names[k] if isinstance(k, int) else k for k in key_names]
    starts = None                                     # groups' first rows

    for col_ref, op in aggs:
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregation {op!r}")
        cname = "*" if op == "size" else (
            col_ref if isinstance(col_ref, str) else table.names[col_ref])
        names.append(f"{op}({cname})")
        if op == "size":
            sizes = torch.bincount(seg, minlength=g)
            out_cols.append(Column(dtypes.INT64, g, sizes))
            continue
        c = table[col_ref]
        ok = c.null_mask.index_select(0, order)
        cnt = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
            0, seg, ok.to(torch.int64))
        if op == "count":
            out_cols.append(Column(dtypes.INT64, g, cnt))
            continue
        if not (c.dtype.is_integer or c.dtype.is_floating
                or c.dtype.kind in _MINMAX_KINDS):
            raise TypeError(f"{op} over {c.dtype} values is not supported")
        v = c.data.index_select(0, order)
        dt = _agg_value_dtype(op, c.dtype)
        if op in ("sum", "mean"):
            if v.is_floating_point() or op == "mean":
                acc = torch.where(ok, v.to(torch.float64),
                                  torch.zeros((), dtype=torch.float64,
                                              device=dev))
                if starts is None:
                    starts = torch.nonzero(boundary).reshape(-1)
                s = segment_sum(acc, seg, starts)
                if op == "mean":
                    s = s / torch.where(cnt == 0, torch.ones_like(cnt),
                                        cnt).to(torch.float64)
            else:
                acc = torch.where(ok, v.to(torch.int64),
                                  torch.zeros((), dtype=torch.int64,
                                              device=dev))
                s = torch.zeros(g, dtype=torch.int64,
                                device=dev).index_add_(0, seg, acc)
            out_cols.append(Column(dt, g, s.to(dt.storage_dtype()), cnt > 0))
            continue
        out_cols.append(Column(dt, g, _extreme(op, v, ok, seg, g), cnt > 0))
    return Table(out_cols, names)
