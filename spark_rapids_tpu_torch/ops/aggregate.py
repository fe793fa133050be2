"""Group-by aggregate with Spark semantics.

Counterpart of `spark_rapids_tpu/ops/aggregate.py::groupby_aggregate`. The
grouping and the reductions are the registry's op `groupby` (as in the
reference, whose executor stamps the choice):

- "torch", the fallback, on CPU tensors: the reference's design, one
  stable lexicographic sort of the key operands (`sort._key_operands`, so
  nulls group together and floats group by total order), run boundaries,
  a group id per sorted row, then the shape of the reference's CPU
  scatter design (`_groupby_kernel_scatter`), one segment reduction
  (`index_add_` / `scatter_reduce_`) per aggregation; float sums and means
  fold each group in row order, as the reference does (`index_add_` on
  the CPU adds in row order);
- "cuda" on CUDA tensors: the groupby kernels (`groupby_cuda`), a hash
  aggregation that sorts no input row by its keys: the rows grouped in a
  hash table, only the G groups' representatives sorted by key, every
  aggregation by group rank, bit for bit the plain version's results. On
  the card a declined call raises `KernelDeclinedError`: the plain
  version never runs there.

Groups come out in sorted-key order. Spark semantics: sum/min/max/mean
ignore nulls and an all-null group gives null; count counts non-nulls;
size is count(*); mean is a float64 sum over the count; integer sums widen
to INT64 and wrap like Java longs. Keys take every kind `sort._key_operands`
orders (STRING and DECIMAL128 included); nested keys raise.

A STRING column's min and max take the reference's design
(`aggregate.py:488-522`): the reductions count the column's non-null rows
per group (its first slot), then one value-ordered stable sort of the
column under the groups (the key operands on the plain path, each row's
group rank on the kernels'), nulls last (descending when only max is
asked), and a `take` at each group's start, or at start + count - 1 for
the max beside a min; an all-null group's row there is null. The capped
form raises for them, as the reference's capped tier does for any string
column.

`groupby_aggregate_capped` is the capped tier's form (the reference's
`:556`): the output has `key_cap` rows, a `valid` mask and an overflow
flag, and nothing reads a size from the device. An `alive` mask excludes
rows entirely. On the plain path its dead flag is the leading sort
operand, so dead rows sort last as groups of their own, which the group
count leaves out; the kept rows (live, in groups below `key_cap`) are a
prefix of the sort. The plain version gives every other row a slot of its
own past the kept groups, which is dropped, so each reduction has key_cap
+ rows slots whatever the data and the padded rows, which share their
(zeroed) keys, never pile onto one address; the float sums' group starts
end the last kept group where the kept rows end. The kernels never insert
a dead row, and reduce only the rows of the first key_cap groups in key
order into key_cap slots.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import Kind
from . import groupby_cuda
from .gather import take
from .groupby_cuda import AggSpec
from .registry import REGISTRY, KernelChoice, KernelDeclinedError
from .segment_sum_cuda import segment_sum
from .sort import NULLS_LAST, _float_total_order, _key_operands, lex_order

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
    `jnp.sum`, so the bits equal the reference's: one value is returned as
    it is (-0.0 stays -0.0), up to SUM_BLOCK values are a left fold from
    +0.0. Longer vectors are padded with zeros to a multiple of SUM_BLOCK,
    half the padding (rounded down) in front, each block of SUM_BLOCK is a
    left fold from +0.0, and the block sums are summed the same way.
    Elementwise IEEE adds give the same bits on the CPU and on CUDA."""
    x = x.reshape(-1)
    if x.shape[0] == 1:
        return x[0].clone()
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


def _is_string_extreme(op: str, c: Column) -> bool:
    return op in ("min", "max") and c.dtype.is_string


def _agg_specs(table: Table, aggs: Sequence[Tuple[Union[int, str], str]]
               ) -> List[AggSpec]:
    """The aggregations validated as the plain version raises: an unknown
    op, values of a kind the op does not take."""
    specs = []
    for col_ref, op in aggs:
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregation {op!r}")
        cname = "*" if op == "size" else (
            col_ref if isinstance(col_ref, str) else table.names[col_ref])
        if op == "size":
            specs.append(AggSpec(op, None, cname, dtypes.INT64))
            continue
        c = table[col_ref]
        if op != "count" and not (c.dtype.is_integer or c.dtype.is_floating
                                  or c.dtype.kind in _MINMAX_KINDS
                                  or _is_string_extreme(op, c)):
            raise TypeError(f"{op} over {c.dtype} values is not supported")
        specs.append(AggSpec(op, c, cname,
                             dtypes.INT64 if op == "count"
                             else _agg_value_dtype(op, c.dtype)))
    return specs


def groupby_aggregate(table: Table,
                      key_names: Sequence[Union[int, str]],
                      aggs: Sequence[Tuple[Union[int, str], str]],
                      _cap: Optional[int] = None,
                      _alive: Optional[torch.Tensor] = None,
                      choice: Optional[KernelChoice] = None):
    """Group by `key_names`, apply `aggs` [(column, op)] with op in
    sum|count|min|max|mean|size. Returns keys + one column per agg, named
    "op(col)", groups in key sort order.

    `_cap` and `_alive` are `groupby_aggregate_capped`'s: with `_cap` the
    result is (table of `_cap` rows, valid, overflow).

    The reductions are the registry's `groupby` choice: on a CPU table the
    plain scatter design below ("torch"), on a CUDA table the groupby
    kernel ("cuda", `groupby_cuda`), or `KernelDeclinedError`. A caller
    that has selected already (the plan executor, which stamps it) passes
    its `choice`."""
    keys = [table[k] for k in key_names]
    if not keys:
        raise ValueError("groupby requires at least one key column")
    for c in keys:
        if c.dtype.is_nested:
            raise TypeError("nested group keys are not supported")
    specs = _agg_specs(table, aggs)
    strings = [i for i, s in enumerate(specs)
               if _is_string_extreme(s.op, s.col)]
    if strings and _cap is not None:
        raise TypeError(
            "string min/max needs the longest string, a host read the "
            "capped tier does not make (the reference's "
            "Column.max_string_length under jit)")
    # the reductions count a string column's non-null rows where its
    # min or max goes; the value-ordered sort below picks the strings
    run_specs = [AggSpec("count", s.col, s.name, dtypes.INT64)
                 if i in strings else s for i, s in enumerate(specs)]
    dev = table.device
    if choice is None:
        choice = REGISTRY.select(
            "groupby", groupby_cuda.make_signature(
                table, aggs, "eager" if _cap is None else "capped",
                key_names), backend=dev.type)
    if choice.fallback and dev.type == "cuda":
        why = ", ".join(f"{k}: {r}" for k, r in choice.declined)
        raise KernelDeclinedError(
            f"no groupby kernel takes this call on the card "
            f"({why or 'the plain version was forced'})")
    if choice.fallback:
        operands = []
        for c in keys:
            operands.extend(_key_operands(c, True, None))
        if _alive is not None:
            operands.insert(0, (~_alive).to(torch.int32))  # dead rows last
        n = table.num_rows
        order = lex_order(operands)
        # the first row starts a group
        boundary = torch.arange(n, device=dev) == 0
        for o in operands:
            s = o.index_select(0, order)
            boundary[1:] |= s[1:] != s[:-1]
        seg = torch.cumsum(boundary, 0) - 1           # group id, sorted pos
        first_rows, agg_cols, num_groups = _reduce_plain(
            run_specs, order, boundary, seg, _cap, _alive)
        if strings:
            agg_cols = _string_extremes(specs, strings, list(agg_cols),
                                        operands,
                                        torch.nonzero(boundary).reshape(-1))
    else:
        first_rows, agg_cols, num_groups, rows = choice.fn(
            keys, run_specs, _cap, _alive, bool(strings))
        if strings:
            agg_cols = _string_extremes(specs, strings, list(agg_cols),
                                        [rows.rank], rows.starts)
    out_cols = [take(c, first_rows, _has_negative=False) for c in keys]
    out_cols += agg_cols
    names = [table.names[k] if isinstance(k, int) else k for k in key_names]
    names += [f"{s.op}({s.name})" for s in specs]
    if _cap is None:
        return Table(out_cols, names)
    valid = torch.arange(_cap, device=dev) < num_groups
    return (Table([_pad_column(c, _cap) for c in out_cols], names), valid,
            num_groups > _cap)


def _string_extremes(specs: Sequence[AggSpec], strings: Sequence[int],
                     agg_cols: List[Column], lead, starts: torch.Tensor
                     ) -> List[Column]:
    """`agg_cols` with the STRING min/max columns at `strings` filled in;
    there they hold each group's non-null count. One value-ordered sort a
    column, under the operands `lead` that order the rows by group (the
    key operands, or each row's group rank), serves all its extremes;
    `starts` are the groups' first positions in that order."""
    by_col = {}
    for i in strings:
        by_col.setdefault(specs[i].name, []).append(i)
    for idxs in by_col.values():
        c = specs[idxs[0]].col
        wants = {specs[i].op for i in idxs}
        # nulls last: a group's first row is its min (its max when only
        # max is asked, sorted descending); a null there means all-null
        vops = _key_operands(c, "min" in wants, NULLS_LAST)
        order2 = lex_order(list(lead) + vops)
        at_start = take(c, order2.index_select(0, starts),
                        _has_negative=False)
        at_last = None
        if wants == {"min", "max"}:
            cnt = agg_cols[idxs[0]].data
            last = starts + cnt.clamp(min=1) - 1
            at_last = take(c, order2.index_select(0, last),
                           _has_negative=False)
        for i in idxs:
            agg_cols[i] = at_last if (specs[i].op == "max"
                                      and at_last is not None) else at_start
    return agg_cols


def _reduce_plain(specs: Sequence[AggSpec], order: torch.Tensor,
                  boundary: torch.Tensor, seg: torch.Tensor,
                  _cap: Optional[int], _alive: Optional[torch.Tensor]):
    """The scatter design: (first rows, the aggregations' columns, live
    groups () or None), one segment reduction (`index_add_` /
    `scatter_reduce_`) per aggregation."""
    n = seg.shape[0]
    dev = seg.device
    if _cap is None or n == 0:
        g = int(seg[-1]) + 1 if n else 0              # the one host sync
        kept_groups = g
        first_rows = order[boundary]
        starts = None                                 # groups' first rows
        sum_seg = seg
    else:
        # key_cap slots for the kept groups (the live ones, up to the cap);
        # every other row, dead or past the cap, reduces into a slot of its
        # own past them, so the padded rows never pile onto one address.
        # The kept rows are a prefix of the sort: live rows sort first.
        pos = torch.arange(n, device=dev)
        kept = seg < _cap
        if _alive is not None:
            kept &= _alive.index_select(0, order)
        seg = torch.where(kept, seg, _cap + pos)
        g, kept_groups = _cap + n, _cap
        first = torch.where(boundary, seg, _cap + pos)  # one row a slot
        first_rows = torch.full((g,), n - 1, dtype=torch.int64, device=dev
                                ).scatter_(0, first, order)[:_cap]
        # ascending: an empty slot starts where the kept rows end, and the
        # spare group after the last one folds the rest, which is dropped
        end = kept.sum()
        starts = torch.cat([torch.minimum(
            torch.full((g,), n, dtype=torch.int64, device=dev
                       ).scatter_(0, first, pos)[:_cap], end),
            end.reshape(1)])
        sum_seg = seg.clamp(max=_cap)

    def kept(x):
        return x[:kept_groups]

    out_cols = []
    for spec in specs:
        op = spec.op
        if op == "size":
            sizes = (torch.bincount(seg, minlength=g) if _cap is None else
                     torch.zeros(g, dtype=torch.int64, device=dev)
                     .index_add_(0, seg, torch.ones_like(seg)))
            out_cols.append(Column(dtypes.INT64, kept_groups, kept(sizes)))
            continue
        c = spec.col
        ok = c.null_mask.index_select(0, order)
        cnt = kept(torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
            0, seg, ok.to(torch.int64)))
        if op == "count":
            out_cols.append(Column(dtypes.INT64, kept_groups, cnt))
            continue
        v = c.data.index_select(0, order)
        dt = spec.dtype
        if op in ("sum", "mean"):
            if v.is_floating_point() or op == "mean":
                acc = torch.where(ok, v.to(torch.float64),
                                  torch.zeros((), dtype=torch.float64,
                                              device=dev))
                if starts is None:
                    starts = torch.nonzero(boundary).reshape(-1)
                s = kept(segment_sum(acc, sum_seg, starts))
                if op == "mean":
                    s = s / torch.where(cnt == 0, torch.ones_like(cnt),
                                        cnt).to(torch.float64)
            else:
                acc = torch.where(ok, v.to(torch.int64),
                                  torch.zeros((), dtype=torch.int64,
                                              device=dev))
                s = kept(torch.zeros(g, dtype=torch.int64,
                                     device=dev).index_add_(0, seg, acc))
            out_cols.append(Column(dt, kept_groups, s.to(dt.storage_dtype()),
                                   cnt > 0))
            continue
        out_cols.append(Column(dt, kept_groups,
                               kept(_extreme(op, v, ok, seg, g)), cnt > 0))
    if _cap is None:
        return first_rows, out_cols, None
    live = boundary if _alive is None else \
        boundary & _alive.index_select(0, order)
    return first_rows, out_cols, live.sum()


def _pad_column(col: Column, to: int) -> Column:
    """`col` cut or padded to `to` rows; padded rows are zero and null
    (the capped contract: rows past the group count are masked by the
    caller's valid vector)."""
    n = col.length
    if n >= to:
        return Column(col.dtype, to, col.data[:to],
                      None if col.validity is None else col.validity[:to])
    extra = to - n
    data = torch.cat([col.data, torch.zeros(extra, dtype=col.data.dtype,
                                            device=col.device)])
    validity = None
    if col.validity is not None:
        validity = torch.cat([col.validity,
                              torch.zeros(extra, dtype=torch.bool,
                                          device=col.device)])
    return Column(col.dtype, to, data, validity)


def groupby_aggregate_capped(table: Table,
                             key_names: Sequence[Union[int, str]],
                             aggs: Sequence[Tuple[Union[int, str], str]],
                             key_cap: int,
                             alive: Optional[torch.Tensor] = None,
                             choice: Optional[KernelChoice] = None):
    """`groupby_aggregate` with a static `key_cap` output size instead of
    the group-count host read: (table of key_cap rows, valid (key_cap,)
    bool, overflow () bool). Rows past the group count are not defined and
    masked by `valid`; overflow means key_cap was too small. `alive`, an
    (n,) bool, excludes rows entirely (not as nulls: the row is not
    there). `choice` is as for `groupby_aggregate`."""
    return groupby_aggregate(table, key_names, aggs, _cap=key_cap,
                             _alive=alive, choice=choice)
