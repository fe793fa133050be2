"""Histograms and the percentiles over them (`Histogram`): the final
evaluation of Spark's `percentile` and `approx_percentile`.

Counterpart of `spark_rapids_tpu/ops/histogram.py` (the reference's
histogram.cu, Histogram.java:47-68):

- `create_histogram_if_valid` pairs values with INT64 frequencies (no
  nulls, none negative) into STRUCT<value, freq> rows, or LIST rows of
  one such struct. Only where some frequency is 0: a list row of it is
  empty, and a struct row's value turns null, every null value's
  frequency becoming 1. It moves data only (a mask, a cumsum and a
  compaction), so it is torch ops on either device, as `ops/gather.py`.
- `percentile_from_histogram` evaluates percentages over LIST<STRUCT<value,
  freq>> histograms: each histogram sorted ascending with nulls last, its
  counts' running sums, and for each percentage the reference's
  interpolation `(higher - position) * lo + (position - lower) * hi`
  between the elements at `lower` and `higher`, as XLA on the CPU
  computes it: the first product and the sum in one fused multiply-add,
  `fma(higher - position, lo, (position - lower) * hi)` (ROADMAP queue C
  records this). An element's index is the start of its histogram plus
  the count of running sums below the target, as the JAX package counts
  them (not a binary search: with a negative count, which this function
  does not reject, the running sums can fall).

On the card the percentile sorts the elements with three stable
`torch.sort` passes (value, null-last, histogram: the JAX package's
`lexsort((values, ~valid, labels))`) and runs the percentile kernel
(`histogram_cuda`, csrc/histogram.cu: one warp a histogram) or raises; on
CPU columns the plain version runs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import dtypes
from ..columnar import Column
from . import histogram_cuda
from .histogram_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["create_histogram_if_valid", "percentile_from_histogram",
           "LAUNCHES", "PLAIN_CALLS", "reset_counters"]

_ARITH_KINDS = {
    dtypes.Kind.INT8, dtypes.Kind.INT16, dtypes.Kind.INT32, dtypes.Kind.INT64,
    dtypes.Kind.FLOAT32, dtypes.Kind.FLOAT64, dtypes.Kind.BOOL,
    dtypes.Kind.UINT8,
}


def create_histogram_if_valid(values: Column, frequencies: Column,
                              output_as_lists: bool) -> Column:
    """Pair (values, frequencies) into STRUCT<value, freq> histogram rows
    (histogram.cu:282)."""
    if frequencies.dtype.kind != dtypes.Kind.INT64:
        raise TypeError("frequencies must be INT64")
    if frequencies.null_count():
        raise ValueError("frequencies must not have nulls")
    if values.length != frequencies.length:
        raise ValueError("values and frequencies must have the same size")
    freqs = frequencies.data
    n = values.length
    dev = freqs.device
    positive = freqs > 0
    # one host read: the least frequency and whether every one is positive
    if n:
        least, all_positive = torch.stack(
            [freqs.min(), positive.all().to(torch.int64)]).tolist()
        if least < 0:
            raise ValueError("frequencies must not contain negative values")
    any_zero = n > 0 and not all_positive

    if output_as_lists:
        # zero-frequency rows become empty lists
        sizes = positive.to(torch.int32)
        offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        torch.cumsum(sizes, 0, out=offsets[1:])
        if any_zero:
            keep = torch.nonzero(positive).reshape(-1)
            child_vals = Column(
                values.dtype, int(keep.numel()), values.data[keep],
                None if values.validity is None else values.validity[keep])
            child_freqs = Column(dtypes.INT64, int(keep.numel()), freqs[keep])
        else:
            child_vals, child_freqs = values, frequencies
        struct = Column.make_struct(value=child_vals, freq=child_freqs)
        return Column.make_list(offsets, struct)

    # the struct form, only where a frequency is 0 (histogram.cu:345): that
    # row's value turns null, and every null row's frequency 1
    # (:362-375); with every frequency positive the input passes through
    # (:416-418)
    if not any_zero:
        return Column.make_struct(value=values, freq=frequencies)
    new_valid = values.null_mask & positive
    out_freqs = torch.where(new_valid, freqs, 1)
    return Column.make_struct(
        value=Column(values.dtype, n, values.data, new_valid),
        freq=Column(dtypes.INT64, n, out_freqs))


def _check_histograms(input_col: Column):
    """(values column, counts column) of a LIST<STRUCT<value, freq>>, with
    the JAX package's errors."""
    if input_col.dtype.kind != dtypes.Kind.LIST:
        raise TypeError("input must be a LIST column")
    struct = input_col.children[0]
    if struct.dtype.kind != dtypes.Kind.STRUCT or len(struct.children) != 2:
        raise TypeError("child must be STRUCT with two children")
    if struct.null_count():
        raise ValueError("child of the input column must not have nulls")
    data_col, counts_col = struct.children
    if counts_col.dtype.kind != dtypes.Kind.INT64:
        raise TypeError("counts must be INT64")
    if counts_col.null_count():
        raise ValueError("counts must not have nulls")
    if data_col.dtype.kind not in _ARITH_KINDS:
        raise TypeError(f"unsupported histogram value type {data_col.dtype}")
    return data_col, counts_col


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = 134217729.0 * a                  # 2^27 + 1: Veltkamp's split
    hi = c - (c - a)
    return hi, a - hi


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, in float64 torch ops that each round once:
    the exact product (Dekker), its sum with c, the low parts summed with
    rounding to odd, then one rounding to nearest (Boldo and Melquiond's
    emulated FMA). Where a factor is non-finite or above 2^996, a product
    is below 2^-969 or c is non-finite, the product and sum round twice."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    s, e = _two_sum(tl, err)
    # the sum of the low parts rounded to odd: where it is inexact and its
    # last bit even, the neighbour toward the exact sum
    inexact_even = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(inexact_even, torch.nextafter(
        s, torch.where(e > 0, torch.inf, -torch.inf)), s)
    exact = (torch.isfinite(p) & torch.isfinite(c) & (a.abs() <= 2.0 ** 996)
             & (b.abs() <= 2.0 ** 996) & ((p == 0) | (p.abs() >= 2.0 ** -969)))
    return torch.where(exact, th + s, p + c)


def sort_histograms(values: torch.Tensor, valid: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the elements by (histogram, null last,
    value), ties in element order: three stable sorts, the JAX package's
    `lexsort((values, ~valid, labels))`."""
    order = torch.sort(values, stable=True).indices
    order = order[torch.sort((~valid[order]).to(torch.uint8),
                             stable=True).indices]
    return order[torch.sort(labels[order], stable=True).indices]


def element_labels(offsets: torch.Tensor, m: int) -> torch.Tensor:
    """(m,) int32 histogram of each element."""
    return (torch.searchsorted(offsets, torch.arange(
        m, dtype=torch.int32, device=offsets.device), right=True) - 1
            ).to(torch.int32)


def percentile_plain(values: torch.Tensor, valid: torch.Tensor,
                     counts: torch.Tensor, offsets: torch.Tensor,
                     pct: torch.Tensor):
    """((n_hist, n_pct) float64 percentiles, (n_hist,) validity) over m > 0
    elements: the JAX package's `_percentile_kernel` in torch ops."""
    m = values.shape[0]
    n_hist = offsets.shape[0] - 1
    labels = element_labels(offsets, m)
    order = sort_histograms(values, valid, labels)
    s_vals, s_valid = values[order], valid[order]
    s_counts, s_labels = counts[order], labels[order].to(torch.int64)
    # each histogram's inclusive running sums of its counts
    cum = torch.cumsum(s_counts, 0)
    first = offsets[:-1].to(torch.int64)
    seg_base = torch.where(first > 0, cum[(first - 1).clamp(min=0)], 0)
    acc = cum - seg_base[s_labels]

    start, try_end = first, offsets[1:].to(torch.int64)
    last_valid = s_valid[(try_end - 1).clamp(min=0)]
    end = torch.where((try_end > start) & ~last_valid, try_end - 1, try_end)
    out_valid = start < end
    max_pos = torch.where(out_valid, acc[(end - 1).clamp(min=0)] - 1, 0)
    position = max_pos.to(torch.float64)[:, None] * pct[None, :]
    lower = torch.floor(position).to(torch.int64)
    higher = torch.ceil(position).to(torch.int64)
    rows = torch.arange(m, device=values.device)
    in_range = (rows >= start[s_labels]) & (rows < end[s_labels])

    def search(target):
        """start + the count of running sums below the target in
        [start, end), a histogram."""
        below = (acc[:, None] < target[s_labels, :]) & in_range[:, None]
        cnt = torch.zeros(target.shape, dtype=torch.int64,
                          device=values.device)
        cnt.index_add_(0, s_labels, below.to(torch.int64))
        return start[:, None] + cnt

    lo_el = s_vals[search(lower + 1).clamp(0, m - 1)]
    hi_el = s_vals[search(higher + 1).clamp(0, m - 1)]
    same = (higher == lower) | (hi_el == lo_el)
    out = torch.where(same, lo_el, fma(higher.to(torch.float64) - position,
                                       lo_el, (position - lower.to(
                                           torch.float64)) * hi_el))
    out = torch.where(out_valid[:, None], out, 0.0)
    return out, out_valid


def percentile_from_histogram(input_col: Column,
                              percentages: Sequence[float],
                              output_as_list: bool) -> Column:
    """Evaluate percentiles over LIST<STRUCT<value, freq:int64>> histograms
    (histogram.cu:428): a LIST<FLOAT64> row (empty and null for a
    histogram of no valid value) a histogram, or FLOAT64 rows, n_pct a
    histogram."""
    data_col, counts_col = _check_histograms(input_col)
    n_hist = input_col.length
    n_pct = len(percentages)
    dev = input_col.device
    m = data_col.length
    if m == 0 or n_hist == 0:
        # every histogram empty: every output row null (histogram.cu:176-184)
        if output_as_list:
            return Column.make_list(
                torch.zeros(n_hist + 1, dtype=torch.int32, device=dev),
                Column(dtypes.FLOAT64, 0,
                       torch.zeros(0, dtype=torch.float64, device=dev)),
                validity=torch.zeros(n_hist, dtype=torch.bool, device=dev))
        return Column(dtypes.FLOAT64, n_hist * n_pct,
                      torch.zeros(n_hist * n_pct, dtype=torch.float64,
                                  device=dev),
                      torch.zeros(n_hist * n_pct, dtype=torch.bool,
                                  device=dev))
    pct = torch.tensor(np.asarray(percentages, np.float64), device=dev)
    values = data_col.data.to(torch.float64)
    offsets = input_col.offsets
    if dev.type == "cpu":
        PLAIN_CALLS["percentile"] += 1
        out, out_valid = percentile_plain(values, data_col.null_mask,
                                          counts_col.data, offsets, pct)
    else:
        out, out_valid = histogram_cuda.percentile(
            values, data_col.null_mask, counts_col.data, offsets, pct)
    # one host read: whether every histogram has a value
    all_valid = bool(out_valid.all())
    flat = out.reshape(-1)
    if output_as_list:
        # null histograms give empty lists
        sizes = torch.where(out_valid, n_pct, 0).to(torch.int32)
        lo = torch.zeros(n_hist + 1, dtype=torch.int32, device=dev)
        torch.cumsum(sizes, 0, out=lo[1:])
        keepers = out_valid.repeat_interleave(n_pct)
        child = flat if all_valid else flat[keepers]
        return Column.make_list(
            lo, Column(dtypes.FLOAT64, int(child.numel()), child),
            validity=None if all_valid else out_valid)
    return Column(dtypes.FLOAT64, n_hist * n_pct, flat,
                  None if all_valid else out_valid.repeat_interleave(n_pct))
