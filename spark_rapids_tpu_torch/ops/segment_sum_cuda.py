"""Per-group float64 sums in row order: the groupby kernel's fold alone,
and its plain version.

The reference's keyed float sum is a left fold of each group's values in
row order (`jax.ops.segment_sum` on XLA CPU). The port's CPU path,
`index_add_`, adds in that order; on a CUDA tensor `index_add_` adds with
atomics, whose order and bits change from run to run, so the card folds
with the groupby kernel (`csrc/groupby.cu`, its fold route; its header
says what bounds it).

- `segment_sum_plain`: `index_add_` into zeros, the row-order fold on CPU
  tensors;
- `segment_sum_cuda`: the fold route of the groupby kernel on contiguous
  key-sorted values, on CUDA tensors only.

`segment_sum` dispatches by the values' device; the plain groupby
(`aggregate._reduce_plain`) calls it on CPU tensors, and on CUDA tensors
the groupby kernel folds inside its own launch. `LAUNCHES` counts
`segment_sum_cuda`'s launches, `PLAIN_CALLS` the plain version's runs in
`segment_sum`. The capped plain groupby passes key_cap + 1 groups: the
last starts where its kept groups end and folds the rows it drops (dead
rows, groups past the cap), so the kept groups' sums never reach them.
"""
from __future__ import annotations

import torch

LAUNCHES = {"segment_sum": 0}
PLAIN_CALLS = {"segment_sum": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def segment_sum_plain(values: torch.Tensor, seg: torch.Tensor,
                      g: int) -> torch.Tensor:
    """(g,) float64: group k's values (rows where seg == k) summed in row
    order from +0.0, on a CPU tensor."""
    return torch.zeros(g, dtype=torch.float64,
                       device=values.device).index_add_(0, seg, values)


def segment_sum_cuda(values: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """(g,) float64: the fold of `values[starts[k]:starts[k + 1]]` (the
    last group to the end) for each of the g groups, in row order from
    +0.0. `values` is (n,) float64 sorted by group, `starts` (g,) int64
    ascending from 0."""
    if values.device.type != "cuda" or starts.device != values.device:
        raise ValueError(f"the segment sum runs on CUDA tensors, got "
                         f"{values.device} and {starts.device}")
    if values.dtype != torch.float64 or starts.dtype != torch.int64 or \
            values.dim() != 1 or starts.dim() != 1 or \
            not values.is_contiguous() or not starts.is_contiguous():
        raise TypeError("the segment sum takes contiguous (n,) float64 "
                        "values and (g,) int64 group starts")
    g = starts.shape[0]
    out = torch.empty(g, dtype=torch.float64, device=values.device)
    if g == 0:
        return out
    from .groupby_cuda import segment_sum_groups
    segment_sum_groups(values, starts, out)
    LAUNCHES["segment_sum"] += 1
    return out


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """(g,) float64 per-group sums in row order: `seg` is each row's group
    (ascending), `starts` each group's first row."""
    if values.device.type == "cpu":
        PLAIN_CALLS["segment_sum"] += 1
        return segment_sum_plain(values, seg, starts.shape[0])
    return segment_sum_cuda(values, starts)
