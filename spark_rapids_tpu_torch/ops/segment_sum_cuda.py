"""Per-group float64 sums in row order: a CUDA kernel and its plain version.

The port's own kernel (`csrc/segment_sum.cu`; its header says what it
computes and what bounds it on the card), with no TPU kernel behind it.
The reference's keyed float sum is a left fold of each group's values in
row order (`jax.ops.segment_sum` on XLA CPU). The port's CPU path,
`index_add_`, adds in that order; on a CUDA tensor `index_add_` adds with
atomics, whose order and bits change from run to run, so the card takes
this kernel instead.

- `segment_sum_plain`: `index_add_` into zeros, the row-order fold on CPU
  tensors (on a CUDA tensor its order is the atomics', which is why the
  kernel exists);
- `segment_sum_cuda`: the kernel, on CUDA tensors only.

`segment_sum` dispatches by the values' device. `LAUNCHES` counts kernel
launches, `PLAIN_CALLS` the plain version's runs in `segment_sum`. The
capped groupby passes key_cap + 1 groups: the last starts where its kept
groups end and folds the rows it drops (dead rows, groups past the cap),
so the kept groups' sums never reach them.
"""
from __future__ import annotations

import ctypes

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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("segment_sum")
        lib.ss_segment_sum.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.c_void_p, ctypes.c_void_p]
        lib.ss_segment_sum.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def segment_sum_cuda(values: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """(g,) float64: the fold of `values[starts[k]:starts[k + 1]]` (the
    last group to the end) for each of the g groups, in row order from
    +0.0. `values` is (n,) float64 sorted by group, `starts` (g,) int64
    ascending from 0."""
    if values.device.type != "cuda" or starts.device != values.device:
        raise ValueError(f"the segment-sum kernel runs on CUDA tensors, got "
                         f"{values.device} and {starts.device}")
    if values.dtype != torch.float64 or starts.dtype != torch.int64 or \
            values.dim() != 1 or starts.dim() != 1 or \
            not values.is_contiguous() or not starts.is_contiguous():
        raise TypeError("the segment-sum kernel takes contiguous (n,) float64 "
                        "values and (g,) int64 group starts")
    g = starts.shape[0]
    out = torch.empty(g, dtype=torch.float64, device=values.device)
    if g == 0:
        return out
    rc = _lib().ss_segment_sum(values.data_ptr(), starts.data_ptr(), g,
                               values.shape[0], out.data_ptr(),
                               torch.cuda.current_stream(values.device)
                               .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment-sum kernel: CUDA error {rc}")
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
