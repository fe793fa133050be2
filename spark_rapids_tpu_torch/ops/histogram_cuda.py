"""The percentile kernel: its binding, launch counters and CPU mirror.

`csrc/histogram.cu` (its header says what it computes and what bounds it
on the card), one warp a histogram, a plain C interface loaded through
ctypes (`cuda_build`, built at first use). `percentile` labels the
elements by histogram, sorts them (three stable `torch.sort` passes,
`histogram.sort_histograms`), gathers the sorted values, validity and
counts, and launches `hg_percentile` once; it reads nothing back.

`percentile_mirror` follows the kernel's steps on the CPU, a histogram at
a time: the running sums scanned in 32-element chunks with a carry, the
negative-count flag, then for each percentage a binary search where the
sums never fall and a linear count where they may.

The port's entry point (`histogram.percentile_from_histogram`) calls
`percentile` on CUDA columns and its plain version on CPU ones.
`LAUNCHES` counts the kernel launches and `PLAIN_CALLS` the entry
point's plain runs, under "percentile". `create_histogram_if_valid` has
no kernel.
"""
from __future__ import annotations

import bisect
import ctypes
import math
from fractions import Fraction

import torch

LAUNCHES = {"percentile": 0}
PLAIN_CALLS = {"percentile": 0}

WARP = 32


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("histogram")
        lib.hg_percentile.argtypes = [_P, _P, _P, _P, _N, _N, _P, _I, _P, _P,
                                      _P, _P]
        lib.hg_percentile.restype = _I
        _LIB = lib
    return _LIB


def sorted_inputs(values, valid, counts, offsets):
    """The elements' values, validity and counts in (histogram, null last,
    value) order."""
    from .histogram import element_labels, sort_histograms
    labels = element_labels(offsets, values.shape[0])
    order = sort_histograms(values, valid, labels)
    return values[order], valid[order], counts[order]


def percentile(values: torch.Tensor, valid: torch.Tensor,
               counts: torch.Tensor, offsets: torch.Tensor,
               pct: torch.Tensor):
    """((n_hist, n_pct) float64 percentiles, (n_hist,) bool validity) of
    m > 0 elements on the card: float64 values, their validity, int64
    counts, (n_hist + 1,) int32 offsets and (n_pct,) float64 percentages.
    Uses the current stream."""
    dev = values.device
    if dev.type != "cuda" or any(t.device != dev for t in (valid, counts,
                                                           offsets, pct)):
        raise ValueError(f"the percentile kernel runs on CUDA tensors, got "
                         f"{dev}")
    n_hist, n_pct, m = offsets.numel() - 1, pct.numel(), values.numel()
    s_vals, s_valid, s_counts = sorted_inputs(values, valid, counts, offsets)
    acc = torch.empty(m, dtype=torch.int64, device=dev)
    out = torch.empty((n_hist, n_pct), dtype=torch.float64, device=dev)
    out_valid = torch.empty(n_hist, dtype=torch.bool, device=dev)
    if n_hist:
        rc = _lib().hg_percentile(
            s_vals.data_ptr(), s_valid.data_ptr(), s_counts.data_ptr(),
            offsets.contiguous().data_ptr(), n_hist, m, pct.data_ptr(),
            n_pct, acc.data_ptr(), out.data_ptr(), out_valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"histogram kernel: CUDA error {rc}")
        LAUNCHES["percentile"] += 1
    return out, out_valid


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once (exact rationals; specials round twice)."""
    if not all(map(math.isfinite, (a, b, c, a * b))):
        return a * b + c
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def percentile_mirror(values, valid, counts, offsets, pct):
    """The kernel's steps on CPU tensors: the same ((n_hist, n_pct),
    (n_hist,)) as the plain version."""
    s_vals, s_valid, s_counts = (t.tolist() for t in sorted_inputs(
        values, valid, counts, offsets))
    offs, pcts, m = offsets.tolist(), pct.tolist(), len(s_vals)
    out = torch.zeros((len(offs) - 1, len(pcts)), dtype=torch.float64)
    out_valid = torch.zeros(len(offs) - 1, dtype=torch.bool)
    mask = (1 << 64) - 1
    for h in range(len(offs) - 1):
        start, end = offs[h], offs[h + 1]
        if end > start and not s_valid[end - 1]:
            end -= 1
        if start >= end:
            continue
        # the warp's inclusive scan, 32 elements a step, in int64
        acc, carry, falls = [], 0, False
        for base in range(start, end, WARP):
            for j in range(base, min(base + WARP, end)):
                carry = (carry + s_counts[j]) & mask
                acc.append(carry - (1 << 64) if carry >> 63 else carry)
                falls |= s_counts[j] < 0
        max_pos = acc[-1] - 1
        for p, q in enumerate(pcts):
            position = float(max_pos) * q
            lower, higher = math.floor(position), math.ceil(position)
            idx = []
            for target in (lower + 1, higher + 1):
                cnt = (sum(a < target for a in acc) if falls
                       else bisect.bisect_left(acc, target))
                idx.append(min(max(start + cnt, 0), m - 1))
            lo, hi = s_vals[idx[0]], s_vals[idx[1]]
            out[h, p] = lo if higher == lower or hi == lo else _fma(
                higher - position, lo, (position - lower) * hi)
        out_valid[h] = True
    return out, out_valid
