"""The bloom filter kernels: their binding and launch counters.

`csrc/bloom_filter.cu` (its header says what it computes and what bounds
it on the card), one thread a row, a plain C interface loaded through
ctypes (`cuda_build`, built at first use). `put` copies the filter's words
and launches `bf_put` on the copy (64-bit atomicOr); `probe` launches
`bf_probe`. Neither reads anything back.

The port's entry points (`bloom_filter.bloom_filter_put`,
`bloom_filter_probe`) call these on CUDA columns and their plain versions
on CPU ones. `LAUNCHES` counts the kernel launches and `PLAIN_CALLS` the
entry points' plain runs, per op: "put", "probe".
"""
from __future__ import annotations

import ctypes

import torch

from ..columnar import Column

LAUNCHES = {"put": 0, "probe": 0}
PLAIN_CALLS = {"put": 0, "probe": 0}


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
        lib = load("bloom_filter")
        lib.bf_put.argtypes = [_P, _P, _N, _I, _N, _P, _P]
        lib.bf_probe.argtypes = [_P, _N, _I, _N, _P, _P, _P]
        lib.bf_put.restype = lib.bf_probe.restype = _I
        _LIB = lib
    return _LIB


def _inputs(words: torch.Tensor, col: Column, what: str):
    if col.device.type != "cuda" or words.device != col.device:
        raise ValueError(f"the bloom filter {what} kernel runs on a CUDA "
                         f"column and filter, got {col.device} and "
                         f"{words.device}")
    return col.data.contiguous(), torch.cuda.current_stream(
        col.device).cuda_stream


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"bloom filter kernel {what}: CUDA error {rc}")


def put(words: torch.Tensor, num_hashes: int, col: Column) -> torch.Tensor:
    """A copy of the filter's (num_longs,) int64 words with the valid rows
    of an INT64 column on the card put in."""
    data, stream = _inputs(words, col, "put")
    out = words.contiguous().clone()
    if col.length:
        valid = None if col.validity is None else col.validity.contiguous()
        _check(_lib().bf_put(data.data_ptr(),
                             None if valid is None else valid.data_ptr(),
                             col.length, num_hashes, out.numel(),
                             out.data_ptr(), stream), "put")
        LAUNCHES["put"] += 1
    return out


def probe(words: torch.Tensor, num_hashes: int, col: Column) -> torch.Tensor:
    """(n,) bool: each row of an INT64 column on the card might be in the
    filter (null rows probed too; the caller keeps the validity)."""
    data, stream = _inputs(words, col, "probe")
    found = torch.empty(col.length, dtype=torch.bool, device=col.device)
    if col.length:
        words = words.contiguous()
        _check(_lib().bf_probe(data.data_ptr(), col.length, num_hashes,
                               words.numel(), words.data_ptr(),
                               found.data_ptr(), stream), "probe")
        LAUNCHES["probe"] += 1
    return found
