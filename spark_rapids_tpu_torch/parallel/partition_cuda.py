"""The shuffle bucket histogram: a CUDA kernel and its plain version.

Counterpart of `spark_rapids_tpu/parallel/partition_pallas.py`. The kernel
lives in `ops/csrc/partition_hist.cu` (its header says what it computes and
what bounds it on the card); this module binds it through ctypes.

- `histogram_plain`: the reference's blocked compare-and-reduce
  (`partition.partition_histogram`) in plain PyTorch;
- `histogram_cuda`: the kernel, on CUDA tensors only, for any number of
  buckets (the reference's `histogram_pallas` stops at 128).

`partition.partition_histogram` dispatches between them by the tensor's
device. Both return (P,) int32 counts and never count an id outside
[0, P). `LAUNCHES` counts kernel launches, `PLAIN_CALLS` the plain
version's runs in `partition_histogram`.
"""
from __future__ import annotations

import ctypes

import torch

_BLOCK = 65536           # rows per compare-and-reduce block
_MAX_BUCKETS = 2 ** 31 - 1   # the kernel's bucket count is a C int

LAUNCHES = {"histogram": 0}
PLAIN_CALLS = {"histogram": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def histogram_plain(part: torch.Tensor, num_partitions: int,
                    block_rows: int = _BLOCK) -> torch.Tensor:
    """(P,) int32 bucket counts: per block of rows, compare every id with
    every bucket and sum the matches."""
    buckets = torch.arange(num_partitions, dtype=torch.int32,
                           device=part.device)
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=part.device)
    p32 = part.to(torch.int32)
    for start in range(0, p32.shape[0], block_rows):
        blk = p32[start:start + block_rows]
        counts += (blk[:, None] == buckets[None, :]).sum(0,
                                                         dtype=torch.int32)
    return counts


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..ops.cuda_build import load
        lib = load("partition_hist")
        lib.ph_histogram.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.ph_histogram.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def histogram_cuda(part: torch.Tensor, num_partitions: int) -> torch.Tensor:
    if not 0 <= num_partitions <= _MAX_BUCKETS:
        raise ValueError(f"the histogram kernel takes 0 to {_MAX_BUCKETS} "
                         f"buckets, got {num_partitions}")
    if part.device.type != "cuda":
        raise ValueError(f"the histogram kernel runs on CUDA tensors, got "
                         f"{part.device}")
    if part.dtype != torch.int32 or part.dim() != 1 or \
            not part.is_contiguous():
        raise TypeError("the histogram kernel takes a contiguous (n,) int32 "
                        "tensor of partition ids")
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=part.device)
    if part.shape[0] == 0 or num_partitions == 0:
        return counts
    rc = _lib().ph_histogram(part.data_ptr(), part.shape[0], num_partitions,
                             counts.data_ptr(),
                             torch.cuda.current_stream(part.device)
                             .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel: CUDA error {rc}")
    LAUNCHES["histogram"] += 1
    return counts
