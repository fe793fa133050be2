"""Spark's bloom filter (org.apache.spark.util.sketch.BloomFilterImpl):
create, put, merge, probe, and its wire format.

Counterpart of `spark_rapids_tpu/ops/bloom_filter.py` (the reference's
bloom_filter.cu, BloomFilter.java:42-97), with Spark's semantics:

- an item's bits: h1 = murmur3_32 of the long with seed 0, h2 = murmur3_32
  of it with seed h1; for i = 1..k, combined = h1 + i * h2 (32-bit wrap),
  bit-flipped (~) where negative, and bit combined % num_bits is set;
- bit j of the filter is bit j & 63 of long j >> 6;
- the wire format: a 12-byte big-endian header {version 1, num_hashes,
  num_longs}, then the longs, each big-endian.

The JAX package keeps the filter unpacked, one uint8 lane a bit, because
XLA and the TPU have no atomics. The port keeps it packed as Spark does:
`BloomFilter.words`, (num_longs,) int64 in the wire's bit layout. On the
card `put` and `probe` run the bloom kernels (`bloom_filter_cuda`,
csrc/bloom_filter.cu: one thread a row, `put` sets its k bits with 64-bit
atomicOr) or raise; on a CPU column they run the plain versions
(`bloom_filter_put_plain`, `bloom_filter_probe_plain`: the same indexes
over int64 math, `hash.py`'s murmur3 steps). `merge` (a word OR),
`serialize` and `deserialize` (each word's bytes swapped behind the
header) are torch ops on either device, as they are XLA ops in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from . import bloom_filter_cuda
from .bloom_filter_cuda import LAUNCHES, PLAIN_CALLS, reset_counters
from .hash import _M32, _mm_value

__all__ = ["BloomFilter", "bloom_filter_create", "bloom_filter_put",
           "bloom_filter_merge", "bloom_filter_probe",
           "bloom_filter_serialize", "bloom_filter_deserialize",
           "SPARK_BLOOM_FILTER_VERSION", "HEADER_SIZE", "LAUNCHES",
           "PLAIN_CALLS", "reset_counters"]

SPARK_BLOOM_FILTER_VERSION = 1
HEADER_SIZE = 12


@dataclasses.dataclass
class BloomFilter:
    """A filter on one device: its packed bits and Spark's header fields."""
    words: torch.Tensor        # (num_longs,) int64, bit j in word j >> 6
    num_hashes: int
    num_longs: int

    @property
    def num_bits(self) -> int:
        return self.num_longs * 64

    @property
    def device(self) -> torch.device:
        return self.words.device


def bloom_filter_create(num_hashes: int, num_longs: int,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> BloomFilter:
    """A new empty filter (bloom_filter.cu:225-253); `device=None` means
    the card."""
    if num_hashes <= 0 or num_longs <= 0:
        raise ValueError("num_hashes and num_longs must be positive")
    dev = _device.resolve(device)
    return BloomFilter(torch.zeros(num_longs, dtype=torch.int64, device=dev),
                       num_hashes, num_longs)


def bit_indexes(values: torch.Tensor, num_hashes: int, num_bits: int
                ) -> torch.Tensor:
    """(n,) int64 -> (n, k) int64 bit indexes, as Spark's BloomFilterImpl
    (the JAX `_spark_bit_indexes`, bloom_filter.py:67), in int64 math."""
    zero = torch.zeros_like(values)
    h1 = _mm_value(zero, values, 8)
    h2 = _mm_value(h1, values, 8)
    i = torch.arange(1, num_hashes + 1, dtype=torch.int64,
                     device=values.device)[None, :]
    combined = (h1[:, None] + i * h2[:, None]) & _M32
    combined = torch.where(combined >= 2**31, _M32 - combined, combined)
    return combined % num_bits


def _check_input(col: Column) -> None:
    if col.dtype.kind != Kind.INT64:
        raise TypeError("bloom filter input must be INT64")


def _same_device(bf: BloomFilter, col: Column) -> None:
    if bf.device != col.device:
        raise ValueError(f"the filter is on {bf.device}, the column on "
                         f"{col.device}")


def bloom_filter_put_plain(bf: BloomFilter, col: Column) -> BloomFilter:
    idx = bit_indexes(col.data, bf.num_hashes, bf.num_bits)
    if col.validity is not None:
        idx = idx[col.validity]
    idx = torch.unique(idx.reshape(-1))
    # distinct bits of a word sum to their OR
    words = torch.zeros_like(bf.words).index_add_(
        0, idx >> 6, torch.ones_like(idx) << (idx & 63))
    return BloomFilter(bf.words | words, bf.num_hashes, bf.num_longs)


def bloom_filter_probe_plain(col: Column, bf: BloomFilter) -> Column:
    idx = bit_indexes(col.data, bf.num_hashes, bf.num_bits)
    hit = (bf.words[idx >> 6] >> (idx & 63)) & 1
    return Column(dtypes.BOOL, col.length, (hit != 0).all(1), col.validity)


def bloom_filter_put(bf: BloomFilter, col: Column,
                     sort_indices: bool = False) -> BloomFilter:
    """Insert a LONG column's valid rows; returns the updated filter
    (bloom_filter.cu:255-275); the input filter is unchanged. The JAX
    package's `sort_indices` (a sorted scatter on the TPU) is taken and
    changes nothing: the bits are the same."""
    del sort_indices
    _check_input(col)
    _same_device(bf, col)
    if col.device.type == "cpu":
        PLAIN_CALLS["put"] += 1
        return bloom_filter_put_plain(bf, col)
    return BloomFilter(bloom_filter_cuda.put(bf.words, bf.num_hashes, col),
                       bf.num_hashes, bf.num_longs)


def bloom_filter_merge(filters: Sequence[BloomFilter]) -> BloomFilter:
    """OR filters with identical parameters (bloom_filter.cu:277-337)."""
    if not filters:
        raise ValueError("requires at least one bloom filter")
    f0 = filters[0]
    for f in filters[1:]:
        if f.num_hashes != f0.num_hashes or f.num_longs != f0.num_longs:
            raise ValueError("Mismatch of bloom filter parameters")
    words = f0.words
    for f in filters[1:]:
        words = words | f.words
    return BloomFilter(words, f0.num_hashes, f0.num_longs)


def bloom_filter_probe(col: Column, bf: BloomFilter) -> Column:
    """BOOL column: True where the row might be in the filter; the input's
    validity passes through (bloom_filter.cu:339-366)."""
    _check_input(col)
    _same_device(bf, col)
    if col.device.type == "cpu":
        PLAIN_CALLS["probe"] += 1
        return bloom_filter_probe_plain(col, bf)
    return Column(dtypes.BOOL, col.length,
                  bloom_filter_cuda.probe(bf.words, bf.num_hashes, col),
                  col.validity)


# ---- Spark's wire format (big-endian; BloomFilterImpl.writeTo) --------------

def bloom_filter_serialize(bf: BloomFilter) -> torch.Tensor:
    """(12 + num_longs * 8,) uint8 on the filter's device: Spark's
    serialized form."""
    header = np.array([SPARK_BLOOM_FILTER_VERSION, bf.num_hashes,
                       bf.num_longs], dtype=">i4").view(np.uint8)
    be = bf.words.contiguous().view(torch.uint8).reshape(-1, 8).flip(1)
    return torch.cat([torch.tensor(header, device=bf.device),
                      be.reshape(-1)])


def bloom_filter_deserialize(buf, device: Optional[Union[str, torch.device]]
                             = None) -> BloomFilter:
    """A filter from Spark's serialized bytes (bytes, a uint8 array or
    tensor) on `device`: the tensor's own for a tensor, else the card when
    None."""
    if isinstance(buf, torch.Tensor):
        dev = torch.device(device) if device is not None else buf.device
        raw = buf.to(torch.uint8)
    else:
        dev = _device.resolve(device)
        raw = torch.from_numpy(np.array(
            np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray))
            else np.asarray(buf, dtype=np.uint8)))
    if raw.numel() < HEADER_SIZE:
        raise ValueError("Encountered truncated bloom filter")
    version, num_hashes, num_longs = (int(v) for v in np.frombuffer(
        raw[:HEADER_SIZE].cpu().numpy().tobytes(), ">i4"))
    if version != SPARK_BLOOM_FILTER_VERSION:
        raise ValueError("Unexpected bloom filter version")
    if num_longs <= 0:
        raise ValueError("Invalid empty bloom filter size")
    if raw.numel() != HEADER_SIZE + num_longs * 8:
        raise ValueError("Encountered invalid/mismatched bloom filter buffer "
                         "data")
    words = raw[HEADER_SIZE:].to(dev).reshape(num_longs, 8).flip(1)
    return BloomFilter(words.contiguous().view(torch.int64).reshape(-1),
                       num_hashes, num_longs)
