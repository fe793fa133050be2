"""Bucket partitioning for the shuffle: histogram, ranks and the partition
map built from them.

Counterpart of `spark_rapids_tpu/parallel/partition.py`, with the same
results bit for bit:

    histogram:  counts[b] = number of rows with part == b
    ranks:      rank[r]   = number of earlier rows in r's bucket

`partition_histogram` runs the histogram kernel (`partition_cuda`) on a
CUDA tensor, for any number of buckets, and its plain version on a CPU
tensor; `exchange_map` does the same for the exchange map of P peers on
one card (the distributed tier's bucketing and all-to-all, `shuffle.
exchange`). The reference builds the ranks and its map without a sort, by a
blocked one-hot scan; here both come from the one stable sort of
`shuffle.sort_by_partition`, which gives the same numbers.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import partition_cuda
from .shuffle import build_partition_map, sort_by_partition


def partition_histogram(part: torch.Tensor, num_partitions: int
                        ) -> torch.Tensor:
    """(P,) int32 bucket counts; ids outside [0, P) are not counted."""
    if part.device.type == "cuda":
        return partition_cuda.histogram_cuda(
            part.to(torch.int32).contiguous(), num_partitions)
    partition_cuda.PLAIN_CALLS["histogram"] += 1
    return partition_cuda.histogram_plain(part, num_partitions)


def exchange_map(part: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gidx (P, P, cap) int32, counts (P, P) int32) for (P, s) partition
    ids of P source peers: gidx[dst, src, slot] is the global row of the
    slot-th row of source src bound for dst, for slot < min(counts[src,
    dst], cap), else 0. On the card the kernel runs or the call raises;
    on the CPU the plain version runs."""
    if part.device.type == "cuda":
        return partition_cuda.exchange_map_cuda(part, capacity)
    partition_cuda.PLAIN_CALLS["exchange_map"] += 1
    return partition_cuda.exchange_map_plain(part, capacity)


def partition_ranks(part: torch.Tensor, num_partitions: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable intra-bucket rank per row ((n,) int64, 0 for ids outside
    [0, P)) and the (P,) int32 counts: the slot a stable radix partition
    gives each row."""
    n = part.shape[0]
    order, sp, starts, counts = sort_by_partition(part.to(torch.int32),
                                                  num_partitions)
    inside = (sp >= 0) & (sp < num_partitions)
    pos = torch.arange(n, dtype=torch.int64, device=part.device)
    run_start = starts[sp.clamp(0, num_partitions - 1)]
    ranks = torch.zeros(n, dtype=torch.int64, device=part.device)
    ranks[order] = torch.where(inside, pos - run_start, 0)
    return ranks, counts


def build_partition_map_scan(part: torch.Tensor, num_partitions: int,
                             capacity: int):
    """Same contract as `shuffle.build_partition_map` — (gather_idx (P,
    cap) int32, valid (P, cap) bool, counts (P,) int32) — and the same map,
    except that a slot past its bucket's count holds row 0, as the
    reference's scan map leaves it. Rows past a bucket's capacity are
    dropped and reported by counts > capacity."""
    gather_idx, valid, counts = build_partition_map(part, num_partitions,
                                                    capacity)
    return torch.where(valid, gather_idx, 0), valid, counts
