"""The shuffle's single-device half: Spark's partitioner and the bucketing
of rows by partition.

Counterpart of the single-device part of `spark_rapids_tpu/parallel/
shuffle.py`: `partition_ids` (`pmod(hash, P)`) and `build_partition_map`
(one stable sort plus two searchsorteds, `sort_by_partition`, which
`partition.py` shares). The mesh, the all-to-all
`exchange` and `repartition_table` wait for the distributed tier (ROADMAP
queue A item 13).
"""
from __future__ import annotations

from typing import Tuple

import torch


def partition_ids(hashes: torch.Tensor, num_partitions: int
                  ) -> torch.Tensor:
    """Spark's `pmod(hash, numPartitions)` partitioner (non-negative mod):
    (n,) int32 in [0, P). `torch.fmod` truncates toward zero like
    `lax.rem`, so a negative remainder is lifted by P; `torch.remainder`
    would follow the divisor's sign instead."""
    h = hashes.to(torch.int32)
    r = torch.fmod(h, num_partitions)
    return torch.where(r < 0, r + num_partitions, r).to(torch.int32)


def sort_by_partition(part: torch.Tensor, num_partitions: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The stable radix-partition step: (order, sorted ids, starts,
    counts), where the rows of bucket b are order[starts[b] : starts[b] +
    counts[b]] in their original order and counts are (P,) int32. Ids
    outside [0, P) sort to either end and fall in no bucket."""
    order = torch.argsort(part, stable=True)
    sorted_part = part[order].contiguous()
    buckets = torch.arange(num_partitions, dtype=part.dtype,
                           device=part.device)
    starts = torch.searchsorted(sorted_part, buckets)
    ends = torch.searchsorted(sorted_part, buckets, right=True)
    return order, sorted_part, starts, (ends - starts).to(torch.int32)


def build_partition_map(part: torch.Tensor, num_partitions: int,
                        capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket rows by partition id into fixed-capacity slots.

    Returns (gather_idx (P, capacity) int32 row indices, valid (P, capacity)
    bool, counts (P,) int32), as the reference does. Rows past `capacity`
    in a bucket are dropped (counts > capacity reports it); ids outside
    [0, P) are never placed. With no rows every slot is invalid (the
    reference's gather fails on an empty shard)."""
    n = part.shape[0]
    dev = part.device
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
    if n == 0:
        counts = torch.zeros(num_partitions, dtype=torch.int32, device=dev)
        gather_idx = torch.zeros((num_partitions, capacity),
                                 dtype=torch.int32, device=dev)
        return gather_idx, slot < counts[:, None], counts
    order, _, starts, counts = sort_by_partition(part, num_partitions)
    src = (starts[:, None] + slot).clamp(0, n - 1)
    valid = slot < counts[:, None]
    return order[src].to(torch.int32), valid, counts
