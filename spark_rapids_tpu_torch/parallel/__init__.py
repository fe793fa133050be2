"""The shuffle's single-device half: Spark's pmod partitioner, the
partition map, and the bucket histogram with its CUDA kernel
(`partition_cuda`). The exchange across devices waits for the distributed
tier (ROADMAP queue A item 13).
"""
from .partition import (build_partition_map_scan, partition_histogram,
                        partition_ranks)
from .shuffle import build_partition_map, partition_ids

__all__ = ["partition_ids", "build_partition_map",
           "build_partition_map_scan", "partition_histogram",
           "partition_ranks"]
