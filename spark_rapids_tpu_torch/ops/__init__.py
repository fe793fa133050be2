"""Relational ops and row hashes of the PyTorch port (fixed-width columns).

`murmur_hash3_32` and `xxhash64` run the fused row-hash kernel on a CUDA
table and the plain version on a CPU one (`hash_cuda`). The hash-join
kernels (`join_cuda`) are imported lazily, by the kernel registry, at the
first `hash_join` dispatch.
"""
from .aggregate import groupby_aggregate
from .gather import apply_boolean_mask, take, take_table
from .hash import DEFAULT_XXHASH64_SEED
from .hash_cuda import fused_row_hash, murmur_hash3_32, xxhash64
from .join import inner_join, left_anti_join, left_semi_join
from .sort import sort_table, sorted_order

__all__ = ["groupby_aggregate", "apply_boolean_mask", "take", "take_table",
           "DEFAULT_XXHASH64_SEED", "fused_row_hash", "murmur_hash3_32",
           "xxhash64", "inner_join", "left_anti_join", "left_semi_join",
           "sort_table", "sorted_order"]
