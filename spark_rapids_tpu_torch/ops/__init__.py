"""Relational ops of the PyTorch port (fixed-width columns).

The hash-join kernels (`join_cuda`) are imported lazily, by the kernel
registry, at the first `hash_join` dispatch.
"""
from .aggregate import groupby_aggregate
from .gather import apply_boolean_mask, take, take_table
from .join import inner_join, left_anti_join, left_semi_join
from .sort import sort_table, sorted_order

__all__ = ["groupby_aggregate", "apply_boolean_mask", "take", "take_table",
           "inner_join", "left_anti_join", "left_semi_join", "sort_table",
           "sorted_order"]
