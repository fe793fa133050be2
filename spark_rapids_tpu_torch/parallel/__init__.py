"""The shuffle and the distributed tier: Spark's pmod partitioner, the
partition map and histogram (with their CUDA kernels, `partition_cuda`),
the mesh of P peers on one device and its exchange (`shuffle`), the typed
key codec (`keys`), the distributed relational ops (`relational`) and the
overflow retry with its `distributed_*_auto` wrappers (`autoretry`).
The reference's `__all__`, less nothing.
"""
from .shuffle import (partition_ids, build_partition_map, exchange,
                      repartition_table, make_mesh, Mesh)
from .relational import (distributed_broadcast_join,
                         distributed_broadcast_join_keyed,
                         distributed_colocated_join_keyed,
                         distributed_groupby,
                         distributed_groupby_keyed, distributed_groupby_multi,
                         distributed_inner_join, distributed_inner_join_keyed,
                         distributed_left_anti_join,
                         distributed_left_anti_join_keyed,
                         distributed_left_join, distributed_left_join_keyed,
                         distributed_left_semi_join,
                         distributed_left_semi_join_keyed,
                         distributed_local_groupby,
                         distributed_repartition_keyed,
                         distributed_sort, distributed_sort_keyed)
from .keys import (KeySpec, encode_key_column, encode_key_columns,
                   decode_key_columns, spark_partition_hash)
from .partition import (build_partition_map_scan, exchange_map,
                        partition_histogram, partition_ranks)
from .autoretry import (CapacityOverflowError, auto_retry_overflow,
                        distributed_broadcast_join_auto,
                        distributed_broadcast_join_keyed_auto,
                        distributed_groupby_auto,
                        distributed_groupby_keyed_auto,
                        distributed_inner_join_auto,
                        distributed_inner_join_keyed_auto,
                        distributed_left_join_auto,
                        distributed_left_join_keyed_auto,
                        distributed_sort_auto)

__all__ = ["partition_ids", "build_partition_map", "exchange",
           "repartition_table", "make_mesh",
           "distributed_groupby", "distributed_groupby_multi",
           "distributed_groupby_keyed", "distributed_inner_join_keyed",
           "distributed_left_join_keyed", "distributed_left_semi_join_keyed",
           "distributed_left_anti_join_keyed",
           "KeySpec", "encode_key_column", "encode_key_columns",
           "decode_key_columns", "spark_partition_hash",
           "build_partition_map_scan", "partition_histogram",
           "partition_ranks",
           "CapacityOverflowError", "auto_retry_overflow",
           "distributed_groupby_auto", "distributed_groupby_keyed_auto",
           "distributed_inner_join_auto", "distributed_inner_join_keyed_auto",
           "distributed_left_join_auto", "distributed_left_join_keyed_auto",
           "distributed_broadcast_join_auto",
           "distributed_broadcast_join_keyed_auto",
           "distributed_sort_auto",
           "distributed_inner_join",
           "distributed_broadcast_join", "distributed_broadcast_join_keyed",
           "distributed_colocated_join_keyed", "distributed_local_groupby",
           "distributed_repartition_keyed",
           "distributed_left_join",
           "distributed_left_semi_join", "distributed_left_anti_join",
           "distributed_sort", "distributed_sort_keyed",
           "Mesh", "exchange_map"]
