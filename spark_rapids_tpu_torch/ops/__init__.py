"""Relational ops, row hashes and DECIMAL128 arithmetic of the PyTorch port.

`murmur_hash3_32` and `xxhash64` run the fused row-hash kernel on a CUDA
table and the plain version on a CPU one (`hash_cuda`); the five decimal
ops (`decimal_utils`) run the decimal kernel on CUDA columns and the plain
version on CPU ones. The hash takes every kind Spark hashes: strings,
DECIMAL128, structs and (murmur3) lists too. The JCUDF row conversion
(`convert_to_rows`, `convert_from_rows` and their fixed-width-optimized
forms) selects the registry's `row_conversion` op: the row-conversion
kernels on the card, the plain version on the CPU. The casts of
`CastStrings` (`string_to_integer`, `string_to_float`, `string_to_decimal`,
`string_to_integer_with_base`, `integer_to_string_with_base`,
`float_to_string`, `format_float`, `decimal_to_non_ansi_string`, and
`CastError` for ANSI mode) run the cast kernels (`cast_cuda`) on CUDA
columns and their plain versions on CPU ones; so do `parse_uri_to_*`
(the URI parse kernel, `parse_uri_cuda`), `from_json` (the JSON kernels,
`map_utils_cuda`) and the bloom filter's `put` and `probe`
(`bloom_filter_cuda`; `BloomFilter` holds Spark's packed longs, and merge,
serialize and deserialize are torch ops on either device). The hash-join
kernels (`join_cuda`) are imported lazily, by the kernel registry, at the
first `hash_join` dispatch.
"""
from .aggregate import groupby_aggregate
from .bloom_filter import (BloomFilter, bloom_filter_create,
                           bloom_filter_deserialize, bloom_filter_merge,
                           bloom_filter_probe, bloom_filter_put,
                           bloom_filter_serialize)
from .cast_decimal import string_to_decimal
from .cast_decimal_to_string import decimal_to_non_ansi_string
from .cast_float_to_string import float_to_string
from .cast_string import (CastError, integer_to_string_with_base,
                          string_to_float, string_to_integer,
                          string_to_integer_with_base)
from .format_float import format_float
from .decimal_utils import (add_decimal128, sub_decimal128,
                            multiply_decimal128, divide_decimal128,
                            remainder_decimal128)
from .gather import apply_boolean_mask, take, take_table
from .hash import DEFAULT_XXHASH64_SEED
from .hash_cuda import fused_row_hash, murmur_hash3_32, xxhash64
from .map_utils import from_json
from .parse_uri import (parse_uri_to_host, parse_uri_to_protocol,
                        parse_uri_to_query, parse_uri_to_query_column,
                        parse_uri_to_query_literal)
from .join import (full_join, inner_join, inner_join_capped, left_join,
                   left_join_capped, left_semi_join, left_anti_join,
                   semi_join_mask)
from .row_conversion import (convert_from_rows,
                             convert_from_rows_fixed_width_optimized,
                             convert_to_rows,
                             convert_to_rows_fixed_width_optimized)
from .sort import sort_table, sorted_order

__all__ = ["groupby_aggregate", "apply_boolean_mask", "take", "take_table",
           "DEFAULT_XXHASH64_SEED", "fused_row_hash", "murmur_hash3_32",
           "xxhash64", "inner_join", "inner_join_capped", "left_join",
           "left_join_capped", "full_join", "left_semi_join",
           "left_anti_join", "semi_join_mask",
           "sort_table", "sorted_order", "add_decimal128", "sub_decimal128",
           "multiply_decimal128", "divide_decimal128",
           "remainder_decimal128", "convert_to_rows",
           "convert_to_rows_fixed_width_optimized", "convert_from_rows",
           "convert_from_rows_fixed_width_optimized", "CastError",
           "string_to_integer", "string_to_float", "string_to_decimal",
           "string_to_integer_with_base", "integer_to_string_with_base",
           "float_to_string", "format_float", "decimal_to_non_ansi_string",
           "BloomFilter", "bloom_filter_create", "bloom_filter_put",
           "bloom_filter_merge", "bloom_filter_probe",
           "bloom_filter_serialize", "bloom_filter_deserialize",
           "parse_uri_to_protocol", "parse_uri_to_host", "parse_uri_to_query",
           "parse_uri_to_query_literal", "parse_uri_to_query_column",
           "from_json"]
