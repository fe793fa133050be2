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
serialize and deserialize are torch ops on either device); so do the
time-zone conversions (`from_timestamp_to_utc_timestamp`,
`from_utc_timestamp_to_timestamp` over `TimeZoneDB`'s transition tables;
`timezones_cuda`), the calendar rebase (`rebase_gregorian_to_julian`,
`rebase_julian_to_gregorian`; `datetime_rebase_cuda`), the Z-order
helpers (`interleave_bits`, `hilbert_index`; `zorder_cuda`) and
`percentile_from_histogram` (`histogram_cuda`, after three stable sorts);
`create_histogram_if_valid` moves data only and is torch ops on either
device. The hash-join kernels (`join_cuda`) are imported lazily, by the
kernel registry, at the first `hash_join` dispatch.
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
from .datetime_rebase import (rebase_gregorian_to_julian,
                              rebase_julian_to_gregorian)
from .hash import DEFAULT_XXHASH64_SEED
from .hash_cuda import fused_row_hash, murmur_hash3_32, xxhash64
from .histogram import create_histogram_if_valid, percentile_from_histogram
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
from .timezones import (TimeZoneDB, from_timestamp_to_utc_timestamp,
                        from_utc_timestamp_to_timestamp,
                        is_supported_time_zone)
from .zorder import hilbert_index, interleave_bits

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
           "from_json", "TimeZoneDB", "from_timestamp_to_utc_timestamp",
           "from_utc_timestamp_to_timestamp", "is_supported_time_zone",
           "rebase_gregorian_to_julian", "rebase_julian_to_gregorian",
           "interleave_bits", "hilbert_index", "create_histogram_if_valid",
           "percentile_from_histogram"]

# Admission (runtime/admission.py) wraps the public ops with the JAX
# package's working-set factors over their operand bytes (spark_rapids_tpu/
# ops/__init__.py _ADMITTED_FACTORS, for the names the port has); a wrapper
# passes through when no DeviceSession is active. Calls between the port's
# own modules import the submodules, so each public call is admitted once.
# The plan executor calls through `plan_ops`, whose entries take their
# factors from this table too (concat_tables is one of them only).
from ..runtime.admission import admitted_op as _admitted_op

_ADMITTED_FACTORS = {
    "murmur_hash3_32": 1.5, "xxhash64": 1.5,
    "string_to_integer": 2.0, "string_to_float": 2.0,
    "string_to_integer_with_base": 2.0, "integer_to_string_with_base": 3.0,
    "string_to_decimal": 2.0,
    "add_decimal128": 2.0, "sub_decimal128": 2.0, "multiply_decimal128": 3.0,
    "divide_decimal128": 3.0, "remainder_decimal128": 3.0,
    "decimal_to_non_ansi_string": 3.0,
    "interleave_bits": 2.0, "hilbert_index": 2.0,
    "rebase_gregorian_to_julian": 2.0, "rebase_julian_to_gregorian": 2.0,
    "from_timestamp_to_utc_timestamp": 2.0,
    "from_utc_timestamp_to_timestamp": 2.0,
    "float_to_string": 4.0, "format_float": 4.0,
    "convert_to_rows": 3.0, "convert_to_rows_fixed_width_optimized": 3.0,
    "convert_from_rows": 3.0, "convert_from_rows_fixed_width_optimized": 3.0,
    "parse_uri_to_protocol": 2.0, "parse_uri_to_host": 2.0,
    "parse_uri_to_query": 2.0, "parse_uri_to_query_literal": 2.0,
    "parse_uri_to_query_column": 2.0,
    "create_histogram_if_valid": 2.0, "percentile_from_histogram": 2.0,
    "from_json": 3.0,
    "take": 2.0, "take_table": 2.0, "apply_boolean_mask": 2.0,
    "sorted_order": 2.0, "sort_table": 3.0,
    "groupby_aggregate": 2.0,
    "inner_join": 3.0, "inner_join_capped": 3.0, "left_join": 3.0,
    "left_join_capped": 3.0, "full_join": 3.0,
    "left_semi_join": 2.0, "left_anti_join": 2.0, "semi_join_mask": 2.0,
    "bloom_filter_put": 2.0, "bloom_filter_merge": 2.0,
    "bloom_filter_probe": 2.0, "concat_tables": 2.0,
}
for _name in __all__:
    if _name in _ADMITTED_FACTORS:
        globals()[_name] = _admitted_op(globals()[_name],
                                        factor=_ADMITTED_FACTORS[_name])
del _name
