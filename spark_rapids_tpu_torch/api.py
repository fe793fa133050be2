"""Java-facing facade of the PyTorch port: the classes of spark-rapids-jni's
Java API, mapped onto the port's ops.

Counterpart of `spark_rapids_tpu/api.py`. `CastStrings`, `DecimalUtils`,
`Hash` (every kind Spark hashes: fixed-width, strings, DECIMAL128, structs
and, for murmur3, lists) and `RowConversion` are ported; the other classes
wait for their modules (ROADMAP queue A item 12).
"""
from __future__ import annotations

from typing import List, Sequence

from . import ops
from .columnar import Column, Table
from .dtypes import DType


class CastStrings:
    """CastStrings.java:36-153."""

    @staticmethod
    def toInteger(cv: Column, ansiMode: bool, type: DType,
                  strip: bool = True) -> Column:
        return ops.string_to_integer(cv, type, ansi_mode=ansiMode, strip=strip)

    @staticmethod
    def toDecimal(cv: Column, ansiMode: bool, precision: int, scale: int,
                  strip: bool = True) -> Column:
        return ops.string_to_decimal(cv, precision, scale, ansi_mode=ansiMode,
                                     strip=strip)

    @staticmethod
    def toFloat(cv: Column, ansiMode: bool, type: DType) -> Column:
        return ops.string_to_float(cv, type, ansi_mode=ansiMode)

    @staticmethod
    def fromDecimal(cv: Column) -> Column:
        return ops.decimal_to_non_ansi_string(cv)

    @staticmethod
    def fromFloat(cv: Column) -> Column:
        return ops.float_to_string(cv)

    @staticmethod
    def fromFloatWithFormat(cv: Column, digits: int) -> Column:
        return ops.format_float(cv, digits)

    @staticmethod
    def toIntegersWithBase(cv: Column, base: int, ansiEnabled: bool,
                           type: DType) -> Column:
        return ops.string_to_integer_with_base(cv, type, base=base,
                                               ansi_mode=ansiEnabled)

    @staticmethod
    def fromIntegersWithBase(cv: Column, base: int) -> Column:
        return ops.integer_to_string_with_base(cv, base=base)


class DecimalUtils:
    """DecimalUtils.java:46-178. Every op returns (overflow BOOL column,
    result column) like the reference's two-column Table."""

    @staticmethod
    def multiply128(a: Column, b: Column, productScale: int,
                    interimCast: bool = True):
        return ops.multiply_decimal128(a, b, productScale,
                                       cast_interim_result=interimCast)

    @staticmethod
    def divide128(a: Column, b: Column, quotientScale: int):
        return ops.divide_decimal128(a, b, quotientScale)

    @staticmethod
    def integerDivide128(a: Column, b: Column):
        return ops.divide_decimal128(a, b, 0, is_int_div=True)

    @staticmethod
    def remainder128(a: Column, b: Column, remainderScale: int):
        return ops.remainder_decimal128(a, b, remainderScale)

    @staticmethod
    def add128(a: Column, b: Column, targetScale: int):
        return ops.add_decimal128(a, b, targetScale)

    @staticmethod
    def subtract128(a: Column, b: Column, targetScale: int):
        return ops.sub_decimal128(a, b, targetScale)


class Hash:
    """Hash.java:26-86."""

    DEFAULT_XXHASH64_SEED = ops.DEFAULT_XXHASH64_SEED

    @staticmethod
    def murmurHash32(columns: Sequence[Column], seed: int = 0) -> Column:
        return ops.murmur_hash3_32(list(columns), seed=seed)

    @staticmethod
    def xxhash64(columns: Sequence[Column],
                 seed: int = ops.DEFAULT_XXHASH64_SEED) -> Column:
        return ops.xxhash64(list(columns), seed=seed)


class RowConversion:
    """RowConversion.java:35-164."""

    @staticmethod
    def convertToRows(table: Table) -> List[Column]:
        return ops.convert_to_rows(table)

    @staticmethod
    def convertToRowsFixedWidthOptimized(table: Table) -> List[Column]:
        return ops.convert_to_rows_fixed_width_optimized(table)

    @staticmethod
    def convertFromRows(vec: Column, *schema: DType) -> Table:
        return ops.convert_from_rows(vec, list(schema))

    @staticmethod
    def convertFromRowsFixedWidthOptimized(vec: Column,
                                           *schema: DType) -> Table:
        return ops.convert_from_rows_fixed_width_optimized(vec,
                                                           list(schema))
