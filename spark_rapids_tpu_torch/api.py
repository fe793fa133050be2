"""Java-facing facade of the PyTorch port: the classes of spark-rapids-jni's
Java API, mapped onto the port's ops.

Counterpart of `spark_rapids_tpu/api.py`: all twelve of its classes.
`CastStrings`, `DecimalUtils`, `Hash` (every kind Spark hashes:
fixed-width, strings, DECIMAL128, structs and, for murmur3, lists),
`RowConversion`, `BloomFilter`, `MapUtils`, `ParseURI`, `GpuTimeZoneDB`,
`DateTimeRebase`, `Histogram` and `ZOrder`, and `RmmSpark` (over
`runtime.ResourceArbiter`, with the reference's OOM exceptions as
aliases); `ParquetFooter` is re-exported from `io.parquet_footer`, as the
reference's facade does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import device as _device
from . import dtypes, ops
from .columnar import Column, Table
from .dtypes import DType
from .io.parquet_footer import ParquetFooter  # noqa: F401  (re-export)
from .runtime.adaptor import (CpuRetryOOM, CpuSplitAndRetryOOM,  # noqa: F401
                              ResourceArbiter, RetryOOM, SplitAndRetryOOM)


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


class BloomFilter:
    """BloomFilter.java:42-97. The reference keeps the filter in a cudf
    list_scalar; here it is `ops.BloomFilter` (Spark's packed longs on one
    device; serialize and deserialize give the wire bytes)."""

    @staticmethod
    def create(numHashes: int, bloomFilterBits: int, device=None):
        return ops.bloom_filter_create(numHashes, (bloomFilterBits + 63) // 64,
                                       device)

    @staticmethod
    def put(bloomFilter, cv: Column):
        return ops.bloom_filter_put(bloomFilter, cv)

    @staticmethod
    def merge(bloomFilters: Sequence):
        """Takes filters or serialized wire buffers: the reference's merge
        input is a column of executor-serialized filters
        (BloomFilter.java:66-74). A buffer lands on the first filter's
        device (a tensor without one stays on its own), else the card."""
        device = next((f.device for f in bloomFilters
                       if isinstance(f, ops.BloomFilter)), None)
        filters = [f if isinstance(f, ops.BloomFilter)
                   else ops.bloom_filter_deserialize(f, device)
                   for f in bloomFilters]
        return ops.bloom_filter_merge(filters)

    @staticmethod
    def probe(bloomFilter, cv: Column) -> Column:
        if not isinstance(bloomFilter, ops.BloomFilter):
            # the serialized-buffer overload (BloomFilter.java:95)
            bloomFilter = ops.bloom_filter_deserialize(bloomFilter, cv.device)
        return ops.bloom_filter_probe(cv, bloomFilter)


class MapUtils:
    """MapUtils.java:47."""

    @staticmethod
    def extractRawMapFromJsonString(jsonColumn: Column) -> Column:
        return ops.from_json(jsonColumn)


class ParseURI:
    """ParseURI.java:36-94."""

    @staticmethod
    def parseURIProtocol(uriColumn: Column) -> Column:
        return ops.parse_uri_to_protocol(uriColumn)

    @staticmethod
    def parseURIHost(uriColumn: Column) -> Column:
        return ops.parse_uri_to_host(uriColumn)

    @staticmethod
    def parseURIQuery(uriColumn: Column) -> Column:
        return ops.parse_uri_to_query(uriColumn)

    @staticmethod
    def parseURIQueryWithLiteral(uriColumn: Column, query: str) -> Column:
        return ops.parse_uri_to_query_literal(uriColumn, query)

    @staticmethod
    def parseURIQueryWithColumn(uriColumn: Column,
                                queryColumn: Column) -> Column:
        return ops.parse_uri_to_query_column(uriColumn, queryColumn)


class GpuTimeZoneDB:
    """GpuTimeZoneDB.java:88-251."""

    @staticmethod
    def cacheDatabaseAsync():
        return ops.TimeZoneDB.cache_database_async()

    @staticmethod
    def cacheDatabase():
        return ops.TimeZoneDB.cache_database()

    @staticmethod
    def shutdown():
        ops.TimeZoneDB.shutdown()

    @staticmethod
    def fromTimestampToUtcTimestamp(input: Column,
                                    currentTimeZone: str) -> Column:
        return ops.from_timestamp_to_utc_timestamp(input, currentTimeZone)

    @staticmethod
    def fromUtcTimestampToTimestamp(input: Column,
                                    desiredTimeZone: str) -> Column:
        return ops.from_utc_timestamp_to_timestamp(input, desiredTimeZone)

    @staticmethod
    def isSupportedTimeZone(zoneId: str) -> bool:
        return ops.is_supported_time_zone(zoneId)


class DateTimeRebase:
    """DateTimeRebase.java:38-62."""

    @staticmethod
    def rebaseGregorianToJulian(input: Column) -> Column:
        return ops.rebase_gregorian_to_julian(input)

    @staticmethod
    def rebaseJulianToGregorian(input: Column) -> Column:
        return ops.rebase_julian_to_gregorian(input)


class Histogram:
    """Histogram.java:47-74."""

    @staticmethod
    def createHistogramIfValid(values: Column, frequencies: Column,
                               outputAsLists: bool) -> Column:
        return ops.create_histogram_if_valid(values, frequencies,
                                             output_as_lists=outputAsLists)

    @staticmethod
    def percentileFromHistogram(input: Column, percentages: Sequence[float],
                                outputAsLists: bool) -> Column:
        return ops.percentile_from_histogram(input, list(percentages),
                                             output_as_list=outputAsLists)


class ZOrder:
    """ZOrder.java:41-75. With no input column there is no column to take
    a device from: `device` names it (None: the card)."""

    @staticmethod
    def interleaveBits(numRows: int, *inputColumns: Column,
                       device=None) -> Column:
        if not inputColumns:
            # the 0-column corner case: numRows empty binaries
            # (ZOrder.java:41-47)
            dev = _device.resolve(device)
            return Column.make_list(
                torch.zeros(numRows + 1, dtype=torch.int32, device=dev),
                Column(dtypes.UINT8, 0,
                       torch.zeros(0, dtype=torch.uint8, device=dev)))
        return ops.interleave_bits(list(inputColumns))

    @staticmethod
    def hilbertIndex(numBits: int, numRows: int, *inputColumns: Column,
                     device=None) -> Column:
        if not inputColumns:
            # the 0-column corner case: numRows zeros (ZOrder.java:70-75)
            return Column(dtypes.INT64, numRows, torch.zeros(
                numRows, dtype=torch.int64, device=_device.resolve(device)))
        return ops.hilbert_index(numBits, list(inputColumns))


class RmmSpark:
    """RmmSpark.java facade over runtime.ResourceArbiter: same role as the
    reference's static wrapper around SparkResourceAdaptor (install an
    arbiter, associate threads with tasks, drain metrics, inject OOMs)."""

    _arbiter: Optional[ResourceArbiter] = None

    @staticmethod
    def setEventHandler(logLoc: Optional[str] = None) -> ResourceArbiter:
        """RmmSpark.java:59-116 (the RMM wrap half is the arbiter install).
        Double-install raises, like the reference."""
        if RmmSpark._arbiter is not None:
            raise RuntimeError("an event handler is already set")
        RmmSpark._arbiter = ResourceArbiter(log_loc=logLoc)
        return RmmSpark._arbiter

    @staticmethod
    def clearEventHandler() -> None:
        if RmmSpark._arbiter is not None:
            RmmSpark._arbiter.close()
            RmmSpark._arbiter = None

    @staticmethod
    def _a() -> ResourceArbiter:
        if RmmSpark._arbiter is None:
            raise RuntimeError("call RmmSpark.setEventHandler() first")
        return RmmSpark._arbiter

    # thread/task association (RmmSpark.java:126-343)
    @staticmethod
    def currentThreadIsDedicatedToTask(taskId: int) -> None:
        RmmSpark._a().current_thread_is_dedicated_to_task(taskId)

    @staticmethod
    def shuffleThreadWorkingOnTasks(taskIds: Sequence[int]) -> None:
        RmmSpark._a().shuffle_thread_working_on_tasks(taskIds)

    @staticmethod
    def poolThreadWorkingOnTasks(taskIds: Sequence[int]) -> None:
        RmmSpark._a().pool_thread_working_on_tasks(taskIds)

    @staticmethod
    def poolThreadFinishedForTasks(taskIds: Sequence[int]) -> None:
        RmmSpark._a().pool_thread_finished_for_tasks(taskIds)

    @staticmethod
    def taskDone(taskId: int) -> None:
        RmmSpark._a().task_done(taskId)

    @staticmethod
    def blockThreadUntilReady() -> None:
        RmmSpark._a().block_thread_until_ready()

    # OOM injection (RmmSpark.java:435-515)
    @staticmethod
    def forceRetryOOM(threadId: int, numOOMs: int = 1, oomMode: int = 0,
                      skipCount: int = 0) -> None:
        RmmSpark._a().force_retry_oom(threadId, numOOMs, oomMode, skipCount)

    @staticmethod
    def forceSplitAndRetryOOM(threadId: int, numOOMs: int = 1, oomMode: int = 0,
                              skipCount: int = 0) -> None:
        RmmSpark._a().force_split_and_retry_oom(threadId, numOOMs, oomMode,
                                                skipCount)

    # metrics drain (RmmSpark.java:533-590)
    @staticmethod
    def getAndResetNumRetryThrow(taskId: int) -> int:
        return RmmSpark._a().get_and_reset_num_retry_throw(taskId)

    @staticmethod
    def getAndResetNumSplitRetryThrow(taskId: int) -> int:
        return RmmSpark._a().get_and_reset_num_split_retry_throw(taskId)

    @staticmethod
    def getAndResetBlockTimeNs(taskId: int) -> int:
        return RmmSpark._a().get_and_reset_block_time_ns(taskId)

    @staticmethod
    def getAndResetComputeTimeLostToRetryNs(taskId: int) -> int:
        return RmmSpark._a().get_and_reset_computation_time_lost_ns(taskId)

    @staticmethod
    def getStateOf(threadId: int) -> str:
        return RmmSpark._a().get_state_name_of(threadId)
