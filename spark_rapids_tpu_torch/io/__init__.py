"""Parquet IO: the footer, the chunked reader and the streaming source.

Counterpart of `spark_rapids_tpu/io/__init__.py`. `read_parquet` is
admitted as in the reference: a read has no resident input buffers, so
its working-set estimate is three times the encoded size of the source,
crossing the active DeviceSession's budget before anything is decoded
(`runtime/admission.py`).
"""
from .parquet_footer import (ParquetFooter, StructElement, ListElement,
                             MapElement, ValueElement, ColumnChunkStats,
                             RowGroupStats, read_footer_stats)
from .parquet import (ParquetChunkedReader, ParquetSource, read_parquet,
                      select_row_groups)

from ..runtime.admission import admitted_op as _admitted_op


def _parquet_read_estimate(source, *args, **kwargs) -> int:
    import os
    if isinstance(source, (bytes, bytearray, memoryview)):
        return 3 * len(source)
    try:
        return 3 * os.path.getsize(source)
    except (OSError, TypeError):
        return 0


read_parquet = _admitted_op(read_parquet, estimator=_parquet_read_estimate)

__all__ = ["ParquetFooter", "StructElement", "ListElement", "MapElement",
           "ValueElement", "ParquetChunkedReader", "ParquetSource",
           "read_parquet", "read_footer_stats", "select_row_groups",
           "ColumnChunkStats", "RowGroupStats"]
