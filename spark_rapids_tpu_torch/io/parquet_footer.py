"""Parquet footer parse / prune / filter / re-serialize / statistics.

Counterpart of `spark_rapids_tpu/io/parquet_footer.py`, over the port's
own copy of the footer C++ (`native/parquet_footer.cpp`, built by
`native/build.py` at first use). The surface and the decoding are the
reference's.

The reference's text follows. Python facade over native/parquet_footer.cpp, mirroring the reference's
ParquetFooter.java surface: a schema DSL (StructElement/ListElement/
MapElement/ValueElement, ParquetFooter.java:34-118) flattened depth-first
into names/num_children/tags arrays (tags 0=VALUE 1=STRUCT 2=LIST 3=MAP,
:139-179), readAndFilter(buffer, partOffset, partLength, schema,
ignoreCase) (:204), and serializeThriftFile returning the
[thrift][4-byte length][PAR1] framing (NativeParquetJni.cpp:793-830).

`read_footer_stats()` additionally exposes per-row-group, per-column-chunk
min/max statistics (decoded from the footer's Statistics structs) — the
input to the streaming scan's row-group pruning (docs/io.md). Columns
lacking statistics, and physical types whose plain encoding this module
does not decode (INT96, FLBA), surface as `min is None / max is None`:
the None-safe path pruning must treat as "cannot prove anything".
"""
from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..native.build import build


class ValueElement:
    """A primitive leaf column."""


class StructElement:
    def __init__(self, **children):
        self.children: List[Tuple[str, object]] = list(children.items())

    @staticmethod
    def of(children: Sequence[Tuple[str, object]]) -> "StructElement":
        s = StructElement()
        s.children = list(children)
        return s


class ListElement:
    def __init__(self, item):
        self.item = item


class MapElement:
    def __init__(self, key, value):
        self.key = key
        self.value = value


def _flatten(element, name: str, lower: bool, names, num_children, tags):
    if lower:
        name = name.lower()
    if isinstance(element, ValueElement):
        names.append(name)
        num_children.append(0)
        tags.append(0)
    elif isinstance(element, StructElement):
        names.append(name)
        num_children.append(len(element.children))
        tags.append(1)
        for child_name, child in element.children:
            _flatten(child, child_name, lower, names, num_children, tags)
    elif isinstance(element, ListElement):
        names.append(name)
        num_children.append(1)
        tags.append(2)
        _flatten(element.item, "element", lower, names, num_children, tags)
    elif isinstance(element, MapElement):
        names.append(name)
        num_children.append(2)
        tags.append(3)
        _flatten(element.key, "key", lower, names, num_children, tags)
        _flatten(element.value, "value", lower, names, num_children, tags)
    else:
        raise TypeError(f"{element!r} is not a supported schema element")


_lib = None
_lib_lock = threading.Lock()


def _native():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build("parquet_footer")))
                lib.pqf_parse.restype = ctypes.c_void_p
                lib.pqf_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
                lib.pqf_last_error.restype = ctypes.c_char_p
                lib.pqf_filter_groups.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int64,
                                                  ctypes.c_int64]
                lib.pqf_prune.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int, ctypes.c_int]
                lib.pqf_num_rows.restype = ctypes.c_int64
                lib.pqf_num_rows.argtypes = [ctypes.c_void_p]
                lib.pqf_num_row_groups.argtypes = [ctypes.c_void_p]
                lib.pqf_num_columns.argtypes = [ctypes.c_void_p]
                lib.pqf_serialize.restype = ctypes.c_int64
                lib.pqf_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                              ctypes.c_int64]
                lib.pqf_rg_num_rows.restype = ctypes.c_int64
                lib.pqf_rg_num_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.pqf_rg_num_chunks.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
                lib.pqf_chunk_info.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64)]
                lib.pqf_chunk_stat.restype = ctypes.c_int64
                lib.pqf_chunk_stat.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int64]
                lib.pqf_free.argtypes = [ctypes.c_void_p]
                _lib = lib
    return _lib


class ParquetFooter:
    """A parsed, filtered parquet footer (reference ParquetFooter.java)."""

    def __init__(self, handle: int):
        self._lib = _native()
        self._h = handle

    @staticmethod
    def read_and_filter(buffer: bytes, part_offset: int, part_length: int,
                        schema: StructElement,
                        ignore_case: bool) -> "ParquetFooter":
        """Parse a footer thrift buffer, prune to `schema`, and keep only
        the row groups whose byte midpoint falls inside
        [part_offset, part_offset + part_length)."""
        lib = _native()
        h = lib.pqf_parse(buffer, len(buffer))
        if not h:
            raise ValueError(lib.pqf_last_error().decode())
        footer = ParquetFooter(h)
        try:
            footer._filter_groups(part_offset, part_length)
            footer._prune(schema, ignore_case)
        except Exception:
            footer.close()
            raise
        return footer

    def _filter_groups(self, part_offset: int, part_length: int) -> None:
        if self._lib.pqf_filter_groups(self._h, part_offset, part_length):
            raise ValueError(self._lib.pqf_last_error().decode())

    def _prune(self, schema: StructElement, ignore_case: bool) -> None:
        names: List[str] = []
        num_children: List[int] = []
        tags: List[int] = []
        for child_name, child in schema.children:
            _flatten(child, child_name, ignore_case, names, num_children,
                     tags)
        n = len(names)
        c_names = (ctypes.c_char_p * n)(*[s.encode() for s in names])
        c_nc = (ctypes.c_int * n)(*num_children)
        c_tags = (ctypes.c_int * n)(*tags)
        if self._lib.pqf_prune(self._h, c_names, c_nc, c_tags, n,
                               int(ignore_case)):
            raise ValueError(self._lib.pqf_last_error().decode())

    def get_num_rows(self) -> int:
        return self._lib.pqf_num_rows(self._h)

    def get_num_columns(self) -> int:
        return self._lib.pqf_num_columns(self._h)

    def get_num_row_groups(self) -> int:
        return self._lib.pqf_num_row_groups(self._h)

    def serialize_thrift_file(self) -> bytes:
        """Filtered footer as [thrift][4-byte LE length]["PAR1"]."""
        size = self._lib.pqf_serialize(self._h, None, 0)
        if size < 0:
            raise ValueError(self._lib.pqf_last_error().decode())
        buf = ctypes.create_string_buffer(size)
        got = self._lib.pqf_serialize(self._h, buf, size)
        if got < 0:
            raise ValueError(self._lib.pqf_last_error().decode())
        return buf.raw[:got]

    def close(self) -> None:
        if self._h:
            self._lib.pqf_free(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---- per-row-group min/max statistics ---------------------------------------

# parquet physical types (parquet.thrift Type enum)
PHYS_BOOLEAN, PHYS_INT32, PHYS_INT64, PHYS_INT96 = 0, 1, 2, 3
PHYS_FLOAT, PHYS_DOUBLE, PHYS_BYTE_ARRAY, PHYS_FLBA = 4, 5, 6, 7


@dataclasses.dataclass(frozen=True)
class ColumnChunkStats:
    """One column chunk's footer statistics. `min`/`max` are decoded python
    values (int/float/bool/bytes) or None when the chunk carries no usable
    statistics — the None-safe "cannot prove anything" state pruning must
    honor. `null_count` is None when the writer omitted it."""
    path: str                       # dotted leaf path ("a", "s.x", ...)
    physical_type: int              # PHYS_* code
    min: object
    max: object
    null_count: Optional[int]
    total_compressed_size: int

    @property
    def column(self) -> str:
        """Top-level column this leaf belongs to."""
        return self.path.split(".", 1)[0]


@dataclasses.dataclass(frozen=True)
class RowGroupStats:
    """Statistics of one row group: num_rows plus per-leaf chunk stats
    keyed by the dotted leaf path."""
    index: int
    num_rows: int
    columns: Dict[str, ColumnChunkStats]


def _decode_stat(raw: Optional[bytes], phys: int):
    """Plain-encoded statistics value -> python value; None when the type
    has no decodable plain form here (INT96, FLBA) or the width is off."""
    if raw is None:
        return None
    try:
        if phys == PHYS_INT32 and len(raw) == 4:
            return int.from_bytes(raw, "little", signed=True)
        if phys == PHYS_INT64 and len(raw) == 8:
            return int.from_bytes(raw, "little", signed=True)
        if phys == PHYS_FLOAT and len(raw) == 4:
            return struct.unpack("<f", raw)[0]
        if phys == PHYS_DOUBLE and len(raw) == 8:
            return struct.unpack("<d", raw)[0]
        if phys == PHYS_BOOLEAN and len(raw) >= 1:
            return raw[0] != 0
        if phys == PHYS_BYTE_ARRAY:
            return raw                  # compare as bytes (UTF8 order ==
            #                             unsigned byte order)
    except (struct.error, ValueError):
        return None
    return None


def footer_thrift_bytes(data: bytes) -> bytes:
    """The raw thrift FileMetaData buffer from a whole-file byte string
    ([...data...][thrift][4-byte LE length][PAR1])."""
    if len(data) < 12 or data[-4:] != b"PAR1":
        raise ValueError("not a parquet file (missing PAR1 trailer)")
    n = int.from_bytes(data[-8:-4], "little")
    if n <= 0 or n + 8 > len(data):
        raise ValueError("corrupt parquet footer length")
    return data[-8 - n:-8]


def _read_footer_tail(source: Union[str, bytes]) -> bytes:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return footer_thrift_bytes(bytes(source))
    with open(source, "rb") as f:
        import os
        size = os.fstat(f.fileno()).st_size
        if size < 12:
            raise ValueError("not a parquet file (too small)")
        f.seek(-8, 2)
        trailer = f.read(8)
        if trailer[-4:] != b"PAR1":
            raise ValueError("not a parquet file (missing PAR1 trailer)")
        n = int.from_bytes(trailer[:4], "little")
        if n <= 0 or n + 8 > size:
            raise ValueError("corrupt parquet footer length")
        f.seek(-(8 + n), 2)
        return f.read(n)


def read_footer_stats(source: Union[str, bytes]) -> List[RowGroupStats]:
    """Per-row-group, per-column-chunk min/max statistics of a parquet file
    (path or whole-file bytes). Reads ONLY the footer — no page data is
    touched, which is what makes stats-driven row-group pruning cheaper
    than decoding ("Do GPUs Really Need New Tabular File Formats?")."""
    lib = _native()
    buf = _read_footer_tail(source)
    h = lib.pqf_parse(buf, len(buf))
    if not h:
        raise ValueError(lib.pqf_last_error().decode())
    try:
        out: List[RowGroupStats] = []
        for rg in range(lib.pqf_num_row_groups(h)):
            n_rows = lib.pqf_rg_num_rows(h, rg)
            if n_rows < 0:
                raise ValueError(lib.pqf_last_error().decode())
            cols: Dict[str, ColumnChunkStats] = {}
            n_chunks = lib.pqf_rg_num_chunks(h, rg)
            if n_chunks < 0:
                raise ValueError(lib.pqf_last_error().decode())
            for c in range(n_chunks):
                path_buf = ctypes.create_string_buffer(2048)
                phys = ctypes.c_int64()
                compressed = ctypes.c_int64()
                null_count = ctypes.c_int64()
                if lib.pqf_chunk_info(h, rg, c, path_buf, 2048,
                                      ctypes.byref(phys),
                                      ctypes.byref(compressed),
                                      ctypes.byref(null_count)):
                    raise ValueError(lib.pqf_last_error().decode())

                def stat(which: int) -> Optional[bytes]:
                    size = lib.pqf_chunk_stat(h, rg, c, which, None, 0)
                    if size == -1:
                        return None             # absent: the None-safe path
                    if size < 0:
                        raise ValueError(lib.pqf_last_error().decode())
                    if size == 0:
                        return b""
                    vbuf = (ctypes.c_uint8 * size)()
                    got = lib.pqf_chunk_stat(h, rg, c, which, vbuf, size)
                    if got < 0:
                        raise ValueError(lib.pqf_last_error().decode())
                    return bytes(vbuf[:got])

                p = int(phys.value)
                st = ColumnChunkStats(
                    path=path_buf.value.decode(),
                    physical_type=p,
                    min=_decode_stat(stat(0), p),
                    max=_decode_stat(stat(1), p),
                    null_count=(None if null_count.value < 0
                                else int(null_count.value)),
                    total_compressed_size=int(compressed.value))
                cols[st.path] = st
            out.append(RowGroupStats(index=rg, num_rows=int(n_rows),
                                     columns=cols))
        return out
    finally:
        lib.pqf_free(h)
