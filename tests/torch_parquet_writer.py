"""A small Parquet writer and the committed fixtures' seed values.

Harness code, free of JAX, of pyarrow and of both packages: `chip_smoke.py`
writes its Parquet inputs with it on a machine that has no pyarrow, and
the tests hold it against pyarrow here.

`write_parquet` writes flat columns (int32, int64, float32, float64, bool,
date32, string) as the Parquet format describes (parquet.thrift):

- a thrift compact-protocol footer, with each column chunk's statistics
  (null_count, min_value and max_value, PLAIN-encoded; a float chunk with
  a NaN gets none, as no order holds there);
- one data page v1 a column chunk, PLAIN values, and for a nullable column
  its definition levels in the RLE/bit-packed hybrid (one bit-packed run);
- a dictionary page and RLE_DICTIONARY indices for a column chunk with at
  most `DICT_MAX` distinct values (`dictionary="auto"`), or for the
  columns named;
- UNCOMPRESSED or GZIP (zlib) pages.

`FIXTURES` names the committed files under `tests/data/torch_parquet/`,
which were written once by `write_fixtures` with pyarrow, for the codecs
and encodings this writer does not make (SNAPPY, ZSTD, data page v2, a
delta encoding, INT96, DECIMAL128 as FIXED_LEN_BYTE_ARRAY, LIST<STRUCT>).
`fixture_values(name)` gives each file's rows from its seed, as Python
values in the port's image (a decimal its unscaled int, INT96 and
timestamps microseconds, a date its day number), so a reader can be held
to them without pyarrow.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_parquet")
DICT_MAX = 1 << 16          # distinct values a dictionary-encoded chunk has

# parquet.thrift enums
_T_BOOLEAN, _T_INT32, _T_INT64, _T_FLOAT, _T_DOUBLE, _T_BYTE_ARRAY = \
    0, 1, 2, 4, 5, 6
_CT_UTF8, _CT_DATE = 0, 6
_REQUIRED, _OPTIONAL = 0, 1
_ENC_PLAIN, _ENC_RLE, _ENC_RLE_DICT = 0, 3, 8
_PAGE_DATA, _PAGE_DICT = 0, 2
_CODECS = {"UNCOMPRESSED": 0, "GZIP": 2}

_KINDS = {   # kind -> (physical type, converted type, numpy dtype)
    "int32": (_T_INT32, None, np.int32),
    "int64": (_T_INT64, None, np.int64),
    "float32": (_T_FLOAT, None, np.float32),
    "float64": (_T_DOUBLE, None, np.float64),
    "bool": (_T_BOOLEAN, None, np.bool_),
    "date32": (_T_INT32, _CT_DATE, np.int32),
    "string": (_T_BYTE_ARRAY, _CT_UTF8, None),
}


# ---- thrift compact protocol ----------------------------------------------

def _uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zz(n: int) -> bytes:
    return _uleb((n << 1) ^ (n >> 63))


_I32, _I64, _BINARY, _LIST, _STRUCT = 5, 6, 8, 9, 12


class _Struct:
    """Fields of one compact-protocol struct, written in id order."""

    def __init__(self):
        self.fields = []

    def add(self, fid: int, tp: int, value):
        if value is not None:
            self.fields.append((fid, tp, value))
        return self

    def encode(self) -> bytes:
        out = bytearray()
        prev = 0
        for fid, tp, value in sorted(self.fields, key=lambda f: f[0]):
            d = fid - prev
            if 0 < d <= 15:
                out.append((d << 4) | tp)
            else:
                out.append(tp)
                out += _zz(fid)
            prev = fid
            out += _value(tp, value)
        out.append(0)
        return bytes(out)


def _value(tp: int, v) -> bytes:
    if tp in (_I32, _I64):
        return _zz(int(v))
    if tp == _BINARY:
        v = v.encode() if isinstance(v, str) else bytes(v)
        return _uleb(len(v)) + v
    if tp == _STRUCT:
        return v.encode()
    if tp == _LIST:
        etp, items = v
        n = len(items)
        head = bytes([(n << 4) | etp]) if n < 15 else \
            bytes([0xF0 | etp]) + _uleb(n)
        return head + b"".join(_value(etp, x) for x in items)
    raise ValueError(f"thrift type {tp}")


# ---- encodings --------------------------------------------------------------

def _bitpack(values: np.ndarray, width: int) -> bytes:
    """One bit-packed run of the RLE/bit-packed hybrid: values in groups
    of eight, each `width` bits (at most 32), least significant bit
    first."""
    n = len(values)
    groups = (n + 7) // 8
    v = np.zeros(groups * 8, np.uint32)
    v[:n] = values
    bits = np.unpackbits(v.view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")[:, :width]
    return _uleb((groups << 1) | 1) + \
        np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _dictionary(kind: str, vals):
    """(sorted distinct values, each value's index), or None for a kind
    with no dictionary here. Integers of a narrow range go by counting."""
    if kind == "bool":
        return None
    if kind == "string":
        uniq = sorted(set(vals))
        index = {s: i for i, s in enumerate(uniq)}
        return uniq, np.array([index[s] for s in vals], np.uint32)
    arr = np.asarray(vals)
    if arr.dtype.kind == "i" and len(arr):
        lo = int(arr.min())
        span = int(arr.max()) - lo + 1
        if span <= 4 * DICT_MAX:
            seen = np.bincount((arr - lo).astype(np.int64), minlength=span)
            codes = np.nonzero(seen)[0]
            remap = np.zeros(span, np.uint32)
            remap[codes] = np.arange(len(codes), dtype=np.uint32)
            return ((codes + lo).astype(arr.dtype),
                    remap[(arr - lo).astype(np.int64)])
    uniq = np.unique(arr)
    return uniq, np.searchsorted(uniq, arr).astype(np.uint32)


def _plain(kind: str, values) -> bytes:
    if kind == "string":
        return b"".join(struct.pack("<I", len(s)) + s for s in values)
    if kind == "bool":
        return np.packbits(np.asarray(values, np.uint8),
                           bitorder="little").tobytes()
    return np.ascontiguousarray(values, _KINDS[kind][2]).tobytes()


def _stat(kind: str, v) -> bytes:
    if kind == "string":
        return v
    if kind == "bool":
        return bytes([int(v)])
    return np.asarray([v], _KINDS[kind][2]).tobytes()


def _compress(codec: str, raw: bytes) -> bytes:
    if codec == "UNCOMPRESSED":
        return raw
    co = zlib.compressobj(1, zlib.DEFLATED, 31)      # a gzip stream
    return co.compress(raw) + co.flush()


def _page(codec: str, header: _Struct, raw: bytes) -> bytes:
    body = _compress(codec, raw)
    header.add(2, _I32, len(raw)).add(3, _I32, len(body))
    return header.encode() + body


# ---- the writer -------------------------------------------------------------

def _as_column(kind: str, values, validity):
    """(present values, validity as a bool array or None, n)."""
    if kind == "string":
        vals = list(values)
        n = len(vals)
        valid = (np.array([v is not None for v in vals], np.bool_)
                 if validity is None else np.asarray(validity, np.bool_))
        enc = [v.encode() if isinstance(v, str) else bytes(v)
               for v, ok in zip(vals, valid) if ok]
        return enc, (None if validity is None and valid.all() else valid), n
    arr = np.asarray(values, _KINDS[kind][2])
    n = len(arr)
    if validity is None:
        return arr, None, n
    valid = np.asarray(validity, np.bool_)
    return arr[valid], valid, n


def _chunk(kind: str, present, valid: Optional[np.ndarray], lo: int,
           hi: int, codec: str, use_dict: Optional[bool], offset: int):
    """(bytes, ColumnMetaData fields) of one column chunk of rows
    [lo, hi), written at file offset `offset`."""
    if valid is None:
        rows_valid = None
        vals = present[lo:hi]
    else:
        rows_valid = valid[lo:hi]
        before = int(valid[:lo].sum())
        count = int(rows_valid.sum())
        vals = present[before:before + count]
    n = hi - lo
    nulls = 0 if rows_valid is None else int(n - rows_valid.sum())
    stats = _Struct().add(3, _I64, nulls)
    if len(vals):
        if kind == "string":
            lo_v, hi_v = min(vals), max(vals)
        else:
            arr = np.asarray(vals)
            ok = not (arr.dtype.kind == "f" and np.isnan(arr).any())
            lo_v, hi_v = (arr.min(), arr.max()) if ok else (None, None)
        if lo_v is not None:
            stats.add(5, _BINARY, _stat(kind, hi_v))
            stats.add(6, _BINARY, _stat(kind, lo_v))
    levels = b""
    if rows_valid is not None:
        lv = _bitpack(rows_valid.astype(np.uint64), 1)
        levels = struct.pack("<I", len(lv)) + lv
    out = bytearray()
    dict_offset = None
    coded = _dictionary(kind, vals) if use_dict is not False else None
    if use_dict is None:
        use_dict = coded is not None and len(vals) > 0 and len(coded[0]) <= \
            min(DICT_MAX, max(len(vals) // 2, 1))
    encodings = [_ENC_RLE, _ENC_PLAIN]
    if use_dict:
        uniq, idx = coded
        width = max(int(len(uniq) - 1).bit_length(), 0)
        dict_offset = offset
        dh = _Struct().add(1, _I32, len(uniq)).add(2, _I32, _ENC_PLAIN)
        out += _page(codec, _Struct().add(1, _I32, _PAGE_DICT)
                     .add(7, _STRUCT, dh), _plain(kind, uniq))
        data = levels + bytes([width]) + _bitpack(idx, width)
        value_enc = _ENC_RLE_DICT
        encodings.append(_ENC_RLE_DICT)
    else:
        data = levels + _plain(kind, vals)
        value_enc = _ENC_PLAIN
    data_offset = offset + len(out)
    ph = (_Struct().add(1, _I32, n).add(2, _I32, value_enc)
          .add(3, _I32, _ENC_RLE).add(4, _I32, _ENC_RLE))
    out += _page(codec, _Struct().add(1, _I32, _PAGE_DATA)
                 .add(5, _STRUCT, ph), data)
    meta = {"encodings": encodings, "num_values": n,
            "size": len(out), "data_offset": data_offset,
            "dict_offset": dict_offset, "stats": stats}
    return bytes(out), meta


def write_parquet(path: str, columns: Sequence, row_group_rows: int,
                  codec: str = "UNCOMPRESSED", dictionary="auto") -> int:
    """Write `columns` [(name, kind, values, validity or None), ...] to
    `path` in row groups of `row_group_rows`; returns the file's bytes.

    `values` is a numpy array of the kind's width (a list of str or bytes
    for "string", None for a null); `validity` (bool, True = valid) makes
    the column OPTIONAL, as does a None in a string list. `codec` is
    "UNCOMPRESSED" or "GZIP". `dictionary` is "auto" (a chunk with at most
    DICT_MAX distinct values and at most half as many as its rows), or a
    collection of column names, or None."""
    if codec not in _CODECS:
        raise ValueError(f"codec {codec!r}: UNCOMPRESSED or GZIP")
    cols = []
    for name, kind, values, validity in columns:
        if kind not in _KINDS:
            raise ValueError(f"column {name!r}: kind {kind!r}")
        present, valid, n = _as_column(kind, values, validity)
        cols.append((name, kind, present, valid, n))
    n_rows = cols[0][4] if cols else 0
    if any(c[4] != n_rows for c in cols):
        raise ValueError("columns of unequal length")
    schema = [_Struct().add(4, _BINARY, "schema").add(5, _I32, len(cols))]
    for name, kind, _, valid, _ in cols:
        phys, conv, _ = _KINDS[kind]
        schema.append(_Struct().add(1, _I32, phys)
                      .add(3, _I32, _REQUIRED if valid is None
                           else _OPTIONAL)
                      .add(4, _BINARY, name).add(6, _I32, conv))
    row_groups = []
    with open(path, "wb") as f:
        f.write(b"PAR1")
        offset = 4
        for lo in range(0, n_rows, max(1, row_group_rows)):
            hi = min(n_rows, lo + row_group_rows)
            chunks, total = [], 0
            for name, kind, present, valid, _ in cols:
                use_dict = (None if dictionary == "auto" else
                            bool(dictionary) and name in dictionary)
                raw, meta = _chunk(kind, present, valid, lo, hi, codec,
                                   use_dict, offset)
                f.write(raw)
                md = (_Struct().add(1, _I32, _KINDS[kind][0])
                      .add(2, _LIST, (_I32, meta["encodings"]))
                      .add(3, _LIST, (_BINARY, [name]))
                      .add(4, _I32, _CODECS[codec])
                      .add(5, _I64, meta["num_values"])
                      .add(6, _I64, meta["size"])
                      .add(7, _I64, meta["size"])
                      .add(9, _I64, meta["data_offset"])
                      .add(11, _I64, meta["dict_offset"])
                      .add(12, _STRUCT, meta["stats"]))
                chunks.append(_Struct().add(2, _I64, offset)
                              .add(3, _STRUCT, md))
                offset += len(raw)
                total += len(raw)
            row_groups.append(_Struct().add(1, _LIST, (_STRUCT, chunks))
                              .add(2, _I64, total).add(3, _I64, hi - lo))
        meta = (_Struct().add(1, _I32, 1)
                .add(2, _LIST, (_STRUCT, schema))
                .add(3, _I64, n_rows)
                .add(4, _LIST, (_STRUCT, row_groups))
                .add(6, _BINARY, "spark-rapids-tpu tests/torch_parquet_writer")
                ).encode()
        f.write(meta)
        f.write(struct.pack("<I", len(meta)))
        f.write(b"PAR1")
        return offset + len(meta) + 8


def write_table(path: str, names: Sequence[str], arrays: Sequence[np.ndarray],
                row_group_rows: int, codec: str = "UNCOMPRESSED",
                dictionary="auto") -> int:
    """`write_parquet` of INT64/INT32/FLOAT64 numpy columns, no nulls."""
    kinds = {np.dtype(np.int64): "int64", np.dtype(np.int32): "int32",
             np.dtype(np.float64): "float64", np.dtype(np.float32): "float32"}
    return write_parquet(
        path, [(n, kinds[np.asarray(a).dtype], a, None)
               for n, a in zip(names, arrays)],
        row_group_rows, codec, dictionary)


# ---- committed fixtures -----------------------------------------------------

FIXTURES = ("snappy_dict_strings", "zstd_decimal_int96", "gzip_v2_delta",
            "snappy_list_struct")


def fixture_values(name: str) -> Dict[str, List]:
    """The rows of fixture `name`, from its seed, in the port's image."""
    rng = np.random.default_rng(FIXTURES.index(name) + 1)
    n = 300
    if name == "snappy_dict_strings":
        words = ["alpha", "beta", "", "γamma", "delta-δ", "e"]
        s = [None if rng.random() < 0.15 else words[int(rng.integers(0, 6))]
             for _ in range(n)]
        k = [int(v) for v in rng.integers(0, 7, n)]
        return {"s": s, "k": k}
    if name == "zstd_decimal_int96":
        dec = [None if rng.random() < 0.1 else
               int(rng.integers(-10**17, 10**17)) * 10**20
               + int(rng.integers(0, 10**18)) for _ in range(n)]
        # INT96 and TIMESTAMP_MICROS: microseconds since the epoch
        ts = [None if rng.random() < 0.1 else
              int(rng.integers(-2 * 10**15, 4 * 10**15)) for _ in range(n)]
        day = [int(v) for v in rng.integers(-20000, 40000, n)]
        return {"dec": dec, "ts96": ts, "day": day}
    if name == "gzip_v2_delta":
        i64 = [int(v) for v in np.cumsum(rng.integers(-1000, 1000, n))]
        i32 = [None if i % 13 == 0 else int(v)
               for i, v in enumerate(rng.integers(-10**6, 10**6, n))]
        s = [None if i % 11 == 0 else f"prefix-{i // 3}-suffix{i}"
             for i in range(n)]
        f = [float(v) for v in rng.standard_normal(n)]
        return {"i64": i64, "i32": i32, "s": s, "f": f}
    if name == "snappy_list_struct":
        rows = []
        for i in range(n):
            if i % 17 == 0:
                rows.append(None)
                continue
            rows.append([{"x": None if rng.random() < 0.2
                          else int(rng.integers(0, 100)),
                          "y": None if rng.random() < 0.2 else
                          "v%d" % int(rng.integers(0, 9))}
                         for _ in range(int(rng.integers(0, 4)))])
        return {"ls": rows, "id": list(range(n))}
    raise KeyError(name)


def write_fixtures(directory: str = DATA_DIR) -> None:    # pragma: no cover
    """Write the committed fixtures with pyarrow (run once, by hand, on a
    machine that has it)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(directory, exist_ok=True)

    def path(name):
        return os.path.join(directory, name + ".parquet")

    v = fixture_values("snappy_dict_strings")
    pq.write_table(pa.table({"s": pa.array(v["s"], pa.string()),
                             "k": pa.array(v["k"], pa.int64())}),
                   path("snappy_dict_strings"), compression="SNAPPY",
                   use_dictionary=True, row_group_size=128)
    v = fixture_values("zstd_decimal_int96")
    import decimal
    ctx = decimal.Context(prec=50)      # 38 digits without rounding
    dec = pa.array([None if x is None else
                    decimal.Decimal(x).scaleb(-3, context=ctx)
                    for x in v["dec"]], pa.decimal128(38, 3))
    pq.write_table(pa.table({"dec": dec,
                             "ts96": pa.array(v["ts96"], pa.timestamp("us")),
                             "day": pa.array(v["day"], pa.date32())}),
                   path("zstd_decimal_int96"), compression="ZSTD",
                   use_deprecated_int96_timestamps=True, row_group_size=200)
    v = fixture_values("gzip_v2_delta")
    pq.write_table(pa.table({"i64": pa.array(v["i64"], pa.int64()),
                             "i32": pa.array(v["i32"], pa.int32()),
                             "s": pa.array(v["s"], pa.string()),
                             "f": pa.array(v["f"], pa.float64())}),
                   path("gzip_v2_delta"), compression="GZIP",
                   use_dictionary=False, data_page_version="2.0",
                   column_encoding={"i64": "DELTA_BINARY_PACKED",
                                    "i32": "DELTA_BINARY_PACKED",
                                    "s": "DELTA_BYTE_ARRAY",
                                    "f": "BYTE_STREAM_SPLIT"},
                   row_group_size=128)
    v = fixture_values("snappy_list_struct")
    pq.write_table(pa.table({
        "ls": pa.array(v["ls"], pa.list_(pa.struct([("x", pa.int64()),
                                                    ("y", pa.string())]))),
        "id": pa.array(v["id"], pa.int64())}),
        path("snappy_list_struct"), compression="SNAPPY", row_group_size=100)
