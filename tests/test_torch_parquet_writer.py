"""The JAX-free Parquet writer (`tests/torch_parquet_writer.py`) and the
committed fixtures, against pyarrow and both packages' readers.

- pyarrow reads every file the writer makes to exactly the arrays it was
  given (each kind, nulls, dictionary and PLAIN chunks, UNCOMPRESSED and
  GZIP, several row groups), and so does the port's reader;
- both packages' `read_footer_stats` see the writer's statistics: per row
  group and column the min, max and null count of the rows written;
- each committed fixture under `tests/data/torch_parquet/` reads, in
  pyarrow and in the port, to the values its seed function gives, which
  is what `chip_smoke.py` holds the card's reads to.

Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import datetime
import os

import numpy as np
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.io as jio
import spark_rapids_tpu_torch.io as tio

import torch_parquet_writer as w

_N = 2_500
_RG = 1_000


def _columns():
    rng = np.random.default_rng(5)
    valid = rng.random(_N) > 0.2
    words = [f"w{i:02d}" for i in range(12)] + ["", "δέλτα"]
    return [
        ("i64", "int64", rng.integers(-10**12, 10**12, _N), None),
        ("i64_dict", "int64", rng.integers(0, 50, _N), None),
        ("i32", "int32", rng.integers(-9, 9, _N).astype(np.int32), valid),
        ("f64", "float64", rng.standard_normal(_N), None),
        ("f32", "float32", rng.standard_normal(_N).astype(np.float32), valid),
        ("b", "bool", rng.random(_N) > 0.5, valid),
        ("d", "date32", rng.integers(-400, 20000, _N).astype(np.int32), None),
        ("s", "string", [None if rng.random() < 0.1 else
                         words[int(rng.integers(0, len(words)))]
                         for _ in range(_N)], None),
        ("u", "string", [f"row-{i}" for i in range(_N)], None),
    ]


def _expected(kind, values, validity):
    out = []
    for i, v in enumerate(values):
        if validity is not None and not validity[i]:
            out.append(None)
        elif kind == "string":
            out.append(v)
        else:
            out.append(v.item())
    return out


def _pyarrow_rows(table, name, kind):
    vals = table.column(name).to_pylist()
    if kind == "date32":
        epoch = datetime.date(1970, 1, 1)
        return [None if v is None else (v - epoch).days for v in vals]
    return vals


@pytest.mark.parametrize("codec,dictionary", [
    ("UNCOMPRESSED", "auto"), ("GZIP", "auto"), ("GZIP", None),
    ("UNCOMPRESSED", ("i64", "u", "f64"))])
def test_pyarrow_and_the_port_read_the_writers_arrays(tmp_path, codec,
                                                      dictionary):
    path = str(tmp_path / "w.parquet")
    cols = _columns()
    w.write_parquet(path, cols, _RG, codec, dictionary)
    md = pq.read_metadata(path)
    assert md.num_row_groups == 3 and md.num_rows == _N
    used = {md.row_group(0).column(i).path_in_schema:
            "RLE_DICTIONARY" in md.row_group(0).column(i).encodings
            for i in range(md.num_columns)}
    if dictionary == "auto":
        assert used["i64_dict"] and used["s"] and not used["i64"]
    elif dictionary is None:
        assert not any(used.values())
    else:
        assert {k for k, v in used.items() if v} == set(dictionary)
    table = pq.read_table(path)
    got = tio.read_parquet(path, device="cpu")
    for name, kind, values, validity in cols:
        want = _expected(kind, values, validity)
        assert _pyarrow_rows(table, name, kind) == want, name
        assert got[name].to_pylist() == want, name


def test_both_packages_read_the_writers_statistics(tmp_path):
    path = str(tmp_path / "w.parquet")
    cols = [c for c in _columns() if c[1] != "bool"]
    w.write_parquet(path, cols, _RG, "GZIP")
    stats = {m: m.read_footer_stats(path) for m in (jio, tio)}
    for m, rgs in stats.items():
        assert len(rgs) == 3
        for g, rg in enumerate(rgs):
            lo, hi = g * _RG, min(_N, (g + 1) * _RG)
            assert rg.num_rows == hi - lo
            for name, kind, values, validity in cols:
                st = rg.columns[name]
                rows = _expected(kind, values[lo:hi],
                                 None if validity is None
                                 else validity[lo:hi])
                present = [v for v in rows if v is not None]
                assert st.null_count == len(rows) - len(present), name
                if kind == "string":    # compared as bytes
                    present = [v.encode() for v in present]
                # a DATE's statistics decode as its INT32 day number
                assert (st.min, st.max) == (min(present), max(present)), name
    assert [[(k, v.min, v.max, v.null_count) for k, v in rg.columns.items()]
            for rg in stats[jio]] == \
        [[(k, v.min, v.max, v.null_count) for k, v in rg.columns.items()]
         for rg in stats[tio]]


def _pyarrow_image(name, rows):
    """pyarrow's rows in the port's image (fixture_values' form)."""
    if name == "dec":
        import decimal
        ctx = decimal.Context(prec=50)      # 38 digits without rounding
        return [None if v is None else int(v.scaleb(3, context=ctx))
                for v in rows]
    if name == "ts96":
        epoch = datetime.datetime(1970, 1, 1)
        return [None if v is None else
                (v - epoch) // datetime.timedelta(microseconds=1)
                for v in rows]
    if name == "day":
        epoch = datetime.date(1970, 1, 1)
        return [(v - epoch).days for v in rows]
    return rows


@pytest.mark.parametrize("fixture", w.FIXTURES)
def test_fixtures_read_to_their_seed_values(fixture):
    path = os.path.join(w.DATA_DIR, fixture + ".parquet")
    want = w.fixture_values(fixture)
    table = pq.read_table(path)
    got = tio.read_parquet(path, device="cpu")
    assert list(got.names) == list(want)
    for name, rows in want.items():
        assert _pyarrow_image(name, table.column(name).to_pylist()) == rows, \
            name
        assert got[name].to_pylist() == rows, name


def test_fixtures_cover_the_codecs_and_encodings():
    seen = set()
    total = 0
    for fixture in w.FIXTURES:
        path = os.path.join(w.DATA_DIR, fixture + ".parquet")
        total += os.path.getsize(path)
        md = pq.read_metadata(path)
        for g in range(md.num_row_groups):
            for c in range(md.num_columns):
                col = md.row_group(g).column(c)
                seen.add(col.compression)
                seen.update(col.encodings)
                seen.add(col.physical_type)
    assert {"SNAPPY", "ZSTD", "GZIP", "DELTA_BINARY_PACKED",
            "DELTA_BYTE_ARRAY", "RLE_DICTIONARY", "INT96",
            "FIXED_LEN_BYTE_ARRAY", "BYTE_STREAM_SPLIT"} <= seen
    assert total <= 64 * 1024
