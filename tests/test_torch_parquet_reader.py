"""The port's Parquet reader against the JAX package's, bit for bit.

Each case is one of the inputs of `tests/test_parquet_reader.py` and
`tests/test_parquet_nested.py`: pyarrow writes the file once (under
`tmp_path`, or in memory), and `read_parquet` of both packages reads it
with the same `columns` and `row_groups`. Every column must agree in
dtype, length, data (floats by their bits; DECIMAL128 limbs; INT96 and
dates as the reference converts them), validity, offsets and children,
at every depth. `ParquetChunkedReader` is held chunk by chunk over a
multi-row-group file, and the errors (an unknown column, a row group out
of range) raise alike. Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import datetime
import decimal
import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu  # noqa: F401
import spark_rapids_tpu.io as jio
import spark_rapids_tpu_torch.io as tio


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "f":
        return a.view(np.uint32 if a.itemsize == 4 else np.uint64)
    if a.dtype == np.bool_:
        return a.astype(np.uint8)
    return a


def assert_columns_equal(jc, tc, where="col"):
    """One JAX column against one port column, every buffer."""
    jd, td = jc.dtype, tc.dtype
    assert (jd.kind.value, jd.precision, jd.scale) == \
        (td.kind.value, td.precision, td.scale), where
    assert tuple(getattr(jd, "field_names", ()) or ()) == \
        tuple(td.field_names or ()), where
    assert int(jc.length) == tc.length, where
    jv = (np.ones(tc.length, np.bool_) if jc.validity is None
          else np.asarray(jc.validity))
    tv = tc.null_mask.numpy()
    np.testing.assert_array_equal(tv, jv, err_msg=f"{where} validity")
    if jc.offsets is not None or tc.offsets is not None:
        np.testing.assert_array_equal(tc.offsets.numpy(),
                                      np.asarray(jc.offsets),
                                      err_msg=f"{where} offsets")
    if td.is_nested:
        assert tc.data is None, where
    else:
        jdata = np.asarray(jc.data)
        tdata = tc.data.numpy()
        assert tdata.shape == jdata.shape, where
        np.testing.assert_array_equal(_bits(tdata), _bits(jdata),
                                      err_msg=f"{where} data")
    assert len(jc.children) == len(tc.children), where
    for i, (a, b) in enumerate(zip(jc.children, tc.children)):
        assert_columns_equal(a, b, f"{where}.{i}")


def assert_tables_equal(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for name in jt.names:
        assert_columns_equal(jt[name], tt[name], name)


def _w(table, **kw):
    def make(tmp_path, name="t.parquet"):
        path = str(tmp_path / name)
        pq.write_table(table, path, **kw)
        return path
    return make


def _mem(table, **kw):
    def make(tmp_path):
        sink = io.BytesIO()
        pq.write_table(table, sink, **kw)
        return sink.getvalue()
    return make


def _plain_types():
    n, rng = 1000, np.random.default_rng(0)
    return pa.table({
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, n), pa.int32()),
        "i64": pa.array(rng.integers(-2**62, 2**62, n), pa.int64()),
        "f32": pa.array(rng.standard_normal(n), pa.float32()),
        "f64": pa.array(rng.standard_normal(n), pa.float64()),
        "b": pa.array(rng.integers(0, 2, n) == 1, pa.bool_())})


_STRINGS = pa.table({"s": pa.array(
    ["alpha", None, "", "beta", "alpha", None, "γunicodeγ", "beta"] * 50,
    pa.string())})


def _codec_table():
    n, rng = 5000, np.random.default_rng(1)
    raw = rng.integers(0, 50, n).astype(np.int64)
    mask = rng.random(n) < 0.1
    return pa.table({"x": pa.array([None if m else int(v)
                                    for v, m in zip(raw, mask)], pa.int64())})


def _mixed():
    rng = np.random.default_rng(7)
    n = 20_000
    mask = rng.random(n) < 0.15
    ints = [None if m else int(v) for m, v in
            zip(mask, rng.integers(-10**12, 10**12, n))]
    strs = [None if rng.random() < 0.1 else
            "".join(chr(97 + int(c))
                    for c in rng.integers(0, 26, rng.integers(0, 12)))
            for _ in range(n)]
    return pa.table({"i": pa.array(ints, pa.int64()),
                     "s": pa.array(strs, pa.string())})


def _delta():
    rng = np.random.default_rng(0)
    n = 5000
    return pa.table({
        "i32": pa.array(rng.integers(-10**6, 10**6, n).astype(np.int32)),
        "i64": pa.array(np.cumsum(rng.integers(-1000, 1000, n))
                        .astype(np.int64)),
        "s": pa.array([None if i % 11 == 0 else f"prefix-{i//3}-suffix{i}"
                       for i in range(n)])})


def _bss():
    rng = np.random.default_rng(1)
    n = 3000
    return pa.table({"f": pa.array(rng.standard_normal(n)
                                   .astype(np.float32)),
                     "d": pa.array(rng.standard_normal(n))})


_ROWS_I = [[1, 2, 3], None, [], [4, None, 6], [7]] * 400
_ROWS_S = [["a", "bb"], [], None, [None, "ccc"], ["d"]] * 400
_LISTS = pa.table({"li": pa.array(_ROWS_I, pa.list_(pa.int64())),
                   "ls": pa.array(_ROWS_S, pa.list_(pa.utf8())),
                   "flat": pa.array(range(len(_ROWS_I)))})
_SROWS = [{"x": 1, "y": "a"}, None, {"x": None, "y": "c"},
          {"x": 4, "y": None}] * 300
_DEEP = [{"inner": {"p": 1.5}, "q": 7}, {"inner": None, "q": 8}, None,
         {"inner": {"p": None}, "q": None}] * 300
_STRUCTS = pa.table({
    "s": pa.array(_SROWS, pa.struct([("x", pa.int64()), ("y", pa.utf8())])),
    "d": pa.array(_DEEP, pa.struct([("inner",
                                     pa.struct([("p", pa.float64())])),
                                    ("q", pa.int32())])),
    "flat": pa.array(range(len(_SROWS)))})
_DAYS = [datetime.date(2020, 1, 1), None, datetime.date(1969, 12, 31)]
_US = [datetime.datetime(2023, 5, 17, 1, 2, 3, 123456), None,
       datetime.datetime(1960, 1, 1)]
_I96 = [datetime.datetime(2001, 2, 3, 4, 5, 6, 789000), None,
        datetime.datetime(1970, 1, 1)]
_DEC = [decimal.Decimal("123456789012345678901234.567"), None,
        decimal.Decimal("-0.001"), decimal.Decimal("99.999")]
_SEQ = pa.table({"a": pa.array(range(4000), pa.int64()),
                 "b": pa.array([i * 0.5 for i in range(4000)],
                               pa.float64())})
_EMPTY_SEL = pa.table({"a": pa.array(range(100), pa.int64()),
                       "s": pa.array([f"v{i}" for i in range(100)],
                                     pa.string()),
                       "f": pa.array([i * 1.5 for i in range(100)],
                                     pa.float64())})


def _nested_rows():
    rng = np.random.default_rng(0)
    rows = []
    for i in range(400):
        if i % 17 == 0:
            rows.append(None)
        else:
            rows.append([{"x": int(rng.integers(0, 5)),
                          "y": ["v%d" % (i % 3)] * int(rng.integers(0, 3))}
                         for _ in range(int(rng.integers(0, 4)))])
    return pa.table({"r": pa.array(rows, pa.list_(pa.struct(
        [("x", pa.int64()), ("y", pa.list_(pa.string()))])))})


def _legacy_two_level(tmp_path):
    """The JAX test's hand-built 2-level LIST file (pyarrow cannot write
    one)."""
    from test_parquet_nested import _legacy_two_level_file
    return _legacy_two_level_file()


# case -> (make(tmp_path) -> source, [read kwargs, ...])
_CASES = {
    # tests/test_parquet_reader.py
    "plain_types": (_w(_plain_types(), use_dictionary=False,
                       compression="NONE"), [{}]),
    "strings_dict_none": (_w(_STRINGS, use_dictionary=True,
                             compression="NONE"), [{}]),
    "strings_dict_snappy": (_w(_STRINGS, use_dictionary=True,
                               compression="SNAPPY"), [{}]),
    "strings_zstd": (_w(_STRINGS, use_dictionary=False,
                        compression="ZSTD"), [{}]),
    "codec_none": (_w(_codec_table(), compression="NONE"), [{}]),
    "codec_snappy": (_w(_codec_table(), compression="SNAPPY"), [{}]),
    "codec_gzip": (_w(_codec_table(), compression="GZIP"), [{}]),
    "codec_zstd": (_w(_codec_table(), compression="ZSTD"), [{}]),
    "multiple_row_groups": (_w(pa.table({"x": pa.array(np.arange(10_000),
                                                        pa.int64())}),
                               row_group_size=1024), [{}]),
    "column_projection": (_w(pa.table({
        "a": pa.array([1, 2, 3], pa.int32()),
        "b": pa.array(["x", "y", "z"]),
        "c": pa.array([1.5, 2.5, 3.5], pa.float64())})),
        [{"columns": ["c", "a"]}, {}]),
    "date_and_timestamps": (_w(pa.table({
        "d": pa.array(_DAYS, pa.date32()),
        "ts": pa.array(_US, pa.timestamp("us")),
        "ms": pa.array(_US, pa.timestamp("ms"))})), [{}]),
    "int96_legacy_timestamps": (_w(pa.table({
        "ts": pa.array(_I96, pa.timestamp("us"))}),
        use_deprecated_int96_timestamps=True), [{}]),
    "decimal128_flba": (_w(pa.table({
        "dec": pa.array(_DEC, pa.decimal128(38, 3))})), [{}]),
    "decimal64_int_backed": (_w(pa.table({"d": pa.array(
        [decimal.Decimal("12.34"), decimal.Decimal("-5.00"), None],
        pa.decimal128(10, 2))}), store_decimal_as_integer=True), [{}]),
    "data_page_v2": (_w(pa.table({"x": pa.array(
        [None if i % 7 == 0 else i * 11 for i in range(3000)], pa.int64())}),
        data_page_version="2.0", compression="SNAPPY"), [{}]),
    "all_nulls_column": (_w(pa.table({"x": pa.array([None] * 3,
                                                    pa.int32())})), [{}]),
    "empty_file": (_w(pa.table({"x": pa.array([], pa.int64()),
                                "s": pa.array([], pa.string())})), [{}]),
    "random_mixed": (_w(_mixed(), row_group_size=4096,
                        compression="SNAPPY"), [{}]),
    "delta_byte_array": (_w(_delta(), use_dictionary=False,
                            data_page_version="2.0", compression="NONE",
                            row_group_size=1234,
                            column_encoding={"i32": "DELTA_BINARY_PACKED",
                                             "i64": "DELTA_BINARY_PACKED",
                                             "s": "DELTA_BYTE_ARRAY"}),
                         [{}]),
    "delta_length_byte_array": (_w(
        _delta(), use_dictionary=False, data_page_version="2.0",
        compression="SNAPPY", row_group_size=1234,
        column_encoding={"i32": "DELTA_BINARY_PACKED",
                         "i64": "DELTA_BINARY_PACKED",
                         "s": "DELTA_LENGTH_BYTE_ARRAY"}), [{}]),
    "byte_stream_split": (_w(_bss(), use_dictionary=False,
                             use_byte_stream_split=True, compression="ZSTD",
                             row_group_size=777), [{}]),
    "lists_v1_snappy": (_w(_LISTS, row_group_size=777, version="1.0",
                           compression="SNAPPY"),
                        [{}, {"columns": ["ls"]}]),
    "lists_v26_zstd": (_w(_LISTS, row_group_size=777, version="2.6",
                          compression="ZSTD"), [{}]),
    "lists_page_v2": (_w(_LISTS, row_group_size=777,
                         data_page_version="2.0"), [{}]),
    "lists_delta": (_w(_LISTS, row_group_size=777, use_dictionary=False,
                       data_page_version="2.0",
                       column_encoding={"li": "DELTA_BINARY_PACKED",
                                        "ls": "DELTA_BYTE_ARRAY",
                                        "flat": "DELTA_BINARY_PACKED"}),
                    [{}]),
    "list_required_elements": (_w(pa.table({"l": pa.array(
        [[1], [2, 3], []], pa.list_(pa.field("item", pa.int32(),
                                             nullable=False)))})), [{}]),
    "map_and_nested_struct_shapes": (_w(pa.table({
        "m": pa.array([{"a": 1}, {"b": 2}], pa.map_(pa.utf8(), pa.int64())),
        "lstruct": pa.array([[{"x": 1}], []],
                            pa.list_(pa.struct([("x", pa.int64())]))),
        "slist": pa.array([{"v": [1, 2]}, {"v": []}],
                          pa.struct([("v", pa.list_(pa.int64()))])),
        "ok": pa.array([10, 20]),
        "larr": pa.array([[1, 2], [3]], pa.list_(pa.int64()))})), [{}]),
    "structs_multi_row_group": (_w(_STRUCTS, row_group_size=500),
                                [{}, {"columns": ["d", "flat"]}]),
    "structs_v2_zstd": (_w(_STRUCTS, row_group_size=500,
                           data_page_version="2.0", compression="ZSTD"),
                        [{}]),
    "struct_required_fields": (_w(pa.table({"s": pa.array(
        [{"a": 1}, {"a": 2}],
        pa.struct([pa.field("a", pa.int64(), nullable=False)]))})), [{}]),
    "optional_struct_all_required_members": (_w(pa.table({"s": pa.array(
        [{"a": 1}, None, {"a": 3}],
        pa.struct([pa.field("a", pa.int64(), nullable=False)]))})), [{}]),
    "struct_with_mixed_members": (_w(pa.table({
        "s": pa.array([{"x": 1, "v": [1, 2]}],
                      pa.struct([("x", pa.int64()),
                                 ("v", pa.list_(pa.int64()))])),
        "ok": pa.array([5])})), [{}]),
    "row_groups_selection": (_w(_SEQ, row_group_size=1000,
                                compression="NONE"),
                             [{"columns": ["a"], "row_groups": [1, 3]},
                              {"row_groups": [2]}]),
    "zero_row_groups_typed_empty": (_w(_EMPTY_SEL, compression="NONE"),
                                    [{"row_groups": []},
                                     {"columns": ["f", "a"],
                                      "row_groups": []}]),
    "zero_row_group_file": (_mem(pa.table({
        "a": pa.array([], pa.int64()), "s": pa.array([], pa.string())}),
        compression="NONE"), [{}, {"columns": ["s"]}]),
    # tests/test_parquet_nested.py (in memory, as there)
    "map_with_nulls_and_empties": (_mem(pa.table({"m": pa.array(
        [[("a", 1), ("b", 2)], None, [], [("c", None)], [("d", 4)]],
        pa.map_(pa.string(), pa.int64()))})), [{}]),
    "list_of_struct_all_member_types": (_mem(pa.table({"ls": pa.array(
        [[{"x": 1, "y": "ab", "z": 1.5}, {"x": None, "y": None, "z": None}],
         None, [], [{"x": 3, "y": "日本", "z": -2.25}]],
        pa.list_(pa.struct([("x", pa.int64()), ("y", pa.string()),
                            ("z", pa.float64())])))})), [{}]),
    "struct_of_list_and_plain_members": (_mem(pa.table({"sl": pa.array(
        [{"v": [1, 2], "w": 9, "s": "p"}, None,
         {"v": None, "w": 8, "s": None}, {"v": [], "w": None, "s": "q"}],
        pa.struct([("v", pa.list_(pa.int64())), ("w", pa.int64()),
                   ("s", pa.string())]))})), [{}]),
    "list_of_list_of_strings": (_mem(pa.table({"ll": pa.array(
        [[["a", "bb"], []], None, [None], [["ccc", None], ["d"]]],
        pa.list_(pa.list_(pa.string())))})), [{}]),
    "map_of_list_values": (_mem(pa.table({"mv": pa.array(
        [[("a", [1, 2]), ("b", [])], None, [("c", None)], []],
        pa.map_(pa.string(), pa.list_(pa.int64())))})), [{}]),
    "struct_in_map_value": (_mem(pa.table({"ms": pa.array(
        [[("k1", {"a": 1, "b": "x"})], None,
         [("k2", None), ("k3", {"a": None, "b": "y"})]],
        pa.map_(pa.string(), pa.struct([("a", pa.int64()),
                                        ("b", pa.string())])))})), [{}]),
    "three_level_deep_nesting": (_mem(pa.table({"deep": pa.array(
        [[{"tags": [["t1", "t2"], []], "n": 1}], None,
         [{"tags": None, "n": 2}, {"tags": [["t3"]], "n": None}]],
        pa.list_(pa.struct([("tags", pa.list_(pa.list_(pa.string()))),
                            ("n", pa.int64())])))})), [{}]),
    "nested_multiple_row_groups_and_dictionary": (
        _mem(_nested_rows(), row_group_size=64), [{}]),
    "nested_alongside_flat": (_mem(pa.table({
        "m": pa.array([[("a", 1)], None], pa.map_(pa.string(), pa.int64())),
        "plain": pa.array([7, 8])})), [{}, {"columns": ["plain"]}]),
    "legacy_two_level_repeated_primitive": (_legacy_two_level, [{}]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_read_parquet_equals_jax(tmp_path, case):
    make, reads = _CASES[case]
    source = make(tmp_path)
    for kw in reads:
        want = jio.read_parquet(source, **kw)
        got = tio.read_parquet(source, device="cpu", **kw)
        assert_tables_equal(want, got)


def test_chunked_reader_equals_jax_chunk_by_chunk(tmp_path):
    path = _w(_mixed(), row_group_size=4096, compression="SNAPPY")(tmp_path)
    with jio.ParquetChunkedReader(path, columns=["s", "i"],
                                  row_groups=[4, 0, 2]) as jr, \
            tio.ParquetChunkedReader(path, columns=["s", "i"],
                                     row_groups=[4, 0, 2],
                                     device="cpu") as tr:
        assert (tr.num_rows, tr.num_row_groups, tr.column_names) == \
            (jr.num_rows, jr.num_row_groups, jr.column_names)
        n = 0
        while jr.has_next():
            assert tr.has_next()
            assert_tables_equal(jr.read_chunk(), tr.read_chunk())
            n += 1
        assert n == 3 and not tr.has_next()


@pytest.mark.parametrize("kw,err", [({"columns": ["nope"]}, KeyError),
                                    ({"row_groups": [4]}, IndexError)])
def test_errors_equal_jax(tmp_path, kw, err):
    path = _w(_SEQ, row_group_size=1000)(tmp_path)
    msgs = []
    for call in (lambda: jio.read_parquet(path, **kw),
                 lambda: tio.read_parquet(path, device="cpu", **kw)):
        with pytest.raises(err) as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_decode_releases_the_gil_and_no_library_is_committed():
    """The reader's library is the port's own build, loaded with CDLL
    (which releases the GIL around each call, so a prefetch thread's
    decode overlaps the executing thread), named by its source's hash
    under `_build/`."""
    import ctypes
    from spark_rapids_tpu_torch.io import parquet as tpq
    from spark_rapids_tpu_torch.native import build
    lib = tpq._native()
    assert type(lib) is ctypes.CDLL and not isinstance(lib, ctypes.PyDLL)
    path = build.library_path("parquet_reader")
    assert path.parent.name == "_build" and path.exists()
    assert build.build_seconds("parquet_reader") == 0.0
