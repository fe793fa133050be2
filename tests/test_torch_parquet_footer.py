"""The port's Parquet footer against the JAX package's, bit for bit.

Each case is one of `tests/test_parquet_footer.py`'s inputs: a file that
pyarrow writes (in memory, or under `tmp_path`), a split and a requested
schema. Both packages' `ParquetFooter.read_and_filter` run on the same
footer bytes and must agree on the counts, on the serialized footer byte
for byte and on the error text where one raises; `read_footer_stats`
must give equal statistics per row group and chunk, and
`select_row_groups` equal selections over the JAX tests' conjuncts.
Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import io

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.io as jio
import spark_rapids_tpu_torch.io as tio


def _write(table, row_group_size=None, **kw) -> bytes:
    sink = io.BytesIO()
    pq.write_table(table, sink, row_group_size=row_group_size,
                   compression="NONE", **kw)
    return sink.getvalue()


def _simple(n=1000):
    return pa.table({
        "a": pa.array(range(n), pa.int64()),
        "b": pa.array([f"s{i}" for i in range(n)], pa.string()),
        "c": pa.array([i * 0.5 for i in range(n)], pa.float64()),
    })


def _abc(m):
    return m.StructElement(a=m.ValueElement(), b=m.ValueElement(),
                           c=m.ValueElement())


def _nested():
    return pa.table({"s": pa.array([{"x": 1, "y": "a", "z": 2.0}] * 10),
                     "p": pa.array(range(10))})


def _list_map():
    return pa.table({
        "l": pa.array([[1, 2], [3]], pa.list_(pa.int64())),
        "m": pa.array([[("k", 7)], [("q", 8)]],
                      pa.map_(pa.string(), pa.int64())),
        "v": pa.array([1, 2])})


def _list_struct():
    return pa.table({"ls": pa.array(
        [[{"u": 1, "w": 2}], [{"u": 3, "w": 4}]],
        pa.list_(pa.struct([("u", pa.int64()), ("w", pa.int64())])))})


# name -> (file bytes, [(part_offset, part_length) or None for the whole
# file], schema(m), ignore_case)
_FILTER_CASES = {
    "roundtrip_identity": (lambda: _write(_simple()), [None], _abc, False),
    "prune_columns": (lambda: _write(_simple()), [None],
                      lambda m: m.StructElement(c=m.ValueElement(),
                                                a=m.ValueElement()), False),
    "case_insensitive": (
        lambda: _write(pa.table({"MixedCase": pa.array([1, 2, 3])})), [None],
        lambda m: m.StructElement(mixedcase=m.ValueElement()), True),
    "case_sensitive_no_match": (
        lambda: _write(pa.table({"MixedCase": pa.array([1, 2, 3])})), [None],
        lambda m: m.StructElement(mixedcase=m.ValueElement()), False),
    "missing_column_skipped": (
        lambda: _write(_simple()), [None],
        lambda m: m.StructElement(a=m.ValueElement(), zz=m.ValueElement()),
        False),
    "row_group_filter_by_midpoint": (
        lambda: _write(_simple(10_000), row_group_size=1000),
        [None, "beyond", "half"], _abc, False),
    "nested_struct_prune": (
        lambda: _write(_nested()), [None],
        lambda m: m.StructElement(s=m.StructElement(x=m.ValueElement(),
                                                    z=m.ValueElement())),
        False),
    "list_and_map_prune": (
        lambda: _write(_list_map()), [None],
        lambda m: m.StructElement(
            l=m.ListElement(m.ValueElement()),
            m=m.MapElement(m.ValueElement(), m.ValueElement())), False),
    "list_of_struct_inner_prune": (
        lambda: _write(_list_struct()), [None],
        lambda m: m.StructElement(ls=m.ListElement(
            m.StructElement(w=m.ValueElement()))), False),
    "type_mismatch_raises": (
        lambda: _write(_simple()), [None],
        lambda m: m.StructElement(a=m.StructElement(x=m.ValueElement())),
        False),
}


def _split(data: bytes, which):
    if which is None:
        return 0, len(data)
    if which == "beyond":
        return len(data) + 10, 5
    return 0, len(data) // 2


def _filtered(m, fb, part, schema, ignore_case):
    """(num_rows, num_columns, num_row_groups, serialized) or the error."""
    try:
        with m.ParquetFooter.read_and_filter(fb, part[0], part[1], schema,
                                             ignore_case) as f:
            return (f.get_num_rows(), f.get_num_columns(),
                    f.get_num_row_groups(), f.serialize_thrift_file())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(_FILTER_CASES))
def test_read_and_filter_equals_jax(case):
    make, splits, schema, ignore_case = _FILTER_CASES[case]
    data = make()
    fb = jio.parquet_footer.footer_thrift_bytes(data)
    assert tio.parquet_footer.footer_thrift_bytes(data) == fb
    for which in splits:
        part = _split(data, which)
        want = _filtered(jio, fb, part, schema(jio), ignore_case)
        got = _filtered(tio, fb, part, schema(tio), ignore_case)
        assert got == want, (case, which)
    if case == "type_mismatch_raises":
        assert want[0] == "ValueError"
    else:
        # the spliced file reads back in pyarrow
        n = int.from_bytes(data[-8:-4], "little")
        pq.read_table(io.BytesIO(data[:len(data) - 8 - n] + got[3]))


def test_garbage_buffer_raises_alike():
    msgs = []
    for m in (jio, tio):
        with pytest.raises(ValueError) as e:
            m.ParquetFooter.read_and_filter(
                b"\x99\x88\x77", 0, 10,
                m.StructElement(a=m.ValueElement()), False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _stats_rows(stats):
    return None if stats is None else [
        (rg.index, rg.num_rows,
         {k: dataclasses.astuple(v) for k, v in rg.columns.items()})
        for rg in stats]


def _nested_stats_file(tmp_path):
    table = pa.table({"s": pa.array([{"x": i, "y": float(i)}
                                     for i in range(50)]),
                      "p": pa.array(range(50))})
    path = tmp_path / "nested.parquet"
    pq.write_table(table, path, compression="NONE")
    return str(path)


_STATS_CASES = {
    "per_group_minmax": lambda tmp: _write(_simple(4000),
                                           row_group_size=1000),
    "none_safe_without_statistics": lambda tmp: _write(
        _simple(100), write_statistics=False),
    "nested_paths_and_file_source": _nested_stats_file,
    "null_groups": lambda tmp: _write(
        pa.table({"a": pa.array([None, 5, 6, 7], pa.int64())})),
    "garbage": lambda tmp: b"\x00" * 64,
}

# the JAX tests' conjunct lists, over the 4,000-row simple file
_CONJUNCTS = [[("a", "<", 1500)], [("a", ">=", 3000)], [("a", "==", 2500)],
              [("a", ">=", 1000), ("a", "<", 2000)], [("b", "==", "s1500")],
              [("zz", "<", 0)], [("a", "<", "x")], [("a", "<", 3)],
              [("c", ">", 1000.0)], []]


@pytest.mark.parametrize("case", sorted(_STATS_CASES))
def test_footer_stats_and_row_group_selection_equal_jax(tmp_path, case):
    source = _STATS_CASES[case](tmp_path)
    out = []
    for m in (jio, tio):
        try:
            stats = m.read_footer_stats(source)
        except ValueError as e:
            out.append(("ValueError", str(e)))
            continue
        n = len(stats)
        out.append((_stats_rows(stats),
                    [m.select_row_groups(stats, c, n) for c in _CONJUNCTS],
                    m.select_row_groups(None, [("a", "<", 0)], 4)))
    assert out[1] == out[0]
    if case == "garbage":
        assert out[0][0] == "ValueError"
