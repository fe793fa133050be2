"""The port's `concat_columns`/`concat_tables` against the JAX package's
`spark_rapids_tpu.ops.concat_tables` on the same numpy buffers: every
fixed-width kind, validity on none, one or all inputs, empty inputs, three
and more tables, and each error. The tolerance is exact: the data buffers
are compared byte for byte (NaN payloads and -0.0 included), the
validity and dtype kind as they are."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu import ops as jops

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.ops import copying

_KINDS = ["int8", "int16", "int32", "int64", "float32", "float64", "bool"]


def _data(kind, n, rng):
    if kind == "bool":
        return rng.random(n) > 0.5
    dt = np.dtype(kind)
    if dt.kind == "f":
        v = rng.standard_normal(n).astype(dt)
        special = np.array([-0.0, np.nan, np.inf, -np.inf, 0.0], dtype=dt)
        # a NaN with a payload of its own, past the canonical one
        special[1] = np.frombuffer(
            (b"\x01\x00\xc0\x7f" if dt == np.float32 else
             b"\x01\x00\x00\x00\x00\x00\xf8\x7f"), dtype=dt)[0]
        v[:min(n, 5)] = special[:min(n, 5)]
        return v
    ii = np.iinfo(dt)
    return rng.integers(ii.min, ii.max, n, dtype=dt, endpoint=True)


def _pair(names, arrays, valids):
    """A JAX-package table and a port table (CPU) of the same buffers."""
    jt = JTable([JColumn.from_numpy(a, validity=v)
                 for a, v in zip(arrays, valids)], names=names)
    kinds = ["bool" if a.dtype == np.bool_ else a.dtype.name for a in arrays]
    tt = table_from_numpy(names, arrays, valids, kinds, device="cpu")
    return jt, tt


def _assert_same(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert tc.dtype.kind.value == jc.dtype.kind.value
        data, valid = tc.to_numpy()
        want = np.asarray(jc.data)
        assert data.dtype == want.dtype
        npt.assert_array_equal(data.view(np.uint8), want.view(np.uint8))
        if jc.validity is None:
            assert valid is None
        else:
            npt.assert_array_equal(valid, np.asarray(jc.validity))


def _inputs(kind, sizes, nulls, seed):
    """One two-column table per size, `nulls[i]` saying whether table i
    carries validity (on its first column only)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i, (n, has) in enumerate(zip(sizes, nulls)):
        arrays = [_data(kind, n, rng), _data("int64", n, rng)]
        valids = [rng.random(n) > 0.3 if has else None, None]
        # the second table's names differ: the result takes the first's
        names = ["a", "b"] if i == 0 else [f"x{i}", f"y{i}"]
        pairs.append(_pair(names, arrays, valids))
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("nulls", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("kind", _KINDS)
def test_concat_two_tables_matches_jax(kind, nulls):
    jts, tts = _inputs(kind, (37, 12), nulls, seed=len(kind))
    got = copying.concat_tables(tts)
    _assert_same(jops.concat_tables(jts), got)
    assert got.names == ("a", "b")
    assert (got["a"].validity is None) == (not any(nulls))


@pytest.mark.parametrize("sizes,nulls", [
    ((5, 0, 9), (False, True, False)),          # an empty middle table
    ((0, 0), (False, False)),                   # empty on both sides
    ((0, 4), (True, False)),
    ((3, 1, 4, 1, 5), (False, False, True, False, True)),
    ((8,), (True,)),                            # one table alone
])
@pytest.mark.parametrize("kind", ["int32", "float64", "bool"])
def test_concat_many_and_empty_tables_match_jax(kind, sizes, nulls):
    jts, tts = _inputs(kind, sizes, nulls, seed=sum(sizes))
    _assert_same(jops.concat_tables(jts), copying.concat_tables(tts))


def test_concat_columns_and_logical_kinds():
    """DATE32 and decimal columns keep their logical type; a dtype that
    differs only in its decimal scale is a mismatch, as in the reference."""
    a = Column.from_numpy(np.arange(4, dtype=np.int32), tdt.DATE32,
                          device="cpu")
    b = Column.from_numpy(np.arange(3, dtype=np.int32), tdt.DATE32,
                          np.array([True, False, True]), device="cpu")
    c = copying.concat_columns([a, b])
    assert c.dtype == tdt.DATE32 and c.length == 7
    assert c.to_pylist() == [0, 1, 2, 3, 0, None, 2]
    d1 = Column.from_numpy(np.arange(2, dtype=np.int64), tdt.decimal(12, 2),
                           device="cpu")
    d2 = Column.from_numpy(np.arange(2, dtype=np.int64), tdt.decimal(12, 3),
                           device="cpu")
    with pytest.raises(TypeError, match="dtype mismatch"):
        copying.concat_columns([d1, d2])


def test_errors_match_the_reference():
    jts, tts = _inputs("int64", (3, 2), (False, False), seed=1)
    for fn, args in ((jops.concat_tables, [jts[0], jts[1].select(["x1"])]),
                     (copying.concat_tables,
                      [tts[0], tts[1].select(["x1"])])):
        with pytest.raises(ValueError, match="column-count mismatch"):
            fn(args)
    for fn in (jops.concat_tables, copying.concat_tables):
        with pytest.raises(ValueError, match="at least one table"):
            fn([])
    with pytest.raises(ValueError, match="at least one column"):
        copying.concat_columns([])
    ji, ti = _inputs("int32", (3,), (False,), seed=2)
    for fn, a, b in ((jops.concat_tables, jts[0], ji[0]),
                     (copying.concat_tables, tts[0], ti[0])):
        with pytest.raises(TypeError, match="dtype mismatch"):
            fn([a, b])


def test_unported_kinds_name_their_roadmap_item():
    """String columns concatenate, and the concatenation sorts as a key
    (ROADMAP queue A item 3, done): its order and rows equal the JAX
    package's, nulls first ascending and last descending."""
    from spark_rapids_tpu import dtypes as jdt
    from spark_rapids_tpu.ops import sort as jsort
    from spark_rapids_tpu_torch.ops import sort
    vals = ["a", None, "bcd", "", "ab", "\u00e9"]
    col = Column.from_pylist(vals, tdt.STRING, device="cpu")
    t = copying.concat_tables([Table([col], ["a"]), Table([col], ["a"])])
    assert t["a"].to_pylist() == vals * 2
    jcol = JColumn.from_pylist(vals * 2, jdt.STRING)
    for asc in (True, False):
        want = np.asarray(jsort.sorted_order([jcol], asc).data)
        npt.assert_array_equal(sort.sorted_order(t, asc).data.numpy(), want)
        assert sort.sort_table(t, ascending=asc)["a"].to_pylist() == \
            [(vals * 2)[i] for i in want]
