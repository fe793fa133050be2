"""Tables across packages: a JAX `Table` -> numpy -> port `Table` round trip
is bit-exact, validity included (spark_rapids_tpu_torch/interop.py)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu import dtypes as jdt

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import nds_q3
from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.columnar import Column, Table


def jax_table_to_numpy(t: JTable):
    """(names, arrays, validities, dtypes) of a JAX table; dtypes as port
    DTypes (kind, precision, scale)."""
    arrays = [np.asarray(c.data) for c in t.columns]
    valids = [None if c.validity is None else np.asarray(c.validity)
              for c in t.columns]
    dts = [tdt.DType(tdt.Kind(c.dtype.kind.value), c.dtype.precision,
                     c.dtype.scale) for c in t.columns]
    return list(t.names), arrays, valids, dts


def _jax_table(n=257, seed=0):
    rng = np.random.default_rng(seed)
    cols = [
        JColumn.from_numpy(rng.integers(-2**62, 2**62, n).astype(np.int64),
                           validity=rng.random(n) > 0.2),
        JColumn.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)),
        JColumn.from_numpy(rng.integers(-2**15, 2**15, n).astype(np.int16),
                           validity=rng.random(n) > 0.5),
        JColumn.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
        JColumn.from_numpy(rng.random(n) > 0.5,
                           validity=rng.random(n) > 0.3),
        JColumn.from_numpy(rng.standard_normal(n).astype(np.float32)),
        JColumn.from_numpy(np.r_[rng.standard_normal(n - 3), np.nan, -0.0,
                                 np.inf].astype(np.float64),
                           validity=rng.random(n) > 0.1),
        JColumn.from_numpy(rng.integers(0, 20000, n).astype(np.int32),
                           dtype=jdt.DATE32),
        JColumn.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int64),
                           dtype=jdt.decimal(12, 2),
                           validity=rng.random(n) > 0.4),
        JColumn.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int32),
                           dtype=jdt.decimal(7, 3)),
    ]
    return JTable(cols, names=[f"c{i}" for i in range(len(cols))])


def test_jax_table_round_trip_with_nulls():
    jt = _jax_table()
    names, arrays, valids, dts = jax_table_to_numpy(jt)
    t = table_from_numpy(names, arrays, valids, dts, device="cpu")
    assert t.names == jt.names and t.num_rows == jt.num_rows
    for jc, tc in zip(jt.columns, t.columns):
        assert tc.dtype.kind.value == jc.dtype.kind.value
        assert (tc.dtype.precision, tc.dtype.scale) == \
            (jc.dtype.precision, jc.dtype.scale)
        data, valid = tc.to_numpy()
        assert data.dtype == np.asarray(jc.data).dtype
        # bit-exact, NaN payloads and -0.0 included
        npt.assert_array_equal(data.view(np.uint8),
                               np.asarray(jc.data).view(np.uint8))
        if jc.validity is None:
            assert valid is None
        else:
            npt.assert_array_equal(valid, np.asarray(jc.validity))
    # and back: the numpy buffers rebuild the same JAX table
    back = JTable([JColumn.from_numpy(d, dtype=jc.dtype, validity=v)
                   for (d, v), jc in zip((c.to_numpy() for c in t.columns),
                                         jt.columns)], names=t.names)
    assert back.to_pydict().keys() == jt.to_pydict().keys()
    for a, b in zip(back.columns, jt.columns):
        npt.assert_array_equal(np.asarray(a.data).view(np.uint8),
                               np.asarray(b.data).view(np.uint8))


def test_jax_decimal128_round_trip_with_nulls():
    """DECIMAL128 columns, (n, 4) uint32 limbs, cross bit for bit, validity
    and the values at +-(10^38 - 1) included; the numpy buffers rebuild
    the same JAX columns, and the Python ints agree."""
    rng = np.random.default_rng(7)
    big = 10**38 - 1
    vals = [big, -big, None, 0, 1, -1, 2**127 - 1, -(2**127)] + [
        None if rng.random() < 0.2 else
        int(rng.integers(-(10**18), 10**18)) * 10**20
        + int(rng.integers(0, 10**18)) for _ in range(57)]
    jt = JTable([JColumn.from_pylist(vals, jdt.decimal(38, 4)),
                 JColumn.from_pylist(vals[::-1], jdt.decimal(20, 0)),
                 JColumn.from_numpy(np.arange(len(vals), dtype=np.int64))],
                names=["d", "e", "i"])
    t = table_from_numpy(*jax_table_to_numpy(jt), device="cpu")
    assert t["d"].dtype == tdt.decimal(38, 4)
    assert t["e"].dtype == tdt.DType(tdt.Kind.DECIMAL128, 20, 0)
    for jc, tc in zip(jt.columns, t.columns):
        data, valid = tc.to_numpy()
        assert data.dtype == np.asarray(jc.data).dtype
        npt.assert_array_equal(data, np.asarray(jc.data))
        if jc.validity is None:
            assert valid is None
        else:
            npt.assert_array_equal(valid, np.asarray(jc.validity))
        back = JColumn.from_numpy(data, dtype=jc.dtype, validity=valid)
        npt.assert_array_equal(np.asarray(back.data), np.asarray(jc.data))
    assert t.to_pydict() == jt.to_pydict()
    assert t["d"].to_pylist() == vals
    ours = Column.from_pylist(vals, tdt.decimal(38, 4), device="cpu")
    assert torch.equal(ours.data, t["d"].data)
    assert torch.equal(ours.validity, t["d"].validity)


def test_concatenated_jax_table_round_trip_with_mixed_validity():
    """A JAX `concat_tables` of two tables, one with validity on a column
    and one without, crosses to the port bit for bit, and equals the
    port's own `concat_tables` of the two tables crossed one by one."""
    from spark_rapids_tpu import ops as jops
    from spark_rapids_tpu_torch.ops import copying
    a = _jax_table(n=40, seed=1)
    b = JTable([JColumn.from_numpy(np.asarray(c.data)[:13], dtype=c.dtype)
                for c in _jax_table(n=13, seed=2).columns],
               names=[f"d{i}" for i in range(a.num_columns)])
    jt = jops.concat_tables([a, b])
    crossed = table_from_numpy(*jax_table_to_numpy(jt), device="cpu")
    ours = copying.concat_tables([
        table_from_numpy(*jax_table_to_numpy(t), device="cpu")
        for t in (a, b)])
    assert crossed.names == ours.names == a.names
    for jc, x, y in zip(jt.columns, crossed.columns, ours.columns):
        assert x.dtype == y.dtype
        dx, vx = x.to_numpy()
        dy, vy = y.to_numpy()
        npt.assert_array_equal(dx.view(np.uint8), dy.view(np.uint8))
        npt.assert_array_equal(dx.view(np.uint8),
                               np.asarray(jc.data).view(np.uint8))
        if jc.validity is None:
            assert vx is None and vy is None
        else:
            npt.assert_array_equal(vx, vy)
            assert vy[40:].all()         # the side without validity


def test_jax_nested_round_trip_with_nulls():
    """STRING, LIST and STRUCT columns, nested two deep with nulls at every
    level, beside flat ones: the JAX table's numpy buffers
    (`interop.table_from_buffers`) rebuild the same table in the port,
    every buffer bit for bit, and the port's buffers rebuild the JAX one."""
    from spark_rapids_tpu_torch import table_from_buffers
    from test_torch_strings import (assert_same, buffers, jax_dtype,
                                    nested_pair)
    jflat = _jax_table(n=31, seed=5).columns[:3]
    jnested, _ = nested_pair(seed=9, n=31)
    jcols = list(jflat) + jnested + [JColumn.from_pylist(
        ["", None, "héllo", "x" * 40] * 7 + ["end", None, "z"], jdt.STRING)]
    jt = JTable(jcols, names=[f"c{i}" for i in range(len(jcols))])
    t = table_from_buffers(jt.names, [buffers(c) for c in jt.columns],
                           device="cpu")
    assert t.names == jt.names and t.num_rows == 31
    for jc, tc in zip(jt.columns, t.columns):
        assert_same(tc, jc)

    def back(tc):
        def arr(x):
            return None if x is None else np.asarray(x.numpy())
        return JColumn(dtype=jax_dtype(tc.dtype), length=tc.length,
                       data=arr(tc.data), validity=arr(tc.validity),
                       offsets=arr(tc.offsets),
                       children=tuple(back(k) for k in tc.children))
    assert JTable([back(c) for c in t.columns],
                  names=t.names).to_pydict() == jt.to_pydict()
    assert t.to_pydict() == jt.to_pydict()


def test_kind_names_and_pylist():
    t = table_from_numpy(["a", "d"], [np.array([1, 2, 3], np.int64),
                                      np.array([10, 11, 12], np.int32)],
                         [np.array([True, False, True]), None],
                         ["int64", "date32"], device="cpu")
    assert t["d"].dtype == tdt.DATE32
    assert t.to_pydict() == {"a": [1, None, 3], "d": [10, 11, 12]}
    jt = JTable([JColumn.from_pylist([1, None, 3], jdt.INT64),
                 JColumn.from_pylist([10, 11, 12], jdt.DATE32)],
                names=["a", "d"])
    assert jt.to_pydict() == t.to_pydict()


def test_column_checks_and_device_moves():
    with pytest.raises(TypeError):
        Column(tdt.INT64, 2, torch.zeros(2, dtype=torch.int32))
    assert tdt.STRING.storage_dtype() == torch.uint8
    with pytest.raises(TypeError, match="no data buffer"):
        tdt.list_(tdt.INT32).storage_dtype()
    with pytest.raises(ValueError, match="offsets"):
        Column(tdt.STRING, 2, torch.zeros(3, dtype=torch.uint8))
    c = Column.from_numpy(np.arange(4, dtype=np.int64), tdt.INT64,
                          np.array([1, 0, 1, 1], bool), device="cpu")
    t = Table([c], ["x"]).to("cpu")
    assert t.device.type == "cpu" and t["x"].null_count() == 1
    with pytest.raises(ValueError, match="equal length"):
        Table([c, Column.from_numpy(np.arange(3, dtype=np.int64),
                                    tdt.INT64, device="cpu")])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table_from_numpy(["a"], [np.zeros(2, np.int64)], [None], ["int64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Column.from_numpy(np.zeros(2, np.int64), tdt.INT64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nds_q3.q3_inputs(16)
