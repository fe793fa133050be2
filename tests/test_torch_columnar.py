"""Tables across packages: a JAX `Table` -> numpy -> port `Table` round trip
is bit-exact, validity included (spark_rapids_tpu_torch/interop.py)."""
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
    with pytest.raises(TypeError, match="not ported"):
        tdt.DType(tdt.Kind.STRING).storage_dtype()
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
