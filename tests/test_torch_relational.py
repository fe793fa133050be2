"""The port's relational ops against the JAX package on the CPU, on the same
numpy inputs: sort_table, groupby_aggregate and the inner/semi/anti join
fallbacks. Exact equality, row order and validity included."""
import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu import ops as jops

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import ops as tops
from spark_rapids_tpu_torch import table_from_numpy


def _port(jt: JTable):
    return table_from_numpy(
        list(jt.names), [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity)
         for c in jt.columns],
        [tdt.DType(tdt.Kind(c.dtype.kind.value), c.dtype.precision,
                   c.dtype.scale) for c in jt.columns], device="cpu")


def assert_tables_equal(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert jc.dtype.kind.value == tc.dtype.kind.value
        data, valid = tc.to_numpy()
        jvalid = (np.ones(jc.length, bool) if jc.validity is None
                  else np.asarray(jc.validity))
        tvalid = np.ones(tc.length, bool) if valid is None else valid
        npt.assert_array_equal(jvalid, tvalid)
        # values under nulls are unspecified; compare valid rows bitwise
        npt.assert_array_equal(np.asarray(jc.data)[jvalid].view(np.uint8),
                               data[tvalid].view(np.uint8))


def _table(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([-1.5, -0.0, 0.0, 2.5, np.nan, np.inf]), n)
    return JTable([
        JColumn.from_numpy(rng.integers(0, 6, n).astype(np.int64),
                           validity=rng.random(n) > 0.15),
        JColumn.from_numpy(rng.integers(-3, 3, n).astype(np.int32)),
        JColumn.from_numpy(rng.random(n) > 0.5),
        JColumn.from_numpy(f.astype(np.float64),
                           validity=rng.random(n) > 0.1),
        JColumn.from_numpy(rng.integers(-50, 50, n).astype(np.int16),
                           validity=rng.random(n) > 0.2),
        JColumn.from_numpy(rng.integers(0, 1000, n).astype(np.int64)),
    ], names=["k", "j", "b", "f", "v", "w"])


@pytest.mark.parametrize("keys,asc", [
    (["k"], [True]),
    (["k", "j"], [False, True]),
    (["f", "b"], [True, False]),
    (["b", "v", "w"], [False, False, True]),
])
def test_sort_table(keys, asc):
    jt = _table(400, 1)
    ref = jops.sort_table(jt, key_names=keys, ascending=asc)
    got = tops.sort_table(_port(jt), key_names=keys, ascending=asc)
    assert_tables_equal(ref, got)


@pytest.mark.parametrize("keys", [["k"], ["j", "b"], ["f"], ["k", "f"]])
def test_groupby_aggregate(keys):
    jt = _table(500, 2)
    aggs = [("v", "sum"), ("v", "count"), ("w", "min"), ("v", "max"),
            ("w", "mean"), ("w", "size"), ("f", "max"), ("f", "min")]
    ref = jops.groupby_aggregate(jt, keys, aggs)
    got = tops.groupby_aggregate(_port(jt), keys, aggs)
    assert_tables_equal(ref, got)


def _join_sides(seed, dt=np.int64):
    rng = np.random.default_rng(seed)
    lt = JTable([JColumn.from_numpy(rng.integers(0, 40, 300).astype(dt),
                                    validity=rng.random(300) > 0.1),
                 JColumn.from_numpy(rng.integers(0, 3, 300).astype(np.int32))],
                names=["a", "b"])
    rt = JTable([JColumn.from_numpy(rng.integers(0, 40, 2000).astype(dt),
                                    validity=rng.random(2000) > 0.1),
                 JColumn.from_numpy(rng.integers(0, 3, 2000).astype(np.int32))],
                names=["a", "b"])
    return lt, rt


@pytest.mark.parametrize("nkeys", [1, 2])
@pytest.mark.parametrize("how", ["inner", "left_semi", "left_anti"])
def test_join_fallbacks(how, nkeys):
    lt, rt = _join_sides(3)
    names = ["a", "b"][:nkeys]
    jl, jr = [lt[n] for n in names], [rt[n] for n in names]
    pl, pr = _port(lt), _port(rt)
    tl, tr = [pl[n] for n in names], [pr[n] for n in names]
    if how == "inner":
        ref = jops.inner_join(jl, jr)
        got = tops.inner_join(tl, tr)
        for a, b in zip(ref, got):
            npt.assert_array_equal(np.asarray(a.data), b.data.numpy())
    else:
        fn = "left_semi_join" if how == "left_semi" else "left_anti_join"
        ref = getattr(jops, fn)(jl, jr)
        got = getattr(tops, fn)(tl, tr)
        npt.assert_array_equal(np.asarray(ref.data), got.data.numpy())


def test_filter_and_gather():
    jt = _table(300, 4)
    pt = _port(jt)
    mask = np.asarray(jt["j"].data) > 0
    ref = jops.apply_boolean_mask(jt, jt["j"].data > 0)
    got = tops.apply_boolean_mask(pt, torch.from_numpy(mask))
    assert_tables_equal(ref, got)
    idx = np.array([5, -1, 0, 299, -1, 7], np.int32)
    ref = jops.take_table(jt, jnp.asarray(idx))
    got = tops.take_table(pt, torch.from_numpy(idx))
    assert_tables_equal(ref, got)
