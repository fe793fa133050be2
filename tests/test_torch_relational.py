"""The port's relational ops against the JAX package on the CPU, on the same
numpy inputs: sort_table, groupby_aggregate, the keyless aggregate of the
plan executor (float sums in the reference's order, signed zeros and NaN
bits of min and max) and the inner/semi/anti join fallbacks. Exact
equality, row order and validity included."""
import torch_threads  # noqa: F401  (one torch thread a worker)
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
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield


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


@pytest.mark.parametrize("groups", [3, 1000])
def test_groupby_float_sums_match_jax(groups):
    """Keyed float sums and means fold each group in row order, as the
    reference's segment_sum does (the card runs the segment-sum kernel for
    this; tests/test_torch_cuda.py holds it to this plain version)."""
    rng = np.random.default_rng(groups)
    n = 100_003
    jt = JTable([JColumn.from_numpy(rng.integers(0, groups, n)
                                    .astype(np.int64)),
                 JColumn.from_numpy(_mixed_floats(rng, n, np.float64),
                                    validity=rng.random(n) > 0.1),
                 JColumn.from_numpy(_mixed_floats(rng, n, np.float32))],
                names=["g", "d", "f"])
    aggs = [("d", "sum"), ("d", "mean"), ("f", "sum"), ("f", "mean")]
    ref = jops.groupby_aggregate(jt, ["g"], aggs)
    got = tops.groupby_aggregate(_port(jt), ["g"], aggs)
    assert_tables_equal(ref, got)


def _keyless(values, validity, aggs):
    """A one-column keyless plan `scan("t").aggregate([], aggs)` through
    the JAX and the port's PlanExecutor (optimize=False, CPU)."""
    from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
    from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
    jt = JTable([JColumn.from_numpy(values, validity=validity)], names=["x"])
    ref = JPlanExecutor(mode="eager", optimize=False).execute(
        JPlanBuilder().scan("t", schema=["x"]).aggregate([], aggs).build(),
        {"t": jt}).table
    got = PlanExecutor(device="cpu", optimize=False).execute(
        PlanBuilder().scan("t", schema=["x"]).aggregate([], aggs).build(),
        {"t": _port(jt)}).table
    return ref, got


def _mixed_floats(rng, n, dt):
    """Values over many magnitudes and both signs: the sum's order shows in
    its last bits."""
    return (rng.standard_normal(n) *
            10.0 ** rng.integers(-8, 12, n)).astype(dt)


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [31, 32, 33, 65, 1000, 100_003])
def test_keyless_float_sum_matches_jax(n, dt, with_nulls):
    rng = np.random.default_rng(n)
    valid = rng.random(n) > 0.1 if with_nulls else None
    ref, got = _keyless(_mixed_floats(rng, n, dt), valid,
                        [("x", "sum", "s")])
    assert_tables_equal(ref, got)


@pytest.mark.parametrize("values,want_bits", [
    ([1e16, 1.0, 1.0, 1.0, 1.0, 1.0], 0x4341C37937E08000),
    ([-0.0] * 33, 0),
    ([-0.0], -2 ** 63),           # one value: XLA returns it as it is
    ([-0.0, -0.0], 0),
])
def test_keyless_sum_edge_cases_match_jax(values, want_bits):
    ref, got = _keyless(np.array(values, np.float64), None,
                        [("x", "sum", "s")])
    assert_tables_equal(ref, got)
    assert int(got["s"].data.view(torch.int64)[0]) == want_bits


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("values", [[-0.0, 0.0], [0.0, -0.0], [1.0, np.nan],
                                    [np.nan]])
def test_keyless_min_max_match_jax(values, dt):
    """-0.0 orders below 0.0, and a NaN gives the canonical quiet NaN."""
    ref, got = _keyless(np.array(values, dt), None,
                        [("x", "min", "lo"), ("x", "max", "hi")])
    assert_tables_equal(ref, got)
    bits = torch.int32 if dt is np.float32 else torch.int64
    lo, hi = (int(got[c].data.view(bits)[0]) for c in ("lo", "hi"))
    if np.isnan(values).any():
        nan = 0x7FC00000 if dt is np.float32 else 0x7FF8000000000000
        assert lo == hi == nan
    else:
        sign = torch.iinfo(bits).min
        assert (lo, hi) == (sign, 0)


def _model_sum(xs, block=32):
    """The reference's keyless float sum, element by element in Python:
    one value as it is; up to `block` values a left fold from +0.0; longer
    lists padded with zeros (half the padding, rounded down, in front),
    each block folded from +0.0, and the block sums summed the same way."""
    if len(xs) == 1:
        return xs[0]

    def fold(vals, dt):
        acc = dt(0.0)
        for v in vals:
            acc = dt(acc + v)
        return acc
    dt = type(xs[0])
    while len(xs) > block:
        pad = -len(xs) % block
        xs = [dt(0.0)] * (pad // 2) + xs + [dt(0.0)] * (pad - pad // 2)
        xs = [fold(xs[i:i + block], dt) for i in range(0, len(xs), block)]
    return fold(xs, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 5, 32, 33, 64, 97, 1025, 3000])
def test_blocked_sum_follows_the_model(n, dt):
    from spark_rapids_tpu_torch.ops.aggregate import blocked_sum
    x = _mixed_floats(np.random.default_rng(n + 1), n, dt)
    want = _model_sum([dt(v) for v in x])
    got = blocked_sum(torch.from_numpy(x)).numpy()
    assert got.dtype == dt and got.tobytes() == np.asarray(want).tobytes()


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
