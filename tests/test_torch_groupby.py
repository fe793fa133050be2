"""The groupby kernel's plain version (`groupby_cuda.groupby_reduce_plain`,
the kernel's tiling with a small tile so that tiny inputs cross its
edges) against the port's plain groupby (the registry's "torch" fallback)
and the JAX package's `groupby_aggregate` / `groupby_aggregate_capped` on
the CPU, on inputs made with numpy from a seed; the registry's `groupby`
op and the executor's stamps. Tolerance: none. Against the plain version
every output bit (floats as their bits, data under nulls and in empty
capped slots included); against JAX the valid rows and the validity,
since neither package defines data under a null or past a capped group
count."""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.ops.aggregate import groupby_aggregate as j_groupby
from spark_rapids_tpu.ops.aggregate import \
    groupby_aggregate_capped as j_groupby_capped

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.ops import aggregate, groupby_cuda
from spark_rapids_tpu_torch.ops.registry import REGISTRY, Signature

# (name, numpy type, JAX dtype): the kinds the kernel reads values of
_KINDS = [("i8", np.int8, jdt.INT8), ("i16", np.int16, jdt.INT16),
          ("i32", np.int32, jdt.INT32), ("i64", np.int64, jdt.INT64),
          ("f32", np.float32, jdt.FLOAT32), ("f64", np.float64, jdt.FLOAT64),
          ("d32", np.int32, jdt.DATE32), ("ts", np.int64, jdt.TIMESTAMP_US)]
_TILE = 8            # the plain version's tile: tiny inputs cross its edges


def _values(rng, name, npt, n):
    if name.startswith("f"):
        pick = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5, -2.25,
                         1e-300, -1e300])
        v = np.where(rng.random(n) < 0.3, rng.choice(pick, n),
                     rng.standard_normal(n) * 10.0 ** rng.integers(-8, 12, n))
        with np.errstate(over="ignore"):
            return v.astype(npt)
    info = np.iinfo(npt)
    return rng.integers(info.min, info.max, n, dtype=np.int64,
                        endpoint=True).astype(npt)


def _keys(rng, dist, n):
    if dist == "one group":
        return np.zeros(n, np.int64)
    if dist == "distinct":
        return rng.permutation(n).astype(np.int64)
    if dist == "edges":      # runs of a tile and around it
        lens = rng.choice([1, _TILE - 1, _TILE, _TILE + 1, 2 * _TILE + 1], 50)
        return rng.permutation(np.resize(np.repeat(np.arange(50), lens),
                                         n)).astype(np.int64)
    return rng.integers(0, 6, n).astype(np.int64)


def _tables(rng, keys, null_p):
    """(JAX table, port table, aggs): key "k" and a value column per kind
    (nulls at null_p; "i64" also null in every group whose key is a
    multiple of 3, so all-null groups occur), every op over each."""
    n = keys.shape[0]
    jcols = [JColumn.from_numpy(keys, jdt.INT64)]
    tcols = [Column.from_numpy(keys, tdt.INT64, device="cpu")]
    names, aggs = ["k"], [("k", "size")]
    for name, npt, jdtype in _KINDS:
        v = rng.random(n) >= null_p if null_p else None
        if name == "i64":
            v = (rng.random(n) >= null_p) & (keys % 3 != 0)
        a = _values(rng, name, npt, n)
        jcols.append(JColumn.from_numpy(a, jdtype, v))
        tcols.append(Column.from_numpy(
            a, tdt.DType(tdt.Kind(jdtype.kind.value)), v, device="cpu"))
        names.append(name)
        aggs += [(name, op) for op in ("count", "min", "max", "mean")]
        if name not in ("d32", "ts"):
            aggs.append((name, "sum"))
    return JTable(jcols, names=names), Table(tcols, names), aggs


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64) \
        if t.is_floating_point() else t


def _same(got: Table, want: Table):
    """Every bit: names, dtypes, data (under nulls too) and validity."""
    assert got.names == want.names and got.num_rows == want.num_rows
    for name, a, b in zip(got.names, got.columns, want.columns):
        assert a.dtype == b.dtype, name
        assert torch.equal(_bits(a.data), _bits(b.data)), name
        assert (a.validity is None) == (b.validity is None), name
        if a.validity is not None:
            assert torch.equal(a.validity, b.validity), name


def _same_as_jax(jt, tt: Table, rows=None):
    """The valid rows and the validity of the first `rows` rows."""
    assert list(jt.names) == list(tt.names)
    for jc, tc in zip(jt.columns, tt.columns):
        assert jc.dtype.kind.value == tc.dtype.kind.value
        jd, td = np.asarray(jc.data), tc.data.numpy()
        jv = np.ones(jd.shape[0], bool) if jc.validity is None \
            else np.asarray(jc.validity)
        tv = tc.null_mask.numpy()
        if rows is not None:
            jd, td, jv, tv = jd[:rows], td[:rows], jv[:rows], tv[:rows]
        np.testing.assert_array_equal(jv, tv)
        np.testing.assert_array_equal(jd[jv].view(np.uint8),
                                      td[tv].view(np.uint8))


@pytest.fixture
def kernel(monkeypatch):
    """The registry's `cuda` groupby forced: on CPU tensors its wrapper
    runs the kernel's plain version, here with a tile of _TILE rows."""
    monkeypatch.setattr(groupby_cuda, "TILE", _TILE)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "groupby=cuda")
    groupby_cuda.reset_counters()


def _plain(fn, *args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARK_RAPIDS_TORCH_KERNELS", "groupby=torch")
        return fn(*args)


@pytest.mark.parametrize("dist", ["one group", "distinct", "edges",
                                  "6 groups"])
@pytest.mark.parametrize("n", [0, 1, _TILE - 1, _TILE, _TILE + 1, 301])
@pytest.mark.parametrize("null_p", [0.0, 0.4])
def test_kernel_tiling_equals_plain_eager(kernel, dist, n, null_p):
    rng = np.random.default_rng(n * 7 + len(dist))
    _, tt, aggs = _tables(rng, _keys(rng, dist, n), null_p)
    got = aggregate.groupby_aggregate(tt, ["k"], aggs)
    _same(got, _plain(aggregate.groupby_aggregate, tt, ["k"], aggs))
    assert groupby_cuda.PLAIN_CALLS == {"groupby": 1}


@pytest.mark.parametrize("dist", ["one group", "distinct", "edges",
                                  "6 groups"])
@pytest.mark.parametrize("n", [0, 1, _TILE + 1, 301])
@pytest.mark.parametrize("cap_at", ["below", "at", "above"])
@pytest.mark.parametrize("live", [1.0, 0.5, 0.0])
def test_kernel_tiling_equals_plain_capped(kernel, dist, n, cap_at, live):
    """Dead rows interleaved before the sort; key_cap below, at and above
    the live group count."""
    rng = np.random.default_rng(n * 11 + len(dist) + len(cap_at))
    keys = _keys(rng, dist, n)
    _, tt, aggs = _tables(rng, keys, 0.3)
    alive = torch.from_numpy(rng.random(n) < live)
    groups = len(np.unique(keys[alive.numpy()]))
    cap = {"below": max(groups // 2, 1), "at": max(groups, 1),
           "above": groups + 5}[cap_at]
    got = aggregate.groupby_aggregate_capped(tt, ["k"], aggs, cap, alive)
    want = _plain(aggregate.groupby_aggregate_capped, tt, ["k"], aggs, cap,
                  alive)
    _same(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool(got[2]) == (groups > cap)


@pytest.mark.parametrize("dist,n", [("6 groups", 301), ("edges", 97),
                                    ("one group", 40)])
def test_kernel_tiling_equals_jax(kernel, dist, n):
    rng = np.random.default_rng(n)
    keys = _keys(rng, dist, n)
    jt, tt, aggs = _tables(rng, keys, 0.3)
    _same_as_jax(j_groupby(jt, ["k"], aggs),
                 aggregate.groupby_aggregate(tt, ["k"], aggs))
    alive = rng.random(n) < 0.6
    groups = len(np.unique(keys[alive]))
    for cap in (max(groups - 2, 1), groups + 3):
        jres = j_groupby_capped(jt, ["k"], aggs, cap, alive)
        tres = aggregate.groupby_aggregate_capped(tt, ["k"], aggs, cap,
                                                  torch.from_numpy(alive))
        np.testing.assert_array_equal(np.asarray(jres[1]), tres[1].numpy())
        assert bool(jres[2]) == bool(tres[2])
        _same_as_jax(jres[0], tres[0], rows=min(groups, cap))


def test_fold_nan_bits_follow_the_cpu(kernel):
    """A fold that ends NaN: the kernel's rule (the last NaN value,
    quieted, else x86's default NaN) gives the CPU fold's bits, distinct
    NaN payloads and both signs included; a float32 NaN widens with its
    payload."""
    nan = lambda b: np.array([b], np.uint64).view(np.float64)[0]  # noqa
    nan32 = lambda b: np.array([b], np.uint32).view(np.float32)[0]  # noqa
    x = np.array([1.0, nan(0x7FF0000000000123), 2.0, nan(0xFFF8000000000456),
                  3.0,                                     # group 0
                  np.inf, 5.0, -np.inf, 1.0,               # group 1
                  nan(0xFFF0000000000789), np.inf, -np.inf,  # group 2
                  1e308, 1e308, -np.inf, 4.0])             # group 3
    k = np.repeat(np.arange(4), [5, 4, 3, 4]).astype(np.int64)
    f = np.array([nan32(0xFF800123), 1.0, nan32(0x7FC00042), 2.0] * 4,
                 np.float32)
    t = Table([Column.from_numpy(k, tdt.INT64, device="cpu"),
               Column.from_numpy(x, tdt.FLOAT64, device="cpu"),
               Column.from_numpy(f, tdt.FLOAT32, device="cpu")],
              ["k", "x", "f"])
    aggs = [("x", "sum"), ("x", "mean"), ("f", "sum"), ("f", "mean")]
    got = aggregate.groupby_aggregate(t, ["k"], aggs)
    _same(got, _plain(aggregate.groupby_aggregate, t, ["k"], aggs))
    bits = got["sum(x)"].data.view(torch.int64).tolist()
    assert bits[1] == bits[3] == -0x0008000000000000     # 0xFFF8...0
    assert torch.isnan(got["sum(x)"].data).all()


def test_jobs_share_a_count_per_column():
    rng = np.random.default_rng(2)
    _, tt, aggs = _tables(rng, _keys(rng, "6 groups", 50), 0.2)
    specs = aggregate._agg_specs(tt, aggs)
    jobs, uses = groupby_cuda._jobs(specs)
    counts = [j for j in jobs if j.op == groupby_cuda.OP_COUNT]
    assert len(counts) == len(_KINDS)
    assert sum(j.op == groupby_cuda.OP_FSUM for j in jobs) == \
        len(_KINDS) + 2                      # every mean, two float sums
    assert [len(u) for u in uses] == [1] + [1 if s.op == "count" else 2
                                            for s in specs[1:]]


def test_registry_selects_the_kernel_on_the_card_only():
    t = Table([Column.from_numpy(np.arange(4, dtype=np.int64), tdt.INT64,
                                 device="cpu")], ["k"])
    for tier in ("eager", "capped"):
        sig = groupby_cuda.make_signature(t, [("k", "sum"), ("k", "size")],
                                          tier)
        assert REGISTRY.select("groupby", sig, "cuda").label == \
            "cuda:groupby"
        assert REGISTRY.select("groupby", sig, "cpu").label == \
            "torch:groupby"
    big = groupby_cuda.make_signature(
        t, [("k", "count")] * (groupby_cuda.MAX_AGGS + 1), "eager")
    choice = REGISTRY.select("groupby", big, "cuda")
    assert choice.fallback and choice.declined == (
        ("cuda", "unsupported signature"),)
    assert not groupby_cuda.supports(Signature(extras=(("tier", "x"),)))


def test_wrapper_runs_the_kernel_only_on_cuda_tensors():
    order = torch.arange(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        groupby_cuda.groupby_reduce_cuda([], order, order, 3)
    groupby_cuda.reset_counters()
    first, cols, groups = groupby_cuda.groupby_reduce([], order,
                                                      torch.zeros(3,
                                                                  dtype=torch
                                                                  .int64), 1)
    assert first.tolist() == [0] and cols == [] and int(groups) == 1
    assert groupby_cuda.PLAIN_CALLS == {"groupby": 1}
    assert groupby_cuda.LAUNCHES == {"groupby": 0, "fold": 0}


@pytest.mark.parametrize("mode", ["eager", "capped"])
def test_executor_stamps_the_groupby(monkeypatch, mode):
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
    rng = np.random.default_rng(4)
    n = 200
    t = Table([Column.from_numpy(rng.integers(0, 9, n).astype(np.int64),
                                 tdt.INT64, device="cpu"),
               Column.from_numpy(rng.standard_normal(n), tdt.FLOAT64,
                                 rng.random(n) > 0.2, device="cpu")],
              ["g", "x"])
    plan = (PlanBuilder().scan("t", schema=["g", "x"])
            .aggregate(["g"], [("x", "sum", "s"), ("x", "max", "m")])
            .build())
    ex = PlanExecutor(mode=mode, device="cpu", optimize=False)
    want = ex.execute(plan, {"t": t})
    assert [m.kernel for m in want.metrics.values()
            if m.kind == "HashAggregate"] == ["torch:groupby"]
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "groupby=cuda")
    groupby_cuda.reset_counters()
    got = PlanExecutor(mode=mode, device="cpu", optimize=False).execute(
        plan, {"t": t})
    assert [m.kernel for m in got.metrics.values()
            if m.kind == "HashAggregate"] == ["cuda:groupby"]
    assert groupby_cuda.PLAIN_CALLS == {"groupby": 1}
    _same(got.compact(), want.compact())
