"""NDS q23 through the port's plan engine against the JAX package's
`PlanExecutor` on the same tables (N = 15,000 store sales rows, the
reference's own test size): authored and optimized, eager and capped (at
the reference bench's key_cap of 8,192), each table bit for bit and each
operator's rows equal; the two shared subqueries run once (five
HashAggregates, each computed once, in both tiers); the optimizer's
fingerprints, rules fired, pruned columns and plan text, with the shared
nodes still shared; cap escalation from 512 keys; scalar aggregates over
FLOAT64 in plans of both tiers (their bits) and over an empty relation
(an error); the port's datagen and DAG against the reference bench's. The
reference's capped runs have their stats store off. Tolerance: exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import re

import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import lit as jlit
from spark_rapids_tpu.plan import scalar_max as jscalar_max
from spark_rapids_tpu.plan import scalar_min as jscalar_min
from spark_rapids_tpu.plan import scalar_sum as jscalar_sum
from spark_rapids_tpu.plan import stats

from benchmarks import bench_nds_q23, nds_plans

from spark_rapids_tpu_torch import nds_q23, table_from_numpy
from spark_rapids_tpu_torch.ops import aggregate, join_cuda
from spark_rapids_tpu_torch.plan import (PlanBuilder, PlanExecutor, col,
                                         lit, scalar_max, scalar_min,
                                         scalar_sum)
from spark_rapids_tpu_torch.plan import executor as texecutor
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

_N = 15_000
_CAPS = {"key_cap": 8192}            # bench_nds_q23.py's plan-tier caps
_TINY = {"key_cap": 512}


@pytest.fixture(scope="module")
def ref():
    """The JAX executor's runs, each computed once."""
    store, sides = bench_nds_q23.build_tables(_N, seed=0)
    inputs = nds_plans.q23_inputs(store, sides)
    out = {}
    with stats.scoped_store(None):
        for optimize in (False, True):
            out["eager", optimize] = JPlanExecutor(
                mode="eager", optimize=optimize).execute(
                nds_plans.q23_plan(), inputs)
            out["capped", optimize] = JPlanExecutor(
                mode="capped", optimize=optimize, caps=dict(_CAPS)).execute(
                nds_plans.q23_plan(), inputs)
        out["tiny"] = JPlanExecutor(
            mode="capped", optimize=True, caps=dict(_TINY),
            max_cap_attempts=14).execute(nds_plans.q23_plan(), inputs)
    return out


@pytest.fixture(scope="module")
def inputs():
    return nds_q23.q23_inputs(_N, seed=0, device="cpu")


def _assert_same(jt, tt):
    """Names, dtype kinds, validity and data bits, row order included."""
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


def _rows(res):
    return [(m.kind, m.rows_in, m.rows_out) for m in res.metrics.values()]


def _counting_aggregates(monkeypatch):
    """Count every aggregate the executor computes, keyed and keyless."""
    calls = []
    for mod, name in ((aggregate, "groupby_aggregate"),
                      (aggregate, "groupby_aggregate_capped"),
                      (texecutor.PlanExecutor, "_global_aggregate")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, staticmethod(spy)
                            if mod is texecutor.PlanExecutor else spy)
    return calls


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("tier", ["eager", "capped"])
def test_q23_matches_jax(monkeypatch, ref, inputs, tier, optimize):
    want = ref[tier, optimize]
    caps = dict(_CAPS) if tier == "capped" else None
    calls = _counting_aggregates(monkeypatch)
    join_cuda.reset_counters()
    res = PlanExecutor(mode=tier, device="cpu", optimize=optimize,
                       caps=caps).execute(nds_q23.q23_plan(), inputs)
    got = res.compact()
    _assert_same(want.compact(), got)
    assert got.names == ("total",) and got.num_rows == 1
    assert _rows(res) == _rows(want)
    if tier == "capped":
        assert (res.attempts, res.caps) == (want.attempts, want.caps)
    # the shared subqueries run once: two keyed and three keyless
    # aggregates, each computed once
    aggs = [m for m in res.metrics.values() if m.kind == "HashAggregate"]
    assert len(aggs) == 5
    keyed = ("groupby_aggregate" if tier == "eager"
             else "groupby_aggregate_capped")
    assert (calls.count(keyed), calls.count("_global_aggregate")) == (2, 3)
    stamps = {m.kernel for m in res.metrics.values() if m.kernel}
    assert stamps == {"torch:hash_join", "torch:groupby"}
    assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                     "emit": 0, "exists": 0, "capped": 0}


def _strip(text):
    return re.sub(r"#\d+", "", text)


def _parents(plan):
    """node id -> its number of parents in the DAG."""
    out = {}
    for n in plan.nodes:
        for c in n.children:
            out[id(c)] = out.get(id(c), 0) + 1
    return out


def test_q23_optimizer_keeps_the_subqueries_shared(ref, inputs):
    res = PlanExecutor(device="cpu").execute(nds_q23.q23_plan(), inputs)
    want = ref["eager", True]
    for key in ("rules_fired", "pruned_columns", "fingerprint",
                "source_fingerprint", "fell_back"):
        assert res.optimizer[key] == want.optimizer[key], key
    assert res.optimizer["rules_fired"] == {"column_pruning": 7}
    assert res.optimizer["pruned_columns"] == 8
    assert _strip(res.plan.explain()) == _strip(want.plan.explain())
    assert nds_q23.q23_plan().fingerprint == \
        nds_plans.q23_plan().fingerprint
    # both HAVING filters still feed both sides (through a pruning Project)
    for plan in (nds_q23.q23_plan(), res.plan):
        filters = [n for n in plan.nodes if n.kind == "Filter"]
        assert len(filters) == 2
        parents = _parents(plan)
        assert [parents[id(f)] for f in filters] == [2, 2]
    assert "[ref Filter" in res.plan.explain()
    theirs = [line for line in _strip(JPlanExecutor(mode="eager").explain(
        nds_plans.q23_plan(), optimized=True)).splitlines()
        if not line.startswith("kernels [")]
    ours = _strip(PlanExecutor(device="cpu").explain(
        nds_q23.q23_plan(), optimized=True)).splitlines()
    assert ours == theirs


def test_q23_escalation_matches_jax(ref, inputs):
    """From 512 keys, optimized: the reference's attempts, caps and
    per-operator escalations; the program cache hits on a second run."""
    want = ref["tiny"]
    ex = PlanExecutor(mode="capped", device="cpu", caps=dict(_TINY),
                      max_cap_attempts=14)
    res = ex.execute(nds_q23.q23_plan(), inputs)
    _assert_same(want.compact(), res.compact())
    assert res.attempts == want.attempts > 1
    assert res.caps == want.caps
    assert [m.escalations for m in res.metrics.values()] == \
        [m.escalations for m in want.metrics.values()]
    again = ex.execute(nds_q23.q23_plan(), inputs)
    assert (again.attempts, again.caps, again.jit_cache_hits) == \
        (1, res.caps, 1)


def _float_table(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 17, n)
    v[::9] = -0.0
    k = rng.integers(0, 100, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    return k, v, valid


def _scalar_plan(m, agg_max, agg_min, agg_sum):
    """A filter that leaves dead rows in the capped tier, a threshold on a
    scalar sum, and bare scalar aggregates projected."""
    b = m.PlanBuilder()
    t = b.scan("t", schema=["k", "v"]).filter(m.col("k") < 70)
    return (t.filter(m.col("v") > m.lit(1e-9) * agg_sum(m.col("v")))
             .project([("k", m.col("k")), ("hi", agg_max(m.col("v"))),
                       ("lo", agg_min(m.col("v"))),
                       ("s", agg_sum(m.col("v"))),
                       ("ks", agg_sum(m.col("k")))])
             .build())


class _M:
    def __init__(self, **kw):
        self.__dict__.update(kw)


_JM = _M(PlanBuilder=JPlanBuilder, col=jcol, lit=jlit)
_TM = _M(PlanBuilder=PlanBuilder, col=col, lit=lit)


@pytest.mark.parametrize("n", [40, 2000])
@pytest.mark.parametrize("tier", ["eager", "capped"])
def test_float_scalar_aggregates_in_plans_match_jax(tier, n):
    """FLOAT64 scalar aggregates (nulls in the column, read as data)
    give the reference's bits in either tier: the capped tier reduces the
    live rows of a padded frame."""
    k, v, valid = _float_table(n, seed=n)
    jt = JTable([JColumn.from_numpy(k), JColumn.from_numpy(v,
                                                           validity=valid)],
                names=["k", "v"])
    tt = table_from_numpy(["k", "v"], [k, v], [None, valid],
                          ["int64", "float64"], device="cpu")
    with stats.scoped_store(None):
        want = JPlanExecutor(mode=tier, optimize=False).execute(
            _scalar_plan(_JM, jscalar_max, jscalar_min, jscalar_sum),
            {"t": jt})
    got = PlanExecutor(mode=tier, device="cpu", optimize=False).execute(
        _scalar_plan(_TM, scalar_max, scalar_min, scalar_sum), {"t": tt})
    _assert_same(want.compact(), got.compact())
    assert got.compact().num_rows > 0


@pytest.mark.parametrize("tier", ["eager", "capped"])
def test_scalar_max_over_an_empty_relation_raises(tier):
    """As in the reference: max over no rows has no identity."""
    empty = np.zeros(0, dtype=np.int64)
    jt = JTable([JColumn.from_numpy(empty)], names=["rev"])
    tt = table_from_numpy(["rev"], [empty], [None], ["int64"], device="cpu")

    def plan(m, agg):
        return (m.PlanBuilder().scan("t", schema=["rev"])
                .filter(m.col("rev") > m.lit(0.95) * agg(m.col("rev")))
                .build())
    with pytest.raises(ValueError):
        with stats.scoped_store(None):
            JPlanExecutor(mode=tier).execute(plan(_JM, jscalar_max),
                                             {"t": jt})
    with pytest.raises(ValueError, match="zero-size"):
        PlanExecutor(mode=tier, device="cpu").execute(
            plan(_TM, scalar_max), {"t": tt})


def test_datagen_matches_reference():
    for seed in (0, 4):
        store, sides = nds_q23.datagen(3000, seed=seed)
        rstore, rsides = bench_nds_q23._datagen(3000, seed=seed)
        for a, b in ((store, rstore), *((sides[s], rsides[s])
                                         for s in nds_q23.SIDES)):
            assert list(a) == list(b)
            for k in a:
                npt.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
    assert (nds_q23.FREQ_THRESHOLD, nds_q23.BEST_FRACTION) == \
        (bench_nds_q23.FREQ_THRESHOLD, bench_nds_q23.BEST_FRACTION)


def test_inputs_bind_as_the_reference_binds(inputs):
    store, sides = bench_nds_q23.build_tables(_N, seed=0)
    theirs = nds_plans.q23_inputs(store, sides)
    assert list(inputs) == list(theirs)
    for name, t in inputs.items():
        assert list(t.names) == list(theirs[name].names)
        for a, b in zip(t.columns, theirs[name].columns):
            assert a.dtype.kind.value == b.dtype.kind.value == "int64"
            npt.assert_array_equal(a.data.numpy(), np.asarray(b.data))


def _shape(plan):
    return [(n.kind, n.describe(), plan.schemas.get(id(n)),
             [plan.nodes.index(c) for c in n.children]) for n in plan.nodes]


def test_q23_plan_has_the_reference_dag():
    assert _shape(nds_q23.q23_plan()) == _shape(nds_plans.q23_plan())
