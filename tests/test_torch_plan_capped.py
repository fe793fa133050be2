"""The port's capped tier, `PlanExecutor(mode="capped")`, against the JAX
package's capped executor, plan by plan on the same tables: q3 (authored),
TPC-DS q3 and q72 at a few thousand rows, unoptimized and optimized, with
`compact()` bit for bit, the CUDA kernels forced (their plain mirrors on
CPU tensors), cap escalation from tiny caps (attempts, final caps and the
per-operator escalations equal to the reference's), the program cache and
caps memo, and the node kinds the tier does not run yet. The reference
runs with its stats store off, so both start from the same static caps.
Tolerance: exact; every column is an integer."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import lit as jlit
from spark_rapids_tpu.plan import stats

from benchmarks import nds_plans

from spark_rapids_tpu_torch import nds_q3, nds_q72, table_from_numpy
from spark_rapids_tpu_torch.ops import join_cuda, topk
from spark_rapids_tpu_torch.parallel.autoretry import CapacityOverflowError
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col, lit
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

_N = 4000
_TINY = {"row_cap": 128, "key_cap": 16}


def _jax_tpcds_plan():
    b = JPlanBuilder()
    sales = b.scan("sales", schema=["sold_date_sk", "item_sk", "price_cents"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_year", "d_moy"])
             .filter(jcol("d_moy") == 11))
    items = (b.scan("items", schema=["i_item_sk", "i_brand", "i_manufact"])
             .filter(jcol("i_manufact") == 42))
    j = (sales.join(dates, left_on="sold_date_sk", right_on="d_date_sk")
              .join(items, left_on="item_sk", right_on="i_item_sk"))
    return (j.aggregate(["d_year", "i_brand"],
                        [("price_cents", "sum", "revenue")])
             .sort(["d_year", "revenue", "i_brand"],
                   ascending=[True, False, True])
             .limit(100).build())


_PLANS = {
    "q3": (nds_q3.q3_plan, nds_plans.q3_plan, nds_q3.q3_inputs),
    "tpcds_q3": (nds_q3.q3_tpcds_plan, _jax_tpcds_plan,
                 nds_q3.q3_tpcds_inputs),
    "q72": (nds_q72.q72_plan, nds_plans.q72_plan, nds_q72.q72_inputs),
}


def _jax_inputs(inputs):
    return {name: JTable([JColumn.from_numpy(c.data.numpy())
                          for c in t.columns], names=list(t.names))
            for name, t in inputs.items()}


_REF = {}


def _jax_capped(which, optimize, caps=None):
    """The reference's capped run (computed once per case)."""
    key = (which, optimize, tuple(sorted((caps or {}).items())))
    if key not in _REF:
        _, jplan, make = _PLANS[which]
        with stats.scoped_store(None):
            _REF[key] = JPlanExecutor(
                mode="capped", optimize=optimize, caps=caps,
                max_cap_attempts=14).execute(
                jplan(), _jax_inputs(make(_N, seed=0, device="cpu")))
    return _REF[key]


def _assert_same(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for a, b in zip(jt.columns, tt.columns):
        assert a.dtype.kind.value == b.dtype.kind.value
        np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("which", ["q3", "tpcds_q3", "q72"])
def test_capped_plans_match_jax(which, optimize):
    plan, _, make = _PLANS[which]
    ref = _jax_capped(which, optimize)
    res = PlanExecutor(mode="capped", device="cpu", optimize=optimize
                       ).execute(plan(), make(_N, seed=0, device="cpu"))
    got = res.compact()
    assert got.num_rows > 0
    _assert_same(ref.compact(), got)
    assert (res.mode, res.attempts, res.caps) == ("capped", ref.attempts,
                                                  ref.caps)
    # the eager tier gives the same rows
    eager = PlanExecutor(device="cpu", optimize=optimize).execute(
        plan(), make(_N, seed=0, device="cpu"))
    _assert_same(eager.table, got)
    joins = [m for m in res.metrics.values() if m.kind == "HashJoin"]
    assert joins and all(m.kernel == "torch:hash_join" for m in joins)
    assert all(m.rows_out <= m.rows_in for m in joins)
    assert res.metrics[res.plan.root.label].rows_out == got.num_rows


@pytest.mark.parametrize("which", ["tpcds_q3", "q72"])
def test_forced_kernels_run_their_plain_mirrors(monkeypatch, which):
    """With the CUDA kernels forced, the capped joins and TopK take the
    kernels' wrappers, which on CPU tensors run their plain mirrors; the
    FusedSelect's decline is stamped and nothing raises."""
    plan, _, make = _PLANS[which]
    ref = _jax_capped(which, True)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS",
                       "hash_join=cuda,topk=cuda,fused_select=cuda")
    join_cuda.reset_counters()
    topk.PLAIN_CALLS["topk"] = 0
    res = PlanExecutor(mode="capped", device="cpu").execute(
        plan(), make(_N, seed=0, device="cpu"))
    _assert_same(ref.compact(), res.compact())
    stamps = {m.kind: m.kernel for m in res.metrics.values() if m.kernel}
    assert stamps["HashJoin"] == "cuda:hash_join"
    assert stamps["FusedSelect"] == "torch:fused_select"
    assert stamps["HashAggregate"] == "torch:groupby"
    n_joins = sum(n.kind == "HashJoin" for n in res.plan.nodes)
    # each capped join: the build and the capped probe's mirror
    assert join_cuda.PLAIN_CALLS == {"build": n_joins, "count": 0,
                                     "emit": 0, "exists": 0,
                                     "capped": n_joins}
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0,
                                  "emit": 0, "exists": 0, "capped": 0}
    if which == "tpcds_q3":
        assert stamps["TopK"] == "cuda:topk"
        assert topk.PLAIN_CALLS["topk"] == 1


@pytest.mark.parametrize("which,optimize", [("q3", False),
                                            ("tpcds_q3", True)])
def test_escalation_matches_jax(which, optimize):
    """From caps of 128 rows and 16 keys: the same attempts, final caps
    and per-operator escalations as the reference; the program cache hits
    on a second run, which starts from the grown caps (the caps memo)."""
    plan, _, make = _PLANS[which]
    ref = _jax_capped(which, optimize, caps=_TINY)
    ex = PlanExecutor(mode="capped", device="cpu", optimize=optimize,
                      caps=_TINY, max_cap_attempts=14)
    inputs = make(_N, seed=0, device="cpu")
    res = ex.execute(plan(), inputs)
    _assert_same(ref.compact(), res.compact())
    assert res.attempts == ref.attempts > 1
    assert res.caps == ref.caps
    assert [m.escalations for m in res.metrics.values()] == \
        [m.escalations for m in ref.metrics.values()]
    assert res.jit_cache_hits == 0
    again = ex.execute(plan(), inputs)        # an equal plan, built apart
    assert (again.attempts, again.caps, again.jit_cache_hits) == \
        (1, res.caps, 1)
    _assert_same(ref.compact(), again.compact())
    assert all(m.escalations == 0 for m in again.metrics.values())
    assert "program cache hit" in again.profile_text()


def test_overflow_past_the_attempts_raises():
    with pytest.raises(CapacityOverflowError, match="2 attempts"):
        PlanExecutor(mode="capped", device="cpu", optimize=False,
                     caps=_TINY, max_cap_attempts=2).execute(
            nds_q3.q3_plan(), nds_q3.q3_inputs(_N, seed=0, device="cpu"))


def test_union_raises_and_modes_are_checked():
    """The capped Union (it raised before the tier had one) runs: the
    padded frames and their alive masks end to end, in input order, equal
    to the reference's capped Union over a filtered input; an unknown mode
    still raises."""
    b = PlanBuilder()
    a = np.arange(5, dtype=np.int64)
    w = np.arange(10, 16, dtype=np.int64)
    valid = np.array([True, False, True, True, False, True])
    t = table_from_numpy(["a"], [a], [None], ["int64"], device="cpu")
    u = table_from_numpy(["a"], [w], [valid], ["int64"], device="cpu")
    union = (b.scan("t", schema=["a"]).filter(col("a") > 1)
             .union(b.scan("u", schema=["a"]))
             .aggregate(["a"], [("a", "count", "n")])).build()
    res = PlanExecutor(mode="capped", device="cpu", optimize=False,
                       caps={"key_cap": 16}).execute(union, {"t": t, "u": u})
    jb = JPlanBuilder()
    jplan = (jb.scan("t", schema=["a"]).filter(jcol("a") > 1)
             .union(jb.scan("u", schema=["a"]))
             .aggregate(["a"], [("a", "count", "n")])).build()
    jin = {"t": JTable([JColumn.from_numpy(a)], names=["a"]),
           "u": JTable([JColumn.from_numpy(w, validity=valid)],
                       names=["a"])}
    with stats.scoped_store(None):
        want = JPlanExecutor(mode="capped", optimize=False,
                             caps={"key_cap": 16}).execute(jplan, jin)
    _assert_same(want.compact(), res.compact())
    assert res.compact().to_pydict() == {
        "a": [None, 2, 3, 4, 10, 12, 13, 15], "n": [0, 1, 1, 1, 1, 1, 1, 1]}
    unions = [m for m in res.metrics.values() if m.kind == "Union"]
    assert [(m.rows_in, m.rows_out) for m in unions] == [(9, 9)]
    with pytest.raises(ValueError, match="unknown executor mode"):
        PlanExecutor(mode="streaming", device="cpu")


_LITERAL_REWRITES = {
    "add_sub_1e16": (lambda c, l: (c("f") + l(1e16)) - l(1e16), 3.0),
    "plus_zero": (lambda c, l: c("f") + l(0.0), -0.0),
    "times_3_times_third": (lambda c, l: (c("f") * l(3.0)) * l(1 / 3),
                            1e-17),
}


@pytest.mark.parametrize("case", sorted(_LITERAL_REWRITES))
def test_capped_float_literals_follow_the_reference_eager_tier(case):
    """A reference deviation, pinned (queue C): under `jax.jit` XLA
    rewrites float arithmetic on literals, so the reference's capped tier
    disagrees with its own eager tier (and with IEEE and Spark). The
    port computes IEEE in both tiers: its capped bits equal its eager bits
    and the reference's eager bits, and the reference's capped bits
    differ. A JAX that stops rewriting fails the last assertion."""
    expr, value = _LITERAL_REWRITES[case]
    f = np.array([value], dtype=np.float64)
    tt = {"t": table_from_numpy(["f"], [f], [None], ["float64"],
                                device="cpu")}
    jt = {"t": JTable([JColumn.from_numpy(f)], names=["f"])}
    tplan = PlanBuilder().scan("t", schema=["f"]).project(
        [("y", expr(col, lit))]).build()
    jplan = JPlanBuilder().scan("t", schema=["f"]).project(
        [("y", expr(jcol, jlit))]).build()
    got = {mode: PlanExecutor(mode=mode, device="cpu", optimize=False)
           .execute(tplan, tt).compact()["y"].data.numpy()
           .view(np.int64).tolist() for mode in ("eager", "capped")}
    with stats.scoped_store(None):
        want = {mode: np.asarray(JPlanExecutor(mode=mode, optimize=False)
                                 .execute(jplan, jt).compact()["y"].data)
                .view(np.int64).tolist() for mode in ("eager", "capped")}
    assert got["capped"] == got["eager"] == want["eager"]
    assert want["capped"] != want["eager"]


def _c8_tables(nl):
    """Queue C 8's tables: `l` (k, v) with its first nl rows, `r` (rk, w);
    (port tables, JAX tables)."""
    k = np.array([0, 1, 2, 0, 1], np.int64)[:nl]
    v = np.arange(nl, dtype=np.int64)
    rk, w = np.array([0, 1, 2, 0], np.int64), np.arange(4, dtype=np.int64)
    tt = {"l": table_from_numpy(["k", "v"], [k, v], [None, None],
                                ["int64", "int64"], device="cpu"),
          "r": table_from_numpy(["rk", "w"], [rk, w], [None, None],
                                ["int64", "int64"], device="cpu")}
    jt = {"l": JTable([JColumn.from_numpy(k), JColumn.from_numpy(v)],
                      names=["k", "v"]),
          "r": JTable([JColumn.from_numpy(rk), JColumn.from_numpy(w)],
                      names=["rk", "w"])}
    return tt, jt


def _c8_plan(plan_cls, side, topk=True):
    b = plan_cls()
    left = b.scan("l", schema=["k", "v"])
    if topk:
        left = left.sort(["v"]).limit(0)
    right = b.scan("r", schema=["rk", "w"])
    if side == "right":
        return right.join(left, left_on="rk", right_on="k").build()
    return left.join(right, left_on="k", right_on="rk").build()


@pytest.mark.parametrize("side", ["left", "right"])
def test_capped_join_over_a_topk_of_zero_rows(monkeypatch, side):
    """Queue C 8, repaired: the optimized plan turns Sort + Limit(0) into
    TopK(0), whose capped kernel route (forced; its CPU mirror here)
    returns a frame of zero rows; the capped inner join over it emits
    `row_cap` dead slots (zero data, validity where the column has one)
    instead of gathering row 0 of nothing. 0 rows, equal to the JAX
    package, the TopK on either side."""
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "topk=cuda")
    tt, jt = _c8_tables(5)
    res = PlanExecutor(mode="capped", device="cpu").execute(
        _c8_plan(PlanBuilder, side), tt)
    assert "TopK" in [n.kind for n in res.plan.nodes]
    with stats.scoped_store(None):
        ref = JPlanExecutor(mode="capped").execute(
            _c8_plan(JPlanBuilder, side), jt)
    got = res.compact()
    assert got.num_rows == ref.compact().num_rows == 0
    _assert_same(ref.compact(), got)
    assert not bool(res.valid.any())


def test_capped_join_over_an_empty_table_gives_no_rows():
    """An empty input table under a capped inner join gives 0 rows, as the
    eager tier and Spark do. The reference's capped tier raises IndexError
    here (its gather takes row 0 of an empty axis): the port gives the
    natural answer (ROADMAP, deviation 7)."""
    for side in ("left", "right"):
        tt, jt = _c8_tables(0)
        plan = _c8_plan(PlanBuilder, side, topk=False)
        got = PlanExecutor(mode="capped", device="cpu").execute(plan, tt)
        assert got.compact().num_rows == 0
        assert got.compact().names == PlanExecutor(device="cpu").execute(
            plan, tt).table.names
        with stats.scoped_store(None), pytest.raises(IndexError):
            JPlanExecutor(mode="capped").execute(
                _c8_plan(JPlanBuilder, side, topk=False), jt)
