"""The port's capped tier, `PlanExecutor(mode="capped")`, against the JAX
package's capped executor, plan by plan on the same tables: q3 (authored),
TPC-DS q3 and q72 at a few thousand rows, unoptimized and optimized, with
`compact()` bit for bit, the CUDA kernels forced (their plain mirrors on
CPU tensors), cap escalation from tiny caps (attempts, final caps and the
per-operator escalations equal to the reference's), the program cache and
caps memo, and the node kinds the tier does not run yet. The reference
runs with its stats store off, so both start from the same static caps.
Tolerance: exact; every column is an integer."""
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import stats

from benchmarks import nds_plans

from spark_rapids_tpu_torch import nds_q3, nds_q72, table_from_numpy
from spark_rapids_tpu_torch.ops import join_cuda, topk
from spark_rapids_tpu_torch.parallel.autoretry import CapacityOverflowError
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col

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
    assert join_cuda.PLAIN_CALLS == {"build": n_joins, "count": n_joins,
                                     "emit": n_joins}
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0, "emit": 0}
    assert join_cuda.CAPPED_CALLS == {"join": 0}
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
