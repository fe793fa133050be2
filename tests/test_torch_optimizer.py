"""The port's rule-based optimizer against the JAX package's: for the NDS
plans q3, q5 and q72, TPC-DS q3, and the single-device cases of
tests/test_optimizer.py, the same authored and optimized fingerprints, the
same rules fired and columns pruned, and the same optimized plan text
(node ids stripped: each package numbers its nodes). Where the port runs
every node kind of a plan, its results with the optimizer on and off equal
the JAX package's, bit for bit."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import re
import types

import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu import plan as jplan
from spark_rapids_tpu.plan import stats as jstats

from benchmarks import nds_plans
from benchmarks.bench_nds_q5 import DATE_HI, DATE_LO

from spark_rapids_tpu_torch import nds_q3, table_from_numpy
from spark_rapids_tpu_torch import plan as tplan
from spark_rapids_tpu_torch.plan import optimizer as topt
from spark_rapids_tpu_torch.plan.nodes import Filter, HashJoin, Limit, Scan
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

J = types.SimpleNamespace(PlanBuilder=jplan.PlanBuilder, col=jplan.col,
                          lit=jplan.lit, scalar_max=jplan.scalar_max,
                          scalar_min=jplan.scalar_min,
                          scalar_sum=jplan.scalar_sum)
T = types.SimpleNamespace(PlanBuilder=tplan.PlanBuilder, col=tplan.col,
                          lit=tplan.lit, scalar_max=tplan.scalar_max,
                          scalar_min=tplan.scalar_min,
                          scalar_sum=tplan.scalar_sum)


def _strip(text: str) -> str:
    return re.sub(r"#\d+", "", text)


def _joptimize(plan, *args, **kw):
    with jstats.scoped_store(None):
        return jplan.optimize(plan, *args, **kw)


def _assert_same_rewrite(jp, tp, bound=None, bound_rows=None,
                         float_inputs=False):
    assert jp.fingerprint == tp.fingerprint
    assert _strip(jp.explain()) == _strip(tp.explain())
    jo, jr = _joptimize(jp, bound, bound_rows, float_inputs=float_inputs)
    to, tr = topt.optimize(tp, bound, bound_rows, float_inputs=float_inputs)
    assert tr.rules_fired() == jr.rules_fired()
    assert tr.pruned_columns == jr.pruned_columns
    assert tr.pruned_bytes_est == jr.pruned_bytes_est
    assert (tr.source_fingerprint, tr.fingerprint) == \
        (jr.source_fingerprint, jr.fingerprint)
    assert tr.fell_back == jr.fell_back
    assert _strip(to.explain()) == _strip(jo.explain())
    assert set(tr.to_dict()) == set(jr.to_dict())
    return to, tr


# ---- the NDS plans, built with each package's builder -----------------------

def _q5(m):
    """benchmarks/nds_plans.py::q5_plan, written once for either package."""
    b = m.PlanBuilder()
    col, lit = m.col, m.lit
    dates = (b.scan("dates", schema=["d_date_sk"])
             .filter((col("d_date_sk") >= DATE_LO) &
                     (col("d_date_sk") < DATE_HI)))
    sums = [("sales", "sum", "sales"), ("returns", "sum", "returns"),
            ("profit", "sum", "profit"), ("loss", "sum", "loss")]
    per = []
    for ci, name in enumerate(("store", "catalog", "web")):
        s = b.scan(f"{name}_sales",
                   schema=["sk", "date_sk", "sales_price", "profit"])
        r = b.scan(f"{name}_returns",
                   schema=["sk", "date_sk", "return_amt", "net_loss"])
        s_rows = s.project([("sk", col("sk")), ("date_sk", col("date_sk")),
                            ("sales", col("sales_price")),
                            ("profit", col("profit")),
                            ("returns", lit(0)), ("loss", lit(0))])
        r_rows = r.project([("sk", col("sk")), ("date_sk", col("date_sk")),
                            ("sales", lit(0)), ("profit", lit(0)),
                            ("returns", col("return_amt")),
                            ("loss", col("net_loss"))])
        u = (s_rows.union(r_rows)
             .join(dates, left_on="date_sk", right_on="d_date_sk",
                   how="left_semi"))
        g = (u.aggregate(["sk"], sums)
              .project([("channel", lit(ci))] +
                       [(n, col(n)) for n in ("sk", "sales", "returns",
                                              "profit", "loss")]))
        per.append(g)
    allch = m.PlanBuilder.union(per)
    sub = allch.aggregate(["channel"], sums)
    tot = (allch.project([("channel", lit(-1))] +
                         [(n, col(n)) for n in ("sales", "returns",
                                                "profit", "loss")])
                .aggregate(["channel"], sums))
    return (sub.union(tot)
               .sort(["channel", "sales"], ascending=[True, False])
               .build())


def _q72(m):
    """benchmarks/nds_plans.py::q72_plan, written once for either package."""
    b = m.PlanBuilder()
    col = m.col
    cs = b.scan("cs", schema=["item_sk", "hd_sk", "sold_date_sk",
                              "ship_days", "qty"])
    inv = b.scan("inv", schema=["inv_item_sk", "inv_week", "inv_wh_sk",
                                "inv_qty"])
    items = b.scan("items", schema=["i_item_sk", "i_brand"])
    hd = (b.scan("hd", schema=["hd_demo_sk", "hd_buy_potential"])
          .filter(col("hd_buy_potential") == 3))
    wh = b.scan("wh", schema=["w_warehouse_sk"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_week", "d_year"])
             .filter(col("d_year") == 1))
    j = (cs.join(hd, "hd_sk", "hd_demo_sk")
           .join(items, "item_sk", "i_item_sk")
           .join(dates, "sold_date_sk", "d_date_sk")
           .filter(col("ship_days") > 5)
           .join(inv, ["i_item_sk", "d_week"], ["inv_item_sk", "inv_week"])
           .filter(col("inv_qty") < col("qty"))
           .join(wh, "inv_wh_sk", "w_warehouse_sk"))
    return (j.aggregate(["i_item_sk", "w_warehouse_sk", "d_week"],
                        [("qty", "size", "cnt")])
             .sort(["cnt", "i_item_sk", "w_warehouse_sk", "d_week"],
                   ascending=[False, True, True, True])
             .build())


def _q3_tpcds(m):
    b = m.PlanBuilder()
    col = m.col
    sales = b.scan("sales", schema=["sold_date_sk", "item_sk", "price_cents"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_year", "d_moy"])
             .filter(col("d_moy") == 11))
    items = (b.scan("items", schema=["i_item_sk", "i_brand", "i_manufact"])
             .filter(col("i_manufact") == 42))
    j = (sales.join(dates, left_on="sold_date_sk", right_on="d_date_sk")
              .join(items, left_on="item_sk", right_on="i_item_sk"))
    return (j.aggregate(["d_year", "i_brand"],
                        [("price_cents", "sum", "revenue")])
             .sort(["d_year", "revenue", "i_brand"],
                   ascending=[True, False, True])
             .limit(100)
             .build())


# bound row counts in the proportions of the benches' tables, so that the
# build_side rule has estimates to decide on
_NDS = {
    "q3": (nds_plans.q3_plan, lambda: nds_q3.q3_plan(),
           {"sales": 10_000, "dates": 3650, "items": 20_000}),
    "q5": (nds_plans.q5_plan, lambda: _q5(T),
           {"dates": 1000, **{f"{c}_{k}": r for c in ("store", "catalog",
                                                       "web")
                              for k, r in (("sales", 9000),
                                           ("returns", 900))}}),
    "q72": (nds_plans.q72_plan, lambda: _q72(T),
            {"cs": 2500, "inv": 40_000, "items": 500, "hd": 7200,
             "wh": 5, "dates": 700}),
    "q3_tpcds": (lambda: _q3_tpcds(J), nds_q3.q3_tpcds_plan,
                 {"sales": 10_000, "dates": 3650, "items": 20_000}),
}


@pytest.mark.parametrize("bind", [False, True])
@pytest.mark.parametrize("q", sorted(_NDS))
def test_nds_plans_rewrite_as_the_reference(q, bind):
    mk_j, mk_t, rows = _NDS[q]
    jp, tp = mk_j(), mk_t()
    bound = ({s.source: s.schema for s in tp.scans} if bind else None)
    to, tr = _assert_same_rewrite(jp, tp, bound, rows if bind else None)
    assert tr.rules_fired()
    if q == "q3_tpcds":
        assert tr.rules_fired() == {"limit_pushdown": 1, "column_pruning": 4,
                                    "select_fusion": 2}
        assert [n.kind for n in to.nodes].count("FusedSelect") == 2
        assert to.root.kind == "TopK" and to.root.n == 100
    if q == "q72":
        assert tr.rules["predicate_pushdown"] > 0
        assert tr.rules["build_side"] == (1 if bind else 0)


def test_helper_plans_transcribe_the_bench_plans():
    assert _q5(J).fingerprint == nds_plans.q5_plan().fingerprint
    assert _q72(J).fingerprint == nds_plans.q72_plan().fingerprint
    assert _q3_tpcds(J).fingerprint == nds_q3.q3_tpcds_plan().fingerprint


@pytest.mark.parametrize("q", sorted(_NDS))
def test_nds_idempotent(q):
    tp = _NDS[q][1]()
    once, _ = topt.optimize(tp)
    twice, r2 = topt.optimize(once)
    assert once.fingerprint == twice.fingerprint
    assert r2.total_rewrites() == 0


# ---- the single-device cases of tests/test_optimizer.py ---------------------

def _sales_dims(m):
    b = m.PlanBuilder()
    s = b.scan("sales", schema=["k", "v", "junk"])
    d = b.scan("dims", schema=["dk", "grp", "extra"]).filter(m.col("grp") == 1)
    return (s.join(d, left_on="k", right_on="dk")
             .aggregate(["grp"], [("v", "sum", "total")]).build())


def _small_plan(m, c=11):
    b = m.PlanBuilder()
    s = b.scan("sales", schema=["k", "v", "junk"])
    d = b.scan("dims", schema=["dk", "grp", "extra"]).filter(m.col("grp") == 1)
    return (s.join(d, left_on="k", right_on="dk")
             .project({"grp": m.col("grp"), "rev": m.col("v") * m.lit(c)})
             .aggregate(["grp"], [("rev", "sum", "total")])
             .sort(["grp"]).build())


def _shared_union(m):
    b = m.PlanBuilder()
    u = b.scan("l", schema=["v"]).union(b.scan("r", schema=["v"]))
    inner = u.filter(m.col("v") > 0)
    shared = inner.project({"v": m.col("v"), "w": m.col("v") * 2})
    return (shared.filter(m.col("v") > 5)
            .join(shared, left_on="v", right_on="v", how="left_semi")
            .build())


def _shared_subtree(m):
    b = m.PlanBuilder()
    t = b.scan("t", schema=["a", "u", "w", "junk"])
    shared = t.filter(m.col("a") > 0)
    left = shared.aggregate(["a"], [("u", "sum", "su")])
    right = shared.aggregate(["a"], [("w", "sum", "sw")])
    return left.join(right, left_on="a", right_on="a",
                     how="left_semi").build()


def _union_shared_elsewhere(m):
    b = m.PlanBuilder()
    a = b.scan("a", schema=["k", "x", "junk", "junk2"])
    c2 = b.scan("c", schema=["k", "x", "junk", "junk2"])
    u = a.union(c2).aggregate(["k"], [("x", "sum", "s")])
    other = a.aggregate(["k"], [("junk", "sum", "j")])
    return u.join(other, left_on="k", right_on="k", how="left_semi").build()


def _swap(m, est=None):
    b = m.PlanBuilder()
    d = b.scan("dims", schema=["dk", "grp", "extra"])
    s = b.scan("sales", schema=["k", "v", "junk"])
    return (d.join(s, left_on="dk", right_on="k")
             .aggregate(["grp"], [("v", "sum", "total")]).build())


def _hinted(m, l_rows, r_rows, agg=True):
    b = m.PlanBuilder()
    l = b.scan("l", schema=["grp"], est_rows=l_rows)
    r = b.scan("r", schema=["v"], est_rows=r_rows)
    j = l.join(r, left_on="grp", right_on="v")
    if not agg:
        return j.build()
    return (j.project({"grp": m.col("grp"), "v": m.col("v")})
             .aggregate(["grp"], [("v", "sum", "total")]).build())


_CASES = {
    "filter_true_drops": lambda m: (
        m.PlanBuilder().scan("t", schema=["v"])
        .filter(m.lit(1) < m.lit(2)).build()),
    "filter_false_short_circuits": lambda m: (
        m.PlanBuilder().scan("t", schema=["v"]).filter(m.col("v") > 0)
        .filter(m.lit(1) > m.lit(2)).build()),
    "literal_subtree_folds": lambda m: (
        m.PlanBuilder().scan("t", schema=["v"])
        .filter(m.col("v") > m.lit(2) + m.lit(3)).build()),
    "pushdown_below_project": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .project({"a": m.col("a"), "w": m.col("v") * 2})
        .filter(m.col("a") > 5).build()),
    "no_pushdown_through_computed": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .project({"w": m.col("v") * 2}).filter(m.col("w") > 5).build()),
    "pushdown_below_union": lambda m: (
        m.PlanBuilder().scan("l", schema=["v"])
        .union(m.PlanBuilder().scan("r", schema=["v"]))
        .filter(m.col("v") > 10).build()),
    "pushdown_into_join_sides": lambda m: (
        m.PlanBuilder().scan("s", schema=["k", "v"])
        .join(m.PlanBuilder().scan("d", schema=["dk", "grp"]),
              left_on="k", right_on="dk")
        .filter(m.col("grp") == 1).filter(m.col("v") > 3).build()),
    "shared_guard_same_pass": _shared_union,
    "scan_narrows": _sales_dims,
    "project_outputs_narrow": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .project({"a": m.col("a"), "w": m.col("v") * 2,
                  "dead": m.col("v") * 3})
        .aggregate(["a"], [("w", "sum", "s")]).build()),
    "join_input_narrowing_select": lambda m: (
        m.PlanBuilder().scan("s", schema=["k", "v"])
        .join(m.PlanBuilder().scan("d", schema=["dk", "grp", "extra"])
              .filter(m.col("extra") > 0), left_on="k", right_on="dk")
        .aggregate(["k"], [("v", "sum", "t")]).build()),
    "shared_subtree_requirements": _shared_subtree,
    "union_input_shared_elsewhere": _union_shared_elsewhere,
    "aggregate_drops_dead_aggs": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .aggregate(["a"], [("v", "sum", "s"), ("v", "max", "dead")])
        .project({"a": m.col("a"), "s": m.col("s")}).build()),
    "project_filter_fuses": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .filter(m.col("a") > 2).project({"w": m.col("v") * 2}).build()),
    "adjacent_filters_merge": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .filter(m.col("a") > 1).filter(m.col("v") < 25).build()),
    "sort_limit_becomes_topk": lambda m: (
        m.PlanBuilder().scan("sales", schema=["k", "v", "junk"])
        .sort(["v", "k"], ascending=[False, True]).limit(7).build()),
    "limit_below_rowwise_project": lambda m: (
        m.PlanBuilder().scan("t", schema=["v"])
        .project({"w": m.col("v") * 2}).limit(2).build()),
    "limit_limit_collapses": lambda m: (
        m.PlanBuilder().scan("t", schema=["v"]).limit(5).limit(2).build()),
    "build_side_swaps": _swap,
    "no_swap_when_order_observable": lambda m: _hinted(m, 10, 10_000, False),
    "no_swap_without_margin": lambda m: _hinted(m, 100, 150),
    "est_rows_hint_swaps": lambda m: _hinted(m, 10, 1000),
    "small_plan": _small_plan,
    # scalar aggregates are not row-wise: the rules that would change the
    # row set under one stand back (`has_scalar_agg`)
    "scalar_filter_stays_above_union": lambda m: (
        m.PlanBuilder().scan("l", schema=["v"])
        .union(m.PlanBuilder().scan("r", schema=["v"]))
        .filter(m.col("v") > m.lit(0.5) * m.scalar_max(m.col("v")))
        .build()),
    "scalar_filter_stays_above_join": lambda m: (
        m.PlanBuilder().scan("s", schema=["k", "v"])
        .join(m.PlanBuilder().scan("d", schema=["dk", "grp"]),
              left_on="k", right_on="dk")
        .filter(m.col("grp") > m.scalar_min(m.col("grp"))).build()),
    "scalar_filter_passes_a_renaming_project": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .project({"a": m.col("a"), "w": m.col("v")})
        .filter(m.col("w") > m.lit(0.5) * m.scalar_max(m.col("a")))
        .build()),
    "no_pushdown_below_a_scalar_project": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .project({"a": m.col("a"), "m": m.scalar_max(m.col("v"))})
        .filter(m.col("a") > 5).build()),
    "no_limit_below_a_scalar_project": lambda m: (
        m.PlanBuilder().scan("t", schema=["v"])
        .project({"s": m.scalar_sum(m.col("v"))}).limit(2).build()),
    "scalar_filter_does_not_fuse": lambda m: (
        m.PlanBuilder().scan("t", schema=["a", "v"])
        .filter(m.col("a") > m.lit(0.5) * m.scalar_max(m.col("a")))
        .project({"w": m.col("v") * 2}).build()),
}

# bound rows where the reference's case binds them
_ROWS = {"build_side_swaps": {"dims": 50, "sales": 2000},
         "scan_narrows": {"sales": 2000, "dims": 50}}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_single_device_cases_rewrite_as_the_reference(case):
    mk = _CASES[case]
    jp, tp = mk(J), mk(T)
    rows = _ROWS.get(case)
    bound = {s.source: s.schema for s in tp.scans} if rows else None
    to, tr = _assert_same_rewrite(jp, tp, bound, rows)
    if case == "filter_false_short_circuits":
        assert any(isinstance(n, Limit) and n.n == 0 for n in to.nodes)
    if case == "scan_narrows":
        assert {s.source: s.projection for s in to.nodes
                if isinstance(s, Scan)} == {"sales": ("k", "v"),
                                            "dims": ("dk", "grp")}
    if case == "build_side_swaps":
        assert tr.rules["build_side"] == 1
    if case == "shared_subtree_requirements":
        assert sum(isinstance(n, Filter) for n in to.nodes) == 1


def test_float_inputs_disable_build_side():
    jp, tp = _swap(J), _swap(T)
    rows = {"dims": 50, "sales": 2000}
    _, tr = _assert_same_rewrite(jp, tp, None, rows, float_inputs=True)
    assert tr.rules["build_side"] == 0


def test_fingerprint_is_literal_sensitive():
    assert _small_plan(T).fingerprint == _small_plan(T).fingerprint
    assert _small_plan(T).fingerprint != _small_plan(T, c=12).fingerprint
    assert _small_plan(T, c=12).fingerprint == _small_plan(J, c=12).fingerprint


def test_unported_arguments_name_their_item():
    # mesh_peers is ported (queue A item 13): exchange_planning runs
    _, rep = topt.optimize(_small_plan(T), mesh_peers=4)
    assert rep.rules["exchange_planning"] > 0 and rep.sharding
    with pytest.raises(NotImplementedError, match="queue A item 14"):
        topt.optimize(_small_plan(T), placement=True)
    # the stats store and the certifier's dtypes are ported (queue A
    # item 11): accepted, with the static decisions of an empty store
    from spark_rapids_tpu_torch.plan import stats as torch_stats
    opt, rep = topt.optimize(
        _small_plan(T), stats=torch_stats.StatsStore(path=""),
        backend="cpu", input_dtypes={})
    assert rep.stats_driven() is False
    with pytest.raises(TypeError):
        topt.optimize(_small_plan(T), no_such_argument=1)


def test_invalid_rewrite_falls_back_to_the_authored_plan(monkeypatch):
    # a rule that drops a join's build side: re-validation fails and the
    # authored plan runs, with the culprit rule named
    def bad_rule(root, ctx):
        def fn(node):
            if isinstance(node, HashJoin):
                return node.left
            return None
        return topt._rewrite(root, fn), 1
    monkeypatch.setattr(topt, "_RULES", topt._RULES + (("select_fusion",
                                                         bad_rule),))
    plan = _small_plan(T)
    opt, rep = topt.optimize(plan)
    assert opt is plan and rep.fell_back
    assert rep.fallback["rule"] == "select_fusion"
    assert rep.rules_fired() == {}
    opt, rep = topt.optimize(plan, verify_rules=True)
    assert opt is plan and rep.fell_back and rep.passes == 1


# ---- execution: optimizer on and off against the JAX package ----------------

def _data(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    return {
        "sales": {"k": rng.integers(0, 50, n), "v": rng.integers(1, 100, n),
                  "junk": rng.integers(0, 9, n)},
        "dims": {"dk": np.arange(50), "grp": np.arange(50) % 3,
                 "extra": np.arange(50) * 7},
        "t": {"a": rng.integers(0, 6, 40), "v": rng.integers(0, 50, 40)},
        "s": {"k": rng.integers(0, 50, 300), "v": rng.integers(0, 9, 300)},
        "d": {"dk": np.arange(50), "grp": np.arange(50) % 3,
              "extra": np.arange(50) - 20},
        "l": {"v": rng.integers(-20, 40, 60)},
        "r": {"v": rng.integers(-20, 40, 25)},
        "a": {c: rng.integers(0, 8, 30) for c in ("k", "x", "junk",
                                                   "junk2")},
        "c": {c: rng.integers(0, 8, 20) for c in ("k", "x", "junk",
                                                   "junk2")},
    }


def _inputs(plan_scans, data):
    jin, tin = {}, {}
    for s in plan_scans:
        cols = {c: np.asarray(data[s.source][c], np.int64) for c in s.schema}
        jin[s.source] = JTable([JColumn.from_numpy(a) for a in cols.values()],
                               names=list(cols))
        tin[s.source] = table_from_numpy(list(cols), list(cols.values()),
                                         [None] * len(cols),
                                         ["int64"] * len(cols), device="cpu")
    return jin, tin


def _assert_tables(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        npt.assert_array_equal(np.asarray(jc.data), tc.data.numpy())


_RUNNABLE = ["filter_true_drops", "filter_false_short_circuits",
             "pushdown_below_project", "pushdown_into_join_sides",
             "scan_narrows", "project_outputs_narrow",
             "join_input_narrowing_select", "aggregate_drops_dead_aggs",
             "project_filter_fuses", "adjacent_filters_merge",
             "sort_limit_becomes_topk", "limit_below_rowwise_project",
             "limit_limit_collapses", "build_side_swaps", "small_plan",
             # Unions and scalar aggregates run since the port has them
             "pushdown_below_union", "shared_guard_same_pass",
             "union_input_shared_elsewhere",
             "scalar_filter_stays_above_union",
             "scalar_filter_stays_above_join",
             "scalar_filter_passes_a_renaming_project",
             "no_pushdown_below_a_scalar_project",
             "no_limit_below_a_scalar_project",
             "scalar_filter_does_not_fuse"]


@pytest.mark.parametrize("case", _RUNNABLE)
def test_execution_matches_reference_on_and_off(case):
    mk = _CASES[case]
    jp, tp = mk(J), mk(T)
    jin, tin = _inputs(tp.scans, _data())
    with jstats.scoped_store(None):
        jres = jplan.PlanExecutor(optimize=True).execute(jp, jin)
    on = tplan.PlanExecutor(device="cpu").execute(tp, tin)
    off = tplan.PlanExecutor(device="cpu", optimize=False).execute(tp, tin)
    _assert_tables(jres.table, on.table)
    _assert_tables(jres.table, off.table)
    assert on.optimizer["rules_fired"] == jres.optimizer["rules_fired"]
    assert on.optimizer["fingerprint"] == jres.optimizer["fingerprint"]
    assert off.optimizer is None and off.plan is tp
    assert _strip(on.plan.explain()) == _strip(jres.plan.explain())


def test_env_switch_and_profile(monkeypatch):
    jin, tin = _inputs(_small_plan(T).scans, _data())
    plan = _small_plan(T)
    res = tplan.PlanExecutor(device="cpu").execute(plan, tin)
    txt = res.profile_text()
    assert "optimizer: rules_fired=" in txt and "pruned" in txt
    ex = tplan.PlanExecutor(device="cpu")
    assert ex.explain(plan) == plan.explain()
    txt = ex.explain(plan, optimized=True)
    assert "== optimized ==" in txt and "sales [k, v]" in txt
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_OPTIMIZER", "off")
    res = tplan.PlanExecutor(device="cpu").execute(plan, tin)
    assert res.optimizer is None and res.plan is plan
    assert len(res.metrics) == len(plan.nodes)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_OPTIMIZER", "banana")
    with pytest.raises(ValueError, match="banana"):
        tplan.PlanExecutor(device="cpu")


def test_rewrite_cache_keys_on_float_inputs():
    # a swap computed from integer inputs is not served to a float
    # binding of the same names and row counts
    b = T.PlanBuilder()
    plan = (b.scan("small", schema=["sk", "g"])
             .join(b.scan("big", schema=["bk", "v"]),
                   left_on="sk", right_on="bk")
             .aggregate(["g"], [("v", "sum", "s")]).build())
    small = table_from_numpy(["sk", "g"], [np.array([0, 0]),
                                           np.array([7, 7])],
                             [None, None], ["int64", "int64"], device="cpu")
    bk = np.array([0] * 4 + list(range(1, 40)))
    big_i = table_from_numpy(["bk", "v"], [bk, np.arange(43)], [None, None],
                             ["int64", "int64"], device="cpu")
    big_f = table_from_numpy(["bk", "v"], [bk, np.arange(43.0)],
                             [None, None], ["int64", "float64"],
                             device="cpu")
    ex = tplan.PlanExecutor(device="cpu")
    r_int = ex.execute(plan, {"small": small, "big": big_i})
    assert r_int.optimizer["rules_fired"].get("build_side") == 1
    r_flt = ex.execute(plan, {"small": small, "big": big_f})
    assert not r_flt.optimizer["rules_fired"].get("build_side")


@pytest.mark.parametrize("q", sorted(_NDS))
def test_subtree_fingerprints_and_conjuncts_match(q):
    mk_j, mk_t, _ = _NDS[q]
    jp, tp = mk_j(), mk_t()
    from spark_rapids_tpu.plan import optimizer as jopt
    jfp = jopt.subtree_fingerprints(jp.root)
    tfp = topt.subtree_fingerprints(tp.root)
    assert [jfp[id(n)] for n in jp.nodes] == [tfp[id(n)] for n in tp.nodes]
    for jn, tn in zip(jp.nodes, tp.nodes):
        if tn.kind == "Filter":
            assert [repr(c) for c in jopt.split_conjuncts(jn.predicate)] == \
                [repr(c) for c in topt.split_conjuncts(tn.predicate)]
