"""The port's resource certifier (spark_rapids_tpu_torch/analysis/
footprint.py) against the JAX package's, and its three consumers, case by
case after the reference's tests/test_footprint.py (its streaming-scan and
parquet cases wait for ROADMAP queue A item 9, its broadcast byte proof
for item 13; its degraded admission runs the port's degraded CPU tier
against the reference's).

Parity: for every NDS plan (q3, TPC-DS q3 INT32 and STRING, q72, q5, q23,
q74, authored and optimized) and every plain corpus seed (authored and
optimized), the port's certificate gives each operator, in toposort
order, the same `rows_lo`, `rows_hi`, `row_bytes` and `out_bytes_hi` as
the reference's, exactly, over the same names, row counts, dtypes and
nullability; exchange payloads are compared at four peers. Working bytes
are the port's own kernels' tables (`join_cuda._capacity`,
`groupby_cuda.capacity`), a limit the port states, and are checked
against those formulas. Tolerance: exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.analysis import certify as jcertify
from spark_rapids_tpu.analysis import fuzz as jfuzz
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import lit as jlit
from spark_rapids_tpu.plan.optimizer import optimize as joptimize

from benchmarks import nds_plans

from spark_rapids_tpu_torch import (nds_q23, nds_q3, nds_q5, nds_q72, nds_q74,
                                    table_from_numpy)
from spark_rapids_tpu_torch.analysis import (ResourceAdmissionError, certify,
                                             certify_nodes, check_observed,
                                             table_metadata)
from spark_rapids_tpu_torch.analysis import fuzz as tfuzz
from spark_rapids_tpu_torch.ops import groupby_cuda, join_cuda
from spark_rapids_tpu_torch.parallel.autoretry import auto_retry_overflow
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col, lit
from spark_rapids_tpu_torch.plan import stats as stats_mod
from spark_rapids_tpu_torch.plan.builder import Plan, _toposort
from spark_rapids_tpu_torch.plan.nodes import Exchange, Scan
from spark_rapids_tpu_torch.plan.optimizer import optimize

_SAME = ("rows_lo", "rows_hi", "row_bytes", "out_bytes_hi")


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    with stats_mod.scoped_store(None):
        yield


def _tbl(**cols):
    names = list(cols)
    arrays, kinds = [], []
    for v in cols.values():
        a = np.asarray(v)
        kind = ("float64" if a.dtype.kind == "f" else
                "bool" if a.dtype.kind == "b" else "int64")
        arrays.append(a.astype({"float64": np.float64, "bool": np.bool_,
                                "int64": np.int64}[kind]))
        kinds.append(kind)
    return table_from_numpy(names, arrays, [None] * len(names), kinds,
                            device="cpu")


def _cert_kw(inputs):
    dts, nul = table_metadata(inputs)
    return dict(bound={n: tuple(t.names) for n, t in inputs.items()},
                bound_rows={n: t.num_rows for n, t in inputs.items()},
                input_dtypes=dts, input_nullable=nul)


def _jax_dtype(d):
    return jdt.DType(jdt.Kind(d.kind.value), d.precision, d.scale,
                     tuple(_jax_dtype(c) for c in d.children),
                     tuple(d.field_names))


def _jax_kw(kw):
    out = dict(kw)
    out["input_dtypes"] = {n: {c: _jax_dtype(d) for c, d in cols.items()}
                           for n, cols in kw["input_dtypes"].items()}
    return out


def _sound(res, inputs):
    cert = certify(res.plan, **_cert_kw(inputs))
    assert check_observed(cert, res) is None
    return cert


def _assert_same_cert(tplan, jplan, kw, n_peers=1):
    assert tplan.fingerprint == jplan.fingerprint
    t = certify(tplan, n_peers=n_peers, **kw)
    j = jcertify(jplan, n_peers=n_peers, **_jax_kw(kw))
    assert [b.kind for b in t.ops] == [b.kind for b in j.ops]
    for tb, jb in zip(t.ops, j.ops):
        for f in _SAME:
            assert getattr(tb, f) == getattr(jb, f), (tb.label, f)
        assert tb.exchange_bytes_hi == jb.exchange_bytes_hi, tb.label
    assert t.unbounded == [b.label for b, jb in zip(t.ops, j.ops)
                           if jb.label in j.unbounded]
    return t


# ---- parity with the reference ----------------------------------------------

def _q3_jax_tpcds():
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


_NDS = {
    "q3": (nds_q3.q3_plan, nds_plans.q3_plan,
           lambda: nds_q3.q3_inputs(3000, seed=0, device="cpu")),
    "tpcds_q3": (nds_q3.q3_tpcds_plan, _q3_jax_tpcds,
                 lambda: nds_q3.q3_tpcds_inputs(3000, seed=0, device="cpu")),
    "tpcds_q3_strings": (
        nds_q3.q3_tpcds_strings_plan,
        lambda: nds_q3.q3_tpcds_strings_plan(100, JPlanBuilder, jcol),
        lambda: nds_q3.q3_tpcds_strings_inputs(3000, seed=0, device="cpu")),
    "q72": (nds_q72.q72_plan, nds_plans.q72_plan,
            lambda: nds_q72.q72_inputs(3000, seed=0, device="cpu")),
    "q5": (nds_q5.q5_plan, nds_plans.q5_plan,
           lambda: nds_q5.q5_inputs(3000, seed=0, device="cpu")),
    "q23": (nds_q23.q23_plan, nds_plans.q23_plan,
            lambda: nds_q23.q23_inputs(3000, seed=0, device="cpu")),
    "q74": (nds_q74.q74_plan,
            lambda: nds_q74.q74_plan(nds_q74.LIMIT, JPlanBuilder, jcol),
            lambda: nds_q74.q74_inputs(3000, 800, 500, seed=0,
                                       device="cpu")),
}


@pytest.mark.parametrize("which", sorted(_NDS))
def test_nds_certificates_equal_the_reference(which):
    tplan_fn, jplan_fn, make = _NDS[which]
    inputs = make()
    kw = _cert_kw(inputs)
    tplan, jplan = tplan_fn(), jplan_fn()
    cert = _assert_same_cert(tplan, jplan, kw)
    floats = any(c.dtype.is_floating for t in inputs.values()
                 for c in t.columns)
    topt, _ = optimize(tplan, kw["bound"], kw["bound_rows"],
                       float_inputs=floats)
    jopt, _ = joptimize(jplan, kw["bound"], kw["bound_rows"],
                        float_inputs=floats)
    _assert_same_cert(topt, jopt, kw)
    # the executed runs stay inside it, on both tiers where they run
    res = PlanExecutor(device="cpu", optimize=False).execute(tplan, inputs)
    assert check_observed(cert, res) is None
    if which not in ("tpcds_q3_strings", "q74"):    # STRING keys: eager
        res = PlanExecutor(mode="capped", device="cpu",
                           optimize=False).execute(tplan, inputs)
        assert check_observed(cert, res) is None


@pytest.mark.parametrize("seed", range(48))
def test_corpus_certificates_equal_the_reference(seed):
    tc = tfuzz.gen_case(seed, device="cpu")
    jc = jfuzz.gen_case(seed)
    kw = _cert_kw(tc.tables)
    _assert_same_cert(tc.plan, jc.plan, kw)
    _assert_same_cert(tc.plan, jc.plan, kw, n_peers=4)
    floats = any(c.dtype.is_floating for t in tc.tables.values()
                 for c in t.columns)
    topt, _ = optimize(tc.plan, kw["bound"], kw["bound_rows"],
                       float_inputs=floats)
    jopt, _ = joptimize(jc.plan, kw["bound"], kw["bound_rows"],
                        float_inputs=floats)
    _assert_same_cert(topt, jopt, kw)


# ---- bound classes ----------------------------------------------------------

def test_filter_bound_collapses_lo_never_hi():
    plan = PlanBuilder().scan("t", schema=["k", "v"]).filter(
        col("v") > 100).build()
    inputs = {"t": _tbl(k=[1, 2, 3], v=[1, 2, 3])}
    cert = certify(plan, **_cert_kw(inputs))
    f = next(bb for bb in cert.ops if bb.kind == "Filter")
    assert (f.rows_lo, f.rows_hi) == (0, 3)
    assert f.row_bytes == 18 and f.out_bytes_hi == 54
    _sound(PlanExecutor(device="cpu").execute(plan, inputs), inputs)


def test_join_working_set_is_the_kernels_table():
    b = PlanBuilder()
    plan = b.scan("l", schema=["k", "v"]).join(
        b.scan("r", schema=["k2", "w"]), "k", "k2").build()
    inputs = {"l": _tbl(k=[1, 1, 2], v=[1, 2, 3]),
              "r": _tbl(k2=[1, 1], w=[5, 6])}
    cert = certify(plan, **_cert_kw(inputs))
    j = next(bb for bb in cert.ops if bb.kind == "HashJoin")
    assert j.rows_hi == 3 * 2
    # hash_join.cu's table over the 2 build rows: 256 slots x 8 bytes
    assert j.working_bytes_hi == 8 * join_cuda._capacity(2) == 2048
    assert j.resident_bytes_hi == (j.out_bytes_hi + 2048
                                   + 3 * 18 + 2 * 18)
    _sound(PlanExecutor(device="cpu").execute(plan, inputs), inputs)
    # the large route's tables: the same 8 bytes a slot
    big = certify_nodes(_toposort(plan.root),
                        **{**_cert_kw(inputs),
                           "bound_rows": {"l": 3, "r": 52_000}})
    jb = big[id(plan.root)]
    assert jb.working_bytes_hi == 8 * join_cuda._capacity(52_000)


def test_aggregate_working_set_is_the_kernels_table():
    plan = PlanBuilder().scan("t", schema=["k", "v"]).aggregate(
        ["k"], [("v", "sum", "s"), ("v", "count", "c")]).build()
    inputs = {"t": _tbl(k=[1, 1, 2, 2], v=[1, 2, 3, 4])}
    cert = certify(plan, **_cert_kw(inputs))
    a = next(bb for bb in cert.ops if bb.kind == "HashAggregate")
    assert (a.rows_lo, a.rows_hi) == (1, 4)
    assert a.row_bytes == 9 + 2 * 9
    # groupby.cu's insertion table: capacity(4) int32 slots
    assert a.working_bytes_hi == 4 * groupby_cuda.capacity(4) == 256
    _sound(PlanExecutor(mode="capped", device="cpu").execute(plan, inputs),
           inputs)
    g = certify(PlanBuilder().scan("t", schema=["k", "v"]).aggregate(
        [], [("v", "sum", "s")]).build(), **_cert_kw(inputs))
    assert g.root.working_bytes_hi == 0 and g.root.rows_hi == 1


def test_keyed_aggregate_lo_collapses_under_nullable_keys():
    plan = PlanBuilder().scan("t", schema=["k", "v"]).aggregate(
        ["k"], [("v", "sum", "s")]).build()
    kw = _cert_kw({"t": _tbl(k=[1], v=[2])})
    kw["input_nullable"] = {"t": {"k": True, "v": False}}
    a = next(bb for bb in certify(plan, **kw).ops
             if bb.kind == "HashAggregate")
    assert a.rows_lo == 0


def test_exchange_payload_bounds_per_kind():
    scan = Scan("t", schema=("k", "v"))
    hash_ex = Exchange(scan, ("k",), how="hash")
    inputs = {"t": _tbl(k=[1, 2, 3, 4], v=[1, 2, 3, 4])}
    by_id = certify_nodes(_toposort(hash_ex), n_peers=4, **_cert_kw(inputs))
    assert by_id[id(hash_ex)].exchange_bytes_hi == 4 * (8 + 9)
    bcast = Exchange(scan, (), how="broadcast")
    by_id = certify_nodes(_toposort(bcast), n_peers=4, **_cert_kw(inputs))
    assert by_id[id(bcast)].exchange_bytes_hi == 4 * 18 * 3
    gather = Exchange(scan, (), how="gather")
    by_id = certify_nodes(_toposort(gather), n_peers=4, **_cert_kw(inputs))
    assert by_id[id(gather)].exchange_bytes_hi == 4 * 18
    by_id = certify_nodes(_toposort(hash_ex), n_peers=1, **_cert_kw(inputs))
    assert by_id[id(hash_ex)].exchange_bytes_hi == 0
    assert certify(Plan(hash_ex), n_peers=4,
                   **_cert_kw(inputs)).exchange_bytes_hi == 4 * (8 + 9)


def test_fused_aggregate_exchange_bounds_partials():
    plan = (PlanBuilder().scan("t", schema=["k", "v"]).exchange(keys=["k"])
            .aggregate(["k"], [("v", "sum", "s"), ("v", "min", "lo"),
                               ("v", "count", "c")]).build())
    inputs = {"t": _tbl(k=[1, 1, 2, 2], v=[1, 2, 3, 4])}
    cert = certify(plan, n_peers=4, **_cert_kw(inputs))
    ex = next(bb for bb in cert.ops if bb.kind == "Exchange")
    assert ex.exchange_bytes_hi == 4 * 32


def test_unbounded_inputs_poison_bytes_never_rows():
    from spark_rapids_tpu_torch import dtypes as tdt
    from spark_rapids_tpu_torch.columnar import Column, Table
    plan = PlanBuilder().scan("t", schema=["k", "s"]).filter(
        col("k") > 0).build()
    strings = Column.from_pylist([b"ab", b"def"], tdt.STRING, device="cpu")
    k = _tbl(k=[1, 2])["k"]
    inputs = {"t": Table([k, strings], names=["k", "s"])}
    cert = certify(plan, **_cert_kw(inputs))
    f = next(bb for bb in cert.ops if bb.kind == "Filter")
    assert f.rows_hi == 2 and f.out_bytes_hi is None
    assert f.label in cert.unbounded
    assert cert.over_budget(1) == []


# ---- consumer 1: admission --------------------------------------------------

def _join_plan_and_inputs():
    b = PlanBuilder()
    plan = b.scan("l", schema=["k", "v"]).join(
        b.scan("r", schema=["k2", "w"]), "k", "k2").aggregate(
        ["k"], [("w", "sum", "s")]).build()
    inputs = {"l": _tbl(k=[1, 2, 3, 1], v=[1, 3, 4, 5]),
              "r": _tbl(k2=[1, 2, 2], w=[10, 20, 30])}
    return plan, inputs


def test_admission_rejects_over_budget_before_anything_runs():
    plan, inputs = _join_plan_and_inputs()
    ex = PlanExecutor(mode="capped", device="cpu", cert_budget=100)
    with pytest.raises(ResourceAdmissionError) as ei:
        ex.execute(plan, inputs)
    v = ei.value.violations[0]
    assert v.invariant == "footprint.over-budget"
    assert v.node.split("#")[0] in ("Scan", "HashJoin", "HashAggregate",
                                    "Project", "FusedSelect")
    assert len(ex._programs) == 0


def test_admission_budget_env_knob_and_pass(monkeypatch):
    plan, inputs = _join_plan_and_inputs()
    ref = PlanExecutor(mode="capped", device="cpu").execute(plan, inputs)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_BUDGET_BYTES", "100")
    with pytest.raises(ResourceAdmissionError):
        PlanExecutor(mode="capped", device="cpu").execute(plan, inputs)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_BUDGET_BYTES", str(1 << 30))
    res = PlanExecutor(mode="capped", device="cpu").execute(plan, inputs)
    assert res.cert is not None and res.cert.peak_bytes_hi <= (1 << 30)
    assert res.compact().to_pydict() == ref.compact().to_pydict()
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_BUDGET_BYTES", "100")
    res = PlanExecutor(mode="capped", device="cpu",
                       cert_budget=1 << 30).execute(plan, inputs)
    assert res.cert is not None


@pytest.mark.parametrize("mode", ["eager", "capped"])
def test_admission_degrade_runs_the_cpu_tier(monkeypatch, mode):
    """Over the budget, degrade admission runs the whole plan on the
    degraded CPU tier, as the reference's does: every operator degraded,
    the result unpadded and bit-equal to the reference's degraded run;
    within the budget, degrade never comes into it."""
    import jax.numpy as jnp
    from spark_rapids_tpu import Column as JColumn
    from spark_rapids_tpu import Table as JTable
    from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
    plan, inputs = _join_plan_and_inputs()
    jb = JPlanBuilder()
    jplan = jb.scan("l", schema=["k", "v"]).join(
        jb.scan("r", schema=["k2", "w"]), "k", "k2").aggregate(
        ["k"], [("w", "sum", "s")]).build()
    jinputs = {
        n: JTable([JColumn(dtype=jdt.INT64, length=c.length,
                           data=jnp.asarray(c.data.numpy()))
                   for c in t.columns], names=list(t.names))
        for n, t in inputs.items()}
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_ADMISSION", "degrade")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CERT_ADMISSION", "degrade")
    res = PlanExecutor(mode=mode, device="cpu",
                       cert_budget=100).execute(plan, inputs)
    jres = JPlanExecutor(mode=mode, cert_budget=100).execute(jplan, jinputs)
    assert res.degraded and jres.degraded
    assert res.valid is None and res.mode == mode
    assert all(m.degraded for m in res.metrics.values())
    got = res.compact()
    want = jres.compact()
    assert list(got.names) == list(want.names)
    for tc, jc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
    assert "DEGRADED" in res.profile_text()
    ok = PlanExecutor(mode=mode, device="cpu",
                      cert_budget=1 << 30).execute(plan, inputs)
    assert not ok.degraded and ok.compact().num_rows > 0


def test_admission_typo_policy(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_ADMISSION", "degarde")
    plan, inputs = _join_plan_and_inputs()
    with pytest.raises(ValueError):
        PlanExecutor(device="cpu", cert_budget=100).execute(plan, inputs)


def test_cert_stamped_on_result_and_profile():
    plan, inputs = _join_plan_and_inputs()
    res = PlanExecutor(device="cpu").execute(plan, inputs)
    assert res.cert is not None
    assert res.cert.root.rows_hi == 12
    assert "footprint: peak resident <=" in res.profile_text()
    d = res.cert.to_dict()
    assert d["root_rows_hi"] == 12 and d["ops"]
    assert "resource cert" in res.cert.render()


# ---- consumer 2: the optimizer's certified estimates -------------------------

def _two_totals(b, c, unbound_hint=None):
    """A join of two keyless aggregates over unbound scans: the static
    chain has no estimate, the certifier bounds each side at 1 row."""
    left = b.scan("a", schema=["x"]).aggregate([], [("x", "sum", "sx")])
    right = b.scan("b", schema=["y"]).aggregate([], [("y", "sum", "sy")])
    return (left.join(right, left_on="sx", right_on="sy")
            .aggregate(["sx"], [("sy", "sum", "t")]).build())


def test_estimator_certified_tier_fills_static_dead_end():
    tplan = _two_totals(PlanBuilder(), col)
    jplan = _two_totals(JPlanBuilder(), jcol)
    _, trep = optimize(tplan)
    _, jrep = joptimize(jplan)
    assert sorted(trep.decision_sources.values()) == \
        sorted(jrep.decision_sources.values()) == ["keep (certified:1)"]


# ---- consumer 3: the capped tier's caps -------------------------------------

def _limited_join(b):
    big = list(range(64))
    plan = b.scan("l", schema=["k", "v"]).limit(3).join(
        b.scan("r", schema=["k2", "w"]).limit(3), "k", "k2").aggregate(
        ["k"], [("w", "sum", "s")]).build()
    return plan, {"l": _tbl(k=big, v=big), "r": _tbl(k2=big, w=big)}


def test_cold_cap_seeding_tightens_below_static_default():
    plan, inputs = _limited_join(PlanBuilder())
    with stats_mod.scoped_store(None):
        static = PlanExecutor(mode="capped", device="cpu").execute(plan,
                                                                   inputs)
    assert static.caps["row_cap"] == 64 and not any(
        ":" in k for k in static.caps)
    with stats_mod.scoped_store(stats_mod.StatsStore(capacity=8, path="")):
        cold = PlanExecutor(mode="capped", device="cpu").execute(plan,
                                                                 inputs)
    tightened = {k: v for k, v in cold.caps.items() if ":" in k}
    assert tightened and all(v == 9 for k, v in tightened.items()
                             if k.startswith("row_cap")), cold.caps
    assert cold.attempts == 1
    assert cold.compact().to_pydict() == static.compact().to_pydict()


def test_cert_seed_off_restores_static_caps(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_SEED", "off")
    plan, inputs = _limited_join(PlanBuilder())
    with stats_mod.scoped_store(stats_mod.StatsStore(capacity=8, path="")):
        cold = PlanExecutor(mode="capped", device="cpu").execute(plan,
                                                                 inputs)
    assert not any(":" in k for k in cold.caps)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_CERT_SEED", "of")
    with stats_mod.scoped_store(stats_mod.StatsStore(capacity=8, path="")):
        with pytest.raises(ValueError):
            PlanExecutor(mode="capped", device="cpu").execute(plan, inputs)


def test_escalation_ceiling_clamps_at_certified_hi():
    b = PlanBuilder()
    plan = b.scan("l", schema=["k"]).join(
        b.scan("r", schema=["k2"]), "k", "k2").aggregate(
        ["k"], [("k2", "size", "n")]).build()
    inputs = {"l": _tbl(k=[1] * 9), "r": _tbl(k2=[1] * 7)}
    with stats_mod.scoped_store(None):
        static = PlanExecutor(mode="capped", device="cpu").execute(plan,
                                                                   inputs)
    with stats_mod.scoped_store(stats_mod.StatsStore(capacity=8, path="")):
        cold = PlanExecutor(mode="capped", device="cpu").execute(plan,
                                                                 inputs)
        warm = PlanExecutor(mode="capped", device="cpu").execute(plan,
                                                                 inputs)
    assert cold.attempts == static.attempts > 1
    assert max(v for k, v in cold.caps.items()
               if k.startswith("row_cap")) == 63
    assert max(v for k, v in static.caps.items()
               if k.startswith("row_cap")) == 72
    assert warm.attempts == 1
    assert all(v <= 63 for k, v in warm.caps.items()
               if k.startswith("row_cap"))
    assert (cold.compact().to_pydict() == warm.compact().to_pydict()
            == static.compact().to_pydict())


def test_cert_caps_equal_the_reference():
    """The same cold and warm attempts and caps as the JAX package's
    capped tier under a fresh store, on the two seeding plans."""
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.columnar import Table as JTable
    from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
    from spark_rapids_tpu.plan import stats as jstats
    for make in (_limited_join, ):
        tplan, inputs = make(PlanBuilder())
        jplan, _ = make(JPlanBuilder())
        jin = {n: JTable([JColumn.from_numpy(c.data.numpy())
                          for c in t.columns], names=list(t.names))
               for n, t in inputs.items()}
        with jstats.scoped_store(jstats.StatsStore(capacity=8, path="")):
            jr = [JPlanExecutor(mode="capped").execute(jplan, dict(jin))
                  for _ in range(2)]
        with stats_mod.scoped_store(stats_mod.StatsStore(capacity=8,
                                                         path="")):
            tr = [PlanExecutor(mode="capped", device="cpu").execute(
                tplan, inputs) for _ in range(2)]
        for j, t in zip(jr, tr):
            assert t.attempts == j.attempts and t.caps == j.caps
            assert t.compact().to_pydict() == j.compact().to_pydict()


def test_autoretry_ceiling_escape_hatch():
    import torch
    calls = []

    def attempt(row_cap):
        calls.append(row_cap)
        return ("t", torch.tensor(row_cap < 40))

    out, caps = auto_retry_overflow(attempt, {"row_cap": 4},
                                    max_attempts=8, ceil={"row_cap": 10})
    assert caps["row_cap"] >= 40 and out[0] == "t"
    assert 10 in calls


# ---- soundness and monotonicity ---------------------------------------------

def test_soundness_eager_and_capped_on_join_agg_plan():
    plan, inputs = _join_plan_and_inputs()
    for mode in ("eager", "capped"):
        _sound(PlanExecutor(mode=mode, device="cpu").execute(plan, inputs),
               inputs)


def test_monotonicity_root_bound_never_loosens():
    plan = PlanBuilder().scan("t", schema=["k", "v", "dead"]).filter(
        col("v") > lit(1)).project(
        {"k": col("k"), "v": col("v")}).sort(["k"]).limit(5).build()
    inputs = {"t": _tbl(k=[3, 1, 2], v=[5, 0, 7], dead=[1, 1, 1])}
    kw = _cert_kw(inputs)
    opt, _ = optimize(plan, kw["bound"], kw["bound_rows"])
    a = certify(plan, **kw).root
    o = certify(opt, **kw).root
    assert o.rows_hi <= a.rows_hi
    assert o.out_bytes_hi <= a.out_bytes_hi
    jplan = JPlanBuilder().scan("t", schema=["k", "v", "dead"]).filter(
        jcol("v") > jlit(1)).project(
        {"k": jcol("k"), "v": jcol("v")}).sort(["k"]).limit(5).build()
    jopt, _ = joptimize(jplan, kw["bound"], kw["bound_rows"])
    _assert_same_cert(opt, jopt, kw)
