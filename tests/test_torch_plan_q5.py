"""NDS q5 through the port's plan engine against the JAX package's
`PlanExecutor` on the same tables (N = 15,000 store sales rows, the
reference's own test size): authored and optimized, eager and capped (at
the reference bench's key_cap of 2,048), each table bit for bit (names,
dtypes, validity and row order) and each operator's rows equal; the
optimizer's fingerprints, rules fired, pruned columns and plan text; cap
escalation from 16 keys; the bare-literal columns q5 projects; the port's
datagen and DAG against the reference bench's. The reference's capped runs
have their stats store off. Tolerance: exact; every column is INT64."""
import re

import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import stats

from benchmarks import bench_nds_q5, nds_plans

from spark_rapids_tpu_torch import nds_q5
from spark_rapids_tpu_torch.ops import join_cuda, select_cuda, topk_cuda
from spark_rapids_tpu_torch.plan import PlanExecutor, col, lit

_N = 15_000
_CAPS = {"key_cap": 2048}            # bench_nds_q5.py's plan-tier caps
_TINY = {"key_cap": 16}


@pytest.fixture(scope="module")
def ref():
    """The JAX executor's runs, each computed once: (tier, optimize) ->
    PlanResult, and the escalation run under "tiny"."""
    tabs, dates = bench_nds_q5.build_tables(_N, seed=0)
    inputs = nds_plans.q5_inputs(tabs, dates)
    out = {}
    with stats.scoped_store(None):
        for optimize in (False, True):
            out["eager", optimize] = JPlanExecutor(
                mode="eager", optimize=optimize).execute(
                nds_plans.q5_plan(), inputs)
            out["capped", optimize] = JPlanExecutor(
                mode="capped", optimize=optimize, caps=dict(_CAPS)).execute(
                nds_plans.q5_plan(), inputs)
        out["tiny"] = JPlanExecutor(
            mode="capped", optimize=False, caps=dict(_TINY),
            max_cap_attempts=14).execute(nds_plans.q5_plan(), inputs)
    return out


@pytest.fixture(scope="module")
def inputs():
    return nds_q5.q5_inputs(_N, seed=0, device="cpu")


def _assert_same(jt, tt):
    """Names, dtype kinds, validity and data, row order included."""
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert tc.dtype.kind.value == jc.dtype.kind.value
        data, valid = tc.to_numpy()
        want = np.asarray(jc.data)
        assert data.dtype == want.dtype
        npt.assert_array_equal(data, want)
        if jc.validity is None:
            assert valid is None
        else:
            npt.assert_array_equal(valid, np.asarray(jc.validity))


def _rows(res):
    return [(m.kind, m.rows_in, m.rows_out) for m in res.metrics.values()]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("tier", ["eager", "capped"])
def test_q5_matches_jax(ref, inputs, tier, optimize):
    want = ref[tier, optimize]
    caps = dict(_CAPS) if tier == "capped" else None
    for m in (join_cuda, select_cuda, topk_cuda):
        m.reset_counters()
    res = PlanExecutor(mode=tier, device="cpu", optimize=optimize,
                       caps=caps).execute(nds_q5.q5_plan(), inputs)
    got = res.compact()
    _assert_same(want.compact(), got)
    assert got.names == ("channel", "sk", "sales", "returns", "profit",
                         "loss")[:1] + ("sales", "returns", "profit",
                                        "loss")
    assert got.num_rows == 4                   # three channels and -1
    assert _rows(res) == _rows(want)
    assert sum(m.kind == "Union" for m in res.metrics.values()) == 5
    if tier == "capped":
        assert (res.attempts, res.caps) == (want.attempts, want.caps)
    # semi joins are torch ops; the keyed aggregates take the registry's
    # groupby, its plain version on the CPU
    stamps = {m.kernel for m in res.metrics.values() if m.kernel}
    assert stamps == {"torch:hash_join", "torch:groupby"}
    assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0}
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0, "emit": 0}
    assert sum(select_cuda.PLAIN_CALLS.values()) == 0
    assert sum(topk_cuda.PLAIN_CALLS.values()) == 0


def _strip(text):
    return re.sub(r"#\d+", "", text)


def test_q5_optimizer_matches_jax(ref, inputs):
    res = PlanExecutor(device="cpu").execute(nds_q5.q5_plan(), inputs)
    want = ref["eager", True]
    for key in ("rules_fired", "pruned_columns", "fingerprint",
                "source_fingerprint", "fell_back"):
        assert res.optimizer[key] == want.optimizer[key], key
    assert res.optimizer["rules_fired"] == {"column_pruning": 6}
    assert res.optimizer["pruned_columns"] == 6
    assert _strip(res.plan.explain()) == _strip(want.plan.explain())
    assert res.plan.fingerprint == want.plan.fingerprint
    assert nds_q5.q5_plan().fingerprint == nds_plans.q5_plan().fingerprint
    # the reference's text ends with its kernel registry's line
    theirs = [line for line in _strip(JPlanExecutor(mode="eager").explain(
        nds_plans.q5_plan(), optimized=True)).splitlines()
        if not line.startswith("kernels [")]
    ours = _strip(PlanExecutor(device="cpu").explain(
        nds_q5.q5_plan(), optimized=True)).splitlines()
    assert ours == theirs


def test_q5_escalation_matches_jax(ref, inputs):
    """From 16 keys: the attempts, final caps and per-operator escalations
    of the reference; a second run starts from the memo's caps."""
    want = ref["tiny"]
    ex = PlanExecutor(mode="capped", device="cpu", optimize=False,
                      caps=dict(_TINY), max_cap_attempts=14)
    res = ex.execute(nds_q5.q5_plan(), inputs)
    _assert_same(want.compact(), res.compact())
    assert res.attempts == want.attempts > 1
    assert res.caps == want.caps
    assert [m.escalations for m in res.metrics.values()] == \
        [m.escalations for m in want.metrics.values()]
    again = ex.execute(nds_q5.q5_plan(), inputs)
    assert (again.attempts, again.caps, again.jit_cache_hits) == \
        (1, res.caps, 1)


@pytest.mark.parametrize("tier", ["eager", "capped"])
def test_bare_literal_columns_are_int64_without_validity(inputs, tier):
    """q5's `lit(0)`/`lit(ci)`/`lit(-1)` projections: INT64, no validity,
    the frame's length, so the Union's concatenation takes them."""
    from spark_rapids_tpu_torch.plan import PlanBuilder
    b = PlanBuilder()
    s = b.scan("store_sales", schema=["sk", "date_sk", "sales_price",
                                      "profit"])
    r = b.scan("store_returns", schema=["sk", "date_sk", "return_amt",
                                        "net_loss"])
    plan = (s.project([("sk", col("sk")), ("returns", lit(0)),
                       ("tag", lit(-1))])
            .union(r.project([("sk", col("sk")), ("returns",
                                                   col("return_amt")),
                              ("tag", lit(2))]))
            .build())
    res = PlanExecutor(mode=tier, device="cpu").execute(plan, inputs)
    t = res.table
    n_s = inputs["store_sales"].num_rows
    n_r = inputs["store_returns"].num_rows
    assert t.num_rows == n_s + n_r
    for name in ("returns", "tag"):
        assert t[name].dtype.kind.value == "int64"
        assert t[name].validity is None
    tag = t["tag"].data.numpy()
    npt.assert_array_equal(tag[:n_s], -1)
    npt.assert_array_equal(tag[n_s:], 2)
    npt.assert_array_equal(t["returns"].data.numpy()[:n_s], 0)
    if tier == "capped":
        assert bool(res.valid.all())


def test_datagen_matches_reference():
    for seed in (0, 5):
        chans, dates = nds_q5.datagen(3000, seed=seed)
        rchans, rdates = bench_nds_q5._datagen(3000, seed=seed)
        npt.assert_array_equal(dates, rdates)
        assert list(chans) == list(rchans)
        for name in chans:
            assert list(chans[name]) == list(rchans[name])
            for k in chans[name]:
                npt.assert_array_equal(chans[name][k], rchans[name][k])
                assert chans[name][k].dtype == rchans[name][k].dtype
    assert (nds_q5.DATE_LO, nds_q5.DATE_HI) == (bench_nds_q5.DATE_LO,
                                                bench_nds_q5.DATE_HI)


def test_inputs_bind_as_the_reference_binds(inputs):
    tabs, dates = bench_nds_q5.build_tables(_N, seed=0)
    theirs = nds_plans.q5_inputs(tabs, dates)
    assert list(inputs) == list(theirs)
    for name, t in inputs.items():
        assert list(t.names) == list(theirs[name].names)
        for a, b in zip(t.columns, theirs[name].columns):
            assert a.dtype.kind.value == b.dtype.kind.value == "int64"
            npt.assert_array_equal(a.data.numpy(), np.asarray(b.data))


def _shape(plan):
    return [(n.kind, n.describe(), plan.schemas.get(id(n)),
             [plan.nodes.index(c) for c in n.children]) for n in plan.nodes]


def test_q5_plan_has_the_reference_dag():
    assert _shape(nds_q5.q5_plan()) == _shape(nds_plans.q5_plan())
