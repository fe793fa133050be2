"""The port's stats store (spark_rapids_tpu_torch/plan/stats.py) and its
three consumers, case by case after the reference's tests/test_adaptive.py
(its degraded-tier case waits for the port's CPU tier, ROADMAP queue A item
10): the store's round trip and bounds, the observed-cardinality
build-side flip through `verify_rewrite`, cap seeding across executors,
the kernel registry's tie-break with registered test kernels on the CPU
backend (on "cuda" nothing is demoted), JSONL persistence, stale stats,
backend isolation, and the decision sources in the profile and explain.

Against the JAX package on the same seeded tables: two runs under a fresh
store make the same decision sources, attempts, caps and observed caps in
both packages, and the same results. Every case installs its own store
with `scoped_store`, so the file order does not matter. Tolerance: exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import json

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import stats as jstats

from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.ops.registry import KernelRegistry, Signature
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col
from spark_rapids_tpu_torch.plan import stats as stats_mod
from spark_rapids_tpu_torch.plan.optimizer import subtree_fingerprints
from spark_rapids_tpu_torch.plan.stats import StatsStore, scoped_store


@pytest.fixture(autouse=True, scope="module")
def _no_default_store():
    """Outside a case's own scope, no store (the knob's default is on)."""
    with scoped_store(None):
        yield


def _t(**cols):
    names = list(cols)
    return table_from_numpy(
        names, [np.asarray(v, dtype=np.int64) for v in cols.values()],
        [None] * len(names), ["int64"] * len(names), device="cpu")


def _jt(t):
    return JTable([JColumn.from_numpy(c.data.numpy()) for c in t.columns],
                  names=list(t.names))


def _skew_tables(n_big=1000, n_small=1000, seed=0):
    """The filtered side's static 0.5 selectivity is wrong (the filter
    keeps about 1%), so the static build-side rule keeps and the observed
    rows swap."""
    rng = np.random.default_rng(seed)
    return {"small": _t(sk=rng.integers(0, 100, n_small),
                        sv=rng.integers(0, 100, n_small)),
            "big": _t(k=rng.integers(0, 10, n_big),
                      v=rng.integers(0, 100, n_big))}


def _skew_plan(b=None, c=col):
    b = b or PlanBuilder()
    left = b.scan("small", schema=["sk", "sv"],
                  est_rows=1000).filter(c("sv") == 0)
    right = b.scan("big", schema=["k", "v"], est_rows=1000)
    return (left.join(right, left_on="sk", right_on="k")
                .aggregate(["sv"], [("v", "sum", "total")])
                .build())


def _fanout_tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"l": _t(k=rng.integers(0, 20, 400), v=rng.integers(0, 100, 400)),
            "r": _t(rk=rng.integers(0, 20, 100))}


def _fanout_plan(b=None):
    b = b or PlanBuilder()
    return (b.scan("l", schema=["k", "v"])
             .join(b.scan("r", schema=["rk"]), left_on="k", right_on="rk")
             .aggregate(["k"], [("v", "sum", "t")])
             .build())


# ---- store round trip and bounds --------------------------------------------

def test_store_round_trip_and_evict():
    store = StatsStore(capacity=2, path="")
    plans, last = [], None
    for n_cols in (2, 3, 4):        # three distinct fingerprints
        names = [f"c{i}" for i in range(n_cols)]
        plans.append(PlanBuilder().scan(f"s{n_cols}", schema=names)
                     .aggregate([names[0]], [(names[1], "sum", "t")])
                     .build())
    with scoped_store(store):
        for p, n_rows in zip(plans, (40, 60, 80)):
            names = list(p.scans[0].schema)
            t = _t(**{n: np.arange(n_rows) % 5 for n in names})
            last = PlanExecutor(device="cpu").execute(
                p, {p.scans[0].source: t})
    assert store.plan_runs("cpu", plans[0].fingerprint) == 0   # evicted
    assert store.plan_runs("cpu", plans[1].fingerprint) == 1
    assert store.plan_runs("cpu", plans[2].fingerprint) == 1
    sub = subtree_fingerprints(last.plan.root)
    assert store.observed_rows("cpu", sub[id(last.plan.root)]) == (5, 1)
    ops = store.op_stats("cpu", plans[2].fingerprint)
    root_idx = len(last.plan.nodes) - 1
    assert ops[root_idx]["rows_out"] == 5
    assert ops[root_idx]["wall_ms"] is not None


# ---- observed-cardinality build-side flip -----------------------------------

def test_observed_build_side_flip_with_verified_rewrite():
    inputs = _skew_tables()
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        cold = PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
        assert not cold.optimizer["rules_fired"].get("build_side")
        warm = PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
    assert warm.optimizer["rules_fired"].get("build_side") == 1
    swaps = [v for k, v in warm.optimizer["decision_sources"].items()
             if k.endswith("/build_side") and v.startswith("swap")]
    assert swaps and "observed:1" in swaps[0]
    assert warm.optimizer["stats_driven"] is True
    assert not warm.optimizer["fell_back"]
    assert not warm.optimizer["stats_reverted"]
    assert warm.compact().to_pydict() == cold.compact().to_pydict()


def test_stats_off_restores_static_decisions():
    plan = _skew_plan()
    inputs = _skew_tables()
    with scoped_store(None):
        static = PlanExecutor(device="cpu").execute(plan, inputs)
    with scoped_store(StatsStore(capacity=8, path="")):
        for _ in range(2):
            PlanExecutor(device="cpu").execute(plan, inputs)
    with scoped_store(None):
        off = PlanExecutor(device="cpu").execute(plan, inputs)
    assert off.optimizer == static.optimizer
    assert off.compact().to_pydict() == static.compact().to_pydict()


def test_stats_driven_rewrite_failing_verify_reverts(monkeypatch):
    """A stats-driven rewrite that fails `verify_rewrite` is not run: the
    static pipeline reruns and the report says so."""
    from spark_rapids_tpu_torch.analysis import verifier

    class _Bad:
        ok = False
    inputs = _skew_tables()
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        cold = PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
        monkeypatch.setattr(verifier, "verify_rewrite",
                            lambda *a, **k: _Bad())
        warm = PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
    assert warm.optimizer["stats_reverted"] is True
    assert not warm.optimizer["rules_fired"].get("build_side")
    assert "STATS REVERTED" in warm.profile_text()
    assert warm.compact().to_pydict() == cold.compact().to_pydict()


# ---- cap seeding ------------------------------------------------------------

def test_cap_seeding_skips_escalation_ladder():
    inputs = _fanout_tables()
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        cold = PlanExecutor(mode="capped", device="cpu").execute(
            _fanout_plan(), inputs)
        assert cold.attempts > 1
        warm_ex = PlanExecutor(mode="capped", device="cpu")
        warm = warm_ex.execute(_fanout_plan(), inputs)
        assert warm.attempts == 1
        assert warm.caps == cold.caps
        again = warm_ex.execute(_fanout_plan(), inputs)
        assert again.attempts == 1 and again.jit_cache_hits >= 1
    assert cold.compact().to_pydict() == warm.compact().to_pydict() \
        == again.compact().to_pydict()
    with scoped_store(None):
        static = PlanExecutor(mode="capped", device="cpu").execute(
            _fanout_plan(), inputs)
    assert static.attempts == cold.attempts


# ---- the same decisions as the reference ------------------------------------

def _jax_pair(plan_fn, inputs, mode):
    """Cold and warm runs of the JAX package under a fresh store: (cold,
    warm, observed caps)."""
    jin = {n: _jt(t) for n, t in inputs.items()}
    store = jstats.StatsStore(capacity=8, path="")
    with jstats.scoped_store(store):
        cold = JPlanExecutor(mode=mode).execute(plan_fn(), dict(jin))
        warm = JPlanExecutor(mode=mode).execute(plan_fn(), dict(jin))
    return cold, warm, store.observed_caps("cpu", plan_fn().fingerprint)


def _torch_pair(plan_fn, inputs, mode):
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        cold = PlanExecutor(mode=mode, device="cpu").execute(plan_fn(),
                                                             inputs)
        warm = PlanExecutor(mode=mode, device="cpu").execute(plan_fn(),
                                                             inputs)
    return cold, warm, store.observed_caps("cpu", plan_fn().fingerprint)


def _jax_skew_plan():
    return _skew_plan(JPlanBuilder(), jcol)


def _jax_fanout_plan():
    return _fanout_plan(JPlanBuilder())


def _sources(res):
    """Decision sources with the labels' serial numbers dropped."""
    return sorted((k.split("#")[0] + "/" + k.split("/", 1)[1], v)
                  for k, v in res.optimizer["decision_sources"].items())


@pytest.mark.parametrize("which,mode", [("skew", "eager"),
                                        ("skew", "capped"),
                                        ("fanout", "capped")])
def test_two_runs_make_the_reference_decisions(which, mode):
    tplan, jplan, make = {
        "skew": (_skew_plan, _jax_skew_plan, _skew_tables),
        "fanout": (_fanout_plan, _jax_fanout_plan, _fanout_tables)}[which]
    inputs = make()
    jc, jw, jcaps = _jax_pair(jplan, inputs, mode)
    tc, tw, tcaps = _torch_pair(tplan, inputs, mode)
    for j, t in ((jc, tc), (jw, tw)):
        assert _sources(t) == _sources(j)
        assert t.optimizer["stats_driven"] == j.optimizer["stats_driven"]
        assert t.optimizer["fingerprint"] == j.optimizer["fingerprint"]
        assert t.compact().to_pydict() == j.compact().to_pydict()
        if mode == "capped":
            assert t.attempts == j.attempts
            assert t.caps == j.caps
    assert tcaps == jcaps


# ---- kernel tie-break -------------------------------------------------------

def test_kernel_tie_break_demotion_and_stamp():
    reg = KernelRegistry()
    reg.register("fuzzop", "plain", fn=lambda: "plain", fallback=True)
    reg.register("fuzzop", "fancy", fn=lambda: "fancy", backends=("*",))
    sig = Signature.of(extras_tier="eager")
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        choice = reg.select("fuzzop", sig, backend="cpu")
        assert choice.name == "fancy" and not choice.stats_demoted
        store.record_kernel("cpu", "fuzzop", sig, "fancy", 5.0)
        store.record_kernel("cpu", "fuzzop", sig, "plain", 1.0)
        choice = reg.select("fuzzop", sig, backend="cpu")
        assert choice.name == "plain" and choice.stats_demoted
        assert any(name == "fancy" and "stats" in why
                   for name, why in choice.declined)
        other = Signature.of(extras_tier="capped")
        assert reg.select("fuzzop", other, backend="cpu").name == "fancy"
        assert not reg.select("fuzzop", None, backend="cpu").stats_demoted
    assert reg.select("fuzzop", sig, backend="cpu").name == "fancy"


def test_cuda_kernels_are_never_demoted():
    """On "cuda" the plain version is not a route: timings that would
    demote a kernel on the CPU leave the card's pick alone."""
    reg = KernelRegistry()
    reg.register("fuzzop3", "plain", fn=lambda: 0, fallback=True)
    reg.register("fuzzop3", "cuda", fn=lambda: 1, backends=("cuda",))
    reg.register("fuzzop3", "fancy", fn=lambda: 2, backends=("*",))
    sig = Signature.of()
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        for name in ("cuda", "fancy"):
            for backend in ("cuda", "cpu"):
                store.record_kernel(backend, "fuzzop3", sig, name, 9.0)
        for backend in ("cuda", "cpu"):
            store.record_kernel(backend, "fuzzop3", sig, "plain", 1.0)
        on_card = reg.select("fuzzop3", sig, backend="cuda")
        assert on_card.name == "cuda" and not on_card.stats_demoted
        on_cpu = reg.select("fuzzop3", sig, backend="cpu")
        assert on_cpu.name == "plain" and on_cpu.stats_demoted


def test_kernel_tie_break_hysteresis():
    reg = KernelRegistry()
    reg.register("fuzzop2", "plain", fn=lambda: 0, fallback=True)
    reg.register("fuzzop2", "fancy", fn=lambda: 1, backends=("*",))
    sig = Signature.of()
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        store.record_kernel("cpu", "fuzzop2", sig, "fancy", 1.1)
        store.record_kernel("cpu", "fuzzop2", sig, "plain", 1.0)
        assert reg.select("fuzzop2", sig, backend="cpu").name == "fancy"


def test_kernel_epoch_bumps_on_verdict_flip_without_reorder():
    store = StatsStore(capacity=8, path="")
    sig = Signature.of()
    store.record_kernel("cpu", "op", sig, "plain", 1.0)
    store.record_kernel("cpu", "op", sig, "fancy", 1.2)   # inside margin
    assert store.kernel_slower("cpu", "op", sig, "fancy", "plain") is None
    epoch = store.kernel_epoch
    store.record_kernel("cpu", "op", sig, "fancy", 2.0)   # EWMA 1.2 -> 1.6
    assert store.kernel_slower("cpu", "op", sig, "fancy", "plain") \
        is not None
    assert store.kernel_epoch > epoch


def test_kernel_epoch_keys_the_capped_program_cache():
    """A demotion verdict flip makes the next capped run another
    program (no cache hit), as the reference keys its compiled programs
    on the epoch."""
    inputs = _fanout_tables()
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        ex = PlanExecutor(mode="capped", device="cpu")
        ex.execute(_fanout_plan(), inputs)
        hit = ex.execute(_fanout_plan(), inputs)
        assert hit.jit_cache_hits == 1
        sig = Signature.of()
        store.record_kernel("cpu", "op", sig, "plain", 1.0)
        store.record_kernel("cpu", "op", sig, "fancy", 9.0)
        miss = ex.execute(_fanout_plan(), inputs)
        assert miss.jit_cache_hits == 0
    assert miss.compact().to_pydict() == hit.compact().to_pydict()


def test_fresh_store_ignores_env_persistence_path(tmp_path, monkeypatch):
    path = tmp_path / "operator.jsonl"
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_STATS_PATH", str(path))
    with scoped_store(StatsStore(capacity=8, path=str(path))):
        PlanExecutor(device="cpu").execute(_fanout_plan(), _fanout_tables())
    written = path.read_text()
    fresh = StatsStore(capacity=8, path="")
    assert fresh.path is None and fresh.generation == 0
    with scoped_store(fresh):
        PlanExecutor(device="cpu").execute(_fanout_plan(), _fanout_tables())
    assert path.read_text() == written
    assert StatsStore(capacity=8).path == str(path)


def test_eager_run_records_kernel_timings():
    plan = (PlanBuilder().scan("t", schema=["a", "b"])
            .filter(col("a") > 2).project([("a", col("a"))]).build())
    t = _t(a=np.arange(50) % 7, b=np.arange(50))
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        res = PlanExecutor(device="cpu").execute(plan, {"t": t})
    assert any(m.kernel.endswith(":fused_select")
               for m in res.metrics.values())
    assert any(key[1] == "fused_select" for key in store._kernels)


# ---- persistence ------------------------------------------------------------

def test_persistence_round_trip(tmp_path):
    path = str(tmp_path / "stats.jsonl")
    inputs = _fanout_tables()
    with scoped_store(StatsStore(capacity=8, path=path)):
        res = PlanExecutor(mode="capped", device="cpu").execute(
            _fanout_plan(), inputs)
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert lines and lines[0]["backend"] == "cpu"
    st2 = StatsStore(capacity=8, path=path)
    assert st2.observed_caps("cpu", _fanout_plan().fingerprint) == \
        dict(res.caps)
    # a CPU run never seeds the card
    assert st2.observed_caps("cuda", _fanout_plan().fingerprint) == {}
    with scoped_store(st2):
        warm = PlanExecutor(mode="capped", device="cpu").execute(
            _fanout_plan(), inputs)
    assert warm.attempts == 1
    assert warm.compact().to_pydict() == res.compact().to_pydict()


def test_persistence_knob_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TORCH_STATS_PATH", raising=False)
    st = StatsStore(capacity=8, path="")
    assert st.path is None
    with scoped_store(st):
        PlanExecutor(device="cpu").execute(_fanout_plan(), _fanout_tables())
    assert list(tmp_path.iterdir()) == []


def test_torn_lines_are_skipped(tmp_path):
    path = tmp_path / "torn.jsonl"
    with scoped_store(StatsStore(capacity=8, path=str(path))):
        PlanExecutor(mode="capped", device="cpu").execute(
            _fanout_plan(), _fanout_tables())
    good = path.read_text()
    path.write_text("{not json\n" + good + good[: len(good) // 2])
    st = StatsStore(capacity=8, path=str(path))
    assert st.generation == 1
    assert st.plan_runs("cpu", _fanout_plan().fingerprint) == 1


def test_default_store_reads_knobs(tmp_path, monkeypatch):
    path = str(tmp_path / "default.jsonl")
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_STATS", "on")
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_STATS_PATH", path)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_STATS_CAPACITY", "7")
    stats_mod.reset_default_store()
    stack = stats_mod._scope_stack()
    saved = list(stack)
    stack.clear()                   # this module's scoped None, lifted
    try:
        store = stats_mod.active_store()
        assert store is stats_mod.default_store()
        assert store.capacity == 7 and store.path == path
        PlanExecutor(device="cpu").execute(_fanout_plan(), _fanout_tables())
        assert open(path).read().strip()
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_STATS", "off")
        assert stats_mod.active_store() is None
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_STATS", "maybe")
        with pytest.raises(ValueError):
            stats_mod.active_store()
    finally:
        stack[:] = saved
        stats_mod.reset_default_store()


def test_rows_generation_moves_only_with_observed_rows():
    """`rows_generation` moves when a subtree is first seen, its rows grow
    or it is evicted, never on a rerun that observes the same rows, which
    still counts in `generation` and in the runs."""
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        res = PlanExecutor(device="cpu").execute(_fanout_plan(),
                                                 _fanout_tables())
        sub = subtree_fingerprints(res.plan.root)   # the executed plan's
        g1 = store.rows_generation
        assert g1 == len(set(sub.values()))
        PlanExecutor(device="cpu").execute(_fanout_plan(), _fanout_tables())
        assert store.rows_generation == g1 and store.generation == 2
        assert store.observed_rows("cpu", sub[id(res.plan.root)])[1] == 2
    small = StatsStore(capacity=1, path="")     # 16 subtree entries
    for i in range(16):
        small._observe_locked("cpu", f"s{i}", 1)
    g = small.rows_generation
    small._observe_locked("cpu", "s0", 1)        # the same rows
    assert small.rows_generation == g
    small._observe_locked("cpu", "s0", 2)        # grown
    assert small.rows_generation == g + 1
    small._observe_locked("cpu", "new", 1)       # first seen, one evicted
    assert small.rows_generation == g + 3


def test_rewrite_kept_while_observed_rows_hold():
    """An executor reruns the optimizer only when the observed rows
    change: the third run of a plan reuses the second's rewrite and
    certificate, and the results stay equal."""
    store = StatsStore(capacity=8, path="")
    plan, tables = _fanout_plan(), _fanout_tables()
    with scoped_store(store):
        ex = PlanExecutor(mode="capped", device="cpu")
        runs = [ex.execute(plan, tables) for _ in range(4)]
    assert len(ex._opt_cache) == 2
    assert runs[2].plan is runs[1].plan and runs[3].plan is runs[1].plan
    assert runs[2].cert is runs[1].cert
    for r in runs[1:]:
        assert np.array_equal(r.compact().columns[0].data.numpy(),
                              runs[0].compact().columns[0].data.numpy())


# ---- stale stats ------------------------------------------------------------

def test_schema_changed_fingerprint_never_matches():
    def make(colname):
        return (PlanBuilder().scan("s", schema=["a", colname])
                .filter(col("a") > 3)
                .aggregate(["a"], [(colname, "sum", "t")])
                .build())

    plan_a, plan_b = make("b"), make("c")
    assert plan_a.fingerprint != plan_b.fingerprint
    sub_a = subtree_fingerprints(plan_a.root)
    sub_b = subtree_fingerprints(plan_b.root)
    assert set(sub_a.values()).isdisjoint(sub_b.values())
    store = StatsStore(capacity=8, path="")
    with scoped_store(store):
        PlanExecutor(device="cpu").execute(
            plan_a, {"s": _t(a=np.arange(60) % 9, b=np.arange(60))})
        assert store.generation == 1
        for fp in sub_b.values():
            assert store.observed_rows("cpu", fp) is None
        res = PlanExecutor(device="cpu").execute(
            plan_b, {"s": _t(a=np.arange(60) % 9, c=np.arange(60))})
    assert "observed" not in "".join(
        res.optimizer["decision_sources"].values())


def test_est_rows_hint_change_still_matches():
    def make(est):
        return (PlanBuilder().scan("s", schema=["a", "b"], est_rows=est)
                .filter(col("a") > 3)
                .aggregate(["a"], [("b", "sum", "t")])
                .build())

    sub1 = subtree_fingerprints(make(10).root)
    sub2 = subtree_fingerprints(make(999_999).root)
    assert sorted(sub1.values()) == sorted(sub2.values())


def test_subtree_fingerprints_equal_the_reference():
    from spark_rapids_tpu.plan import subtree_fingerprints as jsub
    t = subtree_fingerprints(_skew_plan().root)
    j = jsub(_jax_skew_plan().root)
    assert sorted(t.values()) == sorted(j.values())


# ---- backend isolation ------------------------------------------------------

def test_store_is_backend_keyed():
    store = StatsStore(capacity=8, path="")
    sig = Signature.of()
    store.record_kernel("cpu", "topk", sig, "cuda", 9.0)
    store.record_kernel("cpu", "topk", sig, "torch", 1.0)
    assert store.kernel_slower("cuda", "topk", sig, "cuda", "torch") is None
    assert store.kernel_slower("cpu", "topk", sig, "cuda", "torch") \
        is not None


# ---- rendering --------------------------------------------------------------

def test_decision_sources_render_in_profile_and_report():
    inputs = _skew_tables()
    with scoped_store(StatsStore(capacity=8, path="")):
        PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
        warm = PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
    text = warm.profile_text()
    assert "decision" in text and "(observed:" in text
    from spark_rapids_tpu_torch.plan.optimizer import optimize
    with scoped_store(StatsStore(capacity=8, path="")) as st:
        PlanExecutor(device="cpu").execute(_skew_plan(), inputs)
        bound = {n: tuple(t.names) for n, t in inputs.items()}
        _, report = optimize(_skew_plan(), bound,
                             {n: t.num_rows for n, t in inputs.items()},
                             stats=st, backend="cpu")
    assert "decision sources" in report.summary()
    assert "(observed:" in report.summary()
