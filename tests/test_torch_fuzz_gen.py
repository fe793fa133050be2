"""The port's plan fuzzer (spark_rapids_tpu_torch/analysis/fuzz.py) against
the JAX package's: `gen_case(s)` gives the same plan (fingerprint), kinds
and table bytes for every corpus seed; the port's `run_case` passes
properties 1-5 on every seed (4: cold and warm runs under a fresh stats
store agree bit for bit; 5: the certifier is monotone and sound on both
tiers) and reports 6 as not checked, naming its ROADMAP item; a broken
property is reported, not raised; the reference's `TestFuzzer` cases
(tests/test_plan_verifier.py) against the port; `edge_tables` is
deterministic.

It also holds the cross-package runner that the corpus files share
(tests/test_torch_fuzz_plain_{a,b,c,d}.py, tests/test_torch_fuzz_edge_
{a,b}.py): one case through both packages' `PlanExecutor`s on the CPU,
`compact()` compared bit for bit (names, dtypes, data bytes, NaN bits and
the sign of zero, validity), errors by class name.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.analysis import fuzz as jfuzz
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import stats

from spark_rapids_tpu_torch.analysis import fuzz as tfuzz
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

PLAIN_SEEDS = range(48)       # the plain pass: tests/test_torch_fuzz_plain_*
EDGE_SEEDS = range(24)        # the edge pass: tests/test_torch_fuzz_edge_*
C8_SEED = 249                 # queue C 8: a capped join over a TopK of 0


@pytest.fixture(autouse=True)
def _gate_on(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "1")


# ---- the cross-package runner -----------------------------------------------

@functools.lru_cache(maxsize=None)
def _cases(seed: int, edge: bool):
    """(JAX case, JAX tables, port case, port tables) of one seed; the
    edge pass redraws the port's tables and hands the JAX package the
    same bytes."""
    jc = jfuzz.gen_case(seed)
    tc = tfuzz.gen_case(seed, device="cpu")
    if not edge:
        return jc, jc.tables, tc, tc.tables
    ttab = tfuzz.edge_tables(tc, device="cpu")
    jtab = {}
    for name, t in ttab.items():
        cols = []
        for c in t.columns:
            data, valid = c.to_numpy()
            cols.append(JColumn.from_numpy(data, validity=valid))
        jtab[name] = JTable(cols, names=list(t.names))
    return jc, jtab, tc, ttab


def _columns(names, cols, to_numpy):
    out = []
    for name, c in zip(names, cols):
        data, valid = to_numpy(c)
        out.append((name, c.dtype.kind.value, data.dtype.str,
                    data.tobytes(),
                    None if valid is None or valid.all()
                    else valid.tobytes()))
    return tuple(out)


def jax_outcome(seed, edge, mode, optimize):
    jc, jtab, _, _ = _cases(seed, edge)
    try:
        with stats.scoped_store(None):
            res = JPlanExecutor(mode=mode, optimize=optimize).execute(
                jc.plan, dict(jtab))
        t = res.compact()
    except Exception as e:        # parity includes error parity
        return "err", type(e).__name__
    return "ok", _columns(t.names, t.columns, lambda c: (
        np.asarray(c.data),
        None if c.validity is None else np.asarray(c.validity)))


def port_outcome(seed, edge, mode, optimize):
    _, _, tc, ttab = _cases(seed, edge)
    status, t = tfuzz.execute_case(tc, ttab, mode=mode, optimize=optimize,
                                   device="cpu")
    if status == "err":
        return status, t
    return status, _columns(t.names, t.columns, lambda c: c.to_numpy())


def check_parity(seed, edge, mode, optimize):
    """The port's run equals the JAX package's. In the capped tier the
    yardstick is the JAX capped run, unless that differs from the JAX
    eager run (XLA rewrites float literal arithmetic under jit, queue C):
    then the port's capped run must equal the JAX eager one."""
    got = port_outcome(seed, edge, mode, optimize)
    want = jax_outcome(seed, edge, mode, optimize)
    if mode == "capped" and got != want:
        eager = jax_outcome(seed, edge, "eager", optimize)
        assert eager != want        # the recorded deviation, and only it
        want = eager
    assert got[0] == want[0], (got, want)
    assert got == want
    return got


# ---- generator parity -------------------------------------------------------

@pytest.mark.parametrize("seed", PLAIN_SEEDS)
def test_gen_case_matches_jax(seed):
    jc, _, tc, _ = _cases(seed, False)
    assert tc.plan.fingerprint == jc.plan.fingerprint
    assert tc.kinds == jc.kinds
    assert set(tc.tables) == set(jc.tables)
    for name, jt in jc.tables.items():
        tt = tc.tables[name]
        assert list(tt.names) == list(jt.names)
        for a, b in zip(jt.columns, tt.columns):
            assert a.dtype.kind.value == b.dtype.kind.value
            assert np.asarray(a.data).tobytes() == b.data.numpy().tobytes()
            assert a.validity is None and b.validity is None


# ---- properties 1-5 ---------------------------------------------------------

@pytest.mark.parametrize("seed", PLAIN_SEEDS)
def test_run_case_properties(seed):
    """Properties 1-5 hold on every corpus seed; 6 stays unchecked
    (None), never passed."""
    r = tfuzz.run_case(tfuzz.gen_case(seed, device="cpu"), device="cpu")
    assert r.ok and r.executed and r.parity, r.error
    assert r.verified and r.optimized_verified
    assert r.adaptive_parity is True and r.cert_sound is True
    for prop in tfuzz.NOT_CHECKED:
        assert getattr(r, prop) is None
    assert r.not_checked == tfuzz.NOT_CHECKED


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_run_case_properties_over_edge_tables(seed):
    """Properties 1-5 over the edge tables (edge values, nulls)."""
    case = tfuzz.gen_case(seed, device="cpu")
    case.tables = tfuzz.edge_tables(case, device="cpu")
    r = tfuzz.run_case(case, device="cpu")
    assert r.ok and r.executed, r.error
    assert r.adaptive_parity is True and r.cert_sound is True


def test_properties_not_checked_name_their_items():
    assert tfuzz.NOT_CHECKED == {
        "placement_parity":
            "property 6, queue A item 14 (the placement rule)"}
    # a failed property makes the result fail; an unchecked one does not
    for prop in ("parity", "adaptive_parity", "cert_sound"):
        assert not tfuzz.FuzzResult(seed=0, **{prop: False}).ok
    assert tfuzz.FuzzResult(seed=0, parity=True, adaptive_parity=True,
                            cert_sound=True).ok


def test_run_case_reports_a_broken_adaptive_or_cert_property(monkeypatch):
    """A warm run that changes the answer breaks property 4, and a
    certificate tighter than what runs breaks property 5, without
    raising."""
    from spark_rapids_tpu_torch.analysis import footprint
    from spark_rapids_tpu_torch.plan import executor as texecutor
    real = texecutor.PlanExecutor.execute

    def warm_skewed(self, plan, inputs=None):
        res = real(self, plan, inputs)
        store = torch_stats.active_store()
        if store is not None and store.generation > 1:
            res.table = res.table.select(list(res.table.names)[:1])
        return res
    case = tfuzz.gen_case(7, device="cpu")
    monkeypatch.setattr(texecutor.PlanExecutor, "execute", warm_skewed)
    r = tfuzz.run_case(case, device="cpu")
    assert not r.ok and r.adaptive_parity is False
    assert "adaptive parity broke" in r.error
    monkeypatch.setattr(texecutor.PlanExecutor, "execute", real)
    real_interval = footprint._rows_interval

    def too_tight(node, kids, bound_rows, nullable_keys):
        lo, hi = real_interval(node, kids, bound_rows, nullable_keys)
        return lo, (None if hi is None else 0)
    monkeypatch.setattr(footprint, "_rows_interval", too_tight)
    r = tfuzz.run_case(case, device="cpu")
    assert not r.ok and r.cert_sound is False
    assert "cert soundness broke" in r.error


def test_run_case_reports_a_broken_property(monkeypatch):
    """An optimizer that changes the answer breaks property 3 without
    raising: the result carries it."""
    from spark_rapids_tpu_torch.plan import executor as texecutor
    real = texecutor.PlanExecutor.execute

    def skewed(self, plan, inputs=None):
        res = real(self, plan, inputs)
        if self.optimize:
            res.table = res.table.select(list(res.table.names)[:1])
        return res
    monkeypatch.setattr(texecutor.PlanExecutor, "execute", skewed)
    case = tfuzz.gen_case(7, device="cpu")
    r = tfuzz.run_case(case, device="cpu")
    assert not r.ok and r.parity is False
    assert "eager parity broke" in r.error


@pytest.mark.parametrize("edge", [False, True], ids=["plain", "edge"])
def test_corpus_with_every_kernel_forced_runs_their_cpu_mirrors(
        monkeypatch, edge):
    """With every kernel forced, the CPU runs the kernels' plain mirrors
    (their tiling, insertion and emission order); over the corpus, both
    tiers and forms, they give the plain fallback's results. The plain
    pass adds seed 249, queue C 8's case (a capped inner join over a
    TopK of 0 rows)."""
    from spark_rapids_tpu_torch.ops import join_cuda, select, topk
    from spark_rapids_tpu_torch.ops import groupby_cuda
    for m in (join_cuda, groupby_cuda):
        m.reset_counters()
    for d in (select.PLAIN_CALLS, topk.PLAIN_CALLS):
        for k in d:
            d[k] = 0
    for seed in (EDGE_SEEDS if edge else [*PLAIN_SEEDS, C8_SEED]):
        _, _, tc, ttab = _cases(seed, edge)
        for mode in ("eager", "capped"):
            for optimize in (False, True):
                monkeypatch.delenv("SPARK_RAPIDS_TORCH_KERNELS",
                                   raising=False)
                want = tfuzz._outcome(tfuzz.execute_case(
                    tc, ttab, mode=mode, optimize=optimize, device="cpu"))
                monkeypatch.setenv(
                    "SPARK_RAPIDS_TORCH_KERNELS",
                    "hash_join=cuda,topk=cuda,fused_select=cuda,"
                    "groupby=cuda")
                got = tfuzz._outcome(tfuzz.execute_case(
                    tc, ttab, mode=mode, optimize=optimize, device="cpu"))
                assert got == want, (seed, mode, optimize)
    # the mirrors ran: the join's build, the groupby's, FusedSelect's, TopK's
    assert join_cuda.PLAIN_CALLS["build"] > 0
    assert groupby_cuda.PLAIN_CALLS["groupby"] > 0
    assert select.PLAIN_CALLS["fused_select"] > 0
    assert topk.PLAIN_CALLS["topk"] > 0


# ---- the reference's TestFuzzer, against the port --------------------------

class TestFuzzer:
    def test_same_seed_same_plan_and_data(self):
        c1, c2 = (tfuzz.gen_case(42, device="cpu"),
                  tfuzz.gen_case(42, device="cpu"))
        assert c1.plan.fingerprint == c2.plan.fingerprint
        assert set(c1.tables) == set(c2.tables)
        for name in c1.tables:
            t1, t2 = c1.tables[name], c2.tables[name]
            assert list(t1.names) == list(t2.names)
            for a, b in zip(t1.columns, t2.columns):
                assert np.array_equal(a.data.numpy(), b.data.numpy())

    def test_distinct_seeds_distinct_plans(self):
        fps = {tfuzz.gen_case(s, device="cpu").plan.fingerprint
               for s in range(12)}
        assert len(fps) > 6

    def test_premerge_corpus_covers_all_kinds(self):
        kinds = set()
        for s in range(24):
            kinds.update(tfuzz.gen_case(s, device="cpu").kinds)
        assert kinds == set(tfuzz.ALL_KINDS) == set(jfuzz.ALL_KINDS)

    def test_small_corpus_verify_and_parity(self):
        summary = tfuzz.run_corpus(range(8), execute=True, device="cpu")
        assert summary["cases"] == summary["executed"] == 8
        assert not summary["failures"], summary["failures"]
        assert summary["not_checked"] == tfuzz.NOT_CHECKED

    def test_case_properties_individually(self):
        r = tfuzz.run_case(tfuzz.gen_case(7, device="cpu"), device="cpu")
        assert r.ok and r.executed and r.parity


def test_gen_case_runs_on_the_card_unless_told():
    import torch
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfuzz.gen_case(0)


def test_main_prints_the_summary(capsys):
    assert tfuzz.main(["--start", "3", "--count", "4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("plan fuzz: 4 case(s), 4 executed")
    summary = json.loads(next(x for x in out if x.startswith("{")))
    assert summary["fuzz_cases"] == 4 and summary["fuzz_failures"] == 0
    assert summary["device"] == "cpu"
    assert out[-1] == "plan fuzz OK"
    assert sum("not checked" in x for x in out) == len(tfuzz.NOT_CHECKED)
    assert any("placement_parity" in x for x in out)


# ---- the edge tables ---------------------------------------------------------

def test_edge_tables_are_deterministic_and_hold_the_edges():
    seen_f, seen_i, nulls = set(), set(), 0
    for seed in EDGE_SEEDS:
        case = tfuzz.gen_case(seed, device="cpu")
        a = tfuzz.edge_tables(case, device="cpu")
        b = tfuzz.edge_tables(case, device="cpu")
        for name in a:
            assert a[name].names == case.tables[name].names
            for x, y in zip(a[name].columns, b[name].columns):
                assert x.data.numpy().tobytes() == y.data.numpy().tobytes()
                assert np.array_equal(x.validity.numpy(),
                                      y.validity.numpy())
                nulls += int((~x.validity).sum())
                if x.dtype.is_floating:
                    seen_f.update(np.asarray(x.data.numpy()).view(
                        np.int64).tolist())
                elif x.dtype.is_integer:
                    seen_i.update(x.data.tolist())
    edges = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 2.0 ** 53 + 2])
    assert set(edges.view(np.int64).tolist()) <= seen_f
    assert {-(2 ** 63), 2 ** 63 - 1, 2 ** 53 + 1, 2 ** 31, -(2 ** 31),
            -1} <= seen_i
    assert nulls > 0
