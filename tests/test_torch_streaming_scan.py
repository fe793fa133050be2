"""The port's streaming Parquet scan against the JAX package's.

Both packages read the same files (pyarrow writes them from the same
numpy arrays under `tmp_path`):

- NDS q5 and q72 at N = 1,500 in 4 row groups, every source with
  `chunk_rows` 300 (chunks break where the reference's break): the port's
  eager and capped streaming results, optimized, and q5's eager authored
  one, against the JAX package's eager streaming result (the NDS plans are
  integer-only, so the reference's tiers agree there); the Scans' row
  groups, pruned groups and skipped bytes equal the reference's;
- the JAX streaming tests' plans: a selective predicate that prunes, an
  OR that must not, an OR under an AND that lowers its safe conjunct, the
  builder's `scan(parquet=...)`, a keyless min/max over chunks that
  filter empty, a stream below a join; prefetch depth 0 against depth 2
  and a chunk bound; a transient fault retried, a fatal fault degraded
  and replayed on the CPU tier, and a stream under a budget that a
  whole-file read exceeds, each as in the JAX package.

Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import random

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu  # noqa: F401
import spark_rapids_tpu.faultinj as jfi
import spark_rapids_tpu.io as jio
import spark_rapids_tpu.plan as jplan
from spark_rapids_tpu.plan import stats as jstats
from spark_rapids_tpu.runtime import health as jhealth

from benchmarks import nds_plans

import spark_rapids_tpu_torch.faultinj as tfi
import spark_rapids_tpu_torch.io as tio
import spark_rapids_tpu_torch.plan as tplan
from spark_rapids_tpu_torch import nds_q5, nds_q72, table_from_numpy
from spark_rapids_tpu_torch.plan import stats as tstats
from spark_rapids_tpu_torch.runtime import health as thealth

from test_torch_parquet_reader import assert_tables_equal

_N = 1_500
_CHUNK = 300


@pytest.fixture(autouse=True, scope="module")
def _no_stats_stores():
    """No stats store on either side: adaptive chunk sizing would move
    the chunk boundaries."""
    with tstats.scoped_store(None), jstats.scoped_store(None):
        yield


@pytest.fixture(autouse=True)
def _clean():
    yield
    jfi.uninstall()
    tfi.uninstall()


def _write(tmp_path, tables, row_groups=4):
    """{name: {column: int64 array}} -> {name: path}, `row_groups` row
    groups each."""
    out = {}
    for name, cols in tables.items():
        n = len(next(iter(cols.values())))
        path = str(tmp_path / f"{name}.parquet")
        pq.write_table(pa.table({c: pa.array(a) for c, a in cols.items()}),
                       path, row_group_size=max(1, -(-n // row_groups)),
                       compression="NONE")
        out[name] = path
    return out


def _sources(paths, chunk_rows=_CHUNK):
    return ({n: jio.ParquetSource(p, chunk_rows=chunk_rows)
             for n, p in paths.items()},
            {n: tio.ParquetSource(p, chunk_rows=chunk_rows)
             for n, p in paths.items()})


def _result(res):
    return res.compact() if res.valid is not None else res.table


def _scan_io(res):
    return sorted((m.describe, m.io_row_groups_total, m.io_row_groups_pruned,
                   m.io_bytes_skipped)
                  for m in res.metrics.values() if m.kind == "Scan")


def _q5_tables():
    chans, date_sk = nds_q5.datagen(_N, seed=0)
    out = {"dates": {"d_date_sk": date_sk}}
    for name, c in chans.items():
        out[f"{name}_sales"] = dict(zip(
            ("sk", "date_sk", "sales_price", "profit"),
            (c["s_sk"], c["s_date"], c["s_price"], c["s_profit"])))
        out[f"{name}_returns"] = dict(zip(
            ("sk", "date_sk", "return_amt", "net_loss"),
            (c["r_sk"], c["r_date"], c["r_amt"], c["r_loss"])))
    return out


def _q72_tables():
    return {name: dict(d) for name, d in
            zip(nds_q72.TABLES, nds_q72.datagen(_N, seed=0))}


_QUERIES = {"q5": (_q5_tables, nds_plans.q5_plan, nds_q5.q5_plan),
            "q72": (_q72_tables, nds_plans.q72_plan, nds_q72.q72_plan)}


@pytest.mark.parametrize("query", sorted(_QUERIES))
def test_nds_streaming_equals_jax(tmp_path, query):
    tables, jmake, tmake = _QUERIES[query]
    js, ts = _sources(_write(tmp_path, tables()))
    want = jplan.PlanExecutor().execute(jmake(), js)
    runs = [("eager", True), ("capped", True)]
    if query == "q5":
        runs.append(("eager", False))
    for mode, optimize in runs:
        got = tplan.PlanExecutor(mode=mode, device="cpu",
                                 optimize=optimize).execute(tmake(), ts)
        assert_tables_equal(_result(want), _result(got))
        if optimize:
            assert _scan_io(got) == _scan_io(want), mode
    if query == "q5":
        # the dates window prunes three of the four row groups
        assert any(p == 3 for _, _, p, _ in _scan_io(want))


def _seq(n=4_000, seed=0):
    rng = np.random.default_rng(seed)
    return {"seq": np.arange(n, dtype=np.int64),
            "key": rng.integers(0, 40, n).astype(np.int64),
            "val": rng.integers(0, 10_000, n).astype(np.int64)}


def _plan_over(m, predicate, aggs=None, keys=("key",), **scan_kw):
    rel = (m.PlanBuilder().scan("t", **scan_kw).filter(predicate)
           .aggregate(list(keys), aggs or [("val", "sum", "s"),
                                           ("val", "count", "c")]))
    return (rel.sort(list(keys)) if keys else rel).build()


_PREDICATES = {
    "selective": lambda m: (m.col("seq") < 1000) & (m.col("key") >= 5),
    "or_declines": lambda m: (m.col("seq") < 100) | (m.col("key") == 7),
    "or_under_and": lambda m: (m.col("seq") < 1000) & (
        (m.col("key") == 1) | (m.col("key") == 2)),
    # rows only in the middle row groups: the last chunks filter to zero
    # rows (`seq - 1000 < 2000` proves nothing), the first is pruned
    "keyless_empty_chunks": lambda m: (m.col("seq") - 1000 < 2000) &
    (m.col("seq") >= 1000),
}


@pytest.mark.parametrize("case", sorted(_PREDICATES))
def test_pruning_equals_jax(tmp_path, case):
    # each chunk the JAX package aggregates compiles its groupby anew (the
    # filtered rows differ), so the cases keep to few kept chunks
    groups = 8 if case in ("selective", "or_under_and") else 4
    paths = _write(tmp_path, {"t": _seq()}, row_groups=groups)
    keyless = case == "keyless_empty_chunks"
    kw = dict(aggs=[("val", "min", "lo"), ("val", "max", "hi"),
                    ("val", "sum", "s")], keys=()) if keyless else {}
    res = {}
    for name, m, io in (("jax", jplan, jio), ("torch", tplan, tio)):
        plan = _plan_over(m, _PREDICATES[case](m),
                          schema=["seq", "key", "val"], **kw)
        ex = (m.PlanExecutor() if name == "jax"
              else m.PlanExecutor(device="cpu"))
        res[name] = ex.execute(plan, {"t": io.ParquetSource(paths["t"])})
    assert_tables_equal(_result(res["jax"]), _result(res["torch"]))
    assert _scan_io(res["torch"]) == _scan_io(res["jax"])
    fired = res["torch"].optimizer["rules_fired"].get("scan_pruning", 0)
    assert fired == res["jax"].optimizer["rules_fired"].get(
        "scan_pruning", 0)
    pruned = _scan_io(res["torch"])[0][2]
    assert (pruned > 0) == (case != "or_declines")
    scan = next(n for n in res["torch"].plan.nodes if n.kind == "Scan")
    if case == "or_under_and":
        assert "seq" in repr(scan.predicate)
        assert "key" not in repr(scan.predicate)
    if case == "or_declines":
        assert scan.predicate is None and not fired


def test_builder_binding_and_join_boundary_equal_jax(tmp_path):
    paths = _write(tmp_path, {"t": _seq(), "dim": {
        "dkey": np.arange(40, dtype=np.int64),
        "grp": np.random.default_rng(9).integers(0, 5, 40)}}, row_groups=8)
    out = {}
    for name, m in (("jax", jplan), ("torch", tplan)):
        b = m.PlanBuilder()
        fact = b.scan("t", parquet=paths["t"])
        assert fact.node.schema == ("seq", "key", "val")
        assert fact.node.est_rows == 4_000
        with pytest.raises(m.PlanValidationError):
            b.scan("t", schema=["wrong", "names", "here"],
                   parquet=paths["t"])
        d = b.scan("dim", parquet=paths["dim"])
        plan = (fact.filter(m.col("seq") < 2000)
                .join(d, left_on="key", right_on="dkey")
                .aggregate(["grp"], [("val", "sum", "s")])
                .sort(["grp"]).build())
        ex = (m.PlanExecutor() if name == "jax"
              else m.PlanExecutor(device="cpu"))
        out[name] = ex.execute(plan)            # no inputs= needed
    assert_tables_equal(out["jax"].table, out["torch"].table)
    assert _scan_io(out["torch"]) == _scan_io(out["jax"])
    assert any(p > 0 for _, _, p, _ in _scan_io(out["torch"]))


def _selective(m):
    """The selective case's plan (its file: `_seq()` in 8 row groups), so
    that the JAX package's runs below reuse its compiled shapes."""
    return _plan_over(m, _PREDICATES["selective"](m),
                      schema=["seq", "key", "val"])


def test_prefetch_depths_and_chunk_bound_agree(tmp_path, monkeypatch):
    paths = _write(tmp_path, {"t": _seq()}, row_groups=8)
    runs = {}
    for name, depth, rows in (("depth0", "0", "0"), ("depth2", "2", "0"),
                              ("chunked", "2", "200")):
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_IO_PREFETCH", depth)
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_IO_CHUNK_ROWS", rows)
        runs[name] = tplan.PlanExecutor(device="cpu").execute(
            _selective(tplan), {"t": tio.ParquetSource(paths["t"])})
    want = jplan.PlanExecutor().execute(
        _selective(jplan), {"t": jio.ParquetSource(paths["t"])})
    a = _seq()
    kept = int(((a["seq"] < 1000) & (a["key"] >= 5)).sum())
    for name, res in runs.items():
        assert_tables_equal(want.table, res.table)
        scan = next(m for m in res.metrics.values() if m.kind == "Scan")
        # two row groups of 500 rows are left after pruning
        assert scan.io_decode_ms > 0.0 and scan.rows_out == 1_000
        assert scan.io_h2d_ms == 0.0          # no copy on the CPU
        if name == "depth0":
            assert scan.io_overlap_ms == 0.0
        agg = next(m for m in res.metrics.values()
                   if m.kind == "HashAggregate")
        assert agg.rows_in == kept


def _monitor(h):
    probe = None if h is jhealth else (lambda: thealth.device_probe("cpu"))
    return h.DeviceHealthMonitor(backoff_base_ms=1, sleep=lambda s: None,
                                 rng=random.Random(3), probe=probe)


@pytest.mark.parametrize("fault", ["transient", "fatal"])
def test_faults_mid_stream_equal_jax(tmp_path, fault):
    paths = _write(tmp_path, {"t": _seq()}, row_groups=8)
    cfg = tmp_path / "faultinj.json"
    cfg.write_text(json.dumps({"seed": 1, "computeFaults": {
        "plan.FusedSelect": {"percent": 100,
                             "injectionType": 0 if fault == "fatal" else 1,
                             "interceptionCount": 1}}}))
    out = {}
    for name, m, io, fi, h in (("jax", jplan, jio, jfi, jhealth),
                               ("torch", tplan, tio, tfi, thealth)):
        inj = fi.install(str(cfg))
        hm = _monitor(h)
        ex = (m.PlanExecutor(health=hm) if name == "jax"
              else m.PlanExecutor(device="cpu", health=hm))
        res = ex.execute(_selective(m), {"t": io.ParquetSource(paths["t"])})
        assert any(n.kind == "FusedSelect" for n in res.plan.nodes)
        out[name] = (res, inj.get_and_reset_injected(),
                     [(mm.kind, mm.retries, mm.degraded)
                      for mm in res.metrics.values()])
        fi.uninstall()
    (jres, jinj, jops), (tres, tinj, tops) = out["jax"], out["torch"]
    assert tinj == jinj >= 1
    assert (tres.degraded, tres.retries) == (jres.degraded, jres.retries)
    assert tops == jops
    assert tres.degraded == (fault == "fatal")
    if fault == "fatal":
        assert all(mm.degraded for mm in tres.metrics.values())
    else:
        assert tres.retries >= 1
    assert_tables_equal(jres.table, tres.table)


def test_stream_under_a_budget_a_whole_read_exceeds(tmp_path):
    """The JAX package's out-of-core case: `read_parquet` admits three
    times the file's size and is refused under a budget of 1.5 times it,
    while the streamed plan admits one chunk's working set at a time and
    completes, equal to the reference's run."""
    from spark_rapids_tpu_torch.runtime import DeviceSession, HardOOM
    from spark_rapids_tpu_torch.runtime.admission import active_session
    import spark_rapids_tpu.runtime as jrt
    from spark_rapids_tpu.runtime.admission import \
        active_session as jactive
    paths = _write(tmp_path, {"t": _seq()}, row_groups=8)
    limit = int(1.5 * os.path.getsize(paths["t"]))
    res = {}
    for name, rt, act, m, io in (
            ("jax", jrt, jactive, jplan, jio),
            ("torch", None, active_session, tplan, tio)):
        Session = rt.DeviceSession if rt else DeviceSession
        Hard = rt.HardOOM if rt else HardOOM
        with Session(limit) as session:
            with act(session):
                with pytest.raises(Hard):
                    if rt:
                        io.read_parquet(paths["t"])
                    else:
                        io.read_parquet(paths["t"], device="cpu")
            ex = (m.PlanExecutor(session=session, degrade="off")
                  if rt else m.PlanExecutor(device="cpu", session=session,
                                            degrade="off"))
            res[name] = ex.execute(_selective(m),
                                   {"t": io.ParquetSource(paths["t"])})
    assert_tables_equal(res["jax"].table, res["torch"].table)
    assert _scan_io(res["torch"]) == _scan_io(res["jax"])


def test_streaming_matches_the_materialized_plan_and_sizes_chunks(tmp_path):
    """The streamed plan equals the same plan over the materialized table,
    and with a stats store a second run sizes its chunks from the first
    run's observed decode rate."""
    arrays = _seq()
    paths = _write(tmp_path, {"t": arrays}, row_groups=4)
    t = table_from_numpy(list(arrays), list(arrays.values()),
                         [None] * 3, ["int64"] * 3, device="cpu")
    plan = _plan_over(tplan, tplan.col("key") >= 5,
                      schema=["seq", "key", "val"])
    ref = tplan.PlanExecutor(device="cpu").execute(plan, {"t": t})
    store = tstats.StatsStore(path="")
    with tstats.scoped_store(store):
        ex = tplan.PlanExecutor(device="cpu")
        for _ in range(2):
            res = ex.execute(plan, {"t": tio.ParquetSource(paths["t"])})
            assert_tables_equal(ref.table, res.table)
    from spark_rapids_tpu_torch.plan.optimizer import subtree_fingerprints
    scan = next(n for n in res.plan.nodes if n.kind == "Scan")
    assert store.suggest_chunk_rows(
        "cpu", subtree_fingerprints(scan)[id(scan)]) >= 4096
