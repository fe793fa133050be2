"""The port's distributed tier (`plan/distributed.py`) on CPU meshes of
logical peers, against its own single-device eager tier and the JAX
package's distributed tier.

The cases of `tests/test_plan_distributed.py`: shuffle and broadcast
joins, semi and anti joins, composite keys with an elided aggregate
exchange, the sample sort and TopK, an aggregate over an authored
Exchange, the gather boundary below a global aggregate, float inputs kept
local, the optimizer off (implicit exchanges), cap escalation, stacked
consumers, the transport's accounting with packing off and on, the codec
knobs, the async exchange, a DAG-shared gather, NDS q72 and the capped +
mesh rejection; and a Parquet source on a mesh. Every result equals the
port's single-device run (`to_pydict`). In every case but the
DAG-shared gather, the two rejections and the Parquet source, the JAX
package runs the same plan on its 2-device mesh: every executed
operator's kind, `sharding`, `n_peers`, `exchange_how`,
`exchange_bytes`, `exchange_bytes_logical`, `exchange_codecs`, live rows
and escalations equal the reference's, and so do the optimizer's
exchanges and sharding, the certifier's per-edge exchange bounds for 2
peers and the result.
Tolerance: exact (integer plans; the float case keeps its aggregate
local).
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.parallel import make_mesh as j_make_mesh
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import stats as jstats

from benchmarks import bench_nds_q72, nds_plans

from spark_rapids_tpu_torch import nds_q72, table_from_numpy
from spark_rapids_tpu_torch.analysis.footprint import check_observed
from spark_rapids_tpu_torch.parallel import make_mesh
from spark_rapids_tpu_torch.plan import (PlanBuilder, PlanExecutor,
                                         PlanValidationError, col)
from spark_rapids_tpu_torch.plan import stats as torch_stats
from spark_rapids_tpu_torch.plan.distributed import DistContext, shard_table
from spark_rapids_tpu_torch.plan.metrics import OperatorMetrics

NDEV = 2


@pytest.fixture(autouse=True, scope="module")
def _no_stats_stores():
    """No stats store on either side: the static decisions."""
    with torch_stats.scoped_store(None), jstats.scoped_store(None):
        yield


@pytest.fixture(autouse=True)
def _gate_on(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "1")


def _mesh(n=NDEV):
    return make_mesh(n, devices=["cpu"] * n)


@contextlib.contextmanager
def _env(**kv):
    """The same knob for both packages (SPARK_RAPIDS_TORCH_<k> and
    SPARK_RAPIDS_TPU_<k>)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in kv.items():
            for prefix in ("SPARK_RAPIDS_TORCH_", "SPARK_RAPIDS_TPU_"):
                if v is None:
                    mp.delenv(prefix + k, raising=False)
                else:
                    mp.setenv(prefix + k, v)
        yield


def _inputs(arrays):
    """{name: {col: array}} -> (JAX tables, port tables)."""
    jt = {n: JTable([JColumn.from_numpy(a) for a in cols.values()],
                    names=list(cols)) for n, cols in arrays.items()}
    tt = {n: table_from_numpy(list(cols), list(cols.values()),
                              [None] * len(cols),
                              [a.dtype.name for a in cols.values()],
                              device="cpu")
          for n, cols in arrays.items()}
    return jt, tt


def _tables(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return {"sales": {"k": rng.integers(0, 40, n),
                      "v": rng.integers(-500, 500, n)},
            "dims": {"dk": np.arange(40), "grp": rng.integers(0, 3, 40)}}


_FIELDS = ("kind", "sharding", "n_peers", "exchange_how", "exchange_bytes",
           "exchange_bytes_logical", "exchange_codecs", "rows_out",
           "escalations")


def _dist_row(m):
    return tuple(getattr(m, f) for f in _FIELDS)


def _parity(make_plan, arrays, **ex_kw):
    """Port distributed == port single device; every executed operator's
    distributed metrics, the certifier's edge bounds and the optimizer's
    exchange report equal the JAX package's 2-device run, and so does the
    result."""
    jt, tt = _inputs(arrays)
    plan = make_plan(PlanBuilder, col)
    ref = PlanExecutor(device="cpu", **ex_kw).execute(plan, tt)
    res = PlanExecutor(device="cpu", mesh=_mesh(), **ex_kw).execute(plan,
                                                                     tt)
    assert not res.degraded
    assert res.table.to_pydict() == ref.table.to_pydict()
    jres = JPlanExecutor(mesh=j_make_mesh(NDEV), **ex_kw).execute(
        make_plan(JPlanBuilder, jcol), jt)
    assert res.table.to_pydict() == jres.table.to_pydict()
    got = [_dist_row(res.metrics[n.label]) for n in res.plan.nodes]
    want = [_dist_row(jres.metrics[n.label]) for n in jres.plan.nodes]
    assert got == want
    # the certifier's per-edge exchange bounds for the mesh's peers
    assert res.cert.n_peers == jres.cert.n_peers == NDEV
    assert [(b.kind, b.exchange_bytes_hi, b.rows_hi)
            for b in res.cert.ops] == \
        [(b.kind, b.exchange_bytes_hi, b.rows_hi) for b in jres.cert.ops]
    assert res.cert.exchange_bytes_hi == jres.cert.exchange_bytes_hi
    if jres.optimizer is not None:
        for k in ("exchanges", "exchanges_elided"):
            assert res.optimizer[k] == jres.optimizer[k]
        assert list(res.optimizer["sharding"].values()) == \
            list(jres.optimizer["sharding"].values())
    return res


def _join_agg(keys=("grp", "k")):
    def make(B, c):
        b = B()
        s = b.scan("sales", schema=["k", "v"])
        d = b.scan("dims", schema=["dk", "grp"])
        return (s.join(d, left_on="k", right_on="dk")
                 .aggregate(list(keys), [("v", "sum", "t"),
                                         ("v", "max", "mx"),
                                         ("v", "size", "n")])
                 .sort(["k"]).build())
    return make


# ---- joins ---------------------------------------------------------------------

def test_shuffle_join_agg_sort_parity():
    """Both join sides shuffle, the aggregate's exchange is elided (the
    join output is partitioned by k, a subset of the group keys), and one
    gather at the sink."""
    with _env(BROADCAST_ROWS="1"):
        res = _parity(_join_agg(), _tables())
    assert res.optimizer["exchanges"] == {"hash": 2, "broadcast": 0,
                                          "gather": 1}
    assert res.optimizer["exchanges_elided"] >= 1
    gathers = [m for m in res.metrics.values() if m.exchange_how == "gather"]
    assert len(gathers) == 1
    assert sum(m.exchange_bytes for m in res.metrics.values()) > 0
    assert any(m.n_peers == NDEV for m in res.metrics.values())


def test_broadcast_join_parity_and_explain():
    def make(B, c):
        b = B()
        s = b.scan("sales", schema=["k", "v"])
        d = b.scan("dims", schema=["dk", "grp"]).filter(c("grp") == 1)
        return (s.join(d, left_on="k", right_on="dk")
                 .aggregate(["grp"], [("v", "sum", "t")]).build())
    res = _parity(make, _tables())
    assert res.optimizer["exchanges"]["broadcast"] == 1
    bc = [m for m in res.metrics.values() if m.exchange_how == "broadcast"]
    assert len(bc) == 1 and bc[0].exchange_bytes > 0
    jt, tt = _inputs(_tables())
    text = PlanExecutor(device="cpu", mesh=_mesh()).explain(
        make(PlanBuilder, col), optimized=True, inputs=tt)
    jtext = JPlanExecutor(mesh=j_make_mesh(NDEV)).explain(
        make(JPlanBuilder, jcol), optimized=True, inputs=jt)
    line = [ln for ln in text.splitlines() if ln.startswith("transport:")]
    jline = [ln for ln in jtext.splitlines() if ln.startswith("transport:")]
    assert line == jline and len(line) == 1
    assert "broadcast" in text


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_semi_and_anti_join_parity(how):
    def make(B, c):
        b = B()
        s = b.scan("sales", schema=["k", "v"])
        d = b.scan("dims", schema=["dk", "grp"]).filter(c("grp") == 1)
        return (s.join(d, left_on="k", right_on="dk", how=how)
                 .aggregate(["k"], [("v", "sum", "t"), ("v", "count", "c")])
                 .sort(["k"]).build())
    _parity(make, _tables(seed=3))


def test_multi_key_join_and_agg_elision():
    rng = np.random.default_rng(7)
    n = 400
    pairs = [(a, b) for a in range(8) for b in range(6)]
    arrays = {"l": {"a": rng.integers(0, 8, n), "b": rng.integers(0, 6, n),
                    "v": rng.integers(0, 100, n)},
              "r": {"ra": np.array([p[0] for p in pairs]),
                    "rb": np.array([p[1] for p in pairs]),
                    "w": np.arange(len(pairs))}}

    def make(B, c):
        b = B()
        left = b.scan("l", schema=["a", "b", "v"])
        right = b.scan("r", schema=["ra", "rb", "w"])
        return (left.join(right, ["a", "b"], ["ra", "rb"])
                .aggregate(["a", "b", "w"], [("v", "sum", "t")])
                .sort(["a", "b", "w"]).build())
    with _env(BROADCAST_ROWS="1"):
        res = _parity(make, arrays)
    assert res.optimizer["exchanges_elided"] >= 1


# ---- sort / topk ----------------------------------------------------------------

@pytest.mark.parametrize("desc", [False, True])
def test_distributed_sort_and_topk_parity(desc):
    rng = np.random.default_rng(11)
    n = 500
    arrays = {"t": {"k": rng.permutation(n), "v": rng.integers(0, 99, n)}}

    def make(B, c):
        r = B().scan("t", schema=["k", "v"])
        if desc:
            return r.sort(["k"], ascending=False).limit(7).build()
        return r.sort(["k"]).build()
    res = _parity(make, arrays)
    assert any(m.exchange_how == "range" for m in res.metrics.values())
    if desc:
        assert res.table.num_rows == 7


# ---- aggregates -----------------------------------------------------------------

def test_agg_over_authored_exchange_fuses():
    rng = np.random.default_rng(5)
    n = 512
    arrays = {"t": {"k": rng.integers(0, 30, n),
                    "v": rng.integers(-100, 100, n)}}

    def make(B, c):
        return (B().scan("t", schema=["k", "v"]).exchange(keys=["k"])
                .aggregate(["k"], [("v", "sum", "s"), ("v", "min", "lo"),
                                   ("v", "count", "c")])
                .sort(["k"]).build())
    res = _parity(make, arrays)
    exm = next(m for m in res.metrics.values() if m.kind == "Exchange"
               and m.exchange_how == "hash")
    assert exm.exchange_bytes > 0


def test_agg_without_sort_reorders_to_local_kernel_order():
    rng = np.random.default_rng(9)
    n = 300
    arrays = {"t": {"k": rng.integers(0, 25, n), "v": rng.integers(0, 50, n)}}

    def make(B, c):
        return (B().scan("t", schema=["k", "v"])
                .aggregate(["k"], [("v", "sum", "s")]).build())
    _parity(make, arrays)


# ---- graceful boundaries -------------------------------------------------------

def test_gather_boundary_below_global_aggregate():
    def make(B, c):
        b = B()
        s = b.scan("sales", schema=["k", "v"]).filter(c("v") > 0)
        d = b.scan("dims", schema=["dk", "grp"]).filter(c("grp") == 1)
        return (s.join(d, left_on="k", right_on="dk", how="left_semi")
                 .aggregate([], [("v", "sum", "total"), ("v", "count", "n")])
                 .build())
    res = _parity(make, _tables(seed=13))
    agg = next(m for m in res.metrics.values() if m.kind == "HashAggregate")
    assert not agg.sharding.startswith(("hash", "rows", "replicated"))
    assert any(m.exchange_how == "gather" for m in res.metrics.values())


def test_float_inputs_keep_aggregate_local_with_parity():
    rng = np.random.default_rng(17)
    n = 200
    arrays = {"t": {"k": rng.integers(0, 10, n),
                    "x": rng.standard_normal(n)}}

    def make(B, c):
        return (B().scan("t", schema=["k", "x"])
                .aggregate(["k"], [("x", "sum", "s")]).build())
    res = _parity(make, arrays)
    agg = next(m for m in res.metrics.values() if m.kind == "HashAggregate")
    assert not agg.sharding.startswith(("hash", "rows", "replicated"))


def test_optimizer_off_distributes_with_implicit_exchanges():
    def make(B, c):
        b = B()
        s = b.scan("sales", schema=["k", "v"])
        d = b.scan("dims", schema=["dk", "grp"])
        return (s.join(d, left_on="k", right_on="dk")
                 .aggregate(["k"], [("v", "sum", "t")]).sort(["k"]).build())
    res = _parity(make, _tables(seed=19), optimize=False)
    join = next(m for m in res.metrics.values() if m.kind == "HashJoin")
    assert join.exchange_how == "hash" and join.exchange_bytes > 0


def test_capacity_escalation_on_undersized_key_cap():
    rng = np.random.default_rng(23)
    n = 400
    arrays = {"t": {"k": rng.permutation(n) % 97,
                    "v": rng.integers(0, 50, n)}}

    def make(B, c):
        return (B().scan("t", schema=["k", "v"])
                .aggregate(["k"], [("v", "sum", "s")], key_cap=32)
                .sort(["k"]).build())
    res = _parity(make, arrays)
    agg = next(m for m in res.metrics.values() if m.kind == "HashAggregate")
    assert agg.escalations > 0
    text = res.profile_text()
    assert "dist: sharding" in text and "B moved" in text


@pytest.mark.parametrize("optimize", [True, False])
def test_stacked_consumers_never_elide_on_stale_placement(optimize):
    rng = np.random.default_rng(31)
    n = 600
    pairs = [(a, c) for a in range(7) for c in range(4)]
    arrays = {"l": {"k": rng.integers(0, 7, n), "g": rng.integers(0, 4, n),
                    "v": rng.integers(0, 50, n)},
              "r1": {"rk": np.arange(7), "w": np.arange(7)},
              "r2": {"jk": np.array([p[0] for p in pairs]),
                     "jg": np.array([p[1] for p in pairs]),
                     "z": np.arange(len(pairs))}}

    def make(B, c):
        b = B()
        return (b.scan("l", schema=["k", "g", "v"])
                .join(b.scan("r1", schema=["rk", "w"]), "k", "rk")
                .aggregate(["k", "g"], [("v", "sum", "s")])
                .join(b.scan("r2", schema=["jk", "jg", "z"]),
                      ["k", "g"], ["jk", "jg"])
                .aggregate(["k"], [("z", "sum", "zz"), ("s", "sum", "ss")])
                .sort(["k"]).build())
    with _env(BROADCAST_ROWS="1"):
        _parity(make, arrays, optimize=optimize)


# ---- the transport -------------------------------------------------------------

def _det_tables(n=100):
    return {"sales": {"k": np.arange(n) % 40, "v": np.arange(n) - 50},
            "dims": {"dk": np.arange(40), "grp": np.arange(40) % 3}}


def _join_sort(B, c):
    b = B()
    s = b.scan("sales", schema=["k", "v"])
    d = b.scan("dims", schema=["dk", "grp"])
    return (s.join(d, left_on="k", right_on="dk")
             .sort(["k", "v"]).build())


def test_exchange_accounting_pinned_two_peer():
    """Packing off (wire == logical): a hash edge counts each live row
    once at key word + value width, a broadcast its payload x (P - 1), the
    gather the join output once."""
    n = 100
    with _env(EXCHANGE_PACK="off", BROADCAST_ROWS="1"):
        res = _parity(_join_sort, _det_tables(n))
    ex = [m for m in res.metrics.values()
          if m.kind == "Exchange" and m.exchange_how]
    hashes = sorted(m.exchange_bytes for m in ex if m.exchange_how == "hash")
    assert hashes == [40 * 16, n * 16]
    (g,) = [m for m in ex if m.exchange_how == "gather"]
    assert g.exchange_bytes == n * 32
    assert all(m.exchange_bytes == m.exchange_bytes_logical for m in ex)
    with _env(EXCHANGE_PACK="off"):
        res = _parity(_join_sort, _det_tables(n))
    bc = next(m for m in res.metrics.values()
              if m.exchange_how == "broadcast")
    assert bc.exchange_bytes == 40 * 16 * (NDEV - 1)


def test_packed_exchanges_wire_under_logical_and_cert():
    def make(B, c):
        b = B()
        s = b.scan("sales", schema=["k", "v"])
        d = b.scan("dims", schema=["dk", "grp"])
        return (s.join(d, left_on="k", right_on="dk")
                 .aggregate(["k"], [("v", "sum", "t")]).sort(["k"]).build())
    with _env(BROADCAST_ROWS="1"):
        res = _parity(make, _det_tables(200))
    edges = [m for m in res.metrics.values() if m.exchange_how]
    assert edges and all(m.exchange_bytes <= m.exchange_bytes_logical
                         for m in edges)
    assert any(m.exchange_bytes < m.exchange_bytes_logical for m in edges)
    assert any(m.exchange_codecs for m in edges)
    assert res.cert is not None and check_observed(res.cert, res) is None
    row = edges[0].to_dict()
    assert row["exchange_bytes_wire"] == row["exchange_bytes"]
    assert "B logical" in res.profile_text()


@pytest.mark.parametrize("env", [{"EXCHANGE_PACK": "off"},
                                 {"EXCHANGE_CODECS": "none"},
                                 {"EXCHANGE_CODECS": "for,bitpack"}])
def test_pack_off_and_codecs_none_restore_parity(env):
    with _env(**env):
        res = _parity(_join_sort, _det_tables(150))
    if env.get("EXCHANGE_PACK") == "off" or \
            env.get("EXCHANGE_CODECS") == "none":
        assert all(m.exchange_bytes == m.exchange_bytes_logical
                   for m in res.metrics.values() if m.exchange_how)


def test_async_exchange_overlap_and_parity():
    with _env(EXCHANGE_ASYNC="on", BROADCAST_ROWS="1"):
        res = _parity(_join_agg(), _tables(seed=41))
    hash_edges = [m for m in res.metrics.values()
                  if m.kind == "Exchange" and m.exchange_how == "hash"]
    assert hash_edges
    for m in hash_edges:
        assert m.rows_out > 0 and m.bytes_out > 0
        assert m.wall_ms is not None and m.wall_ms > 0
        assert m.exchange_overlap_ms >= 0.0


def test_gather_cache_hit_reports_zero_bytes():
    _, tt = _inputs({"t": {"a": np.arange(50), "b": np.arange(50) % 7}})
    plan = PlanBuilder().scan("t", schema=["a", "b"]).build()
    mesh = _mesh()
    ctx = DistContext(PlanExecutor(device="cpu", mesh=mesh), plan, tt)
    rel = shard_table(mesh, "data", tt["t"])
    m1 = OperatorMetrics("e1", "Exchange")
    m2 = OperatorMetrics("e2", "Exchange")
    t1 = ctx._gather(rel, m1)
    t2 = ctx._gather(rel, m2)
    assert t1 is t2
    assert t1.to_pydict() == tt["t"].to_pydict()
    assert m1.exchange_bytes > 0
    assert m2.exchange_how == "gather" and m2.exchange_bytes == 0
    assert m2.exchange_bytes_logical == 0


def test_nds_q72_distributed_equals_jax():
    """q72 at 4,000 catalog_sales rows on 2 peers, optimized, packed: the
    result and every operator's distributed metrics equal the JAX
    package's distributed run and the port's single-device run."""
    n = 4000
    jin = nds_plans.q72_inputs(*bench_nds_q72.build_tables(n, seed=5))
    tin = nds_q72.q72_inputs(n, seed=5, device="cpu")
    plan = nds_q72.q72_plan()
    ref = PlanExecutor(device="cpu").execute(plan, tin)
    res = PlanExecutor(device="cpu", mesh=_mesh()).execute(plan, tin)
    jres = JPlanExecutor(mesh=j_make_mesh(NDEV)).execute(
        nds_plans.q72_plan(), jin)
    assert res.table.to_pydict() == ref.table.to_pydict() == \
        jres.table.to_pydict()
    assert [_dist_row(res.metrics[nd.label]) for nd in res.plan.nodes] == \
        [_dist_row(jres.metrics[nd.label]) for nd in jres.plan.nodes]
    edges = [m for m in res.metrics.values() if m.exchange_how]
    assert any(m.exchange_bytes < m.exchange_bytes_logical for m in edges)


def test_capped_mesh_rejected_per_plan_names_operator():
    ex = PlanExecutor(mode="capped", device="cpu", mesh=object())
    b = PlanBuilder()
    _, tt = _inputs({"t": {"v": np.array([1, 2, 3])}})
    agg = b.scan("t", schema=["v"]).aggregate([], [("v", "sum", "s")]).build()
    srt = b.scan("t", schema=["v"]).sort(["v"]).build()
    with pytest.raises(PlanValidationError, match=r"Sort#\d+"):
        ex.execute(srt, tt)
    with pytest.raises(PlanValidationError, match=r"HashAggregate#\d+"):
        ex.execute(agg, tt)
    # a row-wise plan has no distributed-lowerable operator: it runs
    flt = b.scan("t", schema=["v"]).filter(col("v") > 1).build()
    assert ex.execute(flt, tt).compact().to_pydict() == {"v": [2, 3]}


def test_mesh_on_another_device_raises():
    with pytest.raises(ValueError, match="share one device"):
        PlanExecutor(device="cpu", mesh=make_mesh(2, devices=["meta"] * 2))


def test_parquet_source_on_a_mesh(tmp_path):
    """A Parquet-bound scan on a mesh is read once, pruned and projected,
    then sharded (no streaming prefix under a mesh)."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu_torch.io import ParquetSource
    arrays = _tables(n=800, seed=43)
    path = str(tmp_path / "sales.parquet")
    pq.write_table(pa.table({k: pa.array(v) for k, v in
                             arrays["sales"].items()}), path,
                   row_group_size=200)
    _, tt = _inputs(arrays)
    plan = _join_agg(("k",))(PlanBuilder, col)
    ref = PlanExecutor(device="cpu").execute(plan, tt)
    res = PlanExecutor(device="cpu", mesh=_mesh()).execute(
        plan, {"sales": ParquetSource(path), "dims": tt["dims"]})
    assert res.table.to_pydict() == ref.table.to_pydict()
    scan = next(m for m in res.metrics.values()
                if m.kind == "Scan" and m.io_row_groups_total)
    assert scan.io_row_groups_total == 4 and scan.sharding == f"rows@{NDEV}"
