"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (hash join,
row hash, shuffle histogram, FusedSelect, TopK, groupby, the casts) against
their plain PyTorch versions, and q3 and TPC-DS q3 through `PlanExecutor()`
on the card.

They import neither JAX nor the JAX package, so they also run where only
the port's dependencies are installed, e.g. on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a CUDA device each test skips (decided inside the test).
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import nds_q3
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch import parallel
from spark_rapids_tpu_torch.columnar import Table
from spark_rapids_tpu_torch.ops import hash as thash
from spark_rapids_tpu_torch.ops import (cast_cuda, cast_decimal,
                                        cast_decimal_to_string,
                                        cast_float_to_string, cast_string,
                                        hash_cuda, join, join_cuda, select,
                                        select_cuda, topk, topk_cuda)
from spark_rapids_tpu_torch.parallel import partition_cuda
# the module: the package's `format_float` is the function
format_float = importlib.import_module("spark_rapids_tpu_torch.ops.format_float")
from spark_rapids_tpu_torch.plan import PlanExecutor, col, lit
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


def _same_probe(got, want):
    """Two probe counts equal: every field, and each segment's list as far
    as the segment has matched rows."""
    for name in ("counts", "tile_sums", "tile_offsets", "seg_sums",
                 "seg_matched", "total"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    at = torch.arange(got.counts.shape[0], device=got.counts.device)
    listed = (at % got.seg) < got.seg_matched.index_select(0, at // got.seg)
    assert torch.equal(got.entries[listed], want.entries[listed])
    c64 = got.counts.to(torch.int64)
    first = torch.arange(0, c64.shape[0], got.tile, device=c64.device)
    assert torch.equal(got.tile_offsets,
                       (torch.cumsum(c64, 0) - c64).index_select(0, first))


@pytest.mark.parametrize("dtype,npt", [(tdt.INT64, np.int64),
                                       (tdt.INT16, np.int16),
                                       (tdt.decimal(9, 2), np.int32)])
@pytest.mark.parametrize("null_p", [0.0, 0.1])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernels_equal_plain_versions(dtype, npt, null_p, offset):
    """Build, count and emit against their plain versions; with `offset`,
    every key column is a view one element into its buffers."""
    _need_card()
    rng = np.random.default_rng(11)
    nl, nr = 50_001, 400

    def col(n):
        v = (rng.random(n + offset) > null_p) if null_p else None
        c = Column.from_numpy(rng.integers(-90, 90, n + offset).astype(npt),
                              dtype, v, device="cuda")
        return [Column(dtype, n, c.data[offset:],
                       None if v is None else c.validity[offset:])]
    lc, rc = col(nl), col(nr)
    C = join_cuda._capacity(nr)
    tk = join_cuda.build_table_cuda(rc, C)
    tp = join_cuda.build_table_plain(rc, C)
    assert torch.equal(tk.slot_row, tp.slot_row)
    assert torch.equal(tk.slot_hash, tp.slot_hash)
    pk = join_cuda.probe_counts_cuda(lc, tk, rc)
    pp = join_cuda.probe_counts_plain(lc, tp, rc)
    _same_probe(pk, pp)
    total = int(pk.total)
    lk, rk = join_cuda.probe_emit_cuda(lc, tk, rc, pk, total)
    lp, rp = join_cuda.probe_emit_plain(lc, tp, rc, pp, total)
    assert torch.equal(lk, lp) and torch.equal(rk, rp)
    got = join_cuda.inner_join_hash(lc, rc)
    ref = join.inner_join(lc, rc)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, ref[0].data)
    assert torch.equal(got[1].data, ref[1].data)


@pytest.mark.parametrize("n", [1, 7, 9, 2047, 2048, 2049, 6143, 6145])
def test_probe_sizes_off_the_tiles(n):
    """Probe sizes on and off the kernels' 2,048-row tiles and a lane's 8
    rows, with 512 equal build keys (512 pairs a matched row: past the
    emit's staging)."""
    _need_card()
    rng = np.random.default_rng(n)
    lc = [Column.from_numpy(np.where(rng.random(n) < 0.3, 5, 6)
                            .astype(np.int64), tdt.INT64,
                            rng.random(n) > 0.1, device="cuda")]
    rc = [Column.from_numpy(np.full(512, 5, np.int64), tdt.INT64,
                            device="cuda")]
    C = join_cuda._capacity(512)
    tk = join_cuda.build_table_cuda(rc, C)
    pk = join_cuda.probe_counts_cuda(lc, tk, rc)
    _same_probe(pk, join_cuda.probe_counts_plain(lc, tk, rc))
    got = join_cuda.inner_join_hash(lc, rc)
    ref = join.inner_join(lc, rc)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, ref[0].data)
    assert torch.equal(got[1].data, ref[1].data)


def test_joins_on_two_streams_at_once():
    """Hash joins from two threads, each on its own stream: the count's
    tile sums, offsets and ticket are each call's own, so every map is the
    plain one."""
    _need_card()
    import threading
    rng = np.random.default_rng(5)
    n = 1_000_000                      # many blocks: the tickets decide
    lc = [Column.from_numpy(rng.integers(0, 3650, n).astype(np.int64),
                            tdt.INT64, device="cuda")]
    rc = [Column.from_numpy(np.arange(0, 3650, 12, dtype=np.int64),
                            tdt.INT64, device="cuda")]
    want = join.inner_join(lc, rc)
    torch.cuda.synchronize()           # the inputs, before other streams
    bad = []

    def run():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for _ in range(20):
                got = join_cuda.inner_join_hash(lc, rc)
                s.synchronize()
                if not (torch.equal(got[0].data, want[0].data) and
                        torch.equal(got[1].data, want[1].data)):
                    bad.append("maps differ")

    threads = [threading.Thread(target=run) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad, bad[0]


def test_q3_on_the_card_uses_the_kernels():
    _need_card()
    inputs = nds_q3.q3_inputs(200_000)
    join_cuda.reset_counters()
    res = PlanExecutor().execute(nds_q3.q3_plan(), inputs)
    assert join_cuda.LAUNCHES == {"build": 2, "count": 2,
                                  "emit": 2, "exists": 0, "capped": 0}
    assert [m.kernel for m in res.metrics.values()
            if m.kind == "HashJoin"] == ["cuda:hash_join"] * 2
    cpu = PlanExecutor(device="cpu").execute(nds_q3.q3_plan(), inputs)
    for a, b in zip(res.table.columns, cpu.table.columns):
        assert torch.equal(a.data.cpu(), b.data)


@pytest.mark.parametrize("null_p", [0.0, 0.2])
@pytest.mark.parametrize("n", [1, 1000, 70_001])
def test_row_hash_kernel_equals_plain_version(n, null_p):
    _need_card()
    rng = np.random.default_rng(n)

    def col(arr, dtype):
        v = (rng.random(n) > null_p) if null_p else None
        return Column.from_numpy(arr, dtype, v, device="cuda")
    f = rng.standard_normal(n)
    f[:min(n, 4)] = [np.nan, -0.0, 0.0, np.inf][:min(n, 4)]
    ints = [col(rng.integers(-2 ** 62, 2 ** 62, n), tdt.INT64),
            col(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                tdt.INT32),
            col(rng.integers(-99, 99, n).astype(np.int8), tdt.INT8),
            col(rng.integers(-10 ** 8, 10 ** 8, n).astype(np.int32),
                tdt.decimal(9, 2)),
            col(rng.integers(0, 2, n).astype(bool), tdt.BOOL)]
    floats = ints[:2] + [col(f, tdt.FLOAT64),
                         col(f.astype(np.float32), tdt.FLOAT32)]
    hash_cuda.reset_counters()
    for cols in (ints, floats):
        for seed in (0, 42):
            assert torch.equal(hash_cuda.murmur_hash3_32(cols, seed).data,
                               thash.murmur_hash3_32(cols, seed).data)
            assert torch.equal(hash_cuda.xxhash64(cols, seed).data,
                               thash.xxhash64(cols, seed).data)
    mm, xx = hash_cuda.fused_row_hash(Table(ints), mm_seed=42)
    assert torch.equal(mm.data, thash.murmur_hash3_32(ints, 42).data)
    assert torch.equal(xx.data, thash.xxhash64(ints).data)
    wide = ints * 8                       # 40 columns: two launches
    assert torch.equal(hash_cuda.xxhash64(wide).data,
                       thash.xxhash64(wide).data)
    torch.cuda.synchronize()
    assert hash_cuda.LAUNCHES == {"murmur": 4, "xxhash": 6, "fused": 1}
    assert hash_cuda.PLAIN_CALLS == {"murmur": 0, "xxhash": 0, "fused": 0}


# 300 and 2000 keep fewer sub-histograms per block, 13000 none (global adds)
@pytest.mark.parametrize("P", [1, 8, 64, 128, 300, 2000, 13000])
def test_histogram_kernel_equals_plain_version(P):
    _need_card()
    rng = np.random.default_rng(P)
    part = rng.integers(0, P, 100_003).astype(np.int32)
    part[::97] = -1
    part[::89] = P
    tp = torch.from_numpy(part).cuda()
    partition_cuda.reset_counters()
    got = parallel.partition_histogram(tp, P)
    want = partition_cuda.histogram_plain(tp, P)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), torch.from_numpy(
        np.bincount(part[(part >= 0) & (part < P)], minlength=P)
        .astype(np.int32)))
    assert partition_cuda.LAUNCHES == {"histogram": 1, "exchange_map": 0}
    assert partition_cuda.PLAIN_CALLS == {"histogram": 0, "exchange_map": 0}


# P = 1365 is the kernel's most (its shared-memory counters); shards off
# and on its 8,192-row blocks and 256-row rounds; caps that overflow
@pytest.mark.parametrize("P,s,cap", [(1, 100_003, 200_000), (2, 1, 1),
                                     (8, 8191, 700), (8, 8193, 100),
                                     (8, 1_250_000, 40_000),
                                     (64, 33, 2), (1365, 33, 1)])
def test_exchange_map_kernel_equals_plain_version(P, s, cap):
    _need_card()
    rng = np.random.default_rng(P + s)
    ids = ((rng.zipf(1.4, (P, s)) - 1) % (P + 1) - (s % 2)).astype(np.int32)
    part = torch.from_numpy(ids)
    want = partition_cuda.exchange_map_plain(part, cap)
    partition_cuda.reset_counters()
    got = parallel.exchange_map(part.cuda(), cap)
    assert partition_cuda.LAUNCHES["exchange_map"] == 1
    assert partition_cuda.PLAIN_CALLS["exchange_map"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    with pytest.raises(Exception, match="at most 1365 peers"):
        parallel.exchange_map(torch.zeros((1366, 1), dtype=torch.int32,
                                          device="cuda"), 1)


def test_meshed_plan_on_the_card_uses_the_exchange_kernels():
    """TPC-DS q3 on 4 logical peers of the card equals the single-device
    run, through the exchange-map and row-hash kernels, no plain run."""
    _need_card()
    t = nds_q3.q3_tpcds_inputs(50_000, device="cuda")
    want = PlanExecutor().execute(nds_q3.q3_tpcds_plan(), t)
    mesh = parallel.make_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    partition_cuda.reset_counters()
    hash_cuda.reset_counters()
    got = PlanExecutor(mesh=mesh).execute(nds_q3.q3_tpcds_plan(), t)
    assert got.table.to_pydict() == want.table.to_pydict()
    assert partition_cuda.LAUNCHES["exchange_map"] > 0
    assert hash_cuda.LAUNCHES["murmur"] > 0
    assert partition_cuda.PLAIN_CALLS["exchange_map"] == 0
    assert hash_cuda.PLAIN_CALLS["murmur"] == 0


def _bits(t):
    """Floats as their bits, so that NaN rows compare equal."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same_table(a, b):
    assert a.names == b.names and a.num_rows == b.num_rows
    for x, y in zip(a.columns, b.columns):
        assert x.dtype == y.dtype
        assert torch.equal(_bits(x.data), _bits(y.data))
        assert (x.validity is None) == (y.validity is None)
        if x.validity is not None:
            assert torch.equal(x.validity, y.validity)


_FS_SPECS = [("bool", None, tdt.BOOL), ("int8", np.int8, tdt.INT8),
             ("int16", np.int16, tdt.INT16), ("int32", np.int32, tdt.INT32),
             ("date32", np.int32, tdt.DATE32), ("int64", np.int64, tdt.INT64),
             ("decimal32", np.int32, tdt.decimal(9, 2)),
             ("decimal64", np.int64, tdt.decimal(18, 2)),
             ("float32", np.float32, tdt.FLOAT32),
             ("float64", np.float64, tdt.FLOAT64)]


def _fs_table(n, null_p, seed=0):
    rng = np.random.default_rng(seed)
    cols, names = [], []
    for name, npt, dtype in _FS_SPECS:
        if npt is None:
            a = rng.integers(0, 2, n).astype(bool)
        elif np.issubdtype(npt, np.floating):
            a = rng.standard_normal(n).astype(npt)
            a[rng.random(n) < 0.05] = np.nan
            a[:min(n, 2)] = [0.0, -0.0][:min(n, 2)]
        else:
            ii = np.iinfo(npt)
            a = rng.integers(ii.min, ii.max, n, dtype=npt, endpoint=True)
        v = (rng.random(n) > null_p) if null_p else None
        cols.append(Column.from_numpy(a, dtype, v, device="cuda"))
        names.append(name)
    cols.append(Column.from_numpy(rng.integers(0, 50, n).astype(np.int32),
                                  tdt.INT32, device="cuda"))
    names.append("sel")
    return Table(cols, names)


_FS_PREDS = [(col("sel") < 25) | (col("sel") > 48),
             col("sel") == 7,
             (col("sel") + 3) * 2 > 40,
             ~(col("sel") >= 10) & (col("bool") | (col("sel") != 3)),
             col("sel") - 60 < lit(-30),
             (col("int8") + 100) > 50,
             col("int32") * 3 < col("int32"),
             (col("int64") > 0) & (col("sel") < 10),
             # float predicates: float32 arithmetic, integer operands
             # rounded, float64 promotion, subnormals, NaN
             (col("float32") + col("int32")) * 0.1 > col("float32"),
             col("float32") * col("int64") < lit(-1.5e18),
             (col("int32") * 1.0) > lit(16777216.5),
             (col("bool") + 0.25) * col("int8") >= col("float64"),
             (col("int16") + 0.1) * col("float32") != col("float32"),
             col("float32") * 1e-39 != lit(0.0),
             (col("float32") == col("float32")) | (col("sel") < 3),
             -col("float64") * col("float32") <= col("decimal32"),
             # a literal-only predicate, and a right-nested chain
             lit(2) + lit(3) > lit(4),
             col("sel") < (col("int8") + (col("int16") - (col("int32") *
                                                          (col("sel") + 1))))]


@pytest.mark.parametrize("null_p", [0.0, 0.15])
@pytest.mark.parametrize("n", [0, 1, 1000, 100_003])
def test_fused_select_kernel_equals_plain_version(n, null_p):
    _need_card()
    t = _fs_table(n, null_p)
    needed = [c for c in t.names if c != "sel"]
    select_cuda.reset_counters()
    for pred in _FS_PREDS:
        got = select_cuda.fused_select_cuda(t, pred, needed)
        _same_table(got, select.fused_select_plain(t, pred, needed))
    torch.cuda.synchronize()
    assert select_cuda.LAUNCHES["count"] == (len(_FS_PREDS) if n else 0)
    # the plain version ran only where the test called it
    assert select_cuda.PLAIN_CALLS == {"fused_select": len(_FS_PREDS)}


_TK_CASES = [(np.int64, True), (np.int64, False), (np.int32, True),
             (np.int16, False), (np.float32, True), (np.float64, False),
             (np.bool_, True)]


@pytest.mark.parametrize("dt,asc", _TK_CASES)
@pytest.mark.parametrize("null_p", [0.0, 0.2])
def test_topk_kernel_equals_plain_version(dt, asc, null_p):
    _need_card()
    rng = np.random.default_rng(3)
    n = 5000
    if dt is np.bool_:
        a, kind = rng.integers(0, 2, n).astype(bool), tdt.BOOL
    elif np.issubdtype(dt, np.floating):
        a = rng.standard_normal(n).astype(dt)
        a[rng.random(n) < 0.05] = np.nan
        kind = tdt.FLOAT32 if dt is np.float32 else tdt.FLOAT64
    else:
        a = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n, dtype=dt,
                         endpoint=True)
        kind = {np.int64: tdt.INT64, np.int32: tdt.INT32,
                np.int16: tdt.INT16}[dt]
    v = (rng.random(n) > null_p) if null_p else None
    t = Table([Column.from_numpy(a, kind, v, device="cuda"),
               Column.from_numpy(rng.integers(0, 9, n).astype(np.int32),
                                 tdt.INT32, device="cuda")], ["k", "pay"])
    # the route rule picks the kernel: on an H100 4,099 with nulls (three
    # words) takes the tile sort and merge, every other limit the
    # threshold kernel
    W = 3 if null_p else 2
    _, optin = topk_cuda.device_limits(torch.device("cuda"))
    for k in (1, 17, 100, 128, 129, 513, 1000, 4099):
        before = dict(topk_cuda.LAUNCHES)
        _same_table(topk_cuda.topk_table_cuda(t, ["k"], [asc], k),
                    topk.topk_plain(t, ["k"], [asc], k))
        threshold = topk_cuda.LAUNCHES["threshold"] - before["threshold"]
        assert threshold == int(topk.threshold_route(k, W, optin)), k
    keys, ascs = ["k", "pay"], [asc, not asc]
    for k in (50, 700):
        _same_table(topk_cuda.topk_table_cuda(t, keys, ascs, k),
                    topk.topk_plain(t, keys, ascs, k))
    small = Table([c for c in t.columns], t.names)
    small = topk.topk_plain(small, ["pay"], [True], 40)     # k > n
    _same_table(topk_cuda.topk_table_cuda(small, ["k"], [asc], 100),
                topk.topk_plain(small, ["k"], [asc], 100))
    torch.cuda.synchronize()


def test_kernels_on_two_streams_at_once():
    """FusedSelect and TopK from two threads, each on its own stream:
    the calls share no device state, so every result is the plain one."""
    _need_card()
    import threading
    n = 1_000_000                      # many blocks: the tickets decide
    t = _fs_table(n, 0.1, seed=4)
    pred, needed = (col("sel") < 7) & (col("int32") > 0), ["int64", "sel"]
    keys, asc = ["int64", "float32"], [False, True]
    want_fs = select.fused_select_plain(t, pred, needed)
    want_tk = topk.topk_plain(t, keys, asc, 100)
    torch.cuda.synchronize()           # the inputs, before other streams
    bad = []

    def run():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for _ in range(20):
                fs = select_cuda.fused_select_cuda(t, pred, needed)
                tk = topk_cuda.topk_table_cuda(t, keys, asc, 100)
                s.synchronize()
                for got, want in ((fs, want_fs), (tk, want_tk)):
                    try:
                        _same_table(got, want)
                    except AssertionError as e:
                        bad.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad, bad[0]


def test_tpcds_q3_on_the_card_uses_the_kernels():
    _need_card()
    inputs = nds_q3.q3_tpcds_inputs(300_000)
    for m in (join_cuda, select_cuda, topk_cuda):
        m.reset_counters()
    res = PlanExecutor().execute(nds_q3.q3_tpcds_plan(), inputs)
    torch.cuda.synchronize()
    assert join_cuda.LAUNCHES["build"] == 2
    assert select_cuda.LAUNCHES["count"] == 2
    # the threshold kernel takes the groups in one launch
    assert topk_cuda.LAUNCHES == {"threshold": 1, "select": 0, "merge": 0,
                                  "final": 0}
    assert select_cuda.PLAIN_CALLS == {"fused_select": 0}
    assert topk_cuda.PLAIN_CALLS == {"topk": 0}
    kinds = {m.kind: m.kernel for m in res.metrics.values() if m.kernel}
    assert kinds == {"FusedSelect": "cuda:fused_select",
                     "HashAggregate": "cuda:groupby",
                     "HashJoin": "cuda:hash_join", "TopK": "cuda:topk"}
    cpu = PlanExecutor(device="cpu").execute(
        nds_q3.q3_tpcds_plan(), {k: t.to("cpu") for k, t in inputs.items()})
    _same_table(res.table.to("cpu"), cpu.table)


def test_a_declined_call_raises_on_the_card(monkeypatch):
    _need_card()
    from spark_rapids_tpu_torch.ops.registry import KernelDeclinedError
    from spark_rapids_tpu_torch.plan import PlanBuilder
    t = _fs_table(1000, 0.0)
    big = col("sel")
    for _ in range(70):
        big = big - col("int8")
    inputs = {"t": t}
    for pred, force, declined in (
            (col("sel") < 9, None, False), (big > 0, None, True),
            (col("sel") < 9, "fused_select=torch", True)):
        plan = (PlanBuilder().scan("t", schema=list(t.names)).filter(pred)
                .project({"v": col("int16")}).build())
        if force:
            monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", force)
        select.PLAIN_CALLS["fused_select"] = 0
        if declined:
            with pytest.raises(KernelDeclinedError, match="fused_select"):
                PlanExecutor().execute(plan, inputs)
        else:
            res = PlanExecutor().execute(plan, inputs)
            assert [m.kernel for m in res.metrics.values() if m.kernel] == [
                "cuda:fused_select"]
        assert select.PLAIN_CALLS == {"fused_select": 0}


# ---- the hash join's large route, the segment sum, q72 ----------------------

def _large_case(case, rng):
    """(probe keys, build keys) on the card for one large-route case."""
    def col(a, dtype, null_p=0.0):
        v = (rng.random(a.shape[0]) > null_p) if null_p else None
        return Column.from_numpy(a, dtype, v, device="cuda")
    npb = 100_003
    if case == "inventory":
        items, weeks = np.meshgrid(np.arange(500), np.arange(104))
        return ([col(rng.integers(0, 520, npb).astype(np.int64), tdt.INT64,
                     0.02),
                 col(rng.integers(0, 104, npb).astype(np.int64), tdt.INT64)],
                [col(items.ravel().astype(np.int64), tdt.INT64),
                 col(weeks.ravel().astype(np.int64), tdt.INT64)])
    if case == "equal_600":
        return ([col(np.where(rng.random(npb) < 0.02, 7, 8).astype(np.int64),
                     tdt.INT64)], [col(np.full(600, 7, np.int64), tdt.INT64)])
    if case == "all_null_build":
        return ([col(rng.integers(0, 5, npb).astype(np.int64), tdt.INT64)],
                [col(rng.integers(0, 5, 2000).astype(np.int64), tdt.INT64,
                     1.0)])
    if case == "six_keys":
        # two key columns past the four the small route stages
        kinds = [(np.int64, tdt.INT64), (np.int32, tdt.INT32),
                 (np.int16, tdt.INT16), (np.int8, tdt.INT8),
                 (np.int32, tdt.DATE32), (np.int64, tdt.INT64)]
        build = [rng.integers(0, 3, 3000).astype(n) for n, _ in kinds]
        pick = rng.integers(0, 3000, npb)
        return ([col(np.where(rng.random(npb) < 0.9, b[pick],
                              rng.integers(0, 3, npb)).astype(n), d,
                     0.02 if j == 5 else 0.0)
                 for j, (b, (n, d)) in enumerate(zip(build, kinds))],
                [col(b, d) for b, (_, d) in zip(build, kinds)])
    n = {"rows_513": 513, "rows_1025_int32": 1025}[case]
    dtype, npt = ((tdt.INT32, np.int32) if case.endswith("int32")
                  else (tdt.INT64, np.int64))
    keys = rng.integers(0, n // 2, n).astype(npt)
    return ([col(rng.integers(0, n // 2 + 40, npb).astype(npt), dtype, 0.1)],
            [col(keys, dtype, 0.1)])


@pytest.mark.parametrize("case", ["rows_513", "rows_1025_int32", "equal_600",
                                  "inventory", "all_null_build", "six_keys"])
def test_large_route_equals_plain_versions(case):
    """The large build, count and emit against their plain versions, and
    the maps against the sort-based join; the launches counted as large."""
    _need_card()
    lc, rc = _large_case(case, np.random.default_rng(21))
    C = join_cuda._capacity(rc[0].length)
    assert join_cuda.is_large(C)
    join_cuda.reset_counters()
    tk = join_cuda.build_table_cuda(rc, C)
    tp = join_cuda.build_table_plain(rc, C)
    assert torch.equal(tk.slot_row, tp.slot_row)
    assert torch.equal(tk.slot_hash, tp.slot_hash)
    assert (int(tk.rounds) == 0) == (case == "all_null_build")
    pk = join_cuda.probe_counts_cuda(lc, tk, rc)
    pp = join_cuda.probe_counts_plain(lc, tp, rc)
    assert pk.entries.dtype == torch.int64
    _same_probe(pk, pp)
    total = int(pk.total)
    lk, rk = join_cuda.probe_emit_cuda(lc, tk, rc, pk, total)
    fl, fr = join.inner_join(lc, rc)
    assert torch.equal(lk, fl.data) and torch.equal(rk, fr.data)
    emits = int(total > 0)                 # no pairs, no emit launch
    assert join_cuda.LARGE_LAUNCHES == {"build": 1, "count": 1,
                                        "emit": emits, "exists": 0,
                                        "capped": 0}
    with pytest.raises(ValueError, match="MAX_BUILD"):
        join_cuda.build_table_cuda(
            [Column.from_numpy(np.zeros(join_cuda.MAX_BUILD + 1, np.int64),
                               tdt.INT64, device="cuda")],
            join_cuda.MAX_CAPACITY)


def test_large_route_joins_on_three_streams_at_once():
    """Large-route joins from three threads, each on its own stream: each
    call's build and probes keep their state in its own scratch, so the
    calls share no device state and every map equals the sort-based
    join's."""
    _need_card()
    import threading
    lc, rc = _large_case("inventory", np.random.default_rng(22))
    fl, fr = join.inner_join(lc, rc)
    torch.cuda.synchronize()
    bad = []

    def run():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for _ in range(10):
                lm, rm = join_cuda.inner_join_hash(lc, rc)
                s.synchronize()
                if not (torch.equal(lm.data, fl.data)
                        and torch.equal(rm.data, fr.data)):
                    bad.append("maps differ")

    threads = [threading.Thread(target=run) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not bad


@pytest.mark.parametrize("groups", [1, 3, 1000])
def test_segment_sum_kernel_equals_the_cpu_fold(groups):
    """Keyed float sums on the card: the kernel's bits equal the plain
    version's row-order fold on the CPU, run after run."""
    _need_card()
    from spark_rapids_tpu_torch.ops import segment_sum_cuda as ss
    rng = np.random.default_rng(groups)
    n = 1_000_003
    seg = torch.from_numpy(np.sort(rng.integers(0, groups, n)))
    v = torch.from_numpy(rng.standard_normal(n) *
                         10.0 ** rng.integers(-8, 12, n))
    starts = torch.searchsorted(seg, torch.arange(groups))
    want = ss.segment_sum_plain(v, seg, groups)
    for _ in range(2):
        got = ss.segment_sum_cuda(v.cuda(), starts.cuda()).cpu()
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_float_aggregates_on_the_card_equal_the_cpu():
    """Keyed and keyless float sums, means, mins and maxes on the card give
    the CPU run's bits."""
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate
    rng = np.random.default_rng(5)
    n = 200_003
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 12, n)
    vals[::997] = -0.0
    t = Table([Column.from_numpy(rng.integers(0, 7, n).astype(np.int64),
                                 tdt.INT64, device="cpu"),
               Column.from_numpy(vals, tdt.FLOAT64, rng.random(n) > 0.1,
                                 device="cpu")], ["g", "x"])
    aggs = [("x", "sum"), ("x", "mean"), ("x", "min"), ("x", "max")]
    cpu = aggregate.groupby_aggregate(t, ["g"], aggs)
    card = aggregate.groupby_aggregate(t.to("cuda"), ["g"], aggs)
    _same_table(card.to("cpu"), cpu)
    from spark_rapids_tpu_torch.plan import PlanBuilder
    plan = (PlanBuilder().scan("t", schema=["g", "x"])
            .aggregate([], [("x", "sum", "s"), ("x", "min", "lo"),
                            ("x", "max", "hi")]).build())
    want = PlanExecutor(device="cpu", optimize=False).execute(
        plan, {"t": t}).table
    got = PlanExecutor(optimize=False).execute(plan, {"t": t}).table
    _same_table(got.to("cpu"), want)


@pytest.mark.parametrize("optimize", [False, True])
def test_q72_on_the_card_uses_the_large_route(optimize):
    _need_card()
    from spark_rapids_tpu_torch import nds_q72
    inputs = nds_q72.q72_inputs(300_000, device="cpu")
    join_cuda.reset_counters()
    res = PlanExecutor(optimize=optimize).execute(nds_q72.q72_plan(), inputs)
    assert join_cuda.LAUNCHES == {"build": 5, "count": 5,
                                  "emit": 5, "exists": 0, "capped": 0}
    assert join_cuda.LARGE_LAUNCHES == {"build": 1, "count": 1,
                                        "emit": 1, "exists": 0, "capped": 0}
    assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                     "emit": 0, "exists": 0, "capped": 0}
    cpu = PlanExecutor(device="cpu", optimize=optimize).execute(
        nds_q72.q72_plan(), inputs)
    _same_table(res.table.to("cpu"), cpu.table)


@pytest.mark.parametrize("nr", [20, 700, 52_000])
def test_capped_join_kernel_equals_plain_version(nr):
    """The capped join's kernels (small route at 20 build rows, large at
    700 and 52,000) against the sort-based capped join, all four outputs
    bit for bit, with alive masks, at caps 0, 1, total - 1, total, total +
    1 and roomy."""
    _need_card()
    rng = np.random.default_rng(nr)
    nl = 300_001
    lk = [Column.from_numpy(rng.integers(0, nr, nl).astype(np.int64),
                            tdt.INT64, rng.random(nl) > 0.05,
                            device="cuda")]
    rk = [Column.from_numpy(rng.integers(0, nr, nr).astype(np.int64),
                            tdt.INT64, device="cuda")]
    la = torch.from_numpy(rng.random(nl) > 0.3).cuda()
    ra = torch.from_numpy(rng.random(nr) > 0.5).cuda()
    roomy = 4 * nl
    total = int(join.inner_join_capped(lk, rk, roomy, lalive=la,
                                       ralive=ra)[2].sum())
    for cap in (0, 1, total - 1, total, total + 1, roomy):
        join_cuda.reset_counters()
        got = join_cuda.inner_join_capped_hash(lk, rk, cap, lalive=la,
                                               ralive=ra)
        want = join.inner_join_capped(lk, rk, cap, lalive=la, ralive=ra)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), cap
        assert (join_cuda.LAUNCHES["capped"], join_cuda.LAUNCHES["count"],
                join_cuda.LAUNCHES["emit"]) == (1, 0, 0)
        assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                         "emit": 0, "exists": 0, "capped": 0}


@pytest.mark.parametrize("share", [0.6, 0.0, 1.0])
def test_capped_topk_kernel_equals_plain_version(share):
    """The capped TopK's kernels, both routes, against its plain version:
    the k-row table and its alive mask."""
    _need_card()
    rng = np.random.default_rng(3)
    n = 500_003
    t = Table([Column.from_numpy(rng.integers(-999, 999, n)
                                 .astype(np.int64), tdt.INT64,
                                 rng.random(n) > 0.1, device="cuda"),
               Column.from_numpy(rng.standard_normal(n).astype(np.float32),
                                 tdt.FLOAT32, device="cuda")], ["k", "v"])
    alive = torch.from_numpy(rng.random(n) < share).cuda()
    for k in (1, 100, 4099):
        topk_cuda.reset_counters()
        got = topk_cuda.topk_capped(t, ["k", "v"], [False, True], k, alive)
        want = topk.topk_capped_plain(t, ["k", "v"], [False, True], k,
                                      alive)
        _same_table(got[0].to("cpu"), want[0].to("cpu"))
        assert torch.equal(got[1], want[1])
        assert sum(topk_cuda.LAUNCHES.values()) >= 1
        assert topk_cuda.LAUNCHES["threshold"] == (k < 4099)


@pytest.mark.parametrize("case", ["many_to_many", "all_dead", "float_keys",
                                  "one_live_row"])
def test_capped_probe_edges_equal_plain_version(case):
    """The capped probe (one launch: look-back offsets, every slot written)
    against the sort-based capped join: a key of 300 build rows whose
    pairs cross tiles and segments, every row dead, FLOAT64 keys (the
    variable-width instantiation), one live probe row; caps at the total,
    + 1 and half of it."""
    _need_card()
    rng = np.random.default_rng(17)
    nl, nr = 70_001, 900
    kind, dt = (np.float64, tdt.FLOAT64) if case == "float_keys" else \
        (np.int64, tdt.INT64)
    pk = rng.integers(0, 3 if case == "many_to_many" else nr, nl)
    bk = rng.integers(0, 3 if case == "many_to_many" else nr, nr)
    lk = [Column.from_numpy(pk.astype(kind), dt, device="cuda")]
    rk = [Column.from_numpy(bk.astype(kind), dt, device="cuda")]
    la = torch.from_numpy(rng.random(nl) < (0.01 if case == "many_to_many"
                                            else 0.5)).cuda()
    if case == "all_dead":
        la.zero_()
    if case == "one_live_row":
        la.zero_()
        la[nl // 2] = True
    ra = torch.ones(nr, dtype=torch.bool, device="cuda")
    total = int(join.inner_join_capped(lk, rk, 4 * nl * 3, lalive=la,
                                       ralive=ra)[2].sum())
    for cap in sorted({total, total + 1, total // 2}):
        got = join_cuda.inner_join_capped_hash(lk, rk, cap, lalive=la,
                                               ralive=ra)
        want = join.inner_join_capped(lk, rk, cap, lalive=la, ralive=ra)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (case, cap)


def test_capped_topk_decimal_keys_and_few_live_rows():
    """The capped TopK's variable-width kernels (a DECIMAL128 key) on both
    routes, with fewer live rows than k, against the plain version."""
    _need_card()
    rng = np.random.default_rng(19)
    n = 200_003
    dec = [int(v) * 10 ** 20 + int(w) for v, w in
           zip(rng.integers(-10 ** 9, 10 ** 9, n), rng.integers(0, 99, n))]
    t = Table([Column.from_pylist(dec, tdt.decimal(38, 2), device="cuda"),
               Column.from_numpy(rng.integers(0, 9, n).astype(np.int32),
                                 tdt.INT32, device="cuda")], ["d", "i"])
    alive = torch.from_numpy(rng.random(n) < 0.0003).cuda()
    for k in (50, 4099):
        got = topk_cuda.topk_capped(t, ["d", "i"], [True, False], k, alive)
        want = topk.topk_capped_plain(t, ["d", "i"], [True, False], k, alive)
        _same_table(got[0].to("cpu"), want[0].to("cpu"))
        assert torch.equal(got[1], want[1])


def test_capped_plans_on_the_card_use_the_kernels():
    """TPC-DS q3 and q72 through `PlanExecutor(mode="capped")` on the card:
    every inner join on the capped kernels, the TopK on its kernel, no
    plain version, `compact()` equal to the eager run."""
    _need_card()
    from spark_rapids_tpu_torch import nds_q72
    for plan, inputs in ((nds_q3.q3_tpcds_plan(),
                          nds_q3.q3_tpcds_inputs(300_000, device="cuda")),
                         (nds_q72.q72_plan(),
                          nds_q72.q72_inputs(300_000, device="cuda"))):
        join_cuda.reset_counters()
        topk_cuda.reset_counters()
        res = PlanExecutor(mode="capped").execute(plan, inputs)
        n = sum(m.kind == "HashJoin" for m in res.metrics.values())
        assert res.attempts == 1
        assert (join_cuda.LAUNCHES["capped"], join_cuda.LAUNCHES["count"],
                join_cuda.LAUNCHES["emit"]) == (n, 0, 0)
        assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                         "emit": 0, "exists": 0, "capped": 0}
        assert topk_cuda.PLAIN_CALLS == {"topk": 0}
        eager = PlanExecutor().execute(plan, inputs)
        _same_table(res.compact().to("cpu"), eager.table.to("cpu"))


def test_union_and_scalar_aggregates_on_the_card_equal_the_cpu():
    """`concat_tables` with mixed validity and `ScalarAgg` (max, min, sum
    over INT64 and FLOAT64, every row and the live ones) on CUDA tensors
    give the CPU's bits."""
    _need_card()
    from spark_rapids_tpu_torch import table_from_numpy
    from spark_rapids_tpu_torch.ops import copying
    from spark_rapids_tpu_torch.plan import expr
    rng = np.random.default_rng(8)
    n = 100_003
    parts = []
    for i, m in enumerate((n, 17, 4096)):
        vals = [rng.integers(-2**40, 2**40, m).astype(np.int64),
                rng.standard_normal(m) * 10.0 ** rng.integers(-8, 17, m)]
        valid = [rng.random(m) > 0.2 if i == 1 else None, None]
        parts.append((vals, valid))
    for dev in ("cpu", "cuda"):
        tables = [table_from_numpy(["a", "v"], v, va, ["int64", "float64"],
                                   device=dev) for v, va in parts]
        got = copying.concat_tables(tables)
        if dev == "cpu":
            want = got
    assert got.device.type == "cuda"
    _same_table(got.to("cpu"), want)
    alive = torch.from_numpy(rng.random(want.num_rows) < 0.6)
    for name in ("a", "v"):
        for op in ("max", "min", "sum"):
            e = expr.ScalarAgg(op, expr.col(name))
            for mask in (None, alive):
                c = e.evaluate(want, mask)
                g = e.evaluate(got, None if mask is None else mask.cuda())
                assert g.device.type == "cuda" and g.dim() == 0
                assert g.cpu().reshape(1).view(torch.uint8).tolist() == \
                    c.reshape(1).view(torch.uint8).tolist(), (name, op)


@pytest.mark.parametrize("q", ["q5", "q23"])
def test_q5_q23_on_the_card_equal_the_cpu(q):
    """Both NDS plans, eager and capped, authored and optimized, on the
    card: the keyed aggregates on the groupby kernel and every semi join on
    the hash join's build and existence probe, no plain version run, and
    every result equal to the CPU run."""
    _need_card()
    from spark_rapids_tpu_torch import nds_q5, nds_q23
    mod = {"q5": nds_q5, "q23": nds_q23}[q]
    plan = getattr(mod, f"{q}_plan")()
    make = getattr(mod, f"{q}_inputs")
    inputs = make(60_000, device="cuda")
    cpu_inputs = make(60_000, device="cpu")
    semis = {"q5": 3, "q23": 4}[q]
    for mode in ("eager", "capped"):
        for optimize in (False, True):
            join_cuda.reset_counters()
            select_cuda.reset_counters()
            topk_cuda.reset_counters()
            res = PlanExecutor(mode=mode, optimize=optimize).execute(
                plan, inputs)
            want = PlanExecutor(mode=mode, device="cpu",
                                optimize=optimize).execute(plan, cpu_inputs)
            _same_table(res.compact().to("cpu"), want.compact())
            assert join_cuda.LAUNCHES == {"build": semis, "count": 0,
                                          "emit": 0, "exists": semis,
                                          "capped": 0}
            assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                             "emit": 0, "exists": 0,
                                             "capped": 0}
            assert sum(select_cuda.LAUNCHES.values()) == 0
            assert sum(topk_cuda.LAUNCHES.values()) == 0
            # the keyed aggregates and the semi joins are the kernels here
            assert {m.kernel for m in res.metrics.values()
                    if m.kernel.startswith("cuda:")} == {"cuda:groupby",
                                                         "cuda:hash_join"}


def test_capped_q23_reads_the_host_attempts_plus_one():
    """A warm capped q23 (a scalar subquery, shared subqueries, a Union)
    reads the card at most once an attempt and once for the counts."""
    _need_card()
    import warnings
    from spark_rapids_tpu_torch import nds_q23
    inputs = nds_q23.q23_inputs(60_000, device="cuda")
    ex = PlanExecutor(mode="capped", caps={"key_cap": 8192})
    ex.execute(nds_q23.q23_plan(), inputs)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = ex.execute(nds_q23.q23_plan(), inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert res.attempts == 1
    assert len(synced) <= res.attempts + 1, [
        f"{w.filename}:{w.lineno}" for w in synced]


def _groupby_table(rng, n, groups, null_p):
    """Key "k" and one value column per kind the groupby kernel reads, with
    nulls (an all-null group every third key in "i64"), and every op."""
    keys = rng.integers(0, groups, n).astype(np.int64)
    cols = [Column.from_numpy(keys, tdt.INT64, device="cpu")]
    names, aggs = ["k"], [("k", "size")]
    for name, npt, dtype in (("i8", np.int8, tdt.INT8),
                             ("i16", np.int16, tdt.INT16),
                             ("i32", np.int32, tdt.INT32),
                             ("i64", np.int64, tdt.INT64),
                             ("f32", np.float32, tdt.FLOAT32),
                             ("f64", np.float64, tdt.FLOAT64),
                             ("d32", np.int32, tdt.DATE32),
                             ("ts", np.int64, tdt.TIMESTAMP_US)):
        if npt in (np.float32, np.float64):
            v = np.where(rng.random(n) < 0.2,
                         rng.choice(np.array([-0.0, 0.0, np.nan, np.inf,
                                              -np.inf]), n),
                         rng.standard_normal(n) * 1e6).astype(npt)
        else:
            info = np.iinfo(npt)
            v = rng.integers(info.min, info.max, n, dtype=np.int64,
                             endpoint=True).astype(npt)
        valid = rng.random(n) >= null_p
        if name == "i64":
            valid &= keys % 3 != 0
        cols.append(Column.from_numpy(v, dtype, valid, device="cpu"))
        names.append(name)
        aggs += [(name, op) for op in ("count", "min", "max", "mean")]
        if name not in ("d32", "ts"):
            aggs.append((name, "sum"))
    return Table(cols, names), aggs


def _same_bits(got, want):
    assert got.names == want.names and got.num_rows == want.num_rows
    for a, b in zip(got.columns, want.columns):
        da, db = a.data, b.data
        if da.is_floating_point():
            bits = torch.int32 if da.dtype == torch.float32 else torch.int64
            da, db = da.view(bits), db.view(bits)
        assert torch.equal(da, db)
        assert (a.validity is None) == (b.validity is None)
        if a.validity is not None:
            assert torch.equal(a.validity, b.validity)


@pytest.mark.parametrize("n,groups", [(1, 1), (2047, 1), (2049, 40),
                                      (100_003, 3), (100_003, 50_000)])
@pytest.mark.parametrize("null_p", [0.0, 0.3])
def test_groupby_kernel_equals_the_plain_version(n, groups, null_p):
    """Every op on eight kinds, eager and capped (key_cap below and above
    the group count, an alive mask): the kernel's bits equal the plain
    version's on the CPU, one launch a call."""
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate, groupby_cuda
    rng = np.random.default_rng(n + groups)
    t, aggs = _groupby_table(rng, n, groups, null_p)
    g = t.to("cuda")
    groupby_cuda.reset_counters()
    _same_bits(aggregate.groupby_aggregate(g, ["k"], aggs).to("cpu"),
               aggregate.groupby_aggregate(t, ["k"], aggs))
    alive = torch.from_numpy(rng.random(n) < 0.6)
    for cap in (max(groups // 2, 1), groups + 3):
        got = aggregate.groupby_aggregate_capped(g, ["k"], aggs, cap,
                                                 alive.cuda())
        want = aggregate.groupby_aggregate_capped(t, ["k"], aggs, cap, alive)
        _same_bits(got[0].to("cpu"), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu(), want[2])
    assert groupby_cuda.LAUNCHES["groupby"] == 3
    assert groupby_cuda.PLAIN_CALLS == {"groupby": 0}


def _nan_payload_table(rng):
    """Groups whose float sums end NaN with distinct payloads and both
    signs: short groups (a thread a group) and long ones (a warp pair,
    several staged chunks), float64 and float32 values, and groups whose
    only NaN is inf - inf."""
    sizes = [5, 4, 3, 4, 40, 1500, 700, 33]
    n = sum(sizes)
    k = np.repeat(np.arange(len(sizes)), sizes).astype(np.int64)
    x = rng.standard_normal(n)
    f = rng.standard_normal(n).astype(np.float32)
    xb, fb = x.view(np.uint64), f.view(np.uint32)
    for lo, hi in zip(np.cumsum([0] + sizes[:-1]), np.cumsum(sizes)):
        at = rng.choice(np.arange(lo, hi), min(hi - lo, 6), replace=False)
        xb[at] = (np.uint64(0x7FF0000000000000)
                  | rng.integers(1, 1 << 51, at.size).astype(np.uint64)
                  | (rng.integers(0, 2, at.size).astype(np.uint64) << 63))
        fb[at] = (np.uint32(0x7F800000)
                  | rng.integers(1, 1 << 22, at.size).astype(np.uint32)
                  | (rng.integers(0, 2, at.size).astype(np.uint32) << 31))
    for g in (2, 7):                          # inf - inf, no NaN value
        lo = sum(sizes[:g])
        x[lo:lo + sizes[g]] = np.where(np.arange(sizes[g]) % 2, np.inf,
                                       -np.inf)
    valid = rng.random(n) >= 0.1
    t = Table([Column.from_numpy(k, tdt.INT64, device="cpu"),
               Column.from_numpy(x, tdt.FLOAT64, valid, device="cpu"),
               Column.from_numpy(f, tdt.FLOAT32, device="cpu")],
              ["k", "x", "f"])
    return t, [("x", "sum"), ("x", "mean"), ("f", "sum"), ("f", "mean")]


def test_groupby_fold_nan_bits_equal_the_cpu():
    """Folds that end NaN, on distinct payloads that tell the first NaN
    from the last: the kernel's bits equal the plain version's on the CPU,
    eager and capped."""
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate
    t, aggs = _nan_payload_table(np.random.default_rng(17))
    g = t.to("cuda")
    _same_bits(aggregate.groupby_aggregate(g, ["k"], aggs).to("cpu"),
               aggregate.groupby_aggregate(t, ["k"], aggs))
    alive = torch.from_numpy(np.random.default_rng(18).random(t.num_rows)
                             < 0.8)
    got = aggregate.groupby_aggregate_capped(g, ["k"], aggs, 6, alive.cuda())
    want = aggregate.groupby_aggregate_capped(t, ["k"], aggs, 6, alive)
    _same_bits(got[0].to("cpu"), want[0])
    assert torch.equal(got[1].cpu(), want[1])


_GB_WORDS = ["", "a", "a\x00", "ab", "abcdefgh", "abcdefghi", "日本",
             "pre_12", "Z"]
_GB_DECS = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64, -2 ** 64, 7]
_GB_NANS = {np.float32: (np.uint32, [0x7FC00000, 0x7F800123, 0xFFC00042]),
            np.float64: (np.uint64, [0x7FF8000000000000, 0x7FF0000000000123,
                                     0xFFF8000000000456])}
_GB_KEY_KINDS = {"bool": (np.bool_, tdt.BOOL), "int8": (np.int8, tdt.INT8),
                 "int16": (np.int16, tdt.INT16),
                 "int32": (np.int32, tdt.INT32),
                 "int64": (np.int64, tdt.INT64),
                 "date32": (np.int32, tdt.DATE32),
                 "timestamp": (np.int64, tdt.TIMESTAMP_US),
                 "float32": (np.float32, tdt.FLOAT32),
                 "float64": (np.float64, tdt.FLOAT64),
                 "decimal128": (None, tdt.decimal(38, 2)),
                 "string": (None, tdt.STRING)}


def _gb_key(rng, kind, n, null_p, groups):
    """A key column of `kind` on the CPU with about `groups` distinct
    values: both zeros, NaN payloads and infinities among the floats,
    empty strings, nulls at null_p."""
    npt, dtype = _GB_KEY_KINDS[kind]
    valid = rng.random(n) >= null_p
    if kind in ("string", "decimal128"):
        base = _GB_WORDS if kind == "string" else _GB_DECS
        pool = base + [(f"k{i:07d}" if kind == "string" else i * 10 ** 20)
                       for i in range(max(groups - len(base), 0))]
        idx = rng.integers(0, len(pool), n)
        return Column.from_pylist([pool[i] if v else None
                                   for i, v in zip(idx, valid)], dtype,
                                  device="cpu")
    if kind == "bool":
        a = rng.random(n) < 0.5
    elif npt in _GB_NANS:
        ut, bits = _GB_NANS[npt]
        special = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf],
                                           npt),
                                  np.array(bits, ut).view(npt)])
        pool = np.concatenate([special, np.arange(groups, dtype=npt)])
        a = pool[rng.integers(0, pool.size, n)]
    else:
        info = np.iinfo(npt)
        pool = np.concatenate([np.array([info.min, info.max], npt),
                               np.arange(groups, dtype=npt)])
        a = pool[rng.integers(0, pool.size, n)]
    return Column.from_numpy(a, dtype, None if valid.all() else valid,
                             device="cpu")


def _gb_key_case(keys, n, strings, rng):
    """Keys and value columns (INT64, FLOAT64, STRING for min/max) and
    their aggregations."""
    v = Column.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n), tdt.INT64,
                          rng.random(n) >= 0.2, device="cpu")
    x = Column.from_numpy(rng.standard_normal(n), tdt.FLOAT64,
                          rng.random(n) >= 0.2, device="cpu")
    cols, names = list(keys) + [v, x], [f"k{i}" for i in range(len(keys))]
    names += ["v", "x"]
    aggs = [("v", "sum"), ("v", "min"), ("v", "max"), ("v", "count"),
            ("x", "sum"), ("x", "mean"), ("v", "size")]
    if strings:
        idx = rng.integers(0, len(_GB_WORDS), n)
        ok = rng.random(n) >= 0.3
        cols.append(Column.from_pylist([_GB_WORDS[i] if o else None
                                        for i, o in zip(idx, ok)],
                                       tdt.STRING, device="cpu"))
        names.append("s")
        aggs += [("s", "min"), ("s", "max")]
    return Table(cols, names), aggs


@pytest.mark.parametrize("kinds", [["bool"], ["int8"], ["int16"], ["int32"],
                                   ["int64"], ["date32"], ["timestamp"],
                                   ["float32"], ["float64"], ["decimal128"],
                                   ["string"],
                                   ["int32", "string", "float64"],
                                   ["int16", "decimal128", "float32"]])
@pytest.mark.parametrize("n,groups", [(1, 1), (2049, 40), (100_003, 6_000)])
def test_groupby_key_kinds_equal_the_plain_version(kinds, n, groups):
    """The hash kernels on every key kind, one and three key columns, with
    nulls: bits equal to the plain version's on the CPU, eager (with
    string min/max) and capped (fixed-width keys; key_cap below and above
    the live group count, an alive mask)."""
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate, groupby_cuda
    rng = np.random.default_rng(n + groups + len(kinds))
    keys = [_gb_key(rng, k, n, 0.2, groups) for k in kinds]
    names = [f"k{i}" for i in range(len(kinds))]
    t, aggs = _gb_key_case(keys, n, True, rng)
    groupby_cuda.reset_counters()
    _same_bits(aggregate.groupby_aggregate(t.to("cuda"), names, aggs)
               .to("cpu"), aggregate.groupby_aggregate(t, names, aggs))
    if "string" not in kinds:
        t, aggs = _gb_key_case(keys, n, False, rng)
        alive = torch.from_numpy(rng.random(n) < 0.6)
        live = int(aggregate.groupby_aggregate_capped(
            t, names, [("v", "size")], n, alive)[1].sum())
        for cap in (max(live // 2, 1), live + 3):
            got = aggregate.groupby_aggregate_capped(t.to("cuda"), names,
                                                     aggs, cap, alive.cuda())
            want = aggregate.groupby_aggregate_capped(t, names, aggs, cap,
                                                      alive)
            _same_bits(got[0].to("cpu"), want[0])
            assert torch.equal(got[1].cpu(), want[1])
            assert torch.equal(got[2].cpu(), want[2])
    assert groupby_cuda.PLAIN_CALLS == {"groupby": 0}


@pytest.mark.parametrize("dist", ["one group", "zipf", "distinct"])
def test_groupby_skew_routes_equal_the_plain_version(dist):
    """One group (every row on one rank), q23's zipf(1.3) skew and
    all-distinct keys at 200,003 rows: the shared-memory route, and the
    global route where the groups do not fit, equal the plain version."""
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate
    rng = np.random.default_rng(31)
    n = 200_003
    k = {"one group": np.zeros(n, np.int64),
         "zipf": (rng.zipf(1.3, n) % 2000).astype(np.int64),
         "distinct": rng.permutation(n).astype(np.int64)}[dist]
    t, aggs = _gb_key_case([Column.from_numpy(k, tdt.INT64, device="cpu")],
                           n, False, rng)
    _same_bits(aggregate.groupby_aggregate(t.to("cuda"), ["k0"], aggs)
               .to("cpu"), aggregate.groupby_aggregate(t, ["k0"], aggs))
    alive = torch.from_numpy(rng.random(n) < 0.7)
    for cap in (1000, n):
        got = aggregate.groupby_aggregate_capped(t.to("cuda"), ["k0"], aggs,
                                                 cap, alive.cuda())
        want = aggregate.groupby_aggregate_capped(t, ["k0"], aggs, cap, alive)
        _same_bits(got[0].to("cpu"), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu(), want[2])


def test_groupby_forced_plain_raises_on_the_card(monkeypatch):
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate
    from spark_rapids_tpu_torch.ops.registry import KernelDeclinedError
    t = Table([Column.from_numpy(np.arange(10, dtype=np.int64), tdt.INT64,
                                 device="cuda")], ["k"])
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "groupby=torch")
    with pytest.raises(KernelDeclinedError):
        aggregate.groupby_aggregate(t, ["k"], [("k", "sum")])


# ---- the decimal kernel ------------------------------------------------------

# (op, a scale, b scale, output scale, flag): every branch of
# csrc/decimal128.cu (divide's three n_shift_exp branches, the remainder's
# d_shift_exp ones, the interim rounding, the integer divide)
_DEC_CASES = [
    ("add", 2, 2, 2, False), ("add", 2, 5, 5, False), ("add", 10, 3, 6, False),
    ("sub", 2, 5, 3, True), ("multiply", 2, 2, 4, True),
    ("multiply", 10, 10, 6, True), ("multiply", 10, 10, 6, False),
    ("multiply", 0, 0, 2, True), ("multiply", 3, 2, 1, True),
    ("divide", 10, 2, 2, False), ("divide", 0, 38, 6, False),
    ("divide", 10, 10, 6, False), ("divide", 2, 2, 0, False),
    ("divide", 2, 2, 0, True), ("divide", 4, 1, 0, True),
    ("divide", 0, 38, 6, True), ("remainder", 2, 5, 3, False),
    ("remainder", 2, 1, 3, False), ("remainder", 1, 1, 1, False),
    ("remainder", 0, 5, 3, False)]


def _dec_column(rng, n, scale, zero_every=0):
    """Random DECIMAL128 limbs: 38-digit values, small ones and the 128-bit
    edges, nulls in one row of ten, every `zero_every`-th value 0."""
    big = [int(x) * 10**20 + int(y) for x, y in zip(
        rng.integers(-(10**18), 10**18, n), rng.integers(0, 10**18, n))]
    small = rng.integers(-(10**6), 10**6, n)
    pick = rng.random(n)
    edges = [0, 1, -1, 10**38 - 1, -(10**38 - 1), 10**38, 2**127 - 1,
             -(2**127)]
    vals = [edges[i % len(edges)] if p < 0.1 else
            (big[i] if p < 0.6 else int(small[i]))
            for i, p in enumerate(pick)]
    if zero_every:
        vals[::zero_every] = [0] * len(vals[::zero_every])
    limbs = Column.from_pylist(vals, tdt.decimal(38, 0), device="cpu").data
    return Column.from_numpy(limbs.numpy(),
                             tdt.DType(tdt.Kind.DECIMAL128, 38, scale),
                             rng.random(n) > 0.1, device="cuda")


def _limb_bits(t):
    """uint32 limbs compared by their int32 bits (torch's CUDA ops take few
    unsigned dtypes)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


@pytest.mark.parametrize("op,sa,sb,so,flag", _DEC_CASES)
def test_decimal_kernel_equals_plain_version(op, sa, sb, so, flag):
    """Every row, null ones too, bit for bit: the result limbs (or INT64),
    the overflow flags and the validity; the entry points launch the kernel
    once and never run the plain version on CUDA tensors."""
    _need_card()
    from spark_rapids_tpu_torch.ops import decimal_utils as du
    rng = np.random.default_rng(_DEC_CASES.index((op, sa, sb, so, flag)))
    n = 20_011
    a, b = _dec_column(rng, n, sa), _dec_column(rng, n, sb, zero_every=9)
    du.reset_counters()
    got = du.decimal128_op(op, a, b, so, flag)
    torch.cuda.synchronize()
    assert sum(du.LAUNCHES.values()) == 1
    assert sum(du.PLAIN_CALLS.values()) == 0
    want = du.decimal128_op(op, a, b, so, flag, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(_limb_bits(g.data), _limb_bits(w.data))
        assert torch.equal(g.validity, w.validity)


def test_decimal_entry_on_the_card():
    """The entry step at 4,096 rows: two row-hash launches and one decimal
    launch, equal to the CPU run."""
    _need_card()
    from spark_rapids_tpu_torch.entry import entry
    from spark_rapids_tpu_torch.ops import decimal_utils as du
    step, (keys, vals) = entry()
    assert keys.is_cuda
    du.reset_counters()
    hash_cuda.reset_counters()
    got = step(keys, vals)
    torch.cuda.synchronize()
    assert du.LAUNCHES["multiply"] == 1 and sum(du.PLAIN_CALLS.values()) == 0
    assert hash_cuda.LAUNCHES["murmur"] == 1 and \
        hash_cuda.LAUNCHES["xxhash"] == 1
    want = step(keys.cpu(), vals.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_decimal_failed_build_raises(monkeypatch):
    """A build that fails raises from the entry point; nothing falls back
    to the plain version."""
    _need_card()
    from spark_rapids_tpu_torch.ops import cuda_build, decimal_cuda
    from spark_rapids_tpu_torch.ops import decimal_utils as du

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(cuda_build, "load", broken)
    monkeypatch.setattr(decimal_cuda, "_LIB", None)
    a = _dec_column(np.random.default_rng(3), 100, 2)
    du.reset_counters()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        du.multiply_decimal128(a, a, 4)
    assert sum(du.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("mode", ["eager", "capped"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decimal_payload_through_a_plan_on_the_card(mode, optimize):
    """A DECIMAL128 payload rides through a Filter (FusedSelect when
    optimized), a HashJoin and a Sort on the card, its limbs gathered as
    int32 bits; the values equal the CPU run's, row for row."""
    _need_card()
    from spark_rapids_tpu_torch.plan import PlanBuilder
    n = 5_000
    rng = np.random.default_rng(0)
    vals = [int(x) * 10**20 + 7 if i % 5 else None
            for i, x in enumerate(rng.integers(-(10**17), 10**17, n))]
    vals[1], vals[2] = 10**38 - 1, -(10**38 - 1)

    def tables(device):
        fact = Table([
            Column.from_numpy(np.arange(n, dtype=np.int64) % 7, tdt.INT64,
                              device=device),
            Column.from_numpy(np.arange(n, dtype=np.int64), tdt.INT64,
                              device=device),
            Column.from_pylist(vals, tdt.decimal(38, 2), device=device)],
            ["k", "x", "amt"])
        dim = Table([Column.from_numpy(np.arange(0, 7, 2, dtype=np.int64),
                                       tdt.INT64, device=device)], ["dk"])
        return {"f": fact, "d": dim}
    b = PlanBuilder()
    plan = (b.scan("f", ["k", "x", "amt"]).filter(col("x") > lit(0))
            .join(b.scan("d", ["dk"]), "k", "dk").sort(["x"]).build())
    res = PlanExecutor(mode=mode, optimize=optimize).execute(
        plan, tables("cuda"))
    want = PlanExecutor(mode=mode, device="cpu", optimize=optimize).execute(
        plan, tables("cpu"))
    got = res.compact()["amt"]
    assert got.data.is_cuda and got.dtype == tdt.decimal(38, 2)
    assert got.to_pylist() == want.compact()["amt"].to_pylist()
    assert got.to_pylist() == [vals[x] for x in range(1, n)
                               if (x % 7) % 2 == 0]


def test_bool_times_float_select_on_the_card():
    """Queue C6 in the FusedSelect kernel: `*` of a bool and a float is
    where(b, x, +0.0) (FLAG_SEL_L/R), so False times NaN, ±inf and -0.0 is
    +0.0 and True times x is x, in FLOAT64 and FLOAT32, with the bool on
    either side and as a literal; the kernel's rows equal the plain
    version's (held against JAX in tests/test_torch_select.py)."""
    _need_card()
    n = 4_099
    rng = np.random.default_rng(6)
    edges = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5])
    f = rng.choice(edges, n)
    b = rng.integers(0, 2, n).astype(bool)
    t = Table([Column.from_numpy(b, tdt.BOOL, device="cuda"),
               Column.from_numpy(f, tdt.FLOAT64, device="cuda"),
               Column.from_numpy(f.astype(np.float32), tdt.FLOAT32,
                                 device="cuda"),
               Column.from_numpy(np.arange(n, dtype=np.int64), tdt.INT64,
                                 device="cuda")], ["b", "f", "g", "i"])
    preds = [col("b") * col("f") == 0.0,
             col("f") * col("b") <= lit(0.0),
             col("b") * col("g") == 0.0,
             col("g") * col("b") + 1.0 > 0,
             lit(False) * col("f") == 0.0,
             col("f") * lit(True) != col("f"),
             (col("b") * lit(float("nan"))) == 0.0]
    select_cuda.reset_counters()
    for pred in preds:
        got = select_cuda.fused_select_cuda(t, pred, ["i"])
        want = select.fused_select_plain(t, pred, ["i"])
        _same_table(got, want)
    # the select itself: every False row of b * f == 0.0 is kept
    kept = select_cuda.fused_select_cuda(t, col("b") * col("f") == 0.0,
                                         ["i"])["i"].data.cpu().numpy()
    expect = np.nonzero(~b | (f == 0.0))[0]
    assert np.array_equal(kept, expect)
    assert select_cuda.LAUNCHES["count"] == len(preds) + 1


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("fn", ["inner_join", "left_join", "full_join",
                                "left_semi_join", "left_anti_join",
                                "inner_join_capped", "left_join_capped",
                                "semi_join_mask"])
def test_outer_and_null_equal_joins_on_the_card_equal_the_cpu(fn,
                                                              null_equal):
    """The torch-op joins of ops/join.py on CUDA columns, with null keys
    and alive masks, equal their CPU run element for element (the CPU run
    is held against JAX in tests/test_torch_join.py)."""
    _need_card()
    rng = np.random.default_rng(21)
    nl, nr = 20_000, 1_000
    lk = rng.integers(0, 700, nl).astype(np.int64)
    rk = rng.integers(0, 900, nr).astype(np.int64)
    lv, rv = rng.random(nl) > 0.1, rng.random(nr) > 0.1
    la = torch.tensor(rng.random(nl) > 0.2)
    ra = torch.tensor(rng.random(nr) > 0.2)

    def run(device):
        l = [Column.from_numpy(lk, tdt.INT64, lv, device=device)]
        r = [Column.from_numpy(rk, tdt.INT64, rv, device=device)]
        f = getattr(join, fn)
        if fn.endswith("_capped"):
            out = f(l, r, 30_000, lalive=la.to(device), ralive=ra.to(device),
                    null_equal=null_equal)
        elif fn == "semi_join_mask":
            out = (f(l, r, lalive=la.to(device), ralive=ra.to(device),
                     null_equal=null_equal),)
        else:
            out = f(l, r, null_equal)
            out = out if isinstance(out, tuple) else (out,)
        return [o.data if isinstance(o, Column) else o for o in out]
    got, want = run("cuda"), run("cpu")
    for g, w in zip(got, want):
        assert g.is_cuda
        assert torch.equal(g.cpu(), w)


def test_scalar_subquery_predicates_on_the_card():
    """FusedSelect predicates with scalar aggregates (`ScalarAgg`): the
    kernel reads each as a one-value column reduced on the card before the
    launch, and equals the plain version; over an empty table both raise
    as `Expr.evaluate` does."""
    _need_card()
    from spark_rapids_tpu_torch.plan import scalar_max, scalar_min
    from spark_rapids_tpu_torch.plan import scalar_sum
    for n in (1, 1000, 100_003):
        t = _fs_table(n, 0.15)
        preds = [col("sel") > scalar_max(col("sel")) - 5,
                 col("float64") <= scalar_min(col("float64")) + 1.0,
                 col("float32") * 100.0 > scalar_sum(col("float32")),
                 col("int8") < scalar_sum(col("int8")),
                 scalar_max(col("bool")) & (col("sel") < 9),
                 col("int64") > lit(0.95) * scalar_max(col("int64")),
                 (col("sel") >= scalar_min(col("sel")))
                 & (col("sel") * 2 > scalar_max(col("sel") + 1))]
        select_cuda.reset_counters()
        for pred in preds:
            got = select_cuda.fused_select_cuda(t, pred, ["sel", "int64"])
            _same_table(got, select.fused_select_plain(t, pred,
                                                       ["sel", "int64"]))
        assert select_cuda.LAUNCHES["count"] == len(preds)
    empty = _fs_table(0, 0.0)
    pred = col("sel") > scalar_max(col("sel"))
    for fn in (select_cuda.fused_select_cuda, select.fused_select_plain):
        with pytest.raises(ValueError, match="zero-size"):
            fn(empty, pred, ["sel"])


# ---- the row hash's byte path and the row conversion --------------------------

def _byte_rows(rng, n, max_len, null_p):
    return [None if rng.random() < null_p else
            bytes(rng.integers(0, 256, int(rng.integers(0, max_len + 1)),
                               dtype=np.uint8))
            for _ in range(n)]


def _hash_byte_cases(n):
    """(what, columns on the card): strings at the tail and stripe edges,
    empty and all-null columns, DECIMAL128, structs and lists."""
    rng = np.random.default_rng(31)
    edge = [bytes(rng.integers(0, 256, k, dtype=np.uint8))
            for k in (0, 3, 4, 31, 32, 33)] * (n // 6 + 1)
    s = Column.from_pylist(edge[:n], tdt.STRING, device="cuda")
    r = Column.from_pylist(_byte_rows(rng, n, 80, 0.1), tdt.STRING,
                           device="cuda")
    decs = [None if rng.random() < 0.1 else
            int(rng.integers(-2**62, 2**62)) * int(rng.integers(1, 2**62))
            for _ in range(n)]
    d = Column.from_pylist(decs, tdt.decimal(38, 2), device="cuda")
    none = Column.from_pylist([None] * n, tdt.STRING, device="cuda")
    empty = Column.from_pylist([""] * n, tdt.STRING, device="cuda")
    i32 = Column.from_pylist([int(x) for x in rng.integers(-9, 9, n)],
                             tdt.INT32, device="cuda")
    st = Column.make_struct(torch.tensor(rng.random(n) > 0.2, device="cuda"),
                            a=i32, b=r)
    lens = rng.integers(0, 9, n)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32, device="cuda")
    m = int(lens.sum())
    li = Column.make_list(offs, Column.from_pylist(
        [None if k % 7 == 0 else k for k in range(m)], tdt.INT32,
        device="cuda"), torch.tensor(rng.random(n) > 0.1, device="cuda"))
    ls = Column.make_list(offs, Column.from_pylist(
        _byte_rows(rng, m, 40, 0.1), tdt.STRING, device="cuda"))
    ll = Column.make_list(torch.arange(0, n + 1, dtype=torch.int32,
                                       device="cuda"), li)
    return [("edge strings", [s]), ("random strings", [r]),
            ("decimal128", [d]), ("all null and empty", [none, empty]),
            ("mixed", [s, d, i32, r]), ("struct", [st]),
            ("list<int32>", [li]), ("list<string>", [ls]),
            ("list<list<int32>>", [ll, s]),
            ("41 columns", [s, d, i32, r, st] * 8 + [li])]


@pytest.mark.parametrize("n", [0, 1, 4099])
def test_row_hash_byte_path_equals_plain_version(n):
    _need_card()
    hash_cuda.reset_counters()
    for what, cols in _hash_byte_cases(n):
        nested = any(c.dtype.is_nested for c in cols)
        for seed in (0, 42):
            got = hash_cuda.murmur_hash3_32(cols, seed)
            assert torch.equal(got.data,
                               thash.murmur_hash3_32(cols, seed).data), what
            if nested:
                with pytest.raises(TypeError):
                    hash_cuda.xxhash64(cols, seed)
                continue
            assert torch.equal(hash_cuda.xxhash64(cols, seed).data,
                               thash.xxhash64(cols, seed).data), what
            m, x = hash_cuda.fused_row_hash(cols, seed)
            assert torch.equal(m.data, thash.murmur_hash3_32(cols,
                                                             seed).data)
            assert torch.equal(x.data, thash.xxhash64(cols).data)
    torch.cuda.synchronize()
    assert hash_cuda.PLAIN_CALLS == {"murmur": 0, "xxhash": 0, "fused": 0}
    assert (sum(hash_cuda.LAUNCHES.values()) > 0) == (n > 0)


def _bytes(t):
    """A tensor's bytes on the host (NaN payloads compare as bits)."""
    return t.cpu().numpy().tobytes()


def _rc_table(ncols, n, null_p, seed=0):
    rng = np.random.default_rng(seed)
    kinds = [(np.int8, tdt.INT8), (np.int16, tdt.INT16),
             (np.int32, tdt.INT32), (np.int64, tdt.INT64),
             (np.float32, tdt.FLOAT32), (np.float64, tdt.FLOAT64),
             (np.bool_, tdt.BOOL), (np.int32, tdt.DATE32),
             (np.int64, tdt.TIMESTAMP_US), (np.uint8, tdt.UINT8),
             (np.uint32, tdt.decimal(38, 4))]
    cols = []
    for i in range(ncols):
        npt, dt = kinds[i % len(kinds)]
        shape = (n, 4) if dt.kind == tdt.Kind.DECIMAL128 else (n,)
        a = rng.integers(0, 256, shape + (np.dtype(npt).itemsize,),
                         dtype=np.uint8).view(npt).reshape(shape)
        if npt is np.bool_:
            a = rng.random(n) > 0.5
        v = None
        if null_p == 1.0:
            v = np.zeros(n, bool)
        elif null_p and i % 2:
            v = rng.random(n) > null_p
        cols.append(Column.from_numpy(a, dt, v, device="cuda"))
    return Table(cols)


@pytest.mark.parametrize("ncols,n,null_p", [(1, 3001, 0.0), (9, 3001, 0.1),
                                            (17, 0, 0.1), (24, 1, 1.0),
                                            (24, 4099, 0.1),
                                            (216, 2048, 0.1)])
def test_row_conversion_kernels_equal_plain_version(ncols, n, null_p):
    from spark_rapids_tpu_torch.ops import row_conversion as rc
    from spark_rapids_tpu_torch.ops import row_conversion_cuda as rcc
    _need_card()
    t = _rc_table(ncols, n, null_p, seed=ncols)
    schema = [c.dtype for c in t.columns]
    rcc.reset_counters()
    (rows,) = rc.convert_to_rows(t)
    back = rc.convert_from_rows(rows, schema)
    torch.cuda.synchronize()
    assert rcc.PLAIN_CALLS == {"to_rows": 0, "from_rows": 0}
    assert rcc.LAUNCHES == ({"to_rows": 1, "from_rows": 1} if n else
                            {"to_rows": 0, "from_rows": 0})
    assert torch.equal(rows.children[0].data, rc.to_rows_plain(t))
    _, _, size = rc.row_layout(schema)
    want = rc.from_rows_plain(rows.children[0].data.reshape(-1, size),
                              schema)
    for got, w, orig in zip(back.columns, want.columns, t.columns):
        assert _bytes(got.data) == _bytes(w.data) == _bytes(orig.data)
        assert torch.equal(got.validity, w.validity)
        assert torch.equal(got.validity, orig.null_mask)


def test_row_conversion_forced_plain_raises_on_the_card(monkeypatch):
    from spark_rapids_tpu_torch.ops import row_conversion as rc
    from spark_rapids_tpu_torch.ops.registry import KernelDeclinedError
    _need_card()
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "row_conversion=torch")
    with pytest.raises(KernelDeclinedError):
        rc.convert_to_rows(_rc_table(3, 10, 0.0))


# ---- STRING, DECIMAL128 and float keys ----------------------------------------

def _key_column(kind, n, rng, null_p, device="cuda"):
    """A key column of a few values of `kind`, nulls at `null_p`: shared
    prefixes, multi-byte UTF-8 and empty strings; +-(10^38 - 1); +-0.0
    and NaN."""
    vals = {"string": ["", "a", "a\x00", "ab", "pre_1", "pre_12", "é",
                       "日本", "x" * 40],
            "decimal": [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64],
            "float32": [0.0, -0.0, float("nan"), 1.5, float("inf")],
            "float64": [0.0, -0.0, float("nan"), 1.5, float("-inf")]}[kind]
    dt = {"string": tdt.STRING, "decimal": tdt.decimal(38, 2),
          "float32": tdt.FLOAT32, "float64": tdt.FLOAT64}[kind]
    idx = rng.integers(0, len(vals), n)
    ok = rng.random(n) >= null_p
    return Column.from_pylist([vals[i] if v else None
                               for i, v in zip(idx, ok)], dt, device=device)


@pytest.mark.parametrize("kind", ["string", "decimal", "float32",
                                  "float64"])
@pytest.mark.parametrize("nr", [300, 5_000])
def test_variable_width_join_kernels_equal_plain_versions(kind, nr):
    """The hash join's variable-width instantiation on both routes: table,
    counts and pairs against the plain versions and the sort-based join."""
    _need_card()
    rng = np.random.default_rng(nr)
    p = [_key_column(kind, 20_000, rng, 0.05)]
    b = [_key_column(kind, nr, rng, 0.05)]
    C = join_cuda._capacity(nr)
    tk, tp = join_cuda.build_table_cuda(b, C), join_cuda.build_table_plain(
        b, C)
    assert torch.equal(tk.slot_row, tp.slot_row)
    pk = join_cuda.probe_counts_cuda(p, tk, b)
    _same_probe(pk, join_cuda.probe_counts_plain(p, tp, b))
    lk, rk = join_cuda.inner_join_hash(p, b)
    lf, rf = join.inner_join(p, b)
    assert torch.equal(lk.data, lf.data) and torch.equal(rk.data, rf.data)


@pytest.mark.parametrize("keys,asc", [(["s"], [True]), (["s"], [False]),
                                      (["d", "s"], [False, True])])
@pytest.mark.parametrize("k", [1, 100, 3_000])
def test_topk_string_and_decimal_keys_equal_plain_version(keys, asc, k):
    _need_card()
    rng = np.random.default_rng(k)
    t = Table([_key_column("string", 50_000, rng, 0.05),
               _key_column("decimal", 50_000, rng, 0.05)], ["s", "d"])
    got = topk_cuda.topk_table_cuda(t, keys, asc, k)
    want = topk.topk_plain(t, keys, asc, k)
    for a, b in zip(got.columns, want.columns):
        assert torch.equal(a.null_mask, b.null_mask)
        assert a.to_pylist() == b.to_pylist()


def test_fused_select_string_and_decimal_payloads_equal_plain_version():
    _need_card()
    rng = np.random.default_rng(3)
    n = 100_003
    t = Table([Column.from_numpy(rng.integers(0, 10, n).astype(np.int32),
                                 tdt.INT32, device="cuda"),
               _key_column("string", n, rng, 0.1),
               _key_column("decimal", n, rng, 0.1)], ["p", "s", "d"])
    for needed in (["s", "d"], ["s"], ["p", "d"]):
        got = select_cuda.fused_select_cuda(t, col("p") < 4, needed)
        want = select.fused_select_plain(t, col("p") < 4, needed)
        for a, b in zip(got.columns, want.columns):
            assert a.to_pylist() == b.to_pylist()
            if a.offsets is not None:
                assert torch.equal(a.offsets, b.offsets)


def test_q74_and_q3_strings_on_the_card_equal_the_cpu():
    _need_card()
    from spark_rapids_tpu_torch import nds_q74
    host = nds_q74.q74_inputs(200_000, 50_000, 10_000, seed=2, device="cpu")
    card = {k: t.to("cuda") for k, t in host.items()}
    join_cuda.reset_counters()
    got = PlanExecutor().execute(nds_q74.q74_plan(), card).table
    assert join_cuda.VAR_LAUNCHES["count"] == 3
    want = PlanExecutor(device="cpu").execute(nds_q74.q74_plan(), host)
    assert got.to("cpu").to_pydict() == want.table.to_pydict()
    q3 = nds_q3.q3_tpcds_strings_inputs(100_000, device="cpu")
    got = PlanExecutor().execute(nds_q3.q3_tpcds_strings_plan(),
                                 {k: t.to("cuda") for k, t in q3.items()})
    want = PlanExecutor(device="cpu").execute(
        nds_q3.q3_tpcds_strings_plan(), q3)
    assert got.table.to("cpu").to_pydict() == want.table.to_pydict()


# ---- the build without rounds, and the semi and anti joins ------------------

def _build_case(kind, case, C, rng):
    """A build side of one key column for one case, on the card: clusters
    that wrap past the last slot, every row in one bucket, 512 equal keys,
    nulls, no valid row, n = C / 2."""
    def values(ids):
        if kind == "float64":
            return [-0.0 if i == 0 else float(i) * 0.5 for i in ids]
        if kind == "decimal":
            return [int(i) * 10 ** 20 + int(i) for i in ids]
        if kind == "string":
            return [f"key-{int(i)}" for i in ids]
        return [int(i) for i in ids]
    dt = {"int32": tdt.INT32, "int64": tdt.INT64, "float64": tdt.FLOAT64,
          "decimal": tdt.decimal(38, 2), "string": tdt.STRING}[kind]

    def in_buckets(buckets, n):
        ids = np.arange(2 * n * C // len(buckets) + 1000)
        cand = Column.from_pylist(values(ids), dt, device="cpu")
        b = (join_cuda.row_hash([cand]) & (C - 1)).numpy()
        return values(rng.permutation(ids[np.isin(b, list(buckets))])[:n])
    if case == "wrap":
        keys = in_buckets((C - 3, C - 2, C - 1, 0), 64) + values(
            rng.integers(0, 10 * C, C // 4))
    elif case == "one_bucket":
        keys = in_buckets((C - 1,), min(C // 2, 256))
    elif case == "equal_512":
        keys = values([7]) * 512
    elif case == "all_null":
        keys = [None] * (C // 4)
    elif case == "nulls":
        keys = [None if v else k for k, v in zip(
            values(rng.integers(0, C // 6 + 1, C // 2)),
            rng.random(C // 2) < 0.3)]
    else:                                        # "half"
        keys = values(rng.permutation(4 * C)[:C // 2])
    return [Column.from_pylist(keys, dt, device="cuda")]


_CARD_BUILDS = [(kind, case, C)
                for kind in ("int32", "int64", "float64", "decimal",
                             "string")
                for case, C in (("wrap", 256), ("wrap", 4096),
                                ("one_bucket", 512), ("one_bucket", 8192),
                                ("equal_512", 1024), ("equal_512", 4096),
                                ("all_null", 2048), ("nulls", 1024),
                                ("nulls", 1 << 14), ("half", 1024),
                                ("half", 2048), ("half", 1 << 14))]


@pytest.mark.parametrize("kind,case,C", _CARD_BUILDS)
def test_build_without_rounds_equals_the_rounds(kind, case, C):
    """The build kernels (small route up to 1,024 slots, large above)
    against the plain version's rounds and the closed form, slot for slot,
    and the large route's rounds."""
    _need_card()
    b = _build_case(kind, case, C, np.random.default_rng(C + len(case)))
    tk = join_cuda.build_table_cuda(b, C)
    tp = join_cuda.build_table_plain(b, C)
    tc = join_cuda.build_table_closed_form(b, C)
    for t in (tp, tc):
        assert torch.equal(tk.slot_row, t.slot_row)
        assert torch.equal(tk.slot_hash, t.slot_hash)
    assert int(tp.rounds) == int(tc.rounds)
    if join_cuda.is_large(C):
        assert int(tk.rounds) == int(tp.rounds)
        assert torch.equal(tk.packed(), tp.packed())


@pytest.mark.parametrize("shape", ["q72_inventory", "q74_customers",
                                   "ceiling"])
def test_build_without_rounds_at_the_plans_shapes(shape):
    """q72's 52,000-row inventory (two INT64 keys), 489,258 16-byte string
    customer ids (q74's) and the 2^22-row ceiling: the large build against
    the plain version, rounds included."""
    _need_card()
    rng = np.random.default_rng(4)
    if shape == "q72_inventory":
        items, weeks = np.meshgrid(np.arange(500), np.arange(104))
        b = [Column.from_numpy(items.ravel().astype(np.int64), tdt.INT64,
                               device="cuda"),
             Column.from_numpy(weeks.ravel().astype(np.int64), tdt.INT64,
                               device="cuda")]
    elif shape == "q74_customers":
        ids = rng.permutation(500_000)[:489_258]
        b = [Column.from_pylist([f"AAAAAAAA{i:08d}" for i in ids],
                                tdt.STRING, device="cuda")]
    else:
        b = [Column.from_numpy(rng.permutation(join_cuda.MAX_BUILD)
                               .astype(np.int64), tdt.INT64,
                               device="cuda")]
    C = join_cuda._capacity(b[0].length)
    tk = join_cuda.build_table_cuda(b, C)
    tp = join_cuda.build_table_plain(b, C)
    assert torch.equal(tk.packed(), tp.packed())
    assert int(tk.rounds) == int(tp.rounds) > 1


@pytest.mark.parametrize("kind", ["int64", "int16", "float64", "decimal",
                                  "string"])
@pytest.mark.parametrize("nr", [300, 5_000])
def test_exists_kernel_equals_plain_version_and_sort_route(kind, nr):
    """The existence probe on both routes against its plain version and
    the count's; the semi and anti joins against the sort-based ones, with
    alive masks on both sides."""
    _need_card()
    rng = np.random.default_rng(nr)
    if kind in ("int64", "int16"):
        npt, dt = {"int64": (np.int64, tdt.INT64),
                   "int16": (np.int16, tdt.INT16)}[kind]

        def keys(n):
            return [Column.from_numpy(rng.integers(0, nr, n).astype(npt),
                                      dt, rng.random(n) > 0.05,
                                      device="cuda")]
        p, b = keys(200_003), keys(nr)
    else:
        p, b = (_key_column(kind, 200_003, rng, 0.05),
                _key_column(kind, nr, rng, 0.05))
        p, b = [p], [b]
    C = join_cuda._capacity(nr)
    table = join_cuda.build_table_cuda(b, C)
    join_cuda.reset_counters()
    got = join_cuda.probe_exists_cuda(p, table, b)
    assert join_cuda.LAUNCHES["exists"] == 1
    assert join_cuda.LARGE_LAUNCHES["exists"] == int(join_cuda.is_large(C))
    assert join_cuda.VAR_LAUNCHES["exists"] == int(join_cuda.is_var(p))
    assert torch.equal(got, join_cuda.probe_exists_plain(p, table, b))
    assert torch.equal(got, join_cuda.probe_counts_cuda(p, table, b).counts
                       > 0)
    la = torch.from_numpy(rng.random(200_003) < 0.6).cuda()
    ra = torch.from_numpy(rng.random(nr) < 0.6).cuda()
    assert torch.equal(join_cuda.semi_join_mask_hash(p, b, lalive=la,
                                                     ralive=ra),
                       join.semi_join_mask(p, b, lalive=la, ralive=ra))
    assert torch.equal(join_cuda.left_semi_join_hash(p, b).data,
                       join.left_semi_join(p, b).data)
    assert torch.equal(join_cuda.left_anti_join_hash(p, b).data,
                       join.left_anti_join(p, b).data)
    # the wrappers never ran a plain version on the card
    assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0,
                                     "exists": 0, "capped": 0}


# ---- the casts (csrc/cast_string.cu, cast_decimal.cu,
# cast_string_to_float.cu, number_to_string.cu) -------------------------------

def _cast_strings(seed, n, device):
    from torch_cast_inputs import EDGE, random_number_strings, with_nulls
    vals = with_nulls(EDGE + random_number_strings(seed, n, max_digits=40),
                      seed + 1)
    return Column.from_pylist(vals, tdt.STRING, device=device)


def _same_column(got, want):
    """Data by its bits, validity and, for strings, offsets and chars."""
    def bits(t):
        if t.dtype in (torch.float32, torch.uint32):
            return t.view(torch.int32)
        if t.dtype in (torch.float64, torch.uint64):
            return t.view(torch.int64)
        return t
    assert got.dtype == want.dtype
    assert torch.equal(bits(got.data).cpu(), bits(want.data).cpu())
    assert (got.validity is None) == (want.validity is None)
    if got.validity is not None:
        assert torch.equal(got.validity.cpu(), want.validity.cpu())
    if got.offsets is not None:
        assert torch.equal(got.offsets.cpu(), want.offsets.cpu())


_STRING_CASTS = [
    ("to_integer", lambda c: cast_string.string_to_integer(c, tdt.INT32),
     lambda c: cast_string.string_to_integer_plain(c, tdt.INT32)[0]),
    ("to_integer", lambda c: cast_string.string_to_integer(
        c, tdt.INT64, strip=False),
     lambda c: cast_string.string_to_integer_plain(c, tdt.INT64,
                                                   strip=False)[0]),
    ("to_integer_base", lambda c: cast_string.string_to_integer_with_base(
        c, tdt.INT64, base=16),
     lambda c: cast_string.string_to_integer_with_base_plain(c, tdt.INT64,
                                                             16)),
    ("to_float", lambda c: cast_string.string_to_float(c, tdt.FLOAT32),
     lambda c: cast_string.string_to_float_plain(c, tdt.FLOAT32)[0]),
    ("to_float", lambda c: cast_string.string_to_float(c, tdt.FLOAT64),
     lambda c: cast_string.string_to_float_plain(c, tdt.FLOAT64)[0]),
    ("to_decimal", lambda c: cast_decimal.string_to_decimal(c, 9, 2),
     lambda c: cast_decimal.string_to_decimal_plain(c, 9, 2)[0]),
    ("to_decimal", lambda c: cast_decimal.string_to_decimal(c, 38, 10),
     lambda c: cast_decimal.string_to_decimal_plain(c, 38, 10)[0]),
]


@pytest.mark.parametrize("case", range(len(_STRING_CASTS)))
def test_string_cast_kernels_equal_plain_version(case):
    """Each string -> number kernel on an edge corpus and 20,000 random
    rows, a slice whose offsets start past 0 too: equal to the plain
    version on the same CUDA tensors and to the CPU run, and no plain run
    counted."""
    _need_card()
    op, kernel, plain = _STRING_CASTS[case]
    col = _cast_strings(case, 20_000, "cuda")
    sliced = Column(tdt.STRING, col.length - 7, col.data,
                    None if col.validity is None else col.validity[7:],
                    col.offsets[7:])
    for c in (col, sliced):
        cast_cuda.reset_counters()
        got = kernel(c)
        torch.cuda.synchronize()
        assert cast_cuda.LAUNCHES[op] == 1
        assert sum(cast_cuda.PLAIN_CALLS.values()) == 0
        _same_column(got, plain(c))
        _same_column(got, kernel(c.to("cpu")))


def test_string_cast_ansi_error_on_the_card():
    _need_card()
    col = Column.from_pylist(["1", None, " 2 ", "4.2", "x"], tdt.STRING,
                             device="cuda")
    with pytest.raises(cast_string.CastError) as e:
        cast_string.string_to_integer(col, tdt.INT32, ansi_mode=True)
    assert (e.value.row_number, e.value.string_with_error) == (3, "4.2")


@pytest.mark.parametrize("cast", ["decimal", "float"])
def test_string_cast_ansi_error_of_each_parse_kernel(cast):
    """The decimal and float kernels flag the first bad row under ANSI as
    the CPU run does; outside ANSI they write no flags and raise nothing."""
    _need_card()
    vals = ["1", None, " 2 ", "4.2x", "x"]
    if cast == "decimal":
        fn = (lambda c, a: cast_decimal.string_to_decimal(c, 9, 2,
                                                          ansi_mode=a))
    else:
        fn = (lambda c, a: cast_string.string_to_float(c, tdt.FLOAT64,
                                                       ansi_mode=a))
    errs = []
    for dev in ("cuda", "cpu"):
        col = Column.from_pylist(vals, tdt.STRING, device=dev)
        fn(col, False)
        with pytest.raises(cast_string.CastError) as e:
            fn(col, True)
        errs.append((e.value.row_number, e.value.string_with_error))
    assert errs[0] == errs[1] == (3, "4.2x")


def _number_columns(device):
    rng = np.random.default_rng(5)
    n = 20_000
    valid = rng.random(n) > 0.1
    f32 = rng.integers(0, 2**32, n).astype(np.uint32).view(np.float32)
    f64 = rng.integers(0, 2**63, n).astype(np.uint64).view(np.float64)
    dec = rng.integers(-2**62, 2**62, n)
    return {
        "float32": Column.from_numpy(f32, tdt.FLOAT32, valid, device=device),
        "float64": Column.from_numpy(f64, tdt.FLOAT64, valid, device=device),
        "dec64": Column.from_numpy(dec, tdt.decimal(18, 4), valid,
                                   device=device),
        "dec128": Column.from_pylist(
            [None if not v else int(x) * 10**19 + 7
             for x, v in zip(dec, valid)], tdt.decimal(38, 6), device=device),
        "int8": Column.from_numpy(rng.integers(-128, 128, n).astype(np.int8),
                                  tdt.INT8, valid, device=device),
        "uint64": Column.from_numpy(rng.integers(0, 2**63, n).astype(
            np.uint64) * 2, tdt.DType(tdt.Kind.UINT64), valid,
            device=device),
    }


_NUMBER_CASTS = [
    ("from_float", "float32", lambda c: cast_float_to_string.float_to_string(
        c), cast_float_to_string.float_to_string_plain),
    ("from_float", "float64", lambda c: cast_float_to_string.float_to_string(
        c), cast_float_to_string.float_to_string_plain),
    ("format_float", "float32", lambda c: format_float.format_float(c, 3),
     lambda c: format_float.format_float_plain(c, 3)),
    ("format_float", "float64", lambda c: format_float.format_float(c, 0),
     lambda c: format_float.format_float_plain(c, 0)),
    ("from_decimal", "dec64",
     cast_decimal_to_string.decimal_to_non_ansi_string,
     cast_decimal_to_string.decimal_to_non_ansi_string_plain),
    ("from_decimal", "dec128",
     cast_decimal_to_string.decimal_to_non_ansi_string,
     cast_decimal_to_string.decimal_to_non_ansi_string_plain),
    ("from_integer_base", "int8",
     lambda c: cast_string.integer_to_string_with_base(c, 16),
     lambda c: cast_string.integer_to_string_with_base_plain(c, 16)),
    ("from_integer_base", "uint64",
     lambda c: cast_string.integer_to_string_with_base(c, 10),
     lambda c: cast_string.integer_to_string_with_base_plain(c, 10)),
]


@pytest.mark.parametrize("case", range(len(_NUMBER_CASTS)))
def test_number_to_string_kernel_equals_plain_version(case):
    """The two passes of number_to_string.cu against the plain version on
    the same CUDA tensors and the CPU run: offsets and chars byte for
    byte, each pass counted."""
    _need_card()
    op, kind, kernel, plain = _NUMBER_CASTS[case]
    col = _number_columns("cuda")[kind]
    cast_cuda.reset_counters()
    got = kernel(col)
    torch.cuda.synchronize()
    assert cast_cuda.LAUNCHES[op] == 2
    assert sum(cast_cuda.PLAIN_CALLS.values()) == 0
    _same_column(got, plain(col))
    _same_column(got, kernel(col.to("cpu")))


# ---- parse_uri, from_json and the bloom filter (csrc/parse_uri.cu,
# map_utils.cu, bloom_filter.cu) ----------------------------------------------

def _uri_column(device):
    from torch_uri_json_inputs import uri_corpus
    return Column.from_pylist(uri_corpus(), tdt.STRING, device=device)


@pytest.mark.parametrize("op", ["protocol", "host", "query", "query_literal",
                                "query_column"])
def test_parse_uri_kernel_equals_plain_version(op):
    """Each parse_uri entry point on the card against the plain version on
    the same tensors and the CPU run, byte for byte; two launches (spans,
    copy), no plain run."""
    _need_card()
    from torch_uri_json_inputs import uri_params
    from spark_rapids_tpu_torch.ops import parse_uri, parse_uri_cuda
    col = _uri_column("cuda")
    params = Column.from_pylist(uri_params(3, col.length), tdt.STRING,
                                device="cuda")
    call = {"query_literal": lambda c, p: parse_uri.parse_uri_to_query_literal(
                c, "a"),
            "query_column": parse_uri.parse_uri_to_query_column}.get(
        op, lambda c, p: getattr(parse_uri, f"parse_uri_to_{op}")(c))
    plain = {"query_literal": lambda c, p: (
                 parse_uri.parse_uri_to_query_literal_plain(c, "a")),
             "query_column": parse_uri.parse_uri_to_query_column_plain}.get(
        op, lambda c, p: getattr(parse_uri, f"parse_uri_to_{op}_plain")(c))
    parse_uri_cuda.reset_counters()
    got = call(col, params)
    torch.cuda.synchronize()
    assert parse_uri_cuda.LAUNCHES[op] == 2
    assert sum(parse_uri_cuda.PLAIN_CALLS.values()) == 0
    _same_column(got, plain(col, params))
    _same_column(got, call(col.to("cpu"), params.to("cpu")))


def test_parse_uri_width_bounds_on_the_card_equal_the_cpu():
    """`pad_to`, `param_pad_to` and `out_pad_to` on a CUDA column: below
    the longest string, parameter or span each raises the CPU run's
    ValueError, in its order; at the longest each gives the CPU run's
    result."""
    _need_card()
    from spark_rapids_tpu_torch.ops import parse_uri
    rows = ["http://a.com/?q=1234567890", "x", None]
    col = Column.from_pylist(rows, tdt.STRING, device="cuda")
    params = Column.from_pylist(["q", "longer", "q"], tdt.STRING,
                                device="cuda")
    calls = [("host", lambda c, p, **kw: parse_uri.parse_uri_to_host(c, **kw)),
             ("query_literal", lambda c, p, **kw: (
                 parse_uri.parse_uri_to_query_literal(c, "q", **kw))),
             ("query_column", parse_uri.parse_uri_to_query_column)]
    bounds = [{"pad_to": 8}, {"out_pad_to": 4},
              {"pad_to": 8, "out_pad_to": 4}]
    bounds_col = bounds + [{"param_pad_to": 2},
                           {"pad_to": 8, "param_pad_to": 2}]
    for op, call in calls:
        for kw in bounds_col if op == "query_column" else bounds:
            msgs = []
            for c, p in ((col, params), (col.to("cpu"), params.to("cpu"))):
                with pytest.raises(ValueError) as e:
                    call(c, p, **kw)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1], (op, kw)
        kw = {"pad_to": 26, "out_pad_to": 10}
        if op == "query_column":
            kw["param_pad_to"] = 6
        _same_column(call(col, params, **kw),
                     call(col.to("cpu"), params.to("cpu"), **kw))


def test_from_json_kernels_equal_plain_version():
    """from_json on the card: list offsets, keys, values and validity equal
    to the plain version and the CPU run; two launches; an error row
    raises the CPU run's message."""
    _need_card()
    from torch_uri_json_inputs import json_corpus
    from spark_rapids_tpu_torch.ops import map_utils, map_utils_cuda
    col = Column.from_pylist(json_corpus(), tdt.STRING, device="cuda")
    map_utils_cuda.reset_counters()
    got = map_utils.from_json(col)
    torch.cuda.synchronize()
    assert map_utils_cuda.LAUNCHES["from_json"] == 2
    assert map_utils_cuda.PLAIN_CALLS["from_json"] == 0
    for want in (map_utils.from_json_plain(col),
                 map_utils.from_json(col.to("cpu"))):
        assert torch.equal(got.offsets, want.offsets.to("cuda"))
        _same_column(Column(tdt.BOOL, got.length, got.null_mask),
                     Column(tdt.BOOL, got.length,
                            want.null_mask.to("cuda")))
        for g, w in zip(got.children[0].children, want.children[0].children):
            _same_column(g, w.to("cuda"))
    bad = Column.from_pylist(['{"a": 1}', '{k: 1}', '{"a": 1'], tdt.STRING,
                             device="cuda")
    msgs = []
    for c in (bad, bad.to("cpu")):
        with pytest.raises(ValueError) as e:
            map_utils.from_json(c)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "row 2" in msgs[0]


@pytest.mark.parametrize("num_longs", [1, 3, 1 << 17])
def test_bloom_filter_kernels_equal_plain_version(num_longs):
    """put (64-bit atomicOr) and probe on the card against the plain
    version on the same tensors and the CPU run; one launch each."""
    _need_card()
    from torch_uri_json_inputs import int64_values
    from spark_rapids_tpu_torch.ops import bloom_filter, bloom_filter_cuda
    v, valid = int64_values(9, 300_000)
    col = Column.from_numpy(v, tdt.INT64, valid, device="cuda")
    bf = bloom_filter.bloom_filter_create(3, num_longs, device="cuda")
    bloom_filter_cuda.reset_counters()
    got = bloom_filter.bloom_filter_put(bf, col)
    found = bloom_filter.bloom_filter_probe(col, got)
    torch.cuda.synchronize()
    assert bloom_filter_cuda.LAUNCHES == {"put": 1, "probe": 1}
    assert sum(bloom_filter_cuda.PLAIN_CALLS.values()) == 0
    assert not bf.words.any()                    # put is functional
    want = bloom_filter.bloom_filter_put_plain(bf, col)
    assert torch.equal(got.words, want.words)
    cpu = bloom_filter.bloom_filter_put(
        bloom_filter.bloom_filter_create(3, num_longs, device="cpu"),
        col.to("cpu"))
    assert torch.equal(got.words.cpu(), cpu.words)
    assert torch.equal(found.data,
                       bloom_filter.bloom_filter_probe_plain(col, got).data)
    assert bool(found.data[col.validity].all())  # no false negatives
    wire = bloom_filter.bloom_filter_serialize(got)
    back = bloom_filter.bloom_filter_deserialize(wire)
    assert back.device == got.device and torch.equal(back.words, got.words)


@pytest.mark.parametrize("depth", ["0", "2"])
def test_streaming_scan_on_the_card_equals_the_cpu(tmp_path, monkeypatch,
                                                    depth):
    """A Parquet file streamed onto the card (page-locked chunks, copies on
    the copy stream, prefetch depth 0 and 2) gives the CPU run's table, and
    the whole-file read gives the CPU read's buffers."""
    _need_card()
    import torch_parquet_writer as pw
    from spark_rapids_tpu_torch.io import read_parquet
    from spark_rapids_tpu_torch.plan import PlanBuilder
    rng = np.random.default_rng(3)
    n = 300_000
    path = str(tmp_path / "t.parquet")
    pw.write_parquet(path, [
        ("k", "int64", rng.integers(0, 1000, n), None),
        ("v", "int64", rng.integers(-5, 5, n), rng.random(n) > 0.1),
        ("f", "float64", rng.standard_normal(n), None)], 65_536, "GZIP")
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_IO_PREFETCH", depth)
    plan = (PlanBuilder().scan("t", parquet=path).filter(col("k") < 500)
            .aggregate(["k"], [("v", "sum", "s"), ("v", "count", "c")])
            .sort(["k"]).build())
    card = PlanExecutor().execute(plan)
    cpu = PlanExecutor(device="cpu").execute(plan)
    for name in cpu.table.names:
        assert torch.equal(card.table[name].data.cpu(), cpu.table[name].data)
        assert torch.equal(card.table[name].null_mask.cpu(),
                           cpu.table[name].null_mask)
    scan = next(m for m in card.metrics.values() if m.kind == "Scan")
    assert scan.io_row_groups_total == 5 and scan.io_h2d_ms > 0.0
    got, want = read_parquet(path), read_parquet(path, device="cpu")
    for name in want.names:
        assert got[name].device.type == "cuda"
        assert torch.equal(got[name].data.cpu(), want[name].data)
        assert torch.equal(got[name].null_mask.cpu(), want[name].null_mask)


def _same_nested(got, want):
    """Two port columns of any depth equal in every buffer (`_same_column`
    on each level; a list's or struct's children too)."""
    if got.data is not None:
        _same_column(got, want)
    else:
        assert got.dtype == want.dtype and got.length == want.length
        assert (got.validity is None) == (want.validity is None)
        if got.validity is not None:
            assert torch.equal(got.validity.cpu(), want.validity.cpu())
        if got.offsets is not None:
            assert torch.equal(got.offsets.cpu(), want.offsets.cpu())
    for g, w in zip(got.children, want.children):
        _same_nested(g, w)


@pytest.mark.parametrize("unit", ["TIMESTAMP_S", "TIMESTAMP_MS",
                                  "TIMESTAMP_US"])
def test_timezone_kernel_equals_plain_version(unit):
    """`tz_convert` both ways in four zones against the plain version on
    the same tensors and the CPU run; one launch a call, no plain run."""
    _need_card()
    from torch_datetime_inputs import timestamps
    from spark_rapids_tpu_torch.ops import timezones, timezones_cuda
    scale = timezones.SCALES[tdt.Kind[unit]]
    v, valid = timestamps(1, 100_003, scale=scale)
    col = Column.from_numpy(v, tdt.DType(tdt.Kind[unit]), valid,
                            device="cuda")
    for zone in ("Asia/Shanghai", "Pacific/Kiritimati", "Asia/Kolkata",
                 "+05:30"):
        utc, loc, offs = timezones.TimeZoneDB.instance().tables_on(
            zone, col.device)
        for to_utc, fn in ((True, timezones.from_timestamp_to_utc_timestamp),
                           (False,
                            timezones.from_utc_timestamp_to_timestamp)):
            timezones_cuda.reset_counters()
            got = fn(col, zone)
            torch.cuda.synchronize()
            assert sum(timezones_cuda.LAUNCHES.values()) == 1
            assert sum(timezones_cuda.PLAIN_CALLS.values()) == 0
            assert torch.equal(got.data, timezones.convert_plain(
                col.data, loc if to_utc else utc, offs, to_utc, scale))
            _same_column(got, fn(col.to("cpu"), zone))


def test_rebase_kernel_equals_plain_version():
    """`dr_rebase`'s four forms against the plain version on the same
    tensors and the CPU run; one launch a call, no plain run."""
    _need_card()
    from torch_datetime_inputs import rebase_days, rebase_micros
    from spark_rapids_tpu_torch.ops import (datetime_rebase,
                                            datetime_rebase_cuda)
    for make, dt in ((rebase_days, tdt.DATE32),
                     (rebase_micros, tdt.TIMESTAMP_US)):
        v, valid = make(2, 100_003)
        col = Column.from_numpy(v, dt, valid, device="cuda")
        for to_julian, fn in ((True,
                               datetime_rebase.rebase_gregorian_to_julian),
                              (False,
                               datetime_rebase.rebase_julian_to_gregorian)):
            datetime_rebase_cuda.reset_counters()
            got = fn(col)
            torch.cuda.synchronize()
            assert sum(datetime_rebase_cuda.LAUNCHES.values()) == 1
            assert sum(datetime_rebase_cuda.PLAIN_CALLS.values()) == 0
            assert torch.equal(got.data,
                               datetime_rebase.rebase_plain(col, to_julian))
            _same_column(got, fn(col.to("cpu")))


def test_zorder_kernels_equal_plain_version():
    """`zo_interleave` at widths 1, 2, 4 and 8 (with nulls, floats by their
    bits) and `zo_hilbert` at every shape of the tests, against the plain
    versions on the same tensors and the CPU run; zero rows launch
    nothing."""
    _need_card()
    from torch_datetime_inputs import HILBERT_SHAPES, zorder_columns
    from spark_rapids_tpu_torch.ops import zorder, zorder_cuda
    for kind, np_type in (("INT8", np.int8), ("INT16", np.int16),
                          ("FLOAT32", np.float32), ("FLOAT64", np.float64),
                          ("BOOL", np.bool_)):
        cols = [Column.from_numpy(v, tdt.DType(tdt.Kind[kind]), ok,
                                  device="cuda")
                for v, ok in zorder_columns(3, np_type, 3, 50_001)]
        zorder_cuda.reset_counters()
        got = zorder.interleave_bits(cols)
        torch.cuda.synchronize()
        assert zorder_cuda.LAUNCHES["interleave"] == 1
        assert sum(zorder_cuda.PLAIN_CALLS.values()) == 0
        assert torch.equal(got.children[0].data.reshape(50_001, -1),
                           zorder.interleave_plain(cols))
        _same_nested(got, zorder.interleave_bits([c.to("cpu") for c in cols]))
    for bits, ncols in HILBERT_SHAPES:
        cols = [Column.from_numpy(v, tdt.INT32, ok, device="cuda")
                for v, ok in zorder_columns(bits, np.int32, ncols, 20_001)]
        got = zorder.hilbert_index(bits, cols)
        assert torch.equal(got.data, zorder.hilbert_plain(bits, cols))
        _same_column(got, zorder.hilbert_index(bits, [c.to("cpu")
                                                      for c in cols]))
    zorder_cuda.reset_counters()
    empty = Column.from_numpy(np.zeros(0, np.int32), tdt.INT32, device="cuda")
    assert zorder.interleave_bits([empty]).length == 0
    assert zorder_cuda.LAUNCHES["interleave"] == 0


@pytest.mark.parametrize("negative", [False, True])
def test_percentile_kernel_equals_plain_version(negative):
    """`hg_percentile` after the three sorts against the plain version on
    the same tensors and the CPU run, both output forms, histograms longer
    than a warp and negative counts; one launch a call, no plain run."""
    _need_card()
    from torch_datetime_inputs import random_histograms
    from spark_rapids_tpu_torch.ops import histogram, histogram_cuda
    values, valid, counts, offsets = random_histograms(4, 5_000, 80,
                                                       null_p=0.05)
    values[::31] = np.nan
    if negative:
        counts = counts - 500
    struct = Column.make_struct(
        value=Column.from_numpy(values, tdt.FLOAT64, valid, device="cuda"),
        freq=Column.from_numpy(counts, tdt.INT64, device="cuda"))
    col = Column.make_list(torch.tensor(offsets, device="cuda"), struct)
    pcts = [0.0, 0.25, 0.5, 0.75, 0.99, 1.0]
    pct = torch.tensor(pcts, dtype=torch.float64, device="cuda")
    out, out_valid = histogram_cuda.percentile(
        struct.children[0].data, struct.children[0].null_mask, struct.children[
            1].data, col.offsets, pct)
    want = histogram.percentile_plain(
        struct.children[0].data, struct.children[0].null_mask,
        struct.children[1].data, col.offsets, pct)
    assert torch.equal(out.view(torch.int64), want[0].view(torch.int64))
    assert torch.equal(out_valid, want[1])
    for as_list in (True, False):
        histogram_cuda.reset_counters()
        got = histogram.percentile_from_histogram(col, pcts, as_list)
        torch.cuda.synchronize()
        assert histogram_cuda.LAUNCHES["percentile"] == 1
        assert histogram_cuda.PLAIN_CALLS["percentile"] == 0
        _same_nested(got, histogram.percentile_from_histogram(
            col.to("cpu"), pcts, as_list))
