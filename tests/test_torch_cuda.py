"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (hash join,
row hash, shuffle histogram, FusedSelect, TopK, groupby) against their plain
PyTorch versions, and q3 and TPC-DS q3 through `PlanExecutor()` on the
card.

They import neither JAX nor the JAX package, so they also run where only
the port's dependencies are installed, e.g. on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a CUDA device each test skips (decided inside the test).
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import nds_q3
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch import parallel
from spark_rapids_tpu_torch.columnar import Table
from spark_rapids_tpu_torch.ops import hash as thash
from spark_rapids_tpu_torch.ops import (hash_cuda, join, join_cuda,
                                        select, select_cuda, topk,
                                        topk_cuda)
from spark_rapids_tpu_torch.parallel import partition_cuda
from spark_rapids_tpu_torch.plan import PlanExecutor, col, lit

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
    assert join_cuda.LAUNCHES == {"build": 2, "count": 2, "emit": 2}
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
    assert partition_cuda.LAUNCHES == {"histogram": 1}
    assert partition_cuda.PLAIN_CALLS == {"histogram": 0}


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
    assert topk_cuda.LAUNCHES == {"threshold": 1, "select": 0, "merge": 0}
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
                                        "emit": emits}
    with pytest.raises(ValueError, match="MAX_BUILD"):
        join_cuda.build_table_cuda(
            [Column.from_numpy(np.zeros(join_cuda.MAX_BUILD + 1, np.int64),
                               tdt.INT64, device="cuda")],
            join_cuda.MAX_CAPACITY)


def test_large_route_joins_on_three_streams_at_once():
    """Large-route joins (cooperative builds) from three threads, each on
    its own stream: each grid is resident alone, the calls share no device
    state, and every map equals the sort-based join's."""
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
    assert join_cuda.LAUNCHES == {"build": 5, "count": 5, "emit": 5}
    assert join_cuda.LARGE_LAUNCHES == {"build": 1, "count": 1, "emit": 1}
    assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0}
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
        assert join_cuda.CAPPED_CALLS == {"join": 1}
        assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0}


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
        assert join_cuda.CAPPED_CALLS == {"join": n}
        assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0}
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
    card: the groupby is the one kernel of the port on their path, no
    plain version runs, and every result equals the CPU run."""
    _need_card()
    from spark_rapids_tpu_torch import nds_q5, nds_q23
    mod = {"q5": nds_q5, "q23": nds_q23}[q]
    plan = getattr(mod, f"{q}_plan")()
    make = getattr(mod, f"{q}_inputs")
    inputs = make(60_000, device="cuda")
    cpu_inputs = make(60_000, device="cpu")
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
            assert join_cuda.LAUNCHES == {"build": 0, "count": 0,
                                          "emit": 0}
            assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                             "emit": 0}
            assert sum(select_cuda.LAUNCHES.values()) == 0
            assert sum(topk_cuda.LAUNCHES.values()) == 0
            # the keyed aggregates are the one kernel on these paths
            assert {m.kernel for m in res.metrics.values()
                    if m.kernel.startswith("cuda:")} == {"cuda:groupby"}


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


def test_groupby_forced_plain_raises_on_the_card(monkeypatch):
    _need_card()
    from spark_rapids_tpu_torch.ops import aggregate
    from spark_rapids_tpu_torch.ops.registry import KernelDeclinedError
    t = Table([Column.from_numpy(np.arange(10, dtype=np.int64), tdt.INT64,
                                 device="cuda")], ["k"])
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "groupby=torch")
    with pytest.raises(KernelDeclinedError):
        aggregate.groupby_aggregate(t, ["k"], [("k", "sum")])
