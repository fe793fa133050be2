"""The port's hash join (spark_rapids_tpu_torch/ops/join_cuda.py) against
the JAX package on the CPU, on the same numpy inputs.

On CPU tensors every wrapper runs its plain PyTorch version, so these tests
hold the plain build/count/emit to the reference: pair for pair, in order,
against `join_pallas.inner_join_pallas` (Pallas interpret mode on the CPU)
and `ops.inner_join`; the build table slot for slot against
`join_pallas._build_table`; and `_supports` against the reference's on the
same signatures. The tolerance is exact: join maps are integers.
"""
import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu.ops import inner_join as j_inner_join
from spark_rapids_tpu.ops import join_pallas

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.ops import join as tjoin
from spark_rapids_tpu_torch.ops import join_cuda
from spark_rapids_tpu_torch.ops.registry import REGISTRY

_HJ_DTYPES = [np.int64, np.int32, np.int16, np.bool_]


def _tcol(jc: JColumn) -> TColumn:
    v = None if jc.validity is None else np.asarray(jc.validity)
    return TColumn.from_numpy(np.asarray(jc.data),
                              tdt.DType(tdt.Kind(jc.dtype.kind.value),
                                        jc.dtype.precision, jc.dtype.scale),
                              v, device="cpu")


def _keys(rng, dt, n, hi, null_p):
    if dt is np.bool_:
        k = rng.integers(0, 2, n).astype(bool)
    else:
        k = rng.integers(0, hi, n).astype(dt)
    v = (rng.random(n) > null_p) if null_p else None
    return JColumn.from_numpy(k, validity=v)


def _assert_maps(ref, got):
    rl, rr = ref
    gl, gr = got
    npt.assert_array_equal(np.asarray(rl.data), gl.data.numpy())
    npt.assert_array_equal(np.asarray(rr.data), gr.data.numpy())
    assert gl.data.dtype == torch.int32 and gr.data.dtype == torch.int32


@pytest.mark.parametrize("dt", _HJ_DTYPES)
@pytest.mark.parametrize("with_nulls", [False, True])
def test_plain_hash_join_matches_pallas_and_fallback(dt, with_nulls):
    rng = np.random.default_rng(6)
    nl, nr = 300, 90
    lc = [_keys(rng, dt, nl, 60, 0.1 if with_nulls else 0)]
    rc = [_keys(rng, dt, nr, 60, 0.1 if with_nulls else 0)]
    tl, tr = [_tcol(c) for c in lc], [_tcol(c) for c in rc]
    got = join_cuda.inner_join_hash(tl, tr)
    _assert_maps(join_pallas.inner_join_pallas(lc, rc), got)
    _assert_maps(j_inner_join(lc, rc), got)
    # the port's own fallback agrees too
    _assert_maps(j_inner_join(lc, rc), tjoin.inner_join(tl, tr))


def test_plain_hash_join_multikey():
    rng = np.random.default_rng(7)
    nl, nr = 260, 120
    lc = [JColumn.from_numpy(rng.integers(0, 20, nl).astype(np.int64)),
          JColumn.from_numpy(rng.integers(0, 3, nl).astype(np.int32),
                             validity=rng.random(nl) > 0.05)]
    rc = [JColumn.from_numpy(rng.integers(0, 20, nr).astype(np.int64)),
          JColumn.from_numpy(rng.integers(0, 3, nr).astype(np.int32))]
    tl, tr = [_tcol(c) for c in lc], [_tcol(c) for c in rc]
    got = join_cuda.inner_join_hash(tl, tr)
    _assert_maps(join_pallas.inner_join_pallas(lc, rc), got)
    _assert_maps(j_inner_join(lc, rc), got)
    _assert_maps(j_inner_join(lc, rc), tjoin.inner_join(tl, tr))


def test_plain_hash_join_all_null_and_empty():
    rng = np.random.default_rng(8)
    lc = [JColumn.from_numpy(rng.integers(0, 5, 200).astype(np.int64),
                             validity=np.zeros(200, bool))]
    rc = [JColumn.from_numpy(rng.integers(0, 5, 50).astype(np.int64))]
    got = join_cuda.inner_join_hash([_tcol(c) for c in lc],
                                    [_tcol(c) for c in rc])
    ref = join_pallas.inner_join_pallas(lc, rc)
    assert ref[0].length == got[0].length == 0     # null keys never match
    e = [TColumn.from_numpy(np.zeros(0, np.int64), tdt.INT64, device="cpu")]
    gl, gr = join_cuda.inner_join_hash(e, e)
    assert gl.length == gr.length == 0
    gl, gr = tjoin.inner_join(e, e)
    assert gl.length == gr.length == 0


@pytest.mark.parametrize("case", ["int64_dupes", "int32_nulls", "two_keys"])
def test_build_table_matches_pallas(case):
    rng = np.random.default_rng(9)
    n = 140
    if case == "int64_dupes":
        cols = [JColumn.from_numpy(rng.integers(-30, 30, n).astype(np.int64))]
    elif case == "int32_nulls":
        cols = [JColumn.from_numpy(rng.integers(0, 90, n).astype(np.int32),
                                   validity=rng.random(n) > 0.2)]
    else:
        cols = [JColumn.from_numpy(rng.integers(0, 9, n).astype(np.int16)),
                JColumn.from_numpy(rng.integers(0, 9, n).astype(np.int64))]
    C = join_pallas._capacity(n)
    assert join_cuda._capacity(n) == C
    rvalid = join_pallas._side_valid(cols, n)
    ref = np.asarray(join_pallas._build_table(cols, rvalid, C,
                                              interpret=True))
    tbl = join_cuda.build_table([_tcol(c) for c in cols], C)
    occ = tbl.slot_row.numpy() >= 0
    npt.assert_array_equal(ref[:, 0] > 0, occ)
    npt.assert_array_equal(ref[:, 1].astype(np.int64),
                           np.where(occ, tbl.slot_row.numpy(), 0))


def test_bucket_hash_matches_reference_words():
    rng = np.random.default_rng(10)
    n = 64
    cols = [JColumn.from_numpy(rng.integers(-2**40, 2**40, n)
                               .astype(np.int64)),
            JColumn.from_numpy(rng.integers(-2**15, 2**15, n)
                               .astype(np.int16))]
    words = join_pallas._flat_planes(cols)
    ref = np.asarray(join_pallas._mm_hash(join_pallas._layout_of(cols),
                                          words)).astype(np.int64)
    got = join_cuda.row_hash([_tcol(c) for c in cols]).numpy()
    npt.assert_array_equal(ref, got)


def test_supports_parity_with_reference():
    """`_supports` equals the reference's on every signature but the build
    size, float keys and semi joins: the reference declines above its 512
    rows (VMEM), the port's large route takes up to its stated ceiling,
    MAX_BUILD = 2^22 rows, and declines one row more; the reference's
    Pallas join declines float keys, the port's kernels take them (queue C
    7: on the card a decline raises, where the reference's sort-based join
    runs); the reference has no kernel for semi and anti joins, the port
    runs them on its build and existence probe."""
    specs = [
        (np.zeros(4, np.float32), np.zeros(4, np.float32), "inner", "eager"),
        (np.zeros(4, np.int64), np.zeros(4, np.int64), "left_semi", "eager"),
        (np.zeros(4, np.int64),
         np.zeros(join_pallas.MAX_BUILD + 1, np.int64), "inner", "eager"),
        (np.zeros(join_pallas.MAX_BUILD + 1, np.int64),
         np.zeros(4, np.int64), "inner", "capped"),
        (np.zeros(4, np.int64), np.zeros(join_pallas.MAX_BUILD, np.int64),
         "inner", "eager"),
        (np.zeros(4, np.int32), np.zeros(4, np.int64), "inner", "eager"),
    ]
    assert join_pallas.MAX_BUILD == 512
    assert join_cuda.MAX_BUILD == 1 << 22
    assert join_cuda.MAX_BUILD * 2 == join_cuda.MAX_CAPACITY == 1 << 23
    refs, verdicts = [], []
    for l, r, how, tier in specs:
        jl, jr = [JColumn.from_numpy(l)], [JColumn.from_numpy(r)]
        refs.append(join_pallas._supports(
            join_pallas.make_signature(jl, jr, how, tier)))
        verdicts.append(join_cuda._supports(join_cuda.make_signature(
            [_tcol(c) for c in jl], [_tcol(c) for c in jr], how, tier)))
    assert refs == [False, False, False, True, True, False]
    assert verdicts == [True, True, True, True, True, False]

    def port(nr):
        return join_cuda._supports(join_cuda.make_signature(
            [TColumn.from_numpy(np.zeros(4, np.int64), tdt.INT64,
                                device="cpu")],
            [TColumn.from_numpy(np.zeros(nr, np.int64), tdt.INT64,
                                device="cpu")], "inner", "eager"))
    assert port(join_cuda.MAX_BUILD) is True
    assert port(join_cuda.MAX_BUILD + 1) is False


def test_registry_selection_and_force(monkeypatch):
    i = [TColumn.from_numpy(np.zeros(4, np.int64), tdt.INT64, device="cpu")]
    sig = join_cuda.make_signature(i, i, "inner", "eager")
    assert REGISTRY.select("hash_join", sig, backend="cuda").name == "cuda"
    assert REGISTRY.select("hash_join", sig, backend="cpu").name == "torch"
    mid = [TColumn.from_numpy(np.zeros(513, np.int64), tdt.INT64,
                              device="cpu")]
    assert REGISTRY.select(
        "hash_join", join_cuda.make_signature(i, mid, "inner", "eager"),
        backend="cuda").name == "cuda"
    big = [TColumn.from_numpy(np.zeros(join_cuda.MAX_BUILD + 1, np.int64),
                              tdt.INT64, device="cpu")]
    ch = REGISTRY.select("hash_join",
                         join_cuda.make_signature(i, big, "inner", "eager"),
                         backend="cuda")
    assert ch.fallback and ("cuda", "unsupported signature") in ch.declined
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=cuda")
    assert REGISTRY.select("hash_join", sig, backend="cpu").name == "cuda"
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=pallas")
    with pytest.raises(ValueError, match="unknown kernel"):
        REGISTRY.select("hash_join", sig, backend="cpu")


def test_wrappers_take_the_plain_version_only_on_cpu():
    k = [TColumn.from_numpy(np.arange(8, dtype=np.int64), tdt.INT64,
                          device="cpu")]
    join_cuda.reset_counters()
    join_cuda.inner_join_hash(k, k)
    assert join_cuda.PLAIN_CALLS == {"build": 1, "count": 1,
                                     "emit": 1, "exists": 0, "capped": 0}
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0,
                                  "emit": 0, "exists": 0, "capped": 0}
    # the kernel path refuses CPU tensors instead of running another way
    with pytest.raises(ValueError, match="CUDA tensors"):
        join_cuda.build_table_cuda(k, 256)



# ---- the probes' tile interface: counts -> tile offsets -> emit -------------

_TILE = 64          # small tiles, so a few hundred rows span several


def _probe_case(case, rng):
    """(probe keys, build keys) as JAX columns for one case."""
    def one(a, v=None):
        return [JColumn.from_numpy(a, validity=v)]
    if case == "int64":
        return (one(rng.integers(-40, 40, 300).astype(np.int64)),
                one(rng.integers(-40, 40, 90).astype(np.int64)))
    if case == "int32_nulls":
        return (one(rng.integers(0, 50, 260).astype(np.int32),
                    rng.random(260) > 0.1),
                one(rng.integers(0, 50, 70).astype(np.int32),
                    rng.random(70) > 0.1))
    if case == "int16":
        return (one(rng.integers(-9, 9, 200).astype(np.int16)),
                one(rng.integers(-9, 9, 40).astype(np.int16)))
    if case == "bool_nulls":
        return (one(rng.integers(0, 2, 150).astype(bool),
                    rng.random(150) > 0.2),
                one(rng.integers(0, 2, 12).astype(bool)))
    if case == "two_keys":
        return ([JColumn.from_numpy(rng.integers(0, 12, 240).astype(np.int64)),
                 JColumn.from_numpy(rng.integers(0, 3, 240).astype(np.int32),
                                    validity=rng.random(240) > 0.05)],
                [JColumn.from_numpy(rng.integers(0, 12, 80).astype(np.int64)),
                 JColumn.from_numpy(rng.integers(0, 3, 80).astype(np.int32))])
    if case == "equal_build_keys":
        # every matched row has 100 pairs: tiles past any staging buffer
        return (one(np.where(rng.random(130) < 0.4, 5, 6).astype(np.int64)),
                one(np.full(100, 5, np.int64)))
    if case == "none_matched":
        return (one(rng.integers(100, 200, 170).astype(np.int64)),
                one(rng.integers(0, 100, 60).astype(np.int64)))
    if case == "all_matched":
        keys = rng.permutation(100).astype(np.int64)[:60]
        return one(rng.choice(keys, 170)), one(keys)
    n = int(case.split("_")[1])                       # "rows_<n>"
    keys = rng.permutation(100).astype(np.int64)[:50]
    return (one(rng.choice(keys, n), rng.random(n) > 0.1), one(keys))


_PROBE_CASES = ["int64", "int32_nulls", "int16", "bool_nulls", "two_keys",
                "equal_build_keys", "none_matched", "all_matched"] + [
    f"rows_{n}" for n in (1, 7, 9, _TILE - 1, _TILE, _TILE + 1,
                          3 * _TILE - 1, 3 * _TILE, 3 * _TILE + 1)]


def _tile_starts(n, tile):
    return np.arange(0, n, tile)


@pytest.mark.parametrize("case", _PROBE_CASES)
def test_plain_probe_tiles_match_pallas(case):
    """The plain count (tiles of 64 rows) against `_probe_counts` in
    interpret mode; its tile sums and offsets, segment sums and matched
    rows and total against numpy; its lists against the reference's first
    pair of each row; the plain emit's maps against `inner_join_pallas` and
    `ops.inner_join`."""
    rng = np.random.default_rng(sum(map(ord, case)))
    lc, rc = _probe_case(case, rng)
    nl, nr = lc[0].length, rc[0].length
    lvalid = join_pallas._side_valid(lc, nl)
    rvalid = join_pallas._side_valid(rc, nr)
    ref_counts = np.asarray(join_pallas._prep_probe(
        lc, rc, lvalid, rvalid, True)[0]).astype(np.int64)
    tl, tr = [_tcol(c) for c in lc], [_tcol(c) for c in rc]
    table = join_cuda.build_table(tr, join_cuda._capacity(nr))
    probe = join_cuda.probe_counts_plain(tl, table, tr, tile=_TILE)
    npt.assert_array_equal(probe.counts.numpy(), ref_counts)
    assert probe.counts.dtype == torch.int32
    starts = _tile_starts(nl, _TILE)
    excl = np.cumsum(ref_counts) - ref_counts
    npt.assert_array_equal(probe.tile_sums.numpy(),
                           np.add.reduceat(ref_counts, starts))
    npt.assert_array_equal(probe.tile_offsets.numpy(), excl[starts])
    seg = _TILE // join_cuda.SEGMENTS
    seg_starts = _tile_starts(nl, seg)
    npt.assert_array_equal(probe.seg_sums.numpy(),
                           np.add.reduceat(ref_counts, seg_starts))
    npt.assert_array_equal(probe.seg_matched.numpy(),
                           np.add.reduceat((ref_counts > 0).astype(np.int64),
                                           seg_starts))
    assert int(probe.total) == int(ref_counts.sum())
    ref_l, ref_r = (np.asarray(c.data) for c in
                    join_pallas.inner_join_pallas(lc, rc))
    # a segment's list: its matched rows in order, each with its first
    # matching slot (holding the reference's first build row for it) and
    # its count
    w = probe.entries.numpy().astype(np.int64)
    slot_row = table.slot_row.numpy()
    rows = np.flatnonzero(ref_counts)
    listed = np.concatenate([
        w[s:s + m] for s, m in zip(seg_starts, probe.seg_matched.numpy())] +
        [np.zeros(0, np.int64)])
    npt.assert_array_equal((listed & 2047) + rows // _TILE * _TILE, rows)
    npt.assert_array_equal(listed >> 21, ref_counts[rows])
    npt.assert_array_equal(slot_row[(listed >> 11) & 1023],
                           ref_r[excl[rows]])
    got = join_cuda.probe_emit_plain(tl, table, tr, probe, int(probe.total))
    npt.assert_array_equal(got[0].numpy(), ref_l)
    npt.assert_array_equal(got[1].numpy(), ref_r)
    jl, jr = j_inner_join(lc, rc)
    npt.assert_array_equal(got[0].numpy(), np.asarray(jl.data))
    npt.assert_array_equal(got[1].numpy(), np.asarray(jr.data))


@pytest.mark.parametrize("dt", [np.int64, np.int32, np.int16, np.int8])
def test_plain_probe_on_column_views(dt):
    """Key columns (and validity) that are views one element into their
    buffers give the maps of the same keys in buffers of their own."""
    rng = np.random.default_rng(12)
    n = 3 * _TILE + 5
    lbuf = rng.integers(-20, 20, n + 1).astype(dt)
    lv = rng.random(n + 1) > 0.1
    rbuf = rng.integers(-20, 20, 41).astype(dt)
    kind = tdt.DType(tdt.Kind(JColumn.from_numpy(lbuf).dtype.kind.value))
    view_l = [TColumn(kind, n, torch.from_numpy(lbuf)[1:],
                      torch.from_numpy(lv)[1:])]
    view_r = [TColumn(kind, 40, torch.from_numpy(rbuf)[1:], None)]
    assert view_l[0].data.storage_offset() == 1
    table = join_cuda.build_table(view_r, join_cuda._capacity(40))
    probe = join_cuda.probe_counts_plain(view_l, table, view_r, tile=_TILE)
    got = join_cuda.probe_emit_plain(view_l, table, view_r, probe,
                                     int(probe.total))
    lc = [JColumn.from_numpy(lbuf[1:].copy(), validity=lv[1:].copy())]
    rc = [JColumn.from_numpy(rbuf[1:].copy())]
    ref = join_pallas.inner_join_pallas(lc, rc)
    npt.assert_array_equal(got[0].numpy(), np.asarray(ref[0].data))
    npt.assert_array_equal(got[1].numpy(), np.asarray(ref[1].data))


def test_inner_join_hash_reads_the_count_total(monkeypatch):
    """`inner_join_hash` sizes the emit from the count's total and runs no
    cumsum over the probe rows after the count (the emit's scans run over
    each tile's matched rows only)."""
    rng = np.random.default_rng(13)
    n = 5000
    k = [TColumn.from_numpy(rng.integers(0, 30, n).astype(np.int64),
                            tdt.INT64, device="cpu")]
    b = [TColumn.from_numpy(np.arange(0, 30, 2, dtype=np.int64), tdt.INT64,
                            device="cpu")]
    scanned, probes = [], []
    count, cumsum = join_cuda.probe_counts, torch.cumsum

    def counted_probe(*a):
        probes.append(count(*a))
        scanned.clear()              # the count's own tile scans
        return probes[-1]

    def counted_cumsum(x, *a, **kw):
        scanned.append(tuple(x.shape))
        return cumsum(x, *a, **kw)
    monkeypatch.setattr(join_cuda, "probe_counts", counted_probe)
    monkeypatch.setattr(torch, "cumsum", counted_cumsum)
    gl, gr = join_cuda.inner_join_hash(k, b)
    monkeypatch.undo()
    assert (n,) not in scanned
    assert probes[0].tile == join_cuda.TILE
    assert gl.length == int(probes[0].total) > 0
    ref_l, ref_r = tjoin.inner_join(k, b)
    assert torch.equal(gl.data, ref_l.data)
    assert torch.equal(gr.data, ref_r.data)


# ---- the large route: tables over SMALL_CAPACITY slots ----------------------

def _large_build(case, rng):
    if case == "rows_513_nulls":
        return [JColumn.from_numpy(rng.integers(0, 400, 513).astype(np.int64),
                                   validity=rng.random(513) > 0.1)]
    if case == "rows_1025_two_keys":
        return [JColumn.from_numpy(rng.integers(0, 9, 1025).astype(np.int32)),
                JColumn.from_numpy(rng.integers(0, 200, 1025)
                                   .astype(np.int64))]
    return [JColumn.from_numpy(np.full(600, 7, np.int64))]   # equal keys


@pytest.mark.parametrize("case", ["rows_513_nulls", "rows_1025_two_keys",
                                  "equal_600"])
def test_large_build_table_matches_pallas(case):
    """The plain build past the reference's 512 rows, slot for slot against
    `_build_table` (interpret mode), which is the oracle at every size."""
    cols = _large_build(case, np.random.default_rng(14))
    n = cols[0].length
    C = join_pallas._capacity(n)
    assert join_cuda._capacity(n) == C and join_cuda.is_large(C)
    rvalid = join_pallas._side_valid(cols, n)
    ref = np.asarray(join_pallas._build_table(cols, rvalid, C,
                                              interpret=True))
    tbl = join_cuda.build_table([_tcol(c) for c in cols], C)
    occ = tbl.slot_row.numpy() >= 0
    npt.assert_array_equal(ref[:, 0] > 0, occ)
    npt.assert_array_equal(ref[:, 1].astype(np.int64),
                           np.where(occ, tbl.slot_row.numpy(), 0))
    # the packed word the large probes read: hash << 32 | row
    words = tbl.packed().numpy()
    npt.assert_array_equal(words & 0xFFFFFFFF,
                           tbl.slot_row.numpy().astype(np.int64) & 0xFFFFFFFF)
    npt.assert_array_equal(words >> 32, tbl.slot_hash.numpy())


def _q72_inventory(rng, n_probe):
    """q72's inventory join: (item, week) probe keys against one build row
    per (item, week), 500 x 104 = 52,000 rows, both INT64."""
    items, weeks = np.meshgrid(np.arange(500), np.arange(104))
    build = [JColumn.from_numpy(items.ravel().astype(np.int64)),
             JColumn.from_numpy(weeks.ravel().astype(np.int64))]
    probe = [JColumn.from_numpy(rng.integers(0, 520, n_probe)
                                .astype(np.int64),
                                validity=rng.random(n_probe) > 0.05),
             JColumn.from_numpy(rng.integers(0, 104, n_probe)
                                .astype(np.int64))]
    return probe, build


@pytest.mark.parametrize("nr", [513, 4097, 52_000])
def test_large_route_pairs_match_jax(nr):
    """The large route's CPU mirror (its rounds, the kernel's 2,048-row
    tiles and 256-row segments, 64-bit entries: row in the tile, first
    slot << 11, count << 34) against the JAX package's `inner_join`, pair
    for pair in order."""
    rng = np.random.default_rng(nr)
    nl = 3000
    if nr == 52_000:
        lc, rc = _q72_inventory(rng, nl)
    else:
        keys = rng.integers(0, nr // 2, nr).astype(np.int64)
        rc = [JColumn.from_numpy(keys, validity=rng.random(nr) > 0.05)]
        lc = [JColumn.from_numpy(rng.integers(0, nr // 2 + 50, nl)
                                 .astype(np.int64))]
    tl, tr = [_tcol(c) for c in lc], [_tcol(c) for c in rc]
    C = join_cuda._capacity(nr)
    assert join_cuda.is_large(C)
    table = join_cuda.build_table(tr, C)
    probe = join_cuda.probe_counts_plain(tl, table, tr)
    assert probe.tile == join_cuda.TILE and probe.entries.dtype == torch.int64
    ref_l, ref_r = (np.asarray(c.data) for c in j_inner_join(lc, rc))
    counts = probe.counts.numpy().astype(np.int64)
    rows = np.flatnonzero(counts)
    seg_starts = _tile_starts(nl, probe.seg)
    w = probe.entries.numpy()
    listed = np.concatenate([
        w[s:s + m] for s, m in zip(seg_starts, probe.seg_matched.numpy())])
    excl = np.cumsum(counts) - counts
    npt.assert_array_equal((listed & 2047) + rows // probe.tile * probe.tile,
                           rows)
    npt.assert_array_equal(listed >> 34, counts[rows])
    npt.assert_array_equal(
        table.slot_row.numpy()[(listed >> 11) & ((1 << 23) - 1)],
        ref_r[excl[rows]])
    got = join_cuda.probe_emit_plain(tl, table, tr, probe, int(probe.total))
    npt.assert_array_equal(got[0].numpy(), ref_l)
    npt.assert_array_equal(got[1].numpy(), ref_r)
    gl, gr = join_cuda.inner_join_hash(tl, tr)
    npt.assert_array_equal(gl.data.numpy(), ref_l)
    npt.assert_array_equal(gr.data.numpy(), ref_r)


# ---- the rest of ops/join.py: outer joins, null_equal, the span functions --

def _outer_keys(rng, kind, n, two_keys):
    """Random INT64 or FLOAT64 key columns with nulls: small ranges so
    runs repeat; floats with NaN, ±0.0 and inf, which match as the
    reference's total order says."""
    cols = []
    for _ in range(2 if two_keys else 1):
        if kind == "int64":
            d = rng.integers(-4, 5, n).astype(np.int64)
        else:
            d = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25,
                                     np.inf]), n)
        v = rng.random(n) > 0.25
        cols.append(JColumn.from_numpy(d, validity=v))
    return cols


_OUTER_CASES = [(kind, nl, nr, two)
                for kind in ("int64", "float64")
                for nl, nr in ((0, 5), (7, 0), (40, 25), (300, 90))
                for two in (False, True)]


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("kind,nl,nr,two", _OUTER_CASES)
def test_joins_match_jax_pair_for_pair(kind, nl, nr, two, null_equal):
    """inner, left and full joins, semi and anti, under `null_equal` both
    ways: the gather maps equal the reference's pair for pair, in order."""
    from spark_rapids_tpu.ops import join as jjoin
    rng = np.random.default_rng(nl * 1000 + nr + two)
    jl, jr = _outer_keys(rng, kind, nl, two), _outer_keys(rng, kind, nr, two)
    tl, tr = [_tcol(c) for c in jl], [_tcol(c) for c in jr]
    for name in ("inner_join", "left_join", "full_join"):
        _assert_maps(getattr(jjoin, name)(jl, jr, null_equal),
                     getattr(tjoin, name)(tl, tr, null_equal))
    for name in ("left_semi_join", "left_anti_join"):
        want = getattr(jjoin, name)(jl, jr, null_equal)
        got = getattr(tjoin, name)(tl, tr, null_equal)
        npt.assert_array_equal(np.asarray(want.data), got.data.numpy())
    # a left join keeps every left row; null_equal changes what matches
    lm, rm = tjoin.left_join(tl, tr, null_equal)
    assert set(lm.data.tolist()) == set(range(nl))


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("kind,nl,nr,two", _OUTER_CASES)
def test_capped_joins_match_jax(kind, nl, nr, two, null_equal):
    """left_join_capped (lmap, rmap, rvalid, valid, overflow),
    inner_join_capped and semi_join_mask with alive masks, at caps below,
    at and above the match count, equal the reference's element for
    element."""
    import jax.numpy as jnp
    from spark_rapids_tpu.ops import join as jjoin
    rng = np.random.default_rng(nl * 7 + nr + two)
    jl, jr = _outer_keys(rng, kind, nl, two), _outer_keys(rng, kind, nr, two)
    tl, tr = [_tcol(c) for c in jl], [_tcol(c) for c in jr]
    la, ra = rng.random(nl) > 0.2, rng.random(nr) > 0.2
    full = int(tjoin.left_join(tl, tr, null_equal)[0].length)
    for cap in sorted({0, full // 2, full + 9}):
        want = jjoin.left_join_capped(jl, jr, cap, lalive=jnp.asarray(la),
                                      ralive=jnp.asarray(ra),
                                      null_equal=null_equal)
        got = tjoin.left_join_capped(tl, tr, cap, lalive=torch.tensor(la),
                                     ralive=torch.tensor(ra),
                                     null_equal=null_equal)
        assert len(got) == 5
        for w, g in zip(want, got):
            npt.assert_array_equal(np.asarray(w), g.numpy())
        want = jjoin.inner_join_capped(jl, jr, cap, lalive=jnp.asarray(la),
                                       ralive=jnp.asarray(ra),
                                       null_equal=null_equal)
        got = tjoin.inner_join_capped(tl, tr, cap, lalive=torch.tensor(la),
                                      ralive=torch.tensor(ra),
                                      null_equal=null_equal)
        for w, g in zip(want, got):
            npt.assert_array_equal(np.asarray(w), g.numpy())
    npt.assert_array_equal(
        np.asarray(jjoin.semi_join_mask(jl, jr, lalive=jnp.asarray(la),
                                        null_equal=null_equal)),
        tjoin.semi_join_mask(tl, tr, lalive=torch.tensor(la),
                             null_equal=null_equal).numpy())
    # without masks the capped left join is the eager one's prefix
    lm, rm, rv, v, ovf = tjoin.left_join_capped(tl, tr, full + 3,
                                                null_equal=null_equal)
    el, er = tjoin.left_join(tl, tr, null_equal)
    assert not bool(ovf) and int(v.sum()) == full
    npt.assert_array_equal(lm[:full].numpy(), el.data.numpy())
    npt.assert_array_equal(np.where(rv[:full].numpy(), rm[:full].numpy(),
                                    -1), er.data.numpy())


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_join_spans_and_expand_spans_match_jax(kind):
    """The public span functions: counts, lo and rorder (matchable right
    rows first, then n) from the same union operands and match masks, and
    their expansion into static slots, outer or not, with and without an
    emit count, padded slots included."""
    import jax.numpy as jnp
    from spark_rapids_tpu.ops import join as jjoin
    from spark_rapids_tpu.ops.sort import _key_operands as jkey_operands
    from spark_rapids_tpu_torch.ops.sort import _key_operands
    rng = np.random.default_rng(5)
    for nl, nr in ((0, 4), (6, 0), (120, 60)):
        (jl,), (jr,) = (_outer_keys(rng, kind, nl, False),
                        _outer_keys(rng, kind, nr, False))
        jops = jkey_operands(jjoin._concat_columns(jl, jr), True, None)
        tops = _key_operands(tjoin._concat(_tcol(jl), _tcol(jr)), True, None)
        lv, rv = rng.random(nl) > 0.3, rng.random(nr) > 0.3
        want = jjoin.join_spans(jops, jnp.asarray(lv), jnp.asarray(rv),
                                nl=nl)
        got = tjoin.join_spans(tops, torch.tensor(lv), torch.tensor(rv),
                               nl=nl)
        for w, g in zip(want, got):
            npt.assert_array_equal(np.asarray(w), g.numpy())
        eff = rng.integers(0, 3, nl)
        for outer in (False, True):
            for total in (0, 200):
                for e in (None, eff):
                    w = jjoin.expand_spans(*want, total=total, outer=outer,
                                           eff=None if e is None
                                           else jnp.asarray(e))
                    g = tjoin.expand_spans(*got, total=total, outer=outer,
                                           eff=None if e is None
                                           else torch.tensor(e))
                    for a, b in zip(w, g):
                        npt.assert_array_equal(np.asarray(a), b.numpy())


def test_null_equal_matches_null_keys_only_when_asked():
    """Null keys match each other under null_equal, and alive masks still
    exclude their rows."""
    lk = [TColumn.from_pylist([None, 1, None, 2], tdt.INT64, device="cpu")]
    rk = [TColumn.from_pylist([None, 2, None], tdt.INT64, device="cpu")]
    lm, rm = tjoin.inner_join(lk, rk)
    assert list(zip(lm.data.tolist(), rm.data.tolist())) == [(3, 1)]
    lm, rm = tjoin.inner_join(lk, rk, null_equal=True)
    assert list(zip(lm.data.tolist(), rm.data.tolist())) == [
        (0, 0), (0, 2), (2, 0), (2, 2), (3, 1)]
    lm, rm = tjoin.full_join(lk, rk)
    assert list(zip(lm.data.tolist(), rm.data.tolist())) == [
        (0, -1), (1, -1), (2, -1), (3, 1), (-1, 0), (-1, 2)]
    mask = tjoin.semi_join_mask(lk, rk, ralive=torch.tensor([False, True,
                                                             True]),
                                null_equal=True)
    assert mask.tolist() == [True, False, True, True]
    mask = tjoin.semi_join_mask(lk, rk, lalive=torch.tensor([False, True,
                                                             True, True]),
                                ralive=torch.tensor([False, True, False]),
                                null_equal=True)
    assert mask.tolist() == [False, False, False, True]
