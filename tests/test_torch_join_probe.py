"""The port's hash-join probes and large route (spark_rapids_tpu_torch/
ops/join_cuda.py) against the JAX package on the CPU, on the same numpy
inputs, split from tests/test_torch_join.py so that the files spread over
the test workers: the probes' tile interface (counts, tile sums and
offsets, segment lists, emit) against `join_pallas._prep_probe` and
`inner_join_pallas` (Pallas interpret mode), column views, the one host
read of the count total. The large route is in
tests/test_torch_join_large.py. The tolerance is exact: join maps are
integers.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
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


def _tcol(jc: JColumn) -> TColumn:
    v = None if jc.validity is None else np.asarray(jc.validity)
    return TColumn.from_numpy(np.asarray(jc.data),
                              tdt.DType(tdt.Kind(jc.dtype.kind.value),
                                        jc.dtype.precision, jc.dtype.scale),
                              v, device="cpu")


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
