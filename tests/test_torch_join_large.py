"""The hash join's large route (build sides over 512 rows, tables over
1,024 slots; spark_rapids_tpu_torch/ops/join_cuda.py) against the JAX
package on the CPU, on the same numpy inputs, split from
tests/test_torch_join_probe.py so that the files spread over the test
workers: the large build table slot for slot against
`join_pallas._build_table` (interpret mode) at 513, 1,025 and 600 equal
keys, and the large route's pairs against the JAX join at 513, 4,097 and
52,000 build rows. The tolerance is exact: join maps are integers.
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
from spark_rapids_tpu_torch.ops import join_cuda


def _tcol(jc: JColumn) -> TColumn:
    v = None if jc.validity is None else np.asarray(jc.validity)
    return TColumn.from_numpy(np.asarray(jc.data),
                              tdt.DType(tdt.Kind(jc.dtype.kind.value),
                                        jc.dtype.precision, jc.dtype.scale),
                              v, device="cpu")


def _tile_starts(n, tile):
    return np.arange(0, n, tile)


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
