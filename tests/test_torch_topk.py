"""TopK in the port against the JAX package: the plain version against
`topk_pallas.topk_table` (Pallas interpret mode) and against `sort_table`
+ `slice_table`, bit for bit with validity and tie order, on the cases of
tests/test_kernel_registry.py; the order words the CUDA kernel compares
against the stable sort, and the kernel's own encoding of them from its
key descriptor (`topk.encode_words`) against `order_words`; the threshold
kernel's selection, mirrored on the CPU (`_threshold_select`), against
`topk_plain` on random, descending, all-equal and all-null keys and at the
route boundary; the registry's declines against `topk_pallas._supports`,
which the port's kernel widens to any limit."""
import torch_threads  # noqa: F401  (one torch thread a worker)
from typing import List, Optional

import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu.ops import slice_table as jslice
from spark_rapids_tpu.ops import sort_table as jsort
from spark_rapids_tpu.ops import topk_pallas
from spark_rapids_tpu.ops.registry import Signature as JSignature

from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.ops import copying, gather, sort, topk, topk_cuda
from spark_rapids_tpu_torch.ops.registry import REGISTRY, Signature
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield


def _tables(arrays):
    jt = JTable([JColumn.from_numpy(a, validity=v)
                 for a, v in arrays.values()], names=list(arrays))
    tt = table_from_numpy(
        list(arrays), [a for a, _ in arrays.values()],
        [v for _, v in arrays.values()],
        ["bool" if a.dtype == np.bool_ else a.dtype.name
         for a, _ in arrays.values()], device="cpu")
    return jt, tt


def _assert_same(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        data, valid = tc.to_numpy()
        npt.assert_array_equal(np.asarray(jc.data), data)
        jv = None if jc.validity is None else np.asarray(jc.validity)
        nj = np.zeros(jt.num_rows, bool) if jv is None else ~jv
        nt = np.zeros(tt.num_rows, bool) if valid is None else ~valid
        npt.assert_array_equal(nj, nt)


def _assert_words_order(tt, keys, asc):
    """The order words, read as unsigned and sorted lexicographically, give
    the stable sort's permutation: what the kernel's tuple compare needs."""
    w = topk.order_words(tt, keys, asc).numpy().view(np.uint64)
    perm = np.lexsort(w[::-1])
    ref = sort.sorted_order([tt[k] for k in keys], asc).data.numpy()
    npt.assert_array_equal(perm, ref)


_TK_CASES = [
    (np.int64, True), (np.int64, False),
    (np.int32, True), (np.int16, False),
    (np.float32, True), (np.float64, False),
    (np.bool_, True),
]


def _key(rng, dt, n):
    if dt is np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if np.issubdtype(dt, np.floating):
        arr = rng.standard_normal(n).astype(dt)
        arr[rng.random(n) < 0.05] = np.nan
        arr[:2] = [0.0, -0.0]
        return arr
    return rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n, dtype=dt,
                        endpoint=True)


@pytest.mark.parametrize("dt,asc", _TK_CASES)
@pytest.mark.parametrize("with_nulls", [False, True])
def test_dtype_matrix_matches_pallas(dt, asc, with_nulls):
    rng = np.random.default_rng(3)
    n, k = 900, 17
    arrays = {"k": (_key(rng, dt, n),
                    (rng.random(n) > 0.2) if with_nulls else None),
              "pay": (rng.integers(0, 9, n).astype(np.int32), None)}
    jt, tt = _tables(arrays)
    got = topk.topk_plain(tt, ["k"], [asc], k)
    _assert_same(jslice(jsort(jt, key_names=["k"], ascending=[asc]), 0, k),
                 got)
    _assert_same(topk_pallas.topk_table(jt, ["k"], [asc], k,
                                        block_rows=256), got)
    _assert_words_order(tt, ["k"], [asc])
    for kk in (1, 100, 128):
        _assert_same(jslice(jsort(jt, key_names=["k"], ascending=[asc]),
                            0, kk), topk.topk_plain(tt, ["k"], [asc], kk))


def test_multikey_and_edges():
    rng = np.random.default_rng(4)
    n = 500
    arrays = {"a": (rng.integers(0, 4, n).astype(np.int64),
                    rng.random(n) > 0.1),
              "b": (rng.standard_normal(n).astype(np.float64), None)}
    jt, tt = _tables(arrays)
    for asc in ([True, False], [False, True]):
        got = topk.topk_plain(tt, ["a", "b"], asc, 11)
        _assert_same(topk_pallas.topk_table(jt, ["a", "b"], asc, 11,
                                            block_rows=256), got)
        _assert_words_order(tt, ["a", "b"], asc)
    # k > n clamps to the relation
    _assert_same(jsort(jt, key_names=["a"], ascending=[True]),
                 topk.topk_plain(tt, ["a"], [True], n + 50))
    # empty table
    _, t0 = _tables({"a": (np.zeros(0, np.int64), None)})
    assert topk.topk_plain(t0, ["a"], [True], 5).num_rows == 0
    assert topk_cuda.topk_table(t0, ["a"], [True], 5).num_rows == 0


def test_slice_table_matches_reference():
    rng = np.random.default_rng(6)
    jt, tt = _tables({"a": (rng.integers(0, 9, 30), rng.random(30) > 0.3)})
    for start, end in ((0, 7), (5, 5), (25, 99), (-3, 4), (40, 50)):
        _assert_same(jslice(jt, start, end),
                     copying.slice_table(tt, start, end))


def test_declines_match_the_reference():
    _, tt = _tables({"a": (np.arange(5, dtype=np.int64), None),
                     "f": (np.arange(5.0, dtype=np.float32),
                           np.ones(5, bool))})
    jt, _ = _tables({"a": (np.arange(5, dtype=np.int64), None),
                     "f": (np.arange(5.0, dtype=np.float32),
                           np.ones(5, bool))})
    # the port's kernel takes any limit; the reference's 1..128 (its lanes)
    for keys, n, tier in ((["a"], 5, "eager"), (["a", "f"], 128, "eager"),
                          (["a"], topk_pallas.MAX_K + 1, "eager"),
                          (["a", "f"], 100_000, "eager"),
                          (["a"], 0, "eager"), (["f"], 5, "capped"),
                          (["a"], 5, "streaming")):
        ref = topk_pallas._supports(topk_pallas.make_signature(
            jt, keys, [True] * len(keys), n, tier))
        sig = topk.make_signature(tt, keys, [True] * len(keys), n, tier)
        widened = tier == "eager" and not 1 <= n <= topk_pallas.MAX_K
        assert topk.supports(sig) == (ref or widened), (keys, n, tier)
        assert not (ref and widened), (keys, n, tier)
        ch = REGISTRY.select("topk", sig, backend="cuda")
        assert ch.label == ("cuda:topk" if ref or widened else "torch:topk")
    for cols in ((("string", False),), (("int64", True),) * 48):
        sig = Signature(columns=cols, extras=(("limit", 5),
                                              ("tier", "eager")))
        jsig = JSignature(columns=cols, extras=(("limit", 5),
                                                ("tier", "eager")))
        # 48 nullable keys are 97 words: past the kernel's tile, which the
        # TPU kernel did not have; a STRING key the port's kernels take
        # (its words from the chars), where the TPU kernel declined it
        assert topk.supports(sig) == (cols[0][0] == "string")
        assert topk_pallas._supports(jsig) == (cols[0][0] != "string")


def test_plan_topk_forced_kernel_runs_plain_on_cpu(monkeypatch):
    rng = np.random.default_rng(9)
    _, tt = _tables({"k": (rng.integers(0, 20, 400), rng.random(400) > 0.1),
                     "v": (rng.integers(0, 5, 400).astype(np.int32), None)})
    plan = (PlanBuilder().scan("t", schema=["k", "v"])
            .sort(["k", "v"], ascending=[False, True]).limit(30).build())
    want = PlanExecutor(device="cpu", optimize=False).execute(plan,
                                                              {"t": tt})
    assert [m.kind for m in want.metrics.values()] == ["Scan", "Sort",
                                                      "Limit"]
    # the plain version counts its own runs, wherever it is called from
    for force, stamp, plain in ((False, "torch:topk", 1),
                                (True, "cuda:topk", 1)):
        if force:
            monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "topk=cuda")
        topk_cuda.reset_counters()
        res = PlanExecutor(device="cpu").execute(plan, {"t": tt})
        assert [m.kernel for m in res.metrics.values()
                if m.kind == "TopK"] == [stamp]
        assert topk_cuda.PLAIN_CALLS == {"topk": plain}
        assert topk_cuda.LAUNCHES == {"threshold": 0, "select": 0,
                                      "merge": 0, "final": 0}
        for a, c in zip(want.table.columns, res.table.columns):
            assert torch.equal(a.data, c.data)
            assert torch.equal(a.null_mask, c.null_mask)


# ---- the kernel's encoding and its threshold selection, mirrored ------------

_EDGES = {np.float32: [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                       np.finfo(np.float32).tiny / 4, -1e-45,
                       np.finfo(np.float32).max, np.finfo(np.float32).min],
          np.float64: [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 5e-324,
                       -5e-324, np.finfo(np.float64).max,
                       np.finfo(np.float64).min]}


def _edge_key(rng, dt, n):
    a = _key(rng, dt, n)
    if dt in _EDGES:
        e = np.array(_EDGES[dt], dt)
        # a NaN with another payload and sign canonicalises too
        bits = np.uint32 if dt is np.float32 else np.uint64
        e[5] = np.array(np.iinfo(bits).max, bits).view(dt)
        a[:len(e)] = e
    elif dt is not np.bool_:
        ii = np.iinfo(dt)
        a[:4] = [ii.min, ii.max, 0, -1]
    return a


@pytest.mark.parametrize("dt", [np.int64, np.int32, np.int16, np.int8,
                                np.float32, np.float64, np.bool_])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_kernel_encoding_equals_order_words(dt, asc, with_nulls):
    rng = np.random.default_rng(11)
    n = 600
    arrays = {"k": (_edge_key(rng, dt, n),
                    (rng.random(n) > 0.2) if with_nulls else None),
              "pay": (rng.integers(-3, 3, n).astype(np.int8),
                      rng.random(n) > 0.5)}
    _, tt = _tables(arrays)
    for keys, ascs in ((["k"], [asc]), (["pay", "k"], [not asc, asc])):
        d = topk.describe_keys(tt, keys, ascs)
        got = topk.encode_words(tt, keys, ascs)
        assert d.n_words == got.shape[0]
        assert torch.equal(got, topk.order_words(tt, keys, ascs))


# csrc/topk.cu tk_threshold, mirrored with numpy: its block walk, buffer
# capacity, flush rule and threshold updates

_ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _below(tuples: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """(n,) bool: each column of the (W, n) uint64 tuples strictly below
    the (W,) threshold, the first differing word deciding."""
    below = np.zeros(tuples.shape[1], bool)
    open_ = np.ones(tuples.shape[1], bool)
    for w in range(tuples.shape[0]):
        differ = open_ & (tuples[w] != thr[w])
        below |= differ & (tuples[w] < thr[w])
        open_ &= ~differ
    return below


def _flush(best: np.ndarray, buf: List[np.ndarray], k: int,
           thr: np.ndarray):
    """The best (at most k, in no order) and the threshold after a flush,
    as the kernel's flush finds them: up to k items all kept, the
    threshold left open; else the k smallest by a radix select over the
    tuples' bytes, most significant first, skipping the bytes the
    undecided tuples share, the threshold the path of bytes it took, then
    all ones: no smaller than any tuple kept."""
    both = np.concatenate([best] + buf, axis=1)
    n = both.shape[1]
    if n <= k:
        return both, thr
    undecided = np.ones(n, bool)
    kept = np.zeros(n, bool)
    need, done, bound = k, False, []
    for col in both:
        if done:
            bound.append(int(_ALL_ONES))
            continue
        o = int(np.bitwise_or.reduce(col[undecided]))
        a = int(np.bitwise_and.reduce(col[undecided]))
        word = 0
        for j in range(8):
            shift = 56 - 8 * j
            if done:
                word = (word << 8) | 0xFF
                continue
            if ((o ^ a) >> shift) & 0xFF == 0:
                word = (word << 8) | ((a >> shift) & 0xFF)
                continue
            d = ((col >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64)
            hist = np.bincount(d[undecided], minlength=256)
            at = int(np.searchsorted(np.cumsum(hist), need))
            below = int(hist[:at].sum())
            every = below + int(hist[at]) == need
            kept |= undecided & ((d < at) | ((d == at) & every))
            undecided &= (d == at) & (not every)
            need -= below
            done = every
            word = (word << 8) | at
        bound.append(word)
    if not done:                 # equal tuples (sentinels): any of them
        kept[np.flatnonzero(undecided)[:need]] = True
    return both[:, kept], np.array(bound, np.uint64)


def _walk(best: np.ndarray, thr: np.ndarray, k: int, items: np.ndarray,
          tiles: range, skip: Optional[range] = None):
    """One block's walk: it flushes before a tile its buffer cannot take
    and, while it holds fewer than k, as soon as k items wait."""
    buf, count = [], 0
    n = items.shape[1]
    for t in tiles:
        have = best.shape[1]
        if (count + topk.TILE_ROWS > topk.BUFFER
                or (have < k and have + count >= k)):
            (best, thr), buf, count = _flush(best, buf, k, thr), [], 0
        lo, hi = t * topk.TILE_ROWS, min((t + 1) * topk.TILE_ROWS, n)
        tile = items[:, lo:hi]
        keep = _below(tile, thr)
        if skip is not None:
            at = np.arange(lo, hi)
            keep &= (at < skip.start) | (at >= skip.stop)
        buf.append(tile[:, keep])
        count += int(keep.sum())
    return _flush(best, buf, k, thr) if count else (best, thr)


def _threshold_select(words: np.ndarray, k: int, blocks: int) -> np.ndarray:
    """int64 row indices of the k smallest of the (W, m) uint64 tuples, in
    order, computed as csrc/topk.cu tk_threshold computes them over
    `blocks` blocks: each block walks tiles b, b + blocks, ..., appending
    the rows below its threshold to a buffer of topk.BUFFER and flushing as
    `_walk` says; each writes its best k as a run (all ones past what it
    holds), and the last block walks the other blocks' runs, then sorts
    its k. 1 <= k <= m."""
    W, m = words.shape
    tiles = -(-m // topk.TILE_ROWS)
    open_thr = np.full(W, _ALL_ONES, np.uint64)
    runs = []
    for b in range(blocks):
        best, thr = _walk(np.zeros((W, 0), np.uint64), open_thr, k, words,
                          range(b, tiles, blocks))
        run = np.full((W, k), _ALL_ONES, np.uint64)
        run[:, :best.shape[1]] = best
        runs.append((run, thr))
    best, thr = runs[-1]
    if blocks > 1:
        cand = np.concatenate([r for r, _ in runs], axis=1)
        own = range((blocks - 1) * k, blocks * k)
        best, _ = _walk(best, thr, k, cand,
                        range(-(-cand.shape[1] // topk.TILE_ROWS)), own)
    best = best[:, np.lexsort(best[::-1])]
    return best[-1].astype(np.int64)


def _mirror_rows(tt, keys, asc, k, sms=132):
    """The threshold kernel's row indices for the call, as the CPU mirror
    computes them with the wrapper's grid."""
    k = min(k, tt.num_rows)
    words = topk.encode_words(tt, keys, asc).numpy().view(np.uint64)
    blocks = topk.threshold_grid(tt.num_rows, k, sms)
    return _threshold_select(words, k, blocks), blocks


def _selection_table(which, n, rng):
    if which == "descending":
        # every row beats every block's threshold
        return {"k": (np.arange(n, 0, -1).astype(np.int64), None)}, [True]
    if which == "all_equal":
        return {"k": (np.zeros(n, np.int32), None)}, [False]
    if which == "all_null":
        return {"k": (rng.integers(0, 9, n).astype(np.int64),
                      np.zeros(n, bool))}, [False]
    return {"k": (rng.integers(-50, 50, n).astype(np.int64),
                  rng.random(n) > 0.1),
            "v": (rng.standard_normal(n).astype(np.float32), None)}, \
        [False, True]


@pytest.mark.parametrize("which,n,k", [
    ("random", 100_000, 100), ("random", 100_000, 1),
    ("random", 40_000, 2989),          # the route boundary at 4 words
    ("random", 3_000, 5_000),          # k > rows: one block, k = rows
    ("random", 1_781, 100),            # TPC-DS q3's groups: one block
    ("descending", 70_000, 100), ("all_equal", 70_000, 50),
    ("all_null", 70_000, 100)])
def test_threshold_selection_mirror_equals_topk_plain(which, n, k):
    rng = np.random.default_rng(12)
    arrays, asc = _selection_table(which, n, rng)
    _, tt = _tables(arrays)
    keys = list(arrays)
    rows, blocks = _mirror_rows(tt, keys, asc, k)
    # under two blocks' worth of tiles one block walks every row; above,
    # the last block merges the others' runs
    assert (blocks == 1) == (n < 2 * topk.MIN_TILES_PER_BLOCK
                             * topk.TILE_ROWS)
    got = gather.take_table(tt, torch.from_numpy(rows), _has_negative=False)
    want = topk.topk_plain(tt, keys, asc, k)
    for a, b in zip(got.columns, want.columns):
        assert torch.equal(a.data, b.data)
        assert torch.equal(a.null_mask, b.null_mask)


def test_route_rule_and_grid():
    optin = 232_448                    # an H100's opt-in bytes a block
    # kernel_bench.py's keys: a nullable INT64 and a FLOAT32, 4 words
    assert topk.threshold_route(2989, 4, optin)
    assert not topk.threshold_route(2990, 4, optin)
    assert topk.threshold_route(3_000, 2, optin)
    # the widest tuples: small limits fit, the best set of large ones not
    assert topk.threshold_route(1, topk.MAX_WORDS, optin)
    assert not topk.threshold_route(1_000, topk.MAX_WORDS, optin)
    assert topk.threshold_smem(100, 4) > topk.threshold_smem(100, 2)
    # a small input walks one block; 10M rows fill two blocks an SM
    assert topk.threshold_grid(1_781, 100, 132) == 1
    assert topk.threshold_grid(32_767, 1, 132) == 1
    assert topk.threshold_grid(10_000_000, 100, 132) == 264
    assert topk.threshold_grid(10_000_000, 1_000, 132) == 100
