"""The hash join's build without rounds, and the semi and anti joins on the
hash-join kernels, on the CPU against the reference.

- `join_cuda.build_table_closed_form`, the kernels' closed form of the
  insertion rounds in their order of work (bucket counts, the scan of the
  slots' maps twice round the ring, each bucket's rows in order, the search
  back from each slot), slot for slot and with its `rounds` against the
  plain version's rounds (`build_table_plain`) and, for the key kinds and
  sizes the reference's Pallas build takes, against
  `join_pallas._build_table` in interpret mode: clusters that wrap past the
  last slot, every row in one bucket and in the last bucket, 512 equal
  keys, nulls, no valid row, n = 0 and n = C / 2, C from 256 to 2^14, on
  INT32, INT64, FLOAT64 (+-0.0 and NaN), DECIMAL128 and STRING keys.
- The existence probe's plain version and the semi and anti joins' CPU
  path (`semi_join_mask_hash`, `left_semi_join_hash`,
  `left_anti_join_hash`) against `ops.join`'s sort-based forms and the JAX
  package's `semi_join_mask`, `left_semi_join` and `left_anti_join`: alive
  masks on both sides, nulls, every kind the kernels take, empty sides.
- The registry: `_supports` takes semi and anti joins and declines what it
  declines for inner ones; a plan's semi join with mismatched key dtypes
  raises the sort-based join's TypeError on every route.

Exact throughout: tables, masks and gather maps are integers.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.ops import join_pallas

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import nds_q5, nds_q23
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.interop import Buffers, column_from_buffers
from spark_rapids_tpu_torch.ops import join, join_cuda
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield


def _port_dtype(jd) -> tdt.DType:
    return tdt.DType(tdt.Kind(jd.kind.value), jd.precision, jd.scale)


def _tcol(jc: JColumn) -> Column:
    def arr(a):
        return None if a is None else np.asarray(a)
    return column_from_buffers(
        Buffers(_port_dtype(jc.dtype), jc.length, arr(jc.data),
                arr(jc.validity), arr(jc.offsets), ()), "cpu")


# ---- the build ---------------------------------------------------------------

_KIND_DTYPES = {"int32": jdt.INT32, "int64": jdt.INT64,
                "float64": jdt.FLOAT64, "decimal": jdt.decimal(38, 2),
                "string": jdt.STRING}


def _values(kind, ids):
    """Distinct keys of `kind`, one per id (floats include -0.0 for 0)."""
    if kind in ("int32", "int64"):
        return [int(i) for i in ids]
    if kind == "float64":
        return [-0.0 if i == 0 else float(i) * 0.5 for i in ids]
    if kind == "decimal":
        return [int(i) * 10 ** 20 + int(i) for i in ids]
    return [f"key-{int(i)}" for i in ids]


def _jcol(kind, values):
    return JColumn.from_pylist(values, _KIND_DTYPES[kind])


def _in_buckets(kind, C, buckets, n, rng):
    """n distinct keys of `kind` whose bucket (h & (C - 1)) is in
    `buckets`, drawn in a random order."""
    ids = np.arange(2 * n * C // len(buckets) + 1000)
    cand = _tcol(_jcol(kind, _values(kind, ids)))
    b = (join_cuda.row_hash([cand]) & (C - 1)).numpy()
    pick = ids[np.isin(b, list(buckets))]
    assert pick.shape[0] >= n
    return _values(kind, rng.permutation(pick)[:n])


def _build_keys(kind, case, C, rng):
    """The build side's key values (None for null) for one case."""
    if case == "empty":
        return []
    if case == "wrap":           # clusters across the last slot into slot 0
        keys = _in_buckets(kind, C, (C - 3, C - 2, C - 1, 0), 64, rng)
        return keys + _values(kind, rng.integers(0, 10 * C, C // 4))
    if case == "last_bucket":    # every row in bucket C - 1, distinct keys
        return _in_buckets(kind, C, (C - 1,), C // 2, rng)
    if case == "one_bucket":     # every row in one bucket, distinct keys
        return _in_buckets(kind, C, (C // 3,), C // 2, rng)
    if case == "equal_512":      # 512 equal keys (floats: 0.0 and -0.0)
        if kind == "float64":
            return [0.0 if i % 2 else -0.0 for i in range(512)]
        return _values(kind, [7]) * 512
    if case == "all_null":
        return [None] * (C // 4)
    if case == "nulls":          # duplicates and nulls; floats NaN, +-0.0
        n = C // 2
        if kind == "float64":
            vals = [0.0, -0.0, float("nan"), float("inf"), 1.5, -2.25]
            keys = [vals[i] for i in rng.integers(0, len(vals), n)]
        else:
            keys = _values(kind, rng.integers(0, n // 3 + 1, n))
        return [None if v else k for k, v in zip(keys, rng.random(n) < 0.3)]
    return _values(kind, rng.permutation(4 * C)[:C // 2])   # "half"


_BUILD_CASES = [(kind, case, C)
                for kind in _KIND_DTYPES
                for case, C in (("empty", 256), ("wrap", 256),
                                ("wrap", 4096), ("last_bucket", 256),
                                ("one_bucket", 512), ("equal_512", 1024),
                                ("all_null", 2048), ("nulls", 512),
                                ("nulls", 4096), ("half", 256),
                                ("half", 1024), ("half", 2048),
                                ("half", 1 << 14))]


@pytest.mark.parametrize("kind,case,C", _BUILD_CASES)
def test_closed_form_build_matches_the_rounds(kind, case, C):
    rng = np.random.default_rng(C + len(case))
    jc = _jcol(kind, _build_keys(kind, case, C, rng))
    cols = [_tcol(jc)]
    want = join_cuda.build_table_plain(cols, C)
    got = join_cuda.build_table_closed_form(cols, C)
    npt.assert_array_equal(got.slot_row.numpy(), want.slot_row.numpy())
    npt.assert_array_equal(got.slot_hash.numpy(), want.slot_hash.numpy())
    assert int(got.rounds) == int(want.rounds)
    n_valid = int(join._side_valid(cols, jc.length, "cpu").sum())
    assert (int(got.rounds) == 0) == (n_valid == 0)
    assert int((got.slot_row >= 0).sum()) == n_valid
    if case == "wrap":           # a cluster runs past slot C - 1 into 0
        occ = got.slot_row.numpy() >= 0
        assert occ[C - 1] and occ[0]
    if kind in ("int32", "int64") and 0 < jc.length and C <= 1024:
        rvalid = join_pallas._side_valid([jc], jc.length)
        ref = np.asarray(join_pallas._build_table([jc], rvalid, C,
                                                  interpret=True))
        occ = got.slot_row.numpy() >= 0
        npt.assert_array_equal(ref[:, 0] > 0, occ)
        npt.assert_array_equal(ref[:, 1].astype(np.int64),
                               np.where(occ, got.slot_row.numpy(), 0))


def test_closed_form_build_on_two_keys_and_views():
    """Two key columns, one a view one element into its buffers, C = 2^14
    at n = C / 2: the closed form against the rounds."""
    rng = np.random.default_rng(3)
    n, C = 1 << 13, 1 << 14
    a = Column.from_numpy(rng.integers(0, 90, n + 1).astype(np.int32),
                          tdt.INT32, rng.random(n + 1) > 0.1, device="cpu")
    a = Column(tdt.INT32, n, a.data[1:], a.validity[1:])
    b = Column.from_pylist(_values("string", rng.integers(0, 50, n)),
                           tdt.STRING, device="cpu")
    want = join_cuda.build_table_plain([a, b], C)
    got = join_cuda.build_table_closed_form([a, b], C)
    assert torch.equal(got.slot_row, want.slot_row)
    assert torch.equal(got.slot_hash, want.slot_hash)
    assert int(got.rounds) == int(want.rounds) > 1


# ---- semi and anti joins ------------------------------------------------------

_SEMI_KINDS = {
    "bool": (jdt.BOOL, [True, False]),
    "int8": (jdt.INT8, [-3, 0, 5, 127]),
    "int16": (jdt.INT16, [-300, 0, 7, 9]),
    "int32": (jdt.INT32, [-(2 ** 31), 0, 1, 2 ** 31 - 1]),
    "date32": (jdt.DATE32, [0, 18000, 18001, -1]),
    "int64": (jdt.INT64, [-(2 ** 63), 0, 1, 2 ** 40]),
    "timestamp": (jdt.TIMESTAMP_US, [0, 10 ** 15, -5]),
    "decimal32": (jdt.decimal(9, 2), [0, 12345, -1]),
    "decimal64": (jdt.decimal(18, 4), [0, 10 ** 17, -7]),
    "float32": (jdt.FLOAT32, [0.0, -0.0, float("nan"), 1.5, float("inf")]),
    "float64": (jdt.FLOAT64, [0.0, -0.0, float("nan"), -2.25]),
    "decimal128": (jdt.decimal(38, 2), [0, 10 ** 38 - 1, -(10 ** 38 - 1),
                                        2 ** 64]),
    "string": (jdt.STRING, ["", "a", "a\x00", "pre_1", "pre_12", "日本"]),
}


def _semi_col(kind, n, rng, null_p=0.2):
    dt, vocab = _SEMI_KINDS[kind]
    idx = rng.integers(0, len(vocab), n)
    return JColumn.from_pylist([None if rng.random() < null_p else vocab[i]
                                for i in idx], dt)


@pytest.mark.parametrize("kind", sorted(_SEMI_KINDS))
@pytest.mark.parametrize("nl,nr", [(0, 5), (7, 0), (40, 25), (300, 600)])
def test_semi_and_anti_joins_match_the_sort_route_and_jax(kind, nl, nr):
    rng = np.random.default_rng(nl * 7 + nr)
    jl = [_semi_col(kind, nl, rng), _semi_col("int32", nl, rng, 0.05)]
    jr = [_semi_col(kind, nr, rng), _semi_col("int32", nr, rng, 0.05)]
    tl, tr = [_tcol(c) for c in jl], [_tcol(c) for c in jr]
    la, ra = rng.random(nl) < 0.7, rng.random(nr) < 0.7
    want = np.asarray(jjoin.semi_join_mask(jl, jr, lalive=jnp.asarray(la),
                                           ralive=jnp.asarray(ra)))
    for fn in (join_cuda.semi_join_mask_hash, join.semi_join_mask):
        got = fn(tl, tr, lalive=torch.from_numpy(la),
                 ralive=torch.from_numpy(ra))
        assert got.dtype == torch.bool
        npt.assert_array_equal(got.numpy(), want)
    for hashed, port, ref in (
            (join_cuda.left_semi_join_hash, join.left_semi_join,
             jjoin.left_semi_join),
            (join_cuda.left_anti_join_hash, join.left_anti_join,
             jjoin.left_anti_join)):
        want = np.asarray(ref(jl, jr).data)
        got = hashed(tl, tr)
        assert got.data.dtype == torch.int32 and got.length == want.shape[0]
        npt.assert_array_equal(got.data.numpy(), want)
        npt.assert_array_equal(port(tl, tr).data.numpy(), want)


@pytest.mark.parametrize("nr", [40, 513, 5000])
def test_probe_exists_plain_is_the_count_above_zero(nr):
    """The existence probe's plain version against the count's, on both
    routes' capacities, with nulls on both sides."""
    rng = np.random.default_rng(nr)
    b = [Column.from_numpy(rng.integers(0, nr, nr).astype(np.int64),
                           tdt.INT64, rng.random(nr) > 0.1, device="cpu")]
    p = [Column.from_numpy(rng.integers(0, 2 * nr, 3000).astype(np.int64),
                           tdt.INT64, rng.random(3000) > 0.1, device="cpu")]
    table = join_cuda.build_table(b, join_cuda._capacity(nr))
    got = join_cuda.probe_exists_plain(p, table, b)
    want = join_cuda.probe_counts_plain(p, table, b).counts > 0
    assert torch.equal(got, want) and bool(got.any()) and not bool(got.all())


def test_exists_wrapper_takes_the_plain_version_only_on_cpu():
    k = [Column.from_numpy(np.arange(8, dtype=np.int64), tdt.INT64,
                           device="cpu")]
    join_cuda.reset_counters()
    mask = join_cuda.semi_join_mask_hash(k, k)
    assert bool(mask.all())
    assert join_cuda.PLAIN_CALLS == {"build": 1, "count": 0, "emit": 0,
                                     "exists": 1, "capped": 0}
    assert sum(join_cuda.LAUNCHES.values()) == 0
    table = join_cuda.build_table(k, 256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        join_cuda.probe_exists_cuda(k, table, k)


def _sig(how, lk=np.int64, rk=np.int64, nr=4):
    def one(a):
        return [_tcol(JColumn.from_numpy(a))]
    return join_cuda.make_signature(one(np.zeros(4, lk)),
                                    one(np.zeros(nr, rk)), how, "eager")


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_supports_semi_and_anti_as_inner(how):
    """Semi and anti joins are taken where an inner join is, and declined
    where it is: other key kinds on the two sides, a build side over
    MAX_BUILD rows; outer joins stay declined."""
    for lk, rk, nr in ((np.int64, np.int64, 4), (np.int32, np.int64, 4),
                       (np.float32, np.float32, 4),
                       (np.int64, np.int64, join_cuda.MAX_BUILD + 1)):
        assert join_cuda._supports(_sig(how, lk, rk, nr)) == \
            join_cuda._supports(_sig("inner", lk, rk, nr))
    assert join_cuda._supports(_sig(how)) is True
    assert join_cuda._supports(_sig("left")) is False


@pytest.mark.parametrize("force", [None, "hash_join=cuda", "hash_join=torch"])
@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
@pytest.mark.parametrize("mode", ["eager", "capped"])
def test_semi_join_with_other_key_dtypes_raises_on_every_route(
        monkeypatch, force, how, mode):
    """INT32 against INT64 keys: the sort-based join's TypeError, before a
    kernel is chosen, whichever the registry would choose."""
    if force:
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", force)
    a = Table([Column.from_numpy(np.arange(5, dtype=np.int32), tdt.INT32,
                                 device="cpu")], ["x"])
    b = Table([Column.from_numpy(np.arange(3, dtype=np.int64), tdt.INT64,
                                 device="cpu")], ["y"])
    pb = PlanBuilder()
    plan = pb.scan("a", schema=["x"]).join(pb.scan("b", schema=["y"]),
                                           left_on="x", right_on="y",
                                           how=how).build()
    with pytest.raises(TypeError, match="join key concat dtype mismatch"):
        PlanExecutor(mode=mode, device="cpu").execute(plan, {"a": a, "b": b})
    with pytest.raises(TypeError, match="join key concat dtype mismatch"):
        join.left_semi_join(a.columns, b.columns)


def _rows(table):
    return {n: c.data.tolist() for n, c in zip(table.names, table.columns)}


@pytest.mark.parametrize("q", ["q5", "q23"])
@pytest.mark.parametrize("mode", ["eager", "capped"])
@pytest.mark.parametrize("optimize", [False, True])
def test_nds_semi_joins_on_the_forced_kernels(monkeypatch, q, mode,
                                              optimize):
    """q5's and q23's semi joins with the hash-join kernel forced take the
    build and existence probe (their plain versions on CPU tensors), one of
    each a semi join, and the result equals the sort-based route's."""
    mod = {"q5": nds_q5, "q23": nds_q23}[q]
    plan = getattr(mod, f"{q}_plan")()
    inputs = getattr(mod, f"{q}_inputs")(3_000, seed=1, device="cpu")
    want = PlanExecutor(mode=mode, device="cpu",
                        optimize=optimize).execute(plan, inputs)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=cuda")
    join_cuda.reset_counters()
    got = PlanExecutor(mode=mode, device="cpu",
                       optimize=optimize).execute(plan, inputs)
    semis = sum(n.kind == "HashJoin" for n in got.plan.nodes)
    assert semis == {"q5": 3, "q23": 4}[q]
    assert join_cuda.PLAIN_CALLS == {"build": semis, "count": 0, "emit": 0,
                                     "exists": semis, "capped": 0}
    assert {m.kernel for m in got.metrics.values()
            if m.kind == "HashJoin"} == {"cuda:hash_join"}
    assert _rows(got.compact()) == _rows(want.compact())
