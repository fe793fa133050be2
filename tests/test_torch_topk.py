"""TopK in the port against the JAX package: the plain version against
`topk_pallas.topk_table` (Pallas interpret mode) and against `sort_table`
+ `slice_table`, bit for bit with validity and tie order, on the cases of
tests/test_kernel_registry.py; the order words the CUDA kernel compares
against the stable sort; the registry's declines against
`topk_pallas._supports`, which the port's kernel widens to any limit."""
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
from spark_rapids_tpu_torch.ops import copying, sort, topk, topk_cuda
from spark_rapids_tpu_torch.ops.registry import REGISTRY, Signature
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor


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
        # TPU kernel did not have
        assert not topk.supports(sig)
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
        assert topk_cuda.LAUNCHES == {"select": 0, "merge": 0}
        for a, c in zip(want.table.columns, res.table.columns):
            assert torch.equal(a.data, c.data)
            assert torch.equal(a.null_mask, c.null_mask)
