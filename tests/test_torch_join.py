"""The port's hash join (spark_rapids_tpu_torch/ops/join_cuda.py) against
the JAX package on the CPU, on the same numpy inputs.

On CPU tensors every wrapper runs its plain PyTorch version, so these tests
hold the plain build/count/emit to the reference: pair for pair, in order,
against `join_pallas.inner_join_pallas` (Pallas interpret mode on the CPU)
and `ops.inner_join`; the build table slot for slot against
`join_pallas._build_table`; and `_supports` against the reference's on the
same signatures. The probes' tile interface and the large route are in
tests/test_torch_join_probe.py; the outer joins, `null_equal`, the capped
joins and the span functions in tests/test_torch_join_outer.py. The
tolerance is exact: join maps are integers.
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
