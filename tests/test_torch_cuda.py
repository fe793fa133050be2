"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (hash join,
row hash, shuffle histogram) against their plain PyTorch versions, and q3
through `PlanExecutor()` on the card.

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
from spark_rapids_tpu_torch.ops import hash_cuda, join, join_cuda
from spark_rapids_tpu_torch.parallel import partition_cuda
from spark_rapids_tpu_torch.plan import PlanExecutor

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.parametrize("dtype,npt", [(tdt.INT64, np.int64),
                                       (tdt.INT16, np.int16),
                                       (tdt.decimal(9, 2), np.int32)])
@pytest.mark.parametrize("null_p", [0.0, 0.1])
def test_kernels_equal_plain_versions(dtype, npt, null_p):
    _need_card()
    rng = np.random.default_rng(11)
    nl, nr = 50_000, 400

    def col(n):
        v = (rng.random(n) > null_p) if null_p else None
        return [Column.from_numpy(rng.integers(-90, 90, n).astype(npt),
                                  dtype, v, device="cuda")]
    lc, rc = col(nl), col(nr)
    C = join_cuda._capacity(nr)
    tk = join_cuda.build_table_cuda(rc, C)
    tp = join_cuda.build_table_plain(rc, C)
    assert torch.equal(tk.slot_row, tp.slot_row)
    assert torch.equal(tk.slot_hash, tp.slot_hash)
    ck = join_cuda.probe_counts_cuda(lc, tk, rc)
    assert torch.equal(ck, join_cuda.probe_counts_plain(lc, tp, rc))
    got = join_cuda.inner_join_hash(lc, rc)
    ref = join.inner_join(lc, rc)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, ref[0].data)
    assert torch.equal(got[1].data, ref[1].data)


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
