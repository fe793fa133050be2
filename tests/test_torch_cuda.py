"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain PyTorch versions, and q3 through `PlanExecutor()` on the card.

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
from spark_rapids_tpu_torch.ops import join, join_cuda
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
