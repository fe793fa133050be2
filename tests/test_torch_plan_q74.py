"""TPC-DS q74 (`spark_rapids_tpu_torch/nds_q74.py`) through the port's eager
plan engine against the JAX package's `PlanExecutor(mode="eager")` on the
same tables, bit for bit, authored and optimized; against the numpy
evaluation `numpy_q74`; its data's shape (key and name kinds, null shares,
date range); and the capped tier's STRING-key raise, which names the
reference's limit. Small sizes: 20,000 store and 5,000 web rows against
1,000 customers."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol

from spark_rapids_tpu_torch import nds_q74
from spark_rapids_tpu_torch.ops import join_cuda
from spark_rapids_tpu_torch.plan import PlanExecutor
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

SIZES = (20_000, 5_000, 1_000)


@pytest.fixture(autouse=True)
def _verify_plans(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "1")


def _jax_table(t):
    cols = []
    for c in t.columns:
        jd = (jdt.STRING if c.dtype.is_string else
              jdt.DType(jdt.Kind(c.dtype.kind.value)))
        cols.append(JColumn(
            dtype=jd, length=c.length, data=jnp.asarray(c.data.numpy()),
            validity=(None if c.validity is None
                      else jnp.asarray(c.validity.numpy())),
            offsets=(None if c.offsets is None
                     else jnp.asarray(c.offsets.numpy()))))
    return JTable(cols, names=list(t.names))


def _assert_same(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert jc.dtype.kind.value == tc.dtype.kind.value
        for j, t in ((jc.data, tc.data), (jc.offsets, tc.offsets)):
            assert (j is None) == (t is None)
            if t is not None:
                npt.assert_array_equal(np.asarray(j), t.numpy())
        jv = None if jc.validity is None else np.asarray(jc.validity)
        tv = None if tc.validity is None else tc.validity.numpy()
        if jv is None or tv is None:
            assert (jv is None or jv.all()) and (tv is None or tv.all())
        else:
            npt.assert_array_equal(jv, tv)


@pytest.fixture(scope="module")
def q74():
    gen = nds_q74.datagen(*SIZES, seed=4)
    inputs = nds_q74.q74_inputs(gen=gen, device="cpu")
    return gen, inputs, {k: _jax_table(t) for k, t in inputs.items()}


def test_datagen_shapes(q74):
    gen, inputs, _ = q74
    kinds = {k: [c.dtype.kind.value for c in t.columns]
             for k, t in inputs.items()}
    assert kinds == {"store_sales": ["int32", "int32", "int64"],
                     "web_sales": ["int32", "int32", "int64"],
                     "customer": ["int32", "string", "string", "string"],
                     "date_dim": ["int32", "int32"]}
    assert inputs["date_dim"].num_rows == 73_049
    years = inputs["date_dim"]["d_year"].data.numpy()
    assert years[0] == 1900 and years[-1] == 2100
    ids = inputs["customer"]["c_customer_id"]
    assert set(ids.string_lengths().tolist()) == {16}
    assert ids.to_pylist()[:2] == ["AAAAAAAABAAAAAAA", "AAAAAAAACAAAAAAA"]
    for name, lo, hi in (("c_first_name", 2, 20), ("c_last_name", 2, 30)):
        c = inputs["customer"][name]
        lens = c.string_lengths()[c.validity].numpy()
        assert lo <= lens.min() and lens.max() <= hi
        assert 0.02 < 1 - c.validity.float().mean().item() < 0.05
    ss = inputs["store_sales"]
    share = 1 - ss["ss_customer_sk"].validity.float().mean().item()
    assert 0.03 < share < 0.05
    sold = years[ss["ss_sold_date_sk"].data.numpy() - nds_q74.FIRST_DATE_SK]
    assert sold.min() == 1998 and sold.max() == 2002


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("limit", [100, None])
def test_q74_matches_jax_and_numpy(q74, optimize, limit):
    gen, inputs, jinputs = q74
    from spark_rapids_tpu.plan import stats
    with stats.scoped_store(None):
        ref = JPlanExecutor(mode="eager", optimize=optimize).execute(
            nds_q74.q74_plan(limit, JPlanBuilder, jcol), jinputs)
    res = PlanExecutor(device="cpu", optimize=optimize).execute(
        nds_q74.q74_plan(limit), inputs)
    _assert_same(ref.table, res.table)
    want = nds_q74.numpy_q74(gen, limit)
    assert res.table.num_rows == len(want) > 0
    assert res.table["customer_id"].to_pylist() == [
        bytes(x).decode() for x in nds_q74.customer_ids(want)]
    stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
    assert stamps.count("torch:hash_join") == 7
    assert stamps.count("torch:groupby") == 2
    if optimize:
        assert res.optimizer["fingerprint"] == ref.optimizer["fingerprint"]
        assert res.optimizer["rules_fired"] == ref.optimizer["rules_fired"]
        assert "torch:fused_select" in stamps
        assert stamps.count("torch:topk") == (limit is not None)


def test_q74_string_joins_on_the_forced_kernels(q74, monkeypatch):
    """With the hash-join kernel forced, the three customer_id joins take
    its plain version (the variable-width instantiation's mirror) and the
    result is unchanged."""
    gen, inputs, _ = q74
    want = PlanExecutor(device="cpu").execute(nds_q74.q74_plan(),
                                              inputs).table
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=cuda")
    join_cuda.reset_counters()
    got = PlanExecutor(device="cpu").execute(nds_q74.q74_plan(),
                                             inputs).table
    assert join_cuda.PLAIN_CALLS == {"build": 7, "count": 7,
                                     "emit": 7, "exists": 0, "capped": 0}
    assert got.to_pydict() == want.to_pydict()


def test_q74_capped_raises_naming_the_limit(q74):
    _, inputs, _ = q74
    with pytest.raises(TypeError, match="max_string_length"):
        PlanExecutor(mode="capped", device="cpu").execute(
            nds_q74.q74_plan(), inputs)
