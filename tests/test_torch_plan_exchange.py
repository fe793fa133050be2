"""An `Exchange` in the port's plans against the JAX package's executor
on one device: a keyed (hash) and an identity Exchange, under a join and
under an aggregate, in both tiers, authored and optimized. On one device
the reference's eager tier returns the Exchange's child
(`spark_rapids_tpu/plan/executor.py`, the Exchange arm of its eager
lowering), and its capped tier passes it through; so does the port. The
results are compared bit for bit, validity included. The port's verifier
gate is on."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import stats

from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield


@pytest.fixture(autouse=True)
def _gate_on(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "1")


def _arrays():
    rng = np.random.default_rng(3)
    n, m = 300, 40
    return {
        "f": {"k": (rng.integers(0, 30, n).astype(np.int64),
                    rng.random(n) > 0.1),
              "v": (rng.integers(-50, 50, n).astype(np.int64), None),
              "x": (rng.choice([0.5, -0.0, np.nan, 2.25], n), None)},
        "d": {"dk": (np.arange(m, dtype=np.int64), None),
              "tag": (rng.integers(0, 4, m).astype(np.int64), None)},
    }


def _inputs():
    arrays = _arrays()
    jt = {name: JTable([JColumn.from_numpy(a, validity=v)
                        for a, v in cols.values()], names=list(cols))
          for name, cols in arrays.items()}
    tt = {name: table_from_numpy(list(cols), [a for a, _ in cols.values()],
                                 [v for _, v in cols.values()],
                                 [a.dtype.name for a, _ in cols.values()],
                                 device="cpu")
          for name, cols in arrays.items()}
    return jt, tt


def _plan(B, c, keys, where):
    """An Exchange (`keys`: () for the identity marker) under a join's
    build side or under an aggregate's input."""
    b = B()
    facts = b.scan("f", schema=["k", "v", "x"])
    dims = b.scan("d", schema=["dk", "tag"]).filter(c("tag") > 0)
    if where == "join":
        dims = dims.exchange(list(keys and ["dk"]))
        j = facts.join(dims, left_on="k", right_on="dk")
        return j.sort(["v", "k", "dk"]).build()
    facts = facts.exchange(list(keys and ["k"]))
    return (facts.aggregate(["k"], [("v", "sum", "s"), ("x", "max", "mx"),
                                    ("v", "count", "n")])
            .sort(["k"]).build())


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["eager", "capped"])
@pytest.mark.parametrize("where", ["join", "aggregate"])
@pytest.mark.parametrize("keys", [("k",), ()], ids=["hash", "identity"])
def test_exchange_matches_jax(keys, where, mode, optimize):
    jt, tt = _inputs()
    jplan = _plan(JPlanBuilder, jcol, keys, where)
    tplan = _plan(PlanBuilder, col, keys, where)
    assert tplan.fingerprint == jplan.fingerprint
    assert sum(n.kind == "Exchange" for n in tplan.nodes) == 1
    with stats.scoped_store(None):
        want = JPlanExecutor(mode=mode, optimize=optimize).execute(
            jplan, jt).compact()
    res = PlanExecutor(mode=mode, device="cpu", optimize=optimize).execute(
        tplan, tt)
    got = res.compact()
    assert "Exchange" in {m.kind for m in res.metrics.values()}
    assert list(got.names) == list(want.names)
    assert got.num_rows == want.num_rows > 0
    for jc, tc in zip(want.columns, got.columns):
        data, valid = tc.to_numpy()
        want_data = np.asarray(jc.data)
        assert data.dtype == want_data.dtype
        npt.assert_array_equal(data.view(np.uint8), want_data.view(np.uint8))
        jv = (np.ones(want.num_rows, bool) if jc.validity is None
              else np.asarray(jc.validity))
        tv = np.ones(got.num_rows, bool) if valid is None else valid
        npt.assert_array_equal(tv, jv)
