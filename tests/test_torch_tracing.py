"""The port's tracing ranges (spark_rapids_tpu_torch/utils/tracing.py)
case by case against the reference's tests/test_tracing.py, and the
executor's ranges: with SPARK_RAPIDS_TORCH_TRACE=1 every eager operator
runs in `plan.<label>` and every capped attempt in `plan.capped.attempt`
inside a `torch.profiler` trace, and every result stays equal to the
untraced run's and to the JAX package's. Tolerance: exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import stats as jstats

from benchmarks import nds_plans

from spark_rapids_tpu_torch import nds_q3
from spark_rapids_tpu_torch.plan import PlanExecutor
from spark_rapids_tpu_torch.plan import stats as torch_stats
from spark_rapids_tpu_torch.utils import (func_range, range_ctx, start_trace,
                                          stop_trace, trace, tracing)


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    with torch_stats.scoped_store(None):
        yield


def test_disabled_is_passthrough(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TORCH_TRACE", raising=False)

    @func_range
    def f(x):
        return x + 1

    assert f(1) == 2
    with torch.profiler.profile() as prof:
        with range_ctx("block"):
            pass
        f(2)
    names = {e.name for e in prof.events()}
    assert "block" not in names and not any("f" == n for n in names)


def test_enabled_annotates(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_TRACE", "1")

    @func_range
    def f(x):
        return torch.sum(torch.as_tensor(x))

    with torch.profiler.profile() as prof:
        assert int(f(np.arange(10))) == 45
        with range_ctx("block"):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert "block" in names
    assert any(n.endswith("test_enabled_annotates.<locals>.f")
               for n in names)
    # only "1" turns it on, as in the reference
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_TRACE", "yes")
    assert not tracing.enabled()


def test_device_trace_capture(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        (torch.arange(1000) * 2).sum()
    found = []
    for _, _, files in os.walk(d):
        found.extend(files)
    assert found == ["trace.json"]
    with open(os.path.join(d, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    # start/stop pair the same way, and one capture at a time
    start_trace(d)
    with pytest.raises(RuntimeError):
        start_trace(d)
    assert stop_trace().endswith("trace.json")
    with pytest.raises(RuntimeError):
        stop_trace()


def _jax_q3(inputs, mode):
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.columnar import Table as JTable
    jin = {n: JTable([JColumn.from_numpy(c.data.numpy())
                      for c in t.columns], names=list(t.names))
           for n, t in inputs.items()}
    with jstats.scoped_store(None):
        return JPlanExecutor(mode=mode).execute(nds_plans.q3_plan(), jin)


@pytest.mark.parametrize("mode", ["eager", "capped"])
def test_plan_ranges_and_equal_results(monkeypatch, mode):
    """q3 at 3,000 rows: traced, every operator (eager) or attempt
    (capped) has its range; the traced result equals the untraced one and
    the JAX package's, bit for bit."""
    inputs = nds_q3.q3_inputs(3000, seed=0, device="cpu")
    monkeypatch.delenv("SPARK_RAPIDS_TORCH_TRACE", raising=False)
    plain = PlanExecutor(mode=mode, device="cpu").execute(
        nds_q3.q3_plan(), inputs)
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_TRACE", "1")
    with torch.profiler.profile() as prof:
        traced = PlanExecutor(mode=mode, device="cpu").execute(
            nds_q3.q3_plan(), inputs)
    names = [e.name for e in prof.events()]
    if mode == "eager":
        for label in traced.metrics:
            assert names.count(f"plan.{label}") == 1, label
        assert "plan.capped.attempt" not in names
    else:
        assert names.count("plan.capped.attempt") == traced.attempts
        assert not any(n.startswith("plan.") and n != "plan.capped.attempt"
                       for n in names)
    a, b = plain.compact(), traced.compact()
    assert list(a.names) == list(b.names)
    for x, y in zip(a.columns, b.columns):
        assert x.data.numpy().tobytes() == y.data.numpy().tobytes()
    ref = _jax_q3(inputs, mode).compact()
    assert list(ref.names) == list(b.names)
    for x, y in zip(ref.columns, b.columns):
        assert np.asarray(x.data).tobytes() == y.data.numpy().tobytes()


def test_operator_ranges_hold_their_ops(monkeypatch):
    """The torch ops an eager operator runs nest inside its range: a
    range's interval covers the ops its operator launched."""
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_TRACE", "1")
    inputs = nds_q3.q3_inputs(3000, seed=0, device="cpu")
    with torch.profiler.profile() as prof:
        res = PlanExecutor(device="cpu").execute(nds_q3.q3_plan(), inputs)
    ranges = {e.name: e for e in prof.events()
              if e.name.startswith("plan.")}
    agg = next(lbl for lbl, m in res.metrics.items()
               if m.kind == "HashAggregate")
    r = ranges[f"plan.{agg}"]
    inner = [e for e in prof.events()
             if e.name.startswith("aten::")
             and e.time_range.start >= r.time_range.start
             and e.time_range.end <= r.time_range.end]
    assert inner
