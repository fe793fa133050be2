"""The port's fault injector, health monitor and degraded CPU tier against
the JAX package's.

- The injector: the same config and seed give the same decisions over the
  same call sequence (exact names, `*`, interception counts, percent 0,
  substitute codes, the fatal poison and its reset, `suppressed()`); it
  intercepts the port's public ops, the executor's op table
  (`ops/plan_ops.py`) and the MemoryBudget calls, and uninstall restores
  them; the config path is the port's env knob.
- The health monitor: one scripted sequence (classification, sticky
  windows, jittered backoff from a seeded rng, the shared retry budget,
  the breaker's lifecycle and cooldown, drained metrics) gives the same
  record over both packages' monitors.
- The executors: NDS q3 and q23 (N = 2,000, authored) run under the same
  config and seed through the JAX package's `PlanExecutor` and the port's
  (`device="cpu"`), eager, and q3 capped, with equal monitors (no real
  sleep, seeded jitter): the same faults fire on the same operators in
  the same order (each operator's retries and whether it degraded), the
  same `degraded`, retries, backoff, breaker snapshot, injected count and
  health metrics, and the tables bit for bit. A fatal fault degrades, and
  `reset_device()` with a half-open probe brings the next run back.
- Admission: q23 under a DeviceSession in both executors: every operator
  that dispatches an op takes a reservation, the two take the same
  number, and the budget returns to 0 once the result is dropped.
- Memory pressure is not a device fault: the arbiter's RetryOOM, forced
  more times in a row than `op_retries`, leaves the port's `execute()`
  each time, never reaches the health monitor or the breaker, and
  `with_retry` reruns the plan to the JAX package's clean result.
Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import gc
import json
import random

import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
import spark_rapids_tpu.faultinj as jfi
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import stats as jstats
from spark_rapids_tpu.runtime import health as jhealth

from benchmarks import bench_nds_q3, bench_nds_q23, nds_plans

import spark_rapids_tpu_torch.faultinj as tfi
import spark_rapids_tpu_torch.runtime as trt
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import nds_q3, nds_q23, table_from_numpy
from spark_rapids_tpu_torch import ops as tops
from spark_rapids_tpu_torch.ops import plan_ops
from spark_rapids_tpu_torch.plan import PlanExecutor
from spark_rapids_tpu_torch.plan import stats as tstats
from spark_rapids_tpu_torch.runtime import health as thealth


@pytest.fixture(autouse=True, scope="module")
def _no_stats_stores():
    with tstats.scoped_store(None), jstats.scoped_store(None):
        yield


@pytest.fixture(autouse=True)
def _clean():
    yield
    jfi.uninstall()
    tfi.uninstall()


def _cfg(tmp_path, cfg, name="faultinj.json"):
    p = tmp_path / name
    p.write_text(json.dumps(cfg))
    return str(p)


def _outcome(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - recorded
        return type(e).__name__ + ":" + str(e)
    return "ok"


# ---- the injector ---------------------------------------------------------------

_NAMES = ["inner_join", "take_table", "plan.HashJoin", "sort_table",
          "plan.Sort", "groupby_aggregate", "health.probe"] * 6

_CONFIGS = {
    "exact": {"computeFaults": {"take_table": {"percent": 100,
                                               "injectionType": 1}}},
    "wildcard_seeded": {"seed": 12345, "computeFaults": {
        "*": {"percent": 40, "injectionType": 1}}},
    "count": {"computeFaults": {"*": {"percent": 100, "injectionType": 1,
                                      "interceptionCount": 3}}},
    "percent_zero": {"computeFaults": {"*": {"percent": 0}}},
    "substitute": {"seed": 1, "computeFaults": {"sort_table": {
        "percent": 70, "injectionType": 2, "substituteReturnCode": 2}}},
    "fatal": {"computeFaults": {"plan.Sort": {
        "percent": 100, "injectionType": 0, "interceptionCount": 1}}},
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_injector_decisions_equal_the_jax_package(tmp_path, name):
    path = _cfg(tmp_path, _CONFIGS[name])
    records = []
    for fi in (jfi, tfi):
        inj = fi.install(path)
        rec = []
        for i, api in enumerate(_NAMES):
            rec.append((api, _outcome(lambda: inj.on_compute(api)),
                        inj.device_poisoned))
            if i == 20:
                inj.reset_device()
            if i == 30:
                with fi.suppressed():
                    rec.append(_outcome(lambda: inj.on_compute(api)))
        rec.append(inj.get_and_reset_injected())
        records.append(rec)
        fi.uninstall()
    assert records[1] == records[0]


def test_interception_reaches_ops_plan_ops_and_budgets(tmp_path,
                                                       monkeypatch):
    import spark_rapids_tpu_torch.runtime.pool as tpool
    before = {n: getattr(plan_ops, n) for n in plan_ops.__all__}
    before_ops = tops.take_table
    before_acquire = tpool.MemoryBudget.acquire
    path = _cfg(tmp_path, {"computeFaults": {
        "take_table": {"percent": 100, "injectionType": 1},
        "slice_table": {"percent": 100, "injectionType": 2,
                        "substituteReturnCode": 7}},
        "runtimeFaults": {"MemoryBudget.acquire": {"percent": 100,
                                                   "injectionType": 1}}})
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_FAULTINJ_CONFIG_PATH", path)
    tfi.maybe_install_from_env()
    assert tfi.active() is not None
    t = table_from_numpy(["a"], [np.arange(4, dtype=np.int64)], [None],
                         ["int64"], device="cpu")
    idx = __import__("torch").arange(2)
    with pytest.raises(tfi.DeviceAssertError):
        tops.take_table(t, idx)
    with pytest.raises(tfi.DeviceAssertError):
        plan_ops.take_table(t, idx)
    with pytest.raises(tfi.InjectedReturnCode) as ei:
        plan_ops.slice_table(t, 0, 2)
    assert ei.value.code == 7
    assert plan_ops.sort_table(t, ["a"], [True]).num_rows == 4
    with trt.DeviceSession(100, watchdog=False) as s:
        with pytest.raises(tfi.DeviceAssertError):
            s.device.acquire(10)
        with tfi.suppressed():
            s.device.release(s.device.acquire(10))
    tfi.uninstall()
    assert {n: getattr(plan_ops, n) for n in plan_ops.__all__} == before
    assert tops.take_table is before_ops
    assert tpool.MemoryBudget.acquire is before_acquire
    assert tops.take_table(t, idx).num_rows == 2


# ---- the health monitor ------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _health_record(h, fi):
    clock, slept, ok = _Clock(), [], {"v": True}
    hm = h.DeviceHealthMonitor(
        retry_budget=3, backoff_base_ms=10, backoff_max_ms=200,
        sticky_threshold=3, sticky_window_s=60, cooldown_s=30,
        probe=lambda: ok["v"], sleep=slept.append, clock=clock,
        rng=random.Random(7))
    e = fi.DeviceAssertError("x")
    rec = [hm.record_failure("op", fi.DeviceFatalError("x")),
           hm.record_failure("op", fi.InjectedReturnCode("op", 2))]
    rec += [hm.record_failure("HashJoin#1", e) for _ in range(2)]
    rec.append(hm.record_failure("Sort#2", e))
    rec.append(hm.record_failure("HashJoin#1", e))
    hm.record_success("HashJoin#1")
    rec.append(hm.record_failure("HashJoin#1", e))
    clock.t += 61
    rec.append(hm.record_failure("HashJoin#1", e))
    rec += [hm.try_retry(a) for a in range(4)]
    hm.start_plan_attempt()
    rec.append(hm.try_retry(5))
    rec.append(list(slept))
    br = hm.breaker
    hm.trip(h.STICKY, e)
    rec += [br.state, br.trips, br.last_trip_reason, br.last_trip_error,
            hm.admit()]
    clock.t += 31
    ok["v"] = False
    rec += [hm.admit(), br.state]             # cooldown armed, probe fails
    clock.t += 10
    rec += [hm.admit(), br.state]             # cooling down again
    hm.reset_device()
    ok["v"] = True
    rec += [br.state, hm.admit(), br.state]
    hm.note_degraded_plan()
    rec.append(sorted(hm.get_and_reset_metrics().items()))
    rec.append(hm.get_and_reset_metrics())
    return rec


def test_health_monitor_sequence_equals_the_jax_package():
    assert _health_record(thealth, tfi) == _health_record(jhealth, jfi)
    for name in ("CLOSED", "OPEN", "HALF_OPEN", "TRANSIENT", "STICKY",
                 "FATAL"):
        assert getattr(thealth, name) == getattr(jhealth, name)


def test_device_probe_is_a_tiny_op_on_the_device(tmp_path):
    assert thealth.device_probe("cpu")
    tfi.install(_cfg(tmp_path, {"computeFaults": {"health.probe": {
        "percent": 100, "injectionType": 0}}}))
    assert not thealth.CircuitBreaker(
        probe=lambda: thealth.device_probe("cpu")).probe()


# ---- the executors ---------------------------------------------------------------

def _port(jt):
    return table_from_numpy(
        list(jt.names), [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity)
         for c in jt.columns],
        [tdt.DType(tdt.Kind(c.dtype.kind.value), c.dtype.precision,
                   c.dtype.scale) for c in jt.columns], device="cpu")


_N = 2000


@pytest.fixture(scope="module")
def plans():
    sales, dates, items = bench_nds_q3.build_tables(_N, seed=0)
    q3 = nds_plans.q3_inputs(sales, dates, items)
    store, sides = bench_nds_q23.build_tables(_N, seed=0)
    q23 = nds_plans.q23_inputs(store, sides)
    return {
        "q3": (nds_plans.q3_plan, q3, nds_q3.q3_plan,
               {k: _port(v) for k, v in q3.items()}),
        "q23": (nds_plans.q23_plan, q23, nds_q23.q23_plan,
                {k: _port(v) for k, v in q23.items()}),
    }


def _monitor(h):
    # the port's default probe runs on the card; here the executor's CPU
    probe = (None if h is jhealth
             else lambda: thealth.device_probe("cpu"))
    return h.DeviceHealthMonitor(backoff_base_ms=1, sleep=lambda s: None,
                                 rng=random.Random(3), probe=probe)


def _observe(res, inj, hm):
    return {
        "degraded": res.degraded, "retries": res.retries,
        "backoff_ms": res.backoff_ms, "breaker": res.breaker,
        "ops": [(m.kind, m.retries, m.degraded)
                for m in res.metrics.values()],
        "injected": inj.get_and_reset_injected(),
        "health": sorted(hm.get_and_reset_metrics().items()),
    }


def _assert_tables_equal(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        data, valid = tc.to_numpy()
        npt.assert_array_equal(np.asarray(jc.data), data)
        jv = None if jc.validity is None else np.asarray(jc.validity)
        if jv is not None and valid is not None:
            npt.assert_array_equal(jv, valid)
        else:
            assert (jv is None or jv.all()) and (valid is None or valid.all())


_CASES = {
    # every plan point and op at 25%: transients retried, and the shared
    # budget or the per-operator bound runs out (a sticky trip)
    "q3-eager-wildcard": ("q3", "eager", {"seed": 11, "computeFaults": {
        "*": {"percent": 25, "injectionType": 1}}}, False),
    # a fatal fault mid-plan: the finished outputs salvaged, the rest on
    # the CPU tier, then reset and a half-open probe
    "q3-eager-fatal": ("q3", "eager", {"computeFaults": {
        "plan.HashAggregate": {"percent": 100, "injectionType": 0,
                               "interceptionCount": 1}}}, False),
    "q3-capped-fatal": ("q3", "capped", {"computeFaults": {
        "plan.HashJoin": {"percent": 100, "injectionType": 0,
                          "interceptionCount": 1}}}, False),
    "q3-capped-asserts": ("q3", "capped", {"seed": 1, "computeFaults": {
        "plan.HashJoin": {"percent": 50, "injectionType": 1}}}, False),
    # op-level faults on the joins, and the budget's acquire under a
    # session
    "q23-eager-ops-and-budget": ("q23", "eager", {"seed": 3,
        "computeFaults": {
            "inner_join": {"percent": 50, "injectionType": 1},
            "left_semi_join": {"percent": 50, "injectionType": 1},
            "concat_tables": {"percent": 100, "injectionType": 2,
                              "substituteReturnCode": 2,
                              "interceptionCount": 1}},
        "runtimeFaults": {"MemoryBudget.acquire": {
            "percent": 10, "injectionType": 1}}}, True),
    "q23-eager-fatal": ("q23", "eager", {"computeFaults": {
        "plan.Union": {"percent": 100, "injectionType": 0,
                       "interceptionCount": 1}}}, False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_faults_and_degrade_equal_the_jax_package(tmp_path, plans, case):
    import spark_rapids_tpu.runtime as jrt
    query, mode, cfg, with_session = _CASES[case]
    jplan, jin, tplan, tin = plans[query]
    path = _cfg(tmp_path, cfg)
    runs = {}
    for name, fi, h, rt, make in (
            ("jax", jfi, jhealth, jrt,
             lambda hm, s: JPlanExecutor(mode=mode, optimize=False,
                                         health=hm, session=s)),
            ("torch", tfi, thealth, trt,
             lambda hm, s: PlanExecutor(mode=mode, device="cpu",
                                        optimize=False, health=hm,
                                        session=s))):
        inj = fi.install(path)
        hm = _monitor(h)
        sess = (rt.DeviceSession(1 << 40, watchdog=False) if with_session
                else None)
        ex = make(hm, sess)
        plan = (jplan if name == "jax" else tplan)()
        inputs = jin if name == "jax" else tin
        res = ex.execute(plan, inputs)
        obs = [_observe(res, inj, hm)]
        table = res.compact()
        if res.degraded and res.breaker["reason"] == "fatal":
            # quarantined: the next run is whole on the CPU tier; after
            # reset_device() a half-open probe brings the device back
            again = ex.execute(plan, inputs)
            obs.append(_observe(again, inj, hm))
            hm.reset_device()
            back = ex.execute(plan, inputs)
            obs.append(_observe(back, inj, hm))
            assert not back.degraded and back.breaker["state"] == "closed"
        if sess is not None:
            sess.close()
        runs[name] = (obs, table)
        fi.uninstall()
    assert runs["torch"][0] == runs["jax"][0]
    _assert_tables_equal(runs["jax"][1], runs["torch"][1])
    first = runs["torch"][0][0]
    assert first["injected"] > 0          # the config did fire


class _Counting:
    def __init__(self, rt):
        outer = self
        self.acquired = []

        class H(rt.MemoryEventHandler):
            def on_allocated(self, total_used):
                outer.acquired.append(total_used)

        self.handler = H()


def _run_both(plans, query):
    """(name, runtime module, run(session)) of each package's executor."""
    import spark_rapids_tpu.runtime as jrt
    jplan, jinputs, tplan, tinputs = plans[query]
    return (("jax", jrt, lambda sess: JPlanExecutor(
                optimize=False, session=sess).execute(jplan(), jinputs)),
            ("torch", trt, lambda sess: PlanExecutor(
                device="cpu", optimize=False, session=sess).execute(
                tplan(), tinputs)))


def test_every_q23_operator_is_admitted_and_the_budget_drains(plans):
    """q23's result is one row of `_global_aggregate`, which runs outside
    the op table in both packages, so no reservation is tied to it: the
    port's budget is 0 while it lives and at `del res`, with no collection
    (queue C 9 repaired). The JAX package's output walk still holds its
    outputs in a reference cycle, so its side drains at `gc.collect()`."""
    counts = {}
    for name, rt, run in _run_both(plans, "q23"):
        c = _Counting(rt)
        sess = rt.DeviceSession(1 << 40, watchdog=False,
                                event_handler=c.handler)
        with sess:
            res = run(sess)
            kinds = [m.kind for m in res.metrics.values()]
            del res
            if name == "jax":
                gc.collect()
            assert sess.device.used == 0
        counts[name] = len(c.acquired)
    # one or more reservations per operator that dispatches an op
    dispatching = [k for k in kinds if k not in ("Scan", "Project",
                                                 "Exchange")]
    assert counts["torch"] == counts["jax"] >= len(dispatching) > 0


def test_an_admitted_result_holds_its_bytes_until_dropped(plans):
    """q3 ends in a Sort, an admitted op whose output the executor hands
    back as the result itself (no unadmitted step copies it), so the
    result holds its reservation while it lives, in both packages. With
    the GC disabled, the port's budget is 0 at `del res` (queue C 9); the
    JAX package's drains at `gc.collect()`."""
    counts = {}
    gc.collect()
    gc.disable()
    try:
        for name, rt, run in _run_both(plans, "q3"):
            c = _Counting(rt)
            sess = rt.DeviceSession(1 << 40, watchdog=False,
                                    event_handler=c.handler)
            with sess:
                res = run(sess)
                assert res.plan.root.kind == "Sort"
                assert sess.device.used > 0      # the result holds its bytes
                del res
                if name == "jax":
                    gc.collect()
                assert sess.device.used == 0
            counts[name] = len(c.acquired)
    finally:
        gc.enable()
    assert counts["torch"] == counts["jax"] > 0


def test_q23_budget_drains_at_del_with_the_gc_disabled(plans):
    """Queue C 9 pinned: with the cyclic GC off, two runs of q23 under one
    executor and one DeviceSession each leave the budget at 0 when the
    result is dropped, and reach the same high-water mark (a garbage
    cycle would carry the first run's outputs into the second's)."""
    _, _, tplan, tinputs = plans["q23"]
    plan = tplan()
    c = _Counting(trt)
    marks = []
    gc.collect()
    gc.disable()
    try:
        with trt.DeviceSession(1 << 40, watchdog=False,
                               event_handler=c.handler) as sess:
            ex = PlanExecutor(device="cpu", optimize=False, session=sess)
            for _ in range(2):
                c.acquired.clear()
                res = ex.execute(plan, tinputs)
                del res
                assert sess.device.used == 0
                marks.append(max(c.acquired))
    finally:
        gc.enable()
    assert marks[0] == marks[1] > 0


@pytest.mark.parametrize("query,mode,skip", [("q23", "eager", 2),
                                             ("q3", "capped", 0)])
def test_arbiter_retry_oom_reruns_and_never_trips(plans, query, mode, skip):
    jplan, jinputs, tplan, tinputs = plans[query]
    want = JPlanExecutor(mode=mode, optimize=False).execute(
        jplan(), jinputs).compact()
    hm = _monitor(thealth)
    ex = PlanExecutor(mode=mode, device="cpu", optimize=False, health=hm)
    assert ex.op_retries == 2 and ex.degrade == "cpu"
    plan = tplan()
    leaves = []

    def attempt(_):
        try:
            return ex.execute(plan, tinputs)
        except trt.RetryOOM as e:
            leaves.append(e)
            raise

    with trt.DeviceSession(1 << 40, watchdog=False) as sess:
        ex.session = sess
        arb = sess.arbiter
        arb.current_thread_is_dedicated_to_task(1)
        arb.force_retry_oom(trt.current_thread_id(), 3,
                            trt.OomInjectionType.GPU, skip)
        [res] = trt.with_retry(arb, attempt, None)
        assert arb.get_and_reset_num_retry_throw(1) == 3
        assert arb.get_state_name_of(trt.current_thread_id()) == \
            "THREAD_RUNNING"
        arb.task_done(1)
        assert len(leaves) == 3
        assert not res.degraded and res.retries == 0
        assert res.breaker == {"state": "closed", "trips": 0,
                               "reason": None, "error": None}
        assert not any(v for k, v in hm.get_and_reset_metrics().items()
                       if k.endswith("_faults"))
        _assert_tables_equal(want, res.compact())
        del res
        gc.collect()
