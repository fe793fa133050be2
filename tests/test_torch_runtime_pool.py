"""The port's memory budgets, retry contract, spill pool, admission and
`RmmSpark` facade against the JAX package's, on CPU tensors.

Each scenario runs once over each package's runtime with the same calls and
records what the budget, the arbiter, the event handler and the spill pool
did (bytes used, exception classes, callbacks, spill counts, the restored
values); the records must be equal. Admission runs the public ops under
a DeviceSession (the plans' admission is in tests/test_torch_faultinj.py,
beside the other executor runs). No test waits on a timer: the watchdog is off and each task runs
on the calling thread or an actor awaited on events. Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import gc
import inspect
import threading

import numpy as np
import pytest

import jax.numpy as jnp

import spark_rapids_tpu.runtime as jrt
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu import api as japi
from spark_rapids_tpu import ops as jops
from spark_rapids_tpu.plan import stats as jstats

import torch

import spark_rapids_tpu_torch.runtime as trt
from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch import ops as tops
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.columnar import Table as TTable
from spark_rapids_tpu_torch.dtypes import INT64
from spark_rapids_tpu_torch.plan import stats as tstats

MiB = 1024 * 1024


@pytest.fixture(autouse=True, scope="module")
def _no_stats_stores():
    with tstats.scoped_store(None), jstats.scoped_store(None):
        yield


class _Jax:
    rt, ops = jrt, jops

    @staticmethod
    def array(a):
        return jnp.asarray(a)

    @staticmethod
    def table(*arrays):
        return JTable([JColumn.from_numpy(np.asarray(a)) for a in arrays])

    @staticmethod
    def host(a):
        return np.asarray(a)


class _Torch:
    rt, ops = trt, tops

    @staticmethod
    def array(a):
        return torch.from_numpy(np.asarray(a).copy())

    @staticmethod
    def table(*arrays):
        return TTable([TColumn.from_numpy(np.asarray(a), INT64, device="cpu")
                       for a in arrays])

    @staticmethod
    def host(a):
        return a.numpy()


class _Events(object):
    """A MemoryEventHandler that records its callbacks and spills from a
    list of releasable reservations (the plugin's spill-store shape)."""

    def __init__(self, rt, rec):
        self.rec, self.spillable, self.budget = rec, [], None
        base = rt.MemoryEventHandler
        outer = self

        class H(base):
            def on_alloc_failure(self, nbytes, retry_count):
                outer.rec.append(("failure", nbytes, retry_count))
                if not outer.spillable:
                    return False
                outer.budget.release(outer.spillable.pop())
                return True

            def on_allocated(self, total_used):
                outer.rec.append(("allocated", total_used))

            def on_deallocated(self, total_used):
                outer.rec.append(("deallocated", total_used))

        self.handler = H()


def _raised(fn):
    try:
        out = fn()
    except Exception as e:          # noqa: BLE001 - recorded
        return ("raised", type(e).__name__)
    return ("ok", out)


# ---- scenarios ----------------------------------------------------------------

def _budget(P, rec):
    """acquire/try_acquire/resize/release, the spill fast path, a raising
    handler, and the fall-through to the task-level RetryOOM."""
    ev = _Events(P.rt, rec)
    s = P.rt.DeviceSession(1000, host_limit_bytes=500, watchdog=False,
                           event_handler=ev.handler)
    ev.budget = s.device
    with s:
        s.arbiter.current_thread_is_dedicated_to_task(1)
        ev.spillable.append(s.device.acquire(600))
        ev.spillable.append(s.device.acquire(300))
        r = s.device.acquire(800)              # spills until it fits
        rec.append(("after spill", s.device.used, s.device.available))
        s.device.resize(r, 200)                # shrink wakes, frees
        s.device.resize(r, 5000)               # advisory grow: no fit
        rec.append(("resized", r.nbytes, s.device.used))
        rec.append(("try", s.device.try_acquire(900) is None,
                    s.device.try_acquire(100).nbytes))
        rec.append(("fall through", _raised(lambda: s.device.acquire(950))))
        # the rollback's block-until-ready, wedged alone: split and retry
        rec.append(("block", _raised(s.arbiter.block_thread_until_ready),
                    s.arbiter.get_state_name_of(P.rt.current_thread_id())))
        h = s.host.acquire(400)
        rec.append(("host", s.host.used, _raised(lambda: s.host.acquire(200))))
        s.host.release(h)

        def boom(nbytes, retry_count):
            raise KeyError("handler failed")
        ev.handler.on_alloc_failure = boom
        rec.append(("raising handler", _raised(lambda: s.device.acquire(990)),
                    s.arbiter.get_state_name_of(
                        P.rt.current_thread_id())))
        rec.append(("metrics", s.arbiter.get_and_reset_num_retry_throw(1),
                    s.arbiter.get_and_reset_num_split_retry_throw(1)))
        s.arbiter.task_done(1)


def _with_retry(P, rec):
    """`with_retry` after forced RetryOOM and SplitAndRetryOOM, a split
    cascade, and a split with no splitter."""
    s = P.rt.DeviceSession(10 * MiB, watchdog=False)
    with s:
        arb = s.arbiter
        arb.current_thread_is_dedicated_to_task(1)
        tid = P.rt.current_thread_id()
        calls, rolled = [], []

        def attempt(n):
            calls.append(n)
            r = s.device.acquire(n)
            s.device.release(r)
            return n

        arb.force_retry_oom(tid, 1, P.rt.OomInjectionType.GPU, 0)
        rec.append(("retry", P.rt.with_retry(
            arb, attempt, 4 * MiB, split=lambda n: [n // 2, n // 2],
            on_rollback=lambda: rolled.append(1)), list(calls), len(rolled)))
        calls.clear()
        arb.force_split_and_retry_oom(tid, 2, P.rt.OomInjectionType.GPU, 0)
        rec.append(("split", P.rt.with_retry(
            arb, attempt, 8 * MiB, split=lambda n: [n // 2, n - n // 2]),
            list(calls)))
        arb.force_split_and_retry_oom(tid, 1, P.rt.OomInjectionType.GPU, 0)
        rec.append(("no splitter", _raised(
            lambda: P.rt.with_retry(arb, attempt, 8 * MiB))))
        deep = []

        def small(n):
            deep.append(n)
            if n > 1:
                raise P.rt.SplitAndRetryOOM(f"batch of {n}")
            return n

        out = P.rt.with_retry(arb, small, 16,
                              split=lambda n: [n // 2, n - n // 2])
        rec.append(("cascade", out, deep))
        rec.append(("metrics", arb.get_and_reset_num_retry_throw(1),
                    arb.get_and_reset_num_split_retry_throw(1)))
        arb.task_done(1)


def _spill(P, rec):
    """A registered buffer spills to let an op's reservation through, with
    no task-level retry; it comes back equal; a SpillableTable spills when
    protected, restores pinned, and a pinned table is never spilled."""
    s = P.rt.DeviceSession(1 * MiB, watchdog=False)
    pool = P.rt.SpillPool().attach(s.device)
    with s:
        s.arbiter.current_thread_is_dedicated_to_task(3)
        with P.rt.active_session(s):
            cached = P.array(np.arange(75_000, dtype=np.int64))
            buf = pool.register(cached)
            del cached
            rec.append(("registered", s.device.used, buf.nbytes))
            t = P.table(np.arange(40_000, dtype=np.int64))
            h = P.ops.murmur_hash3_32(t, seed=42)
            rec.append(("op through", h.length, buf.spilled,
                        pool.spill_count, pool.spilled_bytes,
                        s.arbiter.get_and_reset_num_retry_throw(3)))
            back = P.host(buf.get())
            rec.append(("restored", buf.spilled,
                        bool((back == np.arange(75_000)).all())))
            pool.unregister(buf)
            del h
            gc.collect()
            rec.append(("drained", s.device.used))
            tab = P.table(np.arange(30_000, dtype=np.int64),
                          np.arange(30_000, dtype=np.int64) * 3)
            st = P.rt.SpillableTable(pool, tab)
            del tab
            st.protect()
            rec.append(("protected", s.device.used))
            r = s.device.acquire(700_000)      # pressure: spills the table
            rec.append(("pressed", pool.spill_count, s.device.used))
            s.device.release(r)
            with st.use() as live:
                got = [P.host(c.data) for c in live.columns]
                rec.append(("use", [int(g.sum()) for g in got],
                            s.device.used))
                # pinned: pressure falls through to the task-level retry
                rec.append(("pinned", _raised(
                    lambda: s.device.acquire(700_000))))
            st.close()
            rec.append(("closed", s.device.used))
        s.arbiter.task_done(3)


def _public_op_admission(P, rec):
    """A public op's reservation shrinks to its output's bytes and returns
    when the output is collected."""
    s = P.rt.DeviceSession(10 * MiB, watchdog=False)
    with s:
        s.arbiter.current_thread_is_dedicated_to_task(5)
        col = P.table(np.arange(10_000, dtype=np.int64))
        rec.append(("no session", P.ops.murmur_hash3_32(col, 42).length,
                    s.device.used))
        with P.rt.active_session(s):
            out = P.ops.murmur_hash3_32(col, seed=42)
        rec.append(("held", s.device.used == P.rt.operand_nbytes(out),
                    s.device.used))
        del out
        gc.collect()
        rec.append(("freed", s.device.used))
        s.arbiter.task_done(5)


_SCENARIOS = {"budget": _budget, "with_retry": _with_retry,
              "spill": _spill, "public_op_admission": _public_op_admission}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_runtime_scenario_equals_the_jax_package(scenario):
    want, got = [], []
    _SCENARIOS[scenario](_Jax, want)
    _SCENARIOS[scenario](_Torch, got)
    assert got == want
    assert got


def test_rmmspark_facade_method_for_method():
    jm = {n for n, _ in inspect.getmembers(japi.RmmSpark,
                                           inspect.isfunction)}
    tm = {n for n, _ in inspect.getmembers(tapi.RmmSpark,
                                           inspect.isfunction)}
    assert tm == jm
    for n in jm:
        assert (inspect.signature(getattr(tapi.RmmSpark, n))
                == inspect.signature(getattr(japi.RmmSpark, n))), n
    for alias in ("RetryOOM", "SplitAndRetryOOM", "CpuRetryOOM",
                  "CpuSplitAndRetryOOM", "ResourceArbiter"):
        assert getattr(tapi, alias) is getattr(trt, alias)
    records = []
    for api in (japi, tapi):
        R, rec = api.RmmSpark, []
        R.setEventHandler()
        try:
            rec.append(_raised(lambda: R.setEventHandler()))
            tid = threading.get_native_id()
            R.currentThreadIsDedicatedToTask(7)
            rec.append((R.getStateOf(tid),
                        _raised(lambda: R.blockThreadUntilReady())))
            R.forceRetryOOM(tid, 2)
            R.forceSplitAndRetryOOM(tid, 1, 0, 2)
            arb = R._a()
            outs = []
            for _ in range(4):
                outs.append(_raised(lambda: arb.pre_alloc()))
                if outs[-1][0] == "ok":
                    arb.post_alloc_success()
            rec.append(outs)
            rec.append((R.getAndResetNumRetryThrow(7),
                        R.getAndResetNumSplitRetryThrow(7),
                        R.getAndResetBlockTimeNs(7) >= 0,
                        R.getAndResetComputeTimeLostToRetryNs(7) >= 0))
            R.taskDone(7)
            rec.append(R.getStateOf(tid))
            R.poolThreadWorkingOnTasks([8])
            rec.append(R.getStateOf(tid))
            R.poolThreadFinishedForTasks([8])
            rec.append(R.getStateOf(tid))
            R.shuffleThreadWorkingOnTasks([9])
            rec.append(R.getStateOf(tid))
            R.poolThreadFinishedForTasks([9])
        finally:
            R.clearEventHandler()
        rec.append(_raised(lambda: R.taskDone(1)))
        records.append(rec)
    assert records[1] == records[0]
