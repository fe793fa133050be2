"""The port's resource arbiter (spark_rapids_tpu_torch/runtime/adaptor.py
over its own copy of native/resource_adaptor.cpp) against the JAX
package's, call for call.

Each scenario is one scripted sequence of calls, after the reference's
RmmSparkTest cases as the JAX package's tests/test_resource_adaptor.py
runs them: task threads (dedicated, pool and shuffle) acquire and release
from small device and host budgets, block, are rolled back (BUFN), split,
hit the retry limit (HardOOM), are removed while blocked, and take
injected OOMs and framework exceptions. The scenario runs once over each
package's runtime and records every thread state, every call's outcome
(its value or exception class) and the per-task metrics at fixed points;
the two records must be equal. The watchdog is off in both: the scenario
calls `check_and_break_deadlocks()` itself, so nothing waits on a timer;
threads are awaited on events and on the arbiter's state. The copies of
the C++ source must agree below their headers. Tolerance: exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import queue
import threading
from pathlib import Path

import pytest

import spark_rapids_tpu.runtime as jrt
import spark_rapids_tpu_torch.runtime as trt

MiB = 1024 * 1024
_WAIT = 10.0


def _outcome(fut):
    assert fut["done"].wait(_WAIT), "task thread timed out"
    if "error" in fut:
        return ("raised", type(fut["error"]).__name__)
    return ("ok",)


class _Actor:
    """A task thread that runs submitted closures (the reference's
    TaskThread, RmmSparkTest.java:64-301)."""

    def __init__(self, rt, session, task_id=None, kind="dedicated"):
        self.rt, self.session = rt, session
        self.task_id, self.kind = task_id, kind
        self._q = queue.Queue()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._ready.wait(_WAIT)

    def _run(self):
        self.thread_id = self.rt.current_thread_id()
        if self.kind == "dedicated":
            self.session.arbiter.current_thread_is_dedicated_to_task(
                self.task_id)
        self._ready.set()
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut["value"] = fn()
            except BaseException as e:  # noqa: BLE001 - relayed
                fut["error"] = e
            finally:
                fut["done"].set()

    def submit(self, fn):
        fut = {"done": threading.Event()}
        self._q.put((fn, fut))
        return fut

    def run(self, fn):
        fut = self.submit(fn)
        out = _outcome(fut)
        return fut.get("value"), out

    def state(self):
        return self.session.arbiter.get_state_name_of(self.thread_id)

    def wait_state(self, *names):
        """Wait until the thread is in one of `names` (on the arbiter's
        state, never a timer); return the state."""
        ev = threading.Event()
        for _ in range(int(_WAIT / 0.001)):
            s = self.state()
            if s in names:
                return s
            ev.wait(0.001)
        raise AssertionError(f"thread never reached {names}; at {self.state()}")

    def stop(self, task_done=True):
        if task_done and self.task_id is not None:
            self.session.arbiter.task_done(self.task_id)
        self._q.put(None)
        self._thread.join(timeout=_WAIT)


def _drive(actor, fut, arb):
    """Wait for `fut`, breaking deadlocks whenever the actor's thread is
    parked (the watchdog's poll, made by hand); returns the number of
    polls that found it parked."""
    checks = 0
    for _ in range(int(_WAIT / 0.001)):
        if fut["done"].wait(0.001):
            return checks
        if actor.state() in ("THREAD_BLOCKED", "THREAD_BUFN"):
            arb.check_and_break_deadlocks()
            checks += 1
    raise AssertionError(f"task thread never finished; at {actor.state()}")


def _metrics(arb, task):
    return (arb.get_and_reset_num_retry_throw(task),
            arb.get_and_reset_num_split_retry_throw(task))


# ---- scenarios: (rt, session, record) -> None ------------------------------

def _blocking(rt, s, rec):
    one, two = _Actor(rt, s, 1), _Actor(rt, s, 2)
    rec.append(("start", one.state(), two.state()))
    r1, out = one.run(lambda: s.device.acquire(5 * MiB))
    rec.append(("one acquires 5", out, s.device.used))
    box = {}
    fut = two.submit(lambda: box.setdefault("r", s.device.acquire(6 * MiB)))
    rec.append(("two asks 6", two.wait_state("THREAD_BLOCKED")))
    rec.append(("one releases", one.run(lambda: s.device.release(r1))[1]))
    rec.append(("two wakes", _outcome(fut), s.device.used, two.state()))
    two.run(lambda: s.device.release(box["r"]))
    s.arbiter.get_and_reset_block_time_ns(2)
    rec.append(("metrics", _metrics(s.arbiter, 1), _metrics(s.arbiter, 2)))
    one.stop()
    two.stop()


def _mixed_blocking(rt, s, rec):
    a = [_Actor(rt, s, i) for i in (1, 2, 3, 4)]
    rg, _ = a[0].run(lambda: s.device.acquire(5 * MiB))
    rc, _ = a[1].run(lambda: s.host.acquire(5 * MiB))
    b3, b4 = {}, {}
    f3 = a[2].submit(lambda: b3.setdefault("r", s.device.acquire(6 * MiB)))
    rec.append(("three on device", a[2].wait_state("THREAD_BLOCKED")))
    f4 = a[3].submit(lambda: b4.setdefault("r", s.host.acquire(6 * MiB)))
    rec.append(("four on host", a[3].wait_state("THREAD_BLOCKED")))
    a[1].run(lambda: s.host.release(rc))
    rec.append(("host freed", _outcome(f4), a[2].state()))
    a[3].run(lambda: s.host.release(b4["r"]))
    a[0].run(lambda: s.device.release(rg))
    rec.append(("device freed", _outcome(f3), s.device.used, s.host.used))
    a[2].run(lambda: s.device.release(b3["r"]))
    for x in a:
        x.stop()


def _shuffle_and_pool(rt, s, rec):
    shuffle = _Actor(rt, s, kind="shuffle")
    pool = _Actor(rt, s, kind="pool")
    one, two = _Actor(rt, s, 1), _Actor(rt, s, 2)
    s.arbiter.shuffle_thread_working_on_tasks([1], thread_id=shuffle.thread_id)
    s.arbiter.pool_thread_working_on_tasks([1, 2], thread_id=pool.thread_id)
    rec.append(("registered", shuffle.state(), pool.state()))
    r1, _ = one.run(lambda: s.device.acquire(5 * MiB))
    bs, b2 = {}, {}
    fs = shuffle.submit(lambda: bs.setdefault("r", s.device.acquire(6 * MiB)))
    rec.append(("shuffle asks", shuffle.wait_state("THREAD_BLOCKED")))
    f2 = two.submit(lambda: b2.setdefault("r", s.device.acquire(6 * MiB)))
    rec.append(("two asks", two.wait_state("THREAD_BLOCKED")))
    one.run(lambda: s.device.release(r1))
    # the shuffle thread outranks every task thread
    rec.append(("shuffle first", _outcome(fs), f2["done"].is_set(),
                two.wait_state("THREAD_BLOCKED")))
    shuffle.run(lambda: s.device.release(bs["r"]))
    rec.append(("then two", _outcome(f2)))
    two.run(lambda: s.device.release(b2["r"]))
    rp, out = pool.run(lambda: s.device.acquire(1 * MiB))
    rec.append(("pool acquires", out, pool.state()))
    pool.run(lambda: s.device.release(rp))
    s.arbiter.pool_thread_finished_for_tasks([1], thread_id=shuffle.thread_id)
    s.arbiter.pool_thread_finished_for_tasks([1, 2], thread_id=pool.thread_id)
    rec.append(("finished", shuffle.state(), pool.state()))
    for x in (one, two):
        x.stop()
    shuffle.stop(task_done=False)
    pool.stop(task_done=False)


def _injection(rt, s, rec):
    one = _Actor(rt, s, 1)
    tid, arb = one.thread_id, s.arbiter
    gpu, cpu = rt.OomInjectionType.GPU, rt.OomInjectionType.CPU

    def cycle(budget):
        def go():
            r = budget.acquire(1 * MiB)
            budget.release(r)
        return one.run(go)[1]

    arb.force_retry_oom(tid, 2, gpu, 1)     # skip one, then throw two
    rec.append(("retry x2 skip 1", [cycle(s.device) for _ in range(4)]))
    arb.force_retry_oom(tid, 1, cpu, 0)     # the device is unaffected
    rec.append(("cpu filter", cycle(s.device), cycle(s.host)))
    arb.force_split_and_retry_oom(tid, 1, gpu, 0)
    rec.append(("split", cycle(s.device), cycle(s.device)))
    arb.force_framework_exception(tid, 2)
    rec.append(("exception x2", [cycle(s.device) for _ in range(3)]))
    rec.append(("try_acquire", one.run(
        lambda: s.device.try_acquire(11 * MiB))[0]))
    rec.append(("metrics", _metrics(arb, 1), _metrics(arb, 1)))
    one.stop()


def _bufn(rt, s, rec):
    """Task 3 (higher id, lower priority) is rolled back ahead of task 2,
    and leaves BUFN only when a task finishes."""
    three, two = _Actor(rt, s, 3), _Actor(rt, s, 2)
    arb = s.arbiter
    r3, _ = three.run(lambda: s.device.acquire(5 * MiB))
    r2, _ = two.run(lambda: s.device.acquire(3 * MiB))
    b2 = {}
    f2 = two.submit(lambda: b2.setdefault("r", s.device.acquire(3 * MiB)))
    two.wait_state("THREAD_BLOCKED")
    # everyone blocked: the arbiter rolls the lowest priority back at once
    f3 = three.submit(lambda: s.device.acquire(4 * MiB))
    rec.append(("all blocked", three.wait_state("THREAD_BLOCKED",
                                                "THREAD_BUFN_WAIT"),
                two.state()))
    arb.check_and_break_deadlocks()
    rec.append(("rolled back", _outcome(f3), three.state(), two.state()))
    three.run(lambda: s.device.release(r3))
    rec.append(("two wakes", _outcome(f2)))
    fb = three.submit(arb.block_thread_until_ready)
    rec.append(("three parks", three.wait_state("THREAD_BUFN")))
    two.run(lambda: s.device.release(b2["r"]))
    two.run(lambda: s.device.release(r2))
    arb.check_and_break_deadlocks()
    rec.append(("memory freed", two.state(), three.state()))
    two.stop()
    rec.append(("task done", _outcome(fb), three.wait_state("THREAD_RUNNING")))
    rec.append(("metrics", _metrics(arb, 3), _metrics(arb, 2)))
    three.stop()


def _split_single(rt, s, rec):
    """A task wedged alone is rolled back, then its block-until-ready is
    answered with SplitAndRetryOOM; half the size then fits."""
    one = _Actor(rt, s, 0)
    arb = s.arbiter
    r1, _ = one.run(lambda: s.device.acquire(5 * MiB))
    f = one.submit(lambda: s.device.acquire(6 * MiB))
    rec.append(("rolled back", _outcome(f), one.state()))
    fb = one.submit(arb.block_thread_until_ready)
    _drive(one, fb, arb)
    rec.append(("split", _outcome(fb), one.state()))
    rh, out = one.run(lambda: s.device.acquire(3 * MiB))
    rec.append(("half fits", out, s.device.used))
    one.run(lambda: s.device.release(rh))
    one.run(lambda: s.device.release(r1))
    rec.append(("metrics", _metrics(arb, 0)))
    one.stop()


def _retry_limit(rt, s, rec):
    """A loop that never frees anything gets a HardOOM after the limit
    (SparkResourceAdaptorJni.cpp:984-995)."""
    arb = s.arbiter
    arb.set_retry_limit(5)
    one = _Actor(rt, s, 1)
    one.run(lambda: s.device.acquire(9 * MiB))
    seen = []

    def spin():
        while True:
            try:
                r = s.device.acquire(2 * MiB)
                s.device.release(r)
                return
            except rt.HardOOM:
                raise
            except rt.ArbiterOOM as e:
                seen.append(type(e).__name__)

    f = one.submit(spin)
    _drive(one, f, arb)
    rec.append(("hard oom", _outcome(f), seen))
    rec.append(("metrics", _metrics(arb, 1)))
    one.stop()


def _remove_thread(rt, s, rec):
    """A thread removed from its task while blocked leaves with
    ThreadRemovedError; the other task is unaffected."""
    one, two = _Actor(rt, s, 1), _Actor(rt, s, 2)
    r1, _ = one.run(lambda: s.device.acquire(8 * MiB))
    f = two.submit(lambda: s.device.acquire(8 * MiB))
    rec.append(("blocked", two.wait_state("THREAD_BLOCKED")))
    s.arbiter.remove_dedicated_thread_association(two.thread_id, 2)
    rec.append(("removed", _outcome(f), two.state(), one.state()))
    one.run(lambda: s.device.release(r1))
    rec.append(("after", s.device.used, _metrics(s.arbiter, 2)))
    one.stop()
    two.stop(task_done=False)


_SCENARIOS = {"blocking": _blocking, "mixed_blocking": _mixed_blocking,
              "shuffle_and_pool": _shuffle_and_pool,
              "injection": _injection, "bufn": _bufn,
              "split_single": _split_single, "retry_limit": _retry_limit,
              "remove_thread": _remove_thread}


def _record(rt, scenario):
    rec = []
    with rt.DeviceSession(10 * MiB, host_limit_bytes=10 * MiB,
                          watchdog=False) as s:
        _SCENARIOS[scenario](rt, s, rec)
    return rec


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_arbiter_scenario_equals_the_jax_package(scenario):
    want = _record(jrt, scenario)
    got = _record(trt, scenario)
    assert got == want
    assert got            # the scenario recorded something


def test_state_codes_and_exception_tree_equal():
    assert trt.STATE_NAMES == jrt.STATE_NAMES
    for name in ("STATE_UNKNOWN", "STATE_RUNNING", "STATE_ALLOC",
                 "STATE_ALLOC_FREE", "STATE_BLOCKED", "STATE_BUFN_THROW",
                 "STATE_BUFN_WAIT", "STATE_BUFN", "STATE_SPLIT_THROW",
                 "STATE_REMOVE_THROW"):
        assert getattr(trt, name) == getattr(jrt, name)
    for name in ("RetryOOM", "SplitAndRetryOOM", "CpuRetryOOM",
                 "CpuSplitAndRetryOOM"):
        assert issubclass(getattr(trt, name), trt.ArbiterOOM)
        assert issubclass(getattr(trt, name), MemoryError)
    assert issubclass(trt.HardOOM, MemoryError)
    assert not issubclass(trt.HardOOM, trt.ArbiterOOM)
    assert sorted(trt.__all__) == sorted(jrt.__all__)


def test_native_copy_kept_in_step_and_built_at_first_use():
    root = Path(__file__).resolve().parent.parent
    mine = (root / "spark_rapids_tpu_torch/native/resource_adaptor.cpp"
            ).read_text()
    ref = (root / "spark_rapids_tpu/native/resource_adaptor.cpp").read_text()
    cut = "#include <algorithm>"
    assert mine[mine.index(cut):] == ref[ref.index(cut):]
    from spark_rapids_tpu_torch.native import build
    path = build.build()
    assert path.parent.name == "_build" and path.exists()
    assert path == build.library_path("resource_adaptor")
    assert build.build_seconds() == 0.0           # already current
