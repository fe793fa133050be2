"""Task and memory arbitration for many task threads sharing one card.

Counterpart of `spark_rapids_tpu/runtime/adaptor.py`: the ctypes binding
over the port's own copy of the native core (`native/resource_adaptor.cpp`,
built with g++ at first use by `native/build.py`), in the role the Java
RmmSpark/SparkResourceAdaptor pair plays in the reference. The contract:

- every thread doing device work registers as a *dedicated task thread*, a
  *pool thread* (serving several tasks), or a *shuffle thread* (top
  priority);
- reservations flow through the arbiter: one that does not fit blocks the
  thread, a deadlock escalates the lowest-priority thread to a RetryOOM
  rollback (BUFN), and a wedged card escalates the highest-priority task to
  SplitAndRetryOOM (split the batch and retry the halves);
- a daemon watchdog polls for deadlocks every 100 ms
  (SparkResourceAdaptor.java:35-79); `check_and_break_deadlocks()` is the
  same poll, called directly;
- per-task retry metrics drain with get-and-reset semantics;
- OOM and exception injection force every path without real exhaustion.

The binding loads the library with `ctypes.CDLL`, which releases the GIL
around every call, so a thread the arbiter blocks in C++ does not stop the
others. The native core returns status codes; this module raises the
matching exception (RetryOOM etc., the reference's GpuRetryOOM,
GpuSplitAndRetryOOM, CpuRetryOOM and CpuSplitAndRetryOOM).
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Iterable, Optional

from ..native.build import build

# the reference's 100 ms watchdog (SparkResourceAdaptor.java:35-36) and its
# 500 retries without progress before a HardOOM
# (SparkResourceAdaptorJni.cpp:984-995)
WATCHDOG_PERIOD_S = 0.1
RETRY_LIMIT = 500

# ---- exception hierarchy (mirrors the reference's GpuOOM/OffHeapOOM tree) ---


class ArbiterOOM(MemoryError):
    """Base for all recoverable OOM signals raised by the arbiter."""


class RetryOOM(ArbiterOOM):
    """Device OOM: roll back to a spillable state, block until ready, retry."""


class SplitAndRetryOOM(ArbiterOOM):
    """Device OOM: additionally split the input and retry the halves."""


class CpuRetryOOM(ArbiterOOM):
    """Host off-heap OOM: roll back and retry."""


class CpuSplitAndRetryOOM(ArbiterOOM):
    """Host off-heap OOM: split the input and retry."""


class HardOOM(MemoryError):
    """Retry limit exceeded (livelock watchdog) — a real, fatal OOM."""


class InjectedException(RuntimeError):
    """Test-injected framework exception (forceFrameworkException)."""


class ThreadRemovedError(RuntimeError):
    """The thread was deregistered while blocked."""


_STATUS_TO_EXC = {
    1: RetryOOM,
    2: SplitAndRetryOOM,
    3: CpuRetryOOM,
    4: CpuSplitAndRetryOOM,
    5: InjectedException,
    6: ThreadRemovedError,
    7: HardOOM,
    8: ValueError,
}

# shutdown timed out with threads still parked on native state (not an
# exception: close() reacts by leaking the handle instead of destroying it)
SRA_BUSY = 9

# Thread states, numerically identical to RmmSparkThreadState.java:23-34.
STATE_UNKNOWN = -1
STATE_RUNNING = 0
STATE_ALLOC = 1
STATE_ALLOC_FREE = 2
STATE_BLOCKED = 3
STATE_BUFN_THROW = 4
STATE_BUFN_WAIT = 5
STATE_BUFN = 6
STATE_SPLIT_THROW = 7
STATE_REMOVE_THROW = 8

STATE_NAMES = {
    -1: "UNKNOWN", 0: "THREAD_RUNNING", 1: "THREAD_ALLOC", 2: "THREAD_ALLOC_FREE",
    3: "THREAD_BLOCKED", 4: "THREAD_BUFN_THROW", 5: "THREAD_BUFN_WAIT",
    6: "THREAD_BUFN", 7: "THREAD_SPLIT_THROW", 8: "THREAD_REMOVE_THROW",
}


class OomInjectionType:
    """Filter for injected OOMs (RmmSpark.OomInjectionType)."""
    CPU_OR_GPU = 0
    CPU = 1
    GPU = 2


def _load():
    lib = ctypes.CDLL(str(build("resource_adaptor")))
    L = ctypes.c_int64
    P = ctypes.c_void_p
    I = ctypes.c_int
    lib.sra_create.restype = P
    lib.sra_create.argtypes = [ctypes.c_char_p]
    lib.sra_destroy.argtypes = [P]
    lib.sra_last_error.restype = ctypes.c_char_p
    lib.sra_set_retry_limit.argtypes = [P, I]
    lib.sra_start_dedicated_task_thread.argtypes = [P, L, L, L]
    lib.sra_pool_thread_working_on_tasks.argtypes = [P, I, L, ctypes.POINTER(L), I, L]
    lib.sra_pool_thread_finished_for_tasks.argtypes = [P, L, ctypes.POINTER(L), I, L]
    lib.sra_remove_thread_association.argtypes = [P, L, L, L]
    lib.sra_task_done.argtypes = [P, L, L]
    lib.sra_all_done.argtypes = [P, L]
    lib.sra_set_pool_blocked.argtypes = [P, L, I]
    lib.sra_set_thread_blocked_hint.argtypes = [P, L, I]
    lib.sra_start_retry_block.argtypes = [P, L]
    lib.sra_end_retry_block.argtypes = [P, L]
    lib.sra_force_retry_oom.argtypes = [P, L, I, I, I]
    lib.sra_force_split_retry_oom.argtypes = [P, L, I, I, I]
    lib.sra_force_exception.argtypes = [P, L, I]
    lib.sra_pre_alloc.argtypes = [P, L, I, I, L, ctypes.POINTER(I)]
    lib.sra_post_alloc_success.argtypes = [P, L, I, I, L]
    lib.sra_post_alloc_failed.argtypes = [P, L, I, I, I, I, L, ctypes.POINTER(I)]
    lib.sra_dealloc.argtypes = [P, L, I, L]
    lib.sra_block_thread_until_ready.argtypes = [P, L, L]
    lib.sra_check_and_break_deadlocks.argtypes = [P, L]
    lib.sra_get_thread_state.argtypes = [P, L]
    for m in ("sra_get_and_reset_num_retry", "sra_get_and_reset_num_split_retry",
              "sra_get_and_reset_block_time_ns", "sra_get_and_reset_lost_time_ns"):
        getattr(lib, m).restype = L
        getattr(lib, m).argtypes = [P, L]
    return lib


_lib = None
_lib_lock = threading.Lock()


def _native():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def current_thread_id() -> int:
    """OS thread id of the calling thread (the arbiter's thread identity)."""
    return threading.get_native_id()


def _watchdog_loop(arbiter_ref, stop: threading.Event, period_s: float):
    """Deadlock-watchdog body (daemon thread, 100 ms cadence — the Java
    watchdog in SparkResourceAdaptor.java:59-69)."""
    me = current_thread_id()
    while not stop.wait(period_s):
        arbiter = arbiter_ref()
        if arbiter is None or arbiter._closed:
            return
        arbiter._lib.sra_check_and_break_deadlocks(arbiter._h, me)
        del arbiter  # drop the strong ref before sleeping


class ResourceArbiter:
    """One arbiter per device (per process). Owns the native state machine and
    the deadlock watchdog daemon (100 ms cadence, like
    SparkResourceAdaptor.java:35-36)."""


    def __init__(self, log_loc: Optional[str] = None, watchdog: bool = True):
        self._lib = _native()
        self._h = self._lib.sra_create((log_loc or "").encode())
        if not self._h:
            raise ValueError(self._lib.sra_last_error().decode())
        self._lib.sra_set_retry_limit(self._h, RETRY_LIMIT)
        self._closed = False
        # RLock: dealloc (called from weakref finalizers) guards on this
        # lock; a finalizer firing on the thread that is mid-close() must
        # not self-deadlock. The native handle is live until the final
        # destroy, so a reentrant dealloc during close is safe.
        self._close_lock = threading.RLock()
        self._watchdog_stop = threading.Event()
        self._watchdog = None
        if watchdog:
            # weakref target: a bound-method target would root the arbiter
            # and keep __del__ from ever firing
            self._watchdog = threading.Thread(
                target=_watchdog_loop,
                args=(weakref.ref(self), self._watchdog_stop,
                      WATCHDOG_PERIOD_S),
                name="arbiter-watchdog", daemon=True)
            self._watchdog.start()

    # -- plumbing -------------------------------------------------------------
    def _check(self, code: int) -> None:
        if code == 0:
            return
        msg = self._lib.sra_last_error().decode()
        raise _STATUS_TO_EXC.get(code, RuntimeError)(msg)

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._watchdog_stop.set()
            watchdog_live = False
            if self._watchdog is not None and self._watchdog is not threading.current_thread():
                self._watchdog.join(timeout=5)  # never destroy under its feet
                watchdog_live = self._watchdog.is_alive()
            rc = self._lib.sra_all_done(self._h, current_thread_id())
            self._closed = True
            # A straggler (SRA_BUSY: a registered thread never observed
            # REMOVE_THROW within the bounded wait; or a watchdog stalled past
            # the join timeout) may still be parked on native state —
            # destroying now would free memory under its feet, so leak the
            # handle instead. Same shutdown hazard the reference bounds with
            # its 1 s wait (SparkResourceAdaptorJni.cpp all_done :659-690);
            # we choose leak over use-after-free.
            if rc != SRA_BUSY and not watchdog_live:
                self._lib.sra_destroy(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- registration (RmmSpark.currentThreadIsDedicatedToTask etc.) ---------
    def current_thread_is_dedicated_to_task(self, task_id: int) -> None:
        tid = current_thread_id()
        self._check(self._lib.sra_start_dedicated_task_thread(self._h, tid, task_id, tid))

    def start_dedicated_task_thread(self, thread_id: int, task_id: int) -> None:
        self._check(self._lib.sra_start_dedicated_task_thread(
            self._h, thread_id, task_id, current_thread_id()))

    @staticmethod
    def _ids(task_ids: Iterable[int]):
        ids = list(task_ids)
        return (ctypes.c_int64 * len(ids))(*ids), len(ids)

    def shuffle_thread_working_on_tasks(self, task_ids: Iterable[int],
                                        thread_id: Optional[int] = None) -> None:
        arr, n = self._ids(task_ids)
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_pool_thread_working_on_tasks(
            self._h, 1, tid, arr, n, current_thread_id()))

    def pool_thread_working_on_tasks(self, task_ids: Iterable[int],
                                     thread_id: Optional[int] = None) -> None:
        arr, n = self._ids(task_ids)
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_pool_thread_working_on_tasks(
            self._h, 0, tid, arr, n, current_thread_id()))

    def pool_thread_finished_for_tasks(self, task_ids: Iterable[int],
                                       thread_id: Optional[int] = None) -> None:
        arr, n = self._ids(task_ids)
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_pool_thread_finished_for_tasks(
            self._h, tid, arr, n, current_thread_id()))

    def remove_dedicated_thread_association(self, thread_id: int, task_id: int) -> None:
        self._check(self._lib.sra_remove_thread_association(
            self._h, thread_id, task_id, current_thread_id()))

    def remove_current_dedicated_thread_association(self, task_id: int) -> None:
        self.remove_dedicated_thread_association(current_thread_id(), task_id)

    def task_done(self, task_id: int) -> None:
        self._check(self._lib.sra_task_done(self._h, task_id, current_thread_id()))

    # -- pool-wait bracketing (RmmSpark.submittingToPool/waitingOnPool) ------
    def submitting_to_pool(self, thread_id: Optional[int] = None) -> None:
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_set_pool_blocked(self._h, tid, 1))

    waiting_on_pool = submitting_to_pool

    def done_waiting_on_pool(self, thread_id: Optional[int] = None) -> None:
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_set_pool_blocked(self._h, tid, 0))

    def set_thread_blocked_hint(self, thread_id: int, blocked: bool) -> None:
        """Tell the deadlock detector a thread is parked in code it cannot
        see (the reference asks the JVM via ThreadStateRegistry.isThreadBlocked
        for this — SparkResourceAdaptorJni.cpp:1500-1502)."""
        self._check(self._lib.sra_set_thread_blocked_hint(self._h, thread_id, int(blocked)))

    # -- retry-block metrics bracketing --------------------------------------
    def start_retry_block(self, thread_id: Optional[int] = None) -> None:
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_start_retry_block(self._h, tid))

    def end_retry_block(self, thread_id: Optional[int] = None) -> None:
        tid = thread_id if thread_id is not None else current_thread_id()
        self._check(self._lib.sra_end_retry_block(self._h, tid))

    # -- injection (test hooks; RmmSpark.forceRetryOOM etc.) -----------------
    def force_retry_oom(self, thread_id: int, num_ooms: int = 1,
                        oom_filter: int = OomInjectionType.CPU_OR_GPU,
                        skip_count: int = 0) -> None:
        self._check(self._lib.sra_force_retry_oom(
            self._h, thread_id, num_ooms, oom_filter, skip_count))

    def force_split_and_retry_oom(self, thread_id: int, num_ooms: int = 1,
                                  oom_filter: int = OomInjectionType.CPU_OR_GPU,
                                  skip_count: int = 0) -> None:
        self._check(self._lib.sra_force_split_retry_oom(
            self._h, thread_id, num_ooms, oom_filter, skip_count))

    def force_framework_exception(self, thread_id: int, num_times: int = 1) -> None:
        self._check(self._lib.sra_force_exception(self._h, thread_id, num_times))

    def set_retry_limit(self, limit: int) -> None:
        self._lib.sra_set_retry_limit(self._h, limit)

    # -- allocation path ------------------------------------------------------
    def pre_alloc(self, is_cpu: bool = False, blocking: bool = True) -> bool:
        """Admission gate before reserving memory. Returns True when this is
        a recursive (spill-path) allocation. Raises the retry/split family."""
        tid = current_thread_id()
        rec = ctypes.c_int(0)
        self._check(self._lib.sra_pre_alloc(
            self._h, tid, int(is_cpu), int(blocking), tid, ctypes.byref(rec)))
        return bool(rec.value)

    def post_alloc_success(self, is_cpu: bool = False, was_recursive: bool = False) -> None:
        tid = current_thread_id()
        self._check(self._lib.sra_post_alloc_success(
            self._h, tid, int(is_cpu), int(was_recursive), tid))

    def post_alloc_failed(self, is_cpu: bool = False, was_oom: bool = True,
                          blocking: bool = True, was_recursive: bool = False) -> bool:
        """Returns True when the allocation should be retried."""
        tid = current_thread_id()
        retry = ctypes.c_int(0)
        self._check(self._lib.sra_post_alloc_failed(
            self._h, tid, int(is_cpu), int(was_oom), int(blocking), int(was_recursive),
            tid, ctypes.byref(retry)))
        return bool(retry.value)

    def dealloc(self, is_cpu: bool = False) -> None:
        tid = current_thread_id()
        # Admission reservations are released by weakref finalizers when op
        # outputs are collected — which can be *after* the session closed and
        # the native handle was destroyed. Gate on the close lock so a late
        # free is a no-op instead of a use-after-free.
        with self._close_lock:
            if self._closed:
                return
            self._check(self._lib.sra_dealloc(self._h, tid, int(is_cpu), tid))

    def block_thread_until_ready(self) -> None:
        """Called after catching RetryOOM, before retrying (the contract in
        RmmSpark.java:402-416): parks until the arbiter says go."""
        tid = current_thread_id()
        self._check(self._lib.sra_block_thread_until_ready(self._h, tid, tid))

    def check_and_break_deadlocks(self) -> None:
        self._check(self._lib.sra_check_and_break_deadlocks(self._h, current_thread_id()))

    # -- observability --------------------------------------------------------
    def get_state_of(self, thread_id: int) -> int:
        return self._lib.sra_get_thread_state(self._h, thread_id)

    def get_state_name_of(self, thread_id: int) -> str:
        return STATE_NAMES[self.get_state_of(thread_id)]

    def get_and_reset_num_retry_throw(self, task_id: int) -> int:
        return self._lib.sra_get_and_reset_num_retry(self._h, task_id)

    def get_and_reset_num_split_retry_throw(self, task_id: int) -> int:
        return self._lib.sra_get_and_reset_num_split_retry(self._h, task_id)

    def get_and_reset_block_time_ns(self, task_id: int) -> int:
        return self._lib.sra_get_and_reset_block_time_ns(self._h, task_id)

    def get_and_reset_computation_time_lost_ns(self, task_id: int) -> int:
        return self._lib.sra_get_and_reset_lost_time_ns(self._h, task_id)
