"""Reservation-based admission of device and host memory, per task.

Counterpart of `spark_rapids_tpu/runtime/pool.py`. The reference wraps
rmm's device allocator and catches the synchronous cudaMalloc failure
(`do_allocate`, SparkResourceAdaptorJni.cpp:1733-1754). The port, as the
JAX package, keeps PyTorch's own caching allocator and reserves budget
*before* it dispatches work, with the same observable retry contract: a
reservation that does not fit behaves as a failed cudaMalloc does (the
thread blocks, retries when memory frees, and escalates to RetryOOM or
SplitAndRetryOOM on a deadlock).

`MemoryBudget` is one budget (device or host); tests use small budgets as
the reference's tests use `setupRmmForTestingWithLimits` (RmmSparkTest.java).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from .adaptor import ResourceArbiter, HardOOM


@dataclass
class Reservation:
    """A live memory reservation; free via MemoryBudget.release()."""
    nbytes: int
    is_cpu: bool
    _released: bool = False


class MemoryEventHandler:
    """Spill hook, the slot RmmEventHandlerResourceAdaptor fills in the
    reference's allocator chain (SparkResourceAdaptor → event-handler adaptor
    → pool; SURVEY.md §3.2 "child mr chain"). The plugin registers one whose
    on_alloc_failure makes buffers spillable/frees them and returns True to
    retry the allocation immediately — BEFORE the task-level blocking/retry
    state machine gets involved.

    Subclass and override; default is a no-op handler."""

    def on_alloc_failure(self, nbytes: int, retry_count: int) -> bool:
        """Called when a reservation doesn't fit. Return True if memory may
        have been freed (spilled) and the reservation should be retried
        immediately; False to fall through to the arbiter's blocking retry."""
        return False

    def on_allocated(self, total_used: int) -> None:
        """Called after a successful reservation with the new used total
        (the reference's alloc-threshold callback, coarse-grained)."""

    def on_deallocated(self, total_used: int) -> None:
        """Called after a release with the new used total."""


class MemoryBudget:
    """A byte budget for one memory space, fronted by the arbiter.

    acquire() runs the reference's do_allocate loop shape: pre_alloc (may
    block / raise retry-split) → try reserve → post_alloc_success, or
    post_alloc_failed → loop. release() mirrors do_deallocate: give the bytes
    back, then notify the arbiter so blocked threads wake.
    """

    def __init__(self, arbiter: ResourceArbiter, limit_bytes: int, is_cpu: bool = False,
                 event_handler: Optional[MemoryEventHandler] = None):
        self.arbiter = arbiter
        self.limit = int(limit_bytes)
        self.is_cpu = is_cpu
        self.event_handler = event_handler
        self._used = 0
        # RLock: releases run from weakref finalizers, which can fire via GC
        # on a thread that is already inside one of our critical sections; a
        # plain Lock would self-deadlock. The interleaving is benign — every
        # section is short arithmetic whose checks stay conservative when
        # _used shrinks mid-section.
        self._mu = threading.RLock()

    @property
    def used(self) -> int:
        with self._mu:
            return self._used

    @property
    def available(self) -> int:
        with self._mu:
            return self.limit - self._used

    def _try_reserve(self, nbytes: int) -> bool:
        with self._mu:
            if self._used + nbytes > self.limit:
                return False
            self._used += nbytes
            return True

    def acquire(self, nbytes: int) -> Reservation:
        """Blocking reservation: loops pre→reserve→post like the reference's
        do_allocate (SparkResourceAdaptorJni.cpp:1733-1754)."""
        nbytes = int(nbytes)
        # NB: a reservation larger than the whole budget still goes through
        # the state machine — the caller deserves its RetryOOM/SplitAndRetry
        # escalations (splitting may shrink the request until it fits); the
        # retry-limit watchdog bounds the livelock with a HardOOM, exactly
        # like the reference's 500-retry cap (SparkResourceAdaptorJni.cpp:984).
        while True:
            r = self._attempt(nbytes, blocking=True)
            if r is not None:
                return r

    def try_acquire(self, nbytes: int) -> Optional[Reservation]:
        """Non-blocking: one attempt; None on failure (the reference's
        tryAlloc path — LimitingOffHeapAllocForTests.java)."""
        return self._attempt(int(nbytes), blocking=False)

    def _attempt(self, nbytes: int, blocking: bool) -> Optional[Reservation]:
        recursive = self.arbiter.pre_alloc(is_cpu=self.is_cpu, blocking=blocking)
        ok = False
        try:
            ok = self._try_reserve(nbytes)
            if not ok and self.event_handler is not None:
                # spill loop: let the handler free memory and retry
                # immediately, before the task-level state machine blocks this
                # thread (the RmmEventHandlerResourceAdaptor contract:
                # onAllocFailure returns true -> retry the allocation)
                spill_retries = 0
                while not ok and self.event_handler.on_alloc_failure(
                        nbytes, spill_retries):
                    spill_retries += 1
                    ok = self._try_reserve(nbytes)
        except BaseException:
            # a raising handler must not leave this thread parked in the
            # arbiter's ALLOC state (every later pre_alloc would look
            # recursive and bypass blocking admission)
            if ok:
                with self._mu:
                    self._used -= nbytes
            self.arbiter.post_alloc_failed(
                is_cpu=self.is_cpu, was_oom=False, blocking=False,
                was_recursive=recursive)
            raise
        if ok:
            self.arbiter.post_alloc_success(is_cpu=self.is_cpu, was_recursive=recursive)
            r = Reservation(nbytes=nbytes, is_cpu=self.is_cpu)
            if self.event_handler is not None:
                try:
                    self.event_handler.on_allocated(self.used)
                except BaseException:
                    self.release(r)   # undo: the caller never sees r
                    raise
            return r
        retry = self.arbiter.post_alloc_failed(
            is_cpu=self.is_cpu, was_oom=True, blocking=blocking, was_recursive=recursive)
        if blocking and not retry:
            raise HardOOM(f"allocation of {nbytes} failed and retry is not possible")
        return None

    def resize(self, r: Reservation, nbytes: int) -> None:
        """Shrink (or best-effort grow) a live reservation to `nbytes`.

        The admission layer reserves a pre-dispatch working-set estimate and
        shrinks to the outputs' true bytes once they exist — the analogue of
        transient kernel scratch being freed at kernel end while the output
        allocation stays. Shrinking always succeeds and wakes blocked
        threads; growing takes only what fits (no blocking here: the grow
        path is advisory)."""
        nbytes = int(nbytes)
        with self._mu:
            if r._released:
                return
            delta = nbytes - r.nbytes
            if delta > 0 and self._used + delta > self.limit:
                return  # advisory grow did not fit; keep the old size
            self._used += delta
            r.nbytes = nbytes
        if delta < 0:
            self.arbiter.dealloc(is_cpu=self.is_cpu)
            if self.event_handler is not None:
                self.event_handler.on_deallocated(self.used)

    def release(self, r: Reservation) -> None:
        with self._mu:
            if r._released:
                return
            r._released = True
            self._used -= r.nbytes
        if r.nbytes > 0:
            self.arbiter.dealloc(is_cpu=self.is_cpu)
            if self.event_handler is not None:
                self.event_handler.on_deallocated(self.used)


class DeviceSession:
    """Process-wide pair of budgets (device memory + host off-heap) and the
    arbiter that coordinates them — the counterpart of
    `Rmm.initialize + RmmSpark.setEventHandler` at executor startup
    (SURVEY.md §3.3)."""

    def __init__(self, device_limit_bytes: int, host_limit_bytes: int = 0,
                 log_loc: Optional[str] = None, watchdog: bool = True,
                 event_handler: Optional[MemoryEventHandler] = None):
        self.arbiter = ResourceArbiter(log_loc=log_loc, watchdog=watchdog)
        self.device = MemoryBudget(self.arbiter, device_limit_bytes,
                                   is_cpu=False, event_handler=event_handler)
        self.host = MemoryBudget(self.arbiter, host_limit_bytes, is_cpu=True)

    def close(self):
        self.arbiter.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
