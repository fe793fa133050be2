"""Admission control at the op boundary.

Counterpart of `spark_rapids_tpu/runtime/admission.py`. In the reference
every device allocation crosses the arbiter because the allocator itself is
wrapped (`spark_resource_adaptor::do_allocate`,
SparkResourceAdaptorJni.cpp:1733). The port keeps PyTorch's caching
allocator, as the JAX package keeps XLA's, so the crossing point is *op
dispatch*: the working set is computed from the operands' shapes before any
device work is launched, and a reservation is acquired from the active
`DeviceSession`'s budget first. The acquire path is the arbiter's state
machine: under pressure the thread blocks, and deadlocks escalate to
RetryOOM or SplitAndRetryOOM, from which `with_retry` recovers as the
reference's contract prescribes (RmmSpark.java:402-416).

`operand_nbytes` reads shapes and dtypes only, never a device value, so
admission adds no synchronisation (the capped tier's first run is launched
under `torch.cuda.set_sync_debug_mode("error")`).

Lifetime: after the op, the reservation shrinks to the bytes of its outputs
and is tied to the output objects by weakref finalizers; when the last one
is collected the bytes return to the budget and blocked threads wake, as
`do_deallocate` does (SparkResourceAdaptorJni.cpp:1756).

With no active session every wrapper passes through, so the engine runs
unbudgeted by default. `PlanExecutor(session=...)` scopes a session to one
execution on its thread (`active_session`).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Optional

import torch

from .pool import DeviceSession

_state = threading.local()
_global_session: Optional[DeviceSession] = None
_global_lock = threading.Lock()


def set_active_session(session: Optional[DeviceSession]) -> None:
    """Install `session` process-wide (the analogue of
    RmmSpark.setEventHandler). Pass None to uninstall."""
    global _global_session
    with _global_lock:
        old = _global_session
        _global_session = session
    # drop the displaced session outside the lock: its teardown runs
    # weakref finalizers, which may reach back into this module
    del old


def get_active_session() -> Optional[DeviceSession]:
    override = getattr(_state, "session", None)
    if override is not None:
        return override
    return _global_session


class active_session:
    """Context manager scoping a session to the current thread."""

    def __init__(self, session: DeviceSession):
        self.session = session

    def __enter__(self):
        self._prev = getattr(_state, "session", None)
        _state.session = self.session
        return self.session

    def __exit__(self, *exc):
        _state.session = self._prev
        return False


# ---- byte accounting --------------------------------------------------------

def array_nbytes(a) -> int:
    """Bytes of one dense buffer, from its shape and dtype."""
    if a is None:
        return 0
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    try:
        import numpy as np
        return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
    except Exception:
        return 0


def operand_nbytes(obj: Any) -> int:
    """Total buffer bytes reachable from a Column, Table, tensor, or a
    list, tuple, dict or dataclass of them."""
    # local imports: columnar must not cycle into runtime
    from ..columnar.column import Column
    from ..columnar.table import Table
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return 0
    if isinstance(obj, Column):
        return (array_nbytes(obj.data) + array_nbytes(obj.validity) +
                array_nbytes(obj.offsets) +
                sum(operand_nbytes(c) for c in obj.children))
    if isinstance(obj, Table):
        return sum(operand_nbytes(c) for c in obj.columns)
    if isinstance(obj, (list, tuple)):
        return sum(operand_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(operand_nbytes(v) for v in obj.values())
    if isinstance(obj, torch.Tensor):
        return array_nbytes(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # holders of device buffers (a BloomFilter's words) stay visible
        # to the budget
        return sum(operand_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


# ---- reservation lifetime ---------------------------------------------------

class _SharedRelease:
    """Releases one reservation when the last of N output objects dies."""

    def __init__(self, budget, reservation, count: int):
        self.budget = budget
        self.reservation = reservation
        self.count = count
        self.lock = threading.Lock()

    def dec(self):
        with self.lock:
            self.count -= 1
            done = self.count == 0
        if done:
            # runs from a weakref finalizer on any thread: the release is
            # host accounting and must always land, poisoned device or not
            from .. import faultinj
            with faultinj.suppressed():
                self.budget.release(self.reservation)


def _weakrefable_outputs(out: Any) -> list:
    """Output objects whose lifetime should own the reservation, in the
    reference's depth-first order.

    An explicit stack, not the reference's nested recursive `walk`: a
    closure that calls itself through its own cell is a reference cycle,
    and the cycle held `found`, so the finalizers below fired only when
    the cyclic GC ran (ROADMAP queue C 9, a recorded deviation). Here the
    reservation returns when the last holder dies, as `do_deallocate`
    does in the JNI arbiter."""
    from ..columnar.column import Column
    from ..columnar.table import Table
    found = []
    stack = [out]
    while stack:
        o = stack.pop()
        if isinstance(o, (Column, Table, torch.Tensor)):
            found.append(o)        # do not descend: the holder is enough
        elif isinstance(o, (list, tuple)):
            stack.extend(reversed(o))
        elif isinstance(o, dict):
            stack.extend(reversed(list(o.values())))
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            if operand_nbytes(o):
                found.append(o)
    return found


def tie_to_outputs(budget, reservation, out: Any) -> None:
    """Shrink `reservation` to the outputs' true bytes and hand it to the
    output objects; release it at once when the output holds no buffer."""
    actual = operand_nbytes(out)
    budget.resize(reservation, actual)
    if actual == 0:
        budget.release(reservation)
        return
    live = []
    for h in _weakrefable_outputs(out):
        try:
            weakref.ref(h)
            live.append(h)
        except TypeError:
            pass
    if not live:
        budget.release(reservation)
        return
    shared = _SharedRelease(budget, reservation, len(live))
    for h in live:
        weakref.finalize(h, shared.dec)


# ---- the op wrapper ---------------------------------------------------------

def admitted_op(fn, factor: float = 2.0, min_bytes: int = 0, estimator=None):
    """Wrap an op with reservation-based admission.

    The working-set estimate is `factor x input buffer bytes` (+min_bytes);
    an explicit `estimator(*args, **kw) -> bytes` overrides it. After the
    op runs, the reservation shrinks to the outputs' bytes and is tied to
    their lifetime."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        session = get_active_session()
        if session is None:
            return fn(*args, **kwargs)
        if estimator is not None:
            est = int(estimator(*args, **kwargs))
        else:
            est = int(factor * (operand_nbytes(args) + operand_nbytes(kwargs)))
        est = max(est, min_bytes)
        if est <= 0:
            return fn(*args, **kwargs)
        reservation = session.device.acquire(est)
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            session.device.release(reservation)
            raise
        tie_to_outputs(session.device, reservation, out)
        return out

    wrapper.__wrapped__ = fn
    wrapper.__admitted__ = True
    return wrapper
