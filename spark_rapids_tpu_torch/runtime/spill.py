"""Spillable device buffers and the MemoryEventHandler that frees them.

Counterpart of `spark_rapids_tpu/runtime/spill.py`. The reference's
allocator chain has an event-handler adaptor between the arbiter and the
pool (`RmmEventHandlerResourceAdaptor`, SURVEY.md §3.2): on an allocation
failure the handler frees cached buffers and returns true, so the
allocation retries at once, before the task-level blocking state machine
engages. `SpillPool` is that handler: a registered tensor is copied to host
memory and its device copy dropped, and its reservation returns to the
budget.

A spill copies with `.to("cpu")`, which waits for the card, on the current
stream (no second stream). It can run from another task's thread
(`SpillPool.on_alloc_failure` is called by whichever thread's reservation
did not fit); a pinned buffer is never spilled, so a tensor an op is
reading stays on the card. `SpillableBuffer.get` brings a spilled tensor
back through the budget, bit for bit; a restore under pressure can itself
spill others or enter the retry protocol, which the arbiter's detection of
recursive allocations makes safe, as in the reference (`pre_alloc_core`,
SparkResourceAdaptorJni.cpp:1238-1265).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from .admission import array_nbytes
from .pool import MemoryBudget, MemoryEventHandler, Reservation


class SpillableBuffer:
    """One device tensor whose residency is budget-backed and revocable."""

    def __init__(self, pool: "SpillPool", array: torch.Tensor,
                 reservation: Reservation):
        self._pool = pool
        self._device: Optional[torch.Tensor] = array
        self._where = array.device
        self._host: Optional[torch.Tensor] = None
        self._reservation: Optional[Reservation] = reservation
        self.nbytes = array_nbytes(array)
        self._pinned = False
        self._mu = threading.Lock()

    @property
    def spilled(self) -> bool:
        with self._mu:
            return self._device is None

    @property
    def pinned(self) -> bool:
        with self._mu:
            return self._pinned

    def pin(self) -> None:
        """Exclude this buffer from spilling while an op uses it: a batch is
        spillable only while its task is not computing on it
        (RmmSpark.java:402-416)."""
        with self._mu:
            self._pinned = True

    def unpin(self) -> None:
        with self._mu:
            self._pinned = False

    def spill(self) -> int:
        """Copy to host, drop the device copy, free the budget. Returns
        the bytes freed (0 if already spilled or pinned)."""
        with self._mu:
            if self._device is None or self._pinned:
                return 0
            self._host = self._device.to("cpu")     # waits for the card
            self._device = None                     # the allocator reuses it
            r, self._reservation = self._reservation, None
        self._pool.budget.release(r)
        return self.nbytes

    def get(self) -> torch.Tensor:
        """The device tensor; restores it (re-admitting its bytes) if it
        was spilled. Loops: the buffer can be spilled again between the
        restore and the return, and a restore that lost a race re-reads
        under the lock."""
        while True:
            with self._mu:
                if self._device is not None:
                    return self._device
                host = self._host
            # acquire outside our own lock: admission may call back into the
            # pool's on_alloc_failure, which takes other buffers' locks
            r = self._pool.budget.acquire(self.nbytes)
            dev = host.to(self._where)
            with self._mu:
                if self._device is None:
                    self._device = dev
                    self._host = None
                    self._reservation = r
                    return dev
            self._pool.budget.release(r)

    def close(self) -> None:
        with self._mu:
            self._device = None
            self._host = None
            r, self._reservation = self._reservation, None
        if r is not None:
            self._pool.budget.release(r)


def _table_buffers(table) -> List[torch.Tensor]:
    """Every buffer of `table`, column by column: data, validity, offsets,
    then the children's, depth first."""
    out: List[torch.Tensor] = []

    def walk(c):
        for t in (c.data, c.validity, c.offsets):
            if t is not None:
                out.append(t)
        for k in c.children or ():
            walk(k)

    for c in table.columns:
        walk(c)
    return out


def _layout(table):
    """The column layout of `table` without its buffers: names, and per
    column its dtype, length, which buffers it has, and its children's."""
    def col(c):
        return (c.dtype, c.length, c.data is not None, c.validity is not None,
                c.offsets is not None, tuple(col(k) for k in c.children or ()))
    return tuple(table.names), tuple(col(c) for c in table.columns)


def _rebuild_table(layout, leaves: List[torch.Tensor]):
    """The Table of `layout` over `leaves`, in `_table_buffers` order."""
    from ..columnar import Column, Table
    names, cols = layout
    it = iter(leaves)

    def walk(c):
        dtype, length, has_data, has_validity, has_offsets, kids = c
        data = next(it) if has_data else None
        validity = next(it) if has_validity else None
        offsets = next(it) if has_offsets else None
        return Column(dtype, length, data, validity, offsets,
                      tuple(walk(k) for k in kids))

    return Table([walk(c) for c in cols], names=list(names))


class SpillableTable:
    """A Table whose buffers live in a SpillPool: the "make the inputs
    spillable" half of the recovery contract (RmmSpark.java:402-416).

    `protect()` registers every device buffer (first call) and marks them
    spillable; call it on rollback, while the task is not computing on the
    table. `get()` restores any spilled buffers through the budget and pins
    them. Use it as the `on_rollback` of `runtime.retry.with_retry`:

        st = SpillableTable(pool, table)
        out = with_retry(arbiter, lambda t: op(st.get()), table,
                         on_rollback=st.protect, split=...)
        st.close()
    """

    def __init__(self, pool: "SpillPool", table):
        self._pool = pool
        self._table = table
        self._protected = False
        self._closed = False

    def protect(self) -> None:
        """Register the buffers (first call) and make them spillable."""
        if self._closed:
            raise RuntimeError("SpillableTable is closed")
        if not self._protected:
            self._protected = True
            self._layout = _layout(self._table)
            self._slots = []
            seen: Dict[int, SpillableBuffer] = {}   # one buffer per tensor
            for leaf in _table_buffers(self._table):
                buf = seen.get(id(leaf))
                if buf is None:
                    buf = self._pool.register(leaf)
                    seen[id(leaf)] = buf
                self._slots.append(buf)
            self._table = None         # drop the direct references
        for s in self._unique_buffers():
            s.unpin()

    def _unique_buffers(self):
        seen = set()
        for s in self._slots:
            if id(s) not in seen:
                seen.add(id(s))
                yield s

    def get(self):
        """The live Table, pinned for use; restores spilled buffers through
        the budget. Balance with unpin() (or use()) when the op is done."""
        if self._closed:
            raise RuntimeError("SpillableTable is closed")
        if not self._protected:
            return self._table
        leaves = []
        for s in self._slots:
            # pin first: a pinned buffer cannot be spilled, so the tensor
            # get() returns stays on the card
            s.pin()
            leaves.append(s.get())
        return _rebuild_table(self._layout, leaves)

    def unpin(self) -> None:
        """Make the buffers spillable again (the op is done with them)."""
        if self._protected and not self._closed:
            for s in self._unique_buffers():
                s.unpin()

    def use(self):
        """Context manager: the pinned table inside, spillable outside."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            try:
                yield self.get()
            finally:
                self.unpin()
        return cm()

    def close(self) -> None:
        self._closed = True
        if not self._protected:
            self._table = None
            return
        for s in self._unique_buffers():
            self._pool.unregister(s)
        self._slots = []


class SpillPool(MemoryEventHandler):
    """Registry of spillable buffers; spills oldest first on a failed
    reservation."""

    def __init__(self):
        self.budget: Optional[MemoryBudget] = None   # set by attach()
        self._mu = threading.Lock()
        self._buffers: Dict[int, SpillableBuffer] = {}
        self._next_id = 0
        self.spill_count = 0
        self.spilled_bytes = 0

    def attach(self, budget: MemoryBudget) -> "SpillPool":
        self.budget = budget
        budget.event_handler = self
        return self

    def register(self, array: torch.Tensor) -> SpillableBuffer:
        """Admit a device tensor into the pool: its bytes are charged to
        the budget and become revocable."""
        assert self.budget is not None, "attach() a budget first"
        r = self.budget.acquire(array_nbytes(array))
        buf = SpillableBuffer(self, array, r)
        with self._mu:
            buf._id = self._next_id
            self._next_id += 1
            self._buffers[buf._id] = buf
        return buf

    def unregister(self, buf: SpillableBuffer) -> None:
        with self._mu:
            self._buffers.pop(getattr(buf, "_id", -1), None)
        buf.close()

    # -- MemoryEventHandler ---------------------------------------------------
    def on_alloc_failure(self, nbytes: int, retry_count: int) -> bool:
        """Spill buffers oldest first until `nbytes` are freed. True when
        any bytes were freed (retry the reservation at once). Serialized
        under the pool lock, so concurrent failures do not over-spill."""
        freed = 0
        with self._mu:
            candidates = [b for _, b in sorted(self._buffers.items())
                          if not b.spilled and not b.pinned]
            for b in candidates:
                freed += b.spill()
                if freed >= nbytes:
                    break
            if freed > 0:
                self.spill_count += 1
                self.spilled_bytes += freed
        return freed > 0

    def close(self) -> None:
        with self._mu:
            bufs = list(self._buffers.values())
            self._buffers.clear()
        for b in bufs:
            b.close()
