"""The caller-side retry contract.

Counterpart of `spark_rapids_tpu/runtime/retry.py`. The reference documents
the recovery protocol (RmmSpark.java:402-416): catch RetryOOM, make the
inputs spillable, block until ready, retry; catch SplitAndRetryOOM, split
the input and process the halves. `with_retry` packages that protocol.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, TypeVar

from .adaptor import (ResourceArbiter, RetryOOM, CpuRetryOOM,
                      SplitAndRetryOOM, CpuSplitAndRetryOOM)

T = TypeVar("T")
A = TypeVar("A")


def with_retry(arbiter: ResourceArbiter,
               attempt: Callable[[A], T],
               batch: A,
               split: Optional[Callable[[A], Sequence[A]]] = None,
               on_rollback: Optional[Callable[[], None]] = None) -> List[T]:
    """Run `attempt(batch)`, honoring the arbiter's retry/split protocol.

    Returns the list of results — one element normally, more if the input was
    split. `split` must return the pieces of its argument; when absent, a
    SplitAndRetryOOM is re-raised (nothing left to give back).
    `on_rollback` runs after a RetryOOM so callers can make state spillable.

    The work queue is a deque: split pieces push back onto the head with
    O(1) extendleft, so a deep split cascade (every piece splitting again)
    stays O(n) total instead of the O(n²) a list-head `work[0:1] = pieces`
    rewrite costs.
    """
    work: Deque[A] = deque([batch])
    out: List[T] = []

    def do_split(item: A) -> None:
        if split is None:
            raise
        pieces = list(split(item))
        if len(pieces) <= 1:
            raise
        work.popleft()
        work.extendleft(reversed(pieces))   # head-first, original order

    arbiter.start_retry_block()
    try:
        while work:
            item = work[0]
            try:
                out.append(attempt(item))
                work.popleft()
            except (RetryOOM, CpuRetryOOM):
                if on_rollback is not None:
                    on_rollback()
                # block-until-ready can itself answer with a split escalation
                # (BUFN_WAIT -> BUFN -> everyone wedged -> SPLIT_THROW)
                try:
                    arbiter.block_thread_until_ready()
                except (SplitAndRetryOOM, CpuSplitAndRetryOOM):
                    do_split(item)
            except (SplitAndRetryOOM, CpuSplitAndRetryOOM):
                do_split(item)
        return out
    finally:
        arbiter.end_retry_block()
