"""Host-side runtime: task and memory arbitration for a shared card.

Counterpart of `spark_rapids_tpu/runtime/`, with the same exported names:
the native state machine (`native/resource_adaptor.cpp`, the port's copy,
built with g++ at first use) and its Python facade, memory budgets,
admission at op dispatch, the retry contract, spill, and the health
monitor with its circuit breaker. The reference's largest single component
(SURVEY.md §2.2): it lets many concurrent tasks share one card without
deadlocking.
"""
from .adaptor import (ResourceArbiter, OomInjectionType, current_thread_id,
                      ArbiterOOM, RetryOOM, SplitAndRetryOOM, CpuRetryOOM,
                      CpuSplitAndRetryOOM, HardOOM, InjectedException,
                      ThreadRemovedError,
                      STATE_UNKNOWN, STATE_RUNNING, STATE_ALLOC,
                      STATE_ALLOC_FREE, STATE_BLOCKED, STATE_BUFN_THROW,
                      STATE_BUFN_WAIT, STATE_BUFN, STATE_SPLIT_THROW,
                      STATE_REMOVE_THROW, STATE_NAMES)
from .pool import (DeviceSession, MemoryBudget, MemoryEventHandler,
                   Reservation)
from .retry import with_retry
from .health import (DeviceHealthMonitor, CircuitBreaker, device_probe,
                     CLOSED, OPEN, HALF_OPEN, TRANSIENT, STICKY, FATAL)
from .admission import (set_active_session, get_active_session,
                        active_session, admitted_op, operand_nbytes)
from .spill import SpillPool, SpillableBuffer, SpillableTable

__all__ = [
    "set_active_session", "get_active_session", "active_session",
    "admitted_op", "operand_nbytes", "SpillPool", "SpillableBuffer",
    "SpillableTable",
    "ResourceArbiter", "OomInjectionType", "current_thread_id",
    "ArbiterOOM", "RetryOOM", "SplitAndRetryOOM", "CpuRetryOOM",
    "CpuSplitAndRetryOOM", "HardOOM", "InjectedException", "ThreadRemovedError",
    "MemoryBudget", "MemoryEventHandler", "DeviceSession", "Reservation",
    "with_retry",
    "DeviceHealthMonitor", "CircuitBreaker", "device_probe",
    "CLOSED", "OPEN", "HALF_OPEN", "TRANSIENT", "STICKY", "FATAL",
    "STATE_UNKNOWN", "STATE_RUNNING", "STATE_ALLOC", "STATE_ALLOC_FREE",
    "STATE_BLOCKED", "STATE_BUFN_THROW", "STATE_BUFN_WAIT", "STATE_BUFN",
    "STATE_SPLIT_THROW", "STATE_REMOVE_THROW", "STATE_NAMES",
]
