"""Tracing ranges: named spans in the profiler's timeline.

Counterpart of `spark_rapids_tpu/utils/tracing.py`. The reference
brackets native ops with NVTX ranges behind a flag and, on the TPU, with
`jax.profiler.TraceAnnotation`; the port opens
`torch.profiler.record_function` ranges, which land in the same Kineto
trace as the card's kernel records, with each kernel linked to the range
whose host span launched it.

- `range_ctx(name)` / `func_range`: a range, only when
  SPARK_RAPIDS_TORCH_TRACE=1 (`config.trace_enabled`); with the flag off
  nothing is opened.
- `start_trace(log_dir)` / `stop_trace()` / `trace(log_dir)`: capture a
  `torch.profiler.profile` of the CPU and, where there is one, the CUDA
  card, and write it to `log_dir` as a Chrome trace (`trace.json`).

The plan executor opens `plan.<label>` around every eager operator and
`plan.capped.attempt` around each capped attempt (a graph replay
included).
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Optional, TypeVar

F = TypeVar("F", bound=Callable)

ENV_FLAG = "SPARK_RAPIDS_TORCH_TRACE"


def enabled() -> bool:
    from ..config import trace_enabled
    return trace_enabled()


@contextlib.contextmanager
def range_ctx(name: str):
    """A named range in the profiler's timeline, when tracing is on."""
    if not enabled():
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield


def func_range(fn: F) -> F:
    """Decorator form: the call runs inside a range named after the
    function, when tracing is on."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not enabled():
            return fn(*args, **kwargs)
        import torch
        with torch.profiler.record_function(fn.__qualname__):
            return fn(*args, **kwargs)
    return wrapper  # type: ignore[return-value]


_active: Optional[tuple] = None       # (profiler, log_dir) of start_trace


def start_trace(log_dir: str):
    """Begin capturing a trace of the CPU and the CUDA card (when one is
    present). Returns the profiler; `stop_trace` writes it."""
    global _active
    import torch
    if _active is not None:
        raise RuntimeError("a trace is already being captured")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _active = (prof, log_dir)
    return prof


def stop_trace() -> str:
    """End the capture and write `<log_dir>/trace.json` (a Chrome trace);
    returns its path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is being captured")
    prof, log_dir = _active
    _active = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace around a block; yields the profiler."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace()
