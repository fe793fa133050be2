"""The calendar rebase kernel: its binding and launch counters.

`csrc/datetime_rebase.cu` (its header says what it computes and what
bounds it on the card), one thread a row, a plain C interface loaded
through ctypes (`cuda_build`, built at first use). A call is one launch
of `dr_rebase`, none for an empty column; it reads nothing back.

The port's entry points (`datetime_rebase.rebase_*`) call `rebase` on
CUDA columns and their plain version on CPU ones. `LAUNCHES` counts the
kernel launches and `PLAIN_CALLS` the entry points' plain runs, per
direction: "to_julian", "to_gregorian".
"""
from __future__ import annotations

import ctypes

import torch

from ..columnar import Column
from ..dtypes import Kind

LAUNCHES = {"to_julian": 0, "to_gregorian": 0}
PLAIN_CALLS = {"to_julian": 0, "to_gregorian": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("datetime_rebase")
        lib.dr_rebase.argtypes = [_I, _I, _P, _N, _P, _P]
        lib.dr_rebase.restype = _I
        _LIB = lib
    return _LIB


def rebase(col: Column, to_julian: bool) -> torch.Tensor:
    """The rebased data buffer of a DATE32 or TIMESTAMP_US column on the
    card (every row, null rows too). Uses the current stream."""
    if col.device.type != "cuda":
        raise ValueError(f"the rebase kernel runs on CUDA columns, got "
                         f"{col.device}")
    micros = col.dtype.kind == Kind.TIMESTAMP_US
    data = col.data.contiguous()
    out = torch.empty_like(data)
    if col.length:
        rc = _lib().dr_rebase(int(micros), int(to_julian), data.data_ptr(),
                              col.length, out.data_ptr(),
                              torch.cuda.current_stream(col.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"datetime_rebase kernel: CUDA error {rc}")
        LAUNCHES["to_julian" if to_julian else "to_gregorian"] += 1
    return out
