"""The time-zone conversion kernel: its binding and launch counters.

`csrc/timezones.cu` (its header says what it computes and what bounds it
on the card), one thread a row over the zone's transition table in shared
memory, a plain C interface loaded through ctypes (`cuda_build`, built at
first use). A call is one launch of `tz_convert`, none for an empty
column; it reads nothing back.

The port's entry points (`timezones.from_*`) call `convert` on CUDA
columns and their plain version on CPU ones. `LAUNCHES` counts the kernel
launches and `PLAIN_CALLS` the entry points' plain runs, per direction:
"to_utc", "from_utc".
"""
from __future__ import annotations

import ctypes

import torch

from ..columnar import Column

LAUNCHES = {"to_utc": 0, "from_utc": 0}
PLAIN_CALLS = {"to_utc": 0, "from_utc": 0}


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
        lib = load("timezones")
        lib.tz_convert.argtypes = [_P, _N, _P, _P, _I, _I, _I, _P, _P]
        lib.tz_convert.restype = _I
        _LIB = lib
    return _LIB


def convert(col: Column, keys: torch.Tensor, offsets: torch.Tensor,
            to_utc: bool, scale: int) -> torch.Tensor:
    """The converted (n,) int64 timestamps of a timestamp column on the
    card: `keys` the zone's (k,) int64 search keys in seconds (its UTC or
    local instants), `offsets` its (k,) int32 offsets, `scale` the unit's
    ticks a second (1, 1,000 or 1,000,000). Uses the current stream."""
    dev = col.device
    if dev.type != "cuda" or keys.device != dev or offsets.device != dev:
        raise ValueError(f"the time-zone kernel runs on a CUDA column and "
                         f"table, got {dev} and {keys.device}")
    data = col.data.contiguous()
    out = torch.empty_like(data)
    if col.length:
        rc = _lib().tz_convert(data.data_ptr(), col.length,
                               keys.contiguous().data_ptr(),
                               offsets.contiguous().data_ptr(),
                               keys.numel(), int(to_utc), scale,
                               out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"timezones kernel: CUDA error {rc}")
        LAUNCHES["to_utc" if to_utc else "from_utc"] += 1
    return out
