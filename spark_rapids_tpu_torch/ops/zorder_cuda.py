"""The Z-order kernels: their binding and launch counters.

`csrc/zorder.cu` (its header says what it computes and what bounds it on
the card), a plain C interface loaded through ctypes (`cuda_build`, built
at first use). `interleave` is one launch of `zo_interleave` (one thread
an output byte), `hilbert` one of `zo_hilbert` (one thread a row); none
for zero rows. Each passes the columns' data and validity addresses to
the kernel in a small device array (one host-to-device copy a call) and
reads nothing back.

The port's entry points (`zorder.interleave_bits`, `hilbert_index`) call
these on CUDA columns and their plain versions on CPU ones. `LAUNCHES`
counts the kernel launches and `PLAIN_CALLS` the entry points' plain
runs, per op: "interleave", "hilbert".
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..columnar import Column

LAUNCHES = {"interleave": 0, "hilbert": 0}
PLAIN_CALLS = {"interleave": 0, "hilbert": 0}


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
        lib = load("zorder")
        lib.zo_interleave.argtypes = [_P, _I, _I, _N, _P, _P]
        lib.zo_hilbert.argtypes = [_P, _I, _I, _N, _P, _P]
        lib.zo_interleave.restype = lib.zo_hilbert.restype = _I
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"zorder kernel {what}: CUDA error {rc}")


def _column_table(cols: Sequence[Column]):
    """(kept buffers, a (2 * ncols,) int64 device array: every column's
    data address, then every validity address or 0)."""
    dev = cols[0].device
    if dev.type != "cuda" or any(c.device != dev for c in cols):
        raise ValueError(f"the zorder kernels run on CUDA columns of one "
                         f"device, got {[str(c.device) for c in cols]}")
    if any(c.length != cols[0].length for c in cols):
        raise ValueError("the columns must have the same number of rows")
    data = [c.data.contiguous() for c in cols]
    valid = [None if c.validity is None else c.validity.contiguous()
             for c in cols]
    addrs = [d.data_ptr() for d in data] + [
        0 if v is None else v.data_ptr() for v in valid]
    table = torch.tensor(addrs, dtype=torch.int64).to(dev)
    return (data, valid, table), table


def interleave(cols: Sequence[Column], size: int) -> torch.Tensor:
    """(n, ncols * size) uint8: the interleaved bytes of same-typed CUDA
    columns of `size`-byte values. Uses the current stream."""
    n = cols[0].length
    keep, table = _column_table(cols)
    out = torch.empty((n, size * len(cols)), dtype=torch.uint8,
                      device=cols[0].device)
    if n:
        _check(_lib().zo_interleave(
            table.data_ptr(), len(cols), size, n, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream), "interleave")
        LAUNCHES["interleave"] += 1
    del keep
    return out


def hilbert(num_bits: int, cols: Sequence[Column]) -> torch.Tensor:
    """(n,) int64 Hilbert indexes of INT32 CUDA columns (1 <= ncols,
    num_bits * ncols <= 64). Uses the current stream."""
    n = cols[0].length
    keep, table = _column_table(cols)
    out = torch.empty(n, dtype=torch.int64, device=cols[0].device)
    if n:
        _check(_lib().zo_hilbert(
            table.data_ptr(), len(cols), num_bits, n, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream), "hilbert")
        LAUNCHES["hilbert"] += 1
    del keep
    return out
