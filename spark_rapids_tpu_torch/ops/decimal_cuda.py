"""The DECIMAL128 arithmetic kernel: its binding and launch counters.

The kernel lives in `csrc/decimal128.cu` (its header says what it computes
and what bounds it on the card); this module binds it through ctypes. The
port's entry points are `decimal_utils.add_decimal128` and the rest: on
CUDA tensors they call `launch`, on CPU tensors the plain version
(`decimal_utils.*_plain` over `decimal256`).

`LAUNCHES` counts kernel launches and `PLAIN_CALLS` the entry points'
plain runs, per op: "add", "sub", "multiply", "divide" (the integer divide
too) and "remainder".
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..columnar import Column

# csrc/decimal128.cu's `Op`, one kernel a family
_OPS = {"add": 0, "sub": 0, "multiply": 1, "divide": 2, "remainder": 3}

LAUNCHES = {op: 0 for op in _OPS}
PLAIN_CALLS = {op: 0 for op in _OPS}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("decimal128")
        lib.dec_op.argtypes = [_I, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                               _P, _P, _P]
        lib.dec_op.restype = _I
        _LIB = lib
    return _LIB


def _operand(c: Column, dev: torch.device) -> torch.Tensor:
    """The column's limbs as the kernel reads them: contiguous (n, 4) on
    `dev`, 16-byte aligned (one 16-byte load a row)."""
    if c.device != dev:
        raise ValueError(f"decimal columns on {c.device} and {dev}")
    d = c.data.contiguous()
    if d.data_ptr() % 16:
        raise ValueError("the decimal kernel reads 16-byte aligned limbs")
    return d


def launch(op: str, a: Column, b: Column, out_scale: int, flag: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the decimal kernel over every row of two DECIMAL128
    columns on the card -> (overflow (n,) bool, result (n, 4) uint32 limbs,
    or for the integer divide (n,) int64). `flag` is the op's switch:
    subtract, the interim cast, the integer divide. Uses the current
    stream; allocates through torch; reads nothing back."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"the decimal kernel runs on CUDA tensors, got "
                         f"{dev}")
    int64_out = op == "divide" and flag
    x, y = _operand(a, dev), _operand(b, dev)
    n = a.length
    overflow = torch.empty(n, dtype=torch.bool, device=dev)
    out = (torch.empty(n, dtype=torch.int64, device=dev) if int64_out
           else torch.empty((n, 4), dtype=torch.uint32, device=dev))
    if n == 0:
        return overflow, out
    rc = _lib().dec_op(_OPS[op], x.data_ptr(), y.data_ptr(), n,
                       a.dtype.scale, b.dtype.scale, out_scale, int(flag),
                       out.data_ptr(), overflow.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decimal kernel ({op}): CUDA error {rc}")
    LAUNCHES[op] += 1
    return overflow, out
