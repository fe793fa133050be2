"""The URI parse kernel: its binding and launch counters.

`csrc/parse_uri.cu` (its header says what it computes and what bounds it
on the card), one thread a row, a plain C interface loaded through ctypes
(`cuda_build`, built at first use). A call is two launches: `pu_spans`
writes each row's span and validity, the offsets come by `torch.cumsum`,
one host read gives the char total (and the longest span, which
`out_pad_to` bounds, and the longest input and parameter strings where
`pad_to` and `param_pad_to` bound them), and `pu_copy` writes the chars; one launch when
every span is empty, none for an empty column.

The port's entry points (`parse_uri.parse_uri_to_*`) call `parse` on CUDA
columns and their plain versions on CPU ones. `LAUNCHES` counts the kernel
launches and `PLAIN_CALLS` the entry points' plain runs, per op:
"protocol", "host", "query", "query_literal", "query_column".
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..columnar import Column, make_string_column
from .registry import KernelDeclinedError

OPS = ("protocol", "host", "query", "query_literal", "query_column")
LAUNCHES = {op: 0 for op in OPS}
PLAIN_CALLS = {op: 0 for op in OPS}

# csrc/parse_uri.cu's PuOp
_OP_CODE = {"protocol": 0, "host": 1, "query": 2, "query_literal": 3,
            "query_column": 3}


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
        lib = load("parse_uri")
        lib.pu_spans.argtypes = [_I, _P, _P, _P, _N, _P, _P, _P, _I, _I, _P,
                                 _P, _P, _P]
        lib.pu_copy.argtypes = [_P, _P, _P, _N, _P, _P]
        lib.pu_spans.restype = lib.pu_copy.restype = _I
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"parse_uri kernel {what}: CUDA error {rc}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def parse(col: Column, op: str, literal: Optional[str] = None,
          params: Optional[Column] = None, pad_to: Optional[int] = None,
          out_pad_to: Optional[int] = None,
          param_pad_to: Optional[int] = None) -> Column:
    """One component of every row of a STRING column on the card: `op` is
    one of OPS; "query_literal" takes `literal`, "query_column" the
    parameter column `params` (same rows). `pad_to`, `param_pad_to` and
    `out_pad_to` bound the longest input, parameter and output string as
    in the plain version (ValueError). Uses the current stream."""
    from .cast_cuda import string_buffers
    from .cast_string import check_pad_to
    from .parse_uri import check_out_pad
    dev = col.device
    if dev.type != "cuda":
        raise ValueError(f"the parse_uri kernel runs on CUDA columns, got "
                         f"{dev}")
    n = col.length
    if n == 0:
        return make_string_column(
            torch.empty(0, dtype=torch.uint8, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev))
    offsets, chars, valid = string_buffers(col)
    p_off = p_valid = None
    p_len, nonempty = 0, 0
    if op == "query_column":
        if params.device != dev or params.length != n:
            raise ValueError("params must be a string column of the same "
                             "rows on the same device")
        p_off, p_chars, p_valid = string_buffers(params)
    elif op == "query_literal":
        raw = literal.encode()
        p_chars = torch.tensor(list(raw) or [0], dtype=torch.uint8,
                               device=dev)
        p_len, nonempty = len(raw), 1
    else:
        p_chars = None
    start = torch.empty(n, dtype=torch.int32, device=dev)
    length = torch.empty(n, dtype=torch.int32, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_lib().pu_spans(_OP_CODE[op], offsets.data_ptr(), chars.data_ptr(),
                           _ptr(valid), n, _ptr(p_off), _ptr(p_chars),
                           _ptr(p_valid), p_len, nonempty, start.data_ptr(),
                           length.data_ptr(), out_valid.data_ptr(), stream),
           "spans")
    LAUNCHES[op] += 1
    # a null row's span is empty, its length kept for `out_pad_to`'s check,
    # as the JAX package takes it
    lens = length if valid is None else torch.where(valid, length, 0)
    out_offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=out_offsets[1:])
    # the widths the plain version pads to, read with the total: the
    # parameters' first, then the input's, as it checks them
    bounded = [(c, w) for c, w in ((params, param_pad_to), (col, pad_to))
               if w is not None and c is not None]
    reads = [out_offsets[-1], length.max().to(torch.int64)] + [
        c.string_lengths().max().to(torch.int64) for c, _ in bounded]
    total, longest, *widest = torch.stack(reads).tolist()
    for (_, width), most in zip(bounded, widest):
        check_pad_to(most, width)
    check_out_pad(longest, out_pad_to)
    if total > 2**31 - 1:
        raise KernelDeclinedError(f"parse_uri: {total} chars overflow int32 "
                                  "offsets")
    out_offsets = out_offsets.to(torch.int32)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        _check(_lib().pu_copy(chars.data_ptr(), start.data_ptr(),
                              out_offsets.data_ptr(), n, out.data_ptr(),
                              stream), "copy")
        LAUNCHES[op] += 1
    return make_string_column(out, out_offsets, out_valid)
