"""The from_json kernels: their binding and launch counters.

`csrc/map_utils.cu` (its header says what it computes and what bounds it
on the card), one thread a row, a plain C interface loaded through ctypes
(`cuda_build`, built at first use). A call is two launches: `mu_rows`
writes each row's error kind, validity, pair count and key and value byte
counts; the list and char offsets come by `torch.cumsum`; one host read
gives the first row of each error kind, the totals and whether any row is
null; `mu_pairs` writes the pairs (not launched when no row has a pair).

The port's entry point (`map_utils.from_json`) calls `from_json` on CUDA
columns and the plain version on CPU ones. `LAUNCHES` counts the kernel
launches and `PLAIN_CALLS` the entry point's plain runs, under
"from_json".
"""
from __future__ import annotations

import ctypes

import torch

from ..columnar import Column, make_string_column
from .registry import KernelDeclinedError

LAUNCHES = {"from_json": 0}
PLAIN_CALLS = {"from_json": 0}

# csrc/map_utils.cu's MuErr, and their messages (map_utils.py:151-163)
_ERRORS = ((1, "invalid JSON in row {}: {!r}"),
           (2, "malformed JSON object in row {}: {!r}"),
           (3, "JSON object key must be a quoted string (row {}): {!r}"))


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


_P = ctypes.c_void_p
_N = ctypes.c_longlong
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("map_utils")
        lib.mu_rows.argtypes = [_P, _P, _P, _N, _P, _P, _P, _P, _P, _P]
        lib.mu_pairs.argtypes = [_P, _P, _N, _P, _P, _P, _P, _P, _P, _P, _P]
        lib.mu_rows.restype = lib.mu_pairs.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"map_utils kernel {what}: CUDA error {rc}")


def _exclusive(counts: torch.Tensor) -> torch.Tensor:
    """(n + 1,) int64 scan of `counts`, 0 first."""
    out = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                      device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def from_json(col: Column) -> Column:
    """MapUtils.extractRawMapFromJsonString of a STRING column on the card.
    Uses the current stream."""
    from .cast_cuda import string_buffers
    from .cast_string import row_string
    from .map_utils import empty_map
    dev = col.device
    if dev.type != "cuda":
        raise ValueError(f"the from_json kernels run on CUDA columns, got "
                         f"{dev}")
    n = col.length
    if n == 0:
        return empty_map(torch.zeros(1, dtype=torch.int32, device=dev), None,
                         dev)
    offsets, chars, valid = string_buffers(col)
    err = torch.empty(n, dtype=torch.uint8, device=dev)
    valid_out = torch.empty(n, dtype=torch.bool, device=dev)
    pairs, key_bytes, value_bytes = (
        torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    _check(lib.mu_rows(offsets.data_ptr(), chars.data_ptr(),
                       None if valid is None else valid.data_ptr(), n,
                       err.data_ptr(), valid_out.data_ptr(), pairs.data_ptr(),
                       key_bytes.data_ptr(), value_bytes.data_ptr(), stream),
           "rows")
    LAUNCHES["from_json"] += 1
    pair_start = _exclusive(pairs)
    key_start = _exclusive(key_bytes)
    value_start = _exclusive(value_bytes)
    rows = torch.arange(n, device=dev)
    kinds = torch.tensor([k for k, _ in _ERRORS], dtype=torch.uint8,
                         device=dev)
    firsts = torch.where(err[None, :] == kinds[:, None], rows, n).min(1).values
    facts = torch.cat([firsts, torch.stack(
        [pair_start[-1], key_start[-1], value_start[-1],
         (~valid_out).any().to(torch.int64)])]).tolist()   # the host read
    for (_, message), first in zip(_ERRORS, facts[:3]):
        if first < n:
            raise ValueError(message.format(first, row_string(col, first)))
    total, key_total, value_total, any_null = facts[3:]
    validity = valid_out if any_null else None
    list_offsets = pair_start.to(torch.int32)
    if total == 0:
        return empty_map(list_offsets, validity, dev)
    if max(key_total, value_total) > 2**31 - 1:
        raise KernelDeclinedError(f"from_json: {max(key_total, value_total)} "
                                  "chars overflow int32 offsets")
    key_offsets, value_offsets = (
        torch.zeros(total + 1, dtype=torch.int32, device=dev)
        for _ in range(2))
    key_chars = torch.empty(key_total, dtype=torch.uint8, device=dev)
    value_chars = torch.empty(value_total, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, dtype=torch.uint8, device=dev)   # a non-null pointer
    _check(lib.mu_pairs(offsets.data_ptr(), chars.data_ptr(), n,
                        pair_start.data_ptr(), key_start.data_ptr(),
                        value_start.data_ptr(), key_offsets.data_ptr(),
                        value_offsets.data_ptr(),
                        (key_chars if key_total else one).data_ptr(),
                        (value_chars if value_total else one).data_ptr(),
                        stream), "pairs")
    LAUNCHES["from_json"] += 1
    struct = Column.make_struct(
        key=make_string_column(key_chars, key_offsets),
        value=make_string_column(value_chars, value_offsets))
    return Column.make_list(list_offsets, struct, validity)
