"""The fused Spark row hash: a CUDA kernel and its entry points.

Counterpart of `spark_rapids_tpu/ops/hash_pallas.py`. The kernel lives in
`csrc/row_hash.cu` (its header says what it computes and what bounds it on
the card); this module binds it through ctypes. Its plain PyTorch version
is `hash.py`.

- `murmur_hash3_32_cuda`, `xxhash64_cuda`, `fused_row_hash_cuda`: one
  kernel launch per 32 columns (a wider table continues from the previous
  launch's hashes, which is exact: the chain is sequential per row), on
  CUDA tensors only;
- `murmur_hash3_32`, `xxhash64`, `fused_row_hash`: the wrappers, the port's
  entry points. On CPU tensors they run the plain version; on CUDA tensors
  they launch the kernel or raise, and never fall back.

`LAUNCHES` counts kernel launches and `PLAIN_CALLS` the plain version's
runs, per form: "murmur", "xxhash" and "fused" (both hashes in one pass).
The errors are the reference's: ValueError on zero columns or unequal
lengths, TypeError on kinds the kernel does not take (`supports`) and on
float columns in `fused_row_hash`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from . import hash as _hash
from .hash import DEFAULT_XXHASH64_SEED, as_columns

MAX_COLS = 32       # columns one launch takes (csrc/row_hash.cu)

# csrc/row_hash.cu's `Enc`: Spark's byte form of each kind
_ENC = {**{k: 0 for k in _hash.INT4_KINDS},
        Kind.INT64: 1, Kind.TIMESTAMP_US: 1, Kind.DECIMAL32: 1,
        Kind.DECIMAL64: 1, Kind.FLOAT32: 2, Kind.FLOAT64: 3}

LAUNCHES = {"murmur": 0, "xxhash": 0, "fused": 0}
PLAIN_CALLS = {"murmur": 0, "xxhash": 0, "fused": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def supports(table) -> bool:
    """True if every column is a fixed-width kind the kernel hashes."""
    return all(c.dtype.kind in _ENC for c in as_columns(table))


def _check_no_floats(cols: Sequence[Column]) -> None:
    if any(c.dtype.kind in _hash.FLOAT_KINDS for c in cols):
        raise TypeError("fused_row_hash: float columns need per-hash zero "
                        "normalization; use the single-hash calls")


# ---- the CUDA kernel ---------------------------------------------------------

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("row_hash")
        lib.rh_hash.argtypes = [_PP, _PP, _PI, _PI, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_uint,
                                ctypes.c_ulonglong, _P, _P, _P, _P, _P]
        lib.rh_hash.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda(cols: Sequence[Column], what: str) -> torch.device:
    _hash.check_columns(cols, what)
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"the row-hash kernel runs on CUDA tensors, got "
                         f"{dev}")
    for c in cols:
        if c.dtype.kind not in _ENC:
            raise TypeError(f"the row-hash kernel does not take "
                            f"{c.dtype!r} columns")
        if c.device != dev or not c.data.is_contiguous() or (
                c.validity is not None and not c.validity.is_contiguous()):
            raise ValueError(f"hashed columns must be contiguous and on "
                             f"{dev}")
    return dev


def _run_cuda(cols: Sequence[Column], mm_seed: Optional[int],
              xx_seed: Optional[int], form: str
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    dev = cols[0].device
    n = cols[0].length
    mm = (torch.empty(n, dtype=torch.int32, device=dev)
          if mm_seed is not None else None)
    xx = (torch.empty(n, dtype=torch.int64, device=dev)
          if xx_seed is not None else None)
    if n == 0:
        return mm, xx
    stream = torch.cuda.current_stream(dev).cuda_stream
    mm_ptr = None if mm is None else mm.data_ptr()
    xx_ptr = None if xx is None else xx.data_ptr()
    for start in range(0, len(cols), MAX_COLS):
        chunk = cols[start:start + MAX_COLS]
        nc = len(chunk)
        data = (ctypes.c_void_p * nc)(*[c.data.data_ptr() for c in chunk])
        valid = (ctypes.c_void_p * nc)(*[
            None if c.validity is None else c.validity.data_ptr()
            for c in chunk])
        width = (ctypes.c_int * nc)(*[c.data.element_size() for c in chunk])
        enc = (ctypes.c_int * nc)(*[_ENC[c.dtype.kind] for c in chunk])
        # after the first launch, continue from the hashes written so far
        cont = start > 0
        rc = _lib().rh_hash(data, valid, width, enc, nc, n,
                            (mm_seed or 0) & 0xFFFFFFFF,
                            (xx_seed or 0) & (2 ** 64 - 1),
                            mm_ptr if cont else None,
                            xx_ptr if cont else None, mm_ptr, xx_ptr, stream)
        if rc != 0:
            raise RuntimeError(f"row-hash kernel: CUDA error {rc}")
        LAUNCHES[form] += 1
    return mm, xx


def murmur_hash3_32_cuda(table, seed: int = 0) -> Column:
    cols = as_columns(table)
    _check_cuda(cols, "Murmur3")
    mm, _ = _run_cuda(cols, seed, None, "murmur")
    return Column(dtypes.INT32, cols[0].length, mm)


def xxhash64_cuda(table, seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    cols = as_columns(table)
    _check_cuda(cols, "xxhash64")
    _, xx = _run_cuda(cols, None, seed, "xxhash")
    return Column(dtypes.INT64, cols[0].length, xx)


def fused_row_hash_cuda(table, mm_seed: int = 0,
                        xx_seed: int = DEFAULT_XXHASH64_SEED
                        ) -> Tuple[Column, Column]:
    cols = as_columns(table)
    _check_no_floats(cols)
    _check_cuda(cols, "Row")
    mm, xx = _run_cuda(cols, mm_seed, xx_seed, "fused")
    n = cols[0].length
    return Column(dtypes.INT32, n, mm), Column(dtypes.INT64, n, xx)


# ---- wrappers: plain version on CPU tensors, the kernel on CUDA ones --------

def _on_cpu(cols: Sequence[Column]) -> bool:
    return bool(cols) and cols[0].device.type == "cpu"


def murmur_hash3_32(table, seed: int = 0) -> Column:
    """Spark murmur3_32 of each row (Hash.java:40-58 parity)."""
    cols = as_columns(table)
    if _on_cpu(cols):
        PLAIN_CALLS["murmur"] += 1
        return _hash.murmur_hash3_32(cols, seed)
    return murmur_hash3_32_cuda(cols, seed)


def xxhash64(table, seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    """Spark xxhash64 of each row, seed 42 default (Hash.java:60-86)."""
    cols = as_columns(table)
    if _on_cpu(cols):
        PLAIN_CALLS["xxhash"] += 1
        return _hash.xxhash64(cols, seed)
    return xxhash64_cuda(cols, seed)


def fused_row_hash(table, mm_seed: int = 0,
                   xx_seed: int = DEFAULT_XXHASH64_SEED
                   ) -> Tuple[Column, Column]:
    """Both Spark row hashes in one pass over the table. Integer-family
    columns only: float columns need different zero normalization per hash
    (hash.cuh:33-52), so they go to the single-hash calls."""
    cols = as_columns(table)
    _check_no_floats(cols)
    if _on_cpu(cols):
        PLAIN_CALLS["fused"] += 1
        return (_hash.murmur_hash3_32(cols, mm_seed),
                _hash.xxhash64(cols, xx_seed))
    return fused_row_hash_cuda(cols, mm_seed, xx_seed)
