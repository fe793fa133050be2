"""The Spark row hash: a CUDA kernel and its entry points.

Counterpart of `spark_rapids_tpu/ops/hash_pallas.py` and of the byte path
of `spark_rapids_tpu/ops/hash.py`. The kernel lives in `csrc/row_hash.cu`
(its header says what it computes and what bounds it on the card); this
module binds it through ctypes. Its plain PyTorch version is `hash.py`.

- `murmur_hash3_32_cuda`, `xxhash64_cuda`, `fused_row_hash_cuda`: every
  kind Spark hashes, on CUDA tensors only. The wrapper flattens a STRUCT
  into its leaf fields, each with the struct's validity ANDed into its
  own, and gives a LIST its leaf and each row's leaf span, composed
  through nested lists (torch ops on the card); the kernel takes up to 32
  leaf columns a launch, and a wider table continues from the previous
  launch's hashes, which is exact: the chain is sequential per row;
- `murmur_hash3_32`, `xxhash64`, `fused_row_hash`: the wrappers, the port's
  entry points. On CPU tensors they run the plain version; on CUDA tensors
  they launch the kernel or raise, and never fall back.

`LAUNCHES` counts kernel launches and `PLAIN_CALLS` the plain version's
runs, per form: "murmur", "xxhash" and "fused" (both hashes in one pass).
The errors are the reference's: ValueError on zero columns or unequal
lengths; TypeError on kinds Spark does not hash (TIMESTAMP_S/MS, the
unsigned kinds), on a LIST of STRUCT (murmur3), on nested columns
(xxhash64) and on float columns in `fused_row_hash`.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from . import hash as _hash
from .hash import DEFAULT_XXHASH64_SEED, as_columns

MAX_COLS = 32       # leaf columns one launch takes (csrc/row_hash.cu)

# csrc/row_hash.cu's `Enc`: Spark's byte form of each kind
_ENC = {**{k: 0 for k in _hash.INT4_KINDS},
        Kind.INT64: 1, Kind.TIMESTAMP_US: 1, Kind.DECIMAL32: 1,
        Kind.DECIMAL64: 1, Kind.FLOAT32: 2, Kind.FLOAT64: 3,
        Kind.STRING: 4, Kind.DECIMAL128: 5}

# storage bytes of a value where `DType.itemsize` does not give them
_WIDTH = {Kind.STRING: 1}

LAUNCHES = {"murmur": 0, "xxhash": 0, "fused": 0}
PLAIN_CALLS = {"murmur": 0, "xxhash": 0, "fused": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def supports(table) -> bool:
    """True if murmur3 takes every column: the kinds Spark hashes, at any
    depth, and no LIST of STRUCT."""
    try:
        for c in as_columns(table):
            _hash.check_columns([c], "Murmur3")
            _hash.check_murmur_compat(c)
    except TypeError:
        return False
    return True


def _check_no_floats(cols: Sequence[Column]) -> None:
    if any(c.dtype.kind in _hash.FLOAT_KINDS for c in cols):
        raise TypeError("fused_row_hash: float columns need per-hash zero "
                        "normalization; use the single-hash calls")


# ---- the CUDA kernel ---------------------------------------------------------

_P = ctypes.c_void_p
_LIB = None
# csrc/row_hash.cu `rh_hash`'s per-column arrays, in its argument order:
# the fields every kernel reads (`Cols`), then the byte path's (`ByteCols`)
_FIELDS = (("data", _P), ("valid", _P), ("width", ctypes.c_int),
           ("enc", ctypes.c_int), ("offsets", _P), ("span_start", _P),
           ("span_end", _P), ("elem_valid", _P))


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("row_hash")
        lib.rh_hash.argtypes = [_P] * len(_FIELDS) + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
            ctypes.c_ulonglong, _P, _P, _P, _P, _P]
        lib.rh_hash.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class Leaf:
    """One column the kernel hashes: a non-nested column (a STRUCT's
    field, or a LIST's leaf with each row's span), the row validity with
    every parent's ANDed in, and the tensors the launch reads."""

    def __init__(self, col: Column, valid: Optional[torch.Tensor],
                 span: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.col, self.valid, self.span = col, valid, span

    def tensors(self) -> List[torch.Tensor]:
        ts = [self.col.data, self.col.offsets, self.col.validity,
              self.valid, *(self.span or ())]
        return [t for t in ts if t is not None]

    def desc(self) -> tuple:
        """The leaf's fields, in `_FIELDS` order."""
        c = self.col
        start, end = self.span or (None, None)
        return (_ptr(c.data), _ptr(self.valid),
                _WIDTH.get(c.dtype.kind) or c.dtype.itemsize(),
                _ENC[c.dtype.kind], _ptr(c.offsets), _ptr(start), _ptr(end),
                _ptr(c.validity) if self.span else None)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    # an empty buffer may have no address; the kernel reads none of it
    return None if t is None else t.data_ptr()


def descriptors(chunk: Sequence[Leaf]) -> list:
    """One launch's per-column arrays (`rh_hash`'s first arguments)."""
    fields = list(zip(*[leaf.desc() for leaf in chunk]))
    return [(ty * len(chunk))(*vals)
            for (_, ty), vals in zip(_FIELDS, fields)]


def leaves(cols: Sequence[Column]) -> List[Leaf]:
    """The kernel's leaf columns of `cols`, in hashing order."""
    out = []

    def walk(c: Column, parent: Optional[torch.Tensor]):
        valid = _hash.and_valid(c.validity, parent)
        if c.dtype.kind == Kind.STRUCT:
            for f in c.children:
                walk(f, valid)
        elif c.dtype.kind == Kind.LIST:
            leaf, start, end = _hash.leaf_of_list(c)
            out.append(Leaf(leaf, valid, (start.contiguous(),
                                          end.contiguous())))
        else:
            out.append(Leaf(c, valid))
    for c in cols:
        walk(c, None)
    return out


def _check_cuda(cols: Sequence[Column], what: str,
                xx: bool) -> List[Leaf]:
    _hash.check_columns(cols, what)
    if not xx:
        for c in cols:
            _hash.check_murmur_compat(c)
    elif any(c.dtype.is_nested for c in cols):
        raise TypeError("xxhash64 does not support nested types")
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"the row-hash kernel runs on CUDA tensors, got "
                         f"{dev}")
    out = leaves(cols)
    for leaf in out:
        if any(t.device != dev or not t.is_contiguous()
               for t in leaf.tensors()):
            raise ValueError(f"hashed columns must be contiguous and on "
                             f"{dev}")
    return out


def _run_cuda(cols: Sequence[Column], leaf_cols: Sequence[Leaf],
              mm_seed: Optional[int], xx_seed: Optional[int], form: str
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
    for start in range(0, len(leaf_cols), MAX_COLS):
        chunk = leaf_cols[start:start + MAX_COLS]
        # after the first launch, continue from the hashes written so far
        cont = start > 0
        rc = _lib().rh_hash(*descriptors(chunk), len(chunk), n,
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
    lv = _check_cuda(cols, "Murmur3", xx=False)
    mm, _ = _run_cuda(cols, lv, seed, None, "murmur")
    return Column(dtypes.INT32, cols[0].length, mm)


def xxhash64_cuda(table, seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    cols = as_columns(table)
    lv = _check_cuda(cols, "xxhash64", xx=True)
    _, xx = _run_cuda(cols, lv, None, seed, "xxhash")
    return Column(dtypes.INT64, cols[0].length, xx)


def fused_row_hash_cuda(table, mm_seed: int = 0,
                        xx_seed: int = DEFAULT_XXHASH64_SEED
                        ) -> Tuple[Column, Column]:
    cols = as_columns(table)
    _check_no_floats(cols)
    lv = _check_cuda(cols, "Row", xx=True)
    mm, xx = _run_cuda(cols, lv, mm_seed, xx_seed, "fused")
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
