"""FusedSelect on the card: the CUDA kernels of `csrc/fused_select.cu` and
the wrapper.

Counterpart of `fused_select_compact` in
`spark_rapids_tpu/ops/select_pallas.py`. `fused_select(table, predicate,
needed)` gives the compacted `needed` columns of the rows where
`predicate` holds, in row order, validity included, equal to
`select.fused_select_plain`:

- `select.cached_program` gives the kernel's postfix program with its
  argument struct (compiled once per predicate structure, literals and
  column dtypes), so a call writes only the columns' pointers;
- `fs_count` evaluates the predicate into a bitmask and per-block counts,
  and its last block scans the counts into block offsets and the total;
  the host reads the total (the one sync) and launches nothing else
  before `fs_compact`, which writes each needed column at its width, with
  validity: a DECIMAL128 row as 16 bytes; for STRING columns the kept
  rows' indices, once, through which the wrapper gathers them (`take`).

The wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches the kernels or raises, it never falls back. `LAUNCHES` counts
kernel launches, `STRING_LAUNCHES` the compact launches that wrote the
kept rows' indices, and `PLAIN_CALLS` (`select.PLAIN_CALLS`) the plain
version's runs, wherever it is called from. Registered as
`fused_select`/"cuda" for backend "cuda", beside the plain fallback
"torch".
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import dtypes
from ..columnar import Column, Table
from .gather import take
from .select import (DATA_KINDS, PLAIN_CALLS, PredArgs, Program,
                     cached_program, fused_select_plain, make_signature,
                     needed_columns, scalar_values, supports)

__all__ = ["fused_select", "fused_select_cuda", "make_signature",
           "needed_columns", "LAUNCHES", "STRING_LAUNCHES", "PLAIN_CALLS",
           "reset_counters"]

LAUNCHES = {"count": 0, "compact": 0}
# the compact launches that wrote the kept rows' indices (STRING payloads)
STRING_LAUNCHES = {"compact": 0}

TILE = 2048        # rows per block (csrc/fused_select.cu FS_TILE)
MAX_OUT = 32       # columns one compact launch writes (FS_MAX_OUT)


def reset_counters() -> None:
    for d in (LAUNCHES, STRING_LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---- the CUDA kernels -------------------------------------------------------

class _Out(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p * MAX_OUT),
                ("src_valid", ctypes.c_void_p * MAX_OUT),
                ("dst", ctypes.c_void_p * MAX_OUT),
                ("dst_valid", ctypes.c_void_p * MAX_OUT),
                ("width", ctypes.c_int * MAX_OUT),
                ("ncols", ctypes.c_int)]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("fused_select")
        lib.fs_count.argtypes = [ctypes.POINTER(PredArgs), ctypes.c_longlong,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p]
        lib.fs_compact.argtypes = [ctypes.POINTER(_Out), ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
        lib.fs_count.restype = lib.fs_compact.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _pred_args(prog: Program, table: Table, scalars) -> PredArgs:
    """A fresh copy of `prog`'s argument struct with this call's column
    pointers, a scalar aggregate's pointing at its 0-d value."""
    p = PredArgs.from_buffer_copy(prog.args)
    for i, name in enumerate(prog.columns):
        if isinstance(name, tuple):
            p.data[i] = scalars[name[1]].data_ptr()
            continue
        c = table[name]
        _check(c, table.device, "predicate")
        p.data[i] = c.data.data_ptr()
    return p


def _check(c: Column, dev: torch.device, what: str) -> None:
    if c.device != dev or not c.data.is_contiguous() or (
            c.validity is not None and not c.validity.is_contiguous()):
        raise ValueError(f"fused_select: {what} column must be contiguous "
                         f"and on {dev}")


def fused_select_cuda(table: Table, predicate, needed: Sequence[str]
                      ) -> Table:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the fused_select kernels run on CUDA tensors, "
                         f"got {dev}")
    needed = list(needed)
    cols = [table[c] for c in needed]
    for c in cols:
        if c.dtype.kind.value not in DATA_KINDS:
            raise TypeError(f"the fused_select kernels do not carry "
                            f"{c.dtype!r} columns")
        _check(c, dev, "needed")
    prog = cached_program(predicate, table)
    # scalar subqueries reduce over the whole table first, on the card, as
    # Expr.evaluate reduces them (kept alive past the launch's sync)
    scalars = (scalar_values(prog, predicate, table)
               if any(isinstance(c, tuple) for c in prog.columns) else [])
    n = table.num_rows

    def empty() -> Table:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return Table([take(c, e, _has_negative=False) for c in cols],
                     names=needed)

    if n == 0:
        return empty()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _pred_args(prog, table, scalars)
    blocks = (n + TILE - 1) // TILE
    # one scratch buffer of int64: the total, the call's ticket (fs_count
    # zeroes it), the block offsets, the block counts (int32) and the mask
    # words (int32, TILE / 32 a block)
    scratch = torch.empty(2 + blocks + (blocks + 1) // 2 + blocks * TILE // 64,
                          dtype=torch.int64, device=dev)
    total_p = scratch.data_ptr()
    ticket_p = total_p + 8
    starts_p = ticket_p + 8
    counts_p = starts_p + 8 * blocks
    mask_p = counts_p + 8 * ((blocks + 1) // 2)
    rc = lib.fs_count(ctypes.byref(p), n, mask_p, counts_p, starts_p,
                      total_p, ticket_p, stream)
    if rc != 0:
        raise RuntimeError(f"fused_select count kernel: CUDA error {rc}")
    LAUNCHES["count"] += 1
    total = int(scratch[0])                   # the one host sync
    if total == 0:
        return empty()
    # (source, output) per written column; a STRING column's is the kept
    # rows' indices (one for all), through which it is gathered below
    out_cols, writes, idx = [], [], None
    for c in cols:
        if c.dtype.is_string:
            if idx is None:
                idx = torch.empty(total, dtype=torch.int64, device=dev)
                writes.append((None, Column(dtypes.INT64, total, idx)))
            out_cols.append(None)
            continue
        v = (None if c.validity is None else
             torch.empty(total, dtype=torch.bool, device=dev))
        oc = Column(c.dtype, total,
                    torch.empty((total,) + tuple(c.data.shape[1:]),
                                dtype=c.data.dtype, device=dev), v)
        out_cols.append(oc)
        writes.append((c, oc))
    for lo in range(0, len(writes), MAX_OUT):
        o = _Out()
        chunk = writes[lo:lo + MAX_OUT]
        for i, (c, oc) in enumerate(chunk):
            o.dst[i] = oc.data.data_ptr()
            if c is None:                   # the kept rows' indices
                o.width[i] = 0
                continue
            o.src[i] = c.data.data_ptr()
            o.src_valid[i] = (None if c.validity is None
                              else c.validity.data_ptr())
            o.dst_valid[i] = (None if oc.validity is None
                              else oc.validity.data_ptr())
            o.width[i] = c.data.element_size() * (
                c.data.shape[1] if c.data.dim() > 1 else 1)
        o.ncols = len(chunk)
        rc = lib.fs_compact(ctypes.byref(o), n, mask_p, starts_p, stream)
        if rc != 0:
            raise RuntimeError(f"fused_select compact kernel: CUDA error "
                               f"{rc}")
        LAUNCHES["compact"] += 1
        STRING_LAUNCHES["compact"] += any(c is None for c, _ in chunk)
    out_cols = [take(c, idx, _has_negative=False) if oc is None else oc
                for c, oc in zip(cols, out_cols)]
    return Table(out_cols, names=needed)


def fused_select(table: Table, predicate, needed: Sequence[str]) -> Table:
    """The compacted `needed` columns of the rows where `predicate` holds:
    the kernels on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cpu":
        return fused_select_plain(table, predicate, needed)
    return fused_select_cuda(table, predicate, needed)


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("fused_select", "torch", fallback=True)
_REGISTRY.register("fused_select", "cuda", fn=fused_select,
                   backends=("cuda",), supports=supports)
