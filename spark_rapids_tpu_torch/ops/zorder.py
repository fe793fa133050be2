"""Delta Lake's Z-order helpers: InterleaveBits and the Hilbert index
(`ZOrder`).

Counterpart of `spark_rapids_tpu/ops/zorder.py` (the reference's
zorder.cu), with its semantics:

- `interleave_bits`: columns of one fixed-width type; nulls read 0, floats
  by their bits; each value MSB first, column 0 the most significant; the
  bit stream c0[msb], c1[msb], ..., c0[msb-1], ... packed MSB first into
  `ncols * itemsize` bytes a row, a LIST<UINT8> column;
- `hilbert_index`: INT32 columns only, 0 < num_bits <= 32 and
  num_bits * ncols <= 64; nulls read 0; each coordinate masked to
  num_bits; Skilling's transform, then the bits interleaved, dimension 0
  most significant, into an INT64.

On CUDA columns the Z-order kernels run (`zorder_cuda`, csrc/zorder.cu:
one thread an output byte for the interleave, one a row for the Hilbert
index) or the call raises; on CPU columns the plain versions run. The
plain Hilbert index does the JAX package's uint64 math in int64 (torch on
the CPU has no uint64 shifts): the coordinates stay below 2^32, and bit
63 of the result is INT64_MIN.

One recorded deviation (ROADMAP queue C, deviation 11): over zero rows
`interleave_bits` gives a 0-row LIST<UINT8>, where the JAX package
raises ZeroDivisionError from its reshape.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import Kind
from . import zorder_cuda
from .zorder_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["interleave_bits", "hilbert_index", "LAUNCHES", "PLAIN_CALLS",
           "reset_counters"]

# the signed storage a width's bits are read through
_BITS_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _as_columns(table) -> list:
    if isinstance(table, Table):
        return list(table.columns)
    if isinstance(table, Column):
        return [table]
    return list(table)


def column_bits(col: Column) -> torch.Tensor:
    """(n,) int64 of a fixed-width column's bits (sign-extended from its
    width; only the width's bits are read), nulls 0."""
    size = col.dtype.itemsize()
    data = col.data
    if col.dtype.kind == Kind.BOOL:
        data = data.to(torch.int8)
    u = data.view(_BITS_VIEW[size]).to(torch.int64)
    if col.validity is not None:
        u = torch.where(col.validity, u, 0)
    return u


def column_bytes(col: Column) -> torch.Tensor:
    """(n, itemsize) uint8: a fixed-width column's bytes, most significant
    first, nulls 0."""
    data = col.data
    if col.dtype.kind == Kind.BOOL:
        data = data.to(torch.uint8)
    b = data.contiguous().view(torch.uint8).reshape(
        col.length, col.dtype.itemsize()).flip(1)
    if col.validity is not None:
        b = b * col.validity[:, None].to(torch.uint8)
    return b


def interleave_plain(cols: Sequence[Column]) -> torch.Tensor:
    """(n, ncols * itemsize) uint8: each row's interleaved bytes, in torch
    ops (any device): every column's bits unpacked MSB first into an
    (n, bits, ncols) uint8 plane, as the JAX package does, read as the
    stream and packed eight bits a byte."""
    n, size = cols[0].length, cols[0].dtype.itemsize()
    dev = cols[0].device
    if n == 0:
        return torch.empty((0, size * len(cols)), dtype=torch.uint8,
                           device=dev)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    planes = [((column_bytes(c)[:, :, None] >> shifts) & 1).reshape(
        n, 8 * size) for c in cols]
    bits = torch.stack(planes, 2).reshape(n, size * len(cols), 8)
    out = bits[..., 0] << 7
    for t in range(1, 8):
        out |= bits[..., t] << (7 - t)
    return out


def interleave_bits(table: Union[Table, Column, Sequence[Column]]) -> Column:
    """InterleaveBits over same-typed fixed-width columns -> LIST<UINT8>."""
    cols = _as_columns(table)
    if len(cols) == 0:
        raise ValueError("The input table must have at least one column.")
    t0 = cols[0].dtype
    if t0.is_string or t0.is_nested:
        raise TypeError("Only fixed width columns can be used")
    if any(c.dtype.kind != t0.kind for c in cols):
        raise TypeError("All columns of the input table must be the same type.")
    size = t0.itemsize()
    _BITS_VIEW[size]                # KeyError for DECIMAL128, as the JAX one
    n = cols[0].length
    row_bytes = size * len(cols)
    dev = cols[0].device
    if dev.type == "cpu":
        PLAIN_CALLS["interleave"] += 1
        packed = interleave_plain(cols)
    else:
        packed = zorder_cuda.interleave(cols, size)
    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * row_bytes
    child = Column(dtypes.UINT8, n * row_bytes, packed.reshape(-1))
    return Column.make_list(offsets, child)


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def hilbert_plain(num_bits: int, cols: Sequence[Column]) -> torch.Tensor:
    """(n,) int64 Hilbert indexes, in torch int64 ops (any device)."""
    ncols = len(cols)
    mask = (1 << num_bits) - 1
    # the coordinates, zero-extended from uint32 and masked (nulls 0)
    x = [column_bits(c) & mask for c in cols]
    # Skilling's inverse undo (exchange or invert a column's low bits)
    q = 1 << (num_bits - 1)
    while q > 1:
        p = q - 1
        for i in range(ncols):
            cond = (x[i] & q) != 0
            inv = x[0] ^ p
            if i == 0:
                x[0] = torch.where(cond, inv, x[0])
            else:
                t = (x[0] ^ x[i]) & p
                x0 = torch.where(cond, inv, x[0] ^ t)
                x[i] = torch.where(cond, x[i], x[i] ^ t)
                x[0] = x0
        q >>= 1
    # Gray encode
    for i in range(1, ncols):
        x[i] = (x[i] ^ x[i - 1]) & mask
    t = torch.zeros_like(x[0])
    q = 1 << (num_bits - 1)
    while q > 1:
        t = torch.where((x[ncols - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(ncols):
        x[i] = (x[i] ^ t) & mask
    # interleave the transposed index, dimension 0 most significant
    b = torch.zeros_like(x[0])
    b_index = num_bits * ncols - 1
    for bit in range(num_bits - 1, -1, -1):
        for j in range(ncols):
            b = torch.where((x[j] & (1 << bit)) != 0,
                            b | _signed64(1 << b_index), b)
            b_index -= 1
    return b


def hilbert_index(num_bits: int,
                  table: Union[Table, Column, Sequence[Column]]) -> Column:
    """The Hilbert curve distance of each row's point (zorder.cu:224-273)."""
    cols = _as_columns(table)
    ncols = len(cols)
    if not (0 < num_bits <= 32):
        raise ValueError("the number of bits must be >0 and <= 32.")
    if num_bits * ncols > 64:
        raise ValueError("we only support up to 64 bits of output right now.")
    if ncols == 0:
        raise ValueError("at least one column is required.")
    if any(c.dtype.kind != Kind.INT32 for c in cols):
        raise TypeError("All columns of the input table must be INT32.")
    n = cols[0].length
    if cols[0].device.type == "cpu":
        PLAIN_CALLS["hilbert"] += 1
        out = hilbert_plain(num_bits, cols)
    else:
        out = zorder_cuda.hilbert(num_bits, cols)
    return Column(dtypes.INT64, n, out)
