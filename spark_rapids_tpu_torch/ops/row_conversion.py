"""Columnar <-> row-major conversion in the JCUDF row format.

Counterpart of `spark_rapids_tpu/ops/row_conversion.py` (RowConversion.java:
44-117): each column at an offset aligned to min(its width, 8), in order;
one validity byte per 8 columns (bit i % 8 of byte i // 8 set when column
i is valid) right after the last column, byte aligned; the row padded to a
multiple of 8 bytes. Fixed-width kinds only. The row image is returned as
a LIST<UINT8> column whose offsets are the constant row stride.

`convert_to_rows` / `convert_from_rows` (and their fixed-width-optimized
forms, which enforce that path's limits) select through the kernel
registry's `row_conversion` op: on CPU tensors the plain versions below
("torch"), on CUDA tensors the kernels of `row_conversion_cuda` ("cuda"),
or `KernelDeclinedError`. The plain versions concatenate each column's
little-endian bytes (`Tensor.view(torch.uint8)`); the reference's u32
"word" plan is a TPU tiling device and is not carried over.

One deviation, where the port gives the natural answer: the reference
computes the rows' int32 offsets as `arange(n + 1) * row_size`, which
wraps beyond 2^31 - 1 bytes; the port raises ValueError before it
allocates anything (ROADMAP queue C).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import DType, Kind

# the fixed-width-optimized path's limits (RowConversion.java:32-34, :116)
OPTIMIZED_MAX_ROW_BYTES = 1024
OPTIMIZED_MAX_COLUMNS = 100
MAX_IMAGE_BYTES = 2 ** 31 - 1      # the rows' offsets are int32

FIXED_KINDS = frozenset({
    Kind.BOOL, Kind.INT8, Kind.UINT8, Kind.INT16, Kind.INT32, Kind.INT64,
    Kind.FLOAT32, Kind.FLOAT64, Kind.DECIMAL32, Kind.DECIMAL64,
    Kind.DECIMAL128, Kind.DATE32, Kind.TIMESTAMP_US, Kind.TIMESTAMP_S,
    Kind.TIMESTAMP_MS})

# plain-version runs, counted inside the plain functions (the kernels'
# wrappers in row_conversion_cuda share this dict)
PLAIN_CALLS = {"to_rows": 0, "from_rows": 0}


def check_fixed_width(dts: Sequence[DType]) -> None:
    for dt in dts:
        if dt.kind not in FIXED_KINDS:
            raise TypeError(f"row conversion supports fixed-width types "
                            f"only, got {dt}")


def row_layout(dts: Sequence[DType]) -> Tuple[List[int], int, int]:
    """(column byte offsets, validity byte offset, row size)."""
    check_fixed_width(dts)
    offsets = []
    pos = 0
    for dt in dts:
        w = dt.itemsize()
        align = min(w, 8)
        pos = (pos + align - 1) // align * align
        offsets.append(pos)
        pos += w
    validity_offset = pos                      # byte aligned, no padding
    pos += (len(dts) + 7) // 8
    return offsets, validity_offset, (pos + 7) // 8 * 8


def check_image_size(n: int, row_size: int) -> None:
    if n * row_size > MAX_IMAGE_BYTES:
        raise ValueError(
            f"{n} rows of {row_size} bytes need {n * row_size} bytes, past "
            f"the {MAX_IMAGE_BYTES} an int32 offset reaches; convert fewer "
            "rows at a time")


def check_optimized_limits(dts: Sequence[DType]) -> None:
    """Fewer than 100 columns, at most 1 KB a row."""
    if len(dts) >= OPTIMIZED_MAX_COLUMNS:
        raise ValueError(f"fixed-width-optimized conversion handles < "
                         f"{OPTIMIZED_MAX_COLUMNS} columns")
    _, _, row_size = row_layout(dts)
    if row_size > OPTIMIZED_MAX_ROW_BYTES:
        raise ValueError(f"row size {row_size} exceeds "
                         f"{OPTIMIZED_MAX_ROW_BYTES} bytes")


def rows_column(rows: torch.Tensor, n: int, row_size: int) -> Column:
    """The LIST<UINT8> column of an (n * row_size,) uint8 image."""
    offsets = torch.arange(n + 1, dtype=torch.int64,
                           device=rows.device) * row_size
    return Column.make_list(offsets.to(torch.int32),
                            Column(dtypes.UINT8, n * row_size, rows))


def image_of(rows_col: Column, schema: Sequence[DType]) -> torch.Tensor:
    """The (n, row_size) uint8 image of a rows column, after checking its
    type and its uniform stride (one read of the device)."""
    _, _, row_size = row_layout(schema)
    if rows_col.dtype.kind != Kind.LIST:
        raise TypeError("expected a LIST<UINT8> rows column")
    n = rows_col.length
    offs = rows_col.offsets
    if n and not bool(((offs[1:] - offs[:-1]) == row_size).all()
                      & (offs[0] == 0)):
        raise ValueError(
            f"rows column must be contiguous with a uniform {row_size}-byte "
            "stride matching the schema's row layout")
    return rows_col.children[0].data[: n * row_size].reshape(n, row_size)


# ---- the plain versions ------------------------------------------------------

def to_rows_plain(table: Table) -> torch.Tensor:
    """The (n * row_size,) uint8 row image of a table."""
    PLAIN_CALLS["to_rows"] += 1
    cols = list(table.columns)
    col_offsets, validity_offset, row_size = row_layout(
        [c.dtype for c in cols])
    n = table.num_rows
    check_image_size(n, row_size)
    dev = table.device
    image = torch.zeros((n, row_size), dtype=torch.uint8, device=dev)
    if n == 0:            # an empty tensor has no byte view
        return image.reshape(-1)
    for c, off in zip(cols, col_offsets):
        w = c.dtype.itemsize()
        image[:, off:off + w] = c.data.contiguous().view(
            torch.uint8).reshape(n, w)
    for b in range((len(cols) + 7) // 8):
        byte = torch.zeros(n, dtype=torch.int32, device=dev)
        for bit, c in enumerate(cols[8 * b:8 * b + 8]):
            byte |= c.null_mask.to(torch.int32) << bit
        image[:, validity_offset + b] = byte.to(torch.uint8)
    return image.reshape(-1)


def from_rows_plain(image: torch.Tensor, schema: Sequence[DType]) -> Table:
    """A Table of `schema` from an (n, row_size) uint8 row image; every
    column gets a validity from its bit."""
    PLAIN_CALLS["from_rows"] += 1
    col_offsets, validity_offset, _ = row_layout(schema)
    n = image.shape[0]
    cols = []
    for i, (dt, off) in enumerate(zip(schema, col_offsets)):
        block = image[:, off:off + dt.itemsize()].contiguous()
        if dt.kind == Kind.BOOL:
            data = block[:, 0] != 0
        else:
            data = block.view(dt.storage_dtype()).reshape(
                (n,) + dt.row_shape)
        vbyte = image[:, validity_offset + i // 8].to(torch.int32)
        cols.append(Column(dt, n, data, ((vbyte >> (i % 8)) & 1) != 0))
    return Table(cols)


# ---- the entry points --------------------------------------------------------

def _kernels(device: torch.device):
    """`row_conversion_cuda` where the registry chooses the kernels, None
    for the plain versions (CPU tensors); on the card a declined call
    raises."""
    from .registry import REGISTRY, KernelDeclinedError
    choice = REGISTRY.select("row_conversion", None, backend=device.type)
    if not choice.fallback:
        from . import row_conversion_cuda
        return row_conversion_cuda
    if device.type == "cuda":
        raise KernelDeclinedError("the row-conversion kernels were not "
                                  "chosen on the card (the plain version "
                                  "was forced)")
    return None


def convert_to_rows(table: Table) -> List[Column]:
    """Table -> [LIST<UINT8> rows column] (RowConversion.convertToRows)."""
    _, _, row_size = row_layout([c.dtype for c in table.columns])
    n = table.num_rows
    k = _kernels(table.device)
    rows = to_rows_plain(table) if k is None else k.to_rows(table)
    return [rows_column(rows, n, row_size)]


def convert_to_rows_fixed_width_optimized(table: Table) -> List[Column]:
    """convert_to_rows within the optimized path's limits."""
    check_optimized_limits([c.dtype for c in table.columns])
    return convert_to_rows(table)


def convert_from_rows(rows_col: Column, schema: Sequence[DType]) -> Table:
    """LIST<UINT8> rows column -> Table (RowConversion.convertFromRows);
    `schema` gives each column's type."""
    schema = list(schema)
    image = image_of(rows_col, schema)
    k = _kernels(rows_col.device)
    return (from_rows_plain(image, schema) if k is None
            else k.from_rows(image, schema))


def convert_from_rows_fixed_width_optimized(
        rows_col: Column, schema: Sequence[DType]) -> Table:
    """convert_from_rows within the optimized path's limits."""
    check_optimized_limits(list(schema))
    return convert_from_rows(rows_col, schema)
