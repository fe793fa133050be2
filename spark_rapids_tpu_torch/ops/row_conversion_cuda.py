"""JCUDF row conversion on the card: two CUDA kernels and their wrappers.

The kernels live in `csrc/row_conversion.cu` (its header says what they
compute and what bounds them on the card); this module builds each
schema's word plan, binds the kernels through ctypes and registers the
registry's `row_conversion` op: "torch" (the fallback: `row_conversion`'s
plain versions, on CPU tensors) and "cuda" (these kernels, on the card).

- `to_rows(table)`: the (n * row_size,) uint8 row image;
- `from_rows(image, schema)`: a Table from an (n, row_size) image, every
  column with a validity from its bit.

Both take CUDA tensors only: they launch the kernel or raise, and never
fall back. The entry points of `row_conversion` choose between them and
the plain versions through the registry. Each schema's plan is uploaded
to the card once and kept (`device_plan`). `LAUNCHES` counts the kernels'
launches and `PLAIN_CALLS` (the plain module's own dict) the plain
versions' runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ..columnar import Column, Table
from ..dtypes import DType, Kind
from . import row_conversion as _plain
from .row_conversion import PLAIN_CALLS  # noqa: F401  (the shared dict)

LAUNCHES = {"to_rows": 0, "from_rows": 0}

# csrc/row_conversion.cu's byte sources (to_rows' plan)
SRC_WHOLE = 1 << 29
SRC_ADDR = 0x3FFFF
TILE_ROWS = 32              # rows a block of the kernels takes, at most
MAX_STAGE = 232448          # shared memory a block can have (227 KB)


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


def stage_layout(schema: Tuple[DType, ...]) -> Tuple[int, List[int], int,
                                                    int, int]:
    """to_rows' shared-memory tile: (rows a tile; each column's staging
    offset, 16-aligned, the tile's values one after another; the packed
    validity bytes' offset, a byte a row, byte after byte; the offset of a
    row of zero bytes; bytes in all), for the most rows up to TILE_ROWS
    that fit MAX_STAGE."""
    vbytes = (len(schema) + 7) // 8
    for tile in range(TILE_ROWS, 0, -1):
        stage, pos = [], 0
        for dt in schema:
            stage.append(pos)
            pos += (tile * dt.itemsize() + 15) // 16 * 16
        zstage = pos + vbytes * tile
        if zstage + tile <= MAX_STAGE:
            return tile, stage, pos, zstage, zstage + tile
    raise ValueError(f"a row of {len(schema)} columns does not fit the "
                     f"row-conversion kernel's {MAX_STAGE} bytes of shared "
                     "memory")


@functools.lru_cache(maxsize=64)
def word_plan(schema: Tuple[DType, ...]):
    """(the kernels' schema: four byte sources per 4-byte image word, then
    each column's width, its byte offset in the row, 1 for BOOL, its
    staging offset, its output buffer and its slot there (`out_groups`);
    the row's word count; the validity bytes' offset; the `stage_layout`
    tile, validity and zero offsets and bytes) of a schema."""
    col_offsets, validity_offset, row_size = _plain.row_layout(schema)
    tile, stage, vstage, zstage, stage_bytes = stage_layout(schema)
    # each image byte's address in the staged tile for row 0, and the log2
    # of its row stride there (0 for validity bytes and padding)
    src = [zstage] * row_size
    for c, (dt, off) in enumerate(zip(schema, col_offsets)):
        sh = dt.itemsize().bit_length() - 1
        for k in range(dt.itemsize()):
            src[off + k] = (sh << 24) | (stage[c] + k)
    for b in range((len(schema) + 7) // 8):
        src[validity_offset + b] = vstage + b * tile
    words = []
    for w in range(row_size // 4):
        quad = src[4 * w:4 * w + 4]
        if quad[0] >> 24 >= 2:
            # a column of 4 bytes or more starts 4-aligned and fills whole
            # words: 4 bytes of it
            quad = [quad[0] | SRC_WHOLE, 0, 0, 0]
        words.extend(quad)
    groups, group, slot = out_groups(schema)
    return (words + [dt.itemsize() for dt in schema] + list(col_offsets)
            + [int(dt.kind == Kind.BOOL) for dt in schema] + stage + group
            + slot, row_size // 4, validity_offset,
            (tile, vstage, zstage, stage_bytes))


@functools.lru_cache(maxsize=64)
def out_groups(schema: Tuple[DType, ...]):
    """from_rows' output buffers: (each buffer's (storage dtype, row
    shape, columns), in first-use order; each column's buffer; its slot
    there). A buffer holds its columns one after another, n rows each;
    the fixed-width kinds have 9 storages, within the kernel's 16."""
    keys, group, slot = {}, [], []
    for dt in schema:
        key = (dt.storage_dtype(), dt.row_shape)
        g = keys.setdefault(key, [len(keys), 0])
        group.append(g[0])
        slot.append(g[1])
        g[1] += 1
    return ([(d, shape, g[1]) for (d, shape), g in keys.items()], group,
            slot)


@functools.lru_cache(maxsize=64)
def device_plan(schema: Tuple[DType, ...], dev: torch.device):
    """`word_plan` with its int32 plan on the card, uploaded once."""
    plan, row_words, validity_offset, staging = word_plan(schema)
    return (torch.tensor(plan, dtype=torch.int32, device=dev), row_words,
            validity_offset, staging)


_P = ctypes.c_void_p
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("row_conversion")
        lib.rc_to_rows.argtypes = [_P, _P] + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, _P, _P]
        lib.rc_from_rows.argtypes = [_P, _P] + [ctypes.c_int] * 4 + [
            ctypes.c_longlong, _P, _P, _P]
        for fn in (lib.rc_to_rows, lib.rc_from_rows):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"row-conversion kernel ({what}): CUDA error "
                           f"{rc}")


def _need_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the row-conversion kernels run on CUDA tensors, "
                         f"got {dev}")


def to_rows(table: Table) -> torch.Tensor:
    """The (n * row_size,) uint8 row image of a table."""
    cols = list(table.columns)
    schema = tuple(c.dtype for c in cols)
    _, _, row_size = _plain.row_layout(schema)
    n = table.num_rows
    _plain.check_image_size(n, row_size)
    dev = table.device
    _need_cuda(dev)
    for c in cols:
        if not c.data.is_contiguous() or (
                c.validity is not None and not c.validity.is_contiguous()):
            raise ValueError("row conversion needs contiguous columns")
    meta, row_words, voff, staging = device_plan(schema, dev)
    # the kernel loads each value whole: aligned to min(width, 8)
    datas = [c.data if c.data.data_ptr() % min(d.itemsize(), 8) == 0
             else c.data.clone() for c, d in zip(cols, schema)]
    image = torch.empty(n * row_size, dtype=torch.uint8, device=dev)
    if n == 0 or not cols:
        return image
    # the columns' addresses: one small copy from pinned memory, queued on
    # the launch's stream
    ptrs = torch.tensor([d.data_ptr() for d in datas]
                        + [0 if c.validity is None else c.validity.data_ptr()
                           for c in cols], dtype=torch.int64).pin_memory()
    ptrs = ptrs.to(dev, non_blocking=True)
    _check(_lib().rc_to_rows(meta.data_ptr(), ptrs.data_ptr(), len(cols),
                             row_words, voff, *staging, n, image.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream),
           "to_rows")
    LAUNCHES["to_rows"] += 1
    return image


def from_rows(image: torch.Tensor, schema: Sequence[DType]) -> Table:
    """A Table of `schema` from an (n, row_size) uint8 image. The columns
    are views of one buffer per storage kind (`out_groups`) and their
    validities rows of one (ncols, n) buffer."""
    schema = tuple(schema)
    _, _, row_size = _plain.row_layout(schema)
    n = image.shape[0]
    if tuple(image.shape) != (n, row_size) or image.dtype != torch.uint8 \
            or not image.is_contiguous():
        raise ValueError(f"expected a contiguous ({n}, {row_size}) uint8 "
                         "image")
    dev = image.device
    _need_cuda(dev)
    if image.data_ptr() % 8:
        image = image.clone()         # the kernel reads 8-aligned rows
    groups, group, slot = out_groups(schema)
    bufs = [torch.empty((k, n) + shape, dtype=d, device=dev)
            for d, shape, k in groups]
    valid = torch.empty((len(schema), n), dtype=torch.bool, device=dev)
    if n and schema:
        meta, row_words, voff, _ = device_plan(schema, dev)
        bases = (_P * len(bufs))(*[b.data_ptr() for b in bufs])
        _check(_lib().rc_from_rows(meta.data_ptr(), bases, len(bufs),
                                   len(schema), row_words, voff, n,
                                   image.data_ptr(), valid.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream),
               "from_rows")
        LAUNCHES["from_rows"] += 1
    views = [b.unbind(0) for b in bufs]
    return Table([Column(dt, n, views[g][k], v) for dt, g, k, v in
                  zip(schema, group, slot, valid.unbind(0))])


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("row_conversion", "torch", fallback=True)
_REGISTRY.register("row_conversion", "cuda", backends=("cuda",))
