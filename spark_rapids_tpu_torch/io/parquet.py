"""Chunked Parquet reader into the port's Tables, and the streaming source.

Counterpart of `spark_rapids_tpu/io/parquet.py`, over the port's own copy
of the reader C++ (`native/parquet_reader.cpp`, built by `native/build.py`
at first use and called through `ctypes.CDLL`, which releases the GIL, so
a prefetch thread's decode runs beside the executing thread). The
bitstream decode (thrift page headers, RLE and bit-packed levels,
dictionaries, codecs) runs in host C++, as in the reference, and the
reference's numpy assembly follows it unchanged, so every buffer equals
the JAX package's bit for bit: DECIMAL128 as (n, 4) uint32 limbs, STRING
as chars and int32 offsets, LIST and STRUCT as offsets, children and
validity, INT96 as microseconds, dates as int32 days.

The port differs in where the buffers go. Each chunk is assembled in host
memory (`_Arena`): page-locked memory when the chunk is bound for the
card, so its copy can run asynchronously on a copy stream while the next
chunk decodes (`plan/executor.py` `_ChunkPrefetcher`), and the columns
move to an explicit `device` (None: the card, as for every entry point).
A column whose rows are all present is the C++ output buffer itself, not
a copy of it.

Usage:
    t = read_parquet("part-0.parquet", columns=["a", "b"])     # whole file
    with ParquetChunkedReader("big.parquet") as r:             # chunked
        while r.has_next():
            table = r.read_chunk()          # one row group per chunk

Type mapping (parquet physical + converted -> port dtype):
  BOOLEAN->BOOL, INT32->INT32 (DATE->DATE32, DECIMAL->DECIMAL32),
  INT64->INT64 (TIMESTAMP_MICROS->TIMESTAMP_US, TIMESTAMP_MILLIS->TIMESTAMP_MS,
  DECIMAL->DECIMAL64), INT96->TIMESTAMP_US (legacy Impala timestamps),
  FLOAT->FLOAT32, DOUBLE->FLOAT64, BYTE_ARRAY->STRING,
  FIXED_LEN_BYTE_ARRAY(DECIMAL)->DECIMAL128.
"""
from __future__ import annotations

import ctypes
import os
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import device as _device
from .. import dtypes
from ..columnar import Column, Table
from ..native.build import build


def _t(a: np.ndarray) -> torch.Tensor:
    """A host numpy buffer as a CPU tensor, sharing its memory."""
    return torch.from_numpy(np.ascontiguousarray(a))


class _Arena:
    """Where one chunk's host buffers come from. `pinned` gives
    page-locked buffers (a chunk bound for the card), whose numpy views
    keep their tensors alive; a caller that copies them asynchronously
    keeps the chunk until the copy's event has completed."""

    def __init__(self, pinned: bool = False):
        self.pinned = pinned

    def empty(self, shape, np_dtype) -> np.ndarray:
        shape = (shape,) if isinstance(shape, (int, np.integer)) else \
            tuple(shape)
        if not self.pinned:
            return np.empty(shape, np_dtype)
        nbytes = int(np.prod(shape)) * np.dtype(np_dtype).itemsize
        t = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        return t.numpy()[:nbytes].view(np_dtype).reshape(shape)


_HOST = _Arena()


class _Node(NamedTuple):
    """One generalized-ancestry node (kind-4 leaves): the Python image of
    the native 4-int descriptor records. MAP records are expanded at parse
    time into (list, implicit struct) so the builder only ever sees
    'struct' and 'list' — a map IS LIST<STRUCT<key,value>> in this engine
    (the same representation ops/map_utils.py produces)."""
    kind: str      # "struct" | "list"
    a: int         # struct: def of the group if optional else -1; list: dar
    b: int         # list: def of the (optional) LIST group else -1
    segs: int      # dotted path segments this node consumes

_lib = None
_lib_lock = threading.Lock()

# parquet physical types
_PT_BOOLEAN, _PT_INT32, _PT_INT64, _PT_INT96 = 0, 1, 2, 3
_PT_FLOAT, _PT_DOUBLE, _PT_BYTE_ARRAY, _PT_FLBA = 4, 5, 6, 7
# converted types we honor
_CT_UTF8, _CT_DECIMAL, _CT_DATE = 0, 5, 6
_CT_TIMESTAMP_MILLIS, _CT_TIMESTAMP_MICROS = 9, 10


def _native():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build("parquet_reader")))
                lib.pqr_open.restype = ctypes.c_void_p
                lib.pqr_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
                lib.pqr_open_ex.restype = ctypes.c_void_p
                lib.pqr_open_ex.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int32]
                lib.pqr_last_error.restype = ctypes.c_char_p
                lib.pqr_num_rows.restype = ctypes.c_int64
                lib.pqr_num_rows.argtypes = [ctypes.c_void_p]
                lib.pqr_num_row_groups.argtypes = [ctypes.c_void_p]
                lib.pqr_num_leaves.argtypes = [ctypes.c_void_p]
                lib.pqr_row_group_num_rows.restype = ctypes.c_int64
                lib.pqr_row_group_num_rows.argtypes = [ctypes.c_void_p,
                                                       ctypes.c_int32]
                lib.pqr_leaf_info.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                    ctypes.c_int32] + [ctypes.POINTER(ctypes.c_int32)] * 7
                lib.pqr_read_column.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int64)]
                lib.pqr_leaf_kind.argtypes = [ctypes.c_void_p, ctypes.c_int32]
                lib.pqr_leaf_struct_info.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
                lib.pqr_read_def_levels.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_void_p]
                lib.pqr_read_list_column.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int64)]
                lib.pqr_leaf_ancestry.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
                lib.pqr_read_nested_column.argtypes = [
                    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64)]
                lib.pqr_free.argtypes = [ctypes.c_void_p]
                _lib = lib
    return _lib


class _Leaf:
    def __init__(self, idx, name, phys, type_length, converted, scale,
                 precision, optional, flat, is_list=False,
                 is_struct_member=False, ancestor_defs=(), max_def=0):
        self.idx, self.name, self.phys = idx, name, phys
        self.type_length, self.converted = type_length, converted
        self.scale, self.precision = scale, precision
        self.optional, self.flat = optional, flat
        self.is_list = is_list
        self.is_struct_member = is_struct_member
        self.ancestor_defs = tuple(ancestor_defs)  # per ancestor group,
                                                   # -1 = required
        self.max_def = max_def
        self.max_rep = 0
        self.nodes = ()        # kind-4 generalized ancestry (_Node records)
        # LIST leaves carry the 3-level dotted path (f.list.element) and
        # STRUCT members their field path; the user-facing column name is
        # the outer field
        self.display = name.split(".")[0] if (is_list or is_struct_member) \
            else name

    def dtype(self) -> dtypes.DType:
        if self.phys == _PT_BOOLEAN:
            return dtypes.BOOL
        if self.phys == _PT_INT32:
            if self.converted == _CT_DATE:
                return dtypes.DATE32
            if self.converted == _CT_DECIMAL:
                return dtypes.DType(dtypes.Kind.DECIMAL32,
                                    precision=self.precision, scale=self.scale)
            return dtypes.INT32
        if self.phys == _PT_INT64:
            if self.converted == _CT_TIMESTAMP_MICROS:
                return dtypes.TIMESTAMP_US
            if self.converted == _CT_TIMESTAMP_MILLIS:
                return dtypes.DType(dtypes.Kind.TIMESTAMP_MS)
            if self.converted == _CT_DECIMAL:
                return dtypes.DType(dtypes.Kind.DECIMAL64,
                                    precision=self.precision, scale=self.scale)
            return dtypes.INT64
        if self.phys == _PT_INT96:
            return dtypes.TIMESTAMP_US
        if self.phys == _PT_FLOAT:
            return dtypes.FLOAT32
        if self.phys == _PT_DOUBLE:
            return dtypes.FLOAT64
        if self.phys == _PT_BYTE_ARRAY:
            return dtypes.STRING
        if self.phys == _PT_FLBA and self.converted == _CT_DECIMAL:
            return dtypes.DType(dtypes.Kind.DECIMAL128,
                                precision=self.precision, scale=self.scale)
        raise TypeError(f"unsupported parquet column {self.name!r} "
                        f"(physical type {self.phys})")


class ParquetChunkedReader:
    """Reads a parquet file one row group at a time (cudf chunked-reader
    contract: bounded memory regardless of file size).

    `columns=` is SELECTIVE decode: non-requested leaves are dropped from
    the schema walk before any page is touched, so their column chunks are
    never decompressed or assembled (not a post-select). `row_groups=`
    restricts the chunk sequence to the given group indices — the hook
    min/max footer pruning (parquet_footer.read_footer_stats) drives.
    Chunks come out on `device` (None: the card, "cpu" on request)."""

    def __init__(self, source: Union[str, bytes],
                 columns: Optional[Sequence[str]] = None,
                 row_groups: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = _device.resolve(device)
        self._lib = _native()
        # zero-copy open: mmap files (pages fault in lazily, so decode
        # memory stays bounded per row group) / borrow bytes buffers; the
        # buffer is kept alive on self for the handle's lifetime
        if isinstance(source, (str, os.PathLike)):
            import mmap
            with open(source, "rb") as f:
                # ACCESS_COPY: private CoW pages, required by from_buffer
                self._buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        else:
            self._buf = source
        n = len(self._buf)
        if isinstance(self._buf, bytes):
            addr = ctypes.cast(ctypes.c_char_p(self._buf), ctypes.c_void_p)
        else:
            addr = ctypes.c_void_p(
                ctypes.addressof(ctypes.c_char.from_buffer(self._buf)))
        self._h = self._lib.pqr_open_ex(addr, n, 0)
        if not self._h:
            raise ValueError(self._lib.pqr_last_error().decode())
        self._leaves = self._read_schema()
        # top-level fields that assemble via the generalized nested builder
        # (any kind-4 leaf pulls its whole display group through it)
        self._nested_displays = {l.display for l in self._leaves
                                 if l.kind == 4}
        if columns is not None:
            wanted = set(columns)
            present = {l.display for l in self._leaves}
            missing = [c for c in columns if c not in present]
            if missing:
                raise KeyError(f"columns not in file: {missing}")
            self._leaves = [l for l in self._leaves if l.display in wanted]
            # preserve the requested order (by first occurrence)
            order = {c: k for k, c in enumerate(columns)}
            self._leaves.sort(key=lambda l: order[l.display])
        self.num_row_groups = self._lib.pqr_num_row_groups(self._h)
        self.num_rows = self._lib.pqr_num_rows(self._h)
        if row_groups is None:
            self._groups = list(range(self.num_row_groups))
        else:
            bad = [g for g in row_groups
                   if not 0 <= int(g) < self.num_row_groups]
            if bad:
                raise IndexError(
                    f"row group(s) {bad} out of range "
                    f"(file has {self.num_row_groups})")
            self._groups = [int(g) for g in row_groups]
        self._next_group = 0        # position in self._groups

    def _read_schema(self) -> List[_Leaf]:
        n = self._lib.pqr_num_leaves(self._h)
        out = []
        ints = [ctypes.c_int32() for _ in range(7)]
        for i in range(n):
            buf = ctypes.create_string_buffer(1024)
            rc = self._lib.pqr_leaf_info(self._h, i, buf, 1024,
                                         *[ctypes.byref(x) for x in ints])
            if rc != 0:
                raise ValueError("schema read failed")
            phys, tl, conv, scale, prec, opt, flat = (x.value for x in ints)
            kind = self._lib.pqr_leaf_kind(self._h, i)
            anc, max_def = (), 0
            nodes, max_rep = (), 0
            anc_overflow = False
            if kind == 2:
                md = ctypes.c_int32()
                buf_anc = (ctypes.c_int32 * 16)()
                n_anc = self._lib.pqr_leaf_struct_info(
                    self._h, i, ctypes.byref(md), buf_anc, 16)
                if n_anc < 0 or n_anc > 16:
                    kind = 3            # too deep / inconsistent: skip
                else:
                    anc, max_def = tuple(buf_anc[:n_anc]), md.value
            if kind in (2, 4):
                # kind-2 leaves need the generalized descriptor too: a mixed
                # top-level field (STRUCT with both plain and list-bearing
                # members) assembles every member through the nested builder
                md, mr = ctypes.c_int32(), ctypes.c_int32()
                buf_desc = (ctypes.c_int32 * 64)()
                n_ints = self._lib.pqr_leaf_ancestry(
                    self._h, i, ctypes.byref(md), ctypes.byref(mr),
                    buf_desc, 64)
                if n_ints < 0 or n_ints > 64 or n_ints % 4 != 0:
                    if kind == 4:
                        kind = 3
                    else:
                        # a kind-2 member without a descriptor cannot join a
                        # mixed nested group: poison the field below rather
                        # than crash the builder mid-tree
                        anc_overflow = True
                else:
                    max_def, max_rep = md.value, mr.value
                    parsed = []
                    for k in range(n_ints // 4):
                        t, a, b, segs = (buf_desc[4 * k], buf_desc[4 * k + 1],
                                         buf_desc[4 * k + 2],
                                         buf_desc[4 * k + 3])
                        if t == 2:      # MAP -> list + implicit element struct
                            parsed.append(_Node("list", a, b, segs))
                            parsed.append(_Node("struct", -1, -1, 0))
                        else:
                            parsed.append(_Node("struct" if t == 0 else "list",
                                                a, b, segs))
                    nodes = tuple(parsed)
            leaf = _Leaf(i, buf.value.decode(), phys, tl, conv, scale,
                         prec, bool(opt), bool(flat), kind == 1,
                         kind == 2, anc, max_def)
            leaf.kind = kind
            leaf.anc_overflow = anc_overflow
            if kind in (2, 4):
                leaf.nodes = nodes
                leaf.max_rep = max_rep
            if kind == 4:
                leaf.display = leaf.name.split(".")[0]
            out.append(leaf)
        # an unsupported leaf poisons its whole top-level field: surfacing a
        # struct with silently missing members would misrepresent the schema
        bad = {l.name.split(".")[0] for l in out if l.kind == 3}
        # a kind-2 member without an ancestry descriptor cannot assemble
        # inside a mixed nested field — poison that field too
        nested4 = {l.display for l in out if l.kind == 4}
        bad |= {l.display for l in out
                if l.anc_overflow and l.display in nested4}
        return [l for l in out
                if (l.flat or l.is_list or l.is_struct_member or l.kind == 4)
                and l.display not in bad]

    @property
    def column_names(self) -> List[str]:
        names, seen = [], set()
        for l in self._leaves:
            if l.display not in seen:
                seen.add(l.display)
                names.append(l.display)
        return names

    def has_next(self) -> bool:
        return self._next_group < len(self._groups)

    def read_chunk(self) -> Table:
        """Decode the next (selected) row group into a Table on the
        reader's device."""
        return self.read_chunk_host().to(self.device)

    def read_chunk_host(self, arena: _Arena = _HOST) -> Table:
        """The next (selected) row group as a Table in host memory, its
        large buffers from `arena`."""
        if not self.has_next():
            raise StopIteration("no more row groups")
        rg = self._groups[self._next_group]
        self._next_group += 1
        return self._read_group(rg, arena)

    def read_all_host(self) -> Table:
        """Every remaining row group as one Table in host memory."""
        chunks = []
        while self.has_next():
            chunks.append(self.read_chunk_host())
        if len(chunks) == 1:
            return chunks[0]
        if not chunks:
            return Table(self._empty_columns(), names=self.column_names)
        return _concat_tables(chunks)

    def read_all(self) -> Table:
        """Decode every remaining row group into one Table on the reader's
        device (concatenated in host memory, then moved once)."""
        return self.read_all_host().to(self.device)

    def _empty_column(self, leaf: _Leaf) -> Column:
        elem = _assemble(leaf, np.zeros(0, np.uint8), np.zeros(0, np.int32),
                         np.ones(0, np.uint8), 0, 0)
        if leaf.is_list:
            return Column.make_list(_t(np.zeros(1, np.int32)), elem)
        return elem

    def _empty_columns(self) -> List[Column]:
        cols, done = [], set()
        for leaf in self._leaves:
            if leaf.kind == 4 or leaf.display in self._nested_displays:
                if leaf.display not in done:
                    done.add(leaf.display)
                    group = [l for l in self._leaves
                             if l.display == leaf.display]
                    decoded = [_NLeaf(l, l.name.split("."),
                                      np.zeros(0, np.uint8),
                                      np.zeros(0, np.int32),
                                      np.zeros(0, np.int16),
                                      np.zeros(0, np.int16), 0)
                               for l in group]
                    cols.append(_build_nested(
                        decoded, 0, 0,
                        [np.zeros(0, np.int64)] * len(group), 0))
                continue
            if leaf.is_struct_member:
                if leaf.display not in done:
                    done.add(leaf.display)
                    members = [(l, self._empty_column(l), np.zeros(0, np.uint8))
                               for l in self._leaves
                               if l.is_struct_member and l.display == leaf.display]
                    cols.append(_build_struct_tree(members, 1, 0))
                continue
            cols.append(self._empty_column(leaf))
        return cols

    def _read_group(self, rg: int, arena: _Arena) -> Table:
        n_rows = self._lib.pqr_row_group_num_rows(self._h, rg)
        cols = []
        done_structs = set()
        for leaf in self._leaves:
            if leaf.kind == 4 or leaf.display in self._nested_displays:
                # generalized nesting: assemble the whole top-level field
                # (a mixed struct pulls its plain members through this path
                # too, so every member shares one slot-stream model)
                if leaf.display not in done_structs:
                    done_structs.add(leaf.display)
                    group = [l for l in self._leaves
                             if l.display == leaf.display]
                    cols.append(self._read_nested_chunk(rg, group, n_rows))
                continue
            if leaf.is_struct_member:
                if leaf.display not in done_structs:
                    done_structs.add(leaf.display)
                    members = [l for l in self._leaves
                               if l.is_struct_member and l.display == leaf.display]
                    cols.append(self._read_struct_chunk(rg, members, n_rows))
                continue
            if leaf.is_list:
                cols.append(self._read_list_chunk(rg, leaf, n_rows))
                continue
            nbytes = ctypes.c_int64()
            present = ctypes.c_int64()
            rc = self._lib.pqr_read_column(self._h, rg, leaf.idx, None,
                                           ctypes.byref(nbytes), None, None,
                                           ctypes.byref(present))
            if rc != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            values = arena.empty(max(nbytes.value, 1), np.uint8)
            lengths = np.zeros(max(present.value, 1), np.int32)
            defined = np.zeros(max(n_rows, 1), np.uint8)
            rc = self._lib.pqr_read_column(
                self._h, rg, leaf.idx,
                values.ctypes.data_as(ctypes.c_void_p), ctypes.byref(nbytes),
                lengths.ctypes.data_as(ctypes.c_void_p),
                defined.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(present))
            if rc != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            cols.append(_assemble(leaf, values[:nbytes.value],
                                  lengths[:present.value],
                                  defined[:n_rows], n_rows, present.value,
                                  arena))
        return Table(cols, names=self.column_names)

    def _read_struct_chunk(self, rg: int, members: List[_Leaf],
                           n_rows: int) -> Column:
        """Assemble one STRUCT column from its member leaves: each member
        decodes like a flat column plus its raw def levels; a struct node at
        def threshold D is null on rows where def < D (any member's levels
        give identical ancestor validity)."""
        decoded = []
        for leaf in members:
            nbytes = ctypes.c_int64()
            present = ctypes.c_int64()
            rc = self._lib.pqr_read_column(self._h, rg, leaf.idx, None,
                                           ctypes.byref(nbytes), None, None,
                                           ctypes.byref(present))
            if rc != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            defs = np.zeros(max(n_rows, 1), np.uint8)
            if leaf.max_def > 0:
                rc = self._lib.pqr_read_def_levels(
                    self._h, rg, leaf.idx,
                    defs.ctypes.data_as(ctypes.c_void_p))
                if rc != 0:
                    raise ValueError(self._lib.pqr_last_error().decode())
            else:
                defs[:] = leaf.max_def
            values = np.zeros(max(nbytes.value, 1), np.uint8)
            lengths = np.zeros(max(present.value, 1), np.int32)
            defined = np.zeros(max(n_rows, 1), np.uint8)
            rc = self._lib.pqr_read_column(
                self._h, rg, leaf.idx,
                values.ctypes.data_as(ctypes.c_void_p), ctypes.byref(nbytes),
                lengths.ctypes.data_as(ctypes.c_void_p),
                defined.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(present))
            if rc != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            col = _assemble(leaf, values[:nbytes.value],
                            lengths[:present.value], defined[:n_rows],
                            n_rows, present.value)
            decoded.append((leaf, col, defs[:n_rows]))
        return _build_struct_tree(decoded, level=1, n_rows=n_rows)

    def _read_nested_buffers(self, rg: int, leaf: _Leaf, n_rows: int):
        """(values, lengths, defs, reps, present) for one leaf of a nested
        field. Kind-4 leaves export raw level streams; kind-2 members of a
        mixed struct synthesize reps == 0 over n_rows slots so both plug
        into the same Dremel builder."""
        if leaf.kind == 4:
            nbytes = ctypes.c_int64()
            present = ctypes.c_int64()
            slots = ctypes.c_int64()

            def call(values, lengths, defs, reps):
                return self._lib.pqr_read_nested_column(
                    self._h, rg, leaf.idx, values, ctypes.byref(nbytes),
                    lengths, defs, reps, ctypes.byref(slots),
                    ctypes.byref(present))

            if call(None, None, None, None) != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            values = np.zeros(max(nbytes.value, 1), np.uint8)
            lengths = np.zeros(max(present.value, 1), np.int32)
            defs = np.zeros(max(slots.value, 1), np.uint8)
            reps = np.zeros(max(slots.value, 1), np.uint8)
            if call(values.ctypes.data_as(ctypes.c_void_p),
                    lengths.ctypes.data_as(ctypes.c_void_p),
                    defs.ctypes.data_as(ctypes.c_void_p),
                    reps.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            s = slots.value
            return (values[:nbytes.value], lengths[:present.value],
                    defs[:s].astype(np.int16), reps[:s].astype(np.int16),
                    int(present.value))
        # kind-2 member: dense read + raw def levels, reps all zero
        nbytes = ctypes.c_int64()
        present = ctypes.c_int64()
        rc = self._lib.pqr_read_column(self._h, rg, leaf.idx, None,
                                       ctypes.byref(nbytes), None, None,
                                       ctypes.byref(present))
        if rc != 0:
            raise ValueError(self._lib.pqr_last_error().decode())
        defs = np.full(max(n_rows, 1), leaf.max_def, np.int16)
        if leaf.max_def > 0:
            d8 = np.zeros(max(n_rows, 1), np.uint8)
            rc = self._lib.pqr_read_def_levels(
                self._h, rg, leaf.idx, d8.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise ValueError(self._lib.pqr_last_error().decode())
            defs = d8.astype(np.int16)
        values = np.zeros(max(nbytes.value, 1), np.uint8)
        lengths = np.zeros(max(present.value, 1), np.int32)
        defined = np.zeros(max(n_rows, 1), np.uint8)
        rc = self._lib.pqr_read_column(
            self._h, rg, leaf.idx,
            values.ctypes.data_as(ctypes.c_void_p), ctypes.byref(nbytes),
            lengths.ctypes.data_as(ctypes.c_void_p),
            defined.ctypes.data_as(ctypes.c_void_p), ctypes.byref(present))
        if rc != 0:
            raise ValueError(self._lib.pqr_last_error().decode())
        return (values[:nbytes.value], lengths[:present.value],
                defs[:n_rows], np.zeros(n_rows, np.int16),
                int(present.value))

    def _read_nested_chunk(self, rg: int, group: List[_Leaf],
                           n_rows: int) -> Column:
        """Assemble one generalized-nested top-level field: read every
        leaf's dense values + (def, rep) streams, then run the multi-level
        Dremel reassembly (numpy, vectorized over level slots)."""
        decoded = []
        for leaf in group:
            values, lengths, defs, reps, present = \
                self._read_nested_buffers(rg, leaf, n_rows)
            decoded.append(_NLeaf(leaf, leaf.name.split("."), values,
                                  lengths, defs, reps, present))
        ctxs = [np.nonzero(nl.reps == 0)[0] for nl in decoded]
        for nl, ctx in zip(decoded, ctxs):
            if len(ctx) != n_rows:
                raise ValueError(
                    f"nested column {nl.leaf.display!r}: row count mismatch "
                    f"({len(ctx)} vs {n_rows})")
        return _build_nested(decoded, 0, 0, ctxs, 0)

    def _read_list_chunk(self, rg: int, leaf: _Leaf, n_rows: int) -> Column:
        nbytes = ctypes.c_int64()
        present = ctypes.c_int64()
        slots = ctypes.c_int64()
        rows = ctypes.c_int64()

        def call(values, lengths, defined, counts, valid):
            return self._lib.pqr_read_list_column(
                self._h, rg, leaf.idx, values, ctypes.byref(nbytes),
                lengths, defined, ctypes.byref(slots), ctypes.byref(present),
                counts, valid, ctypes.byref(rows))

        if call(None, None, None, None, None) != 0:
            raise ValueError(self._lib.pqr_last_error().decode())
        values = np.zeros(max(nbytes.value, 1), np.uint8)
        lengths = np.zeros(max(present.value, 1), np.int32)
        defined = np.zeros(max(slots.value, 1), np.uint8)
        counts = np.zeros(max(rows.value, 1), np.int32)
        valid = np.zeros(max(rows.value, 1), np.uint8)
        rc = call(values.ctypes.data_as(ctypes.c_void_p),
                  lengths.ctypes.data_as(ctypes.c_void_p),
                  defined.ctypes.data_as(ctypes.c_void_p),
                  counts.ctypes.data_as(ctypes.c_void_p),
                  valid.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise ValueError(self._lib.pqr_last_error().decode())
        if rows.value != n_rows:
            raise ValueError(
                f"list column {leaf.display!r}: row count mismatch "
                f"({rows.value} vs {n_rows})")
        elem = _assemble(leaf, values[:nbytes.value],
                         lengths[:present.value], defined[:slots.value],
                         int(slots.value), int(present.value))
        offsets = np.zeros(n_rows + 1, np.int32)
        np.cumsum(counts[:n_rows], out=offsets[1:])
        validity = (_t(valid[:n_rows] != 0)
                    if (valid[:n_rows] == 0).any() else None)
        return Column.make_list(_t(offsets), elem, validity)

    def close(self) -> None:
        if self._h:
            self._lib.pqr_free(self._h)
            self._h = 0
        buf = getattr(self, "_buf", None)
        if buf is not None and hasattr(buf, "close"):
            buf.close()
        self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _spread(dense: np.ndarray, defined: np.ndarray, fill=0,
            arena: _Arena = _HOST) -> np.ndarray:
    """Scatter `dense` present-values into full-length rows (nulls =
    fill); `dense` itself when every row is present."""
    n = defined.shape[0]
    if dense.shape[0] == n:
        return dense
    out = arena.empty((n,) + dense.shape[1:], dense.dtype)
    out.fill(fill)
    out[defined != 0] = dense
    return out


def _assemble(leaf: _Leaf, values: np.ndarray, lengths: np.ndarray,
              defined: np.ndarray, n_rows: int, present: int,
              arena: _Arena = _HOST) -> Column:

    dt = leaf.dtype()
    validity = None
    # struct members: a required member under an optional ancestor still has
    # undefined rows (the ancestor was null) — its child column must carry
    # that validity so direct child consumers see nulls, like cudf; kind-4
    # elements likewise (null list/struct ancestors surface as def<max_def)
    nullable = (leaf.optional or getattr(leaf, "is_struct_member", False)
                or getattr(leaf, "kind", 0) == 4)
    if nullable and (defined == 0).any():
        valid = arena.empty(n_rows, np.bool_)
        np.not_equal(defined, 0, out=valid)
        validity = _t(valid)

    if dt.kind == dtypes.Kind.STRING:
        full_lens = _spread(lengths, defined)
        offsets = arena.empty(n_rows + 1, np.int32)
        offsets[0] = 0
        np.cumsum(full_lens, out=offsets[1:])
        return Column(dtype=dt, length=n_rows, data=_t(values),
                      offsets=_t(offsets), validity=validity)

    if dt.kind == dtypes.Kind.DECIMAL128:
        # FLBA big-endian two's-complement → (n, 4) uint32 LE limbs
        w = leaf.type_length
        raw = values.reshape(present, w)
        ext = np.zeros((present, 16), np.uint8)
        sign = (raw[:, 0] & 0x80) != 0
        ext[sign] = 0xFF
        ext[:, 16 - w:] = raw
        le = ext[:, ::-1].copy()                      # little-endian bytes
        limbs = le.view(np.uint32).reshape(present, 4)
        data = _t(_spread(limbs, defined, arena=arena))
        return Column(dtype=dt, length=n_rows, data=data, validity=validity)

    if leaf.phys == _PT_INT96:
        # 12-byte legacy timestamp: u64 nanos-of-day + u32 julian day
        raw = values.reshape(present, 12)
        nanos = raw[:, :8].copy().view(np.int64).reshape(present)
        jday = raw[:, 8:].copy().view(np.int32).reshape(present).astype(np.int64)
        micros = (jday - 2440588) * 86400_000_000 + nanos // 1000
        data = _t(_spread(micros, defined, arena=arena))
        return Column(dtype=dt, length=n_rows, data=data, validity=validity)

    np_dt = {dtypes.Kind.BOOL: np.uint8, dtypes.Kind.INT32: np.int32,
             dtypes.Kind.DATE32: np.int32, dtypes.Kind.DECIMAL32: np.int32,
             dtypes.Kind.INT64: np.int64, dtypes.Kind.TIMESTAMP_US: np.int64,
             dtypes.Kind.TIMESTAMP_MS: np.int64,
             dtypes.Kind.DECIMAL64: np.int64,
             dtypes.Kind.FLOAT32: np.float32,
             dtypes.Kind.FLOAT64: np.float64}[dt.kind]
    dense = values.view(np_dt) if dt.kind != dtypes.Kind.BOOL else values
    dense = dense.reshape(present)
    full = _spread(dense, defined, arena=arena)
    if dt.kind == dtypes.Kind.BOOL:
        full = full != 0
    return Column(dtype=dt, length=n_rows, data=_t(full),
                  validity=validity)


def _build_struct_tree(decoded, level: int, n_rows: int) -> Column:
    """decoded: [(leaf, element Column, def_levels)]; group by the path
    segment at `level` (level 0 is the struct column itself's name)."""

    first_leaf, _, first_defs = decoded[0]
    segs = first_leaf.name.split(".")
    # validity of THIS node (ancestor index level-1): -1 = required group
    thresh = first_leaf.ancestor_defs[level - 1]
    validity = None
    if thresh >= 0 and (first_defs < thresh).any():
        validity = _t(first_defs >= thresh)

    fields = {}
    for leaf, col, defs in decoded:
        parts = leaf.name.split(".")
        key = parts[level]
        if len(parts) == level + 1:
            fields[key] = col              # direct member
        else:                              # deeper nesting: recurse per key
            fields.setdefault(key, []).append((leaf, col, defs))
    out_fields = {}
    for key, val in fields.items():
        if isinstance(val, list):
            out_fields[key] = _build_struct_tree(val, level + 1, n_rows)
        else:
            out_fields[key] = val
    dt = dtypes.DType(dtypes.Kind.STRUCT,
                      children=tuple(c.dtype for c in out_fields.values()),
                      field_names=tuple(out_fields.keys()))
    return Column(dtype=dt, length=n_rows, validity=validity,
                  children=tuple(out_fields.values()))


class _NLeaf(NamedTuple):
    """One decoded leaf of a nested field: dense present values plus the
    full (def, rep) level streams."""
    leaf: "_Leaf"
    parts: List[str]          # dotted path segments
    values: np.ndarray
    lengths: np.ndarray
    defs: np.ndarray          # (slots,) int16
    reps: np.ndarray          # (slots,) int16
    present: int


def _build_nested(group: List[_NLeaf], ni: int, si: int,
                  ctxs: List[np.ndarray], depth: int) -> Column:
    """Multi-level Dremel reassembly (numpy over level slots, not rows).

    The classic level semantics: a slot with repetition level r continues
    the depth-r list, so it starts a new element at every depth > r; an
    element of the depth-k list exists iff rep <= k AND def >= dar_k (def
    below dar_k is an empty/null list placeholder). Offsets at each depth
    fall out of one boolean mask + np.add.reduceat over the parent entry
    boundaries; struct/list validity is one def-threshold compare. This is
    the whole reference cudf preprocess_levels pipeline as ~60 lines of
    vectorized host code.

    group: sibling leaves of one subtree (identical nodes[0..ni)).
    ni/si: next ancestry node / next unconsumed path segment.
    ctxs:  per-leaf slot indices of the current context entries (all the
           same logical entries, one index array per leaf's own stream).
    depth: repetition depth consumed so far (k of the next list = depth+1).
    """
    rep0 = group[0]
    nodes = rep0.leaf.nodes
    n_entries = len(ctxs[0])

    if ni == len(nodes):
        # element leaf
        assert len(group) == 1, [nl.leaf.name for nl in group]
        nl, ctx = group[0], ctxs[0]
        defined = (nl.defs[ctx] == nl.leaf.max_def).astype(np.uint8)
        return _assemble(nl.leaf, nl.values, nl.lengths, defined,
                         n_entries, int(defined.sum()))

    node = nodes[ni]
    if node.kind == "struct":
        validity = None
        if node.a >= 0:
            dv = rep0.defs[ctxs[0]] >= node.a
            if not dv.all():
                validity = _t(dv)
        fields: "OrderedDict[str, tuple]" = OrderedDict()
        for nl, ctx in zip(group, ctxs):
            key = nl.parts[si + node.segs]
            fields.setdefault(key, ([], []))
            fields[key][0].append(nl)
            fields[key][1].append(ctx)
        children = OrderedDict(
            (k, _build_nested(nls, ni + 1, si + node.segs, cx, depth))
            for k, (nls, cx) in fields.items())
        dt = dtypes.DType(dtypes.Kind.STRUCT,
                          children=tuple(c.dtype for c in children.values()),
                          field_names=tuple(children.keys()))
        return Column(dtype=dt, length=n_entries, validity=validity,
                      children=tuple(children.values()))

    # list node at repetition depth k
    k = depth + 1
    ctx0 = ctxs[0]
    elem_mask = (rep0.reps <= k) & (rep0.defs >= node.a)
    if n_entries:
        counts = np.add.reduceat(elem_mask.astype(np.int32), ctx0)
    else:
        counts = np.zeros(0, np.int32)
    offsets = np.zeros(n_entries + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    validity = None
    if node.b >= 0:
        dv = rep0.defs[ctx0] >= node.b
        if not dv.all():
            validity = _t(dv)
    new_ctxs = [np.nonzero((nl.reps <= k) & (nl.defs >= node.a))[0]
                for nl in group]
    child = _build_nested(group, ni + 1, si + node.segs, new_ctxs, k)
    return Column.make_list(_t(offsets), child, validity)


def _concat_tables(tables: List[Table]) -> Table:
    from ..ops.copying import concat_tables
    return concat_tables(tables)


def read_parquet(source: Union[str, bytes],
                 columns: Optional[Sequence[str]] = None,
                 row_groups: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None) -> Table:
    """Read a whole parquet file into a Table on `device` (None: the card;
    selective decode via `columns`, row-group selection via `row_groups` —
    stats-driven pruning composes through parquet_footer.read_footer_stats
    + select_row_groups; the reference flow's ParquetFooter.read_and_filter
    splice also still works upstream)."""
    with ParquetChunkedReader(source, columns=columns,
                              row_groups=row_groups, device=device) as r:
        return r.read_all()


# ---- stats-driven row-group pruning -----------------------------------------

def _proves_empty(st, op: str, val) -> bool:
    """True iff `col <op> val` matches NO row of a chunk with stats `st` —
    provable, never guessed: any missing/undecodable stat, any null in the
    chunk (null rows carry fill values the row-wise Filter above still
    sees), or any type mismatch returns False (keep the group)."""
    if st is None or st.min is None or st.max is None:
        return False
    if st.null_count != 0:          # None (unknown) or > 0: cannot prove
        return False
    if isinstance(val, str):
        val = val.encode()          # UTF8 stats order == byte order
    if isinstance(val, (bytes, bytearray)) != isinstance(st.min, bytes):
        return False
    try:
        if op == "<":
            return not st.min < val
        if op == "<=":
            return not st.min <= val
        if op == ">":
            return not st.max > val
        if op == ">=":
            return not st.max >= val
        if op == "==":
            return val < st.min or val > st.max
    except TypeError:
        return False
    return False


def select_row_groups(stats, conjuncts,
                      num_row_groups: int) -> Tuple[List[int], int]:
    """(kept row-group indices, pruned count) under min/max pruning.

    `conjuncts` is a list of (column, op, literal) triples that are ANDed
    above the scan (plan/optimizer.pruning_conjuncts extracts them); a
    group is dropped only when some conjunct PROVES it holds no matching
    row, so pruning is parity-exact with the retained Filter. `stats` of
    None (unparseable footer) keeps everything."""
    if stats is None or not conjuncts:
        return list(range(num_row_groups)), 0
    kept = []
    for rg in stats:
        if any(_proves_empty(rg.columns.get(name), op, val)
               for name, op, val in conjuncts):
            continue
        kept.append(rg.index)
    return kept, num_row_groups - len(kept)


class ParquetSource:
    """A parquet file/bytes source a plan `Scan` binds to INSTEAD of a
    materialized Table (`PlanBuilder.scan(..., parquet=...)`, or passed as
    an `inputs=` value at execute()). Schema is read from the footer at
    construction, so plans over sources validate at build time; data stays
    on disk until the executor streams it — the streamable prefix of a
    plan runs a chunk at a time (plan/executor.py), so bigger-than-budget tables
    feed the spill/admission machinery instead of materializing up front.
    """

    is_streaming_source = True

    def __init__(self, source: Union[str, bytes],
                 chunk_rows: Optional[int] = None):
        self.source = source
        self.chunk_rows = chunk_rows      # per-source override of
        #                                   SPARK_RAPIDS_TORCH_IO_CHUNK_ROWS
        # the schema only: nothing is decoded, so no device is involved
        with ParquetChunkedReader(source, device="cpu") as r:
            self.names = tuple(r.column_names)
            self.num_rows = int(r.num_rows)
            self.num_row_groups = int(r.num_row_groups)
            dts = {}
            for leaf in r._leaves:
                if leaf.display not in dts:
                    try:
                        dts[leaf.display] = leaf.dtype()
                    except TypeError:
                        dts[leaf.display] = None
            self._dtypes = dts
        self._stats = False               # lazy; None = unparseable footer

    def __repr__(self):
        name = self.source if isinstance(self.source, str) else "<bytes>"
        return (f"ParquetSource({name!r}, rows={self.num_rows}, "
                f"row_groups={self.num_row_groups})")

    @property
    def has_floats(self) -> bool:
        """Any floating column — gates reductions whose result depends on
        accumulation order (streaming partial aggregation, build_side)."""
        return any(dt is not None and dt.is_floating
                   for dt in self._dtypes.values())

    @property
    def stats(self):
        """Per-row-group footer statistics, read once; None when the footer
        stats cannot be parsed (pruning then keeps every group)."""
        if self._stats is False:
            from .parquet_footer import read_footer_stats
            try:
                self._stats = read_footer_stats(self.source)
            except Exception:
                self._stats = None
        return self._stats

    def select_groups(self, conjuncts=(),
                      columns: Optional[Sequence[str]] = None):
        """(kept group indices, pruned count, bytes skipped). Bytes skipped
        counts compressed column-chunk bytes never decoded: pruned groups
        entirely, plus non-projected columns of kept groups."""
        stats = self.stats
        kept, pruned = select_row_groups(stats, list(conjuncts or ()),
                                         self.num_row_groups)
        skipped = 0
        if stats is not None:
            sel = None if columns is None else set(columns)
            kept_set = set(kept)
            for rg in stats:
                for st in rg.columns.values():
                    if rg.index in kept_set and (sel is None
                                                 or st.column in sel):
                        continue
                    skipped += st.total_compressed_size
        return kept, pruned, skipped

    def chunks(self, columns: Optional[Sequence[str]] = None,
               row_groups: Optional[Sequence[int]] = None,
               chunk_rows: Optional[int] = None, pinned: bool = False):
        """Generator of chunks in host memory (page-locked with `pinned`):
        one decoded row group per chunk, split into <= chunk_rows slices
        when a bound is given. An empty selection yields the typed empty
        table once, so downstream operators always see the scan's schema.
        The reader's file closes when the generator closes."""
        from ..ops.copying import slice_table
        with ParquetChunkedReader(self.source, columns=columns,
                                  row_groups=row_groups, device="cpu") as r:
            if not r.has_next():
                yield r.read_all_host()   # typed empty (_empty_columns)
                return
            while r.has_next():
                t = r.read_chunk_host(_Arena(pinned))
                if chunk_rows and t.num_rows > chunk_rows:
                    for off in range(0, t.num_rows, chunk_rows):
                        yield slice_table(t, off,
                                          min(off + chunk_rows, t.num_rows))
                else:
                    yield t

    def read_all(self, columns: Optional[Sequence[str]] = None,
                 row_groups: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None) -> Table:
        """Materialize (a selection of) the source as one Table on
        `device`, through the admitted read path: the working-set estimate
        crosses the active DeviceSession's budget like any other op, so an
        over-budget materialization surfaces as the arbiter's OOM contract
        instead of an allocator crash."""
        from ..io import read_parquet as admitted_read
        return admitted_read(self.source, columns=columns,
                             row_groups=row_groups, device=device)
