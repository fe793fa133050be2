"""Hash-join build/probe over fixed-width keys: CUDA kernels and their plain
PyTorch versions.

Counterpart of `spark_rapids_tpu/ops/join_pallas.py`. The kernels live in
`csrc/hash_join.cu` (its header says what each computes and what bounds it
on the card); this module binds them through ctypes and keeps, beside each,
a plain PyTorch version of the same function:

- `build_table`: the open-addressing table over the build keys, filled by
  min-row-id insertion rounds (equal keys in ascending-row chain order).
  Two routes by capacity: up to SMALL_CAPACITY slots one block builds it
  in shared memory; above, a cooperative grid builds it in global memory,
  one grid-wide barrier a round, as one 8-byte word a slot (`HashTable.ent`,
  hash << 32 | row) that the large route's probes read where it lies;
- `probe_counts`: matches per probe row, walking to the first empty slot,
  with the sums of each tile of `TILE` rows, their exclusive offsets and
  the total, and per segment (an eighth of a tile) its list of matched
  rows, each with its first matching slot and its count (`ProbeCounts`),
  in 32 bits on the small route and 64 on the large one;
- `probe_emit`: the (probe row, build row) pairs from those lists, a row's
  first at its tile's offset plus the counts before it in its tile.

Each wrapper runs the plain version only for CPU tensors. For CUDA tensors
it launches its kernel or raises; it never falls back. `LAUNCHES` counts
kernel launches and `PLAIN_CALLS` the plain version's runs, per wrapper.

The plain versions hash with the row hash's own murmur3 (`hash.py`, unsigned
32-bit math in int64 with a mask after every step).

`inner_join_hash` is the counterpart of `inner_join_pallas`: int32 gather
maps, pair for pair those of `ops.join.inner_join`. Between count and emit
it reads the total (the one host sync) and computes nothing over the probe
rows. It is registered as `hash_join`/"cuda" for backend "cuda" and
declines what the reference's `_supports` declines (non-inner joins,
mismatched or unsupported key kinds) and build sides over `MAX_BUILD` rows.
The reference declines above 512 build rows, the table its VMEM holds;
the port's large route takes up to 2^22 (a 2^23-slot, 64 MB table).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from .hash import as_i32_bits, mm_column
from .join import _cols, _side_valid

SMALL_CAPACITY = 1024       # the small route's tables (csrc/hash_join.cu)
MAX_CAPACITY = 1 << 23      # the large route's: 64 MB of 8-byte slots
MAX_BUILD = MAX_CAPACITY // 2   # build rows the kernels take
_MAX_KEYS = 32      # key columns the kernels take (csrc/hash_join.cu)
TILE = 2048         # probe rows a tile: csrc/hash_join.cu PROBE_TILE
_SEED = 42
_M32 = 0xFFFFFFFF

_SUPPORTED_KINDS = frozenset(k.value for k in (
    Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.DATE32,
    Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64))
# decimals hash as longs (Spark), so DECIMAL32 is 8-byte despite its storage
_WIDE_KINDS = (Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64)

LAUNCHES = {"build": 0, "count": 0, "emit": 0}
# the launches of LAUNCHES that took the large route (C > SMALL_CAPACITY)
LARGE_LAUNCHES = {"build": 0, "count": 0, "emit": 0}
PLAIN_CALLS = {"build": 0, "count": 0, "emit": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, LARGE_LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _capacity(n_build: int) -> int:
    c = 256
    while c < 2 * n_build:
        c *= 2
    return c


def is_large(C: int) -> bool:
    """Whether a table of C slots takes the large route."""
    return C > SMALL_CAPACITY


@dataclasses.dataclass
class HashTable:
    """slot_row: (C,) int32 build row id, -1 where empty. slot_hash: (C,)
    int32 holding the bits of that row's u32 bucket hash (0 where empty).
    The large build writes `ent`, (C,) int64 words hash << 32 | row (the
    row's low 32 bits), and slot_row and slot_hash are views of it; `rounds`
    is its () int32 count of insertion rounds, on the device."""
    slot_row: torch.Tensor
    slot_hash: torch.Tensor
    ent: Optional[torch.Tensor] = None
    rounds: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return int(self.slot_row.shape[0])

    def packed(self) -> torch.Tensor:
        """(C,) int64 words hash << 32 | row, as the large probes read."""
        if self.ent is not None:
            return self.ent
        return (self.slot_hash.to(torch.int64) << 32) \
            | (self.slot_row.to(torch.int64) & _M32)


def _wide(cols: Sequence[Column]) -> List[bool]:
    return [c.dtype.kind in _WIDE_KINDS for c in cols]


def row_hash(cols: Sequence[Column]) -> torch.Tensor:
    """(n,) int64 in [0, 2^32): the bucket hash of every row, seed 42
    chained over the key columns (the reference's `_mm_hash`): Spark
    murmur3_32 as the row hash computes it, validity ignored."""
    n = cols[0].length
    h = torch.full((n,), _SEED, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = mm_column(h, c)
    return h


def _keys_equal(pcols, i, bcols, r) -> torch.Tensor:
    eq = torch.ones(i.shape[0], dtype=torch.bool, device=i.device)
    for p, b in zip(pcols, bcols):
        eq &= p.data.index_select(0, i) == b.data.index_select(0, r)
    return eq


def build_table_plain(bcols: Sequence[Column], C: int) -> HashTable:
    n = bcols[0].length
    dev = bcols[0].device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    h = row_hash(bcols)
    slot_row = torch.full((C,), -1, dtype=torch.int64, device=dev)
    slot_hash = torch.zeros(C, dtype=torch.int64, device=dev)
    d = torch.zeros(n, dtype=torch.int64, device=dev)
    placed = ~_side_valid(bcols, n, dev)        # invalid rows never insert
    for _ in range(2 * C + 2):
        un = ~placed
        if not bool(un.any()):
            break
        slot = (h + d) & (C - 1)
        proposal = torch.full((C,), n, dtype=torch.int64, device=dev)
        proposal.scatter_reduce_(0, slot[un], rows[un], "amin")
        won = un & (slot_row.index_select(0, slot) < 0) \
            & (proposal.index_select(0, slot) == rows)
        slot_row[slot[won]] = rows[won]
        slot_hash[slot[won]] = h[won]
        placed = placed | won
        d = d + (~placed).to(torch.int64)
    return HashTable(slot_row.to(torch.int32), as_i32_bits(slot_hash))


def _walk(pcols, rows, h, table: HashTable, bcols):
    """Yield per chain step the (probe-row mask, build rows, slots) of
    matches for `rows` (probe row ids with hashes `h`), in chain order."""
    C = table.capacity
    srow = table.slot_row.to(torch.int64)
    shash = table.slot_hash.to(torch.int64) & _M32
    active = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    for d in range(C + 1):
        if not bool(active.any()):
            return
        s = (h + d) & (C - 1)
        r = srow.index_select(0, s)
        active = active & (r >= 0)
        rr = r.clamp(min=0)
        match = active & (shash.index_select(0, s) == h) \
            & _keys_equal(pcols, rows, bcols, rr)
        yield match, rr, s


# a matched row's entry in its segment's list (csrc/hash_join.cu): its row
# in the tile, its first matching slot and its count, in 11, 10 and 11 bits
# of an int32 on the small route, in 11, 23 and 30 bits of an int64 on the
# large one
_SLOT_SHIFT = 11
_COUNT_SHIFT = 21
_WIDE_COUNT_SHIFT = 34
SEGMENTS = 8        # a tile's segments: one a warp of the kernels' blocks


@dataclasses.dataclass
class ProbeCounts:
    """What the probe count gives the emit, all on the probe's device.

    counts: (n,) int32 matches per probe row. Per tile of `tile` rows:
    tile_sums (tiles,) int64, its counts summed; tile_offsets (tiles,)
    int64, their exclusive prefix. A tile is SEGMENTS segments of `tile //
    SEGMENTS` rows; per segment: seg_sums (segs,) int32, its counts summed;
    seg_matched (segs,) int32, its rows with a match. entries: (n,),
    segment k's matched rows in ascending order from its first row on, each
    as its row in the tile | its first matching slot << 11 | its count <<
    21 in an int32, or << 34 in an int64 on the large route (past a
    segment's matched rows the values are not defined). total:
    () int64, every count summed; the caller reads it (the one host sync)
    to size the emit."""
    counts: torch.Tensor
    tile_sums: torch.Tensor
    tile_offsets: torch.Tensor
    seg_sums: torch.Tensor
    seg_matched: torch.Tensor
    entries: torch.Tensor
    total: torch.Tensor
    tile: int

    @property
    def seg(self) -> int:
        return self.tile // SEGMENTS


def _count_shift(C: int) -> int:
    return _WIDE_COUNT_SHIFT if is_large(C) else _COUNT_SHIFT


def _entry_dtype(C: int) -> torch.dtype:
    return torch.int64 if is_large(C) else torch.int32


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


def _tiled(x: torch.Tensor, tile: int) -> torch.Tensor:
    """(tiles, tile) int64 copy of the (n,) values, zero past the last."""
    n = x.shape[0]
    padded = torch.zeros(_tiles(n, tile) * tile, dtype=torch.int64,
                         device=x.device)
    padded[:n] = x
    return padded.view(-1, tile)


def probe_counts_plain(pcols, table: HashTable, bcols,
                       tile: int = TILE) -> ProbeCounts:
    if tile % SEGMENTS or not 1 <= tile <= 1 << _SLOT_SHIFT:
        raise ValueError(f"tiles of a multiple of {SEGMENTS} rows up to "
                         f"{1 << _SLOT_SHIFT}, got {tile}")
    n = pcols[0].length
    dev = pcols[0].device
    rows = torch.nonzero(_side_valid(pcols, n, dev)).reshape(-1)
    h = row_hash(pcols).index_select(0, rows)
    c = torch.zeros(rows.shape[0], dtype=torch.int32, device=dev)
    first = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    for match, _, slot in _walk(pcols, rows, h, table, bcols):
        first = torch.where(match & (c == 0), slot, first)
        c += match.to(torch.int32)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    counts[rows] = c
    slots = torch.zeros(n, dtype=torch.int64, device=dev)
    slots[rows] = first
    sums = _tiled(counts, tile).sum(1)
    # segment k's list: its matched rows in order, from its first row on
    seg = tile // SEGMENTS
    cs = _tiled(counts, seg)
    hit = cs > 0
    in_tile = torch.arange(cs.numel(), dtype=torch.int64,
                           device=dev).view_as(cs) % tile
    words = in_tile | (_tiled(slots, seg) << _SLOT_SHIFT) \
        | (cs << _count_shift(table.capacity))
    dest = torch.arange(0, cs.numel(), seg, dtype=torch.int64,
                        device=dev)[:, None] + torch.cumsum(hit, 1) - 1
    edt = _entry_dtype(table.capacity)
    entries = torch.zeros(cs.numel(), dtype=edt, device=dev)
    entries[dest[hit]] = words[hit].to(edt)
    return ProbeCounts(counts, sums, torch.cumsum(sums, 0) - sums,
                       cs.sum(1).to(torch.int32),
                       hit.sum(1).to(torch.int32), entries[:n], sums.sum(),
                       tile)


def probe_emit_plain(pcols, table: HashTable, bcols, probe: ProbeCounts,
                     total: int):
    """The pairs from the count's lists: an entry's first pair goes to its
    tile's offset, plus the counts of the entries before it in the tile
    (the lists of its earlier segments, then its own); it walks from its
    first matching slot, taking the slots whose hash and keys equal that
    slot's build row's, until its count."""
    dev = pcols[0].device
    n, tile, seg, C = pcols[0].length, probe.tile, probe.seg, \
        table.capacity
    at = torch.arange(n, dtype=torch.int64, device=dev)
    listed = (at % seg) < probe.seg_matched.index_select(0, at // seg)
    w = probe.entries[listed].to(torch.int64)
    tl = at[listed] // tile
    rows = tl * tile + (w & ((1 << _SLOT_SHIFT) - 1))
    shift = _count_shift(C)
    s0 = (w >> _SLOT_SHIFT) & ((1 << (shift - _SLOT_SHIFT)) - 1)
    cnt = w >> shift
    # the counts of the entries before each, in its tile
    before = torch.cumsum(cnt, 0) - cnt
    tile_matched = _tiled(probe.seg_matched, SEGMENTS).sum(1)
    tile_first = torch.cumsum(tile_matched, 0) - tile_matched
    pos = probe.tile_offsets.index_select(0, tl) + before \
        - before.index_select(0, tile_first.index_select(0, tl))
    srow = table.slot_row.to(torch.int64)
    shash = table.slot_hash.to(torch.int64) & _M32
    r0 = srow.index_select(0, s0)
    h0 = shash.index_select(0, s0)
    out_l = torch.empty(total, dtype=torch.int32, device=dev)
    out_r = torch.empty(total, dtype=torch.int32, device=dev)
    done = torch.zeros_like(cnt)
    active = torch.ones_like(cnt, dtype=torch.bool)
    for d in range(C):
        active = active & (done < cnt)
        if not bool(active.any()):
            break
        s = (s0 + d) & (C - 1)
        r = srow.index_select(0, s)
        active = active & (r >= 0)
        rr = r.clamp(min=0)
        take = active & (shash.index_select(0, s) == h0) \
            & _keys_equal(bcols, r0, bcols, rr)
        out_l[pos[take]] = rows[take].to(torch.int32)
        out_r[pos[take]] = rr[take].to(torch.int32)
        pos += take.to(torch.int64)
        done += take.to(torch.int64)
    return out_l, out_r


# ---- the CUDA kernels --------------------------------------------------------

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_KEY_ARGS = [_PP, _PP, _PI, _PI, ctypes.c_int, ctypes.c_longlong]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("hash_join")
        lib.hj_build.argtypes = _KEY_ARGS + [ctypes.c_int, _P, _P, _P]
        lib.hj_build_large.argtypes = _KEY_ARGS + [ctypes.c_int, _P, _P, _P]
        lib.hj_barrier.argtypes = [ctypes.c_longlong, ctypes.c_int, _P, _P]
        lib.hj_count.argtypes = _KEY_ARGS + [_PP, _P, _P, _P, ctypes.c_int,
                                             _P, _P, _P, _P, _P]
        lib.hj_emit.argtypes = [_PP, _PI, _PI, ctypes.c_int,
                                ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                                _P, _P, _P, _P, _P, _P, _P]
        for fn in (lib.hj_build, lib.hj_build_large, lib.hj_barrier,
                   lib.hj_count, lib.hj_emit):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda(cols: Sequence[Column], dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"hash-join kernels run on CUDA tensors, got {dev}")
    if not 1 <= len(cols) <= _MAX_KEYS:
        raise ValueError(f"hash-join kernels take 1..{_MAX_KEYS} key columns, "
                         f"got {len(cols)}")
    for c in cols:
        if c.dtype.kind.value not in _SUPPORTED_KINDS:
            raise TypeError(f"hash-join kernels do not take {c.dtype!r} keys")
        if c.device != dev or not c.data.is_contiguous() or (
                c.validity is not None and not c.validity.is_contiguous()):
            raise ValueError("hash-join key columns must be contiguous and "
                             f"on {dev}")


def _check_probe(pcols, bcols, dev: torch.device) -> None:
    _check_cuda(pcols, dev)
    _check_cuda(bcols, dev)
    if [c.dtype.kind for c in pcols] != [c.dtype.kind for c in bcols]:
        raise TypeError("probe and build key kinds differ")


def _key_arrays(cols: Sequence[Column]):
    nk = len(cols)
    data = (ctypes.c_void_p * nk)(*[c.data.data_ptr() for c in cols])
    valid = (ctypes.c_void_p * nk)(*[
        None if c.validity is None else c.validity.data_ptr()
        for c in cols])
    width = (ctypes.c_int * nk)(*[c.data.element_size() for c in cols])
    wide = (ctypes.c_int * nk)(*[int(w) for w in _wide(cols)])
    return [data, valid, width, wide, nk, cols[0].length]


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _table_ptrs(table: HashTable):
    """(slot_row, slot_hash, ent) pointers for the probes: the small route
    reads the first two, the large one the packed words."""
    if is_large(table.capacity):
        return None, None, table.packed().data_ptr()
    return table.slot_row.data_ptr(), table.slot_hash.data_ptr(), None


def build_table_cuda(bcols: Sequence[Column], C: int) -> HashTable:
    dev = bcols[0].device
    _check_cuda(bcols, dev)
    n = bcols[0].length
    if n > MAX_BUILD:
        raise ValueError(f"build side of {n} rows exceeds "
                         f"MAX_BUILD={MAX_BUILD}")
    keys = _key_arrays(bcols)
    if not is_large(C):
        slot_row = torch.empty(C, dtype=torch.int32, device=dev)
        slot_hash = torch.empty(C, dtype=torch.int32, device=dev)
        rc = _lib().hj_build(*keys, C, slot_row.data_ptr(),
                             slot_hash.data_ptr(), _stream(dev))
        _raise_on(rc, "hash-join build kernel")
        LAUNCHES["build"] += 1
        return HashTable(slot_row, slot_hash)
    ent = torch.empty(C, dtype=torch.int64, device=dev)
    # the rows' hashes and distances, then four counters: the proposals of
    # rounds r mod 3 and the rounds
    scratch = torch.empty(2 * n + 4, dtype=torch.int32, device=dev)
    rc = _lib().hj_build_large(*keys, C, ent.data_ptr(), scratch.data_ptr(),
                               _stream(dev))
    _raise_on(rc, "hash-join large build kernel")
    LAUNCHES["build"] += 1
    LARGE_LAUNCHES["build"] += 1
    halves = ent.view(torch.int32).view(C, 2)      # little-endian: row, hash
    return HashTable(halves[:, 0], halves[:, 1], ent, scratch[2 * n + 3])


def barrier_cuda(rows: int, rounds: int) -> torch.Tensor:
    """`rounds` grid-wide barriers alone, on the grid the large build takes
    for `rows` rows (a measurement for the build's bound, not a step of the
    join). Returns a () int32 tensor that holds `rounds` once it ran."""
    out = torch.zeros((), dtype=torch.int32, device="cuda")
    rc = _lib().hj_barrier(rows, rounds, out.data_ptr(),
                           _stream(out.device))
    _raise_on(rc, "grid barrier kernel")
    return out


def probe_counts_cuda(pcols, table: HashTable, bcols) -> ProbeCounts:
    dev = pcols[0].device
    _check_probe(pcols, bcols, dev)
    n = pcols[0].length
    C = table.capacity
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    entries = torch.empty(n, dtype=_entry_dtype(C), device=dev)
    tiles, segs = _tiles(n, TILE), _tiles(n, TILE // SEGMENTS)
    seg = torch.empty(2 * segs, dtype=torch.int32, device=dev)
    # one int64 buffer: the total, the last block's ticket (zeroed by the
    # kernel's entry point on the stream), the tiles' sums and offsets
    scratch = torch.empty(2 + 2 * tiles, dtype=torch.int64, device=dev)
    probe = ProbeCounts(counts, scratch[2:2 + tiles], scratch[2 + tiles:],
                        seg[:segs], seg[segs:], entries, scratch[0], TILE)
    if n == 0:
        scratch.zero_()
        return probe
    bdata = _key_arrays(bcols)[0]
    rc = _lib().hj_count(*_key_arrays(pcols), bdata, *_table_ptrs(table), C,
                         counts.data_ptr(), entries.data_ptr(),
                         seg.data_ptr(), scratch.data_ptr(), _stream(dev))
    _raise_on(rc, "hash-join probe-count kernel")
    LAUNCHES["count"] += 1
    if is_large(C):
        LARGE_LAUNCHES["count"] += 1
    return probe


def probe_emit_cuda(pcols, table: HashTable, bcols, probe: ProbeCounts,
                    total: int):
    dev = pcols[0].device
    _check_probe(pcols, bcols, dev)
    n = pcols[0].length
    C = table.capacity
    segs = _tiles(n, TILE // SEGMENTS)
    shapes = ((probe.entries, _entry_dtype(C), n),
              (probe.seg_sums, torch.int32, segs),
              (probe.seg_matched, torch.int32, segs),
              (probe.tile_offsets, torch.int64, _tiles(n, TILE)))
    if probe.tile != TILE or any(
            t.dtype != dtype or tuple(t.shape) != (size,) or t.device != dev
            or not t.is_contiguous() for t, dtype, size in shapes):
        raise TypeError(f"emit takes the count kernel's {TILE}-row tiles: "
                        "contiguous (n,) entries (int32, int64 on the large "
                        "route), (segs,) int32 sums and matched rows, "
                        "(tiles,) int64 offsets, on the probe's device")
    # `total` must be probe.total (the caller's one host sync): the kernel
    # writes a tile's pairs at its offset .. offset + its sum - 1
    out_l = torch.empty(total, dtype=torch.int32, device=dev)
    out_r = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return out_l, out_r
    data, _, width, wide, nk, _ = _key_arrays(bcols)
    rc = _lib().hj_emit(data, width, wide, nk, n, *_table_ptrs(table), C,
                        *[t.data_ptr() for t, _, _ in shapes],
                        out_l.data_ptr(), out_r.data_ptr(), _stream(dev))
    _raise_on(rc, "hash-join probe-emit kernel")
    LAUNCHES["emit"] += 1
    if is_large(C):
        LARGE_LAUNCHES["emit"] += 1
    return out_l, out_r


# ---- wrappers: plain version on CPU tensors, the kernel on CUDA ones --------

def build_table(bcols: Sequence[Column], C: int) -> HashTable:
    if bcols[0].device.type == "cpu":
        PLAIN_CALLS["build"] += 1
        return build_table_plain(bcols, C)
    return build_table_cuda(bcols, C)


def probe_counts(pcols, table: HashTable, bcols) -> ProbeCounts:
    if pcols[0].device.type == "cpu":
        PLAIN_CALLS["count"] += 1
        return probe_counts_plain(pcols, table, bcols)
    return probe_counts_cuda(pcols, table, bcols)


def probe_emit(pcols, table: HashTable, bcols, probe: ProbeCounts,
               total: int):
    if pcols[0].device.type == "cpu":
        PLAIN_CALLS["emit"] += 1
        return probe_emit_plain(pcols, table, bcols, probe, total)
    return probe_emit_cuda(pcols, table, bcols, probe, total)


def inner_join_hash(left_keys, right_keys) -> Tuple[Column, Column]:
    """Inner equi-join via hash build/probe: gather maps (left_map,
    right_map), pair for pair those of `ops.join.inner_join`."""
    lcols, rcols = _cols(left_keys), _cols(right_keys)
    if len(lcols) != len(rcols) or not lcols:
        raise ValueError("join requires equal, nonzero key column counts")
    for a, b in zip(lcols, rcols):
        if a.dtype.kind != b.dtype.kind:
            raise TypeError(f"join key kinds differ: {a.dtype!r} vs "
                            f"{b.dtype!r}")
    nl, nr = lcols[0].length, rcols[0].length
    dev = lcols[0].device

    def empty():
        e = torch.zeros(0, dtype=torch.int32, device=dev)
        return Column(dtypes.INT32, 0, e), Column(dtypes.INT32, 0, e)

    if nl == 0 or nr == 0:
        return empty()
    table = build_table(rcols, _capacity(nr))
    probe = probe_counts(lcols, table, rcols)
    total = int(probe.total)                   # the one host sync
    if total == 0:
        return empty()
    lmap, rmap = probe_emit(lcols, table, rcols, probe, total)
    return (Column(dtypes.INT32, total, lmap),
            Column(dtypes.INT32, total, rmap))


# ---- registry wiring ---------------------------------------------------------

def make_signature(lcols: Sequence[Column], rcols: Sequence[Column],
                   how: str, tier: str):
    from .registry import Signature
    kinds_match = all(a.dtype.kind == b.dtype.kind
                      for a, b in zip(lcols, rcols))
    return Signature.of(list(lcols) + list(rcols), how=how, tier=tier,
                        kinds_match=kinds_match,
                        build_rows=rcols[0].length if rcols else 0)


def _supports(sig) -> bool:
    return (sig.extra("how") == "inner"
            and sig.extra("tier") in ("eager", "capped")
            and bool(sig.extra("kinds_match"))
            and (sig.extra("build_rows") or 0) <= MAX_BUILD
            and all(k in _SUPPORTED_KINDS for k in sig.kinds))


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("hash_join", "torch", fallback=True)
_REGISTRY.register("hash_join", "cuda", fn=inner_join_hash,
                   backends=("cuda",), supports=_supports)
