"""Hash-join build/probe: CUDA kernels and their plain PyTorch versions.

Counterpart of `spark_rapids_tpu/ops/join_pallas.py`. The kernels live in
`csrc/hash_join.cu` (its header says what each computes and what bounds it
on the card); this module binds them through ctypes and keeps, beside each,
a plain PyTorch version of the same function:

- `build_table`: the open-addressing table over the build keys that the
  reference's min-row-id insertion rounds leave (equal keys in
  ascending-row chain order). The plain version runs those rounds; the
  kernels compute the same table without them, by the closed form that
  `build_table_closed_form` spells out in PyTorch (bucket counts, one scan,
  each bucket's rows in order, a search back per slot). Two routes by
  capacity: up to SMALL_CAPACITY slots one block builds it in shared
  memory; above, six ordinary launches build it in global memory as one
  8-byte word a slot (`HashTable.ent`, hash << 32 | row) that the large
  route's probes read where it lies;
- `probe_counts`: matches per probe row, walking to the first empty slot,
  with the sums of each tile of `TILE` rows, their exclusive offsets and
  the total, and per segment (an eighth of a tile) its list of matched
  rows, each with its first matching slot and its count (`ProbeCounts`),
  in 32 bits on the small route and 64 on the large one;
- `probe_emit`: the (probe row, build row) pairs from those lists, a row's
  first at its tile's offset plus the counts before it in its tile;
- `probe_exists`: whether each probe row has a match (the count's walk,
  stopping at the first), the semi and anti joins' probe;
- `probe_capped`: the capped tier's inner join after the build, the
  (row_cap,) maps, `valid` and `overflow` in one launch.

Each wrapper runs the plain version only for CPU tensors. For CUDA tensors
it launches its kernel or raises; it never falls back. `LAUNCHES` counts
kernel launches and `PLAIN_CALLS` the plain version's runs, per wrapper.

The plain versions hash with the row hash's own murmur3 (`hash.py`, unsigned
32-bit math in int64 with a mask after every step).

Keys are fixed-width integers, floats, DECIMAL128 or STRING. A key set with
a float, DECIMAL128 or STRING column takes the kernels' variable-width
instantiation (the `_var` entry points), so the integer joins keep their
code: a float hashes and compares by its bits normalized as
`sort._float_total_order` normalizes them (0.0 matches -0.0, NaN matches
NaN, as in the sort-based join), a DECIMAL128 by its four limbs, a STRING
by Spark's murmur3 of its bytes and then its length and bytes.

`inner_join_hash` is the counterpart of `inner_join_pallas`: int32 gather
maps, pair for pair those of `ops.join.inner_join`. Between count and emit
it reads the total (the one host sync) and computes nothing over the probe
rows. `inner_join_capped_hash` is the counterpart of
`inner_join_capped_pallas`, the capped tier's join, with no host read:
the build over the live build rows (the kernels read `ralive` beside the
keys' validity), then `probe_capped`, one launch that reads `lalive` the
same way, finds each tile's offset on the card (a decoupled look-back),
writes the pairs below `row_cap` and then every slot of the maps, `valid`
and `overflow` itself; bit for bit the outputs of
`ops.join.inner_join_capped`. `probe_capped_plain` is its CPU mirror.
`semi_join_mask_hash` (the capped tier's
semi and anti joins) and `left_semi_join_hash` / `left_anti_join_hash`
(the eager tier's) are `ops.join`'s `semi_join_mask`, `left_semi_join` and
`left_anti_join` on the build and the existence probe, bit for bit; the
reference has no kernel for them. `inner_join_hash` is registered as
`hash_join`/"cuda" for backend "cuda" and
declines what the reference's `_supports` declines (outer joins,
mismatched or unsupported key kinds) but for semi and anti joins, and
build sides over `MAX_BUILD` rows.
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
from .hash import (Bytes, _M32, _mm_fmix, _mm_round, _mm_value, as_i32_bits,
                   encode_fixed, mm_bytes, mm_column)
from .join import _cols, _keep, _side_valid

SMALL_CAPACITY = 1024       # the small route's tables (csrc/hash_join.cu)
MAX_CAPACITY = 1 << 23      # the large route's: 64 MB of 8-byte slots
MAX_BUILD = MAX_CAPACITY // 2   # build rows the kernels take
_MAX_KEYS = 32      # key columns the kernels take (csrc/hash_join.cu)
TILE = 2048         # probe rows a tile: csrc/hash_join.cu PROBE_TILE
_SEED = 42

_SUPPORTED_KINDS = frozenset(k.value for k in (
    Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.DATE32,
    Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64,
    Kind.FLOAT32, Kind.FLOAT64, Kind.DECIMAL128, Kind.STRING))
# decimals hash as longs (Spark), so DECIMAL32 is 8-byte despite its storage
_WIDE_KINDS = (Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64,
               Kind.FLOAT64)
# the variable-width instantiation's key kinds (csrc/hash_join.cu VK_*)
VK_FIXED, VK_F32, VK_F64, VK_DEC128, VK_STRING = range(5)
_VAR_KINDS = {Kind.FLOAT32: VK_F32, Kind.FLOAT64: VK_F64,
              Kind.DECIMAL128: VK_DEC128, Kind.STRING: VK_STRING}

# "capped": the capped probe (`probe_capped`), one launch a capped join
LAUNCHES = {"build": 0, "count": 0, "emit": 0, "exists": 0, "capped": 0}
# the launches of LAUNCHES that took the large route (C > SMALL_CAPACITY)
LARGE_LAUNCHES = {"build": 0, "count": 0, "emit": 0, "exists": 0,
                  "capped": 0}
# the launches of LAUNCHES of the variable-width instantiation (`is_var`)
VAR_LAUNCHES = {"build": 0, "count": 0, "emit": 0, "exists": 0, "capped": 0}
PLAIN_CALLS = {"build": 0, "count": 0, "emit": 0, "exists": 0, "capped": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, LARGE_LAUNCHES, VAR_LAUNCHES, PLAIN_CALLS):
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
    row's low 32 bits), and slot_row and slot_hash are views of it.
    `rounds`, a () int32 on the device, is the count of insertion rounds
    that the reference runs for this table (1 + the largest distance of a
    placed row, 0 with none): the plain version's and the large build's
    (the small build leaves it None)."""
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


def is_var(cols: Sequence[Column]) -> bool:
    """Whether the key set takes the variable-width instantiation."""
    return any(c.dtype.kind in _VAR_KINDS for c in cols)


def _string_bytes(c: Column) -> Bytes:
    return Bytes(c.data, c.offsets[:-1], c.string_lengths())


def row_hash(cols: Sequence[Column]) -> torch.Tensor:
    """(n,) int64 in [0, 2^32): the bucket hash of every row, seed 42
    chained over the key columns (the reference's `_mm_hash`): Spark
    murmur3_32 as the row hash computes it for integers and strings, of the
    normalized bits for floats, of the four limbs for DECIMAL128; validity
    ignored."""
    n = cols[0].length
    h = torch.full((n,), _SEED, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        k = c.dtype.kind
        if k == Kind.STRING:
            h = mm_bytes(h, _string_bytes(c))
        elif k == Kind.DECIMAL128:
            limbs = c.data.view(torch.int32).to(torch.int64) & _M32
            for j in range(4):
                h = _mm_round(h, limbs[:, j])
            h = _mm_fmix(h ^ 16)
        elif c.dtype.is_floating:
            h = _mm_value(h, *encode_fixed(c, normalize_zero=True))
        else:
            h = mm_column(h, c)
    return h


def _key_values(c: Column, i: torch.Tensor) -> torch.Tensor:
    """Rows i of a fixed-width key as compared: a float by its normalized
    bits, DECIMAL128 as its (m, 4) limbs."""
    if c.dtype.is_floating:
        return encode_fixed(c, normalize_zero=True)[0].index_select(0, i)
    if c.dtype.kind == Kind.DECIMAL128:
        return c.data.view(torch.int32).index_select(0, i)
    return c.data.index_select(0, i)


def _strings_equal(p: Column, i: torch.Tensor, b: Column,
                   r: torch.Tensor) -> torch.Tensor:
    pb, bb = _string_bytes(p).take(i), _string_bytes(b).take(r)
    eq = pb.length == bb.length
    for k in range(max(pb.max_length(), 0)):
        pos = torch.full_like(pb.length, k)
        eq &= (pos >= pb.length) | (pb.byte(pos) == bb.byte(pos))
    return eq


def _keys_equal(pcols, i, bcols, r) -> torch.Tensor:
    eq = torch.ones(i.shape[0], dtype=torch.bool, device=i.device)
    for p, b in zip(pcols, bcols):
        if p.dtype.kind == Kind.STRING:
            eq &= _strings_equal(p, i, b, r)
            continue
        same = _key_values(p, i) == _key_values(b, r)
        eq &= same.all(1) if same.dim() == 2 else same
    return eq


def _insertable(bcols: Sequence[Column], alive) -> torch.Tensor:
    """The build rows the table holds: every key valid, and live where the
    capped tier passes `alive`."""
    v = _side_valid(bcols, bcols[0].length, bcols[0].device)
    return v if alive is None else v & alive


def build_table_plain(bcols: Sequence[Column], C: int,
                      alive=None) -> HashTable:
    n = bcols[0].length
    dev = bcols[0].device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    h = row_hash(bcols)
    slot_row = torch.full((C,), -1, dtype=torch.int64, device=dev)
    slot_hash = torch.zeros(C, dtype=torch.int64, device=dev)
    d = torch.zeros(n, dtype=torch.int64, device=dev)
    placed = ~_insertable(bcols, alive)    # invalid, dead rows never insert
    rounds = 0
    for _ in range(2 * C + 2):
        un = ~placed
        if not bool(un.any()):
            break
        rounds += 1
        slot = (h + d) & (C - 1)
        proposal = torch.full((C,), n, dtype=torch.int64, device=dev)
        proposal.scatter_reduce_(0, slot[un], rows[un], "amin")
        won = un & (slot_row.index_select(0, slot) < 0) \
            & (proposal.index_select(0, slot) == rows)
        slot_row[slot[won]] = rows[won]
        slot_hash[slot[won]] = h[won]
        placed = placed | won
        d = d + (~placed).to(torch.int64)
    return HashTable(slot_row.to(torch.int32), as_i32_bits(slot_hash),
                     rounds=torch.tensor(rounds, dtype=torch.int32,
                                         device=dev))


def build_table_closed_form(bcols: Sequence[Column], C: int,
                            alive=None) -> HashTable:
    """`build_table_plain`'s table and rounds without its rounds, in the
    kernels' order of work (csrc/hash_join.cu, "the build"): per bucket
    s = h & (C - 1) its valid rows cnt[s]; one scan of the slots' maps
    x -> max(x + cnt[s] - 1, 0), taken twice round the ring, giving rem[s],
    the rows still waiting after slot s, and the bucket offsets; each
    bucket's rows in ascending order; then per occupied slot s (rem[s-1] +
    cnt[s] > 0) the search back to the last slot x with rem[x] <= rem[s]:
    its row is bucket x + 1's row at index cnt - 1 - (rem[s] - rem[x])."""
    n = bcols[0].length
    dev = bcols[0].device
    h = row_hash(bcols)
    valid = _insertable(bcols, alive)
    bucket = h & (C - 1)
    cnt = torch.bincount(bucket[valid], minlength=C)
    # the inclusive composition of the maps (cnt - 1, 0): p is their sum,
    # q the largest sum of a suffix (0 for the empty one)
    p = torch.cumsum(cnt - 1, 0)
    q = p - torch.cummin(p, 0).values
    tp, tq = int(p[-1]), int(q[-1])
    start = max(max(tp, tq) + tp, tq)                # T(T(0)): rem[C - 1]
    rem = torch.maximum(start + p, q)
    off = torch.cumsum(cnt, 0) - cnt
    rows = torch.nonzero(valid).reshape(-1)
    rows = rows[torch.argsort(bucket[rows], stable=True)]
    slot = torch.arange(C, dtype=torch.int64, device=dev)
    occ = rem.roll(1) + cnt > 0
    x = slot - 1
    while True:                 # one step a slot, as long as its distance
        back = occ & (rem[x % C] > rem)
        if not bool(back.any()):
            break
        x = x - back.to(torch.int64)
    bk = (x + 1) % C
    at = off[bk] + cnt[bk] - 1 - (rem - rem[x % C])
    slot_row = torch.full((C,), -1, dtype=torch.int64, device=dev)
    slot_hash = torch.zeros(C, dtype=torch.int64, device=dev)
    slot_row[occ] = rows[at[occ]]
    slot_hash[occ] = h[slot_row[occ]]
    dist = torch.where(occ, slot - (x + 1), -1)
    return HashTable(slot_row.to(torch.int32), as_i32_bits(slot_hash),
                     rounds=(dist.max() + 1).to(torch.int32))


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
    """The pairs from the count's lists into (total,) maps: an entry's
    first pair goes to its tile's offset, plus the counts of the entries
    before it in the tile (the lists of its earlier segments, then its
    own); it walks from its first matching slot, taking the slots whose
    hash and keys equal that slot's build row's, until its count. Only
    pairs at positions below `total` are written: `probe.total` gives them
    all, a smaller size the first ones, and past the pairs the maps are
    not defined."""
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
        put = take & (pos < total)
        out_l[pos[put]] = rows[put].to(torch.int32)
        out_r[pos[put]] = rr[put].to(torch.int32)
        pos += take.to(torch.int64)
        done += take.to(torch.int64)
    return out_l, out_r


def probe_exists_plain(pcols, table: HashTable, bcols) -> torch.Tensor:
    """(n,) bool: the probe rows with at least one match in the table, by
    the count's walk; a row with a null key has none."""
    n = pcols[0].length
    dev = pcols[0].device
    rows = torch.nonzero(_side_valid(pcols, n, dev)).reshape(-1)
    h = row_hash(pcols).index_select(0, rows)
    hit = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    for match, _, _ in _walk(pcols, rows, h, table, bcols):
        hit |= match
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[rows] = hit
    return out


def probe_capped_plain(pcols, table: HashTable, bcols, row_cap: int,
                       alive=None, tile: int = TILE):
    """The capped probe (csrc/hash_join.cu `capped_kernel`) in its order of
    work: per live probe row with valid keys its matches and first matching
    slot (the count's walk); per tile of `tile` rows its pairs and their
    exclusive prefix (the look-back); each matched row's pairs from its
    first slot, the first at its tile's offset plus the pairs of the rows
    before it in the tile, those below `row_cap` written; then every
    slot's `valid` (slot < total) and the maps' zeros past the pairs.
    Returns (lmap, rmap, valid, overflow), `ops.join.inner_join_capped`'s.
    """
    n = pcols[0].length
    dev = pcols[0].device
    rows = torch.nonzero(_insertable(pcols, alive)).reshape(-1)
    h = row_hash(pcols).index_select(0, rows)
    c = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    first = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    for match, _, slot in _walk(pcols, rows, h, table, bcols):
        first = torch.where(match & (c == 0), slot, first)
        c += match.to(torch.int64)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    counts[rows] = c
    sums = _tiled(counts, tile).sum(1)
    offsets = torch.cumsum(sums, 0) - sums
    total = sums.sum()
    hit = c > 0
    mrows, cnt, s0 = rows[hit], c[hit], first[hit]
    tl = mrows // tile
    before = torch.cumsum(cnt, 0) - cnt
    pos = offsets.index_select(0, tl) + before - before.index_select(
        0, torch.searchsorted(tl, tl))
    C = table.capacity
    srow = table.slot_row.to(torch.int64)
    shash = table.slot_hash.to(torch.int64) & _M32
    r0, h0 = srow.index_select(0, s0), shash.index_select(0, s0)
    out_l = torch.zeros(row_cap, dtype=torch.int32, device=dev)
    out_r = torch.zeros(row_cap, dtype=torch.int32, device=dev)
    done = torch.zeros_like(cnt)
    active = pos < row_cap
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
        put = take & (pos < row_cap)
        out_l[pos[put]] = mrows[put].to(torch.int32)
        out_r[pos[put]] = rr[put].to(torch.int32)
        pos = pos + take.to(torch.int64)
        done = done + take.to(torch.int64)
    valid = torch.arange(row_cap, device=dev) < total
    return out_l, out_r, valid, total > row_cap


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
        lib.hj_build.argtypes = _KEY_ARGS + [_P, ctypes.c_int, _P, _P, _P]
        lib.hj_build_large.argtypes = _KEY_ARGS + [_P, ctypes.c_int, _P, _P,
                                                   _P]
        lib.hj_build_large_scratch.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int]
        lib.hj_build_large_scratch.restype = ctypes.c_longlong
        lib.hj_count.argtypes = _KEY_ARGS + [_PP, _P, _P, _P, ctypes.c_int,
                                             _P, _P, _P, _P, _P]
        lib.hj_exists.argtypes = _KEY_ARGS + [_PP, _P, _P, _P, ctypes.c_int,
                                              _P, _P]
        lib.hj_emit.argtypes = [_PP, _PI, _PI, ctypes.c_int,
                                ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                                _P, _P, _P, _P, ctypes.c_longlong, _P, _P,
                                _P]
        var = [_PP, _PP, _PP, _PI, _PI, _PI, ctypes.c_int, ctypes.c_longlong]
        lib.hj_build_var.argtypes = var + [_P, ctypes.c_int, _P, _P, _P]
        lib.hj_build_large_var.argtypes = var + [_P, ctypes.c_int, _P, _P,
                                                 _P]
        lib.hj_count_var.argtypes = var + [_PP, _PP, _P, _P, _P,
                                           ctypes.c_int, _P, _P, _P, _P, _P]
        lib.hj_emit_var.argtypes = [_PP, _PP, _PI, _PI, _PI, ctypes.c_int,
                                    ctypes.c_longlong, _P, _P, _P,
                                    ctypes.c_int, _P, _P, _P, _P,
                                    ctypes.c_longlong, _P, _P, _P]
        lib.hj_exists_var.argtypes = var + [_PP, _PP, _P, _P, _P,
                                            ctypes.c_int, _P, _P]
        capped = [ctypes.c_int, ctypes.c_longlong] + [_P] * 6
        lib.hj_capped.argtypes = _KEY_ARGS + [_P, _PP, _P, _P, _P] + capped
        lib.hj_capped_var.argtypes = var + [_P, _PP, _PP, _P, _P,
                                            _P] + capped
        for fn in (lib.hj_build, lib.hj_build_large, lib.hj_count,
                   lib.hj_emit, lib.hj_exists, lib.hj_build_var,
                   lib.hj_build_large_var, lib.hj_count_var,
                   lib.hj_emit_var, lib.hj_exists_var, lib.hj_capped,
                   lib.hj_capped_var):
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
                c.validity is not None and not c.validity.is_contiguous()) \
                or (c.offsets is not None and not c.offsets.is_contiguous()):
            raise ValueError("hash-join key columns must be contiguous and "
                             f"on {dev}")


def _check_probe(pcols, bcols, dev: torch.device) -> None:
    _check_cuda(pcols, dev)
    _check_cuda(bcols, dev)
    if [c.dtype.kind for c in pcols] != [c.dtype.kind for c in bcols]:
        raise TypeError("probe and build key kinds differ")


def _var_arrays(cols: Sequence[Column]):
    """The `_var` entry points' key arguments: data, validity, offsets,
    width, wide, kind, the column count and the rows."""
    data, valid, _, wide, nk, n = _key_arrays(cols)
    offsets = (ctypes.c_void_p * nk)(*[
        None if c.offsets is None else c.offsets.data_ptr() for c in cols])
    width = (ctypes.c_int * nk)(*[
        c.data.element_size() if c.dtype.kind != Kind.DECIMAL128 else 16
        for c in cols])
    kind = (ctypes.c_int * nk)(*[_VAR_KINDS.get(c.dtype.kind, VK_FIXED)
                                 for c in cols])
    return [data, valid, offsets, width, wide, kind, nk, n]


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


def _alive_ptr(alive, n: int, dev: torch.device):
    """The kernels' pointer to a capped side's live rows (None: all)."""
    if alive is None:
        return None
    if alive.dtype != torch.bool or tuple(alive.shape) != (n,) or \
            alive.device != dev or not alive.is_contiguous():
        raise ValueError(f"alive must be a contiguous ({n},) bool tensor on "
                         f"{dev}")
    return alive.data_ptr()


def build_table_cuda(bcols: Sequence[Column], C: int,
                     alive=None) -> HashTable:
    dev = bcols[0].device
    _check_cuda(bcols, dev)
    n = bcols[0].length
    if n > MAX_BUILD:
        raise ValueError(f"build side of {n} rows exceeds "
                         f"MAX_BUILD={MAX_BUILD}")
    var = is_var(bcols)
    keys = _var_arrays(bcols) if var else _key_arrays(bcols)
    live = _alive_ptr(alive, n, dev)
    lib = _lib()
    if not is_large(C):
        slot_row = torch.empty(C, dtype=torch.int32, device=dev)
        slot_hash = torch.empty(C, dtype=torch.int32, device=dev)
        rc = (lib.hj_build_var if var else lib.hj_build)(
            *keys, live, C, slot_row.data_ptr(), slot_hash.data_ptr(),
            _stream(dev))
        _raise_on(rc, "hash-join build kernel")
        LAUNCHES["build"] += 1
        VAR_LAUNCHES["build"] += var
        return HashTable(slot_row, slot_hash)
    ent = torch.empty(C, dtype=torch.int64, device=dev)
    # this call's own: counts, scans, the rows by bucket; [3] the rounds
    scratch = torch.empty(lib.hj_build_large_scratch(n, C),
                          dtype=torch.int32, device=dev)
    rc = (lib.hj_build_large_var if var else lib.hj_build_large)(
        *keys, live, C, ent.data_ptr(), scratch.data_ptr(), _stream(dev))
    _raise_on(rc, "hash-join large build kernels")
    LAUNCHES["build"] += 1
    LARGE_LAUNCHES["build"] += 1
    VAR_LAUNCHES["build"] += var
    halves = ent.view(torch.int32).view(C, 2)      # little-endian: row, hash
    return HashTable(halves[:, 0], halves[:, 1], ent, scratch[3])


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
    outs = (counts.data_ptr(), entries.data_ptr(), seg.data_ptr(),
            scratch.data_ptr(), _stream(dev))
    if is_var(pcols):
        b = _var_arrays(bcols)
        rc = _lib().hj_count_var(*_var_arrays(pcols), b[0], b[2],
                                 *_table_ptrs(table), C, *outs)
    else:
        bdata = _key_arrays(bcols)[0]
        rc = _lib().hj_count(*_key_arrays(pcols), bdata, *_table_ptrs(table),
                             C, *outs)
    _raise_on(rc, "hash-join probe-count kernel")
    LAUNCHES["count"] += 1
    VAR_LAUNCHES["count"] += is_var(pcols)
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
    # the kernel writes a tile's pairs at its offset .. offset + its sum -
    # 1, those below `total` only: probe.total (the eager join's one host
    # sync) writes every pair, a smaller size the first ones
    out_l = torch.empty(total, dtype=torch.int32, device=dev)
    out_r = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return out_l, out_r
    rest = (n, *_table_ptrs(table), C, *[t.data_ptr() for t, _, _ in shapes],
            total, out_l.data_ptr(), out_r.data_ptr(), _stream(dev))
    if is_var(bcols):
        data, _, offsets, width, wide, kind, nk, _ = _var_arrays(bcols)
        rc = _lib().hj_emit_var(data, offsets, width, wide, kind, nk, *rest)
    else:
        data, _, width, wide, nk, _ = _key_arrays(bcols)
        rc = _lib().hj_emit(data, width, wide, nk, *rest)
    _raise_on(rc, "hash-join probe-emit kernel")
    LAUNCHES["emit"] += 1
    VAR_LAUNCHES["emit"] += is_var(bcols)
    if is_large(C):
        LARGE_LAUNCHES["emit"] += 1
    return out_l, out_r


def probe_exists_cuda(pcols, table: HashTable, bcols) -> torch.Tensor:
    dev = pcols[0].device
    _check_probe(pcols, bcols, dev)
    n = pcols[0].length
    C = table.capacity
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    rest = (*_table_ptrs(table), C, out.data_ptr(), _stream(dev))
    if is_var(pcols):
        b = _var_arrays(bcols)
        rc = _lib().hj_exists_var(*_var_arrays(pcols), b[0], b[2], *rest)
    else:
        rc = _lib().hj_exists(*_key_arrays(pcols), _key_arrays(bcols)[0],
                              *rest)
    _raise_on(rc, "hash-join existence kernel")
    LAUNCHES["exists"] += 1
    VAR_LAUNCHES["exists"] += is_var(pcols)
    if is_large(C):
        LARGE_LAUNCHES["exists"] += 1
    return out


def probe_capped_cuda(pcols, table: HashTable, bcols, row_cap: int,
                      alive=None):
    dev = pcols[0].device
    _check_probe(pcols, bcols, dev)
    n = pcols[0].length
    if n == 0:
        raise ValueError("the capped probe takes a probe side of 1 row or "
                         "more")
    C = table.capacity
    live = _alive_ptr(alive, n, dev)
    out_l = torch.empty(row_cap, dtype=torch.int32, device=dev)
    out_r = torch.empty(row_cap, dtype=torch.int32, device=dev)
    valid = torch.empty(row_cap, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    # this call's own: the tile counter, then a look-back word a tile
    scratch = torch.empty(1 + _tiles(n, TILE), dtype=torch.int64,
                          device=dev)
    rest = (*_table_ptrs(table), C, row_cap, out_l.data_ptr(),
            out_r.data_ptr(), valid.data_ptr(), overflow.data_ptr(),
            scratch.data_ptr(), _stream(dev))
    var = is_var(pcols)
    if var:
        b = _var_arrays(bcols)
        rc = _lib().hj_capped_var(*_var_arrays(pcols), live, b[0], b[2],
                                  *rest)
    else:
        rc = _lib().hj_capped(*_key_arrays(pcols), live,
                              _key_arrays(bcols)[0], *rest)
    _raise_on(rc, "hash-join capped probe kernel")
    LAUNCHES["capped"] += 1
    VAR_LAUNCHES["capped"] += var
    if is_large(C):
        LARGE_LAUNCHES["capped"] += 1
    return out_l, out_r, valid, overflow


# ---- wrappers: plain version on CPU tensors, the kernel on CUDA ones --------

def build_table(bcols: Sequence[Column], C: int, alive=None) -> HashTable:
    if bcols[0].device.type == "cpu":
        PLAIN_CALLS["build"] += 1
        return build_table_plain(bcols, C, alive)
    return build_table_cuda(bcols, C, alive)


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


def probe_exists(pcols, table: HashTable, bcols) -> torch.Tensor:
    if pcols[0].device.type == "cpu":
        PLAIN_CALLS["exists"] += 1
        return probe_exists_plain(pcols, table, bcols)
    return probe_exists_cuda(pcols, table, bcols)


def probe_capped(pcols, table: HashTable, bcols, row_cap: int, alive=None):
    if pcols[0].device.type == "cpu":
        PLAIN_CALLS["capped"] += 1
        return probe_capped_plain(pcols, table, bcols, row_cap, alive)
    return probe_capped_cuda(pcols, table, bcols, row_cap, alive)


def join_keys(left_keys, right_keys):
    """(left, right) key columns, checked as the sort-based join checks
    them: equal, nonzero column counts and equal dtypes (TypeError with
    `ops.join`'s message otherwise, so a plan fails alike on every route,
    before a kernel is chosen)."""
    lcols, rcols = _cols(left_keys), _cols(right_keys)
    if len(lcols) != len(rcols) or not lcols:
        raise ValueError("join requires equal, nonzero key column counts")
    for a, b in zip(lcols, rcols):
        if a.dtype != b.dtype:
            raise TypeError(f"join key concat dtype mismatch: {a.dtype} vs "
                            f"{b.dtype}")
    return lcols, rcols


def inner_join_hash(left_keys, right_keys) -> Tuple[Column, Column]:
    """Inner equi-join via hash build/probe: gather maps (left_map,
    right_map), pair for pair those of `ops.join.inner_join`."""
    lcols, rcols = join_keys(left_keys, right_keys)
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


def _with_alive(cols: Sequence[Column], alive) -> List[Column]:
    """The key columns with `alive` folded into the first one's validity:
    a dead row is then a row with a null key, which never matches."""
    if alive is None:
        return list(cols)
    c = cols[0]
    v = alive if c.validity is None else c.validity & alive
    return [dataclasses.replace(c, validity=v)] + list(cols[1:])


def inner_join_capped_hash(left_keys, right_keys, row_cap: int, *,
                           lalive=None, ralive=None):
    """The capped inner join via hash build/probe, with no host read:
    (lmap, rmap, valid, overflow), bit for bit those of
    `ops.join.inner_join_capped`: (row_cap,) int32 maps holding the first
    row_cap pairs in probe-row then chain order and 0 past them, valid =
    arange(row_cap) < total, overflow = total > row_cap (a () bool)."""
    lcols, rcols = join_keys(left_keys, right_keys)
    nl, nr = lcols[0].length, rcols[0].length
    dev = lcols[0].device
    if nl == 0 or nr == 0:                 # no pair: the shape says so
        z = torch.zeros(row_cap, dtype=torch.int32, device=dev)
        return (z, z, torch.zeros(row_cap, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    table = build_table(rcols, _capacity(nr), ralive)
    return probe_capped(lcols, table, rcols, row_cap, lalive)


def semi_join_mask_hash(left_keys, right_keys, *, lalive=None,
                        ralive=None) -> torch.Tensor:
    """(nl,) bool, bit for bit `ops.join.semi_join_mask`: the live left rows
    with a live right match, from the build and the existence probe, with
    no host read. The alive masks are folded into the keys' validity: a
    dead or null build row is never inserted, a dead or null probe row has
    no match. The capped tier's semi join is `lalive & mask`, its anti join
    `lalive & ~mask`."""
    lcols, rcols = join_keys(left_keys, right_keys)
    nl, nr = lcols[0].length, rcols[0].length
    if nl == 0 or nr == 0:
        return torch.zeros(nl, dtype=torch.bool, device=lcols[0].device)
    lcols, rcols = _with_alive(lcols, lalive), _with_alive(rcols, ralive)
    table = build_table(rcols, _capacity(nr))
    return probe_exists(lcols, table, rcols)


def left_semi_join_hash(left_keys, right_keys) -> Column:
    """`ops.join.left_semi_join` on the kernels: the left rows with a match,
    ascending (one host read, the kept rows' count)."""
    return _keep(semi_join_mask_hash(left_keys, right_keys))


def left_anti_join_hash(left_keys, right_keys) -> Column:
    """`ops.join.left_anti_join` on the kernels: the left rows without a
    match, ascending; a row with a null key has none, so it is kept."""
    return _keep(~semi_join_mask_hash(left_keys, right_keys))


# ---- registry wiring ---------------------------------------------------------

def make_signature(lcols: Sequence[Column], rcols: Sequence[Column],
                   how: str, tier: str):
    from .registry import Signature
    kinds_match = all(a.dtype.kind == b.dtype.kind
                      for a, b in zip(lcols, rcols))
    return Signature.of(list(lcols) + list(rcols), how=how, tier=tier,
                        kinds_match=kinds_match,
                        build_rows=rcols[0].length if rcols else 0)


# the joins the kernels take: inner joins (build, count, emit) and semi and
# anti joins (build, exists)
_HOWS = ("inner", "left_semi", "left_anti")


def _supports(sig) -> bool:
    return (sig.extra("how") in _HOWS
            and sig.extra("tier") in ("eager", "capped")
            and bool(sig.extra("kinds_match"))
            and (sig.extra("build_rows") or 0) <= MAX_BUILD
            and all(k in _SUPPORTED_KINDS for k in sig.kinds))


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("hash_join", "torch", fallback=True)
_REGISTRY.register("hash_join", "cuda", fn=inner_join_hash,
                   backends=("cuda",), supports=_supports)
