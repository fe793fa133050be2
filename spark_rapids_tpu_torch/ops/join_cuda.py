"""Hash-join build/probe over fixed-width keys: CUDA kernels and their plain
PyTorch versions.

Counterpart of `spark_rapids_tpu/ops/join_pallas.py`. The kernels live in
`csrc/hash_join.cu` (its header says what each computes and what bounds it
on the card); this module binds them through ctypes and keeps, beside each,
a plain PyTorch version of the same function:

- `build_table`: the open-addressing table over the build keys, filled by
  min-row-id insertion rounds (equal keys in ascending-row chain order);
- `probe_counts`: matches per probe row, walking to the first empty slot;
- `probe_emit`: the (probe row, build row) pairs at each row's start.

Each wrapper runs the plain version only for CPU tensors. For CUDA tensors
it launches its kernel or raises; it never falls back. `LAUNCHES` counts
kernel launches and `PLAIN_CALLS` the plain version's runs, per wrapper.

The plain versions hash with the row hash's own murmur3 (`hash.py`, unsigned
32-bit math in int64 with a mask after every step).

`inner_join_hash` is the counterpart of `inner_join_pallas`: int32 gather
maps, pair for pair those of `ops.join.inner_join`. It is registered as
`hash_join`/"cuda" for backend "cuda" and declines what the reference's
`_supports` declines: non-inner joins, mismatched or unsupported key kinds
and build sides over `MAX_BUILD` rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from .hash import as_i32_bits, mm_column
from .join import _cols, _side_valid

MAX_BUILD = 512     # the reference's VMEM-sized limit, kept for parity
_MAX_KEYS = 32      # key columns the kernels take (csrc/hash_join.cu)
_SEED = 42
_M32 = 0xFFFFFFFF

_SUPPORTED_KINDS = frozenset(k.value for k in (
    Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.DATE32,
    Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64))
# decimals hash as longs (Spark), so DECIMAL32 is 8-byte despite its storage
_WIDE_KINDS = (Kind.INT64, Kind.TIMESTAMP_US, Kind.DECIMAL32, Kind.DECIMAL64)

LAUNCHES = {"build": 0, "count": 0, "emit": 0}
PLAIN_CALLS = {"build": 0, "count": 0, "emit": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _capacity(n_build: int) -> int:
    c = 256
    while c < 2 * n_build:
        c *= 2
    return c


@dataclasses.dataclass
class HashTable:
    """slot_row: (C,) int32 build row id, -1 where empty. slot_hash: (C,)
    int32 holding the bits of that row's u32 bucket hash (0 where empty)."""
    slot_row: torch.Tensor
    slot_hash: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.slot_row.shape[0])


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
    """Yield per chain step the (probe-row mask, build rows) of matches for
    `rows` (probe row ids with hashes `h`), in chain order."""
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
        yield match, rr


def probe_counts_plain(pcols, table: HashTable, bcols) -> torch.Tensor:
    n = pcols[0].length
    dev = pcols[0].device
    rows = torch.nonzero(_side_valid(pcols, n, dev)).reshape(-1)
    h = row_hash(pcols).index_select(0, rows)
    c = torch.zeros(rows.shape[0], dtype=torch.int32, device=dev)
    for match, _ in _walk(pcols, rows, h, table, bcols):
        c += match.to(torch.int32)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    counts[rows] = c
    return counts


def probe_emit_plain(pcols, table: HashTable, bcols, counts: torch.Tensor,
                     starts: torch.Tensor, total: int):
    dev = pcols[0].device
    rows = torch.nonzero(counts > 0).reshape(-1)
    h = row_hash(pcols).index_select(0, rows)
    pos = starts.index_select(0, rows).clone()
    out_l = torch.empty(total, dtype=torch.int32, device=dev)
    out_r = torch.empty(total, dtype=torch.int32, device=dev)
    for match, r in _walk(pcols, rows, h, table, bcols):
        out_l[pos[match]] = rows[match].to(torch.int32)
        out_r[pos[match]] = r[match].to(torch.int32)
        pos += match.to(torch.int64)
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
        lib.hj_count.argtypes = _KEY_ARGS + [_PP, _P, _P, ctypes.c_int, _P,
                                             _P]
        lib.hj_emit.argtypes = _KEY_ARGS + [_PP, _P, _P, ctypes.c_int, _P, _P,
                                            _P, _P, _P]
        for fn in (lib.hj_build, lib.hj_count, lib.hj_emit):
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


def build_table_cuda(bcols: Sequence[Column], C: int) -> HashTable:
    dev = bcols[0].device
    _check_cuda(bcols, dev)
    if bcols[0].length > MAX_BUILD:
        raise ValueError(f"build side of {bcols[0].length} rows exceeds "
                         f"MAX_BUILD={MAX_BUILD}")
    slot_row = torch.empty(C, dtype=torch.int32, device=dev)
    slot_hash = torch.empty(C, dtype=torch.int32, device=dev)
    keys = _key_arrays(bcols)
    rc = _lib().hj_build(*keys, C, slot_row.data_ptr(), slot_hash.data_ptr(),
                         _stream(dev))
    _raise_on(rc, "hash-join build kernel")
    LAUNCHES["build"] += 1
    return HashTable(slot_row, slot_hash)


def probe_counts_cuda(pcols, table: HashTable, bcols) -> torch.Tensor:
    dev = pcols[0].device
    _check_probe(pcols, bcols, dev)
    counts = torch.empty(pcols[0].length, dtype=torch.int32, device=dev)
    if pcols[0].length == 0:
        return counts
    bdata = _key_arrays(bcols)[0]
    rc = _lib().hj_count(*_key_arrays(pcols), bdata, table.slot_row.data_ptr(),
                         table.slot_hash.data_ptr(), table.capacity,
                         counts.data_ptr(), _stream(dev))
    _raise_on(rc, "hash-join probe-count kernel")
    LAUNCHES["count"] += 1
    return counts


def probe_emit_cuda(pcols, table: HashTable, bcols, counts: torch.Tensor,
                    starts: torch.Tensor, total: int):
    dev = pcols[0].device
    _check_probe(pcols, bcols, dev)
    n = pcols[0].length
    if counts.dtype != torch.int32 or starts.dtype != torch.int64 or \
            tuple(counts.shape) != (n,) or tuple(starts.shape) != (n,) or \
            counts.device != dev or starts.device != dev or \
            not (counts.is_contiguous() and starts.is_contiguous()):
        raise TypeError("emit takes contiguous (n,) int32 counts and int64 "
                        "starts on the probe's device")
    # `total` must be counts.sum() (the caller's one host sync): the kernel
    # writes each row's pairs at starts[i] .. starts[i] + counts[i] - 1
    out_l = torch.empty(total, dtype=torch.int32, device=dev)
    out_r = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return out_l, out_r
    bdata = _key_arrays(bcols)[0]
    rc = _lib().hj_emit(*_key_arrays(pcols), bdata, table.slot_row.data_ptr(),
                        table.slot_hash.data_ptr(), table.capacity,
                        counts.data_ptr(), starts.data_ptr(), out_l.data_ptr(),
                        out_r.data_ptr(), _stream(dev))
    _raise_on(rc, "hash-join probe-emit kernel")
    LAUNCHES["emit"] += 1
    return out_l, out_r


# ---- wrappers: plain version on CPU tensors, the kernel on CUDA ones --------

def build_table(bcols: Sequence[Column], C: int) -> HashTable:
    if bcols[0].device.type == "cpu":
        PLAIN_CALLS["build"] += 1
        return build_table_plain(bcols, C)
    return build_table_cuda(bcols, C)


def probe_counts(pcols, table: HashTable, bcols) -> torch.Tensor:
    if pcols[0].device.type == "cpu":
        PLAIN_CALLS["count"] += 1
        return probe_counts_plain(pcols, table, bcols)
    return probe_counts_cuda(pcols, table, bcols)


def probe_emit(pcols, table: HashTable, bcols, counts, starts, total: int):
    if pcols[0].device.type == "cpu":
        PLAIN_CALLS["emit"] += 1
        return probe_emit_plain(pcols, table, bcols, counts, starts, total)
    return probe_emit_cuda(pcols, table, bcols, counts, starts, total)


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
    counts = probe_counts(lcols, table, rcols)
    total = int(counts.sum())                  # the one host sync
    if total == 0:
        return empty()
    c64 = counts.to(torch.int64)
    starts = torch.cumsum(c64, 0) - c64
    lmap, rmap = probe_emit(lcols, table, rcols, counts, starts, total)
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
