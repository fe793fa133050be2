"""The groupby kernel: keyed aggregates by hashing, on the card.

Counterpart of the reference's registry op `groupby`
(`spark_rapids_tpu/ops/aggregate.py`, `_groupby_kernel`: a sort of every
row by its key tuple, then a scatter-free reduction over the runs, a trade
that only pays on a TPU). The kernels live in `csrc/groupby.cu` (its header
says what they compute and what bounds them on the card); this module
binds them through ctypes, registers op `groupby` in the port's registry
and keeps, beside them, their plain version:

- `groupby_hash_cuda`: the rows grouped in a hash table on the card (each
  group's representative its smallest row), the G representatives ordered
  by key (the eager tier: `lex_order` over their G rows after the one host
  read of G; the capped tier: a sort of their order words on the card,
  with no host read), then every aggregation of the call by rank
  (integer sums, counts, sizes and min/max words with atomics, into
  shared memory where the ranks fit); float sums and means fold each
  group's rows in row order after a stable sort of the rows by rank (one
  int operand). On CUDA tensors only;
- `groupby_hash_plain`: the same design in plain PyTorch on CPU tensors:
  groups numbered in the order a sequential insertion claims them, their
  smallest rows, the G-row rank sort, each `tile` rows' partial per rank
  combined as the kernel's blocks combine theirs, and the fold's order.
  The insertion's slots are not modelled: CAS insertion makes them
  nondeterministic, and no output depends on them.

`groupby_hash` dispatches by device. `aggregate.groupby_aggregate` and
`groupby_aggregate_capped` select through the registry: "torch" (the
fallback, the sort-and-scatter design of `ops/aggregate.py`) on CPU
tensors, "cuda" (these kernels) on CUDA ones, where a declined call
raises. `LAUNCHES` counts the entry point's calls ("groupby": one a keyed
aggregate), those that ran the fold ("fold") and the capped tier's sorts
of the representatives on the card ("sort"); `PLAIN_CALLS` counts the
plain version's runs in `groupby_hash`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..dtypes import Kind
from .gather import take
from .sort import _float_total_order, _key_operands, lex_order

LAUNCHES = {"groupby": 0, "fold": 0, "sort": 0}
PLAIN_CALLS = {"groupby": 0}

TILE = 4096          # rows an aggregation block takes (AGG_TILE, groupby.cu)
MAX_AGGS = 64        # aggregations a call (the entry point's job table)
MAX_KEYS = 32        # key columns a call (GB_MAX_KEYS)

OP_COUNT, OP_SIZE, OP_SUM, OP_MIN, OP_MAX, OP_FSUM = range(6)
_TYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
          torch.float32: 4, torch.float64: 5}
# key kinds (GK_* in csrc/groupby.cu)
GK_INT, GK_F32, GK_F64, GK_DEC128, GK_STRING = range(5)
_KEY_KINDS = {Kind.FLOAT32: GK_F32, Kind.FLOAT64: GK_F64,
              Kind.DECIMAL128: GK_DEC128, Kind.STRING: GK_STRING}
_INT_KEYS = (Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
             Kind.DATE32, Kind.TIMESTAMP_US, Kind.TIMESTAMP_S,
             Kind.TIMESTAMP_MS, Kind.DECIMAL32, Kind.DECIMAL64)
_X86_DEFAULT_NAN = -0x0008000000000000      # 0xFFF8000000000000 as int64
_F64_QUIET = 0x0008000000000000


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One validated aggregation: `op` over `col` (None for size), named
    `name`, giving `dtype`."""

    op: str
    col: Optional[Column]
    name: str
    dtype: dtypes.DType


@dataclasses.dataclass(frozen=True)
class GroupRows:
    """Each row's rank (n,) int32 (the output rows' count for a row that is
    dead or past the cap) and each rank's first position (G_out,) int64
    among the rows sorted stably by rank."""

    rank: torch.Tensor
    starts: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Job:
    op: int
    col: Optional[Column]


def _jobs(specs: Sequence[AggSpec]):
    """The kernel's jobs for `specs` (one count a column, shared by the
    aggregations over it) and, per spec, the indices of its jobs."""
    jobs: List[_Job] = []
    counts = {}

    def add(op, col):
        jobs.append(_Job(op, col))
        return len(jobs) - 1

    def count(spec):
        if spec.name not in counts:
            counts[spec.name] = add(OP_COUNT, spec.col)
        return counts[spec.name]

    uses = []
    for s in specs:
        if s.op == "size":
            uses.append((add(OP_SIZE, None),))
        elif s.op == "count":
            uses.append((count(s),))
        elif s.op == "mean" or (s.op == "sum" and s.col.dtype.is_floating):
            uses.append((count(s), add(OP_FSUM, s.col)))
        elif s.op == "sum":
            uses.append((count(s), add(OP_SUM, s.col)))
        else:
            uses.append((count(s), add(OP_MIN if s.op == "min" else OP_MAX,
                                       s.col)))
    return jobs, uses


def _columns(specs: Sequence[AggSpec], uses, outs, G: int) -> List[Column]:
    """The output columns from the jobs' (G,) results: as the plain
    version builds them (counts and sizes without validity, the rest valid
    where the count is positive, min/max words back to their kind)."""
    cols = []
    for s, use in zip(specs, uses):
        if s.op in ("size", "count"):
            cols.append(Column(dtypes.INT64, G, outs[use[0]]))
            continue
        cnt, res = outs[use[0]], outs[use[1]]
        if s.op == "mean":
            # the CPU's division returns a NaN dividend as it is
            res = torch.where(torch.isnan(res), res,
                              res / torch.where(cnt == 0, torch.ones_like(cnt),
                                                cnt).to(torch.float64))
        elif s.op in ("min", "max"):
            vt = s.col.data.dtype
            if vt.is_floating_point:
                bits_t = torch.int32 if vt == torch.float32 else torch.int64
                w = res.to(bits_t)
                info = torch.iinfo(bits_t)
                res = torch.where(w < 0, ~(w ^ info.min), w).view(vt)
            else:
                res = res.to(vt)
        cols.append(Column(s.dtype, G, res.to(s.dtype.storage_dtype()),
                           cnt > 0))
    return cols


def _identity(op: int, vt: torch.dtype) -> int:
    if op not in (OP_MIN, OP_MAX):
        return 0
    bits_t = {torch.float32: torch.int32, torch.float64: torch.int64}.get(
        vt, vt)
    info = torch.iinfo(bits_t)
    return info.max if op == OP_MIN else info.min


def _empty(specs: Sequence[AggSpec], dev):
    """The outputs of a call with no rows: nothing, no group."""
    jobs, uses = _jobs(specs)
    outs = [torch.zeros(0, dtype=torch.float64 if j.op == OP_FSUM
                        else torch.int64, device=dev) for j in jobs]
    return (torch.zeros(0, dtype=torch.int64, device=dev),
            _columns(specs, uses, outs, 0),
            torch.zeros((), dtype=torch.int64, device=dev), None)


def _group_operands(keys: Sequence[Column]) -> List[torch.Tensor]:
    """The key operands that tell groups apart and order them (nulls
    first, floats by total order)."""
    return [o for c in keys for o in _key_operands(c, True, None)]


def _fold_starts(sizes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each rank's first position among the rows sorted by rank, -1 for an
    empty rank; the kept rows' count as a (1,) tensor) from the rows of
    each rank."""
    ends = torch.cumsum(sizes, 0)
    return torch.where(sizes > 0, ends - sizes, -1), ends[-1:]


# ---- the plain version ---------------------------------------------------------

def _words(job: _Job, rows: torch.Tensor) -> torch.Tensor:
    """(k,) int64 contributions of the rows `rows` (row indices)."""
    if job.op == OP_SIZE:
        return torch.ones_like(rows)
    c = job.col
    ok = c.null_mask.index_select(0, rows)
    if job.op == OP_COUNT:
        return ok.to(torch.int64)
    v = c.data.index_select(0, rows)
    w = (_float_total_order(v) if v.is_floating_point() else v).to(
        torch.int64)
    return torch.where(ok, w, torch.full_like(w, _identity(job.op,
                                                           v.dtype)))


def _fold(job: _Job, rows: torch.Tensor, gid: torch.Tensor,
          G: int) -> torch.Tensor:
    """(G,) float64: each group's fold from +0.0 in row order (CPU
    `index_add_` adds in row order); a fold that ends NaN takes the bits
    of its last NaN value, quieted, or x86's default NaN."""
    c = job.col
    ok = c.null_mask.index_select(0, rows)
    x = torch.where(ok, c.data.index_select(0, rows).to(torch.float64),
                    torch.zeros((), dtype=torch.float64))
    out = torch.zeros(G, dtype=torch.float64).index_add_(0, gid, x)
    bad = torch.isnan(out)
    if bool(bad.any()):
        at = torch.arange(x.shape[0])
        isn = torch.isnan(x)
        last = torch.full((G,), -1, dtype=torch.int64).scatter_reduce_(
            0, gid[isn], at[isn], "amax")
        bits = torch.where(
            last >= 0,
            x.view(torch.int64).index_select(0, last.clamp(min=0))
            | _F64_QUIET,
            torch.full((G,), _X86_DEFAULT_NAN, dtype=torch.int64))
        out = torch.where(bad, bits.view(torch.float64), out)
    return out


def groupby_hash_plain(keys: Sequence[Column], specs: Sequence[AggSpec],
                       cap: Optional[int] = None,
                       alive: Optional[torch.Tensor] = None,
                       want_rank: bool = False, tile: Optional[int] = None):
    """The kernels' function on CPU tensors: (first_rows (G_out,) int64,
    the aggregations' (G_out,)-row columns, live groups () int64, the
    rows' `GroupRows` when `want_rank` else None). G_out is the group
    count, or `cap` in the capped tier. `tile` is the rows a block takes
    (TILE when not given)."""
    n = keys[0].length
    if n == 0:
        return _empty(specs, keys[0].device)
    tile = tile or TILE
    ops = _group_operands(keys)
    live = (torch.arange(n) if alive is None
            else torch.nonzero(alive).reshape(-1))
    # the insertion, in row order: a live row claims a new group unless an
    # earlier row holds its key; groups are numbered in claim order and
    # each keeps its smallest row, the representative
    row_gid = torch.full((n,), -1, dtype=torch.int64)
    reps = torch.zeros(0, dtype=torch.int64)
    if live.numel():
        mat = torch.stack([o.index_select(0, live).to(torch.int64)
                           for o in ops], 1)
        _, inv = torch.unique(mat, dim=0, return_inverse=True)
        u = int(inv.max()) + 1
        first = torch.full((u,), n, dtype=torch.int64).scatter_reduce_(
            0, inv, live, "amin")
        claim = torch.argsort(first)                 # group id -> unique key
        reps = first.index_select(0, claim)
        gid_of = torch.empty(u, dtype=torch.int64).scatter_(
            0, claim, torch.arange(u))
        row_gid[live] = gid_of.index_select(0, inv)
    G = reps.shape[0]
    G_out = G if cap is None else cap
    # the rank sort: the G representatives by key
    by_key = (lex_order([o.index_select(0, reps) for o in ops]) if G
              else reps)
    rank_of = torch.empty(G, dtype=torch.int64).scatter_(
        0, by_key, torch.arange(G))
    rank = torch.where(row_gid >= 0,
                       rank_of.index_select(0, row_gid.clamp(min=0))
                       if G else row_gid, G_out)
    rank = torch.where(rank < G_out, rank, G_out)
    first_rows = torch.full((G_out,), n - 1, dtype=torch.int64)
    k = min(G, G_out)
    first_rows[:k] = reps.index_select(0, by_key[:k])
    kept = torch.nonzero(rank < G_out).reshape(-1)
    r_kept = rank.index_select(0, kept)
    # one partial a block's tile and rank, combined into the outputs as
    # the kernel's blocks combine theirs
    part_id = (kept // tile) * G_out + r_kept
    parts, part = torch.unique(part_id, return_inverse=True)
    part_rank = parts % G_out
    jobs, uses = _jobs(specs)
    fold_jobs = [j for j in jobs if j.op == OP_FSUM]
    sizes = torch.zeros(G_out, dtype=torch.int64).index_add_(
        0, r_kept, torch.ones_like(r_kept))
    outs = []
    if fold_jobs:
        # the rows stably sorted by rank: each group's in row order
        order = torch.argsort(rank, stable=True)
    for job in jobs:
        if job.op == OP_FSUM:
            rows = order[:kept.shape[0]]
            outs.append(_fold(job, rows, rank.index_select(0, rows), G_out))
            continue
        vt = job.col.data.dtype if job.col is not None else torch.int64
        ident = _identity(job.op, vt)
        w = _words(job, kept)
        out = torch.full((G_out,), ident, dtype=torch.int64)
        if job.op in (OP_MIN, OP_MAX):
            red = "amin" if job.op == OP_MIN else "amax"
            partial = torch.full((parts.shape[0],), ident, dtype=torch.int64
                                 ).scatter_reduce_(0, part, w, red)
            out.scatter_reduce_(0, part_rank, partial, red)
        else:
            partial = torch.zeros(parts.shape[0], dtype=torch.int64
                                  ).index_add_(0, part, w)
            out.index_add_(0, part_rank, partial)
        outs.append(out)
    rows = None
    if want_rank:
        rows = GroupRows(rank.to(torch.int32), _fold_starts(sizes)[0])
    return (first_rows, _columns(specs, uses, outs, G_out),
            torch.tensor(G, dtype=torch.int64), rows)


# ---- the CUDA kernels ------------------------------------------------------

_P = ctypes.c_void_p
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("groupby")
        LL, I = ctypes.c_longlong, ctypes.c_int
        lib.gb_insert.argtypes = [_P, _P, _P, _P, _P, I, LL, _P, _P, LL, _P,
                                  _P, _P, _P]
        lib.gb_sort_groups.argtypes = [_P, _P, _P, _P, _P, I, _P, _P, _P, LL,
                                       I, _P, _P, _P, _P, _P]
        lib.gb_aggregate.argtypes = [_P, LL, _P, LL, I, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P, I, _P]
        lib.gb_fold_rows.argtypes = [_P, _P, LL, LL, _P, _P, _P, _P, _P, _P,
                                     I, _P]
        lib.gb_segment_sum.argtypes = [_P, _P, LL, LL, _P, _P, _P]
        for f in (lib.gb_insert, lib.gb_sort_groups, lib.gb_aggregate,
                  lib.gb_fold_rows, lib.gb_segment_sum):
            f.restype = I
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"groupby kernel ({what}): CUDA error {rc}")


def _ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(values), 1))(*values)


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * max(len(values), 1))(*values)


def capacity(n: int) -> int:
    """The insertion table's slots for n rows: a power of two >= 1.5 n, so
    a table of distinct keys is at most two thirds full."""
    return 1 << max(6, (n + n // 2).bit_length())


def key_words(keys: Sequence[Column]) -> int:
    """The order words a group takes in the capped tier's sort."""
    return sum((c.validity is not None)
               + (2 if c.dtype.kind == Kind.DECIMAL128 else 1) for c in keys)


def _key_args(keys: Sequence[Column]):
    """The key columns as the entry points take them (contiguous) and the
    tensors their pointers point into."""
    cols = []
    for c in keys:
        if c.dtype.kind not in _INT_KEYS and c.dtype.kind not in _KEY_KINDS:
            raise TypeError(f"the groupby kernel does not take {c.dtype!r} "
                            "keys")
        cols.append(Column(
            c.dtype, c.length, c.data.contiguous(),
            None if c.validity is None else c.validity.contiguous(),
            None if c.offsets is None else c.offsets.contiguous()))
    args = [_ptrs([c.data.data_ptr() for c in cols]),
            _ptrs([0 if c.validity is None else c.validity.data_ptr()
                   for c in cols]),
            _ptrs([0 if c.offsets is None else c.offsets.data_ptr()
                   for c in cols]),
            _ints([c.data.element_size() for c in cols]),
            _ints([_KEY_KINDS.get(c.dtype.kind, GK_INT) for c in cols]),
            len(cols)]
    return args, cols


def _job_args(jobs: Sequence[_Job], outs, dev):
    data, valid, keep = [], [], []
    for job in jobs:
        d = v = None
        if job.col is not None:
            c = job.col
            if c.device != dev:
                raise ValueError(f"column on {c.device}, keys on {dev}")
            if c.validity is not None:
                v = c.validity.contiguous()
            if job.op not in (OP_COUNT, OP_SIZE):
                d = c.data.contiguous()
                if d.dtype not in _TYPES:
                    raise TypeError(f"the groupby kernel does not take "
                                    f"{c.dtype!r} values")
        keep += [d, v]
        data.append(0 if d is None else d.data_ptr())
        valid.append(0 if v is None else v.data_ptr())
    types = [_TYPES[job.col.data.dtype] if job.col is not None
             and job.op not in (OP_COUNT, OP_SIZE) else 3 for job in jobs]
    return ([_ptrs(data), _ptrs(valid), _ptrs([o.data_ptr() for o in outs]),
             _ints([j.op for j in jobs]), _ints(types), len(jobs)], keep)


def groupby_hash_cuda(keys: Sequence[Column], specs: Sequence[AggSpec],
                      cap: Optional[int] = None,
                      alive: Optional[torch.Tensor] = None,
                      want_rank: bool = False):
    """The kernels: (first_rows (G_out,) int64, the aggregations' (G_out,)
    -row columns, live groups () int64 on the card, the rows' `GroupRows`
    when `want_rank` else None), as `groupby_hash_plain` gives them. The
    eager tier (`cap` None) reads the group count once on the host; the
    capped tier reads nothing."""
    dev = keys[0].device
    if dev.type != "cuda" or any(c.device != dev for c in keys) or (
            alive is not None and alive.device != dev):
        raise ValueError(f"the groupby kernel runs on CUDA tensors, got "
                         f"{[str(c.device) for c in keys]}")
    if len(specs) > MAX_AGGS or not 0 < len(keys) <= MAX_KEYS:
        raise ValueError(f"the groupby kernel takes 1 to {MAX_KEYS} keys "
                         f"and at most {MAX_AGGS} aggregations a call, got "
                         f"{len(keys)} and {len(specs)}")
    n = keys[0].length
    if n == 0:
        return _empty(specs, dev)
    if n >= 2 ** 31 - 1:
        raise ValueError(f"the groupby kernel takes fewer than 2^31 rows, "
                         f"got {n}")
    if cap is not None and any(c.dtype.is_string for c in keys):
        raise TypeError("the capped groupby kernel does not take STRING keys")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kargs, kcols = _key_args(keys)
    C = capacity(n)
    i32 = dict(dtype=torch.int32, device=dev)
    table, slot_rank = torch.empty(C, **i32), torch.empty(C, **i32)
    gid_slot, row_slot = torch.empty(n, **i32), torch.empty(n, **i32)
    groups = torch.empty(1, dtype=torch.int64, device=dev)
    if alive is not None:
        alive = alive.contiguous()
    _check(lib.gb_insert(*kargs, n, None if alive is None
                         else alive.data_ptr(), table.data_ptr(), C,
                         gid_slot.data_ptr(), row_slot.data_ptr(),
                         groups.data_ptr(), stream),
           "insert")
    if cap is None:
        G_out = int(groups)                       # the one host read
        reps = table.index_select(0, gid_slot[:G_out].long()).long()
        sorted_gid = lex_order(_group_operands(
            [take(c, reps, _has_negative=False) for c in kcols])
        ).to(torch.int32)
    else:
        G_out = cap
        W = key_words(kcols)
        words = torch.empty(n * W, dtype=torch.int64, device=dev)
        bufs = torch.empty(2, n, **i32)
        which = ctypes.c_int(0)
        _check(lib.gb_sort_groups(*kargs, groups.data_ptr(),
                                  gid_slot.data_ptr(), table.data_ptr(), n,
                                  W, words.data_ptr(), bufs[0].data_ptr(),
                                  bufs[1].data_ptr(), ctypes.byref(which),
                                  stream), "sort")
        sorted_gid = bufs[which.value]
        LAUNCHES["sort"] += 1
    jobs, uses = _jobs(specs)
    fold_jobs = [j for j in jobs if j.op == OP_FSUM]
    if fold_jobs or want_rank:              # each rank's rows
        jobs = jobs + [_Job(OP_SIZE, None)]
    outs = [torch.empty(G_out, dtype=torch.float64 if j.op == OP_FSUM
                        else torch.int64, device=dev) for j in jobs]
    jargs, keep = _job_args(jobs, outs, dev)     # keep: what jargs point into
    first_rows = torch.empty(G_out, dtype=torch.int64, device=dev)
    row_rank = (torch.empty(n, **i32) if fold_jobs or want_rank else None)
    _check(lib.gb_aggregate(
        row_slot.data_ptr(), n, groups.data_ptr(), G_out, int(cap is None),
        sorted_gid.data_ptr(), gid_slot.data_ptr(), table.data_ptr(),
        slot_rank.data_ptr(), first_rows.data_ptr(),
        None if row_rank is None else row_rank.data_ptr(), *jargs, stream),
        "aggregate")
    rows = None
    if row_rank is not None:
        starts, end = _fold_starts(outs[-1])
        if fold_jobs:
            # the rows stably sorted by rank: each group's in row order
            order = torch.argsort(row_rank, stable=True)
            at = [q for q, j in enumerate(jobs) if j.op == OP_FSUM]
            fargs, fkeep = _job_args([jobs[q] for q in at],
                                     [outs[q] for q in at], dev)
            long_list = torch.empty(G_out + 1, dtype=torch.int64, device=dev)
            _check(lib.gb_fold_rows(
                order.data_ptr(), starts.data_ptr(), G_out, n,
                end.data_ptr(), long_list.data_ptr(), fargs[0], fargs[1],
                fargs[2], fargs[4], fargs[5], stream), "fold")
            LAUNCHES["fold"] += 1
        if want_rank:
            rows = GroupRows(row_rank, starts)
        outs = outs[:-1]
    LAUNCHES["groupby"] += 1
    return first_rows, _columns(specs, uses, outs, G_out), groups[0], rows


def groupby_hash(keys: Sequence[Column], specs: Sequence[AggSpec],
                 cap: Optional[int] = None,
                 alive: Optional[torch.Tensor] = None,
                 want_rank: bool = False):
    """The groupby kernels on CUDA tensors, their plain version on CPU
    ones."""
    if keys[0].device.type == "cpu":
        PLAIN_CALLS["groupby"] += 1
        return groupby_hash_plain(keys, specs, cap, alive, want_rank)
    return groupby_hash_cuda(keys, specs, cap, alive, want_rank)


def segment_sum_groups(values: torch.Tensor, starts: torch.Tensor,
                       out: torch.Tensor) -> None:
    """The fold route alone on contiguous sorted float64 values (the
    contract of `segment_sum_cuda.segment_sum_cuda`), into `out`."""
    g = starts.shape[0]
    long_list = torch.empty(g + 1, dtype=torch.int64, device=values.device)
    _check(_lib().gb_segment_sum(
        values.data_ptr(), starts.data_ptr(), g, values.shape[0],
        out.data_ptr(), long_list.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream),
        "segment sum")


# ---- registry wiring ---------------------------------------------------------------

_KINDS = frozenset(k.value for k in dtypes._STORAGE)
_KEY_KIND_VALUES = frozenset(k.value for k in _INT_KEYS + tuple(_KEY_KINDS))


def make_signature(table: Table, aggs: Sequence[Tuple[object, str]],
                   tier: str, keys: Sequence[object] = ()):
    from .registry import Signature
    # the kernel reads only the validity of a count's column, and counts
    # a string column's rows where its min or max goes (`aggregate`)
    cols = [table[c] for c, op in aggs if op != "size"
            and not (op in ("count", "min", "max")
                     and table[c].dtype.is_string)]
    return Signature.of(cols, ops=tuple(op for _, op in aggs), tier=tier,
                        keys=tuple(table[k].dtype.kind.value for k in keys))


def supports(sig) -> bool:
    """The kernels take up to MAX_KEYS keys of every kind `_key_operands`
    orders, STRING only in the eager tier (the capped sort compares
    fixed-width order words), and MAX_AGGS aggregations."""
    tier = sig.extra("tier")
    keys = sig.extra("keys") or ()
    return (tier in ("eager", "capped")
            and len(sig.extra("ops") or ()) <= MAX_AGGS
            and len(keys) <= MAX_KEYS
            and all(k in _KEY_KIND_VALUES for k in keys)
            and not (tier == "capped" and Kind.STRING.value in keys)
            and all(k in _KINDS for k in sig.kinds))


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("groupby", "torch", fallback=True)
_REGISTRY.register("groupby", "cuda", fn=groupby_hash, backends=("cuda",),
                   supports=supports)
