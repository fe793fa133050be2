"""The groupby kernel: keyed aggregates over the key-sorted rows, on the card.

Counterpart of the reference's registry op `groupby`
(`spark_rapids_tpu/ops/aggregate.py`, `_groupby_kernel`: scatter-free over
the sorted runs). The kernel lives in `csrc/groupby.cu` (its header says
what it computes and what bounds it on the card); this module binds it
through ctypes, registers op `groupby` in the port's registry and keeps,
beside the kernel, its plain version:

- `groupby_reduce_cuda`: one launch of the kernel's entry point for every
  aggregation of one keyed aggregate (integer sums, counts, sizes and
  min/max words in one pass over tiles of sorted rows; float sums and
  means by the row-order fold), on CUDA tensors only;
- `groupby_reduce_plain`: the same function in plain PyTorch with the
  kernel's tiling (`tile` rows a block): each tile's partial of each group,
  stored where the group lies inside the tile and combined into the
  identity-filled output where a tile edge cuts it, as the kernel's
  atomics combine them; the float sums as the fold gives them, NaN bits
  by the kernel's rule. The CPU tests run it with a small tile.

`groupby_reduce` dispatches by device. `aggregate.groupby_aggregate` and
`groupby_aggregate_capped` select through the registry: "torch" (the
fallback, the scatter design of `ops/aggregate.py`) on CPU tensors, "cuda"
(this kernel) on CUDA ones, where a declined call raises. `LAUNCHES` counts
the entry point's launches ("groupby") and those of them that ran the fold
("fold"); `PLAIN_CALLS` counts the plain version's runs in
`groupby_reduce`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column, Table
from .sort import _float_total_order

LAUNCHES = {"groupby": 0, "fold": 0}
PLAIN_CALLS = {"groupby": 0}

TILE = 2048          # sorted rows a block (GB_TILE in csrc/groupby.cu)
MAX_AGGS = 64        # aggregations a call (the entry point's job table)

OP_COUNT, OP_SIZE, OP_SUM, OP_MIN, OP_MAX, OP_FSUM = range(6)
_TYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
          torch.float32: 4, torch.float64: 5}
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


def _empty(specs: Sequence[AggSpec], dev) -> Tuple[torch.Tensor,
                                                   List[Column]]:
    jobs, uses = _jobs(specs)
    outs = [torch.zeros(0, dtype=torch.float64 if j.op == OP_FSUM
                        else torch.int64, device=dev) for j in jobs]
    return (torch.zeros(0, dtype=torch.int64, device=dev),
            _columns(specs, uses, outs, 0))


# ---- the plain version ---------------------------------------------------------

def _words(job: _Job, rows: torch.Tensor) -> torch.Tensor:
    """(k,) int64 contributions of the sorted rows `rows` (row indices)."""
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


def groupby_reduce_plain(specs: Sequence[AggSpec], order: torch.Tensor,
                         seg: torch.Tensor, G: int,
                         alive: Optional[torch.Tensor] = None,
                         tile: Optional[int] = None):
    """The kernel's function on CPU tensors: (first_rows (G,) int64, the
    aggregations' (G,)-row columns, live groups () int64). `tile` is the
    kernel's block of sorted rows (TILE when not given)."""
    n = seg.shape[0]
    if n == 0 or G == 0:
        first_rows, cols = _empty(specs, seg.device)
        return first_rows, cols, torch.zeros((), dtype=torch.int64)
    tile = tile or TILE
    pos = torch.arange(n)
    live = n if alive is None else int(alive.sum())
    kept = (pos < live) & (seg < G)
    head = kept & torch.cat([torch.ones(1, dtype=torch.bool),
                             seg[1:] != seg[:-1]])
    first_rows = torch.full((G,), n - 1, dtype=torch.int64)
    first_rows[seg[head]] = order[head]
    groups = seg[live - 1] + 1 if live else torch.zeros((), dtype=torch.int64)
    rows, gid = order[kept], seg[kept]
    # each kept row's tile and partial (one a tile and group, numbered in
    # row order); a partial is whole where its group's rows all lie in
    # its tile
    t = pos[kept] // tile
    one = torch.ones(min(1, gid.numel()), dtype=torch.bool)
    starts_part = torch.cat([one, (gid[1:] != gid[:-1]) | (t[1:] != t[:-1])])
    part = torch.cumsum(starts_part, 0) - 1
    first_t = torch.full((G,), -1, dtype=torch.int64).scatter_reduce_(
        0, gid, t, "amin", include_self=False)
    last_t = torch.full((G,), -1, dtype=torch.int64).scatter_reduce_(
        0, gid, t, "amax", include_self=False)
    p_gid, p_t = gid[starts_part], t[starts_part]
    whole = (first_t.index_select(0, p_gid) == p_t) & \
        (last_t.index_select(0, p_gid) == p_t)
    jobs, uses = _jobs(specs)
    outs = []
    for job in jobs:
        if job.op == OP_FSUM:
            outs.append(_fold(job, rows, gid, G))
            continue
        vt = job.col.data.dtype if job.col is not None else torch.int64
        ident = _identity(job.op, vt)
        w = _words(job, rows)
        red = "amin" if job.op == OP_MIN else "amax"
        slots = p_gid.shape[0]
        if job.op in (OP_MIN, OP_MAX):
            partial = torch.full((slots,), ident, dtype=torch.int64
                                 ).scatter_reduce_(0, part, w, red)
        else:
            partial = torch.zeros(slots, dtype=torch.int64).index_add_(
                0, part, w)
        out = torch.full((G,), ident, dtype=torch.int64)
        out[p_gid[whole]] = partial[whole]                # plain stores
        if job.op in (OP_MIN, OP_MAX):                    # the atomics
            out.scatter_reduce_(0, p_gid[~whole], partial[~whole], red)
        else:
            out.index_add_(0, p_gid[~whole], partial[~whole])
        outs.append(out)
    return first_rows, _columns(specs, uses, outs, G), groups


# ---- the CUDA kernel --------------------------------------------------------------

_P = ctypes.c_void_p
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("groupby")
        LL = ctypes.c_longlong
        lib.gb_groupby.argtypes = [_P, _P, LL, _P, LL, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P, ctypes.c_int,
                                   ctypes.c_int, _P]
        lib.gb_groupby.restype = ctypes.c_int
        lib.gb_segment_sum.argtypes = [_P, _P, LL, LL, _P, _P, _P]
        lib.gb_segment_sum.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"groupby kernel ({what}): CUDA error {rc}")


def _ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(values), 1))(*values)


def groupby_reduce_cuda(specs: Sequence[AggSpec], order: torch.Tensor,
                        seg: torch.Tensor, G: int,
                        alive: Optional[torch.Tensor] = None):
    """The kernel: (first_rows (G,) int64, the aggregations' (G,)-row
    columns, live groups () int64 on the card).
    `order` and `seg` are (n,) int64 on the card: the sorted positions'
    rows and groups; with `alive`, dead rows sort last and groups at or
    past G are dropped. Reads nothing on the host."""
    dev = seg.device
    if dev.type != "cuda" or order.device != dev or (
            alive is not None and alive.device != dev):
        raise ValueError(f"the groupby kernel runs on CUDA tensors, got "
                         f"{seg.device} and {order.device}")
    if len(specs) > MAX_AGGS:
        raise ValueError(f"the groupby kernel takes at most {MAX_AGGS} "
                         f"aggregations a call, got {len(specs)}")
    n = seg.shape[0]
    if n == 0 or G == 0:
        first_rows, cols = _empty(specs, dev)
        return first_rows, cols, torch.zeros((), dtype=torch.int64,
                                             device=dev)
    seg, order = seg.contiguous(), order.contiguous()
    jobs, uses = _jobs(specs)
    data, valid, outs, ops, types = [], [], [], [], []
    keep = []                           # tensors the pointers point into
    for job in jobs:
        out = torch.empty(G, dtype=torch.float64 if job.op == OP_FSUM
                          else torch.int64, device=dev)
        outs.append(out)
        d = v = None
        t = 3
        if job.col is not None:
            c = job.col
            if c.device != dev:
                raise ValueError(f"column on {c.device}, rows on {dev}")
            if c.validity is not None:
                v = c.validity.contiguous()
            if job.op != OP_COUNT:
                d = c.data.contiguous()
                if d.dtype not in _TYPES:
                    raise TypeError(f"the groupby kernel does not take "
                                    f"{c.dtype!r} values")
                t = _TYPES[d.dtype]
        keep += [d, v]
        data.append(0 if d is None else d.data_ptr())
        valid.append(0 if v is None else v.data_ptr())
        ops.append(job.op)
        types.append(t)
    need_rows = any(p != 0 for p in data + valid)
    has_fold = OP_FSUM in ops
    first_rows = torch.empty(G, dtype=torch.int64, device=dev)
    meta = torch.empty(2, dtype=torch.int64, device=dev)
    starts = long_list = None
    if has_fold:
        starts = torch.empty(G, dtype=torch.int64, device=dev)
        long_list = torch.empty(G + 1, dtype=torch.int64, device=dev)
    n_live = None if alive is None else alive.sum()
    nj = len(jobs)
    rc = _lib().gb_groupby(
        seg.data_ptr(), order.data_ptr(), n,
        None if n_live is None else n_live.data_ptr(), G,
        first_rows.data_ptr(), None if starts is None else starts.data_ptr(),
        meta.data_ptr(), None if long_list is None else long_list.data_ptr(),
        _ptrs(data), _ptrs(valid), _ptrs([o.data_ptr() for o in outs]),
        (ctypes.c_int * max(nj, 1))(*ops),
        (ctypes.c_int * max(nj, 1))(*types), nj, int(need_rows),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, "groupby")
    LAUNCHES["groupby"] += 1
    if has_fold:
        LAUNCHES["fold"] += 1
    return first_rows, _columns(specs, uses, outs, G), meta[1]


def groupby_reduce(specs: Sequence[AggSpec], order: torch.Tensor,
                   seg: torch.Tensor, G: int,
                   alive: Optional[torch.Tensor] = None):
    """The groupby kernel on CUDA tensors, its plain version on CPU ones."""
    if seg.device.type == "cpu":
        PLAIN_CALLS["groupby"] += 1
        return groupby_reduce_plain(specs, order, seg, G, alive)
    return groupby_reduce_cuda(specs, order, seg, G, alive)


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


def make_signature(table: Table, aggs: Sequence[Tuple[object, str]],
                   tier: str):
    from .registry import Signature
    # the kernel reads only the validity of a count's column, and counts
    # a string column's rows where its min or max goes (`aggregate`)
    cols = [table[c] for c, op in aggs if op != "size"
            and not (op in ("count", "min", "max")
                     and table[c].dtype.is_string)]
    return Signature.of(cols, ops=tuple(op for _, op in aggs), tier=tier)


def supports(sig) -> bool:
    return (sig.extra("tier") in ("eager", "capped")
            and len(sig.extra("ops") or ()) <= MAX_AGGS
            and all(k in _KINDS for k in sig.kinds))


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("groupby", "torch", fallback=True)
_REGISTRY.register("groupby", "cuda", fn=groupby_reduce, backends=("cuda",),
                   supports=supports)
