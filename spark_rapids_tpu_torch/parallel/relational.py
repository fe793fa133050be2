"""Distributed relational ops over a mesh.

Counterpart of `spark_rapids_tpu/parallel/relational.py`, with the same
outputs bit for bit, padded layout included. The reference runs each op
as one SPMD program, `shard_map` over the mesh with the all-to-all in the
middle; here the mesh's P peers share one device (`shuffle.Mesh`), a
sharded array is one tensor with the peer axis leading, each per-peer
body runs on its peer's view, and the all-to-all is `partition.
exchange_map` (one `px_exchange_map` launch on the card) plus one gather:

    distributed_groupby: a local sorted partial aggregate into key_cap
        slots -> Spark murmur pmod of the group keys -> exchange (capacity
        key_cap: a source sends at most key_cap groups, so no bucket
        overflows) -> a local final merge;
    distributed_inner_join: both sides hash-partitioned by key -> exchange
        (slack-sized buckets) -> a per-peer sort-merge join into row_cap
        slots.

Every op returns per-peer overflow flags instead of a wrong result (the
SplitAndRetry signal; `autoretry` grows the caps). Results are global
arrays: peer i's rows (key_cap, row_cap or the exchange's P * cap) sit at
[i*c, (i+1)*c), dead slots carry the reference's fills (`_DEAD_KEY` for
key words, zeros or the aggregate's identity for values), and the
received rows are source-major: peer d's rows are bucket d of source 0,
then of source 1, and so on. Nothing here reads the device on the host.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..ops.join import expand_spans, join_spans
from ..ops.sort import lex_order
from .shuffle import (Mesh, exchange_parts, partition_ids, shards, take_fill,
                      take_rows, where_zero, widen_unsigned)

_AGGS = ("sum", "count", "min", "max")

# int64.max is the dead-slot sentinel of key words throughout (padded
# exchange slots); a real key of exactly that value would merge with them
_DEAD_KEY = 2 ** 63 - 1
_I64_MIN = -2 ** 63


def _spark_murmur_i64(keys) -> torch.Tensor:
    """Spark murmur3_32 (seed 42, as GpuHashPartitioning) of one or more
    int64 key columns, chained per column: the row-hash kernel on the
    card."""
    from ..ops import hash_cuda
    key_list = keys if isinstance(keys, (list, tuple)) else [keys]
    cols = [Column(dtypes.INT64, int(k.shape[0]), k.to(torch.int64))
            for k in key_list]
    return hash_cuda.murmur_hash3_32(cols, seed=42).data


def _fit(x: torch.Tensor, cap: int, fill) -> torch.Tensor:
    """Slice or pad a (n,) tensor to exactly (cap,)."""
    n = x.shape[0]
    if n >= cap:
        return x[:cap]
    return torch.cat([x, torch.full((cap - n,), fill, dtype=x.dtype,
                                    device=x.device)])


def _identity(op: str) -> int:
    return {"sum": 0, "min": _DEAD_KEY, "max": _I64_MIN}[op]


def _cat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(parts)) if len(parts) > 1 else parts[0]


def _bucket_exchange(n_peers: int, cap: int, part: torch.Tensor,
                     payloads: Sequence[Tuple[torch.Tensor, object]]):
    """The shared bucket-then-exchange step: rows of every peer go by
    `part` into (P, cap) slots and bucket d of every source to peer d; the
    receiver's mask comes from the sent counts. payloads: [(sharded array,
    dead-slot fill)]. Returns (received arrays (P * P * cap,), their valid
    mask, (P,) per-source spill flags)."""
    gidx, counts, valid = exchange_parts(part, n_peers, cap)
    outs = [take_fill(x, gidx, valid, fill) for x, fill in payloads]
    return outs, valid, (counts > cap).any(1)


def _merge_groups(keys, alive: torch.Tensor,
                  cols: Sequence[Tuple[torch.Tensor, str]], key_cap: int):
    """One peer's merge of rows with equal keys (the partial and the final
    stage share it). `keys` is one int64 tensor or a list (rows merge when
    every word is equal); cols [(int64 column, sum|min|max)]; dead rows
    are left out. Returns (keys like the input, outs [(key_cap,)], valid
    (key_cap,), the count of real groups), padded or cut to key_cap as the
    reference pads: past the groups, slots below n repeat the last sorted
    row's key (and its group's min/max), slots past n hold the fills."""
    multi = isinstance(keys, (list, tuple))
    key_list = list(keys) if multi else [keys]
    n = key_list[0].shape[0]
    dev = alive.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    ks = [torch.where(alive, k, _DEAD_KEY) for k in key_list]  # dead last
    order = lex_order(ks) if n else iota
    sks = [k.index_select(0, order) for k in ks]
    salive = alive.index_select(0, order)
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for o in sks:
        neq = neq | (o != torch.roll(o, 1))
    boundary = neq
    if n:
        boundary = neq.clone()
        boundary[0] = True
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    # group starts first (in order), then n: the boundary compaction
    flag = torch.where(boundary, 0, 1).to(torch.int32)
    payload = torch.where(boundary, iota, n)
    starts = payload.index_select(0, torch.argsort(flag, stable=True))
    if n:
        ends = torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int64,
                                                 device=dev)])
    else:
        ends = starts
    last = (ends - 1).clamp(0, max(n - 1, 0))
    prev = starts - 1

    def span_sum(x):
        c = torch.cumsum(x, 0)
        hi = c.index_select(0, last)
        lo = torch.where(prev >= 0, c.index_select(0, prev.clamp(min=0)), 0)
        return hi - lo

    alive_cnt = span_sum(salive.to(torch.int64))
    outs: List[torch.Tensor] = []
    for col, op in cols:
        sc = col.index_select(0, order).to(torch.int64)
        if op == "sum":
            outs.append(span_sum(torch.where(salive, sc, 0)))
        else:
            # the reference's segmented scan read at each span's last row:
            # the reduce over the span
            masked = torch.where(salive, sc, _identity(op))
            seg = torch.zeros(n, dtype=torch.int64, device=dev)
            seg = seg.scatter_reduce(0, gid, masked,
                                     "amin" if op == "min" else "amax",
                                     include_self=False)
            outs.append(seg.index_select(0, gid.index_select(0, last)))
    n_groups = (gid[-1] + 1) if n else torch.zeros((), dtype=torch.int64,
                                                   device=dev)
    in_range = iota < n_groups
    n_real = ((alive_cnt > 0) & in_range).sum()
    valid = (_fit(alive_cnt, key_cap, 0) > 0) & (
        torch.arange(key_cap, device=dev) < n_groups)
    gkeys = [_fit(k.index_select(0, starts.clamp(max=n - 1)), key_cap,
                  _DEAD_KEY) if n else
             torch.full((key_cap,), _DEAD_KEY, dtype=torch.int64, device=dev)
             for k in sks]
    out_keys = gkeys if multi else gkeys[0]
    return out_keys, [_fit(o, key_cap, 0) for o in outs], valid, n_real


def _check_aggs(aggs, n_vals):
    for _, a in aggs:
        if a not in _AGGS:
            raise ValueError(f"unsupported distributed agg {a!r}")
    aggs = tuple((int(i), a) for i, a in aggs)
    for i, a in aggs:
        if a != "count" and not (0 <= i < n_vals):
            raise ValueError(f"agg value index {i} out of range "
                             f"({n_vals} value columns)")
    return aggs


def _partial_cols(aggs, key0, vals):
    ones = torch.ones(key0.shape, dtype=torch.int64, device=key0.device)
    return [(ones if a == "count" else vals[i],
             "sum" if a in ("sum", "count") else a) for i, a in aggs]


def _live(alive, peer, n, dev):
    return (alive[peer] if alive is not None
            else torch.ones(n, dtype=torch.bool, device=dev))


def distributed_groupby(mesh: Mesh, keys: torch.Tensor, vals: torch.Tensor,
                        aggs: Sequence[str], key_cap: int,
                        axis: str = "data"):
    """Groupby over sharded int64 key and value columns: partial aggregate
    -> exchange by key hash -> final aggregate. Returns (keys, [agg
    arrays], valid, overflow), each peer's key_cap slots in turn; overflow
    (P,) means a peer held more than key_cap groups (retry with a bigger
    key_cap)."""
    (gk,), outs, valid, overflow = distributed_groupby_multi(
        mesh, [keys], [vals], [(0, a) for a in aggs], key_cap, axis)
    return gk, outs, valid, overflow


def distributed_groupby_multi(mesh: Mesh, keys: Sequence[torch.Tensor],
                              vals: Sequence[torch.Tensor],
                              aggs: Sequence[Tuple[int, str]], key_cap: int,
                              axis: str = "data", hash_fn=None, alive=None):
    """Multi-key, multi-value groupby over the mesh, aggregating [(value
    index, op)] pairs. `hash_fn(key arrays) -> (n,) hash` sets the
    placement (the typed path passes `keys.spark_partition_hash`; default
    the chained murmur over raw int64 words); `alive` (sharded (n,) bool)
    leaves dead rows out. Returns ([key arrays], [agg arrays], valid,
    overflow)."""
    keys, vals = list(keys), list(vals)
    if not keys:
        raise ValueError("at least one key column is required")
    aggs = _check_aggs(aggs, len(vals))
    P = mesh.shape[axis]
    dev = keys[0].device
    ks = [shards(k, P) for k in keys]
    vs = [shards(v, P) for v in vals]
    al = None if alive is None else shards(alive, P)
    nloc = ks[0].shape[1]
    merge = [("sum" if a in ("sum", "count") else a) for _, a in aggs]
    first = []
    for i in range(P):
        kk = [k[i] for k in ks]
        first.append(_merge_groups(
            kk, _live(al, i, nloc, dev),
            _partial_cols(aggs, kk[0], [v[i] for v in vs]), key_cap))
    gks = [_cat([f[0][j] for f in first]) for j in range(len(keys))]
    partials = [_cat([f[1][j] for f in first]) for j in range(len(aggs))]
    gvalid = _cat([f[2] for f in first])
    overflow = torch.stack([f[3] > key_cap for f in first])
    part = partition_ids((hash_fn or _spark_murmur_i64)(gks), P)
    part = torch.where(gvalid, part, P)
    recv, recv_alive, _ = _bucket_exchange(
        P, key_cap, part, [(g, _DEAD_KEY) for g in gks]
        + [(p, _identity(op)) for p, op in zip(partials, merge)])
    rks = [shards(r, P) for r in recv[:len(keys)]]
    rps = [shards(r, P) for r in recv[len(keys):]]
    ral = shards(recv_alive, P)
    final = []
    for i in range(P):
        final.append(_merge_groups(
            [r[i] for r in rks], ral[i],
            [(r[i], op) for r, op in zip(rps, merge)], key_cap))
    overflow = overflow | torch.stack([f[3] > key_cap for f in final])
    return ([_cat([f[0][j] for f in final]) for j in range(len(keys))],
            [_cat([f[1][j] for f in final]) for j in range(len(aggs))],
            _cat([f[2] for f in final]), overflow)


def distributed_groupby_keyed(mesh: Mesh, key_words: Sequence[torch.Tensor],
                              key_specs, vals: Sequence[torch.Tensor],
                              aggs: Sequence[Tuple[int, str]], key_cap: int,
                              axis: str = "data", alive=None):
    """Typed-key groupby: key columns of any supported kind as word lists
    (`keys.encode_key_columns`), placed by `keys.spark_partition_hash`.
    Decode the returned words with `keys.decode_key_columns(words, specs,
    alive=valid)`."""
    from .keys import spark_partition_hash
    return distributed_groupby_multi(
        mesh, key_words, vals, aggs, key_cap, axis,
        hash_fn=lambda ws: spark_partition_hash(ws, key_specs), alive=alive)


def distributed_local_groupby(mesh: Mesh, key_words: Sequence[torch.Tensor],
                              vals: Sequence[torch.Tensor],
                              aggs: Sequence[Tuple[int, str]], key_cap: int,
                              axis: str = "data", alive=None):
    """The groupby of an input whose groups are already each on one peer
    (below an elided exchange): one merge per peer, no exchange. The
    contract of `distributed_groupby_multi`; overflow means a peer held
    more than key_cap live groups."""
    key_words, vals = list(key_words), list(vals)
    aggs = _check_aggs(aggs, len(vals))
    P = mesh.shape[axis]
    dev = key_words[0].device
    ks = [shards(k, P) for k in key_words]
    vs = [shards(v, P) for v in vals]
    al = None if alive is None else shards(alive, P)
    nloc = ks[0].shape[1]
    res = []
    for i in range(P):
        kk = [k[i] for k in ks]
        res.append(_merge_groups(
            kk, _live(al, i, nloc, dev),
            _partial_cols(aggs, kk[0], [v[i] for v in vs]), key_cap))
    return ([_cat([r[0][j] for r in res]) for j in range(len(key_words))],
            [_cat([r[1][j] for r in res]) for j in range(len(aggs))],
            _cat([r[2] for r in res]),
            torch.stack([r[3] > key_cap for r in res]))


def distributed_repartition_keyed(mesh: Mesh,
                                  key_words: Sequence[torch.Tensor],
                                  key_specs, vals: Sequence[torch.Tensor],
                                  slack: float = 2.0, axis: str = "data",
                                  alive=None, word_codecs=None,
                                  word_refs=None):
    """The standalone hash exchange of one relation (an `Exchange(hash)`):
    every live row moves to the peer of the Spark hash of its key words
    (pmod P); dead rows are dropped by the bucketing.

    `word_codecs` ("raw" | "forN" per word) and `word_refs` ((1,) int64
    references, one per narrowed word in order) carry the narrowed wire
    form (`plan.transport.narrow_words`): the hash runs over the words
    widened back to 64 bits, the exchange moves the narrow planes, so
    placement is the raw path's.

    Returns ([key words], [vals], valid, overflow); the key words come back
    in the wire form they were given. overflow (P,): a bucket spilled its
    slack-sized capacity."""
    from .keys import spark_partition_hash
    P = mesh.shape[axis]
    key_words, vals = list(key_words), list(vals)
    codecs = tuple(word_codecs) if word_codecs else ("raw",) * len(key_words)
    hash_fn = lambda ws: spark_partition_hash(ws, key_specs)  # noqa: E731
    if any(c != "raw" for c in codecs):
        refs = iter(word_refs or [])
        ws64 = [w if c == "raw" else next(refs)[0] + widen_unsigned(w)
                for w, c in zip(key_words, codecs)]
        fills = [_DEAD_KEY if c == "raw" else 0 for c in codecs]
        Ws, Vs, recv_alive, spilled = _hash_exchange(
            P, slack, key_words, vals, hash_fn, alive=alive,
            hash_keys=ws64, key_fills=fills)
    else:
        Ws, Vs, recv_alive, spilled = _hash_exchange(
            P, slack, key_words, vals, hash_fn, alive=alive)
    return Ws, Vs, recv_alive, spilled.expand(P).clone()


def _check_word_counts(l_words, r_words):
    if len(r_words) != len(l_words):
        raise ValueError(
            f"join key word counts differ: left {len(l_words)} vs right "
            f"{len(r_words)}; encode both sides with identical KeySpecs")


def _semi_keep(lw, rw, lmatch, rmatch, lal, semi: bool):
    nl = lw[0].shape[0]
    operands = tuple(torch.cat([a, b]) for a, b in zip(lw, rw))
    counts, _, _ = join_spans(operands, lmatch, rmatch, nl=nl,
                              need_rorder=False)
    hit = counts > 0
    return lal & (hit if semi else ~hit)


def distributed_colocated_join_keyed(mesh: Mesh,
                                     l_words: Sequence[torch.Tensor],
                                     lvals: Sequence[torch.Tensor],
                                     r_words: Sequence[torch.Tensor],
                                     rvals: Sequence[torch.Tensor],
                                     key_specs, row_cap: int = 0,
                                     axis: str = "data", how: str = "inner",
                                     lalive=None, ralive=None,
                                     r_replicated: bool = False):
    """Equi-join of two aligned sides with no exchange: both sides
    hash-partitioned by matching key tuples, or the right side replicated
    (`r_replicated`: every peer sees all of it). `how`: inner (row_cap
    slots a peer) or left_semi / left_anti (left-shaped). NULL keys never
    match.

    Returns: inner -> ([l key words], [lvals], [rvals], valid, overflow);
    semi/anti -> ([l key words], [lvals], keep, overflow)."""
    from .keys import keys_null_mask
    l_words, lvals = list(l_words), list(lvals)
    r_words, rvals = list(r_words), list(rvals)
    _check_word_counts(l_words, r_words)
    if how not in ("inner", "left_semi", "left_anti"):
        raise ValueError(f"unsupported colocated join type {how!r}")
    P = mesh.shape[axis]
    dev = l_words[0].device

    def side(arrs, replicated):
        if replicated:
            return [[a] * P for a in arrs]
        return [list(shards(a, P)) for a in arrs]

    lw, lv = side(l_words, False), side(lvals, False)
    rw, rv = side(r_words, r_replicated), side(rvals, r_replicated)
    lal = None if lalive is None else side([lalive], False)[0]
    ral = None if ralive is None else side([ralive], r_replicated)[0]
    res = []
    for i in range(P):
        Lw, Rw = [w[i] for w in lw], [w[i] for w in rw]
        Lal = _live(lal, i, Lw[0].shape[0], dev)
        Ral = _live(ral, i, Rw[0].shape[0], dev)
        lmatch = Lal & ~keys_null_mask(Lw, key_specs)
        rmatch = Ral & ~keys_null_mask(Rw, key_specs)
        if how != "inner":
            keep = _semi_keep(Lw, Rw, lmatch, rmatch, Lal,
                              how == "left_semi")
            res.append(([torch.where(keep, w, 0) for w in Lw],
                        [where_zero(keep, v[i]) for v in lv], keep))
            continue
        res.append(_local_join_tail(Lw, [v[i] for v in lv], Lal, Rw,
                                    [v[i] for v in rv], Ral, row_cap,
                                    lmatch=lmatch, rmatch=rmatch))
    lw_out = [_cat([r[0][j] for r in res]) for j in range(len(l_words))]
    lv_out = [_cat([r[1][j] for r in res]) for j in range(len(lvals))]
    if how != "inner":
        return (lw_out, lv_out, _cat([r[2] for r in res]),
                torch.zeros(P, dtype=torch.bool, device=dev))
    return (lw_out, lv_out,
            [_cat([r[2][j] for r in res]) for j in range(len(rvals))],
            _cat([r[4] for r in res]), torch.stack([r[5] for r in res]))


def distributed_sort(mesh: Mesh, keys: torch.Tensor, vals: torch.Tensor,
                     slack: float = 2.0, axis: str = "data"):
    """Global sort of sharded (key, value) columns, a sample sort: peer 0
    ends with the smallest keys, each peer sorted. Returns (keys, vals,
    valid, overflow); overflow means a peer received more than its
    capacity (skew; retry with bigger slack)."""
    (w,), ov, valid, overflow = distributed_sort_keyed(
        mesh, [keys], None, vals, slack=slack, axis=axis)
    return w, ov, valid, overflow


def distributed_sort_keyed(mesh: Mesh, key_words: Sequence[torch.Tensor],
                           key_specs, vals, slack: float = 2.0,
                           axis: str = "data", alive=None):
    """Global sort over typed key words (order-preserving, so splitters
    are word tuples), the reference's sample sort: each peer sorts and
    samples P-1 tuples from its live rows, the pooled samples give the
    splitters, rows go by splitter interval (a row equal to a splitter
    stays below it) through the exchange, and each peer sorts what it
    received. `vals` is one array or a list; `alive` marks live rows.
    Returns ([key words], vals (as given), valid, overflow)."""
    del key_specs       # the caller's decode needs them, the sort does not
    P = mesh.shape[axis]
    key_words = list(key_words)
    nw = len(key_words)
    multi_vals = isinstance(vals, (list, tuple))
    val_list = list(vals) if multi_vals else [vals]
    dev = key_words[0].device
    ws = [shards(w, P) for w in key_words]
    vs = [shards(v, P) for v in val_list]
    al = None if alive is None else shards(alive, P)
    nloc = ws[0].shape[1]
    cap = max(1, math.ceil(nloc / P * slack))
    sorted_ws, sorted_vs, sorted_alive, samples = [], [], [], []
    pos_base = torch.arange(1, P, dtype=torch.int64, device=dev)
    for i in range(P):
        live = _live(al, i, nloc, dev)
        ks = [torch.where(live, w[i], _DEAD_KEY) for w in ws]
        order = lex_order(ks) if nloc else torch.arange(0, device=dev)
        sws = [k.index_select(0, order) for k in ks]
        sorted_ws.append(sws)
        sorted_vs.append([take_rows(v[i], order) for v in vs])
        salive = live.index_select(0, order)
        sorted_alive.append(salive)
        nlive = salive.to(torch.int64).sum()
        pos = (pos_base * nlive) // P
        samples.append([w.index_select(0, pos.clamp(0, max(nloc - 1, 0)))
                        if nloc else torch.zeros(P - 1, dtype=torch.int64,
                                                 device=dev)
                        for w in sws])
    pools = [torch.cat([s[j] for s in samples]) for j in range(nw)]
    m = pools[0].shape[0]
    porder = lex_order(pools) if m else torch.arange(0, device=dev)
    pool_sorted = [p.index_select(0, porder) for p in pools]
    spl_pos = (torch.arange(1, P, dtype=torch.int64, device=dev) * m) // P
    spl = [p.index_select(0, spl_pos.clamp(0, max(m - 1, 0)))
           for p in pool_sorted]
    parts = []
    for i in range(P):
        lt = torch.zeros((nloc, P - 1), dtype=torch.bool, device=dev)
        eq = torch.ones((nloc, P - 1), dtype=torch.bool, device=dev)
        for w, s in zip(sorted_ws[i], spl):
            lt = lt | (eq & (s[None, :] < w[:, None]))
            eq = eq & (s[None, :] == w[:, None])
        part = lt.sum(1).to(torch.int32)
        parts.append(torch.where(sorted_alive[i], part, P))
    flat_ws = [_cat([s[j] for s in sorted_ws]) for j in range(nw)]
    flat_vs = [_cat([s[j] for s in sorted_vs]) for j in range(len(vs))]
    recv, ralive, spilled = _bucket_exchange(
        P, cap, _cat(parts), [(w, _DEAD_KEY) for w in flat_ws]
        + [(v, 0) for v in flat_vs])
    spilled = spilled.any()
    rws = [shards(r, P) for r in recv[:nw]]
    rvs = [shards(r, P) for r in recv[nw:]]
    ral = shards(ralive, P)
    out_w = [[] for _ in range(nw)]
    out_v = [[] for _ in range(len(vs))]
    out_valid = []
    for i in range(P):
        dead = torch.where(ral[i], 0, 1).to(torch.int32)
        keyed = [torch.where(ral[i], w[i], _DEAD_KEY) for w in rws]
        order = lex_order(keyed + [dead])
        for j in range(nw):
            out_w[j].append(keyed[j].index_select(0, order))
        for j in range(len(vs)):
            out_v[j].append(take_rows(rvs[j][i], order))
        out_valid.append(dead.index_select(0, order) == 0)
    out_vs = [_cat(v) for v in out_v]
    return ([_cat(w) for w in out_w],
            out_vs if multi_vals else out_vs[0], _cat(out_valid),
            spilled.expand(P).clone())


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _local_join_tail(lk, lv, lalive, rk, rv, ralive, row_cap: int,
                     outer: bool = False, lmatch=None, rmatch=None):
    """One peer's inner or left-outer join into row_cap slots: the union
    sort's spans and their padded expansion. Keys are one array or word
    lists; rows match when every word is equal. `lmatch`/`rmatch`
    (default the alive masks) restrict matching only: a null-keyed left
    row under `outer` is still emitted, never matched. Returns (lkeys,
    lvals, rvals, rmatched, live, overflow scalar); rmatched is False on
    unmatched left-outer rows (their right values are 0, read as null)."""
    lks, rks = _as_list(lk), _as_list(rk)
    lvs, rvs = _as_list(lv), _as_list(rv)
    lmatch = lalive if lmatch is None else lmatch
    rmatch = ralive if rmatch is None else rmatch
    nl, nr = lks[0].shape[0], rks[0].shape[0]
    dev = lks[0].device
    operands = tuple(torch.cat([a, b]) for a, b in zip(lks, rks))
    counts, lo, rorder = join_spans(operands, lmatch, rmatch, nl=nl)
    if outer:
        # dead rows emit nothing, so the live slots are a prefix
        eff = torch.where(lalive, counts.clamp(min=1), 0)
        total = eff.to(torch.int64).sum()
    else:
        eff = None
        total = counts.to(torch.int64).sum()
    lsel, rsel = expand_spans(counts, lo, rorder, total=row_cap, outer=outer,
                              eff=eff)
    live = torch.arange(row_cap, device=dev) < total
    rmatched = (rsel >= 0) if outer else torch.ones(row_cap,
                                                    dtype=torch.bool,
                                                    device=dev)
    lsel = lsel.to(torch.int64).clamp(0, max(nl - 1, 0))
    rsafe = rsel.to(torch.int64).clamp(0, max(nr - 1, 0))

    def take(x, idx, mask):
        if x.shape[0] == 0:
            return torch.zeros(row_cap, dtype=x.dtype, device=dev)
        return where_zero(mask, take_rows(x, idx))

    out_lks = [take(k, lsel, live) for k in lks]
    out_lvs = [take(v, lsel, live) for v in lvs]
    out_rvs = [take(v, rsafe, live & rmatched) for v in rvs]
    return (out_lks, out_lvs, out_rvs, rmatched & live, live,
            total > row_cap)


def _hash_exchange(n_peers: int, slack: float, keys, vals, hash_fn=None,
                   alive=None, hash_keys=None, key_fills=None):
    """Hash-partition one table side by Spark murmur pmod and exchange it
    (every distributed join's shuffle). `keys` one int64 array or a word
    list; `vals` None, one array or a list; `alive` marks live rows (dead
    ones go to the id P and are dropped); `hash_keys` (default `keys`) are
    what the hash reads, `key_fills` each key plane's dead-slot fill
    (default `_DEAD_KEY`). Returns (key outs, val outs, alive, spilled, a
    () bool for every peer: a spill anywhere means some peer received an
    incomplete side)."""
    key_list = _as_list(keys)
    val_list = [] if vals is None else _as_list(vals)
    nloc = key_list[0].shape[0] // n_peers
    cap = max(1, math.ceil(nloc / n_peers * slack))
    hash_list = key_list if hash_keys is None else _as_list(hash_keys)
    part = partition_ids((hash_fn or _spark_murmur_i64)(hash_list), n_peers)
    if alive is not None:
        part = torch.where(alive, part, n_peers)
    fills = ([_DEAD_KEY] * len(key_list) if key_fills is None
             else list(key_fills))
    payloads = list(zip(key_list, fills)) + [(v, 0) for v in val_list]
    outs, recv_alive, spilled = _bucket_exchange(n_peers, cap, part,
                                                 payloads)
    nk = len(key_list)
    return outs[:nk], outs[nk:], recv_alive, spilled.any()


def _per_peer_join(P, L, R, row_cap, outer, key_specs=None):
    """The per-peer tails of a shuffled or broadcast join over received
    sides L, R = (key words, vals, alive, replicated)."""
    from .keys import keys_null_mask
    res = []
    lw, lv, lal, _ = L
    rw, rv, ral, rrep = R
    dev = lw[0].device

    def peer(arrs, i, rep):
        return [a if rep else shards(a, P)[i] for a in arrs]

    for i in range(P):
        Lw, Lv = peer(lw, i, False), peer(lv, i, False)
        Rw, Rv = peer(rw, i, rrep), peer(rv, i, rrep)
        Lal = (shards(lal, P)[i] if lal is not None else
               torch.ones(Lw[0].shape[0], dtype=torch.bool, device=dev))
        Ral = ((ral if rrep else shards(ral, P)[i]) if ral is not None else
               torch.ones(Rw[0].shape[0], dtype=torch.bool, device=dev))
        lmatch = rmatch = None
        if key_specs is not None:
            lmatch = Lal & ~keys_null_mask(Lw, key_specs)
            rmatch = Ral & ~keys_null_mask(Rw, key_specs)
        res.append(_local_join_tail(Lw, Lv, Lal, Rw, Rv, Ral, row_cap,
                                    outer=outer, lmatch=lmatch,
                                    rmatch=rmatch))
    return ([_cat([r[0][j] for r in res]) for j in range(len(lw))],
            [_cat([r[1][j] for r in res]) for j in range(len(lv))],
            [_cat([r[2][j] for r in res]) for j in range(len(rv))],
            _cat([r[3] for r in res]), _cat([r[4] for r in res]),
            torch.stack([r[5] for r in res]))


def distributed_inner_join(mesh: Mesh, lkeys: torch.Tensor,
                           lvals: torch.Tensor, rkeys: torch.Tensor,
                           rvals: torch.Tensor, row_cap: int,
                           slack: float = 2.0, axis: str = "data"):
    """Inner equi-join of two sharded int64-keyed tables: both sides
    hash-partitioned (slack-sized buckets), exchanged, and joined per peer
    into row_cap slots. Returns (lkey, lval, rval, valid, overflow);
    overflow covers bucket spills and join outputs past row_cap."""
    P = mesh.shape[axis]
    Lk, Lv, Lal, lspill = _hash_exchange(P, slack, lkeys, lvals)
    Rk, Rv, Ral, rspill = _hash_exchange(P, slack, rkeys, rvals)
    lk, lv, rv, _, live, jover = _per_peer_join(
        P, (Lk, Lv, Lal, False), (Rk, Rv, Ral, False), row_cap, False)
    return lk[0], lv[0], rv[0], live, jover | lspill | rspill


def _distributed_join_keyed(mesh, l_words, lvals, r_words, rvals, key_specs,
                            row_cap, slack, axis, outer, broadcast=False):
    """The typed-key equi-join (inner, left-outer, broadcast): exchange
    both sides by the Spark hash of the words, or (`broadcast`) give every
    peer the whole right side while the left never moves, then join per
    peer; NULL keys never match."""
    from .keys import spark_partition_hash
    P = mesh.shape[axis]
    hash_fn = lambda ws: spark_partition_hash(ws, key_specs)  # noqa: E731
    l_words, lvals = list(l_words), list(lvals)
    r_words, rvals = list(r_words), list(rvals)
    _check_word_counts(l_words, r_words)
    dev = l_words[0].device
    if broadcast:
        L = (l_words, lvals, None, False)
        R = (r_words, rvals, None, True)
        spill = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        Lw, Lv, Lal, lspill = _hash_exchange(P, slack, l_words, lvals,
                                             hash_fn)
        Rw, Rv, Ral, rspill = _hash_exchange(P, slack, r_words, rvals,
                                             hash_fn)
        L, R = (Lw, Lv, Lal, False), (Rw, Rv, Ral, False)
        spill = lspill | rspill
    lw, lv, rv, rvalid, live, jover = _per_peer_join(
        P, L, R, row_cap, outer, key_specs)
    outs = (lw, lv, rv)
    if outer:
        return outs + (rvalid, live, jover | spill)
    return outs + (live, jover | spill)


def distributed_inner_join_keyed(mesh: Mesh, l_words, lvals, r_words, rvals,
                                 key_specs, row_cap: int, slack: float = 2.0,
                                 axis: str = "data"):
    """Typed-key inner join: word lists from `keys.encode_key_columns`,
    placed by `keys.spark_partition_hash`; NULL keys never match. Returns
    ([l key words], [lvals], [rvals], valid, overflow)."""
    return _distributed_join_keyed(mesh, l_words, lvals, r_words, rvals,
                                   key_specs, row_cap, slack, axis,
                                   outer=False)


def distributed_broadcast_join(mesh: Mesh, lkeys: torch.Tensor,
                               lvals: torch.Tensor, rkeys: torch.Tensor,
                               rvals: torch.Tensor, row_cap: int,
                               axis: str = "data"):
    """Broadcast inner equi-join: every peer sees the whole (small) right
    side, the probe side never moves, and each peer joins locally.
    Returns (lkey, lval, rval, valid, overflow) as the shuffle join."""
    P = mesh.shape[axis]
    lk, lv, rv, _, live, over = _per_peer_join(
        P, ([lkeys], [lvals], None, False), ([rkeys], [rvals], None, True),
        row_cap, False)
    return lk[0], lv[0], rv[0], live, over


def distributed_broadcast_join_keyed(mesh: Mesh, l_words, lvals, r_words,
                                     rvals, key_specs, row_cap: int,
                                     axis: str = "data"):
    """Typed-key broadcast inner join (see `distributed_broadcast_join`);
    NULL keys never match. Returns ([l key words], [lvals], [rvals],
    valid, overflow)."""
    return _distributed_join_keyed(mesh, l_words, lvals, r_words, rvals,
                                   key_specs, row_cap, slack=1.0, axis=axis,
                                   outer=False, broadcast=True)


def distributed_left_join_keyed(mesh: Mesh, l_words, lvals, r_words, rvals,
                                key_specs, row_cap: int, slack: float = 2.0,
                                axis: str = "data"):
    """Typed-key left-outer join. Returns ([l key words], [lvals],
    [rvals], rvalid, valid, overflow); rvalid is False on unmatched left
    rows, null-keyed ones included."""
    return _distributed_join_keyed(mesh, l_words, lvals, r_words, rvals,
                                   key_specs, row_cap, slack, axis,
                                   outer=True)


def distributed_left_join(mesh: Mesh, lkeys: torch.Tensor,
                          lvals: torch.Tensor, rkeys: torch.Tensor,
                          rvals: torch.Tensor, row_cap: int,
                          slack: float = 2.0, axis: str = "data"):
    """Left-outer equi-join, the shuffle of `distributed_inner_join`.
    Returns (lkey, lval, rval, rvalid, valid, overflow)."""
    P = mesh.shape[axis]
    Lk, Lv, Lal, lspill = _hash_exchange(P, slack, lkeys, lvals)
    Rk, Rv, Ral, rspill = _hash_exchange(P, slack, rkeys, rvals)
    lk, lv, rv, rvalid, live, jover = _per_peer_join(
        P, (Lk, Lv, Lal, False), (Rk, Rv, Ral, False), row_cap, True)
    return lk[0], lv[0], rv[0], rvalid, live, jover | lspill | rspill


def _semi_anti(P, Lw, Lv, Lal, Rw, Ral, semi, key_specs=None):
    from .keys import keys_null_mask
    keeps, out_w, out_v = [], [[] for _ in Lw], [[] for _ in Lv]
    for i in range(P):
        lw = [shards(w, P)[i] for w in Lw]
        rw = [shards(w, P)[i] for w in Rw]
        lal, ral = shards(Lal, P)[i], shards(Ral, P)[i]
        lmatch, rmatch = lal, ral
        if key_specs is not None:
            lmatch = lal & ~keys_null_mask(lw, key_specs)
            rmatch = ral & ~keys_null_mask(rw, key_specs)
        keep = _semi_keep(lw, rw, lmatch, rmatch, lal, semi)
        keeps.append(keep)
        for j, w in enumerate(lw):
            out_w[j].append(torch.where(keep, w, 0))
        for j, v in enumerate(Lv):
            out_v[j].append(where_zero(keep, shards(v, P)[i]))
    return [_cat(w) for w in out_w], [_cat(v) for v in out_v], _cat(keeps)


def _distributed_semi_anti(mesh, lkeys, lvals, rkeys, semi, slack, axis):
    """Mark each left row matched or not after the exchange; the output
    stays left-shaped."""
    P = mesh.shape[axis]
    Lk, Lv, Lal, lspill = _hash_exchange(P, slack, lkeys, lvals)
    Rk, _, Ral, rspill = _hash_exchange(P, slack, rkeys, None)
    (lk,), (lv,), keep = _semi_anti(P, Lk, Lv, Lal, Rk, Ral, semi)
    return lk, lv, keep, (lspill | rspill).expand(P).clone()


def _distributed_semi_anti_keyed(mesh, l_words, lvals, r_words, key_specs,
                                 semi, slack, axis):
    """The typed-key semi/anti join: a null-keyed left row is dropped by
    semi and kept by anti."""
    from .keys import spark_partition_hash
    P = mesh.shape[axis]
    hash_fn = lambda ws: spark_partition_hash(ws, key_specs)  # noqa: E731
    l_words, lvals, r_words = list(l_words), list(lvals), list(r_words)
    _check_word_counts(l_words, r_words)
    Lw, Lv, Lal, lspill = _hash_exchange(P, slack, l_words, lvals, hash_fn)
    Rw, _, Ral, rspill = _hash_exchange(P, slack, r_words, None, hash_fn)
    lw, lv, keep = _semi_anti(P, Lw, Lv, Lal, Rw, Ral, semi, key_specs)
    return lw, lv, keep, (lspill | rspill).expand(P).clone()


def distributed_left_semi_join_keyed(mesh, l_words, lvals, r_words,
                                     key_specs, slack: float = 2.0,
                                     axis: str = "data"):
    """Typed-key left-semi join: left rows with at least one match.
    Returns ([l key words], [lvals], valid, overflow)."""
    return _distributed_semi_anti_keyed(mesh, l_words, lvals, r_words,
                                        key_specs, True, slack, axis)


def distributed_left_anti_join_keyed(mesh, l_words, lvals, r_words,
                                     key_specs, slack: float = 2.0,
                                     axis: str = "data"):
    """Typed-key left-anti join: left rows with no match."""
    return _distributed_semi_anti_keyed(mesh, l_words, lvals, r_words,
                                        key_specs, False, slack, axis)


def distributed_left_semi_join(mesh: Mesh, lkeys, lvals, rkeys,
                               slack: float = 2.0, axis: str = "data"):
    """Left rows with at least one match. Returns (lkey, lval, valid,
    overflow), left-sized."""
    return _distributed_semi_anti(mesh, lkeys, lvals, rkeys, True, slack,
                                  axis)


def distributed_left_anti_join(mesh: Mesh, lkeys, lvals, rkeys,
                               slack: float = 2.0, axis: str = "data"):
    """Left rows with no match; the contract of the semi join."""
    return _distributed_semi_anti(mesh, lkeys, lvals, rkeys, False, slack,
                                  axis)
