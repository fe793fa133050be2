"""The distributed tier of the eager executor: a whole plan over a mesh.

Counterpart of `spark_rapids_tpu/plan/distributed.py`. When
`PlanExecutor(mesh=...)` runs an eager plan, every operator with a
distributed form runs over a `ShardedRel`: a padded, row-sharded relation
(global tensors whose leading axis splits evenly over the mesh's P peers,
a live-row mask, and the hash-partitioning claim its rows satisfy). Rows
move only at `Exchange` nodes (hash, broadcast, gather) and inside the
two-phase aggregate and the sample sort:

- Scan: the bound table pads to a multiple of P and shards by rows
  (dead padding rows are zero and not live). A Parquet source is read
  once, pruned and projected (the distributed tier has no streaming
  prefix), then sharded.
- Filter / Project / FusedSelect: element-wise over the sharded columns;
  a filter narrows the live mask, nothing is compacted.
- Exchange(hash): `distributed_repartition_keyed`; Exchange(broadcast):
  the build side replicated to every peer; Exchange(gather): the relation
  collected and compacted to one relation (the sink, or the input of an
  operator with no distributed form).
- HashJoin: both sides aligned (or the right replicated) join per peer
  with `distributed_colocated_join_keyed`; an unplanned join
  repartitions its sides itself.
- HashAggregate over a hash Exchange fuses into the two-phase
  `distributed_groupby_keyed` (partials cross, not rows); over an input
  already partitioned by a subset of its keys the exchange is elided and
  `distributed_local_groupby` merges per peer.
- Sort / TopK: `distributed_sort_keyed` (descending keys as inverted
  words); TopK keeps the global rank prefix.
- Union: the logical concatenation, resharded.

Capacities (row_cap, key_cap, slack) grow by `auto_retry_overflow` and
the final ones are kept per (plan fingerprint, node, primitive) on the
executor. Gates, as the reference's: fixed-width 1-D columns only;
aggregate values non-null integers or bools (exact int64 partials); no
`mean`; a keyless aggregate and a Limit have no distributed form; such a
node gathers its inputs and runs on the local eager path. Relations carry
`order_keys`, so that a gather re-sorts an aggregate's output by its keys
into the local kernel's order.

Transport (`plan/transport.py`): with packing on, every exchange moves
packed planes and unpacks on the receiving side; `exchange_bytes` is the
wire form and `exchange_bytes_logical` the unpacked payload, live rows
only, each edge once (broadcast x (P - 1)). On one device the gather
decodes and compacts the planes where they are. With
SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC on, an Exchange's pack and transfer run
on a worker thread (`PendingRel`) until its consumer resolves it; on a
CUDA mesh the worker enqueues on the consumer's stream, so the work stays
in stream order.

On the card the exchange map is the `px_exchange_map` kernel and the
partition hash the row-hash kernel (`parallel.relational`).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import dtypes
from ..columnar import Column, Table
from ..parallel.keys import (KeySpec, _ONE_WORD_KINDS, decode_key_columns,
                             encode_key_column)
from . import transport
from .expr import ColumnRef
from .nodes import (Exchange, Filter, FusedSelect, HashAggregate, HashJoin,
                    Limit, PlanNode, Project, Scan, Sort, TopK, Union)

__all__ = ["transfer_part", "part_satisfies", "join_alignment",
           "ShardedRel", "PendingRel", "DistContext", "shard_table",
           "table_shardable"]

_KEYABLE_KINDS = set(_ONE_WORD_KINDS) | {dtypes.Kind.FLOAT32,
                                         dtypes.Kind.FLOAT64}
_DIST_AGGS = ("sum", "count", "min", "max", "size")
# the starting slack of the fixed-capacity exchange buckets (capacity =
# rows/peer x slack); skew past it sets the overflow flag, and the executor
# retries with the slack grown (parallel/autoretry.py)
DIST_SLACK = 2.0


class ShardedRel:
    """A relation on the mesh: `table`'s columns are global tensors split
    by rows over the peers (or whole on every peer when `replicated`, a
    broadcast build side), `valid` marks live rows, `part` is the set of
    key tuples the rows are hash-partitioned by, and `order_keys` names
    the columns a gather re-sorts by (set by aggregates). Reads like a
    Table where the executor's metrics need it: `columns`, `num_rows`
    (live rows, one host read) and `nbytes()`."""

    __slots__ = ("table", "valid", "part", "replicated", "order_keys",
                 "_num_rows", "_local")

    def __init__(self, table: Table, valid: torch.Tensor,
                 part: frozenset = frozenset(), replicated: bool = False,
                 order_keys: Optional[List[str]] = None):
        self.table = table
        self.valid = valid
        self.part = part
        self.replicated = replicated
        self.order_keys = order_keys
        self._num_rows = None
        self._local = None

    @property
    def columns(self):
        return self.table.columns

    @property
    def num_rows(self) -> int:
        if self._num_rows is None:
            self._num_rows = int(self.valid.sum())
        return self._num_rows

    @property
    def padded_rows(self) -> int:
        return self.table.num_rows

    def nbytes(self) -> int:
        return self.table.nbytes()

    def sharding_str(self, n_peers: int) -> str:
        return _sharding_str(self.part, self.replicated, n_peers)

    def to_local_table(self) -> Table:
        """The live rows as one relation (the sink), re-sorted by
        `order_keys` when set. Cached: shared consumers gather once."""
        if self._local is None:
            self._local = _compact(self.table, self.valid, self.order_keys)
        return self._local


def _compact(table: Table, valid: torch.Tensor, order_keys) -> Table:
    from ..ops import plan_ops
    idx = torch.nonzero(valid).reshape(-1)
    cols = [Column(c.dtype, int(idx.shape[0]), c.data.index_select(0, idx),
                   None if c.validity is None
                   else c.validity.index_select(0, idx))
            for c in table.columns]
    t = Table(cols, names=list(table.names))
    if order_keys:
        t = plan_ops.sort_table(t, list(order_keys),
                                [True] * len(order_keys))
    return t


def _sharding_str(part: frozenset, replicated: bool, n_peers: int) -> str:
    if replicated:
        return f"replicated@{n_peers}"
    if part:
        keys = min(part)   # a deterministic pick for display
        return f"hash[{','.join(keys)}]@{n_peers}"
    return f"rows@{n_peers}"


class PendingRel:
    """A ShardedRel still being made on an exchange worker thread
    (SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC): the plan walk goes on past the
    Exchange, and the first consumer `resolve()`s it. The transfer time
    that ran while the consumer was not waiting is the edge's
    `exchange_overlap_ms`. `part`/`replicated` are known statically, so
    the metrics stamp `sharding` without waiting; every data accessor
    resolves first. A worker's error raises at the consumer once; a later
    resolve (the consumer's fault retry) reruns the exchange
    synchronously. On a CUDA mesh the worker enqueues on the stream that
    was current where the exchange was dispatched, and waits for its work
    before it finishes."""

    pending = True

    def __init__(self, fn, metric, nbytes_fn, device: torch.device,
                 part: frozenset = frozenset(), replicated: bool = False):
        self._fn = fn
        self._metric = metric
        self._nbytes_fn = nbytes_fn
        self.part = part
        self.replicated = replicated
        self._result = None
        self._err = None
        self._t0 = self._t1 = 0.0
        self._resolved = False
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)

        def work():
            self._t0 = time.perf_counter()
            try:
                if stream is not None:
                    with torch.cuda.stream(stream):
                        out = fn()
                        stream.synchronize()
                else:
                    out = fn()
                self._result = out
            except BaseException as e:    # raised at the consumer
                self._err = e
            finally:
                self._t1 = time.perf_counter()

        self._thread = threading.Thread(
            target=work, daemon=True, name="spark-rapids-torch-exchange")
        self._thread.start()

    def _stamp(self, dur: float) -> None:
        m = self._metric
        m.wall_ms = dur * 1e3
        m.rows_out = self._result.num_rows
        m.bytes_out = self._nbytes_fn(self._result.table)

    def resolve(self) -> "ShardedRel":
        if not self._resolved:
            w0 = time.perf_counter()
            self._thread.join()
            blocked = time.perf_counter() - w0
            self._resolved = True
            dur = self._t1 - self._t0
            self._metric.exchange_overlap_ms = max(0.0, dur - blocked) * 1e3
            if self._result is not None:
                self._stamp(dur)
        if self._result is None:
            err, self._err = self._err, None
            if err is not None:
                raise err
            t0 = time.perf_counter()
            self._result = self._fn()
            self._stamp(time.perf_counter() - t0)
        return self._result

    def sharding_str(self, n_peers: int) -> str:
        return _sharding_str(self.part, self.replicated, n_peers)

    @property
    def table(self):
        return self.resolve().table

    @property
    def valid(self):
        return self.resolve().valid

    @property
    def columns(self):
        return self.resolve().columns

    @property
    def num_rows(self) -> int:
        return self.resolve().num_rows

    @property
    def padded_rows(self) -> int:
        return self.resolve().padded_rows

    @property
    def order_keys(self):
        return self.resolve().order_keys

    def nbytes(self) -> int:
        return self.resolve().nbytes()

    def to_local_table(self) -> Table:
        return self.resolve().to_local_table()


def _resolve_rel(c):
    return c.resolve() if getattr(c, "pending", False) else c


def table_shardable(t: Table) -> bool:
    """Whether every column can ride the distributed tier: fixed-width
    1-D buffers only (strings, lists and DECIMAL128 keep the plan local,
    a gather boundary, not an error)."""
    return all(c.data is not None and c.offsets is None and not c.children
               and c.data.dim() == 1 for c in t.columns)


def shard_table(mesh, axis: str, t: Table,
                part: frozenset = frozenset()) -> ShardedRel:
    """Pad a table to a multiple of the mesh's peers and shard it by rows
    (padding rows zero, validity False, not live). An empty table becomes
    one dead row a peer, so no peer's shape is empty."""
    n_peers = mesh.shape[axis]
    n = t.num_rows
    pad = (-n) % n_peers if n else n_peers
    dev = t.device if t.columns else mesh.device

    def put(a, fill):
        if pad:
            a = torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                         device=a.device)])
        return a

    cols = [Column(c.dtype, n + pad, put(c.data, 0),
                   None if c.validity is None else put(c.validity, False))
            for c in t.columns]
    valid = put(torch.ones(n, dtype=torch.bool, device=dev), False)
    return ShardedRel(Table(cols, names=list(t.names)), valid, part=part)


# ---- value packing (columns <-> primitive payload arrays) ---------------------

def _pack_cols(t: Table, names: List[str]):
    """Columns -> flat payload arrays for the exchange primitives: each
    column's data, and its validity when nullable. Returns (arrays,
    layout)."""
    arrays, layout = [], []
    for nm in names:
        c = t[nm]
        arrays.append(c.data)
        has_v = c.validity is not None
        if has_v:
            arrays.append(c.validity)
        layout.append((nm, c.dtype, has_v))
    return arrays, layout


def _unpack_cols(arrays, layout) -> List[Column]:
    cols = []
    i = 0
    for nm, dt, has_v in layout:
        data = arrays[i].to(dt.storage_dtype())
        i += 1
        validity = None
        if has_v:
            validity = arrays[i].to(torch.bool)
            i += 1
        cols.append(Column(dt, int(data.shape[0]), data, validity))
    return cols


def _key_specs(lt: Table, lkeys, rt: Optional[Table] = None,
               rkeys=None) -> Optional[List[KeySpec]]:
    """The shared static key layout of one or two sides; None when a key
    kind has no distributed encoding here (or the sides' kinds differ)."""
    specs = []
    for i, lk in enumerate(lkeys):
        lc = lt[lk]
        kind = lc.dtype.kind
        if kind not in _KEYABLE_KINDS:
            return None
        nullable = lc.validity is not None
        if rt is not None:
            rc = rt[rkeys[i]]
            if rc.dtype.kind != kind:
                return None
            nullable = nullable or rc.validity is not None
        specs.append(KeySpec(lc.dtype, 1, nullable))
    return specs


def _encode_keys(t: Table, keys, specs) -> List[torch.Tensor]:
    words = []
    for k, sp in zip(keys, specs):
        w, _ = encode_key_column(t[k], spec=sp)
        words.extend(w)
    return words


def _decode_keys(words, specs, names) -> List[Tuple[str, Column]]:
    """Key words back to named typed columns. The relation's `valid` owns
    liveness, so a non-nullable key stays non-nullable; dead slots decode
    to sentinel values nobody reads."""
    return list(zip(names, decode_key_columns(words, specs)))


# ---- partitioning transfer (the exchange-elision property) --------------------

def transfer_part(node: PlanNode, child_parts: List[frozenset]) -> frozenset:
    """The hash-partitioning claim of `node`'s output given its
    children's (the optimizer's exchange planning, the verifier and the
    runtime relations follow the same rule)."""
    if isinstance(node, (Filter, Limit)):
        return child_parts[0]
    if isinstance(node, (Project, FusedSelect)):
        renames = {}
        for out_name, e in node.exprs:
            if isinstance(e, ColumnRef) and e.name not in renames:
                renames[e.name] = out_name
        return frozenset(tuple(renames[c] for c in p)
                         for p in child_parts[0]
                         if all(c in renames for c in p))
    if isinstance(node, Exchange):
        if node.how == "hash":
            return frozenset({tuple(node.keys)})
        if node.how in ("broadcast", "gather"):
            return frozenset()
        return child_parts[0]
    if isinstance(node, HashJoin):
        lp = child_parts[0]
        broadcast = (isinstance(node.right, Exchange)
                     and node.right.how == "broadcast")
        if broadcast:
            # the probe side's rows never move
            return lp
        if node.how != "inner":
            # semi and anti joins keep the left relation, placed by its keys
            return frozenset({tuple(node.left_keys)})
        return frozenset({tuple(node.left_keys), tuple(node.right_keys)})
    if isinstance(node, HashAggregate):
        if not node.keys:
            return frozenset()
        # a child claim within the keys elides the exchange (rows stay,
        # so exactly those claims survive); otherwise the groups are
        # re-placed by the hash of the full key tuple
        keys = set(node.keys)
        sub = frozenset(p for p in child_parts[0] if set(p) <= keys)
        return sub if sub else frozenset({tuple(node.keys)})
    return frozenset()      # Sort/TopK (range), Union, Scan


def part_satisfies(part: frozenset, keys) -> bool:
    """Whether `part` co-locates every group of `keys`: a claimed tuple
    within the group keys suffices."""
    keyset = set(keys)
    return any(set(p) <= keyset for p in part)


def join_alignment(lpart: frozenset, rpart: frozenset, lkeys, rkeys
                   ) -> Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """The (left tuple, right tuple) under which both join sides are
    partitioned alike (the same permutation of the key pairing), so that
    matching rows are co-located; None when there is none."""
    lk, rk = tuple(lkeys), tuple(rkeys)
    for lp in lpart:
        if len(lp) != len(lk) or set(lp) != set(lk):
            continue
        rp = tuple(rk[lk.index(c)] for c in lp)
        if rp in rpart:
            return lp, rp
    return None


# ---- the distributed walk -----------------------------------------------------

class DistContext:
    """One execution's distributed state: the mesh, the transport knobs,
    the fused exchanges, and the caps memo shared with the executor."""

    def __init__(self, executor, plan, inputs):
        from .. import config
        self.ex = executor
        self.mesh = executor.mesh
        self.axis = executor.mesh_axis
        self.n_peers = self.mesh.shape[self.axis]
        self.plan = plan
        self.slack = DIST_SLACK
        self.pack = config.exchange_pack()
        self.codecs = config.exchange_codecs() if self.pack else frozenset()
        self.async_on = config.exchange_async()
        parents: Dict[int, List[PlanNode]] = {}
        for n in plan.nodes:
            for c in n.children:
                parents.setdefault(id(c), []).append(n)
        self.parents = parents
        self._node_index = {id(n): i for i, n in enumerate(plan.nodes)}
        # a hash Exchange whose one consumer is a keyed HashAggregate fuses
        # into the two-phase groupby: the Exchange passes its input on and
        # the aggregate charges the exchange bytes back to it
        self.fused_exchanges = {
            id(n) for n in plan.nodes
            if isinstance(n, Exchange) and n.how == "hash"
            and len(parents.get(id(n), [])) == 1
            and isinstance(parents[id(n)][0], HashAggregate)
            and parents[id(n)][0].keys
        }

    # -- the caps memo ---------------------------------------------------------
    def _memo_key(self, node, tag: str):
        return (self.plan.fingerprint, self._node_index[id(node)], tag)

    def _caps(self, node, tag: str, defaults: Dict) -> Dict:
        memo = self.ex._dist_caps_memo.get(self._memo_key(node, tag))
        caps = dict(defaults)
        for k, v in (memo or {}).items():
            if k in caps:
                caps[k] = max(caps[k], v)
        return caps

    def _retry(self, node, tag: str, run, caps: Dict, m):
        from ..parallel.autoretry import auto_retry_overflow
        attempts = [0]

        def attempt(**kw):
            attempts[0] += 1
            return run(**kw)

        out, final = auto_retry_overflow(attempt, caps,
                                         self.ex.max_cap_attempts)
        if m is not None:
            m.escalations += attempts[0] - 1
        self.ex._dist_caps_memo[self._memo_key(node, tag)] = dict(final)
        return out

    # -- helpers ---------------------------------------------------------------
    def lift(self, rel_or_table, part: frozenset = frozenset()):
        if isinstance(rel_or_table, ShardedRel):
            return rel_or_table
        return shard_table(self.mesh, self.axis, rel_or_table, part=part)

    def localize(self, rel_or_table) -> Table:
        rel_or_table = _resolve_rel(rel_or_table)
        if isinstance(rel_or_table, ShardedRel):
            return rel_or_table.to_local_table()
        return rel_or_table

    @staticmethod
    def _nbytes(table: Table) -> int:
        return table.nbytes()

    def _default_cap(self, *padded_lens) -> int:
        per_shard = max(max(padded_lens, default=1) // self.n_peers, 1)
        return max(64, 2 * per_shard)

    # -- node dispatch ---------------------------------------------------------
    def exec_node(self, node, childs, inputs, schemas, m, metrics):
        """One node: distributed when it has a form and its children allow
        it, else local (its sharded children gathered). Returns a
        ShardedRel, a PendingRel or a Table; in-flight child exchanges
        resolve here, at their consumer."""
        childs = [_resolve_rel(c) for c in childs]
        out = self._try_dist(node, childs, inputs, schemas, m, metrics)
        if out is None:
            local = [self.localize(c) for c in childs]
            out = self.ex._exec_eager_node(node, local, inputs, schemas, m)
        if isinstance(out, (ShardedRel, PendingRel)):
            m.sharding = out.sharding_str(self.n_peers)
            m.n_peers = self.n_peers
        elif any(isinstance(c, ShardedRel) for c in childs):
            m.sharding = "local"
        return out

    def _try_dist(self, node, childs, inputs, schemas, m, metrics):
        try:
            if isinstance(node, Scan):
                return self._dist_scan(node, inputs, m)
            if isinstance(node, Filter):
                return self._dist_filter(node, childs)
            if isinstance(node, (Project, FusedSelect)):
                return self._dist_project(node, childs)
            if isinstance(node, Exchange):
                return self._dist_exchange(node, childs, m)
            if isinstance(node, HashJoin):
                return self._dist_join(node, childs, m, metrics)
            if isinstance(node, HashAggregate):
                return self._dist_aggregate(node, childs, schemas, m,
                                            metrics)
            if isinstance(node, (Sort, TopK)):
                return self._dist_sort(node, childs, m)
            if isinstance(node, Union):
                return self._dist_union(node, childs)
        except NotImplementedError:
            return None
        return None        # Limit and the rest: no distributed form

    # -- scans -----------------------------------------------------------------
    def _dist_scan(self, node, inputs, m):
        t = inputs[node.source]
        if not isinstance(t, Table):
            # a streaming source: one pruned, projected read, then sharded
            t = self.ex._materialize_scan(node, t, m, self.ex.device)
        elif node.projection is not None:
            t = t.select(list(node.projection))
        if t.num_rows == 0 or not table_shardable(t):
            return None
        return self.lift(t)

    # -- row-wise --------------------------------------------------------------
    def _dist_filter(self, node, childs):
        (c,) = childs
        if not isinstance(c, ShardedRel) or c.replicated:
            return None
        mask = node.predicate.evaluate(c.table, c.valid)
        return ShardedRel(c.table, c.valid & mask, part=c.part,
                          order_keys=c.order_keys)

    def _dist_project(self, node, childs):
        (c,) = childs
        if not isinstance(c, ShardedRel) or c.replicated:
            return None
        valid = c.valid
        if isinstance(node, FusedSelect):
            valid = valid & node.predicate.evaluate(c.table, valid)
        cols = []
        for name, e in node.exprs:
            if isinstance(e, ColumnRef):
                cols.append(c.table[e.name])
            else:
                v = e.evaluate(c.table, valid)
                if v.dim() == 0:
                    v = v.expand(c.table.num_rows).contiguous()
                cols.append(Column(dtypes.from_torch(v.dtype),
                                   int(v.shape[0]), v))
        part = transfer_part(node, [c.part])
        order = None
        if c.order_keys:
            renames = {e.name: nm for nm, e in node.exprs
                       if isinstance(e, ColumnRef)}
            if all(k in renames for k in c.order_keys):
                order = [renames[k] for k in c.order_keys]
        return ShardedRel(Table(cols, names=[n for n, _ in node.exprs]),
                          valid, part=part, order_keys=order)

    # -- exchanges -------------------------------------------------------------
    def _dist_exchange(self, node, childs, m):
        (c,) = childs
        if not isinstance(c, ShardedRel):
            if node.how == "broadcast" and isinstance(c, Table) and \
                    table_shardable(c) and c.num_rows:
                # a small build side computed locally can still feed a
                # distributed broadcast join: replicate it as it is
                if self.async_on:
                    return PendingRel(lambda: self._replicate_local(c, m),
                                      m, self._nbytes, self.ex.device,
                                      replicated=True)
                return self._replicate_local(c, m)
            return None       # one-device semantics: the Exchange passes
        if node.how == "identity":
            return c
        if node.how == "gather":
            return self._gather(c, m)
        if node.how == "broadcast":
            if c.replicated:
                return c
            if self.async_on:
                return PendingRel(lambda: self._broadcast(c, m), m,
                                  self._nbytes, self.ex.device,
                                  replicated=True)
            return self._broadcast(c, m)
        if id(node) in self.fused_exchanges:
            return c          # deferred into the aggregate above
        if self.async_on:
            # the has-a-distributed-form checks fail here, synchronously,
            # inside _try_dist's fall-back
            if _key_specs(c.table, list(node.keys)) is None or \
                    not table_shardable(c.table):
                raise NotImplementedError
            return PendingRel(lambda: self._repartition(node, c, m), m,
                              self._nbytes, self.ex.device,
                              part=frozenset({tuple(node.keys)}))
        return self._repartition(node, c, m)

    def _edge(self, m, how: str, logical: int, wire: int, codec: str,
              copies: int = 1):
        """Stamp one exchange edge on a metric row: logical = the unpacked
        payload, wire = the packed bytes moved; live rows only, each edge
        once (a broadcast passes copies = P - 1)."""
        m.exchange_how = how
        m.exchange_bytes_logical += logical * copies
        m.exchange_bytes += wire * copies
        if codec:
            m.exchange_codecs = (m.exchange_codecs + ";" + codec
                                 if m.exchange_codecs else codec)

    @staticmethod
    def _reset_edge(m):
        """A retried exchange describes its edge anew."""
        m.exchange_bytes = 0
        m.exchange_bytes_logical = 0
        m.exchange_codecs = ""

    def _gather(self, c: ShardedRel, m) -> Table:
        """The sink collect. Packed: the wire planes are made and decoded
        (on one device, where they are) and the live rows compacted; a
        relation gathered before is served from its cache and moves
        nothing (zero bytes)."""
        self._reset_edge(m)
        if c._local is not None:
            m.exchange_how = "gather"
            return c._local
        live = c.num_rows
        cols = list(c.table.columns)
        logical = live * transport.logical_row_bytes(cols)
        if self.pack:
            names = list(c.table.names)
            dp = transport.pack_device(cols, names, c.valid, self.codecs)
            decoded = Table(transport.unpack_device(dp.planes, dp),
                            names=names)
            c._local = _compact(decoded, c.valid, c.order_keys)
            self._edge(m, "gather", logical, live * dp.wire_row_bytes,
                       dp.codec_str)
            return c._local
        t = c.to_local_table()
        self._edge(m, "gather", logical, logical, "")
        return t

    def _replicate_local(self, t: Table, m) -> ShardedRel:
        self._reset_edge(m)
        live = t.num_rows
        logical = live * transport.logical_row_bytes(t.columns)
        copies = self.n_peers - 1
        dev = self.ex.device
        if self.pack:
            # materialized on the host: the dynamic-size codecs apply, and
            # the decode runs on the lifted planes
            hp = transport.pack_host(list(t.columns), list(t.names),
                                     self.codecs)
            cols = transport.unpack_host_device(hp, lambda a: a.to(dev))
            self._edge(m, "broadcast", logical, hp.wire_bytes,
                       hp.codec_str, copies=copies)
        else:
            cols = list(t.columns)
            self._edge(m, "broadcast", logical, logical, "", copies=copies)
        valid = torch.ones(t.num_rows, dtype=torch.bool, device=dev)
        return ShardedRel(Table(cols, names=list(t.names)), valid,
                          replicated=True)

    def _broadcast(self, c: ShardedRel, m) -> ShardedRel:
        if c.replicated:
            return c
        self._reset_edge(m)
        names = list(c.table.names)
        cols = list(c.table.columns)
        live = c.num_rows
        copies = self.n_peers - 1
        logical = live * transport.logical_row_bytes(cols)
        if self.pack:
            dp = transport.pack_device(cols, names, c.valid, self.codecs)
            out_cols = transport.unpack_device(dp.planes, dp)
            self._edge(m, "broadcast", logical, live * dp.wire_row_bytes,
                       dp.codec_str, copies=copies)
        else:
            arrays, layout = _pack_cols(c.table, names)
            out_cols = _unpack_cols(arrays, layout)
            self._edge(m, "broadcast", logical, logical, "", copies=copies)
        return ShardedRel(Table(out_cols, names=names), c.valid,
                          replicated=True)

    def _repartition(self, node, c: ShardedRel, m) -> ShardedRel:
        self._reset_edge(m)
        rel, logical, wire, codec = self._repartition_rel(
            node, c, list(node.keys), m, "repart")
        self._edge(m, "hash", logical, wire, codec)
        return rel

    def _repartition_rel(self, node, c: ShardedRel, keys, m, tag: str):
        """Hash-exchange a sharded relation by `keys`: (the rel, logical
        bytes, wire bytes, codec string). Key columns ride their 64-bit
        words (8 B x words logically; with packing the planes FOR-narrow
        and the exchange widens them back for the hash); value columns
        move packed."""
        from ..parallel.relational import distributed_repartition_keyed
        specs = _key_specs(c.table, keys)
        if specs is None or not table_shardable(c.table):
            raise NotImplementedError
        words = _encode_keys(c.table, keys, specs)
        vnames = [nm for nm in c.table.names if nm not in set(keys)]
        val_cols = [c.table[nm] for nm in vnames]
        live = c.num_rows
        key_word_bytes = 8 * sum(sp.total_words for sp in specs)
        logical_row = key_word_bytes + transport.logical_row_bytes(val_cols)
        dp = layout = wplans = None
        word_codecs, refs = (), []
        if self.pack:
            dp = transport.pack_device(val_cols, vnames, c.valid,
                                       self.codecs)
            vals = dp.planes
            codec = dp.codec_str
            key_wire_bytes = key_word_bytes
            if "for" in self.codecs:
                words, wplans, key_wire_bytes, knote = \
                    transport.narrow_words(words, c.valid)
                if knote:
                    codec = ",".join(x for x in (codec, knote) if x)
                word_codecs = tuple(p.codec for p in wplans)
                refs = [torch.full((1,), p.ref, dtype=torch.int64,
                                   device=c.valid.device)
                        for p in wplans if p.codec != "raw"]
            wire_row = key_wire_bytes + dp.wire_row_bytes
        else:
            vals, layout = _pack_cols(c.table, vnames)
            wire_row, codec = logical_row, ""
        mesh, axis = self.mesh, self.axis

        def run(slack):
            return distributed_repartition_keyed(
                mesh, words, specs, vals, slack=slack, axis=axis,
                alive=c.valid, word_codecs=word_codecs or None,
                word_refs=refs or None)

        ws, vs, alive, _ = self._retry(
            node, tag, run, self._caps(node, tag, {"slack": self.slack}), m)
        if wplans is not None:
            ws = transport.widen_words(list(ws), wplans)
        cols = dict(_decode_keys(ws, specs, keys))
        if dp is not None:
            unpacked = transport.unpack_device(list(vs), dp)
        else:
            unpacked = _unpack_cols(vs, layout)
        cols.update({nm: col for nm, col in zip(vnames, unpacked)})
        table = Table([cols[nm] for nm in c.table.names],
                      names=list(c.table.names))
        return (ShardedRel(table, alive, part=frozenset({tuple(keys)})),
                live * logical_row, live * wire_row, codec)

    # -- joins -----------------------------------------------------------------
    def _dist_join(self, node, childs, m, metrics):
        from ..parallel.relational import distributed_colocated_join_keyed
        if node.how not in ("inner", "left_semi", "left_anti"):
            return None
        l, r = childs
        if not isinstance(l, ShardedRel) and not isinstance(r, ShardedRel):
            return None
        if not isinstance(l, ShardedRel):
            if not (isinstance(l, Table) and table_shardable(l)
                    and l.num_rows):
                return None
            l = self.lift(l)
        if not isinstance(r, ShardedRel):
            if not (isinstance(r, Table) and table_shardable(r)
                    and r.num_rows):
                return None
            r = self.lift(r)
        if l.replicated:
            return None     # the probe side must be partitioned
        if not (table_shardable(l.table) and table_shardable(r.table)):
            return None
        specs = _key_specs(l.table, node.left_keys, r.table, node.right_keys)
        if specs is None:
            return None
        lk, rk = list(node.left_keys), list(node.right_keys)
        inner = node.how == "inner"
        l_moved = False
        # aligned sides join where they are; a replicated right side
        # probes locally; anything else repartitions here (the bytes on
        # this node's metric)
        if not r.replicated and join_alignment(l.part, r.part, lk,
                                               rk) is None:
            self._reset_edge(m)
            if tuple(lk) not in l.part:
                l, lg, lwb, lc = self._repartition_rel(node, l, lk, m,
                                                       "repart_l")
                self._edge(m, "hash", lg, lwb, lc)
                l_moved = True
            if tuple(rk) not in r.part:
                r, rg, rwb, rc = self._repartition_rel(node, r, rk, m,
                                                       "repart_r")
                self._edge(m, "hash", rg, rwb, rc)
        # the output's claim names the tuples the rows are placed by: the
        # aligned permutation, not the join-key order
        aligned = (None if r.replicated
                   else join_alignment(l.part, r.part, lk, rk))
        l_words = _encode_keys(l.table, lk, specs)
        r_words = _encode_keys(r.table, rk, specs)
        lvnames = [nm for nm in l.table.names if nm not in set(lk)]
        lvals, l_layout = _pack_cols(l.table, lvnames)
        if inner:
            rvnames = [nm for nm in r.table.names if nm not in set(rk)]
            rvals, r_layout = _pack_cols(r.table, rvnames)
        else:
            rvnames, rvals, r_layout = [], [], []
        mesh, axis, how, rrep = self.mesh, self.axis, node.how, r.replicated

        def run(row_cap):
            return distributed_colocated_join_keyed(
                mesh, l_words, lvals, r_words, rvals, specs,
                row_cap=row_cap, axis=axis, how=how, lalive=l.valid,
                ralive=r.valid, r_replicated=rrep)

        if inner:
            cap0 = self._default_cap(l.padded_rows, r.padded_rows
                                     * (self.n_peers if r.replicated else 1))
            ws, lvs, rvs, live, _ = self._retry(
                node, "join", run,
                self._caps(node, "join", {"row_cap": cap0}), m)
        else:
            ws, lvs, live, _ = run(row_cap=0)
        cols = dict(_decode_keys(ws, specs, lk))
        cols.update({nm: col for nm, col
                     in zip(lvnames, _unpack_cols(lvs, l_layout))})
        names = list(l.table.names)
        if inner:
            # right key columns equal the left keys on every matched row
            for nm, lkey in zip(rk, lk):
                rc = r.table[nm]
                src = cols[lkey]
                cols[nm] = Column(rc.dtype, src.length,
                                  src.data.to(rc.dtype.storage_dtype()),
                                  src.validity)
            cols.update({nm: col for nm, col
                         in zip(rvnames, _unpack_cols(rvs, r_layout))})
            names = names + list(r.table.names)
        if r.replicated:
            part = l.part              # the probe side never moved
        elif aligned is None:
            part = frozenset()
        elif inner:
            part = frozenset(aligned)
        else:
            part = frozenset({aligned[0]})   # left columns only survive
        # a broadcast semi/anti join never moves the left rows, so the
        # left relation's gather order survives
        order = l.order_keys if (not inner and r.replicated
                                 and not l_moved) else None
        return ShardedRel(Table([cols[nm] for nm in names], names=names),
                          live, part=part, order_keys=order)

    # -- aggregates ------------------------------------------------------------
    def _dist_aggregate(self, node, childs, schemas, m, metrics):
        from ..ops.aggregate import _agg_value_dtype
        from ..parallel.relational import (distributed_groupby_keyed,
                                           distributed_local_groupby)
        (c,) = childs
        fused_child = (isinstance(node.child, Exchange)
                       and id(node.child) in self.fused_exchanges)
        if not isinstance(c, ShardedRel) or c.replicated:
            return None
        if not node.keys:
            return None       # a global aggregate: the gather boundary
        if any(o not in _DIST_AGGS for _, o, _ in node.aggs):
            return None
        specs = _key_specs(c.table, node.keys)
        if specs is None:
            return None
        val_names, agg_pairs = [], []
        for cn, o, _ in node.aggs:
            if o == "size":
                agg_pairs.append((0, "count"))
                continue
            col = c.table[cn]
            if col.validity is not None or not (
                    col.dtype.is_integer or col.dtype.kind == dtypes.Kind.BOOL):
                return None   # exact int64 partials only
            if cn not in val_names:
                val_names.append(cn)
            agg_pairs.append((val_names.index(cn),
                              "count" if o == "count" else o))
        words = _encode_keys(c.table, list(node.keys), specs)
        vals = [c.table[v].data for v in val_names]
        key_cap0 = node.key_cap or self.ex.caps.get("key_cap") or \
            self._default_cap(c.padded_rows)
        elide = (not fused_child) and part_satisfies(c.part, node.keys)
        nbytes = [0]
        live_in = c.num_rows
        nw = len(words)
        mesh, axis, n_peers = self.mesh, self.axis, self.n_peers

        def run(key_cap):
            if elide:
                return distributed_local_groupby(
                    mesh, words, vals, list(agg_pairs), key_cap=key_cap,
                    axis=axis, alive=c.valid)
            # the exchange moves per-group partials, not rows: one int64 a
            # key word and a partial, for at most min(live rows, P x
            # key_cap) groups
            nbytes[0] = (8 * (nw + len(agg_pairs))
                         * min(live_in, n_peers * key_cap))
            return distributed_groupby_keyed(
                mesh, words, specs, vals, list(agg_pairs), key_cap=key_cap,
                axis=axis, alive=c.valid)

        gws, outs, gvalid, _ = self._retry(
            node, "group", run,
            self._caps(node, "group", {"key_cap": key_cap0}), m)
        if not elide:
            # the partials' bytes belong to the exchange boundary: the
            # child Exchange when one was planned, this node otherwise
            # (64-bit exact partials: no packing, wire == logical)
            tgt = m
            if fused_child and node.child.label in metrics:
                tgt = metrics[node.child.label]
            self._reset_edge(tgt)
            tgt.exchange_how = "hash"
            tgt.exchange_bytes = nbytes[0]
            tgt.exchange_bytes_logical = nbytes[0]
        cols = dict(_decode_keys(gws, specs, list(node.keys)))
        for arr, (cn, o, out_name) in zip(outs, node.aggs):
            dt = _agg_value_dtype(o, c.table[cn].dtype
                                  if o != "size" else dtypes.INT64)
            cols[out_name] = Column(dt, int(arr.shape[0]),
                                    arr.to(dt.storage_dtype()))
        names = schemas[id(node)]
        # the claim of the path that ran: the elided merge left rows at
        # the child's subset claims; the fused program re-placed groups by
        # the hash of the full key tuple
        if elide:
            keyset = set(node.keys)
            part = frozenset(p for p in c.part if set(p) <= keyset)
        else:
            part = frozenset({tuple(node.keys)})
        return ShardedRel(Table([cols[nm] for nm in names],
                                names=list(names)),
                          gvalid, part=part, order_keys=list(node.keys))

    # -- sort / topk -----------------------------------------------------------
    def _dist_sort(self, node, childs, m):
        from ..parallel.relational import distributed_sort_keyed
        (c,) = childs
        if not isinstance(c, ShardedRel) or c.replicated:
            return None
        if not table_shardable(c.table):
            return None
        specs = _key_specs(c.table, node.keys)
        if specs is None:
            return None
        keys = list(node.keys)
        words = []
        for k, sp, asc in zip(keys, specs, node.ascending):
            w, _ = encode_key_column(c.table[k], spec=sp)
            if not asc:
                # bitwise NOT reverses signed order word by word, and so
                # the tuple's lexicographic order
                w = [~x for x in w]
            words.extend(w)
        vnames = [nm for nm in c.table.names if nm not in set(keys)]
        val_cols = [c.table[nm] for nm in vnames]
        live = c.num_rows
        key_word_bytes = 8 * sum(sp.total_words for sp in specs)
        logical_row = key_word_bytes + transport.logical_row_bytes(val_cols)
        dp = layout = None
        if self.pack:
            dp = transport.pack_device(val_cols, vnames, c.valid,
                                       self.codecs)
            vals = dp.planes
            wire_row = key_word_bytes + dp.wire_row_bytes
            codec = dp.codec_str
        else:
            vals, layout = _pack_cols(c.table, vnames)
            wire_row, codec = logical_row, ""
        mesh, axis = self.mesh, self.axis

        def run(slack):
            return distributed_sort_keyed(mesh, words, None, list(vals),
                                          slack=slack, axis=axis,
                                          alive=c.valid)

        ws, vs, valid, _ = self._retry(
            node, "sort", run, self._caps(node, "sort",
                                          {"slack": self.slack}), m)
        # each live row crosses the range partition once; the splitter
        # samples are metadata
        self._reset_edge(m)
        self._edge(m, "range", live * logical_row, live * wire_row, codec)
        i = 0
        dec_words = []
        for sp, asc in zip(specs, node.ascending):
            tw = list(ws[i:i + sp.total_words])
            if not asc:
                tw = [~x for x in tw]
            dec_words.extend(tw)
            i += sp.total_words
        cols = dict(_decode_keys(dec_words, specs, keys))
        if vals:
            if dp is not None:
                unpacked = transport.unpack_device(list(vs), dp)
            else:
                unpacked = _unpack_cols(list(vs), layout)
            cols.update({nm: col for nm, col in zip(vnames, unpacked)})
        table = Table([cols[nm] for nm in c.table.names],
                      names=list(c.table.names))
        if isinstance(node, TopK):
            # the live slots in order are the globally sorted run (peer 0
            # holds the smallest keys): the first n are a prefix count
            valid = valid & (torch.cumsum(valid.to(torch.int64), 0)
                             <= node.n)
        return ShardedRel(table, valid)

    # -- union -----------------------------------------------------------------
    def _dist_union(self, node, childs):
        if not all(isinstance(c, ShardedRel) and not c.replicated
                   for c in childs):
            return None
        names = list(childs[0].table.names)
        cols = []
        for i in range(len(names)):
            parts = [c.table.columns[i] for c in childs]
            data = torch.cat([p.data for p in parts])
            validity = None
            if any(p.validity is not None for p in parts):
                validity = torch.cat([p.null_mask for p in parts])
            cols.append(Column(parts[0].dtype, int(data.shape[0]), data,
                               validity))
        valid = torch.cat([c.valid for c in childs])
        return ShardedRel(Table(cols, names=names), valid)
