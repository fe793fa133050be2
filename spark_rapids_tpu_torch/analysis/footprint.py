"""Static resource certifier: sound bounds on rows and bytes per operator.

Counterpart of `spark_rapids_tpu/analysis/footprint.py`. One walk over the
typed plan DAG in toposort order gives each operator a sound interval
`[rows_lo, rows_hi]` of its output rows and byte bounds derived from it,
packaged as a `ResourceCert`:

- **rows**: `rows_hi` holds for every execution over the bound inputs
  (a filter collapses `rows_lo` to 0, never raises `rows_hi`; an inner
  join's `rows_hi` is the cross product of its sides'). These depend only
  on the plan and its binding and equal the reference's.
- **bytes**: per-row widths come from the verifier's typing layer
  (`verifier.column_types`): a fixed-width column certifies `itemsize + 1`
  bytes a row (the 1 is a validity byte, assumed present), a STRING,
  nested or unknown column makes the byte bound unbounded (None). A keyed
  aggregate's outputs certify at the 64-bit accumulator width. `row_bytes`
  and `out_bytes_hi` equal the reference's.
- **working sets** (`working_bytes_hi`), where the port differs by design:
  the reference sizes its TPU designs' join and aggregation tables (the
  build side's bytes, the aggregate's accumulators per input row). The
  port sizes the tables its own kernels build: `hash_join.cu`'s table of
  `join_cuda._capacity(build rows)` slots of 8 bytes (slot row and slot
  hash, or one 8-byte word on the large route) for every join, and
  `groupby.cu`'s insertion table of `groupby_cuda.capacity(input rows)`
  int32 slots for a keyed aggregate. Rows are the eager tier's live rows;
  the capped tier builds over its padded frames, whose rows are its caps.
  The kernels' smaller scratch (per-tile counts and lists, the gather
  maps) is not counted: `working_bytes_hi` bounds the tables, and
  `resident_bytes_hi` the children's outputs, the tables and the output.
- **exchange bytes**: the reference's per-edge wire model: with
  `n_peers > 1` (a meshed executor) a hash edge moves each row at most
  once (key words at 8 B, values at their width, validity a byte), a
  fused aggregate exchange at most the larger of that and its partials
  per group, a broadcast its payload x (P - 1), a gather its payload; on
  one device (`n_peers=1`) an exchange moves nothing.

A bound is sound or None, never a guess. `check_observed` is the
soundness inequality (fuzz property 5): every executed operator's
observed rows lie in `[rows_lo, rows_hi]` on both tiers, and its observed
bytes are at most `out_bytes_hi` on the eager tier (the capped tier pads
to its caps).

Consumers: the executor's admission gate (SPARK_RAPIDS_TORCH_CERT_BUDGET_
BYTES; `ResourceAdmissionError` names the operator), the optimizer's
estimator (a certified `rows_hi` where the static chain has nothing) and
the capped tier's cap seeding and ladder ceiling (`_cert_caps`, with a
stats store, under SPARK_RAPIDS_TORCH_CERT_SEED).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .. import dtypes
from ..plan.nodes import (Exchange, Filter, FusedSelect, HashAggregate,
                          HashJoin, Limit, PlanNode, Project, Scan, Sort,
                          TopK, Union)
from .verifier import (PlanVerificationError, Violation, _propagate_schemas,
                       column_types)

__all__ = ["OpBound", "ResourceCert", "ResourceAdmissionError",
           "certify", "certify_nodes", "table_metadata",
           "check_observed", "quota_charge"]

_VALIDITY_BYTES = 1        # one bool byte a row a column
_ACC_BYTES = 8             # aggregate accumulators widen to 64-bit
_JOIN_SLOT_BYTES = 8       # hash_join.cu: int32 slot row + int32 slot hash
_GROUPBY_SLOT_BYTES = 4    # groupby.cu: one int32 group slot


class ResourceAdmissionError(PlanVerificationError):
    """A plan's certified footprint exceeds the device budget: raised at
    admission, before anything runs, with the operator's label in the
    violations."""


def _add(a: Optional[int], b: Optional[int]) -> Optional[int]:
    """None-propagating sum: an unbounded term poisons the bound."""
    if a is None or b is None:
        return None
    return a + b


def _mul(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None or b is None:
        return None
    return a * b


def _col_width(dt: Optional[dtypes.DType]) -> Optional[int]:
    """Certified bytes a row of one column, or None where the buffer is not
    a function of the row count (strings, nested) or the dtype is
    unknown. DECIMAL128 is 16 bytes of limbs."""
    if dt is None or dt.is_string or dt.is_nested:
        return None
    return dt.itemsize() + _VALIDITY_BYTES


def _join_table_bytes(build_rows: Optional[int]) -> Optional[int]:
    """Bytes of the hash-join kernels' table over `build_rows` rows."""
    if build_rows is None:
        return None
    from ..ops.join_cuda import _capacity
    return _JOIN_SLOT_BYTES * _capacity(build_rows)


def _groupby_table_bytes(rows: Optional[int]) -> Optional[int]:
    """Bytes of the groupby kernel's insertion table over `rows` rows."""
    if rows is None:
        return None
    from ..ops.groupby_cuda import capacity
    return _GROUPBY_SLOT_BYTES * capacity(rows)


@dataclasses.dataclass(frozen=True)
class OpBound:
    """Certified bounds of one operator; a None is unbounded."""
    label: str
    kind: str
    index: int                        # toposort index (the capped tier's
    #                                   per-node cap keys)
    rows_lo: int
    rows_hi: Optional[int]
    row_bytes: Optional[int]          # certified output bytes a row
    out_bytes_hi: Optional[int]       # rows_hi x row_bytes
    working_bytes_hi: Optional[int]   # the kernel's hash table
    exchange_bytes_hi: Optional[int]  # planned movement (Exchange nodes)
    resident_bytes_hi: Optional[int]  # children's outputs + working + output

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class ResourceCert:
    """One plan's certified bounds in toposort order. `by_label` and
    `by_index` address the same `OpBound`s; `peak_bytes_hi` is the largest
    certified residency (the admission comparand); `unbounded` lists the
    operators without a row or byte bound (they pass admission)."""

    def __init__(self, ops: List[OpBound], n_peers: int = 1):
        self.ops = list(ops)
        self.n_peers = n_peers
        self.by_label: Dict[str, OpBound] = {b.label: b for b in self.ops}
        self.by_index: Dict[int, OpBound] = {b.index: b for b in self.ops}
        self.unbounded: List[str] = [
            b.label for b in self.ops
            if b.rows_hi is None or b.out_bytes_hi is None]
        finite = [b.resident_bytes_hi for b in self.ops
                  if b.resident_bytes_hi is not None]
        self.peak_bytes_hi: Optional[int] = max(finite) if finite else None
        ex = [b.exchange_bytes_hi for b in self.ops
              if b.exchange_bytes_hi is not None]
        self.exchange_bytes_hi: Optional[int] = sum(ex) if ex else 0

    @property
    def root(self) -> OpBound:
        return self.ops[-1]

    def over_budget(self, budget_bytes: int) -> List[Violation]:
        """Operators whose certified residency exceeds `budget_bytes`;
        an unbounded operator is not one of them."""
        out = []
        for b in self.ops:
            if b.resident_bytes_hi is not None and \
                    b.resident_bytes_hi > budget_bytes:
                out.append(Violation(
                    "footprint.over-budget", b.label,
                    f"{b.label}: certified residency hi-bound "
                    f"{b.resident_bytes_hi} B (rows<= "
                    f"{b.rows_hi}, output<={b.out_bytes_hi} B, working<="
                    f"{b.working_bytes_hi or 0} B) exceeds the device "
                    f"budget of {budget_bytes} B — the plan cannot be "
                    "proven to fit"))
        return out

    def to_dict(self) -> Dict:
        return {"peak_bytes_hi": self.peak_bytes_hi,
                "exchange_bytes_hi": self.exchange_bytes_hi,
                "root_rows_hi": self.root.rows_hi,
                "root_bytes_hi": self.root.out_bytes_hi,
                "unbounded": list(self.unbounded),
                "ops": [b.to_dict() for b in self.ops]}

    def render(self) -> str:
        """explain()'s block: one line an operator."""
        def fmt(v, unit=""):
            return "unbounded" if v is None else f"{v}{unit}"
        lines = ["resource cert (certified hi-bounds, "
                 f"peak {fmt(self.peak_bytes_hi, ' B')} resident, "
                 f"exchange {fmt(self.exchange_bytes_hi, ' B')}):"]
        for b in self.ops:
            parts = [f"rows [{b.rows_lo}, {fmt(b.rows_hi)}]",
                     f"out<={fmt(b.out_bytes_hi, ' B')}"]
            if b.working_bytes_hi:
                parts.append(f"working<={b.working_bytes_hi} B")
            if b.exchange_bytes_hi:
                parts.append(f"exchange<={b.exchange_bytes_hi} B")
            lines.append(f"  {b.label}: " + ", ".join(parts))
        return "\n".join(lines)

    def __repr__(self):
        return (f"ResourceCert({len(self.ops)} ops, peak="
                f"{self.peak_bytes_hi}, unbounded={len(self.unbounded)})")

    def peak_op_label(self) -> str:
        """The operator that set `peak_bytes_hi` ("" when none is
        bounded)."""
        for b in self.ops:
            if b.resident_bytes_hi is not None and \
                    b.resident_bytes_hi == self.peak_bytes_hi:
                return b.label
        return ""


def quota_charge(cert: Optional[ResourceCert],
                 default_bytes: int) -> Tuple[int, str, str]:
    """(bytes, source, operator) one admission charges: the certified
    peak when there is one ("certified"), else `default_bytes`
    ("default")."""
    if cert is None or cert.peak_bytes_hi is None:
        return int(default_bytes), "default", ""
    return int(cert.peak_bytes_hi), "certified", cert.peak_op_label()


# ---- the walk ---------------------------------------------------------------

def _scan_rows(node: Scan, bound_rows) -> Optional[int]:
    """Source cardinality: the bound table's or source's row count wins; a
    scan carrying its own Parquet source knows its footer's count;
    otherwise unbounded (est_rows is a hint, never a sound bound)."""
    v = (bound_rows or {}).get(node.source)
    if v is not None:
        return int(v)
    if node.parquet is not None:
        try:
            return int(node.parquet.num_rows)
        except (AttributeError, TypeError):
            return None
    return None


def _rows_interval(node: PlanNode, kids: List[Tuple[int, Optional[int]]],
                   bound_rows, nullable_keys: bool
                   ) -> Tuple[int, Optional[int]]:
    """[lo, hi] of one operator's output rows from its children's."""
    if isinstance(node, Scan):
        n = _scan_rows(node, bound_rows)
        if n is None:
            return 0, None           # est_rows is a hint, never a bound
        return (0 if node.predicate is not None else n), n
    los = [lo for lo, _ in kids]
    his = [hi for _, hi in kids]
    if isinstance(node, (Filter, FusedSelect)):
        return 0, his[0]
    if isinstance(node, (Project, Sort, Exchange)):
        return los[0], his[0]
    if isinstance(node, (Limit, TopK)):
        return (min(node.n, los[0]),
                None if his[0] is None else min(node.n, his[0]))
    if isinstance(node, Union):
        hi = 0
        for h in his:
            hi = _add(hi, h)
        return sum(los), hi
    if isinstance(node, HashJoin):
        if node.how == "inner":
            return 0, _mul(his[0], his[1])
        return 0, his[0]                     # semi/anti: left rows
    if isinstance(node, HashAggregate):
        if not node.keys:
            return 1, 1                      # one row, even over none
        # at least one group when the input has a row and no key can be
        # null
        lo = 1 if (los[0] > 0 and not nullable_keys) else 0
        return lo, his[0]
    return los[0] if los else 0, his[0] if his else None


def _key_words(dt: Optional[dtypes.DType], nullable: bool) -> Optional[int]:
    """64-bit words one key column rides through a hash exchange."""
    if dt is None or dt.is_string or dt.is_nested:
        return None
    words = 2 if dt.kind == dtypes.Kind.DECIMAL128 else 1
    return words + (1 if nullable else 0)


def _hash_edge_row_bytes(node: Exchange, schema, ctypes,
                         cnull) -> Optional[int]:
    """Wire bytes a row of a hash exchange: keys as 8-byte words, every
    other column at most its width."""
    total = 0
    keyset = set(node.keys)
    for k in node.keys:
        w = _key_words(ctypes.get(k), cnull.get(k, True))
        if w is None:
            return None
        total += 8 * w
    for cname in (schema or ()):
        if cname in keyset:
            continue
        w = _col_width(ctypes.get(cname))
        if w is None:
            return None
        total += w
    return total


def _partial_row_bytes(agg: HashAggregate, ctypes, cnull) -> Optional[int]:
    """Wire bytes a group of a hash exchange fused into the keyed
    aggregate above it: an int64 a key word and a partial."""
    total_words = 0
    for k in agg.keys:
        w = _key_words(ctypes.get(k), cnull.get(k, True))
        if w is None:
            return None
        total_words += w
    return 8 * (total_words + len(agg.aggs))


def _agg_widths(node: HashAggregate, child_types) -> Optional[int]:
    """Output bytes a row of a HashAggregate: keys at their widths, each
    aggregate at the 64-bit accumulator's."""
    total = 0
    for k in node.keys:
        w = _col_width(child_types.get(k))
        if w is None:
            return None
        total += w
    return total + len(node.aggs) * (_ACC_BYTES + _VALIDITY_BYTES)


def _nullability(nodes, schemas, input_nullable) -> Dict[int, Dict]:
    """node id -> {column: may be null}; unknown is nullable."""
    from ..plan.expr import ColumnRef
    nullable: Dict[int, Dict[str, bool]] = {}
    for node in nodes:
        kids_n = [nullable.get(id(c), {}) for c in node.children]
        if isinstance(node, Scan):
            src = dict((input_nullable or {}).get(node.source) or {})
            nullable[id(node)] = {
                c: src.get(c, True) for c in schemas.get(id(node), ())}
        elif isinstance(node, (Project, FusedSelect)):
            nullable[id(node)] = {
                n: (kids_n[0].get(e.name, True)
                    if isinstance(e, ColumnRef) else False)
                for n, e in node.exprs}
        elif isinstance(node, HashJoin):
            out = dict(kids_n[0])
            if node.how == "inner":
                out.update(kids_n[1])
            nullable[id(node)] = out
        elif isinstance(node, HashAggregate):
            out = {k: kids_n[0].get(k, True) for k in node.keys}
            out.update({n: True for _, _, n in node.aggs})
            nullable[id(node)] = out
        elif isinstance(node, Union):
            nullable[id(node)] = {
                c: any(k.get(c, True) for k in kids_n)
                for c in schemas.get(id(node), ())}
        else:
            nullable[id(node)] = dict(kids_n[0]) if kids_n else {}
    return nullable


def certify_nodes(nodes: List[PlanNode], *, bound=None, bound_rows=None,
                  input_dtypes=None, input_nullable=None,
                  n_peers: int = 1) -> Dict[int, OpBound]:
    """The walk over a toposorted node list: node id -> OpBound. `bound`
    maps scan source -> column names (else the declared schemas),
    `bound_rows` -> row counts, `input_dtypes` -> {column: DType} (byte
    bounds), `input_nullable` -> {column: bool} (a keyed aggregate's
    `rows_lo`; unknown columns are nullable). `n_peers` sizes exchange
    payloads (1: one device, exchanges move nothing)."""
    schemas, _ = _propagate_schemas(nodes, bound, strict=False)
    types = column_types(nodes, schemas, input_dtypes or {})
    parents: Dict[int, List[PlanNode]] = {}
    for nd in nodes:
        for ch in nd.children:
            parents.setdefault(id(ch), []).append(nd)
    nullable = _nullability(nodes, schemas, input_nullable)

    out: Dict[int, OpBound] = {}
    for i, node in enumerate(nodes):
        kid_bounds = [out[id(c)] for c in node.children]
        kid_rows = [(b.rows_lo, b.rows_hi) for b in kid_bounds]
        keys_nullable = True
        if isinstance(node, HashAggregate) and node.keys and kid_bounds:
            cn = nullable.get(id(node.children[0]), {})
            keys_nullable = any(cn.get(k, True) for k in node.keys)
        lo, hi = _rows_interval(node, kid_rows, bound_rows, keys_nullable)

        schema = schemas.get(id(node))
        ntypes = types.get(id(node)) or {}
        row_bytes: Optional[int] = None
        if schema is not None:
            if isinstance(node, HashAggregate):
                ctypes = (types.get(id(node.children[0])) or {}
                          if node.children else {})
                row_bytes = _agg_widths(node, ctypes)
            else:
                total = 0
                for c in schema:
                    w = _col_width(ntypes.get(c))
                    if w is None:
                        total = None
                        break
                    total += w
                row_bytes = total
        out_bytes = _mul(hi, row_bytes)

        # the port's kernels' tables (module docstring)
        working: Optional[int] = 0
        if isinstance(node, HashJoin):
            working = _join_table_bytes(kid_bounds[1].rows_hi)
        elif isinstance(node, HashAggregate) and node.keys:
            working = _groupby_table_bytes(kid_bounds[0].rows_hi)

        exchange: Optional[int] = 0
        if isinstance(node, Exchange) and n_peers > 1:
            child_out = kid_bounds[0].out_bytes_hi
            if node.how == "hash":
                cid = id(node.children[0])
                ctypes = types.get(cid) or {}
                cnull = nullable.get(cid, {})
                width = _hash_edge_row_bytes(node, schemas.get(id(node)),
                                             ctypes, cnull)
                par = parents.get(id(node), [])
                if width is not None and len(par) == 1 and \
                        isinstance(par[0], HashAggregate) and par[0].keys:
                    pw = _partial_row_bytes(par[0], ctypes, cnull)
                    width = None if pw is None else max(width, pw)
                exchange = _mul(hi, width)
            elif node.how == "gather":
                exchange = child_out
            elif node.how == "broadcast":
                exchange = _mul(child_out, n_peers - 1)

        resident = out_bytes
        for b in kid_bounds:
            resident = _add(resident, b.out_bytes_hi)
        resident = _add(resident, working)
        out[id(node)] = OpBound(
            label=node.label, kind=node.kind, index=i, rows_lo=lo,
            rows_hi=hi, row_bytes=row_bytes, out_bytes_hi=out_bytes,
            working_bytes_hi=working, exchange_bytes_hi=exchange,
            resident_bytes_hi=resident)
    return out


def table_metadata(inputs) -> Tuple[Dict, Dict]:
    """(input_dtypes, input_nullable) of an execute()-style `inputs`
    dict: the one extraction the executor, the fuzzer and the tests
    share. A streaming source contributes nothing, as in the reference:
    its dtypes stay unknown and its columns count as nullable."""
    from ..columnar.table import Table
    dts = {name: {cn: c.dtype for cn, c in zip(t.names, t.columns)}
           for name, t in inputs.items() if isinstance(t, Table)}
    nul = {name: {cn: c.validity is not None
                  for cn, c in zip(t.names, t.columns)}
           for name, t in inputs.items() if isinstance(t, Table)}
    return dts, nul


def check_observed(cert: ResourceCert, result) -> Optional[str]:
    """The soundness inequality: every executed operator's observed rows
    inside the certified `[lo, hi]` (both tiers), and its observed bytes
    at most the certified byte bound on the eager tier, except on the
    mesh (an operator with `n_peers` set pads to the mesh and the slack,
    so its bytes measure padding). On a distributed run every planned
    Exchange's observed wire bytes are at most its certified edge bound.
    The first violation as a string, None when sound."""
    for lbl, m in result.metrics.items():
        b = cert.by_label.get(lbl)
        if b is None:
            return f"{lbl}: executed op has no cert entry"
        if m.rows_out < b.rows_lo or (
                b.rows_hi is not None and m.rows_out > b.rows_hi):
            return (f"{lbl}: observed rows {m.rows_out} outside "
                    f"certified [{b.rows_lo}, {b.rows_hi}]")
        if result.mode == "eager" and not m.degraded and not m.n_peers \
                and b.out_bytes_hi is not None \
                and m.bytes_out > b.out_bytes_hi:
            return (f"{lbl}: observed bytes {m.bytes_out} > certified "
                    f"{b.out_bytes_hi}")
        if m.kind == "Exchange" and not m.degraded \
                and m.exchange_bytes \
                and b.exchange_bytes_hi is not None \
                and m.exchange_bytes > b.exchange_bytes_hi:
            return (f"{lbl}: observed wire bytes {m.exchange_bytes} > "
                    f"certified exchange bound {b.exchange_bytes_hi}")
    return None


def certify(plan, *, bound=None, bound_rows=None, input_dtypes=None,
            input_nullable=None, n_peers: int = 1) -> ResourceCert:
    """Certify one Plan (see `certify_nodes`); its ops are in the plan's
    toposort order, so `by_index` lines up with the capped tier's
    per-node cap keys and the stats store's per-op records."""
    by_id = certify_nodes(plan.nodes, bound=bound, bound_rows=bound_rows,
                          input_dtypes=input_dtypes,
                          input_nullable=input_nullable, n_peers=n_peers)
    return ResourceCert([by_id[id(n)] for n in plan.nodes],
                        n_peers=n_peers)
