"""Static plan verifier: invariant checks over a Plan DAG, without running
it.

Counterpart of `spark_rapids_tpu/analysis/verifier.py`, with the same
invariant names and messages, so the two packages' reports compare as
equal. It flags only definite violations, so it can gate every execution
without false alarms. The layers:

1. **Schema propagation** (`_propagate_schemas`, `resolve_schemas`,
   `check_build`): every node's output names derive from its children's.
   The builder validates through it at build time and the executor at
   bind time.
2. **Dtype typing** (`type_expr`, `_check_types`, `column_types`): with
   the inputs' dtypes known, expressions type bottom-up by
   `plan/expr.py`'s own `promote`; predicates must type to BOOL, `&`, `|`
   and `~` take no float, and expressions and data-reading aggregates take
   no string, nested or DECIMAL128 column. A dtype that cannot be known
   never flags.
3. **Scan pruning** (`_check_scan_pruning`): a `Scan.predicate` must sit
   directly under the Filter or FusedSelect that enforces it, on a scan
   with one consumer, and every conjunct must be provable from min/max
   statistics and kept above.
4. **Partitioning** (`_check_partitioning`, `verify(planned=True)`):
   every node's hash-partitioning claim re-derived with `plan/
   distributed.py`'s rules; shuffle joins and keyed aggregates
   co-located, sharded relations gathered before an operator with no
   distributed form, one gather at the root. A meshed eager executor
   runs it on every plan whose exchanges the optimizer placed.

`verify_rewrite` adds the checks of an optimizer rewrite that one plan
cannot show: the root schema is kept, and a join build-side swap happens
only where row order is unobservable and never under float inputs or a
`mean`. `PlanExecutor.execute` runs `verify`/`verify_rewrite` before every
plan when SPARK_RAPIDS_TORCH_VERIFY_PLANS is on (`config.verify_plans`).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from .. import dtypes
from ..dtypes import Kind
from ..plan.expr import (BinOp, ColumnRef, Expr, Literal, ScalarAgg,
                         UnaryOp, promote, unary_check)
from ..plan.nodes import (Exchange, Filter, FusedSelect, HashAggregate,
                          HashJoin, PlanNode, PlanValidationError, Project,
                          Scan, Union)

__all__ = ["Violation", "VerifyReport", "PlanVerificationError", "verify",
           "verify_rewrite", "check_build", "resolve_schemas",
           "column_types", "type_expr"]


# ---- error vocabulary -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: a code, the operator's label, a message."""
    invariant: str
    node: str
    message: str

    def __str__(self):
        return f"[{self.invariant}] {self.message}"


class PlanVerificationError(PlanValidationError):
    """A plan failed static verification; carries the `violations`."""

    def __init__(self, violations: List[Violation], context: str = ""):
        self.violations = list(violations)
        head = f"plan verification failed ({context}):\n" if context else ""
        super().__init__(head + "\n".join(str(v) for v in self.violations))


class VerifyReport:
    """The violations one verification found (none: the plan is
    consistent with every checked invariant)."""

    def __init__(self, violations: Optional[List[Violation]] = None):
        self.violations: List[Violation] = list(violations or [])

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, invariant: str, node: PlanNode, message: str):
        self.violations.append(Violation(invariant, node.label, message))

    def raise_if_failed(self, context: str = ""):
        if self.violations:
            raise PlanVerificationError(self.violations, context)

    def __repr__(self):
        return f"VerifyReport({len(self.violations)} violation(s))"


# ---- layer 1: schema propagation --------------------------------------------

def _propagate_schemas(nodes, bound, strict
                       ) -> Tuple[Dict[int, Tuple[str, ...]],
                                  List[Violation]]:
    """node-id -> output names over a toposorted node list, collecting
    violations. A node whose schema cannot be derived poisons its subtree
    silently, so one authoring mistake yields one violation."""
    bound = bound or {}
    out: Dict[int, Tuple[str, ...]] = {}
    vs: List[Violation] = []
    broken = set()
    for node in nodes:
        if isinstance(node, Scan):
            schema = bound.get(node.source, node.schema)
            if schema is None and not strict:
                broken.add(id(node))
                continue
            if schema is None:
                vs.append(Violation(
                    "schema.unbound-scan", node.label,
                    f"{node.label}: input {node.source!r} is not bound "
                    f"and no schema was declared"))
                broken.add(id(node))
                continue
            schema = tuple(schema)
            if node.schema is not None and tuple(node.schema) != schema:
                vs.append(Violation(
                    "schema.binding-mismatch", node.label,
                    f"{node.label}: bound table schema {list(schema)} "
                    f"does not match declared {list(node.schema)}"))
                broken.add(id(node))
                continue
            try:
                # the cross-check above ran on the full schema; a pruned
                # projection narrows the output
                out[id(node)] = node.apply_projection(schema)
            except PlanValidationError as e:
                vs.append(Violation("schema", node.label, str(e)))
                broken.add(id(node))
            continue
        child_schemas = []
        ok = True
        for c in node.children:
            if id(c) not in out:
                ok = False
                break
            child_schemas.append(out[id(c)])
        if not ok:
            if strict and not any(id(c) in broken for c in node.children):
                vs.append(Violation(
                    "schema.unresolved", node.label,
                    f"{node.label}: child schema unresolved"))
            broken.add(id(node))
            continue
        try:
            out[id(node)] = tuple(node.output_names(child_schemas))
        except PlanValidationError as e:
            vs.append(Violation("schema", node.label, str(e)))
            broken.add(id(node))
    return out, vs


def resolve_schemas(nodes, bound=None, strict: bool = True
                    ) -> Dict[int, Tuple[str, ...]]:
    """Raising form of the schema layer (`Plan.resolve_schemas`)."""
    out, vs = _propagate_schemas(nodes, bound, strict)
    if vs:
        raise PlanVerificationError(vs)
    return out


def check_build(plan) -> Dict[int, Tuple[str, ...]]:
    """Build-time validation for `Plan.__init__`: duplicate-source check +
    non-strict schema propagation. Returns the resolvable schemas."""
    sources = [s.source for s in plan.scans]
    dup = {s for s in sources if sources.count(s) > 1}
    if dup:
        raise PlanVerificationError([Violation(
            "schema.duplicate-source", plan.root.label,
            f"multiple Scan nodes bind the same input(s) {sorted(dup)}; "
            "reuse one Scan node (the DAG executes it once)")])
    schemas, vs = _propagate_schemas(plan.nodes, None, strict=False)
    if vs:
        raise PlanVerificationError(vs)
    return schemas


# ---- layer 2: expression and operator dtype typing --------------------------

_NOT_ROW_SHAPED = (Kind.STRING, Kind.LIST, Kind.STRUCT, Kind.DECIMAL128)


def _expr_addressable(dt: Optional[dtypes.DType]) -> bool:
    """Whether `Expr.evaluate` can read the column: it reads the raw data
    buffer, which for string, nested and DECIMAL128 ((n, 4) limbs)
    columns is not one value a row."""
    return dt is None or dt.kind not in _NOT_ROW_SHAPED


def _lit_dtype(v) -> Optional[dtypes.DType]:
    if isinstance(v, bool):
        return dtypes.BOOL
    if isinstance(v, int):
        return dtypes.INT64
    if isinstance(v, float):
        return dtypes.FLOAT64
    return None


_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


def _storage(dt: dtypes.DType) -> Optional[torch.dtype]:
    try:
        return dt.storage_dtype()
    except TypeError:                   # a kind not ported yet
        return None


def _type(e: Expr, coltypes, node, report) -> Tuple[
        Optional[dtypes.DType], bool]:
    """(dtype or None, weak): `type_expr` with the weak flag that
    `plan/expr.py`'s promotion reads."""
    if isinstance(e, ColumnRef):
        dt = coltypes.get(e.name)
        if not _expr_addressable(dt):
            report.add("typing.column-not-expr-addressable", node,
                       f"{node.label}: column {e.name!r} is {dt!r} — "
                       "expressions read the raw data buffer, which for "
                       "string/nested/decimal128 columns is not "
                       "row-shaped")
            return None, False
        return dt, False
    if isinstance(e, Literal):
        dt = _lit_dtype(e.value)
        return dt, dt is not None and dt != dtypes.BOOL
    if isinstance(e, BinOp):
        lt, lw = _type(e.left, coltypes, node, report)
        rt, rw = _type(e.right, coltypes, node, report)
        if e.op in _CMP_OPS:
            return dtypes.BOOL, False
        if e.op in ("&", "|"):
            for side in (lt, rt):
                if side is not None and side.is_floating:
                    report.add("typing.bitwise-on-float", node,
                               f"{node.label}: {e.op!r} over a "
                               f"floating-point operand in {e!r} — jnp "
                               "bitwise ops reject floats at runtime")
                    return None, False
        if lt is None or rt is None:
            return None, False
        a, b = _storage(lt), _storage(rt)
        if a is None or b is None:
            return None, False
        try:
            dt, weak = promote(e.op, a, lw, b, rw)
            return dtypes.from_torch(dt), weak
        except TypeError:
            return None, False          # the reference leaves it unknown
    if isinstance(e, UnaryOp):
        ct, weak = _type(e.child, coltypes, node, report)
        if e.op == "~":
            if ct is not None and ct.is_floating:
                report.add("typing.invert-on-float", node,
                           f"{node.label}: ~ over a floating-point "
                           f"operand in {e!r} — jnp rejects it at "
                           "runtime")
                return None, False
            return ct, weak
        if ct is not None and _storage(ct) is not None:
            try:
                unary_check(e.op, _storage(ct))
            except TypeError:
                return None, False      # -bool: the reference leaves it
        return ct, weak
    if isinstance(e, ScalarAgg):
        ct, weak = _type(e.child, coltypes, node, report)
        if ct is None:
            return None, False
        if e.op == "sum":
            return (ct if ct.is_floating else dtypes.INT64), weak
        return ct, weak                 # min/max preserve
    return None, False


def type_expr(e: Expr, coltypes: Dict[str, Optional[dtypes.DType]],
              node: PlanNode, report: VerifyReport
              ) -> Optional[dtypes.DType]:
    """Bottom-up dtype of `e` as `Expr.evaluate` computes it (None when
    unknowable); appends a violation only for expressions that definitely
    fail at run time."""
    return _type(e, coltypes, node, report)[0]


def _agg_out_dtype(op: str, child_dt: Optional[dtypes.DType]
                   ) -> Optional[dtypes.DType]:
    """The aggregate's output dtype by the port's own rule
    (`ops/aggregate._agg_value_dtype`), None when unknowable."""
    from ..ops.aggregate import _agg_value_dtype
    if op in ("count", "size", "mean"):
        return _agg_value_dtype(op, child_dt)
    if child_dt is None:
        return None
    try:
        return _agg_value_dtype(op, child_dt)
    except TypeError:
        return None


def _check_predicate(pred: Expr, coltypes, node, report: VerifyReport):
    t = type_expr(pred, coltypes, node, report)
    if t is not None and t.kind != Kind.BOOL:
        report.add("typing.predicate-not-bool", node,
                   f"{node.label}: predicate {pred!r} types to {t!r}, "
                   "not BOOL — a non-boolean mask silently corrupts the "
                   "capped tier's alive set")


def _check_types(nodes, schemas, input_dtypes, report: VerifyReport
                 ) -> Dict[int, Dict[str, Optional[dtypes.DType]]]:
    """Node dtypes bottom-up; unknown columns stay unknown and never flag.
    `input_dtypes` maps scan source -> {column: DType}. Returns node-id ->
    {column: DType or None}."""
    types: Dict[int, Dict[str, Optional[dtypes.DType]]] = {}
    for node in nodes:
        if id(node) not in schemas:
            continue            # the schema layer poisoned this subtree
        if any(id(c) not in types for c in node.children):
            types[id(node)] = {}
            continue
        kids = [types[id(c)] for c in node.children]
        if isinstance(node, Scan):
            src = dict(input_dtypes.get(node.source) or {})
            types[id(node)] = {n: src.get(n) for n in schemas[id(node)]}
            continue
        if isinstance(node, Filter):
            _check_predicate(node.predicate, kids[0], node, report)
            types[id(node)] = kids[0]
            continue
        if isinstance(node, (Project, FusedSelect)):
            if isinstance(node, FusedSelect):
                _check_predicate(node.predicate, kids[0], node, report)
            # bare ColumnRefs pass through the executor's _project
            # untouched (never Expr.evaluate): only computed expressions
            # type-check
            types[id(node)] = {
                n: (kids[0].get(e.name) if isinstance(e, ColumnRef)
                    else type_expr(e, kids[0], node, report))
                for n, e in node.exprs}
            continue
        if isinstance(node, HashJoin):
            out = dict(kids[0])
            if node.how == "inner":
                out.update(kids[1])
            types[id(node)] = out
            continue
        if isinstance(node, HashAggregate):
            out = {k: kids[0].get(k) for k in node.keys}
            for c, o, n in node.aggs:
                cdt = kids[0].get(c) if o != "size" else None
                # only ops that read the data buffer as one value a row:
                # sum and mean always, min and max in the keyless path
                reads_data = o in ("sum", "mean") or (
                    not node.keys and o in ("min", "max"))
                if reads_data and not _expr_addressable(cdt):
                    report.add(
                        "typing.agg-over-non-scalar", node,
                        f"{node.label}: {o}({c}) reduces a {cdt!r} "
                        "column's data buffer, which is not row-shaped "
                        "for string/nested/decimal128 layouts")
                out[n] = _agg_out_dtype(o, cdt)
            types[id(node)] = out
            continue
        if isinstance(node, Union):
            first = kids[0]
            for other in kids[1:]:
                for name in schemas[id(node)]:
                    a, b = first.get(name), other.get(name)
                    if a is None or b is None:
                        continue
                    if _expr_addressable(a) != _expr_addressable(b):
                        report.add(
                            "typing.union-dtype-mismatch", node,
                            f"{node.label}: column {name!r} is {a!r} on "
                            f"one input and {b!r} on another — UNION ALL "
                            "cannot concatenate scalar and non-scalar "
                            "layouts")
            types[id(node)] = dict(first)
            continue
        # Sort/TopK/Limit/Exchange: pass-through
        types[id(node)] = dict(kids[0]) if kids else {}
    return types


def column_types(nodes, schemas, input_dtypes
                 ) -> Dict[int, Dict[str, Optional[dtypes.DType]]]:
    """node-id -> {column: DType or None} by the typing layer's walk, its
    violations discarded (callers that want them gate through verify)."""
    return _check_types(nodes, schemas, input_dtypes, VerifyReport())


# ---- layer 3: scan-pruning legality -----------------------------------------

def _conjunct_triples(pred: Expr):
    """(name, op, repr(value)) triples of the min/max-provable top-level
    AND conjuncts, and the count of the others."""
    from ..plan.optimizer import _as_comparison, split_conjuncts
    triples, unprovable = set(), 0
    for c in split_conjuncts(pred):
        cmp = _as_comparison(c)
        if cmp is None:
            unprovable += 1
        else:
            triples.add((cmp[0], cmp[1], repr(cmp[2])))
    return triples, unprovable


def _check_scan_pruning(nodes, report: VerifyReport):
    """A `Scan.predicate` only prunes: the Filter or FusedSelect that
    enforces it must sit directly above, the scan must have one consumer
    (a shared scan feeds parents that did not author the filter), and
    every conjunct must be min/max-provable and a conjunct of the kept
    predicate."""
    parents: Dict[int, List[PlanNode]] = {}
    for n in nodes:
        for c in n.children:
            parents.setdefault(id(c), []).append(n)
    for node in nodes:
        if not isinstance(node, Scan) or node.predicate is None:
            continue
        ps = parents.get(id(node), [])
        if len(ps) != 1:
            report.add("pruning.shared-scan", node,
                       f"{node.label}: carries a pruning predicate but "
                       f"has {len(ps)} consumers — pruning a DAG-shared "
                       "scan starves the parents that did not author "
                       "the filter")
            continue
        parent = ps[0]
        if not isinstance(parent, (Filter, FusedSelect)):
            report.add("pruning.unenforced-predicate", node,
                       f"{node.label}: pruning predicate "
                       f"{node.predicate!r} has no enforcing Filter/"
                       f"FusedSelect directly above (parent is "
                       f"{parent.label}) — pruned row groups would "
                       "change the result")
            continue
        scan_triples, unprovable = _conjunct_triples(node.predicate)
        if unprovable:
            report.add("pruning.unprovable-conjunct", node,
                       f"{node.label}: pruning predicate "
                       f"{node.predicate!r} contains conjunct(s) row-"
                       "group min/max statistics cannot prove — the "
                       "scan would over-prune")
            continue
        parent_triples, _ = _conjunct_triples(parent.predicate)
        missing = scan_triples - parent_triples
        if missing:
            report.add("pruning.unretained-conjunct", node,
                       f"{node.label}: pruning conjunct(s) "
                       f"{sorted(missing)} are not conjuncts of the "
                       f"retained predicate on {parent.label} — rows "
                       "the plan still wants could be pruned")


# ---- layer 4: partitioning soundness ----------------------------------------

def _check_partitioning(nodes, root, schemas, float_inputs: bool,
                        report: VerifyReport):
    """Re-derive each node's sharded state and hash-partitioning claim
    bottom-up (`plan/distributed.transfer_part`) and prove the exchange
    structure sound: co-located shuffle-join and keyed-aggregate inputs,
    a gather wherever a sharded relation meets an operator with no
    distributed form, one gather at the root. Meaningful only for an
    exchange-planned plan (`verify(planned=True)`)."""
    from ..plan.distributed import (join_alignment, part_satisfies,
                                    transfer_part)
    from ..plan.optimizer import _statically_distributable
    sharded: Dict[int, bool] = {}
    part: Dict[int, frozenset] = {}
    for node in nodes:
        if id(node) not in schemas:
            continue
        kids = list(node.children)
        kid_sharded = [sharded.get(id(c), False) for c in kids]
        kid_parts = [part.get(id(c), frozenset()) for c in kids]
        if isinstance(node, Exchange):
            base = kid_sharded[0]
            if node.how == "gather":
                if not base:
                    report.add("partitioning.redundant-gather", node,
                               f"{node.label}: gathers an input that is "
                               "already local — the sink must gather "
                               "exactly once")
                sharded[id(node)] = False
                part[id(node)] = frozenset()
            elif node.how == "broadcast":
                # replicates a sharded relation, or lifts a local build side
                sharded[id(node)] = True
                part[id(node)] = frozenset()
            else:               # hash / identity: no-op over a local child
                sharded[id(node)] = base
                part[id(node)] = (transfer_part(node, kid_parts)
                                  if base else frozenset())
            continue
        on_mesh = _statically_distributable(node, float_inputs) and (
            isinstance(node, Scan) or (bool(kids) and all(kid_sharded)))
        sharded[id(node)] = on_mesh
        part[id(node)] = (transfer_part(node, kid_parts)
                          if on_mesh else frozenset())
        if not on_mesh:
            for c, s in zip(kids, kid_sharded):
                if s:
                    report.add(
                        "partitioning.ungathered-input", node,
                        f"{node.label}: has no distributed form for "
                        f"this binding but consumes sharded {c.label} "
                        "without a gather boundary")
            continue
        if isinstance(node, HashJoin):
            l, r = kids
            r_broadcast = isinstance(r, Exchange) and r.how == "broadcast"
            if isinstance(l, Exchange) and l.how == "broadcast":
                report.add("partitioning.broadcast-probe", node,
                           f"{node.label}: probe (left) side is a "
                           "broadcast exchange — only the build side "
                           "may replicate")
            if not r_broadcast and join_alignment(
                    kid_parts[0], kid_parts[1],
                    node.left_keys, node.right_keys) is None:
                report.add(
                    "partitioning.join-not-colocated", node,
                    f"{node.label}: sides are partitioned by "
                    f"{sorted(map(list, kid_parts[0])) or 'rows'} vs "
                    f"{sorted(map(list, kid_parts[1])) or 'rows'} — "
                    f"matching keys ({', '.join(node.left_keys)}) = "
                    f"({', '.join(node.right_keys)}) are not provably "
                    "co-located; the elided shuffle would duplicate/"
                    "drop matches")
        elif isinstance(node, HashAggregate) and node.keys:
            (c,) = kids
            fused = isinstance(c, Exchange) and c.how == "hash"
            if not fused and not part_satisfies(kid_parts[0], node.keys):
                report.add(
                    "partitioning.agg-not-colocated", node,
                    f"{node.label}: groups by ({', '.join(node.keys)}) "
                    f"over an input partitioned by "
                    f"{sorted(map(list, kid_parts[0])) or 'rows'} — no "
                    "claim co-locates every group and no hash exchange "
                    "re-places them; a shard-local merge would emit "
                    "duplicate groups")
    if sharded.get(id(root), False):
        report.add("partitioning.unsunk-root", root,
                   f"{root.label}: plan root is still sharded — the "
                   "planned sink gather is missing")


# ---- entry points -----------------------------------------------------------

def _any_float(input_dtypes) -> bool:
    return bool(input_dtypes) and any(
        dt is not None and dt.is_floating
        for cols in input_dtypes.values() for dt in cols.values())


def verify(plan, *, bound=None,
           input_dtypes: Optional[Dict[str, Dict]] = None,
           float_inputs: Optional[bool] = None,
           planned: bool = False) -> VerifyReport:
    """Verify one plan. `bound` maps scan source -> column names (the
    schema layer runs strict when given); `input_dtypes` maps source ->
    {column: DType} and turns on the typing layer; `planned=True` turns
    on the partitioning layer (the plan claims a complete exchange plan).
    Callers gate with `.raise_if_failed()`."""
    report = VerifyReport()
    schemas, schema_vs = _propagate_schemas(plan.nodes, bound,
                                            strict=bound is not None)
    report.violations.extend(schema_vs)
    if float_inputs is None:
        float_inputs = _any_float(input_dtypes)
    if input_dtypes:
        _check_types(plan.nodes, schemas, input_dtypes, report)
    _check_scan_pruning(plan.nodes, report)
    if planned and not schema_vs:
        _check_partitioning(plan.nodes, plan.root, schemas,
                            bool(float_inputs), report)
    return report


def _plan_has_mean(nodes) -> bool:
    return any(isinstance(n, HashAggregate)
               and any(o == "mean" for _, o, _ in n.aggs) for n in nodes)


def verify_rewrite(authored, optimized, *, bound=None,
                   input_dtypes: Optional[Dict[str, Dict]] = None,
                   float_inputs: Optional[bool] = None,
                   planned: bool = False, report=None) -> VerifyReport:
    """Verify an optimizer rewrite: the optimized plan alone, plus what
    the pair shows. The root schema is kept, and a join build-side swap
    happens only in an order-unobservable region, never under float
    inputs or a `mean`. `report` (the `OptimizeReport`) limits the swap
    check to runs where the build_side rule fired and names each swap's
    decision source."""
    out = verify(optimized, bound=bound, input_dtypes=input_dtypes,
                 float_inputs=float_inputs, planned=planned)
    if float_inputs is None:
        float_inputs = _any_float(input_dtypes)
    a_schemas, _ = _propagate_schemas(authored.nodes, bound, strict=False)
    o_schemas, _ = _propagate_schemas(optimized.nodes, bound, strict=False)
    a_root = a_schemas.get(id(authored.root))
    o_root = o_schemas.get(id(optimized.root))
    if a_root is not None and o_root is not None and a_root != o_root:
        out.add("rewrite.schema-drift", optimized.root,
                f"{optimized.root.label}: rewrite changed the plan's "
                f"output schema {list(a_root)} -> {list(o_root)}")
    if report is not None and not report.rules.get("build_side", 0):
        return out

    # a swap shows as an inner join's key pair occurring more often than
    # authored while its reverse was authored: a multiset count, so a
    # plan that authors both (x)/(y) and (y)/(x) cannot hide one
    def _pairs(nodes):
        return Counter((tuple(n.left_keys), tuple(n.right_keys))
                       for n in nodes
                       if isinstance(n, HashJoin) and n.how == "inner")

    a_cnt = _pairs(authored.nodes)
    excess = {p: c - a_cnt.get(p, 0)
              for p, c in _pairs(optimized.nodes).items()}
    swapped = []
    for n in optimized.nodes:
        if not (isinstance(n, HashJoin) and n.how == "inner"):
            continue
        p = (tuple(n.left_keys), tuple(n.right_keys))
        if excess.get(p, 0) > 0 and (p[1], p[0]) in a_cnt:
            excess[p] -= 1
            swapped.append(n)
    if not swapped:
        return out

    def _src(n) -> str:
        """Which estimate picked the swap: only `swap (...)` stamps
        count, since the fixpoint pass re-stamps the swapped node with a
        `keep`."""
        sources = getattr(report, "decision_sources", None) or {}
        got = sources.get(f"{n.label}/build_side")
        if got is None or not got.startswith("swap"):
            swaps = [v for k, v in sorted(sources.items())
                     if k.endswith("/build_side") and v.startswith("swap")]
            got = swaps[0] if len(swaps) == 1 else None
        return f" (decision source: {got})" if got else ""

    if float_inputs or _plan_has_mean(optimized.nodes) \
            or _plan_has_mean(authored.nodes):
        for n in swapped:
            out.add("rewrite.fp-build-side", n,
                    f"{n.label}: build-side swap under floating-point "
                    "inputs (or a mean aggregate) — fp reductions are "
                    "not reorder-exact on m:n joins, so the swapped "
                    f"pair enumeration changes the bits{_src(n)}")
        return out
    from ..plan.optimizer import _order_safe_ids
    safe = _order_safe_ids(optimized.root)
    for n in swapped:
        if id(n) not in safe:
            out.add("rewrite.order-unsafe-swap", n,
                    f"{n.label}: build-side swap where the join's output "
                    "row order is observable (not every path to the root "
                    "crosses a HashAggregate) — results would no longer "
                    f"be row-for-row identical{_src(n)}")
    return out
