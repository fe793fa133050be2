"""Rule-based plan optimizer: Catalyst-style logical rewrites before the
executor runs a plan.

Counterpart of `spark_rapids_tpu/plan/optimizer.py` for its single-device
rules. `PlanExecutor.execute()` runs this pipeline by default
(`SPARK_RAPIDS_TORCH_OPTIMIZER=off`, or `PlanExecutor(optimize=False)`, to
disable) and executes the rewritten DAG. Each rule is a pure
`root -> root'` rewrite; the pipeline runs to fixpoint with a pass-count
guard (`MAX_PASSES`), in the reference's order:

- `constant_folding`: literal-only subtrees fold (`expr.fold`);
  `Filter(true)` drops; `Filter(false)` becomes `Limit(0)`.
- `predicate_pushdown`: a Filter moves below a Project (through
  ColumnRef/Literal projections), below a Union, and into the side of a
  HashJoin whose columns it references.
- `limit_pushdown`: Limit(Limit) collapses, Limit moves below row-wise
  Projects, and Limit(Sort) fuses into `TopK`.
- `build_side`: inner-join children swap (with a column-order-restoring
  Project) when row estimates say the left side is much smaller, only
  where the join's row order is unobservable (every path to the root
  crosses a HashAggregate), and never with float inputs or a `mean`.
- `column_pruning`: required columns walk top-down; Scans narrow to a
  `projection`, Project/FusedSelect/HashAggregate drop dead outputs, and
  width-sensitive operators get a select-Project over dead input columns.
- `select_fusion`: adjacent Filters merge and Project(Filter) fuses into
  `FusedSelect`.

Estimates, as the reference's: a node's observed output rows from the
stats store (`optimize(stats=..., backend=...)`, plan/stats.py) first for
interior nodes, bound table sizes at scans, then `est_rows` scan hints,
then the resource certifier's sound `rows_hi` (analysis/footprint.py),
else None (the rule skips). Every build-side decision names its source on
`OptimizeReport.decision_sources` ("observed:<runs>", "hint",
"certified:<bound>" or "default"); `stats_driven()` says whether an
observed source changed the plan, and the executor then re-verifies the
rewrite (`verify_rewrite`) or reruns the static pipeline
(`stats_reverted`). `scan_pruning` lowers the provable conjuncts of a
Filter over a Scan bound to a Parquet source into `Scan.predicate` (the
scans in `streaming_sources`, or those carrying their own source).
`exchange_planning` runs once after the fixpoint for a meshed eager
executor (`mesh_peers`, `_plan_exchanges`: the distributed tier's
Exchange boundaries); `placement` waits for ROADMAP queue A item 14;
`RULE_NAMES` lists them all and the unported one counts 0. A rewrite that fails re-validation falls
back to the authored plan with `fell_back=True` and the culprit rule
named.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from .builder import Plan, _toposort
from .expr import (BinOp, ColumnRef, Expr, Literal, ScalarAgg, UnaryOp,
                   col, fold, has_scalar_agg, substitute)
from .nodes import (Exchange, Filter, FusedSelect, HashAggregate, HashJoin,
                    Limit, PlanNode, PlanValidationError, Project, Scan,
                    Sort, TopK, Union)

__all__ = ["optimize", "explain_optimized", "plan_fingerprint",
           "subtree_fingerprints", "split_conjuncts", "pruning_conjuncts",
           "OptimizeReport",
           "RULE_NAMES", "MAX_PASSES"]

MAX_PASSES = 10           # fixpoint guard: rewrite passes, not rewrites
_EST_BYTES_PER_CELL = 8   # the reference's INT64-tier column width
# a build side whose certified bytes (analysis/footprint.py) exceed this
# never broadcasts, whatever its row estimate
BROADCAST_BYTES = 64 << 20


# ---- fingerprint ------------------------------------------------------------

# pure hints that do not change what a plan computes (a Scan's attached
# streaming source is execution state, not plan structure)
_FP_SKIP_FIELDS = {"est_rows", "parquet"}


def _fp_expr(e: Expr) -> Tuple:
    """Type-tagged expression serialization: `col("1")` and `lit(1)` repr
    alike but must hash apart."""
    if isinstance(e, ColumnRef):
        return ("col", e.name)
    if isinstance(e, Literal):
        return ("lit", repr(e.value))
    if isinstance(e, BinOp):
        return ("bin", e.op, _fp_expr(e.left), _fp_expr(e.right))
    if isinstance(e, UnaryOp):
        return ("un", e.op, _fp_expr(e.child))
    if isinstance(e, ScalarAgg):
        return ("agg", e.op, _fp_expr(e.child))
    return ("expr", repr(e))


def _fp_value(v) -> object:
    if isinstance(v, Expr):
        return _fp_expr(v)
    if isinstance(v, tuple):
        return tuple(_fp_value(x) for x in v)
    return repr(v)


def _node_params(node: PlanNode) -> Tuple:
    """Canonical value tuple over the node's non-child parameters."""
    params = []
    for f in dataclasses.fields(node):
        if f.name in _FP_SKIP_FIELDS:
            continue
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            continue
        if isinstance(v, tuple) and v and isinstance(v[0], PlanNode):
            continue
        params.append((f.name, _fp_value(v)))
    return tuple(params)


def plan_fingerprint(plan: Plan) -> str:
    """Structural hash over the plan DAG: per node (kind, params, child
    indices in toposort order), so two independently built identical
    plans hash equal, and equal to the reference's hash of the same plan."""
    nodes = plan.nodes
    index = {id(n): i for i, n in enumerate(nodes)}
    toks = [(n.kind, _node_params(n),
             tuple(index[id(c)] for c in n.children)) for n in nodes]
    return hashlib.sha256(repr(toks).encode()).hexdigest()[:16]


def _subtree_token_hash(node: PlanNode, child_fps) -> str:
    """The one per-node subtree hash: the stats store's record keys
    (`subtree_fingerprints` of the executed plan) and the estimator's
    consult keys (`_Estimator._subtree_fp`) both derive from it."""
    toks = (node.kind, _node_params(node), tuple(child_fps))
    return hashlib.sha256(repr(toks).encode()).hexdigest()[:16]


def subtree_fingerprints(root: PlanNode) -> Dict[int, str]:
    """node id -> structural hash of the subtree below each node (kind,
    params, child subtree hashes), equal to the reference's: a subtree's
    observed rows carry from an executed plan to the same subtree of the
    next, and a schema or parameter change never matches."""
    out: Dict[int, str] = {}
    for n in _toposort(root):
        out[id(n)] = _subtree_token_hash(
            n, (out[id(c)] for c in n.children))
    return out


def split_conjuncts(e: Expr) -> List[Expr]:
    """Top-level AND conjuncts of a predicate (the predicate itself when
    its root is not `&`)."""
    if isinstance(e, BinOp) and e.op == "&":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


_PRUNE_OPS = ("<", "<=", ">", ">=", "==")
_FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _as_comparison(e: Expr) -> Optional[Tuple[str, str, object]]:
    """`col <op> literal` (either orientation) as (name, op, value); None
    for any other shape (an OR, a column-column compare, arithmetic, a
    scalar aggregate), which min/max statistics prove nothing about."""
    if not isinstance(e, BinOp) or e.op not in _PRUNE_OPS:
        return None
    l, r = e.left, e.right
    if isinstance(l, ColumnRef) and isinstance(r, Literal):
        return (l.name, e.op, r.value)
    if isinstance(r, ColumnRef) and isinstance(l, Literal):
        return (r.name, _FLIP_OP[e.op], l.value)
    return None


def pruning_conjuncts(e: Expr) -> List[Tuple[str, str, object]]:
    """The (column, op, literal) triples of `e`'s top-level AND conjuncts
    that row-group min/max statistics can evaluate. Pruning on this subset
    of an AND is conservative-exact (every extracted conjunct must hold for
    a row to survive the retained Filter); a non-conjunct shape, such as an
    OR at the top level, contributes nothing, so the scan_pruning rule
    declines rather than over-prunes."""
    out = []
    for c in split_conjuncts(e):
        cmp = _as_comparison(c)
        if cmp is not None:
            out.append(cmp)
    return out


def _statically_distributable(n: PlanNode, float_inputs: bool) -> bool:
    """Whether a node kind can run on a mesh: Limit and keyless aggregates
    have no distributed form, and `mean` or any float input rule out an
    aggregate (the exchange accumulates partials in exact int64). The
    exchange planner (`_plan_exchanges`) and the verifier's partitioning
    layer share it."""
    if isinstance(n, Limit):
        return False
    if isinstance(n, HashAggregate):
        if not n.keys or any(o == "mean" for _, o, _ in n.aggs):
            return False
        if float_inputs:
            return False
    return True


# ---- report -----------------------------------------------------------------

RULE_NAMES = ("constant_folding", "predicate_pushdown", "limit_pushdown",
              "build_side", "column_pruning", "select_fusion",
              "scan_pruning", "exchange_planning", "placement")


@dataclasses.dataclass
class OptimizeReport:
    """What the pipeline did to one plan: `PlanResult.optimizer` and
    `explain_optimized` show it. The keys are the reference's; those of
    unported rules (exchanges, sharding, placements) stay empty."""
    rules: Dict[str, int]
    passes: int = 0
    pruned_columns: int = 0        # columns dropped (scan/project/insert)
    pruned_bytes_est: int = 0      # est rows x 8 B per dropped column
    source_fingerprint: str = ""
    fingerprint: str = ""
    fell_back: bool = False
    fallback: Optional[Dict] = None    # rule, node, invariant, message
    exchanges: Dict[str, int] = dataclasses.field(default_factory=dict)
    exchanges_elided: int = 0
    sharding: Dict[str, str] = dataclasses.field(default_factory=dict)
    # "<join label>/build_side" -> "swap|keep (observed:<runs> | hint |
    # certified:<bound> | default)": which kind of estimate each build-side
    # decision rested on
    decision_sources: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    placements: Dict[str, str] = dataclasses.field(default_factory=dict)
    stats_reverted: bool = False

    def rules_fired(self) -> Dict[str, int]:
        return {k: v for k, v in self.rules.items() if v}

    def total_rewrites(self) -> int:
        return sum(self.rules.values())

    def stats_driven(self) -> bool:
        """Whether an observed-sourced decision changed the plan: a
        build-side `swap` stamped from observed rows, or any observed
        exchange-mode pick (counted either way, as the reference counts
        it: telling an observed pick from the same static one would need
        a second estimate per join). A `keep (observed:N)` build side
        confirms the static outcome and is not a rewrite. (The reference
        also counts observed placement decisions, a rule the port does
        not run.)"""
        for key, v in self.decision_sources.items():
            if "observed" not in v:
                continue
            if key.endswith("/exchange"):
                return True
            if key.endswith("/build_side") and v.startswith("swap"):
                return True
        return False

    def to_dict(self) -> Dict:
        return {"rules_fired": self.rules_fired(), "passes": self.passes,
                "pruned_columns": self.pruned_columns,
                "pruned_bytes_est": self.pruned_bytes_est,
                "fingerprint": self.fingerprint,
                "source_fingerprint": self.source_fingerprint,
                "fell_back": self.fell_back,
                "fallback": dict(self.fallback) if self.fallback else None,
                "exchanges": dict(self.exchanges),
                "exchanges_elided": self.exchanges_elided,
                "sharding": dict(self.sharding),
                "decision_sources": dict(self.decision_sources),
                "placements": dict(self.placements),
                "stats_driven": self.stats_driven(),
                "stats_reverted": self.stats_reverted}

    def summary(self) -> str:
        lines = [f"optimizer: {self.passes} pass(es), "
                 f"{self.total_rewrites()} rewrite(s)"
                 + (" [FELL BACK: re-validation failed, authored plan ran]"
                    if self.fell_back else "")]
        if self.fallback:
            lines.append(f"  fell back on rule={self.fallback.get('rule')} "
                         f"node={self.fallback.get('node')} "
                         f"invariant={self.fallback.get('invariant')}: "
                         f"{self.fallback.get('message')}")
        for name, n in self.rules_fired().items():
            lines.append(f"  {name}: {n}")
        if self.pruned_columns:
            lines.append(f"  pruned {self.pruned_columns} column(s) "
                         f"(~{self.pruned_bytes_est} bytes est)")
        if self.decision_sources:
            lines.append("  decision sources"
                         + (" [STATS REVERTED: observed-driven rewrite "
                            "failed verify_rewrite, static decisions ran]"
                            if self.stats_reverted else "") + ":")
            for key, src in sorted(self.decision_sources.items()):
                lines.append(f"    {key}: {src}")
        lines.append(f"  fingerprint {self.source_fingerprint} -> "
                     f"{self.fingerprint}")
        return "\n".join(lines)


# ---- rewrite infrastructure -------------------------------------------------

def _with_children(node: PlanNode, kids: Tuple[PlanNode, ...]) -> PlanNode:
    if isinstance(node, HashJoin):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, Union):
        return dataclasses.replace(node, inputs=tuple(kids))
    if node.children:
        return dataclasses.replace(node, child=kids[0])
    return node


def _rewrite(root: PlanNode, fn, shared: Optional[set] = None) -> PlanNode:
    """Bottom-up memoized rewrite. `fn(node) -> replacement | None` runs on
    each node after its children were rewritten; the memo keys on the
    original objects so DAG-shared subtrees rewrite once and stay shared.
    `shared` is kept live: a rebuilt shared node's id joins it, so a
    parent-side guard still sees the fresh object as shared."""
    memo: Dict[int, PlanNode] = {}

    def go(node: PlanNode) -> PlanNode:
        got = memo.get(id(node))
        if got is not None:
            return got
        kids = tuple(go(c) for c in node.children)
        if any(k is not c for k, c in zip(kids, node.children)):
            node2 = _with_children(node, kids)
        else:
            node2 = node
        if shared is not None and node2 is not node and id(node) in shared:
            shared.add(id(node2))
        out = fn(node2)
        memo[id(node)] = node2 if out is None else out
        return memo[id(node)]

    return go(root)


def _shared_ids(root: PlanNode) -> set:
    """ids of nodes referenced by more than one parent: rules that
    restructure a parent/child pair skip these, or the subtree would
    un-share."""
    counts: Dict[int, int] = {}
    for n in _toposort(root):
        for c in n.children:
            counts[id(c)] = counts.get(id(c), 0) + 1
    return {i for i, c in counts.items() if c > 1}


class _Schemas:
    """Lazy output-schema resolver for any node, old or freshly rewritten.
    Unresolvable subtrees resolve to None and schema-dependent rules skip
    them."""

    def __init__(self, bound: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.bound = dict(bound or {})
        self.memo: Dict[int, Optional[Tuple[str, ...]]] = {}

    def of(self, node: PlanNode) -> Optional[Tuple[str, ...]]:
        got = self.memo.get(id(node), _Schemas)
        if got is not _Schemas:
            return got
        if isinstance(node, Scan):
            base = self.bound.get(node.source, node.schema)
            s = None if base is None else node.apply_projection(base)
        else:
            kids = [self.of(c) for c in node.children]
            s = (None if any(k is None for k in kids)
                 else tuple(node.output_names(kids)))
        self.memo[id(node)] = s
        return s


# decision-source severity: a warm observation outranks everything; a
# certified bound and a hint outrank the structural defaults
_SRC_RANK = {"default": 0, "certified": 1, "hint": 2, "observed": 3}


class _Estimator:
    """Row-count estimates, bottom-up. Observed subtree rows from the stats
    store win for interior nodes; bound table sizes win at scans; `est_rows`
    hints fill in; where the static chain has nothing, the certifier's
    sound `rows_hi` fills in last; else None (rules skip). Selectivity
    guesses are crude on purpose; only build_side reads them, behind a 2x
    margin. Each estimate's source (and the observed run count or the
    certified bound) is kept so a decision can name it."""

    def __init__(self, bound_rows: Optional[Dict[str, int]] = None,
                 stats=None, backend: Optional[str] = None, cert=None):
        self.bound = dict(bound_rows or {})
        self.stats = stats          # plan/stats.StatsStore or None
        self.backend = backend
        self.cert = cert            # node -> certified rows hi or None
        self.memo: Dict[int, Optional[float]] = {}
        self.src: Dict[int, Tuple[str, Optional[int]]] = {}
        self._subfp: Dict[int, str] = {}

    def of(self, node: PlanNode) -> Optional[float]:
        got = self.memo.get(id(node), _Estimator)
        if got is not _Estimator:
            return got
        e, src, runs = self._compute(node)
        self.memo[id(node)] = e
        if e is not None:
            self.src[id(node)] = (src, runs)
        return e

    def source_of(self, *nodes: PlanNode) -> str:
        """The decision source over the nodes whose estimates fed one
        decision: the highest-ranked source, with the fewest observed runs
        (a decision is as warm as its coldest observation) or the largest
        certified bound."""
        best, runs, bnd = "default", None, None
        for n in nodes:
            s, r = self.src.get(id(n), ("default", None))
            if _SRC_RANK[s] > _SRC_RANK[best]:
                best = s
            if s == "observed" and r is not None:
                runs = r if runs is None else min(runs, r)
            if s == "certified" and r is not None:
                bnd = r if bnd is None else max(bnd, r)
        if best == "observed":
            return f"observed:{runs}"
        if best == "certified":
            return f"certified:{bnd}"
        return best

    def _subtree_fp(self, node: PlanNode) -> str:
        got = self._subfp.get(id(node))
        if got is None:
            got = _subtree_token_hash(
                node, (self._subtree_fp(c) for c in node.children))
            self._subfp[id(node)] = got
        return got

    def _observed(self, node: PlanNode) -> Optional[Tuple[int, int]]:
        if self.stats is None or self.backend is None:
            return None
        return self.stats.observed_rows(self.backend,
                                        self._subtree_fp(node))

    def _certified(self, node: PlanNode) -> Optional[int]:
        return None if self.cert is None else self.cert(node)

    def _compute(self, node: PlanNode
                 ) -> Tuple[Optional[float], str, Optional[int]]:
        if isinstance(node, Scan):
            v = self.bound.get(node.source)
            if v is not None:
                return float(v), "default", None
            obs = self._observed(node)
            if obs is not None:
                return float(obs[0]), "observed", obs[1]
            if node.est_rows is not None:
                return float(node.est_rows), "hint", None
            c = self._certified(node)
            if c is not None:
                return float(c), "certified", c
            return None, "default", None
        obs = self._observed(node)
        if obs is not None:
            return float(obs[0]), "observed", obs[1]
        kids = [self.of(c) for c in node.children]
        if any(k is None for k in kids):
            c = self._certified(node)
            if c is not None:
                return float(c), "certified", c
            return None, "default", None
        src, runs = "default", None
        for c in node.children:
            s, r = self.src.get(id(c), ("default", None))
            if _SRC_RANK[s] > _SRC_RANK[src]:
                src = s
            if s == "observed" and r is not None:
                runs = r if runs is None else min(runs, r)
        if isinstance(node, (Filter, FusedSelect)):
            return 0.5 * kids[0], src, runs
        if isinstance(node, (Project, Exchange, Sort)):
            return kids[0], src, runs
        if isinstance(node, (Limit, TopK)):
            return min(float(node.n), kids[0]), src, runs
        if isinstance(node, Union):
            return sum(kids), src, runs
        if isinstance(node, HashJoin):
            if node.how == "inner":
                return max(kids), src, runs
            return 0.5 * kids[0], src, runs
        if isinstance(node, HashAggregate):
            if not node.keys:
                return 1.0, src, runs
            return max(1.0, kids[0] / 10.0), src, runs   # distinct guess
        return (kids[0] if kids else None), src, runs


class _Ctx:
    """Schemas, estimates and shared ids computed fresh for one rule run,
    plus the report for prune counts."""

    def __init__(self, root, bound, bound_rows, report, float_inputs=False,
                 stats=None, backend=None, input_dtypes=None,
                 streaming=frozenset()):
        self.root = root
        self.streaming = streaming      # scan sources bound to streaming
        #                                 (Parquet) sources this execution
        self.bound = bound
        self.bound_rows = bound_rows
        self.input_dtypes = input_dtypes
        self._cert = None               # the certifier's walk, on demand
        self.schemas = _Schemas(bound)
        self.est = _Estimator(bound_rows, stats, backend,
                              cert=self.cert_rows_hi)
        self.shared = _shared_ids(root)
        self.report = report
        self.float_inputs = float_inputs

    def _cert_bound(self, node: PlanNode):
        """The certifier's bounds of `node` over this pass's root
        (analysis/footprint.py), walked at the first consult."""
        if self._cert is None:
            from ..analysis.footprint import certify_nodes
            self._cert = certify_nodes(
                _toposort(self.root), bound=self.bound,
                bound_rows=self.bound_rows, input_dtypes=self.input_dtypes)
        return self._cert.get(id(node))

    def cert_rows_hi(self, node: PlanNode) -> Optional[int]:
        b = self._cert_bound(node)
        return None if b is None else b.rows_hi

    def cert_out_bytes_hi(self, node: PlanNode) -> Optional[int]:
        """The exchange rule's broadcast byte proof."""
        b = self._cert_bound(node)
        return None if b is None else b.out_bytes_hi


# ---- rules ------------------------------------------------------------------
# Each rule: (root, ctx) -> (root', hits).

def _rule_constant_folding(root, ctx):
    hits = [0]

    def fn(node):
        if isinstance(node, Filter):
            p = fold(node.predicate)
            if isinstance(p, Literal):
                hits[0] += 1
                if bool(p.value):
                    return node.child              # Filter(true): drop
                return Limit(node.child, 0)        # Filter(false): empty
            if p is not node.predicate:
                hits[0] += 1
                return dataclasses.replace(node, predicate=p)
            return None
        if isinstance(node, FusedSelect):
            p = fold(node.predicate)
            exprs = tuple((n, fold(e)) for n, e in node.exprs)
            changed = (p is not node.predicate or
                       any(e is not o for (_, e), (_, o)
                           in zip(exprs, node.exprs)))
            if isinstance(p, Literal):
                hits[0] += 1
                child = (node.child if bool(p.value)
                         else Limit(node.child, 0))
                return Project(child, exprs)
            if changed:
                hits[0] += 1
                return FusedSelect(node.child, p, exprs)
            return None
        if isinstance(node, Project):
            exprs = tuple((n, fold(e)) for n, e in node.exprs)
            if any(e is not o for (_, e), (_, o) in zip(exprs, node.exprs)):
                hits[0] += 1
                return dataclasses.replace(node, exprs=exprs)
        return None

    return _rewrite(root, fn), hits[0]


def _rule_predicate_pushdown(root, ctx):
    hits = [0]

    def fn(node):
        if not isinstance(node, Filter):
            return None
        child, p = node.child, node.predicate
        if id(child) in ctx.shared:
            return None    # restructuring would un-share the subtree
        if isinstance(child, Project):
            if any(has_scalar_agg(e) for _, e in child.exprs):
                return None
            mapping = dict(child.exprs)
            refs = p.references()
            # substitute only through cheap projections: re-evaluating a
            # computed expression twice would trade bytes for work
            if refs <= set(mapping) and all(
                    isinstance(mapping[r], (ColumnRef, Literal))
                    for r in refs):
                hits[0] += 1
                pushed = Filter(child.child, substitute(p, mapping))
                return dataclasses.replace(child, child=pushed)
            return None
        if isinstance(child, Union) and not has_scalar_agg(p):
            hits[0] += 1
            return Union(tuple(Filter(i, p) for i in child.inputs))
        if isinstance(child, HashJoin) and not has_scalar_agg(p):
            refs = p.references()
            ls = ctx.schemas.of(child.left)
            rs = ctx.schemas.of(child.right)
            if child.how == "inner" and rs is not None and refs <= set(rs):
                hits[0] += 1
                return dataclasses.replace(
                    child, right=Filter(child.right, p))
            if ls is not None and refs <= set(ls):
                # semi/anti output the left schema, so a row filter on it
                # always commutes to the left side
                hits[0] += 1
                return dataclasses.replace(child, left=Filter(child.left, p))
        return None

    return _rewrite(root, fn, ctx.shared), hits[0]


def _rule_limit_pushdown(root, ctx):
    hits = [0]

    def fn(node):
        if not isinstance(node, Limit):
            return None
        c = node.child
        if id(c) in ctx.shared:
            return None
        if isinstance(c, Limit):
            hits[0] += 1
            return Limit(c.child, min(node.n, c.n))
        if isinstance(c, Project) and not any(
                has_scalar_agg(e) for _, e in c.exprs):
            hits[0] += 1
            return dataclasses.replace(c, child=Limit(c.child, node.n))
        if isinstance(c, Sort):
            hits[0] += 1
            return TopK(c.child, c.keys, c.ascending, node.n)
        return None

    return _rewrite(root, fn, ctx.shared), hits[0]


def _order_safe_ids(root: PlanNode) -> set:
    """ids of nodes whose output row order is unobservable: every path to
    the root passes through a HashAggregate via operators that merely
    propagate rows. (Sort is not a pass-through: a stable sort exposes
    input order on key ties; Limit/TopK take the first n rows.)"""
    nodes = _toposort(root)
    parents: Dict[int, List[PlanNode]] = {}
    for n in nodes:
        for c in n.children:
            parents.setdefault(id(c), []).append(n)
    pass_through = (Filter, FusedSelect, Project, HashJoin, Union, Exchange)
    safe: Dict[int, bool] = {}
    for n in reversed(nodes):             # parents before children
        ps = parents.get(id(n), [])
        safe[id(n)] = bool(ps) and all(
            isinstance(p, HashAggregate)
            or (isinstance(p, pass_through) and safe[id(p)])
            for p in ps)
    return {i for i, v in safe.items() if v}


def _rule_build_side(root, ctx):
    hits = [0]
    if ctx.float_inputs:
        # float sums are not reorder-exact on m:n joins: skip the rule
        # when any bound input carries floats
        return root, 0
    if any(isinstance(n, HashAggregate)
           and any(o == "mean" for _, o, _ in n.aggs)
           for n in _toposort(root)):
        # mean accumulates in float64 even over integer inputs
        return root, 0
    safe = _order_safe_ids(root)
    memo: Dict[int, PlanNode] = {}

    def go(n: PlanNode) -> PlanNode:      # the safety set keys on the
        got = memo.get(id(n))             # original node ids
        if got is not None:
            return got
        kids = tuple(go(c) for c in n.children)
        node2 = (_with_children(n, kids)
                 if any(k is not c for k, c in zip(kids, n.children)) else n)
        if (isinstance(n, HashJoin) and n.how == "inner"
                and id(n) in safe):
            le = ctx.est.of(n.left)
            re_ = ctx.est.of(n.right)
            ls = ctx.schemas.of(n.left)
            rs = ctx.schemas.of(n.right)
            # 2x hysteresis: the swapped join's sides never re-qualify
            if None not in (le, re_, ls, rs):
                swap = le * 2 < re_
                ctx.report.decision_sources[f"{n.label}/build_side"] = (
                    f"{'swap' if swap else 'keep'} "
                    f"({ctx.est.source_of(n.left, n.right)})")
                if swap:
                    hits[0] += 1
                    swapped = HashJoin(node2.right, node2.left,
                                       n.right_keys, n.left_keys,
                                       how="inner", row_cap=n.row_cap)
                    order = tuple(ls) + tuple(rs)  # restore authored order
                    node2 = Project(swapped,
                                    tuple((nm, col(nm)) for nm in order))
        memo[id(n)] = node2
        return node2

    return go(root), hits[0]


def _rule_select_fusion(root, ctx):
    hits = [0]

    def fn(node):
        if (isinstance(node, Filter) and isinstance(node.child, Filter)
                and id(node.child) not in ctx.shared
                and not has_scalar_agg(node.predicate)):
            inner = node.child
            hits[0] += 1
            return Filter(inner.child, inner.predicate & node.predicate)
        if (isinstance(node, Project) and isinstance(node.child, Filter)
                and id(node.child) not in ctx.shared):
            f = node.child
            hits[0] += 1
            return FusedSelect(f.child, f.predicate, node.exprs)
        return None

    return _rewrite(root, fn, ctx.shared), hits[0]


# width-sensitive operators: a dead column crossing one of these edges is
# materialized or sorted, so a zero-copy select pays for itself
_NARROW_PARENTS = (HashJoin, HashAggregate, Sort, TopK, Exchange)


def _rule_column_pruning(root, ctx):
    nodes = _toposort(root)
    schemas = {id(n): ctx.schemas.of(n) for n in nodes}
    if any(s is None for s in schemas.values()):
        return root, 0                    # unresolved subtree: skip the pass
    required: Dict[int, set] = {}
    extra: Dict[int, set] = {}     # union-equalization floor (see below)
    edge_req: Dict[Tuple[int, int], set] = {}

    def req_of(n):
        return required[id(n)] | extra.get(id(n), set())

    def push(parent, i, req):
        edge_req[(id(parent), i)] = req
        required[id(parent.children[i])] |= req

    # Union inputs must all narrow to the same schema, but a DAG-shared
    # input can pick up requirements from parents outside the union:
    # equalize every union's inputs and re-propagate until stable
    # (requirements only grow, so this ends well inside the bound).
    for _ in range(len(nodes) + 1):
        required = {id(n): set() for n in nodes}
        edge_req.clear()
        required[id(root)] = set(schemas[id(root)])
        # reversed toposort = parents before children
        for n in reversed(nodes):
            req = req_of(n)
            if isinstance(n, Filter):
                push(n, 0, set(req) | n.predicate.references())
            elif isinstance(n, (Project, FusedSelect)):
                kept = [e for name, e in n.exprs if name in req] or \
                       [n.exprs[0][1]]
                r = set().union(*[e.references() for e in kept])
                if isinstance(n, FusedSelect):
                    r |= n.predicate.references()
                if not r:                 # all-literal: keep a row carrier
                    r = {schemas[id(n.children[0])][0]}
                push(n, 0, r)
            elif isinstance(n, HashJoin):
                ls = schemas[id(n.left)]
                rs = schemas[id(n.right)]
                if n.how == "inner":
                    push(n, 0, (req & set(ls)) | set(n.left_keys))
                    push(n, 1, (req & set(rs)) | set(n.right_keys))
                else:
                    push(n, 0, set(req) | set(n.left_keys))
                    push(n, 1, set(n.right_keys))
            elif isinstance(n, HashAggregate):
                kept = [a for a in n.aggs if a[2] in req] or [n.aggs[0]]
                r = set(n.keys) | {c for c, o, _ in kept if o != "size"}
                if not r:                 # global size-only aggregate
                    r = {schemas[id(n.children[0])][0]}
                push(n, 0, r)
            elif isinstance(n, (Sort, TopK, Exchange)):
                push(n, 0, set(req) | set(n.keys))
            elif isinstance(n, (Limit, Union)):
                for i in range(len(n.children)):
                    push(n, i, set(req))
        stable = True
        for n in nodes:
            if isinstance(n, Union):
                eq = set().union(*[req_of(c) for c in n.children])
                for c in n.children:
                    if req_of(c) != eq:
                        extra.setdefault(id(c), set()).update(eq)
                        stable = False
        if stable:
            break

    hits = [0]
    rep = ctx.report

    def note_pruned(n_cols, est_rows):
        hits[0] += 1
        rep.pruned_columns += n_cols
        if est_rows is not None:
            rep.pruned_bytes_est += int(
                n_cols * est_rows * _EST_BYTES_PER_CELL)

    memo: Dict[int, PlanNode] = {}

    def go(n: PlanNode) -> PlanNode:
        got = memo.get(id(n))
        if got is not None:
            return got
        kids = [go(c) for c in n.children]
        if isinstance(n, _NARROW_PARENTS):
            for i, (orig_c, new_c) in enumerate(zip(n.children, kids)):
                if isinstance(new_c, Exchange):
                    continue    # Exchange is pass-through: narrow below it
                r = edge_req[(id(n), i)]
                cs = ctx.schemas.of(new_c)
                if cs is None or not (set(cs) - r):
                    continue
                keep = tuple(c for c in cs if c in r)
                note_pruned(len(cs) - len(keep), ctx.est.of(orig_c))
                kids[i] = Project(new_c,
                                  tuple((c, ColumnRef(c)) for c in keep))
        node2 = (_with_children(n, tuple(kids))
                 if any(k is not c for k, c in zip(kids, n.children)) else n)
        req = req_of(n)
        if isinstance(n, Scan):
            cur = schemas[id(n)]
            keep = tuple(c for c in cur if c in req) or (cur[0],)
            if keep != tuple(cur):
                note_pruned(len(cur) - len(keep), ctx.est.of(n))
                node2 = dataclasses.replace(node2, projection=keep)
        elif isinstance(n, (Project, FusedSelect)):
            kept = tuple((name, e) for name, e in n.exprs if name in req) \
                or (n.exprs[0],)
            if len(kept) < len(n.exprs):
                note_pruned(len(n.exprs) - len(kept), ctx.est.of(n))
                node2 = dataclasses.replace(node2, exprs=kept)
        elif isinstance(n, HashAggregate):
            kept = tuple(a for a in n.aggs if a[2] in req) or (n.aggs[0],)
            if len(kept) < len(n.aggs):
                note_pruned(len(n.aggs) - len(kept), ctx.est.of(n))
                node2 = dataclasses.replace(node2, aggs=kept)
        memo[id(n)] = node2
        return node2

    return go(root), hits[0]


def _rule_scan_pruning(root, ctx):
    """Filter/FusedSelect directly over a streaming-source Scan: lower the
    min/max-provable AND-conjuncts of the predicate into `Scan.predicate`
    for row-group pruning. Pruning only: the Filter/FusedSelect stays
    above for exact row semantics; a row group is skipped at scan time
    only when footer statistics prove the lowered conjuncts match nothing
    (io/parquet.select_row_groups). Predicates with no provable top-level
    conjunct (an OR at the root, column-column compares, scalar
    aggregates) lower nothing: extracting from inside an OR would
    over-prune rows the retained Filter still wants."""
    hits = [0]

    def fn(node):
        if not isinstance(node, (Filter, FusedSelect)):
            return None
        child = node.child
        if not isinstance(child, Scan) or child.predicate is not None:
            return None
        if child.parquet is None and child.source not in ctx.streaming:
            return None     # table-bound scan: nothing to prune at IO time
        if id(child) in ctx.shared:
            # a shared scan feeds other parents that did not author this
            # filter: pruning it would starve them of rows
            return None
        safe = [c for c in split_conjuncts(node.predicate)
                if _as_comparison(c) is not None]
        if not safe:
            return None
        pred = safe[0]
        for c in safe[1:]:
            pred = BinOp("&", pred, c)
        hits[0] += 1
        return _with_children(
            node, (dataclasses.replace(child, predicate=pred),))

    return _rewrite(root, fn, ctx.shared), hits[0]


_RULES = (
    ("constant_folding", _rule_constant_folding),
    ("predicate_pushdown", _rule_predicate_pushdown),
    ("limit_pushdown", _rule_limit_pushdown),
    ("build_side", _rule_build_side),
    ("column_pruning", _rule_column_pruning),
    ("select_fusion", _rule_select_fusion),
    ("scan_pruning", _rule_scan_pruning),
)


# ---- fall-back diagnostics --------------------------------------------------

def _plan_error(root: PlanNode, bound=None) -> Optional[PlanValidationError]:
    """Re-validate a rewritten root through the verifier; the schema error,
    or None when clean. `bound` matters: a Scan with no declared schema
    resolves only against the bound tables."""
    try:
        p = Plan(root)
        if bound:
            p.resolve_schemas(bound)
    except PlanValidationError as e:
        return e
    return None


def _diagnose(rule: str, err: PlanValidationError) -> Dict:
    """The (rule, node, invariant, message) fall-back record. Verifier
    errors carry structured violations; a bare PlanValidationError falls
    back to the leading `Kind#id:` label convention."""
    violations = getattr(err, "violations", None)
    if violations:
        v = violations[0]
        return {"rule": rule, "node": v.node, "invariant": v.invariant,
                "message": v.message}
    msg = str(err)
    head = msg.split(":", 1)[0]
    node = head if "#" in head and " " not in head else ""
    return {"rule": rule, "node": node, "invariant": "schema",
            "message": msg}


def _fall_back(plan: Plan, report: OptimizeReport):
    """Discard the rewrite and run the authored plan. The report describes
    what ran, so the discarded rewrite's counts are zeroed; the caller's
    `report.fallback` says why."""
    report.fell_back = True
    report.rules = {name: 0 for name in RULE_NAMES}
    report.pruned_columns = 0
    report.pruned_bytes_est = 0
    report.decision_sources = {}
    report.fingerprint = report.source_fingerprint
    return plan, report


# ---- exchange planning (the distributed tier) ----------------------------------

def _plan_exchanges(root: PlanNode, ctx: "_Ctx", n_peers: int):
    """After the fixpoint, for a meshed eager executor: walk the DAG
    bottom-up tracking each node's hash-partitioning claim
    (`plan.distributed.transfer_part`, the rule the runtime relations
    follow) and place the Exchange boundaries the mesh needs:

    - each shuffle-join side gets Exchange(hash, its keys) unless it is
      already partitioned by exactly that tuple (elided);
    - a join whose build side's estimate is at most
      `config.broadcast_rows()` (and no larger than the probe side), and
      whose certified bytes fit `BROADCAST_BYTES`, gets
      Exchange(broadcast) on its build side instead;
    - a keyed HashAggregate gets Exchange(hash, group keys) below it (the
      executor fuses the pair) unless its input already co-locates every
      group (a subset of the keys suffices): elided;
    - sharded relations flowing into an operator with no distributed form,
      and the root, get Exchange(gather).

    Returns (new root, insertions); fills report.exchanges,
    exchanges_elided and sharding."""
    from .. import config
    from .distributed import part_satisfies, transfer_part
    report = ctx.report
    nodes = _toposort(root)
    if any(ctx.schemas.of(n) is None for n in nodes):
        return root, 0
    thresh = config.broadcast_rows()
    stats = {"hash": 0, "broadcast": 0, "gather": 0}
    elided = [0]
    sharded: Dict[int, bool] = {}
    part: Dict[int, frozenset] = {}
    memo: Dict[int, PlanNode] = {}
    gathers: Dict[int, PlanNode] = {}   # one gather per shared child

    def add_exchange(child: PlanNode, keys, how: str) -> PlanNode:
        if how == "gather" and id(child) in gathers:
            return gathers[id(child)]
        stats[how] += 1
        ex = Exchange(child, tuple(keys), how=how)
        part[id(ex)] = transfer_part(ex, [part[id(child)]])
        sharded[id(ex)] = how != "gather"
        if how == "gather":
            gathers[id(child)] = ex
        return ex

    def go(n: PlanNode) -> PlanNode:
        got = memo.get(id(n))
        if got is not None:
            return got
        kids = [go(c) for c in n.children]
        on_mesh = _statically_distributable(n, ctx.float_inputs) and (
            isinstance(n, Scan) or (bool(kids)
                                    and all(sharded[id(k)] for k in kids)))
        if not on_mesh:
            # the graceful boundary: sharded children collect here
            kids = [add_exchange(k, (), "gather") if sharded[id(k)] else k
                    for k in kids]
        elif isinstance(n, HashJoin):
            l_new, r_new = kids
            le = ctx.est.of(n.left)
            re_ = ctx.est.of(n.right)
            row_ok = (re_ is not None and re_ <= thresh
                      and (le is None or re_ <= le))
            # broadcast legality is a proven byte bound; the row estimate
            # stays the cost rule
            bytes_hi = ctx.cert_out_bytes_hi(n.right)
            byte_ok = bytes_hi is None or bytes_hi <= BROADCAST_BYTES
            broadcast = row_ok and byte_ok
            note = ("" if bytes_hi is None else
                    f"; certified:{bytes_hi}B"
                    f"{'<=' if byte_ok else '>'}{BROADCAST_BYTES}B")
            report.decision_sources[f"{n.label}/exchange"] = (
                f"{'broadcast' if broadcast else 'shuffle'} "
                f"({ctx.est.source_of(n.left, n.right)}{note})")
            if broadcast:
                r_new = add_exchange(r_new, (), "broadcast")
            else:
                if tuple(n.left_keys) in part[id(l_new)]:
                    elided[0] += 1
                else:
                    l_new = add_exchange(l_new, n.left_keys, "hash")
                if tuple(n.right_keys) in part[id(r_new)]:
                    elided[0] += 1
                else:
                    r_new = add_exchange(r_new, n.right_keys, "hash")
            kids = [l_new, r_new]
        elif isinstance(n, HashAggregate):
            (c_new,) = kids
            if isinstance(c_new, Exchange) and c_new.how == "hash":
                pass                    # an authored boundary: kept
            elif part_satisfies(part[id(c_new)], n.keys):
                elided[0] += 1          # the input co-locates the groups
            else:
                kids = [add_exchange(c_new, n.keys, "hash")]
        node2 = (_with_children(n, tuple(kids))
                 if any(k is not c for k, c in zip(kids, n.children)) else n)
        sharded[id(node2)] = on_mesh
        part[id(node2)] = (transfer_part(
            node2, [part[id(k)] for k in node2.children])
            if on_mesh else frozenset())
        memo[id(n)] = node2
        return node2

    new_root = go(root)
    if sharded[id(new_root)]:
        new_root = add_exchange(new_root, (), "gather")   # the sink

    for node in _toposort(new_root):
        if isinstance(node, Exchange) and node.how != "identity":
            if node.how == "gather":
                spec = "local (gather)"
            elif node.how == "broadcast":
                spec = f"replicated@{n_peers}"
            else:
                spec = f"hash[{','.join(node.keys)}]@{n_peers}"
        elif not sharded.get(id(node), False):
            spec = "local"
        elif part.get(id(node)):
            keys = min(part[id(node)])
            spec = f"hash[{','.join(keys)}]@{n_peers}"
        else:
            spec = f"rows@{n_peers}"
        report.sharding[node.label] = spec
    report.exchanges = stats
    report.exchanges_elided = elided[0]
    return new_root, sum(stats.values())


def _attribute_fallback(plan: Plan, bound, bound_rows, float_inputs,
                        err: PlanValidationError, stats=None, backend=None,
                        input_dtypes=None, streaming=frozenset(),
                        mesh_peers: Optional[int] = None) -> Dict:
    """Re-run the pipeline from the authored root, re-validating after
    every rule that rewrites, to name the rule that produced the invalid
    DAG, with the estimates the failing pipeline read. Runs only on the
    fall-back path."""
    scratch = OptimizeReport(rules={name: 0 for name in RULE_NAMES})
    root = plan.root
    for _ in range(MAX_PASSES):
        pass_hits = 0
        for name, rule in _RULES:
            ctx = _Ctx(root, bound, bound_rows, scratch, float_inputs,
                       stats, backend, input_dtypes, streaming)
            try:
                new_root, n = rule(root, ctx)
            except PlanValidationError as bad:
                return _diagnose(name, bad)   # the rule itself blew up
            if new_root is not root:
                bad = _plan_error(new_root, bound)
                if bad is not None:
                    return _diagnose(name, bad)
            root = new_root
            pass_hits += n
        if not pass_hits:
            break
    if mesh_peers is not None and mesh_peers > 1:
        ctx = _Ctx(root, bound, bound_rows, scratch, float_inputs,
                   stats, backend, input_dtypes, streaming)
        try:
            new_root, _ = _plan_exchanges(root, ctx, mesh_peers)
        except PlanValidationError as bad:
            return _diagnose("exchange_planning", bad)
        bad = _plan_error(new_root, bound)
        if bad is not None:
            return _diagnose("exchange_planning", bad)
    return _diagnose("unknown", err)


# ---- pipeline ---------------------------------------------------------------

_NOT_PORTED_ARGS = {
    "placement": "placement (ROADMAP queue A item 14)",
}


def optimize(plan: Plan,
             bound: Optional[Dict[str, Tuple[str, ...]]] = None,
             bound_rows: Optional[Dict[str, int]] = None,
             max_passes: int = MAX_PASSES,
             float_inputs: bool = False,
             verify_rules: bool = False,
             stats=None,
             backend: Optional[str] = None,
             input_dtypes: Optional[Dict[str, Dict]] = None,
             streaming_sources=frozenset(),
             mesh_peers: Optional[int] = None,
             **not_ported) -> Tuple[Plan, OptimizeReport]:
    """Run the rule pipeline to fixpoint over `plan`. `bound` maps scan
    source -> actual column names and `bound_rows` -> actual row counts
    (execute() passes both; explain-time callers may pass neither and the
    schema- and estimate-dependent rules skip what they cannot resolve).
    `float_inputs` disables build_side (execute() sets it when any bound
    column is floating point). `verify_rules` re-validates every rule's
    output as it lands, so the first invalid rewrite falls back at once
    with its (rule, node, invariant) in `report.fallback`. `stats` (a
    plan/stats.StatsStore) and `backend` ("cuda" or "cpu") make the
    estimator read observed rows of that backend; with stats=None the
    decisions are the static pipeline's. `input_dtypes` (source ->
    {column: DType}) gives the certifier its dtypes (its row bounds need
    none). `streaming_sources` names the scans bound to streaming
    (Parquet) sources this execution: the scan_pruning rule fires only for
    those and for scans that carry their own source. `mesh_peers` (a
    meshed eager executor passes its mesh width) runs the
    `exchange_planning` rule once after the fixpoint (`_plan_exchanges`),
    after so that the logical rules never move through the physical
    boundaries. The reference's other arguments raise, naming the
    ROADMAP item that ports them.
    Returns the optimized Plan (the same object when nothing fired) and
    the report."""
    for arg in not_ported:
        if arg not in _NOT_PORTED_ARGS:
            raise TypeError(f"optimize() got an unexpected argument {arg!r}")
        raise NotImplementedError(f"optimize({arg}=...): "
                                  f"{_NOT_PORTED_ARGS[arg]} is not ported")
    report = OptimizeReport(rules={name: 0 for name in RULE_NAMES})
    report.source_fingerprint = plan.fingerprint
    streaming = frozenset(streaming_sources)
    root = plan.root
    try:
        for p in range(max_passes):
            pass_hits = 0
            for name, rule in _RULES:
                ctx = _Ctx(root, bound, bound_rows, report, float_inputs,
                           stats, backend, input_dtypes, streaming)
                new_root, n = rule(root, ctx)
                if verify_rules and new_root is not root:
                    bad = _plan_error(new_root, bound)
                    if bad is not None:
                        report.passes = p + 1
                        report.fallback = _diagnose(name, bad)
                        return _fall_back(plan, report)
                root = new_root
                report.rules[name] += n
                pass_hits += n
            report.passes = p + 1
            if not pass_hits:
                break
        if mesh_peers is not None and mesh_peers > 1:
            ctx = _Ctx(root, bound, bound_rows, report, float_inputs,
                       stats, backend, input_dtypes, streaming)
            new_root, n = _plan_exchanges(root, ctx, mesh_peers)
            if verify_rules and new_root is not root:
                bad = _plan_error(new_root, bound)
                if bad is not None:
                    report.fallback = _diagnose("exchange_planning", bad)
                    return _fall_back(plan, report)
            root = new_root
            report.rules["exchange_planning"] += n
    except PlanValidationError as err:
        # an invalid rewrite can detonate inside a later rule's schema
        # resolution: that too falls back, naming the culprit
        report.fallback = _attribute_fallback(plan, bound, bound_rows,
                                              float_inputs, err, stats,
                                              backend, input_dtypes,
                                              streaming, mesh_peers)
        return _fall_back(plan, report)
    if root is plan.root:
        report.fingerprint = report.source_fingerprint
        return plan, report
    try:
        opt = Plan(root)
        if bound:
            opt.resolve_schemas(bound)
    except PlanValidationError as err:
        report.fallback = _attribute_fallback(plan, bound, bound_rows,
                                              float_inputs, err, stats,
                                              backend, input_dtypes,
                                              streaming, mesh_peers)
        return _fall_back(plan, report)
    report.fingerprint = opt.fingerprint
    return opt, report


def explain_optimized(plan: Plan,
                      bound: Optional[Dict[str, Tuple[str, ...]]] = None,
                      bound_rows: Optional[Dict[str, int]] = None) -> str:
    """Authored tree, optimized tree, and the per-rule rewrite summary."""
    opt, report = optimize(plan, bound, bound_rows)
    return "\n".join(["== authored ==", plan.explain(), "",
                      "== optimized ==", opt.explain(), "",
                      report.summary()])
