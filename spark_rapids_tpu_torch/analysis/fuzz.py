"""Property-based plan fuzzer: seeded random DAGs over all 11 node kinds.

Counterpart of `spark_rapids_tpu/analysis/fuzz.py`. A `FuzzCase` is a
seeded random operator DAG (Scan, Filter, Project, FusedSelect, HashJoin,
HashAggregate, Sort, TopK, Limit, Union, Exchange, the optimizer-produced
kinds authored directly) and the tables it runs over. `gen_case(seed)`
draws exactly as the reference's does, from `random.Random(seed)` only:
the same seed gives the same plan, with the JAX package's
`Plan.fingerprint`, and the same table bytes. `edge_tables` redraws a
case's tables with edge values and nulls from a numpy generator of the
seed, so a case runs over the same bytes in both packages.

`run_case` checks the reference's properties 1-5:

1. the authored plan verifies (schema, typing and pruning layers);
2. the optimizer's rewrite (`verify_rules=True`) does not fall back and
   passes `verify_rewrite`;
3. the optimized and unoptimized eager runs agree bit for bit, compacted
   row for row, and an error raises with the same class in both (with no
   stats store: these measure the static engine);
4. `adaptive_parity`: the optimized plan run twice under a fresh
   `StatsStore(capacity=32, path="")` (the first run records, the second
   reads observed rows, caps and timings) agrees bit for bit, error class
   included;
5. `cert_sound`: the resource certifier is monotone (the optimized plan's
   root bounds are at most the authored plan's) and sound: every
   successful run (unoptimized, optimized, cold, warm, and one capped run
   of the optimized plan) stays inside the certificate of the plan it
   executed (`footprint.check_observed`: rows on both tiers, eager bytes).

Property 6 (placement on and off) needs the placement rule, which the
port has not yet: `FuzzResult` gives it as None and `NOT_CHECKED` names
the ROADMAP queue A item that ports it; it never counts as passed.

From the shell: `python -m spark_rapids_tpu_torch.analysis.fuzz --start S
--count N [--max-ops K] [--no-exec] [--device cpu|cuda]`. Like every entry
point of the port, `gen_case`, `run_case`, `run_corpus` and `main` run on
the CUDA card unless given `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..plan.expr import Expr, col, lit, scalar_max, scalar_min, scalar_sum
from ..plan.nodes import (Exchange, Filter, FusedSelect, HashAggregate,
                          HashJoin, Limit, PlanNode, Project, Scan, Sort,
                          TopK, Union)

__all__ = ["ALL_KINDS", "NOT_CHECKED", "FuzzCase", "FuzzResult",
           "gen_case", "edge_tables", "execute_case", "run_case",
           "run_corpus", "main"]

ALL_KINDS = ("Scan", "Filter", "Project", "FusedSelect", "HashJoin",
             "HashAggregate", "Sort", "TopK", "Limit", "Union", "Exchange")

_GLOBAL_AGGS = ("sum", "count", "size")      # empty-relation-safe
_KEYED_AGGS = ("sum", "count", "min", "max", "mean", "size")

# the reference's property the port does not check yet, and the ROADMAP
# item that ports it
NOT_CHECKED = {
    "placement_parity": "property 6, queue A item 14 (the placement rule)",
}


@dataclasses.dataclass
class FuzzCase:
    seed: int
    plan: object                 # plan.builder.Plan
    tables: Dict[str, object]    # source -> columnar.Table
    kinds: Tuple[str, ...]       # node kinds present, for coverage


@dataclasses.dataclass
class FuzzResult:
    seed: int
    verified: bool = True
    optimized_verified: bool = True
    executed: bool = False
    parity: Optional[bool] = None
    adaptive_parity: Optional[bool] = None
    cert_sound: Optional[bool] = None
    placement_parity: Optional[bool] = None
    error: Optional[str] = None
    not_checked: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(NOT_CHECKED))

    @property
    def ok(self) -> bool:
        return (self.verified and self.optimized_verified
                and self.error is None and self.parity is not False
                and self.adaptive_parity is not False
                and self.cert_sound is not False)


# ---- deterministic relation and expression generation ----------------------

class _Rel:
    """A relation while generating: the node, its (name -> tag) schema,
    tag 'i' (int64), 'f' (float64) or 'b' (bool), and a rough row
    estimate that keeps join products bounded."""

    __slots__ = ("node", "schema", "est")

    def __init__(self, node: PlanNode, schema: List[Tuple[str, str]],
                 est: float):
        self.node = node
        self.schema = list(schema)
        self.est = est

    def cols(self, tag=None) -> List[str]:
        return [n for n, t in self.schema if tag is None or t == tag]


def _gen_table(rng: random.Random, schema: List[Tuple[str, str]],
               n_rows: int, device):
    """The table over the tagged schema: ints in 0..7, so joins and
    groupbys meet duplicates, and quarter-integer floats, which are exact.
    The draws are the reference's, in its order."""
    from .. import dtypes
    from ..columnar import Column, Table
    cols, names = [], []
    for name, tag in schema:
        if tag == "i":
            data = np.asarray([rng.randrange(8) for _ in range(n_rows)],
                              dtype=np.int64)
            dt = dtypes.INT64
        elif tag == "f":
            data = np.asarray([rng.randrange(32) / 4.0
                               for _ in range(n_rows)], dtype=np.float64)
            dt = dtypes.FLOAT64
        else:
            data = np.asarray([rng.randrange(2) == 1
                               for _ in range(n_rows)], dtype=np.bool_)
            dt = dtypes.BOOL
        cols.append(Column.from_numpy(data, dt, device=device))
        names.append(name)
    return Table(cols, names=names)


def _gen_predicate(rng: random.Random, rel: _Rel, depth: int = 0) -> Expr:
    """Random boolean expression over the relation: comparisons of int
    and float columns with literals in range, conjunctions, disjunctions,
    negations, the odd scalar-aggregate subquery."""
    numeric = rel.cols("i") + rel.cols("f")
    if not numeric:
        return lit(True)
    if depth < 2 and rng.random() < 0.35:
        op = rng.choice(("&", "|", "~"))
        a = _gen_predicate(rng, rel, depth + 1)
        if op == "~":
            return ~a
        b = _gen_predicate(rng, rel, depth + 1)
        return (a & b) if op == "&" else (a | b)
    name = rng.choice(numeric)
    c = col(name)
    cmp = rng.choice(("<", "<=", ">", ">=", "==", "!="))
    if rng.random() < 0.12:
        sagg = rng.choice((scalar_max, scalar_min, scalar_sum))
        rhs: Expr = sagg(col(rng.choice(numeric)))
    else:
        is_f = name in rel.cols("f")
        rhs = lit(rng.randrange(32) / 4.0 if is_f else rng.randrange(8))
    return {"<": c < rhs, "<=": c <= rhs, ">": c > rhs, ">=": c >= rhs,
            "==": c == rhs, "!=": c != rhs}[cmp]


def _gen_exprs(rng: random.Random, rel: _Rel, fresh) -> Tuple[
        List[Tuple[str, Expr]], List[Tuple[str, str]]]:
    """Projection list: a random subset of the columns under their own
    names, and up to one derived integer column."""
    keep = [nt for nt in rel.schema if rng.random() < 0.75]
    if not keep:
        keep = [rng.choice(rel.schema)]
    exprs = [(n, col(n)) for n, _ in keep]
    schema = list(keep)
    numeric = rel.cols("i")
    if numeric and rng.random() < 0.5:
        name = fresh("d")
        a, b = rng.choice(numeric), rng.choice(numeric)
        op = rng.choice(("+", "-", "*"))
        e = {"+": col(a) + col(b), "-": col(a) - col(b),
             "*": col(a) * lit(rng.randrange(1, 4))}[op]
        exprs.append((name, e))
        schema.append((name, "i"))
    return exprs, schema


def gen_case(seed: int, *, max_ops: int = 8, allow_floats: bool = True,
             device=None) -> FuzzCase:
    """One deterministic random case, its tables on `device` (None: the
    card). The generator composes only schema-correct operators, from the
    whole node vocabulary, DAG-shared subtrees (self-unions, shared join
    inputs) included."""
    from .. import device as _device
    from ..plan.builder import Plan
    dev = _device.resolve(device)
    rng = random.Random(seed)
    counter = [0]

    def fresh(prefix: str) -> str:
        counter[0] += 1
        return f"{prefix}{counter[0]}"

    n_sources = rng.randrange(1, 4)
    tables: Dict[str, object] = {}
    rels: List[_Rel] = []
    for i in range(n_sources):
        src = f"s{i}"
        n_cols = rng.randrange(2, 5)
        schema = []
        for j in range(n_cols):
            r = rng.random()
            tag = ("f" if allow_floats and r < 0.18 else
                   "b" if r < 0.28 else "i")
            schema.append((f"{src}_c{j}", tag))
        n_rows = rng.randrange(6, 40)
        tables[src] = _gen_table(rng, schema, n_rows, dev)
        # an est_rows hint on some scans feeds the build_side rule
        est = n_rows if rng.random() < 0.5 else None
        rels.append(_Rel(Scan(src, tuple(n for n, _ in schema),
                              est_rows=est), schema, float(n_rows)))

    for _ in range(rng.randrange(3, max_ops + 1)):
        op = rng.choices(
            ("filter", "project", "fused", "aggregate", "sort", "topk",
             "limit", "union", "join", "exchange"),
            weights=(18, 14, 8, 12, 8, 5, 7, 7, 14, 7))[0]
        idx = rng.randrange(len(rels))
        rel = rels[idx]
        if op == "filter":
            pred = _gen_predicate(rng, rel)
            out = _Rel(Filter(rel.node, pred), rel.schema,
                       max(rel.est * 0.6, 1.0))
        elif op == "project":
            exprs, schema = _gen_exprs(rng, rel, fresh)
            out = _Rel(Project(rel.node, tuple(exprs)), schema, rel.est)
        elif op == "fused":
            exprs, schema = _gen_exprs(rng, rel, fresh)
            out = _Rel(FusedSelect(rel.node, _gen_predicate(rng, rel),
                                   tuple(exprs)), schema,
                       max(rel.est * 0.6, 1.0))
        elif op == "aggregate":
            numeric = rel.cols("i") + rel.cols("f")
            if not numeric:
                continue
            keyed = rel.cols("i") and rng.random() < 0.8
            keys = (tuple(rng.sample(rel.cols("i"),
                                     rng.randrange(1, min(3, len(
                                         rel.cols("i"))) + 1)))
                    if keyed else ())
            ops = _KEYED_AGGS if keys else _GLOBAL_AGGS
            aggs, schema = [], [(k, dict(rel.schema)[k]) for k in keys]
            for _ in range(rng.randrange(1, 3)):
                c = rng.choice(numeric)
                o = rng.choice(ops)
                name = fresh("a")
                aggs.append((c, o, name))
                tag = ("i" if o in ("count", "size") else
                       "f" if o == "mean" or dict(rel.schema)[c] == "f"
                       else "i")
                schema.append((name, tag))
            out = _Rel(HashAggregate(rel.node, keys, tuple(aggs)),
                       schema, max(rel.est / 4, 1.0) if keys else 1.0)
        elif op in ("sort", "topk"):
            sortable = rel.cols("i") + rel.cols("f")
            if not sortable:
                continue
            keys = tuple(rng.sample(sortable,
                                    rng.randrange(1, min(2, len(sortable))
                                                  + 1)))
            asc = tuple(rng.random() < 0.7 for _ in keys)
            if op == "sort":
                out = _Rel(Sort(rel.node, keys, asc), rel.schema, rel.est)
            else:
                out = _Rel(TopK(rel.node, keys, asc, rng.randrange(0, 12)),
                           rel.schema, 12.0)
        elif op == "limit":
            out = _Rel(Limit(rel.node, rng.randrange(0, 24)), rel.schema,
                       24.0)
        elif op == "union":
            # a self-union through two filters: the same schema, and the
            # child is DAG-shared (it runs once)
            p1 = _gen_predicate(rng, rel)
            p2 = _gen_predicate(rng, rel)
            out = _Rel(Union((Filter(rel.node, p1),
                              Filter(rel.node, p2))), rel.schema,
                       rel.est * 1.2)
        elif op == "join":
            partners = [r for r in rels
                        if r is not rel and r.cols("i")
                        and not (set(r.cols()) & set(rel.cols()))]
            if not partners or not rel.cols("i"):
                continue
            other = rng.choice(partners)
            if rel.est * other.est > 4000:
                continue
            lk = (rng.choice(rel.cols("i")),)
            rk = (rng.choice(other.cols("i")),)
            how = rng.choices(("inner", "left_semi", "left_anti"),
                              weights=(3, 1, 1))[0]
            schema = (rel.schema + other.schema if how == "inner"
                      else list(rel.schema))
            est = (rel.est * other.est / 4 if how == "inner"
                   else rel.est * 0.6)
            out = _Rel(HashJoin(rel.node, other.node, lk, rk, how=how),
                       schema, max(est, 1.0))
        else:   # exchange: hash on an int column, or the identity marker
            if rel.cols("i") and rng.random() < 0.7:
                out = _Rel(Exchange(rel.node,
                                    (rng.choice(rel.cols("i")),)),
                           rel.schema, rel.est)
            else:
                out = _Rel(Exchange(rel.node, ()), rel.schema, rel.est)
        rels[idx] = out

    root = rng.choice(rels)
    plan = Plan(root.node)
    return FuzzCase(seed=seed, plan=plan, tables=dict(tables),
                    kinds=tuple(sorted({n.kind for n in plan.nodes})))


_FLOAT_EDGES = (0.0, -0.0, float("nan"), float("inf"), float("-inf"),
                float(2 ** 53 + 2))
_INT_EDGES = (-(2 ** 63), 2 ** 63 - 1, 2 ** 53 + 1, 2 ** 31, -(2 ** 31), -1)


def edge_tables(case: FuzzCase, *, device=None) -> Dict[str, object]:
    """`case.tables` redrawn with edge values, from a numpy generator of
    the case's seed: ±0.0, NaN, ±inf and 2^53 + 2 in about 40% of the
    float values; INT64 min and max, 2^53 + 1, ±2^31 and -1 in about 20%
    of the int values; about 15% nulls in every column. The same seed
    gives the same bytes."""
    from .. import device as _device
    from ..columnar import Column, Table
    dev = _device.resolve(device)
    rng = np.random.default_rng(case.seed)
    out = {}
    for name in sorted(case.tables):
        t = case.tables[name]
        cols = []
        for c in t.columns:
            data = c.data.cpu().numpy().copy()
            n = data.shape[0]
            if c.dtype.is_floating:
                hit = rng.random(n) < 0.4
                data[hit] = rng.choice(np.array(_FLOAT_EDGES), n)[hit]
            elif c.dtype.is_integer:
                hit = rng.random(n) < 0.2
                data[hit] = rng.choice(np.array(_INT_EDGES, np.int64),
                                       n)[hit]
            valid = rng.random(n) >= 0.15
            cols.append(Column.from_numpy(data, c.dtype, valid, dev))
        out[name] = Table(cols, names=t.names)
    return out


# ---- properties -------------------------------------------------------------

def _run(case: FuzzCase, tables=None, *, mode: str = "eager",
         optimize: bool = False, device=None):
    """One run of the case's plan: (("ok", compacted Table) or ("err", the
    exception's class name), the PlanResult or None)."""
    from ..plan.executor import PlanExecutor
    ex = PlanExecutor(mode=mode, optimize=optimize, device=device)
    try:
        r = ex.execute(case.plan, dict(tables or case.tables))
        return ("ok", r.compact()), r
    except Exception as e:          # parity includes error parity
        return ("err", type(e).__name__), None


def execute_case(case: FuzzCase, tables=None, *, mode: str = "eager",
                 optimize: bool = False, device=None):
    """One run of the case's plan over `tables` (default `case.tables`):
    ("ok", compacted Table) or ("err", the exception's class name)."""
    return _run(case, tables, mode=mode, optimize=optimize,
                device=device)[0]


def _outcome(run) -> tuple:
    """A run's comparable form: every column's dtype, data bits and
    validity, or the error's class name."""
    status, got = run
    if status == "err":
        return run
    cols = []
    for name, c in zip(got.names, got.columns):
        data, valid = c.to_numpy()
        cols.append((name, repr(c.dtype), data.tobytes(),
                     None if valid is None else valid.tobytes()))
    return status, tuple(cols)


def _cert_kw(case: FuzzCase, bound) -> Dict:
    from .footprint import table_metadata
    input_dtypes, input_nullable = table_metadata(case.tables)
    return dict(bound=bound,
                bound_rows={n: t.num_rows for n, t in case.tables.items()},
                input_dtypes=input_dtypes, input_nullable=input_nullable)


def _cert_monotonicity(case: FuzzCase, opt, bound) -> Optional[str]:
    """Property 5's rewrite half: the optimized plan's certified root
    bounds are at most the authored plan's (a looser proof is a rule or
    certifier bug, even where the results agree)."""
    from .footprint import certify
    kw = _cert_kw(case, bound)
    a = certify(case.plan, **kw).root
    o = certify(opt, **kw).root
    if a.rows_hi is not None and (
            o.rows_hi is None or o.rows_hi > a.rows_hi):
        return (f"optimized root rows hi {o.rows_hi} exceeds authored "
                f"{a.rows_hi}")
    if a.out_bytes_hi is not None and (
            o.out_bytes_hi is None or o.out_bytes_hi > a.out_bytes_hi):
        return (f"optimized root bytes hi {o.out_bytes_hi} exceeds "
                f"authored {a.out_bytes_hi}")
    return None


def _cert_soundness(case: FuzzCase, results, bound) -> Optional[str]:
    """Property 5's run half: each successful run inside the certificate
    of the plan it executed (the single inequality of
    `footprint.check_observed`)."""
    from .footprint import certify, check_observed
    kw = _cert_kw(case, bound)
    for r in results:
        bad = check_observed(certify(r.plan, **kw), r)
        if bad is not None:
            return f"{r.mode}: {bad}"
    return None


def run_case(case: FuzzCase, *, execute: bool = True,
             device=None) -> FuzzResult:
    """Check properties 1-5 on one case. A property failure is carried by
    the result, never raised; only a generator bug raises."""
    from ..plan import stats as stats_mod
    from ..plan.executor import _input_has_floats
    from ..plan.optimizer import optimize
    from .verifier import verify, verify_rewrite
    res = FuzzResult(seed=case.seed)
    bound = {n: tuple(t.names) for n, t in case.tables.items()}
    input_dtypes = {
        n: {cn: c.dtype for cn, c in zip(t.names, t.columns)}
        for n, t in case.tables.items()}
    floats = _input_has_floats(case.tables)

    rep = verify(case.plan, bound=bound, input_dtypes=input_dtypes,
                 float_inputs=floats)
    if not rep.ok:
        res.verified = False
        res.error = f"authored plan failed verify: {rep.violations[0]}"
        return res

    bound_rows = {n: t.num_rows for n, t in case.tables.items()}
    opt, report = optimize(case.plan, bound, bound_rows,
                           float_inputs=floats, verify_rules=True)
    if report.fell_back:
        res.optimized_verified = False
        res.error = f"optimizer fell back: {report.fallback}"
        return res
    rep = verify_rewrite(case.plan, opt, bound=bound,
                         input_dtypes=input_dtypes, float_inputs=floats,
                         report=report)
    if not rep.ok:
        res.optimized_verified = False
        res.error = f"optimized plan failed verify: {rep.violations[0]}"
        return res

    mono = _cert_monotonicity(case, opt, bound)
    if mono is not None:
        res.cert_sound = False
        res.error = f"cert monotonicity broke: {mono}"
        return res
    res.cert_sound = True

    if not execute:
        return res
    res.executed = True
    done = []                   # successful PlanResults for property 5
    # properties 1-3 measure the static engine: no store, or an earlier
    # case's observations would warm this one
    with stats_mod.scoped_store(None):
        outs = {}
        for opt_on in (False, True):
            run, r = _run(case, optimize=opt_on, device=device)
            outs[opt_on] = _outcome(run)
            done += [r] if r is not None else []
        _, r = _run(case, mode="capped", optimize=True, device=device)
        done += [r] if r is not None else []
    res.parity = outs[False] == outs[True]
    if not res.parity:
        res.error = (f"eager parity broke: unoptimized={outs[False][:1]!r} "
                     f"optimized={outs[True][:1]!r}")
        return res

    # property 4: cold then warm under a fresh store (path="": never the
    # persisted file of SPARK_RAPIDS_TORCH_STATS_PATH)
    runs = []
    with stats_mod.scoped_store(stats_mod.StatsStore(capacity=32, path="")):
        for _ in range(2):
            run, r = _run(case, optimize=True, device=device)
            runs.append(_outcome(run))
            done += [r] if r is not None else []
    res.adaptive_parity = runs[0] == runs[1]
    if not res.adaptive_parity:
        res.error = (f"adaptive parity broke: cold={runs[0][:1]!r} "
                     f"warm={runs[1][:1]!r}")
        return res

    bad = _cert_soundness(case, done, bound)
    if bad is not None:
        res.cert_sound = False
        res.error = f"cert soundness broke: {bad}"
    return res


def run_corpus(seeds, *, execute: bool = True, max_ops: int = 8,
               verbose: bool = False, device=None) -> Dict:
    """gen_case + run_case over `seeds`: a summary with the failures per
    seed, the node kinds the corpus covered and the properties not
    checked."""
    results: List[FuzzResult] = []
    kinds = set()
    for seed in seeds:
        case = gen_case(seed, max_ops=max_ops, device=device)
        kinds.update(case.kinds)
        r = run_case(case, execute=execute, device=device)
        results.append(r)
        if verbose:
            status = "ok" if r.ok else f"FAIL ({r.error})"
            print(f"  seed {seed}: {len(case.plan.nodes)} nodes "
                  f"[{', '.join(case.kinds)}] -> {status}")
    failures = [r for r in results if not r.ok]
    return {
        "cases": len(results),
        "executed": sum(1 for r in results if r.executed),
        "kinds_covered": tuple(sorted(kinds)),
        "failures": [{"seed": r.seed, "error": r.error} for r in failures],
        "not_checked": dict(NOT_CHECKED),
    }


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="plan fuzzer: verify + optimize + eager parity over "
                    "seeded random DAGs")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=24)
    ap.add_argument("--max-ops", type=int, default=8)
    ap.add_argument("--no-exec", action="store_true",
                    help="verify and optimize only (no parity runs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    seeds = range(args.start, args.start + args.count)
    summary = run_corpus(seeds, execute=not args.no_exec,
                         max_ops=args.max_ops, verbose=args.verbose,
                         device=args.device)
    print(f"plan fuzz: {summary['cases']} case(s), "
          f"{summary['executed']} executed, kinds covered: "
          f"{', '.join(summary['kinds_covered'])}")
    for prop, item in NOT_CHECKED.items():
        print(f"  not checked: {prop} ({item})")
    print(json.dumps({"metric": "plan_fuzz", "device": args.device,
                      "fuzz_cases": summary["cases"],
                      "fuzz_executed": summary["executed"],
                      "fuzz_failures": len(summary["failures"]),
                      "fuzz_kinds": ",".join(summary["kinds_covered"])}))
    if summary["failures"]:
        for f in summary["failures"]:
            print(f"  FAIL seed {f['seed']}: {f['error']}")
        return 1
    print("plan fuzz OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
