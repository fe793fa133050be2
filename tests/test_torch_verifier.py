"""The port's static plan verifier (spark_rapids_tpu_torch/analysis/
verifier.py) against the JAX package's, on the cases of
tests/test_plan_verifier.py: error vocabulary, typing, scan pruning,
partitioning, rewrite pairs and the optimizer's fall-back diagnostics.
Each plan is built once per package from the same description and goes
through both verifiers; the violations' invariant names must be equal
(and, where the reference test names one, be it). The executors' gates
(SPARK_RAPIDS_TPU_VERIFY_PLANS, SPARK_RAPIDS_TORCH_VERIFY_PLANS) raise on
the same plans.

The reference's `test_string_columns_pass_through_clean` runs here in
full: its typing half, and its execution half, a string column's grouped
min and count through both executors with their gates on.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import types

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.analysis import verify as jverify
from spark_rapids_tpu.analysis import verify_rewrite as jverify_rewrite
from spark_rapids_tpu.analysis import \
    PlanVerificationError as JPlanVerificationError
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu import plan as jplan
from spark_rapids_tpu.plan import optimizer as jopt
from spark_rapids_tpu.plan import nodes as jnodes

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch import plan as tplan
from spark_rapids_tpu_torch.analysis import (PlanVerificationError, verify,
                                             verify_rewrite)
from spark_rapids_tpu_torch.analysis import verifier as tverifier
from spark_rapids_tpu_torch.plan import PlanValidationError
from spark_rapids_tpu_torch.plan import nodes as tnodes
from spark_rapids_tpu_torch.plan import optimizer as topt
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield


@pytest.fixture(autouse=True)
def _gate_on(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "1")


def _ns(plan_mod, nodes_mod, verify_fn, rewrite_fn, opt_mod, dt_mod):
    return types.SimpleNamespace(
        Plan=plan_mod.Plan, PlanBuilder=plan_mod.PlanBuilder,
        col=plan_mod.col, lit=plan_mod.lit, Scan=nodes_mod.Scan,
        Filter=nodes_mod.Filter, Project=nodes_mod.Project,
        HashJoin=nodes_mod.HashJoin, HashAggregate=nodes_mod.HashAggregate,
        Union=nodes_mod.Union, Exchange=nodes_mod.Exchange,
        verify=verify_fn, verify_rewrite=rewrite_fn, opt=opt_mod,
        INT64=dt_mod.INT64, FLOAT64=dt_mod.FLOAT64)


JAX = _ns(jplan, jnodes, jverify, jverify_rewrite, jopt, jdt)
PORT = _ns(tplan, tnodes, verify, verify_rewrite, topt, tdt)
BOTH = (JAX, PORT)


def _invariants(report):
    return sorted(v.invariant for v in report.violations)


def _same(case):
    """Run `case(m)` -> VerifyReport in both packages; the invariant names
    must be equal. Returns them."""
    want, got = _invariants(case(JAX)), _invariants(case(PORT))
    assert got == want
    return got


def _tables(**cols):
    """{name: values} as a JAX table and a port table (CPU)."""
    arrays = {n: np.asarray(v) for n, v in cols.items()}
    for n, a in arrays.items():
        if a.dtype.kind == "i":
            arrays[n] = a.astype(np.int64)
    jt = JTable([JColumn.from_numpy(a) for a in arrays.values()],
                names=list(arrays))
    tt = table_from_numpy(
        list(arrays), list(arrays.values()), [None] * len(arrays),
        ["bool" if a.dtype == np.bool_ else a.dtype.name
         for a in arrays.values()], device="cpu")
    return jt, tt


def _executor(m):
    if m is JAX:
        return jplan.PlanExecutor()
    return tplan.PlanExecutor(device="cpu")


def _error_type(m):
    return JPlanVerificationError if m is JAX else PlanVerificationError


# ---- error vocabulary -------------------------------------------------------

class TestErrorVocabulary:
    def test_builder_raises_verification_error_with_invariant(self):
        for m in BOTH:
            with pytest.raises(_error_type(m)) as ei:
                (m.PlanBuilder().scan("t", schema=["a"])
                 .filter(m.col("nope") == 1).build())
            assert isinstance(ei.value, (PlanValidationError,
                                         jnodes.PlanValidationError))
            v = ei.value.violations[0]
            assert v.invariant.startswith("schema")
            assert v.node.startswith("Filter#")
            assert "nope" in v.message

    def test_bind_time_same_vocabulary(self):
        jt, tt = _tables(a=[1, 2])
        got = []
        for m, t in ((JAX, jt), (PORT, tt)):
            plan = m.PlanBuilder().scan("t").filter(m.col("nope") == 1).build()
            with pytest.raises(_error_type(m)) as ei:
                _executor(m).execute(plan, {"t": t})
            got.append(ei.value.violations[0].invariant)
        assert got[0] == got[1] and got[1].startswith("schema")


# ---- typing layer -----------------------------------------------------------

def _dt(m):
    return {"t": {"a": m.INT64, "f": m.FLOAT64}}


_TYPING = {
    "non_bool_predicate": (lambda m: m.col("a") + m.lit(1),
                           ["typing.predicate-not-bool"]),
    "bitwise_on_float": (lambda m: m.col("f") & m.col("a"),
                         ["typing.bitwise-on-float"]),
    "comparison_clean": (lambda m: m.col("f") > m.lit(0.5), []),
    "invert_on_float": (lambda m: ~(m.col("f") > 1.0) & ~m.col("f"),
                        ["typing.invert-on-float"]),
    "float_arith_not_bool": (lambda m: m.col("f") * m.lit(2),
                             ["typing.predicate-not-bool"]),
    "bool_ops_clean": (lambda m: (m.col("a") > 1) | ~(m.col("f") < 2.0), []),
}


class TestTyping:
    @pytest.mark.parametrize("case", sorted(_TYPING))
    def test_filter_predicates(self, case):
        pred, want = _TYPING[case]
        got = _same(lambda m: m.verify(
            m.Plan(m.Filter(m.Scan("t", ("a", "f")), pred(m))),
            bound={"t": ("a", "f")}, input_dtypes=_dt(m)))
        assert got == want

    def test_projection_types_flow_to_an_aggregate(self):
        """A computed projection types by promotion, and an aggregate of
        it is typed; a predicate over the projected bool stays clean."""
        def case(m):
            proj = m.Project(m.Scan("t", ("a", "f")),
                             (("x", m.col("a") * m.lit(3)),
                              ("y", m.col("f") > m.col("a"))))
            agg = m.HashAggregate(m.Filter(proj, m.col("y")), ("x",),
                                  (("x", "sum", "s"), ("x", "mean", "mu")))
            return m.verify(m.Plan(agg), bound={"t": ("a", "f")},
                            input_dtypes=_dt(m))
        assert _same(case) == []
        plan = tplan.Plan(tnodes.Project(
            tnodes.Scan("t", ("a", "f")),
            (("x", tplan.col("a") * tplan.lit(3)),
             ("y", tplan.col("f") > tplan.col("a")),
             ("z", tplan.col("a") + tplan.lit(0.5)))))
        types_ = tverifier.column_types(plan.nodes,
                                        plan.resolve_schemas(
                                            {"t": ("a", "f")}),
                                        _dt(PORT))
        assert types_[id(plan.root)] == {"x": tdt.INT64, "y": tdt.BOOL,
                                         "z": tdt.FLOAT64}

    def test_string_columns_pass_through_clean(self, monkeypatch):
        """Bare-ref projections and count/min aggregates of a string
        column are clean; summing its chars buffer is a definite error.
        The clean plan runs through both executors' gates to the same
        rows."""
        def case(m, agg):
            string = jdt.STRING if m is JAX else tdt.DType(tdt.Kind.STRING)
            b = m.PlanBuilder()
            plan = (b.scan("t", schema=["k", "s"]).select(["k", "s"])
                    .aggregate(["k"], agg).sort(["k"]).build())
            return m.verify(plan, bound={"t": ("k", "s")},
                            input_dtypes={"t": {"k": m.INT64, "s": string}})
        assert _same(lambda m: case(m, [("s", "min", "m"),
                                        ("s", "count", "c")])) == []
        assert _same(lambda m: case(m, [("s", "sum", "x")])) == [
            "typing.agg-over-non-scalar"]
        assert _same(lambda m: case(m, [("k", "sum", "x")])) == []
        monkeypatch.setenv("SPARK_RAPIDS_TPU_VERIFY_PLANS", "1")
        keys, vals = [1, 1, 2, 2, 3], ["bb", "aa", "cc", None, None]

        def run(mod, table):
            b = mod.PlanBuilder()
            plan = (b.scan("t", schema=["k", "s"]).select(["k", "s"])
                    .aggregate(["k"], [("s", "min", "m"),
                                       ("s", "count", "c")])
                    .sort(["k"]).build())
            return mod.PlanExecutor(mode="eager").execute(
                plan, {"t": table}).table.to_pydict()
        want = run(jplan, JTable([JColumn.from_pylist(keys, jdt.INT64),
                                  JColumn.from_pylist(vals, jdt.STRING)],
                                 names=["k", "s"]))
        from spark_rapids_tpu_torch.columnar import Column, Table
        got = run(types.SimpleNamespace(
            PlanBuilder=tplan.PlanBuilder,
            PlanExecutor=lambda mode: tplan.PlanExecutor(mode=mode,
                                                         device="cpu")),
            Table([Column.from_pylist(keys, tdt.INT64, device="cpu"),
                   Column.from_pylist(vals, tdt.STRING, device="cpu")],
                  ["k", "s"]))
        assert got == want == {"k": [1, 2, 3], "m": ["aa", "cc", None],
                               "c": [2, 1, 0]}

    def test_mixed_bool_int_types_exactly_where_the_reference_says_unknown(
            self):
        """A deviation the port keeps (ROADMAP queue C): the port types
        `bool + int` by `plan/expr.py`'s promotion (INT64), so a Filter on
        it is a definite non-bool predicate; the reference types the mix
        as unknown and lets it through."""
        def plan(m):
            return m.Plan(m.Filter(m.Scan("t", ("b",)),
                                   m.col("b") + m.lit(1)))
        got = [_invariants(m.verify(plan(m), bound={"t": ("b",)},
                                    input_dtypes={"t": {"b": dt}}))
               for m, dt in ((JAX, jdt.BOOL), (PORT, tdt.BOOL))]
        assert got == [[], ["typing.predicate-not-bool"]]

    def test_decimal128_columns_are_not_expression_addressable(self):
        def case(m):
            d = (jdt.decimal(38, 2) if m is JAX else tdt.decimal(38, 2))
            plan = m.Plan(m.Filter(m.Scan("t", ("a", "d")),
                                   m.col("d") > m.lit(1)))
            return m.verify(plan, bound={"t": ("a", "d")},
                            input_dtypes={"t": {"a": m.INT64, "d": d}})
        assert _same(case) == ["typing.column-not-expr-addressable"]


# ---- scan-pruning legality --------------------------------------------------

def _shared_scan(m):
    scan = m.Scan("t", ("a", "v"), predicate=m.col("a") > m.lit(1))
    return m.Plan(m.Union((m.Filter(scan, m.col("a") > m.lit(1)),
                           m.Filter(scan, m.col("v") > m.lit(0)))))


class TestScanPruning:
    def test_shared_scan_with_predicate_rejected(self):
        assert _same(lambda m: m.verify(_shared_scan(m),
                                        bound={"t": ("a", "v")})) == [
            "pruning.shared-scan"]

    def test_unenforced_predicate_rejected(self):
        def case(m):
            scan = m.Scan("t", ("a", "v"), predicate=m.col("a") > m.lit(1))
            return m.verify(m.Plan(m.Project(scan, (("a", m.col("a")),))),
                            bound={"t": ("a", "v")})
        assert _same(case) == ["pruning.unenforced-predicate"]

    def test_unretained_conjunct_rejected(self):
        def case(m):
            scan = m.Scan("t", ("a", "v"), predicate=m.col("a") > m.lit(5))
            return m.verify(m.Plan(m.Filter(scan, m.col("a") > m.lit(1))),
                            bound={"t": ("a", "v")})
        assert _same(case) == ["pruning.unretained-conjunct"]

    def test_unprovable_conjunct_rejected(self):
        def case(m):
            scan = m.Scan("t", ("a", "v"),
                          predicate=(m.col("a") > m.lit(1))
                          | (m.col("v") < m.lit(0)))
            return m.verify(m.Plan(m.Filter(scan, m.col("a") > m.lit(1))),
                            bound={"t": ("a", "v")})
        assert _same(case) == ["pruning.unprovable-conjunct"]

    def test_lowered_conjunct_subset_clean(self):
        def case(m):
            pred = (m.col("a") > m.lit(1)) & (m.col("v") > m.col("a"))
            scan = m.Scan("t", ("a", "v"),
                          predicate=m.lit(1) < m.col("a"))
            return m.verify(m.Plan(m.Filter(scan, pred)),
                            bound={"t": ("a", "v")})
        assert _same(case) == []

    def test_gate_rejects_at_execute(self):
        jt, tt = _tables(a=[1, 2], v=[3, 4])
        for m, t in ((JAX, jt), (PORT, tt)):
            with pytest.raises(_error_type(m), match="shared-scan"):
                _executor(m).execute(_shared_scan(m), {"t": t})

    def test_gate_is_off_by_default_in_the_port(self, monkeypatch):
        """Without SPARK_RAPIDS_TORCH_VERIFY_PLANS the port runs the plan
        (the pruning predicate is a hint it does not read yet); a typo in
        the switch raises."""
        _, tt = _tables(a=[1, 2], v=[3, 4])
        monkeypatch.delenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS")
        res = tplan.PlanExecutor(device="cpu").execute(_shared_scan(PORT),
                                                       {"t": tt})
        assert res.table.to_pydict() == {"a": [2, 1, 2], "v": [4, 3, 4]}
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "yes")
        with pytest.raises(ValueError, match="VERIFY_PLANS"):
            tplan.PlanExecutor(device="cpu").execute(_shared_scan(PORT),
                                                     {"t": tt})


# ---- partitioning soundness -------------------------------------------------

BOUND = {"t": ("a", "b", "v"), "l": ("a", "v"), "r": ("b", "w")}


def _stacked_aggs(m, inner_keys, outer_keys, outer_agg):
    scan = m.Scan("t", ("a", "b", "v"))
    ex = m.Exchange(scan, ("a",), how="hash")
    agg1 = m.HashAggregate(ex, inner_keys, (("v", "sum", "s"),))
    agg2 = m.HashAggregate(agg1, outer_keys, (outer_agg,))
    return m.Plan(m.Exchange(agg2, (), how="gather")), agg2


def _shuffle_join(m, left_ex, right_ex, gather=True):
    l = m.Scan("l", ("a", "v"))
    r = m.Scan("r", ("b", "w"))
    if left_ex:
        l = m.Exchange(l, ("a",), how="hash")
    if right_ex == "hash":
        r = m.Exchange(r, ("b",), how="hash")
    elif right_ex == "broadcast":
        r = m.Exchange(r, (), how="broadcast")
    join = m.HashJoin(l, r, ("a",), ("b",))
    return m.Plan(m.Exchange(join, (), how="gather") if gather else join)


class TestPartitioning:
    def test_stale_partitioning_claim_rejected(self):
        names = {}

        def case(m):
            plan, agg2 = _stacked_aggs(m, ("a",), ("s",),
                                       ("a", "count", "c"))
            rep = m.verify(plan, bound=BOUND, planned=True)
            bad = [v for v in rep.violations
                   if v.invariant == "partitioning.agg-not-colocated"]
            names[m is PORT] = bad[0].node == agg2.label
            return rep
        assert "partitioning.agg-not-colocated" in _same(case)
        assert names == {False: True, True: True}

    def test_justified_elision_clean(self):
        assert _same(lambda m: m.verify(
            _stacked_aggs(m, ("a", "b"), ("a",), ("s", "sum", "s2"))[0],
            bound=BOUND, planned=True)) == []

    @pytest.mark.parametrize("left_ex,right_ex,gather,want", [
        (True, None, True, ["partitioning.join-not-colocated"]),
        (True, "hash", True, []),
        (False, "broadcast", True, []),
        (True, "hash", False, ["partitioning.unsunk-root"]),
    ])
    def test_shuffle_joins(self, left_ex, right_ex, gather, want):
        assert _same(lambda m: m.verify(
            _shuffle_join(m, left_ex, right_ex, gather), bound=BOUND,
            planned=True)) == want

    def test_double_gather_rejected(self):
        def case(m):
            g1 = m.Exchange(m.Scan("l", ("a", "v")), (), how="gather")
            return m.verify(m.Plan(m.Exchange(g1, (), how="gather")),
                            bound=BOUND, planned=True)
        assert "partitioning.redundant-gather" in _same(case)

    def test_broadcast_probe_and_ungathered_input_rejected(self):
        def case(m):
            l = m.Exchange(m.Scan("l", ("a", "v")), (), how="broadcast")
            r = m.Exchange(m.Scan("r", ("b", "w")), (), how="broadcast")
            join = m.HashJoin(l, r, ("a",), ("b",))
            agg = m.HashAggregate(join, (), (("v", "sum", "s"),))
            return m.verify(m.Plan(agg), bound=BOUND, planned=True)
        assert _same(case) == ["partitioning.broadcast-probe",
                               "partitioning.ungathered-input"]

    def test_exchange_planner_output_verifies(self):
        """The reference's exchange_planning output (the port plans no
        exchanges before ROADMAP queue A item 13), rebuilt node by node in
        the port, passes the port's partitioning layer too: both derive
        claims from the same transfer rules."""
        b = jplan.PlanBuilder()
        plan = (b.scan("l", schema=["a", "v"], est_rows=100_000)
                 .join(b.scan("r", schema=["b", "w"], est_rows=90_000),
                       left_on="a", right_on="b")
                 .aggregate(["a"], [("v", "sum", "s")]).build())
        bound = {"l": ("a", "v"), "r": ("b", "w")}
        opt, report = jopt.optimize(plan, bound,
                                    {"l": 100_000, "r": 90_000},
                                    mesh_peers=4)
        assert report.rules["exchange_planning"] > 0
        assert jverify(opt, bound=bound, planned=True).ok
        ported = tplan.Plan(_to_port(opt.root, {}))
        assert ported.fingerprint == opt.fingerprint
        rep = verify(ported, bound=bound, planned=True)
        assert rep.ok, rep.violations
        # and the plan without its sink gather is flagged in both
        unsunk_j = jplan.Plan(opt.root.child)
        unsunk_t = tplan.Plan(ported.root.child)
        assert (_invariants(jverify(unsunk_j, bound=bound, planned=True))
                == _invariants(verify(unsunk_t, bound=bound, planned=True))
                == ["partitioning.unsunk-root"])


def _to_port(node, memo):
    """A JAX-package plan node rebuilt as the port's (the same fields)."""
    import dataclasses
    from spark_rapids_tpu.plan import expr as jexpr
    from spark_rapids_tpu_torch.plan import expr as texpr
    if id(node) in memo:
        return memo[id(node)]

    def conv(v):
        if isinstance(v, jnodes.PlanNode):
            return _to_port(v, memo)
        if isinstance(v, jexpr.Expr):
            return _expr_to_port(v, jexpr, texpr)
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    cls = getattr(tnodes, type(node).__name__)
    kw = {f.name: conv(getattr(node, f.name))
          for f in dataclasses.fields(node) if f.init}
    kw = {k: v for k, v in kw.items()
          if k in {f.name for f in dataclasses.fields(cls)}}
    memo[id(node)] = out = cls(**kw)
    return out


def _expr_to_port(e, jexpr, texpr):
    if isinstance(e, jexpr.ColumnRef):
        return texpr.ColumnRef(e.name)
    if isinstance(e, jexpr.Literal):
        return texpr.Literal(e.value)
    if isinstance(e, jexpr.BinOp):
        return texpr.BinOp(e.op, _expr_to_port(e.left, jexpr, texpr),
                           _expr_to_port(e.right, jexpr, texpr))
    if isinstance(e, jexpr.UnaryOp):
        return texpr.UnaryOp(e.op, _expr_to_port(e.child, jexpr, texpr))
    return texpr.ScalarAgg(e.op, _expr_to_port(e.child, jexpr, texpr))


# ---- rewrite-pair checks ----------------------------------------------------

def _swap_shape(m, with_agg: bool):
    l = m.Scan("l", ("a", "v"))
    r = m.Scan("r", ("b", "w"))
    authored_join = m.HashJoin(l, r, ("a",), ("b",))
    authored_root = (m.HashAggregate(authored_join, ("a",),
                                     (("v", "sum", "s"),))
                     if with_agg else authored_join)
    swapped = m.HashJoin(r, l, ("b",), ("a",))
    restore = m.Project(swapped,
                        tuple((n, m.col(n)) for n in ("a", "v", "b", "w")))
    opt_root = (m.HashAggregate(restore, ("a",), (("v", "sum", "s"),))
                if with_agg else restore)
    return m.Plan(authored_root), m.Plan(opt_root)


class TestRewrite:
    @pytest.mark.parametrize("with_agg,floats,want", [
        (True, True, ["rewrite.fp-build-side"]),
        (True, False, []),
        (False, False, ["rewrite.order-unsafe-swap"]),
    ])
    def test_build_side_swaps(self, with_agg, floats, want):
        assert _same(lambda m: m.verify_rewrite(
            *_swap_shape(m, with_agg), bound=BOUND,
            float_inputs=floats)) == want

    def test_swap_detected_despite_reversed_pair_aliasing(self):
        def plans(m):
            s1, s2 = m.Scan("s1", ("a", "p")), m.Scan("s2", ("b", "q"))
            s3, s4 = m.Scan("s3", ("b", "r")), m.Scan("s4", ("a", "t"))
            j1 = m.HashJoin(s1, s2, ("a",), ("b",))
            j2 = m.HashJoin(s3, s4, ("b",), ("a",))
            semi = m.HashJoin(j1, j2, ("a",), ("a",), how="left_semi")
            authored = m.Plan(m.HashAggregate(semi, ("a",),
                                              (("p", "sum", "s"),)))
            j1s = m.Project(m.HashJoin(s2, s1, ("b",), ("a",)),
                            tuple((n, m.col(n))
                                  for n in ("a", "p", "b", "q")))
            semi2 = m.HashJoin(j1s, j2, ("a",), ("a",), how="left_semi")
            optimized = m.Plan(m.HashAggregate(semi2, ("a",),
                                               (("p", "sum", "s"),)))
            return authored, optimized
        assert _same(lambda m: m.verify_rewrite(
            *plans(m), float_inputs=True)) == ["rewrite.fp-build-side"]
        assert _same(lambda m: m.verify_rewrite(
            plans(m)[0], plans(m)[0], float_inputs=True)) == []

    def test_schema_drift_rejected(self):
        def case(m):
            authored = m.PlanBuilder().scan("l", schema=["a", "v"]).build()
            optimized = (m.PlanBuilder().scan("l", schema=["a", "v"])
                         .select(["a"]).build())
            return m.verify_rewrite(authored, optimized,
                                    bound={"l": ("a", "v")})
        assert _same(case) == ["rewrite.schema-drift"]

    def test_optimizer_swap_passes_and_names_its_source(self):
        """A real build_side swap on integer inputs under an aggregate
        passes verify_rewrite in both; forced as if over floats, it is
        flagged with the swap's decision source in the message."""
        msgs = []

        def case(m):
            b = m.PlanBuilder()
            plan = (b.scan("l", schema=["a", "v"], est_rows=10)
                    .join(b.scan("r", schema=["b", "w"], est_rows=1000),
                          left_on="a", right_on="b")
                    .aggregate(["a"], [("v", "sum", "s")]).build())
            opt, report = m.opt.optimize(plan, None, None)
            assert report.rules["build_side"] == 1
            assert m.verify_rewrite(plan, opt, report=report).ok
            rep = m.verify_rewrite(plan, opt, report=report,
                                   float_inputs=True)
            msgs.append(rep.violations[0].message.split(": ", 1)[1])
            return rep
        assert _same(case) == ["rewrite.fp-build-side"]
        assert msgs[0] == msgs[1] and "decision source: swap" in msgs[1]


# ---- optimizer fall-back: the rule, node and invariant --------------------

def _patch_bad_rule(monkeypatch, m, victim="select_fusion"):
    def bad_rule(root, ctx):
        return m.Filter(root, m.col("__nope__") == m.lit(1)), 1
    patched = tuple((n, bad_rule) if n == victim else (n, r)
                    for n, r in m.opt._RULES)
    monkeypatch.setattr(m.opt, "_RULES", patched)


class TestFallbackDiagnostics:
    @pytest.mark.parametrize("verify_rules", [False, True])
    def test_fallback_names_rule_node_invariant(self, monkeypatch,
                                                verify_rules):
        got = []
        for m in BOTH:
            _patch_bad_rule(monkeypatch, m)
            plan = (m.PlanBuilder().scan("t", schema=["a", "v"])
                    .filter(m.col("a") > 1).build())
            opt, report = m.opt.optimize(plan, {"t": ("a", "v")}, {"t": 8},
                                         verify_rules=verify_rules)
            assert report.fell_back and opt is plan
            fb = report.fallback
            assert fb == report.to_dict()["fallback"]
            assert "select_fusion" in report.summary()
            assert "__nope__" in fb["message"]
            got.append((fb["rule"], fb["invariant"], fb["node"][:7]))
        assert got[0] == got[1] == ("select_fusion", "schema", "Filter#")

    @pytest.mark.parametrize("verify_rules", [False, True])
    def test_attribution_uses_bound_schemas(self, monkeypatch, verify_rules):
        for m in BOTH:
            _patch_bad_rule(monkeypatch, m, "constant_folding")
            plan = m.PlanBuilder().scan("t").filter(m.col("a") > 1).build()
            opt, report = m.opt.optimize(plan, {"t": ("a", "v")}, {"t": 8},
                                         verify_rules=verify_rules)
            assert report.fell_back and opt is plan
            assert report.fallback["rule"] == "constant_folding"
            assert "__nope__" in report.fallback["message"]

    def test_clean_optimize_has_no_fallback(self):
        for m in BOTH:
            plan = (m.PlanBuilder().scan("t", schema=["a", "v"])
                    .filter(m.col("a") > 1).select(["a"]).build())
            _, report = m.opt.optimize(plan, {"t": ("a", "v")}, {"t": 8},
                                       verify_rules=True)
            assert not report.fell_back and report.fallback is None

    def test_executed_result_surfaces_fallback(self, monkeypatch):
        jt, tt = _tables(a=[1, 2, 3], v=[4, 5, 6])
        for m, t in ((JAX, jt), (PORT, tt)):
            _patch_bad_rule(monkeypatch, m)
            plan = (m.PlanBuilder().scan("t", schema=["a", "v"])
                    .filter(m.col("a") > 1).build())
            res = _executor(m).execute(plan, {"t": t})
            assert res.optimizer["fell_back"]
            assert res.optimizer["fallback"]["rule"] == "select_fusion"
            assert res.table.to_pydict()["a"] == [2, 3]


# ---- the executor's gate ------------------------------------------------------

class TestGate:
    def test_gate_raises_before_execution_on_the_same_plans(self):
        """A non-bool Filter predicate: both gates raise the typing
        violation before any operator runs."""
        jt, tt = _tables(a=[1, 2, 3], f=[0.5, 1.5, 2.5])
        got = []
        for m, t in ((JAX, jt), (PORT, tt)):
            plan = m.Plan(m.Filter(m.Scan("t", ("a", "f")),
                                   m.col("a") + m.lit(1)))
            with pytest.raises(_error_type(m), match="pre-execution") as ei:
                _executor(m).execute(plan, {"t": t})
            got.append([v.invariant for v in ei.value.violations])
        assert got[0] == got[1] == ["typing.predicate-not-bool"]

    def test_verdicts_are_memoized_per_plan_and_binding(self, monkeypatch):
        _, tt = _tables(a=[1, 2, 3], f=[0.5, 1.5, 2.5])
        plan = (tplan.PlanBuilder().scan("t", schema=["a", "f"])
                .filter(tplan.col("a") > 1).build())
        ex = tplan.PlanExecutor(device="cpu")
        calls = []
        real = tverifier.verify_rewrite
        monkeypatch.setattr(tverifier, "verify_rewrite",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        for _ in range(3):
            assert ex.execute(plan, {"t": tt}).table.num_rows == 2
        assert len(calls) == 1
