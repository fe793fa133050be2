"""Plan executor, eager tier.

Counterpart of the eager tier of `spark_rapids_tpu/plan/executor.py`
(`_execute_eager`, `_exec_eager_node`, `_global_aggregate`): the DAG runs
operator by operator in toposort order through the port's `ops`, each
operator with its own wall time, rows and bytes. HashJoin consults the
kernel registry (`ops/registry.py`) with the executor's device type as the
backend and stamps the choice on its metrics: on "cuda" an inner join runs
`join_cuda.inner_join_hash`, a FusedSelect `select_cuda.fused_select` and a
TopK `topk_cuda.topk_table`. The plain versions run only on the CPU: where
the registry declines a call on the card (an inner join's build side over
the kernel's 2^22 rows, `join_cuda.MAX_BUILD`; a predicate over the
FusedSelect program's limits, a TopK tuple over 96 words, or a forced plain
kernel), the executor raises `KernelDeclinedError` and never gives way to
the plain version there.

`PlanExecutor(device=None)` runs on the CUDA card and raises when there is
none; `device="cpu"` runs on the CPU. The scan inputs move to the device
once, at `execute()`. With `block_per_op` each operator's wall time ends in
`torch.cuda.synchronize`, so it is the device time of that operator and not
its enqueue.

The rule-based optimizer (`plan/optimizer.py`) runs first, by default
(`optimize=None` reads SPARK_RAPIDS_TORCH_OPTIMIZER), once per (plan,
binding); `PlanResult.optimizer` holds its report. The capped tier,
streaming scans, placement, the stats store, the distributed tier and the
degraded CPU tier wait for later slices; a node kind this tier does not run
raises `PlanValidationError` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union as TUnion

import torch

from .. import config, dtypes
from .. import device as _device
from ..columnar import Column, Table
from ..ops import aggregate, copying, gather, join, select, sort, topk
from ..ops.aggregate import _agg_value_dtype
from ..ops.registry import REGISTRY, KernelDeclinedError
from .builder import Plan
from .expr import ColumnRef
from .metrics import OperatorMetrics, render_profile
from .nodes import (Filter, FusedSelect, HashAggregate, HashJoin, Limit,
                    PlanNode, PlanValidationError, Project, Scan, Sort, TopK)

_OPT_CACHE_SIZE = 64     # rewrites kept per executor, oldest dropped first

_NOT_PORTED = {
    "Union": "queue A item 3 (ops/copying.py concat_tables)",
    "Exchange": "queue A item 13 (distributed tier)",
}


class PlanResult:
    """Output of one plan execution: the executed `plan` (the optimized
    form when the optimizer ran; metric labels refer to its nodes), the
    result `table`, per-operator `metrics` (label -> OperatorMetrics), the
    plan's wall time and the optimizer's report (`optimizer`, None when it
    did not run)."""

    def __init__(self, plan: Plan, table: Table,
                 metrics: Dict[str, OperatorMetrics], wall_ms: float,
                 device: torch.device):
        self.plan = plan
        self.table = table
        self.metrics = metrics
        self.wall_ms = wall_ms
        self.device = device
        self.optimizer: Optional[Dict] = None

    def profile(self) -> List[Dict]:
        """Per-operator metric rows."""
        return [m.to_dict() for m in self.metrics.values()]

    def profile_text(self) -> str:
        return render_profile(list(self.metrics.values()),
                              plan_wall_ms=self.wall_ms,
                              device=str(self.device),
                              optimizer=self.optimizer)


class PlanExecutor:
    """Executes validated Plans on one device, eager tier only."""

    def __init__(self, mode: str = "eager",
                 device: Optional[TUnion[str, torch.device]] = None,
                 block_per_op: bool = True,
                 optimize: Optional[bool] = None):
        if mode != "eager":
            raise ValueError(f"executor mode {mode!r} is not ported; the "
                             "capped tier is ROADMAP.md queue A item 7")
        self.mode = mode
        self.device = _device.resolve(device)
        self.block_per_op = block_per_op
        self.optimize = (config.optimizer_enabled() if optimize is None
                         else bool(optimize))
        # (root, binding) -> (optimized plan, its schemas, report)
        self._opt_cache: Dict[Tuple, Tuple] = {}

    def execute(self, plan: Plan,
                inputs: Optional[Dict[str, Table]] = None) -> PlanResult:
        """Run `plan` over `inputs` ({scan source: Table})."""
        inputs = dict(inputs or {})
        missing = [s for s in plan.input_names if s not in inputs]
        if missing:
            raise PlanValidationError(f"unbound plan input(s) {missing}")
        bound = {name: tuple(t.names) for name, t in inputs.items()}
        # the authored plan validates against the bound tables before any
        # rewrite renames its nodes
        schemas = plan.resolve_schemas(bound)
        report = None
        if self.optimize:
            plan, schemas, report = self._optimized(plan, inputs, bound)
        for node in plan.nodes:
            if node.kind in _NOT_PORTED:
                raise PlanValidationError(
                    f"{node.label}: {node.kind} has no eager lowering in the "
                    f"PyTorch port yet; ROADMAP.md {_NOT_PORTED[node.kind]} "
                    "ports it")
        inputs = {s: inputs[s].to(self.device) for s in plan.input_names}
        res = self._execute_eager(plan, inputs, schemas)
        if report is not None:
            res.optimizer = report.to_dict()
        return res

    def _optimized(self, plan: Plan, inputs, bound):
        """The rewrite of `plan` for this binding, computed once per (plan,
        names, row counts, float flag): float columns anywhere in the
        inputs disable the row-reordering build_side rule, so the flag is
        part of the key."""
        from .optimizer import optimize as run_optimizer
        floats = any(c.dtype.is_floating for t in inputs.values()
                     for c in t.columns)
        rows = {n: t.num_rows for n, t in inputs.items()}
        key = (plan.root, tuple(sorted(bound.items())),
               tuple(sorted(rows.items())), floats)
        hit = self._opt_cache.get(key)
        if hit is None:
            opt, report = run_optimizer(plan, bound, rows,
                                        float_inputs=floats)
            hit = (opt, opt.resolve_schemas(bound), report)
            if len(self._opt_cache) >= _OPT_CACHE_SIZE:
                self._opt_cache.pop(next(iter(self._opt_cache)))
            self._opt_cache[key] = hit
        return hit

    def explain(self, plan: Plan, optimized: bool = False) -> str:
        """The authored tree; with `optimized=True`, the authored and the
        rewritten trees and the per-rule summary, from declared schemas
        and `est_rows` hints (no binding)."""
        if not optimized:
            return plan.explain()
        from .optimizer import explain_optimized
        return explain_optimized(plan)

    def _sync(self) -> None:
        if self.block_per_op and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _execute_eager(self, plan: Plan, inputs, schemas) -> PlanResult:
        self._sync()
        t_plan0 = time.perf_counter()
        results: Dict[int, Table] = {}
        metrics: Dict[str, OperatorMetrics] = {}
        for node in plan.nodes:
            childs = [results[id(c)] for c in node.children]
            m = OperatorMetrics(label=node.label, kind=node.kind,
                                describe=node.describe())
            t0 = time.perf_counter()
            out = self._exec_eager_node(node, childs, inputs, schemas, m)
            self._sync()
            m.wall_ms = (time.perf_counter() - t0) * 1e3
            m.rows_in = sum(t.num_rows for t in childs)
            m.rows_out = out.num_rows
            m.bytes_out = out.nbytes()
            metrics[node.label] = m
            results[id(node)] = out
        wall = (time.perf_counter() - t_plan0) * 1e3
        return PlanResult(plan, results[id(plan.root)], metrics, wall,
                          self.device)

    def _kernel_choice(self, op: str, sig, m: OperatorMetrics):
        """The registry's kernel for `op`, stamped on `m`; on the card a
        declined call raises (the plain versions run on the CPU only)."""
        choice = REGISTRY.select(op, sig, backend=self.device.type)
        m.kernel = choice.label
        if choice.fallback and self.device.type == "cuda":
            why = ", ".join(f"{k}: {r}" for k, r in choice.declined)
            raise KernelDeclinedError(
                f"{m.label}: no {op} kernel takes this call on the card "
                f"({why or 'the plain version was forced'})")
        return choice

    def _exec_eager_node(self, node: PlanNode, childs: List[Table], inputs,
                         schemas, m: OperatorMetrics) -> Table:
        if isinstance(node, Scan):
            t = inputs[node.source]
            if node.projection is not None:
                t = t.select(list(node.projection))   # pruned columns
            return t
        if isinstance(node, Filter):
            (t,) = childs
            return gather.apply_boolean_mask(t, node.predicate.evaluate(t))
        if isinstance(node, FusedSelect):
            # gather only the projection-referenced columns through the
            # predicate, then project
            (t,) = childs
            needed = select.needed_columns(t, node.exprs)
            choice = self._kernel_choice(
                "fused_select",
                select.make_signature(t, node.predicate, node.exprs,
                                      "eager"), m)
            if not choice.fallback:
                ft = choice.fn(t, node.predicate, needed)
            else:
                ft = select.fused_select_plain(t, node.predicate, needed)
            return self._project(ft, node)
        if isinstance(node, Project):
            (t,) = childs
            return self._project(t, node)
        if isinstance(node, HashJoin):
            lt, rt = childs
            lkeys = [lt[k] for k in node.left_keys]
            rkeys = [rt[k] for k in node.right_keys]
            from ..ops import join_cuda
            sig = join_cuda.make_signature(lkeys, rkeys, node.how, "eager")
            if node.how == "inner":
                choice = self._kernel_choice("hash_join", sig, m)
                if not choice.fallback:
                    lm, rm = choice.fn(lkeys, rkeys)
                else:
                    lm, rm = join.inner_join(lkeys, rkeys)
                return Table(
                    list(gather.take_table(lt, lm.data,
                                           _has_negative=False).columns) +
                    list(gather.take_table(rt, rm.data,
                                           _has_negative=False).columns),
                    names=list(lt.names) + list(rt.names))
            # semi and anti joins have no kernel, here or in the reference
            m.kernel = REGISTRY.select("hash_join", sig,
                                       backend=self.device.type).label
            keep = (join.left_semi_join(lkeys, rkeys)
                    if node.how == "left_semi"
                    else join.left_anti_join(lkeys, rkeys))
            return gather.take_table(lt, keep.data, _has_negative=False)
        if isinstance(node, HashAggregate):
            (t,) = childs
            if not node.keys:
                return self._global_aggregate(t, node)
            agg = aggregate.groupby_aggregate(
                t, list(node.keys), [(c, o) for c, o, _ in node.aggs])
            return Table(list(agg.columns), names=schemas[id(node)])
        if isinstance(node, Sort):
            (t,) = childs
            return sort.sort_table(t, key_names=list(node.keys),
                                   ascending=list(node.ascending))
        if isinstance(node, TopK):
            (t,) = childs
            choice = self._kernel_choice(
                "topk",
                topk.make_signature(t, node.keys, node.ascending, node.n,
                                    "eager"), m)
            if not choice.fallback:
                return choice.fn(t, list(node.keys), list(node.ascending),
                                 node.n)
            return topk.topk_plain(t, node.keys, node.ascending, node.n)
        if isinstance(node, Limit):
            (t,) = childs
            return copying.slice_table(t, 0, node.n)
        raise PlanValidationError(f"no eager lowering for {node.kind}")

    @staticmethod
    def _project(t: Table, node: Project) -> Table:
        cols = []
        for name, e in node.exprs:
            if isinstance(e, ColumnRef):
                cols.append(t[e.name])      # preserve dtype + validity
            else:
                v = e.evaluate(t)
                cols.append(Column(dtypes.from_torch(v.dtype),
                                   int(v.shape[0]), v))
        return Table(cols, names=[n for n, _ in node.exprs])

    @staticmethod
    def _global_aggregate(t: Table, node: HashAggregate) -> Table:
        """Keyless (one-row) aggregate: sum/min/max ignore nulls. Float
        sums, mins and maxes give the reference's bits: its summation
        order (`aggregate.blocked_sum`), -0.0 below 0.0 and the canonical
        NaN (`aggregate.float_extreme`)."""
        dev = t.device
        cols, names = [], []
        for c, op, out_name in node.aggs:
            if op == "size":
                dt, val = dtypes.INT64, torch.tensor(t.num_rows,
                                                     dtype=torch.int64,
                                                     device=dev)
            else:
                src = t[c]
                ok = src.validity
                if op == "count":
                    dt = dtypes.INT64
                    val = (ok.to(torch.int64).sum() if ok is not None else
                           torch.tensor(t.num_rows, dtype=torch.int64,
                                        device=dev))
                else:
                    dt = _agg_value_dtype(op, src.dtype)
                    acc = src.data.to(dt.storage_dtype())
                    if op == "sum":
                        if ok is not None:
                            acc = torch.where(ok, acc, torch.zeros_like(acc))
                        val = (aggregate.blocked_sum(acc)
                               if acc.is_floating_point() else
                               acc.sum(dtype=dt.storage_dtype()))
                    else:
                        if ok is not None:
                            acc = torch.where(ok, acc, torch.full_like(
                                acc, _reduce_identity(op, acc.dtype)))
                        # an empty relation raises, as in the reference
                        if acc.is_floating_point():
                            val = aggregate.float_extreme(op, acc)
                        else:
                            val = acc.min() if op == "min" else acc.max()
            cols.append(Column(dt, 1,
                               val.reshape(1).to(dt.storage_dtype())))
            names.append(out_name)
        return Table(cols, names=names)


def _reduce_identity(op: str, dt: torch.dtype):
    if dt.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dt)
    return info.min if op == "max" else info.max
