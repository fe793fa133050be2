"""Plan executor: the eager and the capped tier.

Counterpart of `spark_rapids_tpu/plan/executor.py`.

- `mode="eager"` (`_execute_eager`, `_exec_eager_node`,
  `_global_aggregate`): the DAG runs operator by operator in toposort
  order through the port's `ops`, each operator with its own wall time,
  rows and bytes. With `block_per_op` each operator's wall time ends in
  `torch.cuda.synchronize`, so it is the device time of that operator and
  not its enqueue.
- `mode="capped"` (`_execute_capped`, `_run_capped`, `_exec_capped_node`):
  the whole DAG runs with static capacities and no host read inside an
  attempt. Every relation is a padded frame and an alive mask
  (`_CappedRel`); a filter is a mask AND, a semi or anti join a mask, an
  inner join and a keyed aggregate write into `row_cap`/`key_cap` slots
  and return an overflow flag instead of a size (an inner join with a
  zero-row side, which the host knows from the shapes, `row_cap` dead
  slots of `copying.dead_column`). The flags OR into one,
  which `parallel.autoretry.auto_retry_overflow` reads once per attempt
  (the attempt's one host read), growing every cap x2 while it is set,
  at most `max_cap_attempts` times. The per-operator live-row counts are
  counted on the device and read once, after the last attempt.
  `PlanResult.table` is then padded and `valid` marks its live rows;
  `compact()` gathers them. Caps start at the largest input's rows (or a
  node's own `row_cap`/`key_cap`), floored by the caps memo, which keeps
  the grown caps per plan fingerprint. The program cache, keyed as the
  reference's `_jitted_capped` (fingerprint, caps, input names and shapes,
  device type and kernel overrides), holds each program's lowering: the
  kernel chosen per node and the bytes of its padded output.

HashJoin, FusedSelect and TopK consult the kernel registry
(`ops/registry.py`) with the executor's device type as the backend and
stamp the choice on the metrics: on "cuda" an inner join runs
`join_cuda.inner_join_hash` (capped: `inner_join_capped_hash`), a semi or
anti join `join_cuda.left_semi_join_hash` / `left_anti_join_hash` (capped:
`semi_join_mask_hash`), a FusedSelect `select_cuda.fused_select` and a
TopK `topk_cuda.topk_table` (capped: `topk_capped`). The plain versions
run only on the CPU: where the registry declines a join or a TopK on the
card (a build side over the kernel's 2^22 rows, `join_cuda.MAX_BUILD`; a TopK
tuple over 96 words, or a forced plain kernel), and in the eager tier a
FusedSelect (a predicate over the program's limits), the executor raises
`KernelDeclinedError` and never gives way to the plain version there. In
the capped tier a FusedSelect is a mask, not a compaction: the registry is
consulted only to stamp its decline, and the predicate is evaluated as a
Filter's. Keys of every orderable kind run in the eager tier, STRING and
DECIMAL128 included; in the capped tier a STRING key raises TypeError
before any kernel is chosen (`_check_capped_keys`), as the reference's
capped tier cannot order strings either.

`PlanExecutor(device=None)` runs on the CUDA card and raises when there is
none; `device="cpu"` runs on the CPU. The scan inputs move to the device
once, at `execute()`.

The rule-based optimizer (`plan/optimizer.py`) runs first, by default
(`optimize=None` reads SPARK_RAPIDS_TORCH_OPTIMIZER), once per (plan,
binding); `PlanResult.optimizer` holds its report. With
SPARK_RAPIDS_TORCH_VERIFY_PLANS on, the optimizer re-validates every
rule's output and `_verify_execution` runs the static verifier
(`analysis/verifier.py`) on the plan about to run, as the reference's
gate does. Every node kind runs in both tiers; an `Exchange` returns its
child, as the reference's does on one device. Streaming scans,
placement, the stats store and its cap seeding, the resource certifier's
caps, the health breaker, fault injection, the mesh lowering and the
degraded CPU tier wait for later slices.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union as TUnion

import torch

from .. import config, dtypes
from .. import device as _device
from ..columnar import Column, Table
from ..ops import (aggregate, copying, gather, groupby_cuda, join, select,
                   sort, topk)
from ..ops.aggregate import _agg_value_dtype
from ..ops.registry import REGISTRY, KernelDeclinedError
from ..parallel.autoretry import auto_retry_overflow
from .builder import Plan
from .expr import ColumnRef, _reduce_identity
from .metrics import OperatorMetrics, render_profile
from .nodes import (Exchange, Filter, FusedSelect, HashAggregate, HashJoin,
                    Limit, PlanNode, PlanValidationError, Project, Scan, Sort,
                    TopK, Union)

_OPT_CACHE_SIZE = 64     # rewrites kept per executor, oldest dropped first
_PROGRAM_CACHE_SIZE = 64     # capped programs kept per executor
_CAPS_MEMO_SIZE = 256        # plans whose grown caps are kept

def _check_capped_keys(cols) -> None:
    """A STRING key raises TypeError in the capped tier before any kernel
    is chosen: its operands need the longest string, a host read, which
    the reference's capped tier cannot make either (its
    `Column.max_string_length` calls int() under jit)."""
    for c in cols:
        if c.dtype.is_string:
            raise TypeError(
                f"{c.dtype!r} keys do not run in the capped tier: their "
                "sort words need the longest string, a host read (the "
                "reference's Column.max_string_length under jit)")


def _bounded_put(cache: Dict, key, value, size: int) -> None:
    """cache[key] = value, dropping the oldest entry past `size`."""
    if key not in cache and len(cache) >= size:
        cache.pop(next(iter(cache)))
    cache[key] = value


class PlanResult:
    """Output of one plan execution: the executed `plan` (the optimized
    form when the optimizer ran; metric labels refer to its nodes), the
    result `table`, per-operator `metrics` (label -> OperatorMetrics), the
    plan's wall time and the optimizer's report (`optimizer`, None when it
    did not run).

    In the capped tier `table` is padded and `valid` marks its live rows
    (`compact()` gathers them); `attempts` counts the cap-escalation
    attempts, `caps` holds the final (possibly grown) capacities and
    `jit_cache_hits` the program-cache reuses of this execute."""

    def __init__(self, plan: Plan, table: Table,
                 metrics: Dict[str, OperatorMetrics], wall_ms: float,
                 device: torch.device, valid: Optional[torch.Tensor] = None,
                 mode: str = "eager", attempts: int = 1,
                 caps: Optional[Dict[str, int]] = None,
                 jit_cache_hits: int = 0):
        self.plan = plan
        self.table = table
        self.valid = valid
        self.metrics = metrics
        self.mode = mode
        self.wall_ms = wall_ms
        self.device = device
        self.attempts = attempts
        self.caps = caps
        self.jit_cache_hits = jit_cache_hits
        self.optimizer: Optional[Dict] = None

    def compact(self) -> Table:
        """The live rows only (the table itself in the eager tier). Reads
        the mask from the device."""
        if self.valid is None:
            return self.table
        idx = torch.nonzero(self.valid).reshape(-1)
        return gather.take_table(self.table, idx, _has_negative=False)

    def profile(self) -> List[Dict]:
        """Per-operator metric rows."""
        return [m.to_dict() for m in self.metrics.values()]

    def profile_text(self) -> str:
        return render_profile(list(self.metrics.values()),
                              plan_wall_ms=self.wall_ms,
                              device=str(self.device),
                              optimizer=self.optimizer,
                              attempts=self.attempts, caps=self.caps,
                              jit_cache_hits=self.jit_cache_hits)


class _CappedRel:
    """A relation inside a capped run: a padded table and its live-row
    mask."""

    __slots__ = ("table", "alive")

    def __init__(self, table: Table, alive: torch.Tensor):
        self.table = table
        self.alive = alive


class _CappedProgram:
    """The lowering of one capped program, filled at its first run and
    reused by every run that hits the program cache: the kernel choice per
    node (toposort index -> KernelChoice) and the bytes of each node's
    padded output."""

    __slots__ = ("kernels", "bytes_out")

    def __init__(self):
        self.kernels: Dict[int, object] = {}
        self.bytes_out: Dict[int, int] = {}


class PlanExecutor:
    """Executes validated Plans on one device, in the eager or the capped
    tier. `caps` ({"row_cap": r, "key_cap": k}) are the capped tier's
    starting capacities, else the largest input's rows; `max_cap_attempts`
    bounds its escalation."""

    def __init__(self, mode: str = "eager",
                 device: Optional[TUnion[str, torch.device]] = None,
                 block_per_op: bool = True,
                 optimize: Optional[bool] = None,
                 caps: Optional[Dict[str, int]] = None,
                 max_cap_attempts: int = 6):
        if mode not in ("eager", "capped"):
            raise ValueError(f"unknown executor mode {mode!r}")
        self.mode = mode
        self.device = _device.resolve(device)
        self.block_per_op = block_per_op
        self.optimize = (config.optimizer_enabled() if optimize is None
                         else bool(optimize))
        self.caps = dict(caps or {})
        self.max_cap_attempts = max_cap_attempts
        # (root, binding) -> (optimized plan, its schemas, report)
        self._opt_cache: Dict[Tuple, Tuple] = {}
        # program key -> _CappedProgram (the key of `_capped_program`)
        self._programs: Dict[Tuple, _CappedProgram] = {}
        # plan fingerprint -> the caps its last run ended with, so the next
        # run of an equal plan starts from the grown caps
        self._caps_memo: Dict[str, Dict[str, int]] = {}
        # the pre-execution gate's passed verdicts (`_verify_execution`)
        self._verify_cache: Dict[Tuple, bool] = {}

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
        authored = plan
        if self.optimize:
            plan, schemas, report = self._optimized(plan, inputs, bound)
        if config.verify_plans():
            self._verify_execution(authored, plan, report, inputs, bound)
        inputs = {s: inputs[s].to(self.device) for s in plan.input_names}
        if self.mode == "capped":
            res = self._execute_capped(plan, inputs, schemas)
        else:
            res = self._execute_eager(plan, inputs, schemas)
        if report is not None:
            res.optimizer = report.to_dict()
        return res

    def _verify_execution(self, authored: Plan, plan: Plan, report,
                          inputs, bound) -> None:
        """The pre-execution gate (SPARK_RAPIDS_TORCH_VERIFY_PLANS): the
        plan about to run passes the static verifier, schema and typing
        layers, and the rewrite pair's checks when the optimizer ran.
        Raises PlanVerificationError naming the invariant and operator.
        Verdicts are kept per (plan, binding), as the reference keeps
        them, so a repeat execution pays nothing."""
        from ..analysis import verifier
        input_dtypes = {
            name: {cn: c.dtype for cn, c in zip(t.names, t.columns)}
            for name, t in inputs.items()}
        floats = _input_has_floats(inputs)
        key = (authored.root, plan.root, tuple(sorted(bound.items())),
               tuple((n, tuple(repr(d) for d in cols.values()))
                     for n, cols in sorted(input_dtypes.items())),
               floats,
               None if report is None else (report.fingerprint,
                                            report.fell_back))
        if self._verify_cache.get(key):
            return
        # no executor of the port plans exchanges before ROADMAP queue A
        # item 13, so the partitioning layer (`planned=True`) is not run
        if report is None and plan is authored:
            rep = verifier.verify(plan, bound=bound,
                                  input_dtypes=input_dtypes,
                                  float_inputs=floats)
        else:
            rep = verifier.verify_rewrite(authored, plan, bound=bound,
                                          input_dtypes=input_dtypes,
                                          float_inputs=floats, report=report)
        rep.raise_if_failed("pre-execution gate")
        _bounded_put(self._verify_cache, key, True, _OPT_CACHE_SIZE)

    def _optimized(self, plan: Plan, inputs, bound):
        """The rewrite of `plan` for this binding, computed once per (plan,
        names, row counts, float flag, verify mode): float columns anywhere
        in the inputs disable the row-reordering build_side rule, and the
        verify mode (`config.verify_plans`, which re-validates every
        rule's output) changes which plan survives an invalid rewrite, so
        both are part of the key."""
        from .optimizer import optimize as run_optimizer
        floats = _input_has_floats(inputs)
        rows = {n: t.num_rows for n, t in inputs.items()}
        verify_rules = config.verify_plans()
        key = (plan.root, tuple(sorted(bound.items())),
               tuple(sorted(rows.items())), floats, verify_rules)
        hit = self._opt_cache.get(key)
        if hit is None:
            opt, report = run_optimizer(plan, bound, rows,
                                        float_inputs=floats,
                                        verify_rules=verify_rules)
            hit = (opt, opt.resolve_schemas(bound), report)
            _bounded_put(self._opt_cache, key, hit, _OPT_CACHE_SIZE)
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

    def _kernel_choice(self, op: str, sig, label: str):
        """The registry's kernel for `op`; on the card a declined call
        raises (the plain versions run on the CPU only)."""
        choice = REGISTRY.select(op, sig, backend=self.device.type)
        if choice.fallback and self.device.type == "cuda":
            why = ", ".join(f"{k}: {r}" for k, r in choice.declined)
            raise KernelDeclinedError(
                f"{label}: no {op} kernel takes this call on the card "
                f"({why or 'the plain version was forced'})")
        return choice

    def _stamp(self, op: str, sig):
        """The registry's choice for a call that runs no kernel of `op`
        (the capped tier's FusedSelect), to stamp on the metrics; never
        raised."""
        return REGISTRY.select(op, sig, backend=self.device.type)

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
                                      "eager"), m.label)
            m.kernel = choice.label
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
            from ..ops import join_cuda
            # mismatched key dtypes raise as the sort-based join raises,
            # before a kernel is chosen
            lkeys, rkeys = join_cuda.join_keys(
                [lt[k] for k in node.left_keys],
                [rt[k] for k in node.right_keys])
            sig = join_cuda.make_signature(lkeys, rkeys, node.how, "eager")
            choice = self._kernel_choice("hash_join", sig, m.label)
            m.kernel = choice.label
            if node.how == "inner":
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
            # semi and anti joins: the build and the existence probe on the
            # card (the reference has no kernel for them), the sort-based
            # join on the CPU
            semi = node.how == "left_semi"
            if not choice.fallback:
                keep = (join_cuda.left_semi_join_hash if semi
                        else join_cuda.left_anti_join_hash)(lkeys, rkeys)
            else:
                keep = (join.left_semi_join if semi
                        else join.left_anti_join)(lkeys, rkeys)
            return gather.take_table(lt, keep.data, _has_negative=False)
        if isinstance(node, HashAggregate):
            (t,) = childs
            if not node.keys:
                return self._global_aggregate(t, node)
            aggs = [(c, o) for c, o, _ in node.aggs]
            choice = self._kernel_choice(
                "groupby", groupby_cuda.make_signature(t, aggs, "eager",
                                                       node.keys),
                m.label)
            m.kernel = choice.label
            agg = aggregate.groupby_aggregate(t, list(node.keys), aggs,
                                              choice=choice)
            return Table(list(agg.columns), names=schemas[id(node)])
        if isinstance(node, Sort):
            (t,) = childs
            return sort.sort_table(t, key_names=list(node.keys),
                                   ascending=list(node.ascending))
        if isinstance(node, TopK):
            (t,) = childs
            sig = topk.make_signature(t, node.keys, node.ascending, node.n,
                                      "eager")
            choice = self._kernel_choice("topk", sig, m.label)
            m.kernel = choice.label
            if not choice.fallback:
                return choice.fn(t, list(node.keys), list(node.ascending),
                                 node.n, words=sig.extra("words"))
            return topk.topk_plain(t, node.keys, node.ascending, node.n)
        if isinstance(node, Limit):
            (t,) = childs
            return copying.slice_table(t, 0, node.n)
        if isinstance(node, Union):
            return copying.concat_tables(childs)
        if isinstance(node, Exchange):
            # one device: a distribution marker that returns its child, as
            # the reference's eager tier does without a mesh
            return childs[0]
        raise PlanValidationError(f"no eager lowering for {node.kind}")

    @staticmethod
    def _project(t: Table, node: Project,
                 alive: Optional[torch.Tensor] = None) -> Table:
        cols = []
        for name, e in node.exprs:
            if isinstance(e, ColumnRef):
                cols.append(t[e.name])      # preserve dtype + validity
            else:
                v = e.evaluate(t, alive)
                if v.dim() == 0:
                    # a bare scalar aggregate: broadcast to the relation
                    v = v.expand(t.num_rows).contiguous()
                cols.append(Column(dtypes.from_torch(v.dtype),
                                   int(v.shape[0]), v))
        return Table(cols, names=[n for n, _ in node.exprs])

    @staticmethod
    def _global_aggregate(t: Table, node: HashAggregate,
                          alive: Optional[torch.Tensor] = None) -> Table:
        """Keyless (one-row) aggregate: sum/min/max ignore nulls, and in
        the capped tier the rows `alive` leaves out. Float sums, mins and
        maxes give the reference's bits: its summation order
        (`aggregate.blocked_sum`), -0.0 below 0.0 and the canonical NaN
        (`aggregate.float_extreme`)."""
        dev = t.device
        cols, names = [], []
        for c, op, out_name in node.aggs:
            if op == "size":
                dt = dtypes.INT64
                val = (alive.to(torch.int64).sum() if alive is not None else
                       torch.tensor(t.num_rows, dtype=torch.int64,
                                    device=dev))
            else:
                src = t[c]
                ok = src.validity
                if alive is not None:
                    ok = alive if ok is None else ok & alive
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


    # ---- capped tier -------------------------------------------------------

    def _default_caps(self, plan: Plan, inputs) -> Dict[str, int]:
        """Starting capacities: the executor's caps, defaulted to the
        largest input's rows, and one `row_cap:<i>`/`key_cap:<i>` entry per
        node that sets its own (keyed by toposort index, so that equal
        plans share them), which grows with the rest."""
        caps = dict(self.caps)
        max_rows = max((t.num_rows for t in inputs.values()), default=1)
        needs_row = needs_key = False
        for i, n in enumerate(plan.nodes):
            if isinstance(n, HashJoin) and n.how == "inner":
                if n.row_cap is None:
                    needs_row = True
                else:
                    caps[f"row_cap:{i}"] = n.row_cap
            elif isinstance(n, HashAggregate) and n.keys:
                if n.key_cap is None:
                    needs_key = True
                else:
                    caps[f"key_cap:{i}"] = n.key_cap
        if needs_row:
            caps.setdefault("row_cap", max(max_rows, 1))
        if needs_key:
            caps.setdefault("key_cap", max(max_rows, 1))
        return caps

    @staticmethod
    def _node_cap(caps: Dict[str, int], which: str, idx: int) -> int:
        return caps.get(f"{which}:{idx}") or caps[which]

    def _execute_capped(self, plan: Plan, inputs, schemas) -> PlanResult:
        caps = self._default_caps(plan, inputs)
        fp = plan.fingerprint
        for k, v in (self._caps_memo.get(fp) or {}).items():
            caps[k] = max(caps.get(k, 0), v)
        input_key = tuple(sorted((n, tuple(t.names), t.num_rows)
                                 for n, t in inputs.items()))
        t0 = time.perf_counter()
        attempts = hits = 0
        prog: Optional[_CappedProgram] = None     # the last attempt's

        def run(**caps_now):
            nonlocal attempts, hits, prog
            attempts += 1
            prog, hit = self._capped_program(plan, caps_now, input_key)
            hits += hit
            return self._run_capped(plan, schemas, caps_now, inputs, prog)

        (table, valid, counts, _), final_caps = auto_retry_overflow(
            run, caps, self.max_cap_attempts)
        _bounded_put(self._caps_memo, fp, dict(final_caps), _CAPS_MEMO_SIZE)
        # every operator's live rows in and out: one read, after the run
        rows = torch.stack(counts).tolist()
        wall = (time.perf_counter() - t0) * 1e3
        metrics: Dict[str, OperatorMetrics] = {}
        for i, node in enumerate(plan.nodes):
            uses_cap = (isinstance(node, HashJoin) and node.how == "inner") \
                or (isinstance(node, HashAggregate) and bool(node.keys))
            choice = prog.kernels.get(i)
            metrics[node.label] = OperatorMetrics(
                label=node.label, kind=node.kind, describe=node.describe(),
                rows_in=rows[i][0], rows_out=rows[i][1],
                bytes_out=prog.bytes_out.get(i, 0),
                kernel="" if choice is None else choice.label,
                escalations=attempts - 1 if uses_cap else 0)
        return PlanResult(plan, table, metrics, wall, self.device,
                          valid=valid, mode="capped", attempts=attempts,
                          caps=final_caps, jit_cache_hits=hits)

    def _capped_program(self, plan: Plan, caps: Dict[str, int], input_key):
        """(the program's lowering, whether it was cached). The key is the
        reference's `_jitted_capped` key: the plan's fingerprint (equal
        plans built apart share it), the caps, the inputs' names and
        shapes, and what picks the kernels: the device type and the kernel
        overrides."""
        kern_key = (self.device.type,
                    tuple(sorted(config.kernel_overrides().items())))
        key = (plan.fingerprint, tuple(sorted(caps.items())), input_key,
               kern_key)
        prog = self._programs.get(key)
        if prog is not None:
            return prog, True
        prog = _CappedProgram()
        _bounded_put(self._programs, key, prog, _PROGRAM_CACHE_SIZE)
        return prog, False

    def _run_capped(self, plan: Plan, schemas, caps, inputs,
                    prog: _CappedProgram):
        """One attempt: (root table, root alive, per-node [rows in, rows
        out] as (2,) int64 device tensors, overflow as a () bool device
        tensor). Nothing here reads the device."""
        rels: Dict[int, _CappedRel] = {}
        live: Dict[int, torch.Tensor] = {}
        counts: List[torch.Tensor] = []
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        for i, node in enumerate(plan.nodes):
            childs = [rels[id(c)] for c in node.children]
            rel, ovf = self._exec_capped_node(node, i, childs, inputs,
                                              schemas, caps, prog)
            if ovf is not None:
                overflow = overflow | ovf
            prog.bytes_out[i] = rel.table.nbytes()
            live[id(node)] = rel.alive.to(torch.int64).sum()
            rows_in = sum((live[id(c)] for c in node.children), zero)
            counts.append(torch.stack([rows_in, live[id(node)]]))
            rels[id(node)] = rel
        root = rels[id(plan.root)]
        return root.table, root.alive, counts, overflow

    def _exec_capped_node(self, node: PlanNode, idx: int,
                          childs: List[_CappedRel], inputs, schemas, caps,
                          prog: _CappedProgram):
        """-> (_CappedRel, overflow flag or None) for one node."""
        def pick(op: str, sig):
            # the lowering's choice for this node, made at the program's
            # first run; on the card a declined call raises
            if idx not in prog.kernels:
                prog.kernels[idx] = self._kernel_choice(op, sig, node.label)
            return prog.kernels[idx]

        if isinstance(node, Scan):
            t = inputs[node.source]
            if node.projection is not None:
                t = t.select(list(node.projection))
            return _CappedRel(t, torch.ones(t.num_rows, dtype=torch.bool,
                                            device=t.device)), None
        if isinstance(node, Filter):
            (c,) = childs
            # a mask AND: dead rows stay, and stay dead
            mask = node.predicate.evaluate(c.table, c.alive)
            return _CappedRel(c.table, c.alive & mask), None
        if isinstance(node, FusedSelect):
            # filter then project over the padded frame; no compaction, so
            # no kernel: the registry's decline is stamped, never raised
            (c,) = childs
            if idx not in prog.kernels:
                prog.kernels[idx] = self._stamp(
                    "fused_select",
                    select.make_signature(c.table, node.predicate,
                                          node.exprs, "capped"))
            alive = c.alive & node.predicate.evaluate(c.table, c.alive)
            return _CappedRel(self._project(c.table, node, alive),
                              alive), None
        if isinstance(node, Project):
            (c,) = childs
            return _CappedRel(self._project(c.table, node, c.alive),
                              c.alive), None
        if isinstance(node, HashJoin):
            l, r = childs
            from ..ops import join_cuda
            lkeys, rkeys = join_cuda.join_keys(
                [l.table[k] for k in node.left_keys],
                [r.table[k] for k in node.right_keys])
            _check_capped_keys(lkeys + rkeys)
            sig = join_cuda.make_signature(lkeys, rkeys, node.how, "capped")
            choice = pick("hash_join", sig)
            if node.how == "inner":
                row_cap = self._node_cap(caps, "row_cap", idx)
                if l.table.num_rows == 0 or r.table.num_rows == 0:
                    # no row 0 to gather for the dead slots (a TopK of 0
                    # rows, an empty input): row_cap dead slots, no pair
                    dev = l.table.device
                    t = Table([copying.dead_column(c, row_cap)
                               for c in (list(l.table.columns)
                                         + list(r.table.columns))],
                              names=list(l.table.names) +
                              list(r.table.names))
                    dead = torch.zeros(row_cap, dtype=torch.bool, device=dev)
                    return _CappedRel(t, dead), torch.zeros(
                        (), dtype=torch.bool, device=dev)
                fn = (join.inner_join_capped if choice.fallback
                      else join_cuda.inner_join_capped_hash)
                lm, rm, valid, ovf = fn(lkeys, rkeys, row_cap,
                                        lalive=l.alive, ralive=r.alive)
                cols = [gather.take(c, lm, _has_negative=False)
                        for c in l.table.columns]
                cols += [gather.take(c, rm, _has_negative=False)
                         for c in r.table.columns]
                t = Table(cols, names=list(l.table.names) +
                          list(r.table.names))
                return _CappedRel(t, valid), ovf
            fn = (join.semi_join_mask if choice.fallback
                  else join_cuda.semi_join_mask_hash)
            mask = fn(lkeys, rkeys, lalive=l.alive, ralive=r.alive)
            alive = (l.alive & mask if node.how == "left_semi"
                     else l.alive & ~mask)
            return _CappedRel(l.table, alive), None
        if isinstance(node, HashAggregate):
            (c,) = childs
            if not node.keys:
                t = self._global_aggregate(c.table, node, alive=c.alive)
                return _CappedRel(t, torch.ones(1, dtype=torch.bool,
                                                device=t.device)), None
            _check_capped_keys([c.table[k] for k in node.keys])
            aggs = [(cn, o) for cn, o, _ in node.aggs]
            choice = pick("groupby", groupby_cuda.make_signature(
                c.table, aggs, "capped", node.keys))
            agg, valid, ovf = aggregate.groupby_aggregate_capped(
                c.table, list(node.keys), aggs,
                key_cap=self._node_cap(caps, "key_cap", idx), alive=c.alive,
                choice=choice)
            t = Table(list(agg.columns), names=schemas[id(node)])
            return _CappedRel(t, valid), ovf
        if isinstance(node, Sort):
            (c,) = childs
            _check_capped_keys([c.table[k] for k in node.keys])
            t, alive = sort.sort_table_capped(
                c.table, key_names=list(node.keys),
                ascending=list(node.ascending), alive=c.alive)
            return _CappedRel(t, alive), None
        if isinstance(node, TopK):
            # the kernel returns the top n live rows (a narrower frame);
            # the plain lowering sorts the frame, dead rows last, and keeps
            # the first n live rows by an inclusive prefix count. Capped
            # operators downstream take any row count.
            (c,) = childs
            _check_capped_keys([c.table[k] for k in node.keys])
            sig = topk.make_signature(c.table, node.keys, node.ascending,
                                      node.n, "capped")
            choice = pick("topk", sig)
            if not choice.fallback:
                from ..ops import topk_cuda
                return _CappedRel(*topk_cuda.topk_capped(
                    c.table, list(node.keys), list(node.ascending), node.n,
                    c.alive, words=sig.extra("words"))), None
            t, alive = sort.sort_table_capped(
                c.table, key_names=list(node.keys),
                ascending=list(node.ascending), alive=c.alive)
            return _CappedRel(t, _first_live(alive, node.n)), None
        if isinstance(node, Limit):
            (c,) = childs
            return _CappedRel(c.table, _first_live(c.alive, node.n)), None
        if isinstance(node, Union):
            # the padded frames end to end, their alive masks likewise
            t = copying.concat_tables([c.table for c in childs])
            return _CappedRel(t, torch.cat([c.alive for c in childs])), None
        if isinstance(node, Exchange):
            return childs[0], None
        raise PlanValidationError(f"no capped lowering for {node.kind}")


def _input_has_floats(inputs: Dict[str, Table]) -> bool:
    """Any floating column among the bound tables."""
    return any(c.dtype.is_floating for t in inputs.values()
               for c in t.columns)


def _first_live(alive: torch.Tensor, n: int) -> torch.Tensor:
    """The first n live rows of `alive`, by an inclusive prefix count."""
    return alive & (torch.cumsum(alive.to(torch.int32), 0) <= n)
