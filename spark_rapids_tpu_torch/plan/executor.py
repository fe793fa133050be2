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
  the grown caps per plan fingerprint, and by the stats store's observed
  caps of the authored plan; with a store and SPARK_RAPIDS_TORCH_CERT_SEED
  on, the resource certifier's `rows_hi` then tightens them and puts a
  ceiling on the ladder (`_cert_caps`). The program cache, keyed as the
  reference's `_jitted_capped` (fingerprint, caps, input names, shapes and
  column layout, device type, kernel overrides and the store's kernel
  epoch), holds each program: the kernel chosen per node, the bytes of
  its padded output and, on the card, its CUDA graph.

  The CUDA graph is the port's counterpart of the reference's one
  compiled program per plan (`jax.jit` of `_run_capped`). A program's
  first run launches every kernel from Python under
  `torch.cuda.set_sync_debug_mode("error")`, which loads every library
  and kernel outside a capture and proves that the attempt reads nothing
  of the device. Its second run captures `_run_capped` into a
  `torch.cuda.CUDAGraph` over static input buffers (copies of the
  inputs) and replays it; every later run copies its inputs into those
  buffers on the card and replays. The outputs (the padded table,
  `alive`, the per-node counts, the overflow flag) are copied out of the
  graph's pool before the result takes them. An executor's graphs share
  one memory pool and one capture stream. A replay runs no kernel
  wrapper, so the kernels' launch counters count the capture's calls
  and not the replays; `GRAPH_COUNTS` counts captures and replays. An
  overflow grows the caps, so the next attempt is another program. The
  CPU has no graphs, and a plan whose scans give a STRING or nested
  column is not captured (`gather._spans` reads the char total on the
  host); nor is a program whose capture failed. Such a program runs
  every kernel on the card as the first run does, without the sync
  check, and `PlanResult.graph` is False with `graph_reason` saying
  why.

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

The feedback loop, as the reference's (plan/stats.py): after every
successful run the result is recorded in the active stats store under
the backend it ran on ("cuda" or "cpu"; a CPU run never seeds the card),
and the optimizer reads the store's observed rows (a stats-driven rewrite
passes `verify_rewrite`, or the static pipeline reruns and the report
says `stats_reverted`). The resource certifier (analysis/footprint.py)
certifies the plan about to run, once per (plan, binding), stamps it on
`PlanResult.cert`, and gates admission when SPARK_RAPIDS_TORCH_CERT_
BUDGET_BYTES (or `cert_budget=`) is set: "reject" raises
`ResourceAdmissionError` before anything runs; "degrade" runs the whole
plan on the degraded CPU tier, where the device budget does not bind.
With SPARK_RAPIDS_TORCH_TRACE=1 every eager operator runs in a
`plan.<label>` range and every capped attempt in `plan.capped.attempt`
(utils/tracing.py).

Runtime arbitration, as the reference's (runtime/, faultinj.py):

- Admission. The eager tier and the degraded tier call every op through
  `ops/plan_ops.py`, by module attribute, under the JAX package's op
  names; each entry is admitted against the active `DeviceSession`'s
  device budget (`runtime.admission`), and `session=` scopes one to the
  execution on this thread. A capped attempt is admitted once, before
  its program runs or replays, for the program's padded bytes (twice the
  inputs' before its first run), and its reservation shrinks to the
  attempt's outputs: a graph replay runs no Python, so nothing inside it
  can be admitted or injected.
- Faults. The plan-level fault-injection point `plan.<Kind>` fires once
  per operator in the eager tier and once per operator per attempt in
  the capped tier, before the attempt's program is looked up, so a fault
  leaves no program half captured; the op-level shims sit on
  `plan_ops`. `runtime.health` turns injected failures into a policy:
  transient ones (an assert, a substituted return code) retry with
  jittered backoff against the plan attempt's retry budget, at most
  `op_retries` times per operator; sticky and fatal ones trip the
  breaker.
- Memory pressure is not a device fault. The arbiter's RetryOOM and
  SplitAndRetryOOM (and their CPU forms) leave `execute()` at once: they
  never reach the health monitor, so they neither trip the breaker nor
  degrade. The caller drops the attempt's outputs, which frees their
  reservations, blocks until the arbiter lets the thread go and reruns
  (`runtime.with_retry`'s protocol; a plan is not split). The reference
  retries a RetryOOM in place while holding the plan's earlier outputs,
  and trips its breaker once `op_retries` is spent.
- The degraded CPU tier. After a trip, with `degrade="cpu"` (the
  default, SPARK_RAPIDS_TORCH_BREAKER_DEGRADE), the outputs finished on
  the card are copied to host memory and the rest of the plan runs on
  the CPU's plain versions with every fault point suppressed; while the
  breaker is open whole plans run there, and after `reset_device()` (or
  the cooldown) a half-open probe on the card decides. `PlanResult`
  says so: `degraded`, `retries`, `backoff_ms` and the breaker's
  snapshot. The stats store files a degraded result under "cpu".
  Everywhere else on the card the kernels run or the call raises.

The rule-based optimizer (`plan/optimizer.py`) runs first, by default
(`optimize=None` reads SPARK_RAPIDS_TORCH_OPTIMIZER), once per (plan,
binding); `PlanResult.optimizer` holds its report. With
SPARK_RAPIDS_TORCH_VERIFY_PLANS on, the optimizer re-validates every
rule's output and `_verify_execution` runs the static verifier
(`analysis/verifier.py`) on the plan about to run, as the reference's
gate does. Every node kind runs in both tiers; without a mesh an
`Exchange` returns its child, as the reference's does on one device.
Placement waits for ROADMAP queue A item 14.

The distributed tier, as the reference's (`plan/distributed.py`):
`PlanExecutor(mesh=make_mesh(P, devices=[...] * P))` runs an eager plan
over the mesh's P peers, which share the executor's device (a mesh on
another device raises). The optimizer's exchange_planning rule places
the Exchange(hash | broadcast | gather) boundaries for the mesh width and
the broadcast thresholds, the verifier's partitioning layer checks them
(`planned=True`), the certifier sizes each exchange edge for P peers,
and `DistContext` runs every node with a distributed form over sharded
relations, gathering at the sink. Source-bound scans are read once,
pruned, under a mesh (no streaming prefix). A capped executor with a mesh
rejects a plan with a distributed-lowerable operator, naming it
(`_check_capped_mesh`).

The streaming scan, as the reference's (`_stream_chains`,
`_exec_stream_chain`): a Scan bound to a Parquet source (`io.ParquetSource`,
through `inputs=` or `PlanBuilder.scan(parquet=...)`) starts a streamable
prefix, which runs a chunk (a row group, or SPARK_RAPIDS_TORCH_IO_CHUNK_ROWS
rows of one) at a time: the row groups that the scan_pruning rule's
`Scan.predicate` proves empty are skipped by footer statistics, a prefetch
thread (SPARK_RAPIDS_TORCH_IO_PREFETCH chunks deep, 0 inline) decodes chunk
N+1 into page-locked host memory and starts its copy on a copy stream while
chunk N runs on the card (`_Uploader`), and a tail HashAggregate
accumulates per-chunk partials merged exactly at the end. A transient
fault retries the chunk's operator; a breaker trip replays the prefix from
the scan on the degraded CPU tier. A source-bound scan outside a prefix,
and every source of a capped plan, is read whole once, pruned and
projected, through the admitted `read_parquet`.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple, Union as TUnion

import torch

from .. import config, dtypes, faultinj
from .. import device as _device
from ..columnar import Column, Table
from ..utils import tracing
from ..utils.lru import LruDict
from ..ops import (aggregate, copying, gather, groupby_cuda, join, plan_ops,
                   select, sort, topk)
from ..ops.aggregate import _agg_value_dtype
from ..ops.registry import REGISTRY, KernelDeclinedError
from ..parallel.autoretry import auto_retry_overflow
from ..runtime.admission import (active_session, get_active_session,
                                 operand_nbytes, tie_to_outputs)
from .builder import Plan
from .expr import ColumnRef, _reduce_identity
from . import stats as stats_mod
from .metrics import OperatorMetrics, render_profile
from .nodes import (Exchange, Filter, FusedSelect, HashAggregate, HashJoin,
                    Limit, PlanNode, PlanValidationError, Project, Scan, Sort,
                    TopK, Union)

_OPT_CACHE_SIZE = 64     # rewrites kept per executor, oldest dropped first
_PROGRAM_CACHE_SIZE = 64     # capped programs kept per executor
_CAPS_MEMO_SIZE = 256        # plans whose grown caps are kept

def _fault_surface():
    """The failures the health policy handles: injected nonfatal asserts
    and substituted return codes (transient), and DeviceFatalError (fatal,
    never retried on the device). The arbiter's OOMs are not among them:
    they leave `execute()` for the caller."""
    return (faultinj.DeviceFatalError, faultinj.DeviceAssertError,
            faultinj.InjectedReturnCode)


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


class PlanResult:
    """Output of one plan execution: the executed `plan` (the optimized
    form when the optimizer ran; metric labels refer to its nodes), the
    result `table`, per-operator `metrics` (label -> OperatorMetrics), the
    plan's wall time and the optimizer's report (`optimizer`, None when it
    did not run).

    In the capped tier `table` is padded and `valid` marks its live rows
    (`compact()` gathers them); `attempts` counts the cap-escalation
    attempts, `caps` holds the final (possibly grown) capacities and
    `jit_cache_hits` the program-cache reuses of this execute; `graph`
    whether its last attempt replayed a CUDA graph, and `graph_reason` why
    not. `cert` is the resource certifier's certificate of the executed
    plan (None where the certifier declined). `retries` counts the re-runs
    after transient faults and `backoff_ms` the time backed off before
    them; `degraded` says the plan finished on the degraded CPU tier
    (`device` is then the CPU, and a capped result is unpadded), and
    `breaker` is the health breaker's snapshot ({"state", "trips",
    "reason", "error"})."""

    def __init__(self, plan: Plan, table: Table,
                 metrics: Dict[str, OperatorMetrics], wall_ms: float,
                 device: torch.device, valid: Optional[torch.Tensor] = None,
                 mode: str = "eager", attempts: int = 1,
                 caps: Optional[Dict[str, int]] = None,
                 jit_cache_hits: int = 0, graph: bool = False,
                 graph_reason: str = "the eager tier has no program",
                 retries: int = 0, degraded: bool = False,
                 breaker: Optional[Dict] = None, backoff_ms: float = 0.0):
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
        self.graph = graph
        self.graph_reason = "" if graph else graph_reason
        self.optimizer: Optional[Dict] = None
        self.cert = None
        self.retries = retries
        self.degraded = degraded
        self.breaker = breaker
        self.backoff_ms = backoff_ms

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
                              jit_cache_hits=self.jit_cache_hits,
                              cert=self.cert, graph=self.graph,
                              degraded=self.degraded, breaker=self.breaker)


class _CappedRel:
    """A relation inside a capped run: a padded table and its live-row
    mask."""

    __slots__ = ("table", "alive")

    def __init__(self, table: Table, alive: torch.Tensor):
        self.table = table
        self.alive = alive


class _CappedProgram:
    """One capped program, filled at its first run and reused by every run
    that hits the program cache: the kernel choice per node (toposort
    index -> KernelChoice), the bytes of each node's padded output, and on
    the card its CUDA graph (module docstring): `runs` counts its runs,
    `reason` is why it is never captured ("" when it may be), `graph` the
    captured graph with its static inputs and outputs."""

    __slots__ = ("kernels", "bytes_out", "runs", "reason", "graph",
                 "static_in", "static_out")

    def __init__(self, reason: str = ""):
        self.kernels: Dict[int, object] = {}
        self.bytes_out: Dict[int, int] = {}
        self.runs = 0
        self.reason = reason
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.static_in: Optional[Dict[str, Table]] = None
        self.static_out = None

    def release(self) -> None:
        """Drop the graph and its buffers (the program left the cache):
        their blocks go back to the executor's graph pool."""
        self.graph = self.static_in = self.static_out = None

    def fill(self, inputs) -> None:
        """Copy `inputs` into the static buffers, on the card's stream."""
        for dst, src in zip(_buffers(self.static_in), _buffers(inputs)):
            dst.copy_(src)


# graphs captured and replayed, by every executor of the process: a replay
# runs no kernel wrapper, so the kernels' launch counters do not see it
GRAPH_COUNTS = {"captures": 0, "replays": 0}


@contextlib.contextmanager
def _sync_is_error():
    """Any synchronising call of PyTorch inside the block raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _clone_column(c: Column) -> Column:
    return Column(c.dtype, c.length, c.data.clone(),
                  None if c.validity is None else c.validity.clone(),
                  None if c.offsets is None else c.offsets.clone(),
                  tuple(_clone_column(k) for k in c.children or ()))


def _clone_table(t: Table) -> Table:
    return Table([_clone_column(c) for c in t.columns], names=list(t.names))


def _buffers(tables: Dict[str, Table]) -> List[torch.Tensor]:
    """The fixed-width tables' buffers in a fixed order: data, then
    validity where there is one, column by column, table by name."""
    out = []
    for name in sorted(tables):
        for c in tables[name].columns:
            out.append(c.data)
            if c.validity is not None:
                out.append(c.validity)
    return out


class PlanExecutor:
    """Executes validated Plans on one device, in the eager or the capped
    tier. `caps` ({"row_cap": r, "key_cap": k}) are the capped tier's
    starting capacities, else the largest input's rows; `max_cap_attempts`
    bounds its escalation. `op_retries` bounds the transient-fault re-runs
    of one operator (of one capped plan); `session` is a DeviceSession
    scoped to each execution; `health` a DeviceHealthMonitor (share one to
    give several executors one breaker; default: one of its own, probing
    this executor's device); `degrade` "cpu" or "off" (None:
    SPARK_RAPIDS_TORCH_BREAKER_DEGRADE)."""

    def __init__(self, mode: str = "eager",
                 device: Optional[TUnion[str, torch.device]] = None,
                 block_per_op: bool = True,
                 optimize: Optional[bool] = None,
                 caps: Optional[Dict[str, int]] = None,
                 max_cap_attempts: int = 6,
                 cert_budget: Optional[int] = None,
                 op_retries: int = 2,
                 session=None,
                 health=None,
                 degrade: Optional[str] = None,
                 mesh=None, mesh_axis: str = "data"):
        if mode not in ("eager", "capped"):
            raise ValueError(f"unknown executor mode {mode!r}")
        self.mode = mode
        self.device = _device.resolve(device)
        # a capped executor with a mesh is checked per plan in execute():
        # only a plan with a distributed-lowerable operator is rejected
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None and hasattr(mesh, "device"):
            from ..parallel.shuffle import _normal
            if _normal(mesh.device) != _normal(self.device):
                raise ValueError(
                    f"the mesh's peers are on {mesh.device} but the "
                    f"executor runs on {self.device}: they must share one "
                    "device")
        self.op_retries = op_retries
        self.session = session
        if health is None:
            import functools
            from ..runtime.health import DeviceHealthMonitor, device_probe
            health = DeviceHealthMonitor(
                probe=functools.partial(device_probe, self.device))
        self.health = health
        self.degrade = (config.breaker_degrade() if degrade is None
                        else degrade)
        if self.degrade not in ("cpu", "off"):
            raise ValueError(f"unknown degrade policy {self.degrade!r} "
                             "(expected cpu or off)")
        self.block_per_op = block_per_op
        self.optimize = (config.optimizer_enabled() if optimize is None
                         else bool(optimize))
        self.caps = dict(caps or {})
        self.max_cap_attempts = max_cap_attempts
        # the admission budget in bytes (None: SPARK_RAPIDS_TORCH_CERT_
        # BUDGET_BYTES; 0: off)
        self.cert_budget = cert_budget
        # (root, binding) -> (optimized plan, its schemas, report)
        self._opt_cache: Dict[Tuple, Tuple] = LruDict(_OPT_CACHE_SIZE)
        # (root, binding) -> ResourceCert: one certify walk per binding
        self._cert_cache: Dict[Tuple, object] = LruDict(_OPT_CACHE_SIZE)
        # program key -> _CappedProgram (the key of `_capped_program`); an
        # evicted program frees its graph
        self._programs: Dict[Tuple, _CappedProgram] = LruDict(
            _PROGRAM_CACHE_SIZE, on_evict=_CappedProgram.release)
        # plan fingerprint -> the caps its last run ended with, so the next
        # run of an equal plan starts from the grown caps
        self._caps_memo: Dict[str, Dict[str, int]] = LruDict(_CAPS_MEMO_SIZE)
        # the distributed tier's grown caps: (fingerprint, node index,
        # primitive) -> caps
        self._dist_caps_memo: Dict[Tuple, Dict] = LruDict(_CAPS_MEMO_SIZE)
        # the pre-execution gate's passed verdicts (`_verify_execution`)
        self._verify_cache: Dict[Tuple, bool] = LruDict(_OPT_CACHE_SIZE)
        # one memory pool and one capture stream for all of this
        # executor's graphs (`_capture`), made at the first capture
        self._graph_pool = None
        self._capture_stream: Optional["torch.cuda.Stream"] = None

    def execute(self, plan: Plan,
                inputs: Optional[Dict[str, Table]] = None) -> PlanResult:
        """Run `plan` over `inputs` ({scan source: Table or
        `io.ParquetSource`}); a scan built with `parquet=` needs no
        entry."""
        self._check_capped_mesh(plan)
        inputs = bind_scan_sources(plan, inputs)
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
        # the authored fingerprint keys the stats store's plan entry, so a
        # stats-driven rewrite keeps the entry of its authored plan
        source_fp = authored.fingerprint
        cert = self._certify(plan, inputs, bound)
        if self._over_budget(cert):
            # degrade admission: the device budget does not bind on the
            # CPU tier, so the whole plan runs there, untouched by the card
            self.health.start_plan_attempt()
            res = self._execute_degraded(
                plan, inputs, schemas, {}, {}, start=0,
                t_plan0=time.perf_counter(), mode=self.mode)
        else:
            # a streaming source stays a host handle: its chunks move to
            # the device as they are decoded
            inputs = {s: (inputs[s] if _is_source(inputs[s])
                          else inputs[s].to(self.device))
                      for s in plan.input_names}
            scope = contextlib.nullcontext()
            if self.session is not None:
                scope = active_session(self.session)
            with scope:
                if self.mode == "capped":
                    res = self._execute_capped(plan, inputs, schemas,
                                               source_fp, cert)
                else:
                    res = self._execute_eager(plan, inputs, schemas)
        res.cert = cert
        if report is not None:
            res.optimizer = report.to_dict()
        store = stats_mod.active_store()
        if store is not None:
            # a degraded result ran on the CPU: it never seeds the card
            store.record_result(
                plan, res,
                backend="cpu" if res.degraded else self.device.type,
                source_fp=source_fp)
        return res

    def _mesh_peers(self) -> Optional[int]:
        """The mesh width the optimizer and the certifier plan for: the
        eager tier's mesh, else None."""
        if self.mesh is None or self.mode != "eager":
            return None
        return self.mesh.shape[self.mesh_axis]

    def _check_capped_mesh(self, plan: Plan) -> None:
        """mode="capped" with a mesh: reject only a plan with a
        distributed-lowerable operator (the capped tier would run it on one
        device), naming it."""
        if self.mesh is None or self.mode == "eager":
            return
        for n in plan.nodes:
            if isinstance(n, (Exchange, HashJoin, HashAggregate, Sort,
                              TopK, Union)):
                raise PlanValidationError(
                    f"{n.label}: distributed lowering (mesh=) exists only "
                    "in the eager tier; a capped executor would silently "
                    f"run this {n.kind} on one chip — drop the mesh or use "
                    "mode=\"eager\"")

    def _certify(self, plan: Plan, inputs, bound):
        """The resource certificate of the plan about to run, once per
        (plan, binding). None where the certifier fails: sizing never fails
        a query that would otherwise run."""
        from ..analysis import footprint
        try:
            input_dtypes, input_nullable = footprint.table_metadata(inputs)
            bound_rows = {n: t.num_rows for n, t in inputs.items()}
            n_peers = self._mesh_peers() or 1
            key = (plan.root, tuple(sorted(bound.items())),
                   tuple(sorted(bound_rows.items())),
                   tuple((n, tuple((cn, repr(dt)) for cn, dt in cols.items()))
                         for n, cols in sorted(input_dtypes.items())),
                   tuple((n, tuple(sorted(cols.items())))
                         for n, cols in sorted(input_nullable.items())),
                   n_peers)
            hit = self._cert_cache.get(key)
            if hit is None:
                hit = footprint.certify(
                    plan, bound=bound, bound_rows=bound_rows,
                    input_dtypes=input_dtypes, input_nullable=input_nullable,
                    n_peers=n_peers)
                self._cert_cache[key] = hit
            return hit
        except Exception:
            return None

    def _over_budget(self, cert) -> bool:
        """The admission gate: whether the plan's certified residency
        exceeds the budget. Over it, "reject" raises
        ResourceAdmissionError naming the operator and "degrade" answers
        True (the caller runs the degraded CPU tier)."""
        budget = (self.cert_budget if self.cert_budget is not None
                  else config.cert_budget_bytes())
        if not budget or cert is None:
            return False
        violations = cert.over_budget(budget)
        if not violations:
            return False
        if config.cert_admission() == "reject":
            from ..analysis.footprint import ResourceAdmissionError
            raise ResourceAdmissionError(
                violations, "admission gate: certified footprint exceeds "
                f"the {budget} B device budget")
        return True

    def _verify_execution(self, authored: Plan, plan: Plan, report,
                          inputs, bound) -> None:
        """The pre-execution gate (SPARK_RAPIDS_TORCH_VERIFY_PLANS): the
        plan about to run passes the static verifier, schema and typing
        layers, and the rewrite pair's checks when the optimizer ran.
        Raises PlanVerificationError naming the invariant and operator.
        Verdicts are kept per (plan, binding), as the reference keeps
        them, so a repeat execution pays nothing."""
        from ..analysis import verifier
        input_dtypes = _input_dtypes(inputs)
        floats = _input_has_floats(inputs)
        # partitioning soundness checks when exchange_planning placed the
        # distributed boundaries (a meshed eager executor, P > 1)
        planned = (report is not None and not report.fell_back
                   and (self._mesh_peers() or 1) > 1)
        key = (authored.root, plan.root, tuple(sorted(bound.items())),
               tuple((n, tuple(repr(d) for d in cols.values()))
                     for n, cols in sorted(input_dtypes.items())),
               floats, planned,
               None if report is None else (report.fingerprint,
                                            report.fell_back))
        if self._verify_cache.get(key):
            return
        if report is None and plan is authored:
            rep = verifier.verify(plan, bound=bound,
                                  input_dtypes=input_dtypes,
                                  float_inputs=floats)
        else:
            rep = verifier.verify_rewrite(authored, plan, bound=bound,
                                          input_dtypes=input_dtypes,
                                          float_inputs=floats,
                                          planned=planned, report=report)
        rep.raise_if_failed("pre-execution gate")
        self._verify_cache[key] = True

    def _optimized(self, plan: Plan, inputs, bound):
        """The rewrite of `plan` for this binding, computed once per (plan,
        names, row counts, float flag, verify mode, dtypes, the store's
        `rows_generation`): float columns anywhere in the inputs disable
        the row-reordering build_side rule, the verify mode
        (`config.verify_plans`, which re-validates every rule's output)
        changes which plan survives an invalid rewrite, the dtypes feed the
        certifier, and a cached rewrite must not outlive the observed rows
        it ignored (a rerun that observes the same rows keeps it, and with
        it the certificate and the gate's verdict). Every stats-driven
        rewrite passes `verify_rewrite`, or the static pipeline reruns and
        the report says `stats_reverted`."""
        from .optimizer import optimize as run_optimizer
        floats = _input_has_floats(inputs)
        rows = {n: t.num_rows for n, t in inputs.items()}
        verify_rules = config.verify_plans()
        input_dtypes = _input_dtypes(inputs)
        # scans bound to streaming sources: the scan_pruning rule fires
        # only for these, so the set belongs in the key too
        streaming = frozenset(n for n, t in inputs.items() if _is_source(t))
        dtype_sig = tuple(
            (name, tuple((cn, repr(dt)) for cn, dt in cols.items()))
            for name, cols in sorted(input_dtypes.items()))
        store = stats_mod.active_store()
        stats_gen = None if store is None else (store.uid,
                                                store.rows_generation)
        # exchange_planning runs for a meshed eager executor only, and its
        # placements depend on the mesh width and the broadcast threshold
        mesh_peers = self._mesh_peers()
        bc_rows = config.broadcast_rows() if mesh_peers else None
        key = (plan.root, tuple(sorted(bound.items())),
               tuple(sorted(rows.items())), floats, verify_rules, dtype_sig,
               stats_gen, streaming, mesh_peers, bc_rows)
        hit = self._opt_cache.get(key)
        if hit is None:
            backend = self.device.type
            opt, report = run_optimizer(plan, bound, rows,
                                        float_inputs=floats,
                                        verify_rules=verify_rules,
                                        stats=store, backend=backend,
                                        input_dtypes=input_dtypes,
                                        streaming_sources=streaming,
                                        mesh_peers=mesh_peers)
            if (store is not None and not verify_rules
                    and opt is not plan and not report.fell_back
                    and report.stats_driven()):
                from ..analysis import verifier
                rep = verifier.verify_rewrite(
                    plan, opt, bound=bound, input_dtypes=input_dtypes,
                    float_inputs=floats, report=report,
                    planned=bool(mesh_peers and mesh_peers > 1))
                if not rep.ok:
                    opt, report = run_optimizer(
                        plan, bound, rows, float_inputs=floats,
                        verify_rules=verify_rules,
                        input_dtypes=input_dtypes,
                        streaming_sources=streaming,
                        mesh_peers=mesh_peers)
                    report.stats_reverted = True
            hit = (opt, opt.resolve_schemas(bound), report)
            self._opt_cache[key] = hit
        return hit

    def explain(self, plan: Plan, optimized: bool = False,
                inputs: Optional[Dict[str, Table]] = None) -> str:
        """The authored tree; with `optimized=True`, the authored and the
        rewritten trees and the per-rule summary, from declared schemas
        and `est_rows` hints, or, given `inputs`, the exact rewrite
        execute() runs for that binding, its certificate and, with a
        mesh, the transport line."""
        if not optimized:
            return plan.explain()
        if inputs is None:
            from .optimizer import explain_optimized
            return explain_optimized(plan)
        if not self.optimize:
            return (plan.explain() + "\n\noptimizer: disabled for this "
                    "executor (optimize=False / SPARK_RAPIDS_TORCH_OPTIMIZER"
                    "=off) — the authored plan executes verbatim")
        inputs = bind_scan_sources(plan, inputs)
        bound = {name: tuple(t.names) for name, t in inputs.items()}
        plan.resolve_schemas(bound)
        opt, _, report = self._optimized(plan, inputs, bound)
        cert = self._certify(opt, inputs, bound)
        cert_block = [cert.render()] if cert is not None else []
        transport_block = ([self._transport_summary()]
                           if self._mesh_peers() else [])
        return "\n".join(["== authored ==", plan.explain(), "",
                          "== optimized ==", opt.explain(), "",
                          report.summary(), *cert_block, *transport_block])

    @staticmethod
    def _transport_summary() -> str:
        """The exchange-transport line of a meshed explain(optimized=True):
        what the plan's exchanges would move under the current knobs."""
        pack = config.exchange_pack()
        codecs = ",".join(sorted(config.exchange_codecs())) if pack else ""
        return ("transport: pack=" + ("on" if pack else "off")
                + f" codecs={codecs or 'none'}"
                + " async=" + ("on" if config.exchange_async() else "off")
                + " (wire vs logical bytes per edge on profile())")

    def _sync(self) -> None:
        if self.block_per_op and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- faults and the health policy ---------------------------------------

    @staticmethod
    def _faultinj_points(nodes) -> None:
        """The plan-level interception point: rules keyed `plan.<Kind>`
        (or `*`) fire here for each of `nodes`, besides the op-level shims
        of `plan_ops`. One lookup when no injector is installed."""
        inj = faultinj.active()
        if inj is not None:
            for node in nodes:
                inj.on_compute(f"plan.{node.kind}")

    def _breaker_snapshot(self) -> Dict:
        br = self.health.breaker
        return {"state": br.state, "trips": br.trips,
                "reason": br.last_trip_reason, "error": br.last_trip_error}

    def _handle_fault(self, err, op_label: str, attempt: int,
                      metric: OperatorMetrics) -> bool:
        """One failure on the device path. True: retry the failed unit
        (backoff slept, counters bumped). False: the breaker tripped, and
        the caller degrades (or raises under degrade="off")."""
        from ..runtime import health as _h
        kind = self.health.record_failure(op_label, err)
        if kind == _h.TRANSIENT:
            if attempt < self.op_retries:
                slept = self.health.try_retry(attempt)
                if slept is not None:
                    metric.retries += 1
                    metric.backoff_ms += slept
                    return True
                kind = _h.STICKY        # the shared retry budget is spent
            else:
                kind = _h.STICKY        # the per-operator bound is spent
        self.health.trip(kind, err)
        return False

    # ---- eager tier ----------------------------------------------------------

    def _execute_eager(self, plan: Plan, inputs, schemas) -> PlanResult:
        self._sync()
        t_plan0 = time.perf_counter()
        results: Dict[int, Table] = {}
        metrics: Dict[str, OperatorMetrics] = {}
        self.health.start_plan_attempt()
        if self.degrade != "off" and not self.health.admit():
            # the device is quarantined (breaker open, or a failed
            # half-open probe): the whole plan runs on the CPU tier
            return self._execute_degraded(plan, inputs, schemas, results,
                                          metrics, start=0, t_plan0=t_plan0,
                                          mode="eager")
        # the distributed tier (plan/distributed.py): with a mesh, nodes
        # run over sharded relations and gather at the sink, or at the
        # first operator with no distributed form; source-bound scans are
        # read once, pruned, instead of streamed
        dist = None
        if self.mesh is not None:
            from .distributed import DistContext
            dist = DistContext(self, plan, inputs)
        # streamable prefixes over source-bound scans run a chunk at a
        # time (chunk N+1 decodes on the host while chunk N runs); their
        # interior nodes never materialize a whole relation, only the
        # chain's tail does
        chains = {} if dist is not None else self._stream_chains(plan,
                                                                  inputs)
        chain_interior = {id(n) for ch in chains.values() for n in ch[:-1]}
        node_index = {id(n): i for i, n in enumerate(plan.nodes)}
        try:
            for i, node in enumerate(plan.nodes):
                if id(node) in chain_interior:
                    continue        # runs inside its chain, at the tail
                if id(node) in chains:
                    chain = chains[id(node)]
                    try:
                        results[id(node)] = self._exec_stream_chain(
                            chain, inputs, schemas, metrics)
                    except _StreamBreaker as sb:
                        if self.degrade == "off":
                            raise sb.error
                        # replay the whole prefix on the CPU tier, from
                        # the scan
                        return self._execute_degraded(
                            plan, inputs, schemas, results, metrics,
                            start=_replay_start(plan, node_index,
                                                node_index[id(chain[0])],
                                                results),
                            t_plan0=t_plan0, mode="eager",
                            carry_retries=sb.retries,
                            carry_backoff_ms=sb.backoff_ms)
                    continue
                childs = [results[id(c)] for c in node.children]
                m = OperatorMetrics(label=node.label, kind=node.kind,
                                    describe=node.describe())
                t0 = time.perf_counter()
                attempt = 0
                while True:
                    try:
                        with tracing.range_ctx(f"plan.{node.label}"):
                            self._faultinj_points((node,))
                            if dist is not None:
                                out = dist.exec_node(node, childs, inputs,
                                                     schemas, m, metrics)
                            else:
                                out = self._exec_eager_node(
                                    node, childs, inputs, schemas, m)
                            if not getattr(out, "pending", False):
                                self._sync()
                        break
                    except _fault_surface() as err:
                        if self._handle_fault(err, node.label, attempt, m):
                            attempt += 1
                            continue
                        if self.degrade == "off":
                            raise
                        return self._execute_degraded(
                            plan, inputs, schemas, results, metrics,
                            start=i, t_plan0=t_plan0, mode="eager",
                            first_metric=m)
                if attempt:
                    # retried to success: the fault was transient, and must
                    # not count toward a later sticky trip
                    self.health.record_success(node.label)
                m.rows_in = sum(t.num_rows for t in childs)
                if not getattr(out, "pending", False):
                    # compute of every attempt, not the backoff between
                    # them; an exchange in flight stamps its own at resolve
                    m.wall_ms = ((time.perf_counter() - t0) * 1e3
                                 - m.backoff_ms)
                    m.rows_out = out.num_rows
                    m.bytes_out = out.nbytes()
                metrics[node.label] = m
                results[id(node)] = out
        except BaseException as err:
            # a failed plan still says what completed; the first
            # attachment wins (a failed degraded rerun recorded its own)
            if not hasattr(err, "plan_metrics"):
                try:
                    err.plan_metrics = dict(metrics)
                except Exception:
                    pass
            raise
        root_out = results[id(plan.root)]
        if not isinstance(root_out, Table):
            # the sink gather of a distributed plan, where the optimizer
            # placed no Exchange(gather) at the root
            root_out = root_out.to_local_table()
        wall = (time.perf_counter() - t_plan0) * 1e3
        return PlanResult(plan, root_out, metrics, wall,
                          self.device,
                          retries=sum(mm.retries for mm in metrics.values()),
                          breaker=self._breaker_snapshot(),
                          backoff_ms=sum(mm.backoff_ms
                                         for mm in metrics.values()))

    # ---- degraded CPU tier -----------------------------------------------------

    def _execute_degraded(self, plan: Plan, inputs, schemas, results,
                          metrics, start: int, t_plan0: float, mode: str,
                          first_metric: Optional[OperatorMetrics] = None,
                          carry_retries: int = 0,
                          carry_backoff_ms: float = 0.0,
                          attempts: int = 1,
                          caps: Optional[Dict[str, int]] = None
                          ) -> PlanResult:
        """Finish the plan on the CPU after a breaker trip (or under
        degrade admission). The outputs finished on the card are copied to
        host memory; the nodes from `start` on run eagerly on CPU tensors,
        each kernel's plain version, with every fault point suppressed
        (`faultinj.suppressed()`: the CPU tier does not touch the
        quarantined card). If the copy fails, the whole plan reruns from
        the inputs. Admission still applies."""
        cpu = torch.device("cpu")
        self.health.note_degraded_plan()
        with faultinj.suppressed():
            try:
                cpu_results = {k: (t if isinstance(t, Table)
                                   else t.to_local_table()).to(cpu)
                               for k, t in results.items()}
                cpu_inputs = _inputs_to(inputs, cpu)
            except Exception:
                # the card's buffers are lost: restart from the inputs,
                # keeping the retries and backoff already paid
                carry_retries += sum(mm.retries for mm in metrics.values())
                carry_backoff_ms += sum(mm.backoff_ms
                                        for mm in metrics.values())
                if first_metric is not None:
                    carry_retries += first_metric.retries
                    carry_backoff_ms += first_metric.backoff_ms
                cpu_results = {}
                cpu_inputs = _inputs_to(inputs, cpu)
                metrics = {}
                start = 0
                first_metric = None
            try:
                for node in plan.nodes[start:]:
                    childs = [cpu_results[id(c)] for c in node.children]
                    if first_metric is not None and node is plan.nodes[start]:
                        m = first_metric    # keep the failed op's retries
                    else:
                        m = OperatorMetrics(label=node.label, kind=node.kind,
                                            describe=node.describe())
                    m.degraded = True
                    t0 = time.perf_counter()
                    with tracing.range_ctx(f"plan.{node.label}.degraded"):
                        out = self._exec_eager_node(node, childs, cpu_inputs,
                                                    schemas, m,
                                                    backend="cpu")
                    m.wall_ms = (time.perf_counter() - t0) * 1e3
                    m.rows_in = sum(t.num_rows for t in childs)
                    m.rows_out = out.num_rows
                    m.bytes_out = out.nbytes()
                    metrics[node.label] = m
                    cpu_results[id(node)] = out
            except BaseException as err:
                try:
                    err.plan_metrics = dict(metrics)
                except Exception:
                    pass
                raise
        wall = (time.perf_counter() - t_plan0) * 1e3
        return PlanResult(plan, cpu_results[id(plan.root)], metrics, wall,
                          cpu, mode=mode, attempts=attempts, caps=caps,
                          graph_reason="the degraded CPU tier has no program",
                          degraded=True,
                          retries=carry_retries + sum(
                              mm.retries for mm in metrics.values()),
                          breaker=self._breaker_snapshot(),
                          backoff_ms=carry_backoff_ms + sum(
                              mm.backoff_ms for mm in metrics.values()))

    def _pick(self, op: str, sig, m: OperatorMetrics,
              backend: Optional[str] = None):
        """`_kernel_choice` for an eager operator, stamped on its metrics
        with the signature the stats store files its timing under."""
        choice = self._kernel_choice(op, sig, m.label, backend)
        m.kernel = choice.label
        m._kernel_sig = (op, sig)
        return choice

    def _kernel_choice(self, op: str, sig, label: str,
                       backend: Optional[str] = None):
        """The registry's kernel for `op` on `backend` (the executor's
        device type by default; the degraded tier passes "cpu"); on the
        card a declined call raises (the plain versions run on the CPU
        only)."""
        backend = backend or self.device.type
        choice = REGISTRY.select(op, sig, backend=backend)
        if choice.fallback and backend == "cuda":
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
                         schemas, m: OperatorMetrics,
                         backend: Optional[str] = None) -> Table:
        """One eager operator, every op through `plan_ops` (looked up at
        call time, so the admission wrappers and the fault injector's
        shims see it), in the JAX executor's order of op names."""
        P = plan_ops
        if isinstance(node, Scan):
            t = inputs[node.source]
            if _is_source(t):
                # a streaming source outside a streamable prefix: one
                # pruned, projected read
                return self._materialize_scan(
                    node, t, m, torch.device(backend) if backend
                    else self.device)
            if node.projection is not None:
                t = t.select(list(node.projection))   # pruned columns
            return t
        if isinstance(node, Filter):
            (t,) = childs
            return P.apply_boolean_mask(t, node.predicate.evaluate(t))
        if isinstance(node, FusedSelect):
            # gather only the projection-referenced columns through the
            # predicate, then project
            (t,) = childs
            needed = select.needed_columns(t, node.exprs)
            choice = self._pick(
                "fused_select",
                select.make_signature(t, node.predicate, node.exprs,
                                      "eager"), m, backend)
            ft = P.apply_boolean_mask(t, predicate=node.predicate,
                                      needed=needed, choice=choice)
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
            choice = self._pick("hash_join", sig, m, backend)
            if node.how == "inner":
                lm, rm = P.inner_join(lkeys, rkeys, choice=choice)
                return Table(
                    list(P.take_table(lt, lm.data,
                                      _has_negative=False).columns) +
                    list(P.take_table(rt, rm.data,
                                      _has_negative=False).columns),
                    names=list(lt.names) + list(rt.names))
            # semi and anti joins: the build and the existence probe on the
            # card (the reference has no kernel for them), the sort-based
            # join on the CPU
            keep = (P.left_semi_join if node.how == "left_semi"
                    else P.left_anti_join)(lkeys, rkeys, choice=choice)
            return P.take_table(lt, keep.data, _has_negative=False)
        if isinstance(node, HashAggregate):
            (t,) = childs
            if not node.keys:
                return self._global_aggregate(t, node)
            aggs = [(c, o) for c, o, _ in node.aggs]
            choice = self._pick(
                "groupby", groupby_cuda.make_signature(t, aggs, "eager",
                                                       node.keys), m,
                backend)
            agg = P.groupby_aggregate(t, list(node.keys), aggs,
                                      choice=choice)
            return Table(list(agg.columns), names=schemas[id(node)])
        if isinstance(node, Sort):
            (t,) = childs
            return P.sort_table(t, list(node.keys), list(node.ascending))
        if isinstance(node, TopK):
            (t,) = childs
            sig = topk.make_signature(t, node.keys, node.ascending, node.n,
                                      "eager")
            choice = self._pick("topk", sig, m, backend)
            t = P.sort_table(t, list(node.keys), list(node.ascending),
                             limit=node.n, choice=choice,
                             words=sig.extra("words"))
            return P.slice_table(t, 0, min(node.n, t.num_rows))
        if isinstance(node, Limit):
            (t,) = childs
            return P.slice_table(t, 0, min(node.n, t.num_rows))
        if isinstance(node, Union):
            return P.concat_tables(childs)
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


    # ---- streaming scan ------------------------------------------------------

    @staticmethod
    def _stream_chains(plan: Plan, inputs) -> Dict[int, List[PlanNode]]:
        """id(tail) -> [Scan, op, ...] streamable prefixes, the reference's:
        a chain starts at a Scan bound to a streaming source and extends
        while the node has exactly one consumer that is a row-wise Filter,
        Project or FusedSelect with no scalar aggregate (those reduce over
        the whole relation); it may end in a HashAggregate whose ops
        decompose exactly (sum, count, min, max, size over a source with
        no float column: float partial sums are not reorder-exact).
        Everything else is the concatenation boundary: the tail gives one
        Table and the rest of the plan runs as it would over tables."""
        from .expr import has_scalar_agg
        parents: Dict[int, List[PlanNode]] = {}
        for n in plan.nodes:
            for c in n.children:
                parents.setdefault(id(c), []).append(n)
        chains: Dict[int, List[PlanNode]] = {}
        for scan in plan.scans:
            src = inputs.get(scan.source)
            if src is None or not _is_source(src):
                continue
            chain: List[PlanNode] = [scan]
            node: PlanNode = scan
            while True:
                ps = parents.get(id(node), [])
                if len(ps) != 1:
                    break
                p = ps[0]
                if isinstance(p, Filter) and \
                        not has_scalar_agg(p.predicate):
                    chain.append(p)
                    node = p
                    continue
                if isinstance(p, Project) and not any(
                        has_scalar_agg(e) for _, e in p.exprs):
                    chain.append(p)
                    node = p
                    continue
                if isinstance(p, FusedSelect) and \
                        not has_scalar_agg(p.predicate) and not any(
                            has_scalar_agg(e) for _, e in p.exprs):
                    chain.append(p)
                    node = p
                    continue
                if (isinstance(p, HashAggregate)
                        and all(o in _STREAM_AGG_MERGE
                                for _, o, _ in p.aggs)
                        and not _source_has_floats(src)):
                    chain.append(p)     # the tail: partial aggregation
                break
            if len(chain) > 1:
                chains[id(chain[-1])] = chain
        return chains

    def _stream_op(self, node: PlanNode, t: Table, inputs, schemas,
                   m: OperatorMetrics) -> Table:
        """One chain operator over one chunk, with the eager tier's fault
        policy (backoff-paced retries of the chunk; a breaker trip raises
        _StreamBreaker so that the caller can degrade)."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                with tracing.range_ctx(f"plan.{node.label}"):
                    self._faultinj_points((node,))
                    out = self._exec_eager_node(node, [t], inputs,
                                                schemas, m)
                    self._sync()
                break
            except _fault_surface() as err:
                if self._handle_fault(err, node.label, attempt, m):
                    attempt += 1
                    continue
                raise _StreamBreaker(err, m.retries, m.backoff_ms)
        if attempt:
            self.health.record_success(node.label)
        m.wall_ms = (m.wall_ms or 0.0) + (time.perf_counter() - t0) * 1e3
        m.rows_in += t.num_rows
        m.rows_out += out.num_rows
        return out

    def _exec_stream_chain(self, chain: List[PlanNode], inputs, schemas,
                           metrics: Dict[str, OperatorMetrics]) -> Table:
        """Run one streamable prefix a chunk at a time: row-group pruning
        at the scan, a bounded prefetch that decodes chunk N+1 and starts
        its copy while chunk N runs, each Filter/Project/FusedSelect per
        chunk, and a tail HashAggregate as per-chunk partials merged
        exactly at the end. Fills `metrics` for every chain node and
        returns the tail's Table."""
        from .optimizer import pruning_conjuncts
        scan = chain[0]
        src = inputs[scan.source]
        ms = {n.label: OperatorMetrics(label=n.label, kind=n.kind,
                                       describe=n.describe())
              for n in chain}
        sm = ms[scan.label]
        columns = (list(scan.projection) if scan.projection is not None
                   else None)
        conjuncts = (pruning_conjuncts(scan.predicate)
                     if scan.predicate is not None else [])
        kept, pruned, skipped = src.select_groups(conjuncts, columns)
        sm.io_row_groups_total = src.num_row_groups
        sm.io_row_groups_pruned = pruned
        sm.io_bytes_skipped = skipped
        agg = chain[-1] if isinstance(chain[-1], HashAggregate) else None
        body = chain[1:-1] if agg is not None else chain[1:]
        chunk_rows = src.chunk_rows or config.io_chunk_rows() or None
        if chunk_rows is None:
            # adaptive chunk sizing: with no explicit bound, size chunks
            # from this scan's observed decode throughput. The exact
            # merge makes the result independent of the chunking, so this
            # changes pacing only; an explicit bound always wins
            store = stats_mod.active_store()
            if store is not None:
                from .optimizer import subtree_fingerprints
                scan_fp = subtree_fingerprints(scan)[id(scan)]
                chunk_rows = store.suggest_chunk_rows(
                    self.device.type, scan_fp) or None
        uploader = _Uploader(self.device)
        gen = src.chunks(columns=columns, row_groups=kept,
                         chunk_rows=chunk_rows, pinned=uploader.cuda)
        depth = config.io_prefetch()
        feed = (_ChunkPrefetcher(gen, depth, uploader) if depth > 0
                else _SyncFeed(gen, uploader))
        parts: List[Table] = []         # tail outputs (or agg partials)
        empty_t: Optional[Table] = None
        proc_intervals = []
        try:
            while True:
                chunk = feed.get()
                if chunk is None:
                    break
                t0p = time.perf_counter()
                sm.rows_out += chunk.num_rows
                sm.bytes_out += chunk.nbytes()
                t = chunk
                for node in body:
                    t = self._stream_op(node, t, inputs, schemas,
                                        ms[node.label])
                    ms[node.label].bytes_out += t.nbytes()
                if agg is not None:
                    if t.num_rows == 0:
                        # a fully filtered chunk contributes nothing, and a
                        # keyless min/max over zero rows would raise where
                        # the table-bound plan succeeds: skip it, keeping
                        # one empty frame for the all-empty case
                        empty_t = t
                        proc_intervals.append((t0p, time.perf_counter()))
                        continue
                    t = self._stream_op(agg, t, inputs, schemas,
                                        ms[agg.label])
                parts.append(t)
                proc_intervals.append((t0p, time.perf_counter()))
        finally:
            feed.close()
            h2d_ms = uploader.close()
        sm.io_decode_ms = feed.decode_ms
        sm.io_h2d_ms = h2d_ms
        sm.io_overlap_ms = _interval_overlap_ms(feed.decode_intervals,
                                                proc_intervals)
        sm.wall_ms = feed.decode_ms     # the scan's wall is its decode
        # concatenate only at the first non-streamable boundary
        tail = chain[-1]
        tm = ms[tail.label]
        t0 = time.perf_counter()
        if agg is not None:
            if not parts:
                # every chunk filtered to zero rows: aggregate the empty
                # frame once, with the table-bound plan's semantics
                # (a keyless min/max error included)
                parts = [self._stream_op(agg, empty_t, inputs, schemas,
                                         ms[agg.label])]
            out = self._finalize_stream_agg(agg, parts, schemas,
                                            ms[agg.label])
            tm.rows_out = out.num_rows  # the partial rows were internal
        else:
            out = (parts[0] if len(parts) == 1
                   else plan_ops.concat_tables(parts))
        self._sync()
        tm.wall_ms = (tm.wall_ms or 0.0) + (time.perf_counter() - t0) * 1e3
        tm.bytes_out = out.nbytes()
        for n in chain:
            metrics[n.label] = ms[n.label]
        return out

    def _finalize_stream_agg(self, node: HashAggregate,
                             partials: List[Table], schemas,
                             m: OperatorMetrics) -> Table:
        """The exact merge of per-chunk partials: counts and sums sum,
        min and max reduce again, the reference's two-phase shape. The
        groupby's key-ordered output makes the merged result equal, row
        for row, to the one-pass aggregate."""
        import types
        cat = (partials[0] if len(partials) == 1
               else plan_ops.concat_tables(partials))
        merged = tuple((out, _STREAM_AGG_MERGE[o], out)
                       for _, o, out in node.aggs)
        if not node.keys:
            return self._global_aggregate(cat, types.SimpleNamespace(
                aggs=merged))
        aggs = [(c, o) for c, o, _ in merged]
        choice = self._pick(
            "groupby", groupby_cuda.make_signature(cat, aggs, "eager",
                                                   node.keys), m)
        out = plan_ops.groupby_aggregate(cat, list(node.keys), aggs,
                                         choice=choice)
        return Table(list(out.columns), names=schemas[id(node)])

    def _materialize_scan(self, node: Scan, src,
                          m: Optional[OperatorMetrics],
                          device: torch.device) -> Table:
        """A source-bound Scan outside a streamable prefix (a shared scan,
        a join input, the capped tier, the degraded tier): one admitted
        read onto `device`, still with selective decode (the projection's
        columns only) and row-group pruning."""
        from .optimizer import pruning_conjuncts
        columns = (list(node.projection) if node.projection is not None
                   else None)
        conjuncts = (pruning_conjuncts(node.predicate)
                     if node.predicate is not None else [])
        kept, pruned, skipped = src.select_groups(conjuncts, columns)
        t0 = time.perf_counter()
        t = src.read_all(columns=columns, row_groups=kept, device=device)
        if m is not None:
            m.io_row_groups_total = src.num_row_groups
            m.io_row_groups_pruned = pruned
            m.io_bytes_skipped = skipped
            m.io_decode_ms += (time.perf_counter() - t0) * 1e3
        return t

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

    @staticmethod
    def _cert_caps(plan: Plan, caps: Dict[str, int], cert):
        """Fold the certifier's sound `rows_hi` into the caps, as the
        reference's `_cert_caps` does: a starting cap tightens to the
        certified bound where that is lower (a per-node `row_cap:<i>` /
        `key_cap:<i>` entry; a sound bound cannot overflow), and the ladder
        gets a ceiling there (per node, or on the shared key at the largest
        bound of the nodes that use it; an unbounded node leaves the shared
        key without one). Returns (caps, ceiling) for
        `auto_retry_overflow(ceil=...)`, where the ceiling is advisory."""
        caps = dict(caps)
        ceil: Dict[str, int] = {}
        shared_hi: Dict[str, Optional[int]] = {"row_cap": 0, "key_cap": 0}
        for i, n in enumerate(plan.nodes):
            if isinstance(n, HashJoin) and n.how == "inner":
                which = "row_cap"
            elif isinstance(n, HashAggregate) and n.keys:
                which = "key_cap"
            else:
                continue
            b = cert.by_index.get(i)
            hi = None if b is None else b.rows_hi
            key = f"{which}:{i}"
            if key in caps:
                if hi is not None:
                    if hi < caps[key]:
                        caps[key] = hi
                    ceil[key] = max(caps[key], hi)
                continue
            cur = caps.get(which)
            if hi is not None and cur is not None and hi < cur:
                caps[key] = hi
                ceil[key] = hi
            elif shared_hi[which] is not None:
                shared_hi[which] = (None if hi is None
                                    else max(shared_hi[which], hi))
        for which, g in shared_hi.items():
            if g and which in caps:
                ceil[which] = max(g, caps[which])
        return caps, ceil

    def _execute_capped(self, plan: Plan, inputs, schemas,
                        source_fp: Optional[str] = None,
                        cert=None) -> PlanResult:
        # a capped program runs over whole tables of static shape, so
        # streaming sources materialize first, through the pruned and
        # projected read (a plan has one Scan per source, so one read per
        # name with that scan's projection and predicate loses nothing)
        scan_io: Dict[str, OperatorMetrics] = {}
        if any(_is_source(t) for t in inputs.values()):
            inputs = dict(inputs)
            by_source = {n.source: n for n in plan.nodes
                         if isinstance(n, Scan)}
            for name, v in list(inputs.items()):
                if not _is_source(v):
                    continue
                holder = OperatorMetrics(label=name, kind="Scan")
                node = by_source.get(name)
                inputs[name] = (
                    self._materialize_scan(node, v, holder, self.device)
                    if node is not None else v.read_all(device=self.device))
                scan_io[name] = holder
        caps = self._default_caps(plan, inputs)
        fp = plan.fingerprint
        for k, v in (self._caps_memo.get(fp) or {}).items():
            caps[k] = max(caps.get(k, 0), v)
        # the store's observed high-water caps of the authored plan on this
        # backend, floor only: a starting cap the ladder would reach anyway
        store = stats_mod.active_store()
        if store is not None and source_fp is not None:
            for k, v in store.observed_caps(self.device.type, source_fp,
                                            executed_fp=fp).items():
                caps[k] = max(caps.get(k, 0), v)
        cert_ceil: Dict[str, int] = {}
        if store is not None and cert is not None and config.cert_seed():
            caps, cert_ceil = self._cert_caps(plan, caps, cert)
        input_key = tuple(sorted(
            (n, tuple(t.names), t.num_rows,
             tuple((repr(c.dtype), c.validity is not None)
                   for c in t.columns))
            for n, t in inputs.items()))
        t0 = time.perf_counter()
        attempts = hits = 0
        prog: Optional[_CappedProgram] = None     # the last attempt's
        replayed = False
        last_caps = dict(caps)
        self.health.start_plan_attempt()
        if self.degrade != "off" and not self.health.admit():
            return self._execute_degraded(plan, inputs, schemas, {}, {},
                                          start=0, t_plan0=t0, mode="capped")

        def run(**caps_now):
            nonlocal attempts, hits, prog, replayed
            attempts += 1
            last_caps.clear()
            last_caps.update(caps_now)
            # the plan-level fault points, every attempt, before the
            # program is looked up: a fault leaves no program half made
            self._faultinj_points(plan.nodes)
            key = self._program_key(plan, caps_now, input_key)
            session, reservation = self._admit_attempt(key, inputs)
            try:
                prog, hit = self._capped_program(plan, key, inputs)
                hits += hit
                with tracing.range_ctx("plan.capped.attempt"):
                    out, replayed = self._run_program(plan, schemas,
                                                      caps_now, inputs, prog)
            except BaseException:
                if reservation is not None:
                    session.device.release(reservation)
                raise
            if reservation is not None:
                tie_to_outputs(session.device, reservation, out)
            return out

        retries = 0
        plan_metric = OperatorMetrics(label="plan", kind="Plan")
        while True:
            try:
                (table, valid, counts, _), final_caps = auto_retry_overflow(
                    run, caps, self.max_cap_attempts, ceil=cert_ceil)
                if retries:
                    self.health.record_success("plan")
                break
            except _fault_surface() as err:
                # one program per attempt: the sticky window keys on the
                # plan, not an operator
                if self._handle_fault(err, "plan", retries, plan_metric):
                    retries += 1
                    # resume from the grown caps: growth paid for stays
                    caps = dict(last_caps)
                    continue
                if self.degrade == "off":
                    raise
                return self._execute_degraded(
                    plan, inputs, schemas, {}, {}, start=0, t_plan0=t0,
                    mode="capped", carry_retries=plan_metric.retries,
                    carry_backoff_ms=plan_metric.backoff_ms,
                    attempts=attempts, caps=dict(last_caps))
        self._caps_memo[fp] = dict(final_caps)
        # every operator's live rows in and out: one read, after the run
        rows = counts.tolist()
        wall = (time.perf_counter() - t0) * 1e3
        metrics: Dict[str, OperatorMetrics] = {}
        # cap growths only: each of the (retries + 1) runs of the ladder
        # has a first attempt that is not an escalation
        escal = max(0, attempts - (retries + 1))
        for i, node in enumerate(plan.nodes):
            uses_cap = (isinstance(node, HashJoin) and node.how == "inner") \
                or (isinstance(node, HashAggregate) and bool(node.keys))
            choice = prog.kernels.get(i)
            metrics[node.label] = OperatorMetrics(
                label=node.label, kind=node.kind, describe=node.describe(),
                rows_in=rows[i][0], rows_out=rows[i][1],
                bytes_out=prog.bytes_out.get(i, 0),
                kernel="" if choice is None else choice.label,
                escalations=escal if uses_cap else 0)
            if isinstance(node, Scan) and node.source in scan_io:
                io, mm = scan_io[node.source], metrics[node.label]
                mm.io_row_groups_total = io.io_row_groups_total
                mm.io_row_groups_pruned = io.io_row_groups_pruned
                mm.io_bytes_skipped = io.io_bytes_skipped
                mm.io_decode_ms = io.io_decode_ms
        return PlanResult(plan, table, metrics, wall, self.device,
                          valid=valid, mode="capped", attempts=attempts,
                          caps=final_caps, jit_cache_hits=hits,
                          graph=replayed,
                          graph_reason=prog.reason or (
                              "the program's first run: kernels launched "
                              "from Python, no host read"),
                          retries=plan_metric.retries,
                          breaker=self._breaker_snapshot(),
                          backoff_ms=plan_metric.backoff_ms)

    def _program_key(self, plan: Plan, caps: Dict[str, int], input_key):
        """The program cache's key, the reference's `_jitted_capped` key:
        the plan's fingerprint (equal plans built apart share it), the
        caps, the inputs' names, shapes and column layout, and what picks
        the kernels: the device type, the kernel overrides and the stats
        store's kernel epoch."""
        store = stats_mod.active_store()
        kern_key = (self.device.type,
                    tuple(sorted(config.kernel_overrides().items())),
                    None if store is None else (store.uid,
                                                store.kernel_epoch))
        return (plan.fingerprint, tuple(sorted(caps.items())), input_key,
                kern_key)

    def _admit_attempt(self, key, inputs):
        """Reserve one capped attempt's working set from the active
        session's device budget: the program's padded node outputs where
        it has run before, else twice the inputs' bytes. (session,
        reservation), or (None, None) with no session."""
        session = get_active_session()
        if session is None:
            return None, None
        prog = self._programs.get(key)
        est = (sum(prog.bytes_out.values()) if prog is not None
               and prog.bytes_out else 2 * operand_nbytes(inputs))
        if est <= 0:
            return None, None
        return session, session.device.acquire(est)

    def _capped_program(self, plan: Plan, key, inputs):
        """(the program of `key`, whether it was cached)."""
        prog = self._programs.get(key)
        if prog is not None:
            return prog, True
        prog = _CappedProgram(self._graph_obstacle(plan, inputs))
        self._programs[key] = prog
        return prog, False

    def _graph_obstacle(self, plan: Plan, inputs) -> str:
        """Why a program of `plan` over `inputs` is never captured, or ""."""
        if self.device.type != "cuda":
            return "the CPU has no CUDA graphs"
        for n in plan.nodes:
            if not isinstance(n, Scan):
                continue
            t = inputs[n.source]
            if n.projection is not None:
                t = t.select(list(n.projection))
            for name, c in zip(t.names, t.columns):
                if c.dtype.is_string or c.dtype.is_nested:
                    return (f"{n.label} gives {c.dtype!r} column {name!r}: "
                            "its gathers read the char total on the host "
                            "(ops/gather.py _spans)")
        return ""

    def _run_program(self, plan: Plan, schemas, caps, inputs,
                     prog: _CappedProgram):
        """One attempt of `prog`: (the attempt's outputs, whether a graph
        replayed). The first run on the card launches from Python with
        every synchronising call an error; the second captures and
        replays; later runs fill the static inputs and replay. A capture
        that fails gives the program its reason, and this and every later
        run launch from Python."""
        if prog.reason:
            return self._run_capped(plan, schemas, caps, inputs, prog), False
        prog.runs += 1
        if prog.runs == 1:
            with _sync_is_error():
                return self._run_capped(plan, schemas, caps, inputs,
                                        prog), False
        if prog.graph is None:
            try:
                self._capture(plan, schemas, caps, inputs, prog)
            except Exception as e:   # the attempt itself ran at the first
                prog.reason = (      # run; what failed is the capture
                    f"its capture failed: {type(e).__name__}: {e}")
                return self._run_capped(plan, schemas, caps, inputs,
                                        prog), False
        else:
            prog.fill(inputs)
        prog.graph.replay()
        GRAPH_COUNTS["replays"] += 1
        table, alive, counts, overflow = prog.static_out
        return (_clone_table(table), alive.clone(), counts.clone(),
                overflow.clone()), True

    def _capture(self, plan: Plan, schemas, caps, inputs,
                 prog: _CappedProgram) -> None:
        """Capture one attempt of `prog` into a CUDA graph over copies of
        `inputs`, on the executor's capture stream and into its graph
        pool. Sharing the pool is safe because replays run one at a time
        on one stream and each replay's outputs are cloned out before the
        next: a block that one graph frees inside its capture may hold
        another graph's temporaries or outputs, never what a later replay
        reads before writing it."""
        dev = self.device
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
            self._graph_pool = torch.cuda.graph_pool_handle()
        static_in = {n: _clone_table(t) for n, t in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(dev)
        side = self._capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._graph_pool)
            try:
                out = self._run_capped(plan, schemas, caps, static_in, prog)
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:       # the capture is void; keep the
                    pass                # error that voided it
                raise
            graph.capture_end()
        cur.wait_stream(side)
        GRAPH_COUNTS["captures"] += 1
        prog.graph, prog.static_in, prog.static_out = graph, static_in, out

    def _run_capped(self, plan: Plan, schemas, caps, inputs,
                    prog: _CappedProgram):
        """One attempt: (root table, root alive, per-node [rows in, rows
        out] as an (n_nodes, 2) int64 device tensor, overflow as a () bool
        device tensor). Nothing here reads the device."""
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
        return root.table, root.alive, torch.stack(counts), overflow

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


def _input_has_floats(inputs: Dict) -> bool:
    """Any floating column among the bound tables and streaming sources
    (a source's unknown dtypes count as floats: the conservative direction
    for every gate that reads this)."""
    return any(_source_has_floats(t) for t in inputs.values())


def _source_has_floats(t) -> bool:
    if isinstance(t, Table):
        return any(c.dtype.is_floating for c in t.columns)
    return bool(getattr(t, "has_floats", True))


def _input_dtypes(inputs: Dict) -> Dict[str, Dict]:
    """source -> {column: DType} of the bound tables; a streaming source
    contributes nothing, as in the reference (its dtypes stay unknown to
    the certifier and the verifier)."""
    return {name: {cn: c.dtype for cn, c in zip(t.names, t.columns)}
            for name, t in inputs.items() if isinstance(t, Table)}


def _inputs_to(inputs: Dict, device: torch.device) -> Dict:
    """The bound tables on `device`; streaming sources are host handles,
    which the tier they run on re-reads."""
    return {k: t if _is_source(t) else t.to(device)
            for k, t in inputs.items()}


def bind_scan_sources(plan: Plan, inputs: Optional[Dict]) -> Dict:
    """The scan-binding prologue: a Scan carrying its own Parquet source
    needs no `inputs=` entry; an explicit entry (Table or source) for the
    same name wins."""
    inputs = dict(inputs or {})
    for s in plan.scans:
        if s.source not in inputs and s.parquet is not None:
            inputs[s.source] = s.parquet
    return inputs


def _is_source(t) -> bool:
    """A streaming (Parquet) source rather than a materialized Table."""
    return not isinstance(t, Table)


# ---- the streaming scan -------------------------------------------------------

class _StreamBreaker(Exception):
    """A streaming chain hit an unrecoverable fault (the breaker tripped):
    carries the original error and the retries and backoff already paid,
    so the degraded rerun still reports them."""

    def __init__(self, error, retries: int, backoff_ms: float):
        super().__init__(str(error))
        self.error = error
        self.retries = retries
        self.backoff_ms = backoff_ms


def _tensors(t: Table) -> List[torch.Tensor]:
    out = []

    def walk(c: Column):
        out.extend(x for x in (c.data, c.validity, c.offsets)
                   if x is not None)
        for k in c.children:
            walk(k)
    for c in t.columns:
        walk(c)
    return out


class _Uploader:
    """Moves host chunks to the executor's device.

    On the card every chunk is assembled in page-locked memory (the
    decode writes there), and its copies run on a copy stream of their
    own between two timing events, so that they overlap the previous
    chunk's kernels. The consumer's stream waits on the chunk's end event
    before any kernel reads it, and the chunk's tensors are recorded on
    that stream, since the caching allocator gave them out on the copy
    stream. A chunk's host buffers stay referenced until its end event has
    completed (`_inflight`): freed earlier, the next decode could take
    them while the copy still reads them. On the CPU a host chunk is the
    chunk."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._events: List[Tuple] = []        # (start, end) per chunk
        self._inflight: List[Tuple] = []      # (end event, host chunk)

    def upload(self, host: Table):
        """(device chunk, token); runs on the decode thread."""
        if not self.cuda:
            return host, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            start.record(self.stream)
            dev = host.to(self.device, non_blocking=True)
            end.record(self.stream)
        return dev, (start, end, host)

    def accept(self, dev: Table, token) -> Table:
        """The device chunk, safe to use on the current stream; runs on
        the executing thread."""
        if token is None:
            return dev
        start, end, host = token
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(end)
        for x in _tensors(dev):
            x.record_stream(cur)
        self._events.append((start, end))
        self._inflight.append((end, host))
        while self._inflight and self._inflight[0][0].query():
            self._inflight.pop(0)
        return dev

    @staticmethod
    def discard(token) -> None:
        """A chunk that is dropped unused: its copy completes first."""
        if token is not None:
            token[1].synchronize()

    def close(self) -> float:
        """Wait for every copy; the copies' device time in ms."""
        for end, _ in self._inflight:
            end.synchronize()
        self._inflight.clear()
        total = 0.0
        for start, end in self._events:
            end.synchronize()
            total += start.elapsed_time(end)
        return total


class _SyncFeed:
    """Prefetch off (SPARK_RAPIDS_TORCH_IO_PREFETCH=0): decode and copy
    inline on the executing thread. The surface of _ChunkPrefetcher."""

    def __init__(self, gen, uploader: _Uploader):
        self._gen = gen
        self._up = uploader
        self.decode_intervals: List[Tuple[float, float]] = []
        self.decode_ms = 0.0
        self.rows = 0

    def get(self) -> Optional[Table]:
        t0 = time.perf_counter()
        try:
            host = next(self._gen)
        except StopIteration:
            return None
        t1 = time.perf_counter()
        self.decode_intervals.append((t0, t1))
        self.decode_ms += (t1 - t0) * 1e3
        self.rows += host.num_rows
        return self._up.accept(*self._up.upload(host))

    def close(self) -> None:
        self._gen.close()


class _ChunkPrefetcher:
    """A bounded host prefetch thread: decodes chunk N+1 (up to `depth`
    ahead) and starts its copy while the executing thread runs chunk N.
    The native decode releases the GIL (`ctypes.CDLL`), so the overlap is
    real CPU concurrency."""

    _DONE = object()

    def __init__(self, gen, depth: int, uploader: _Uploader):
        import queue
        self._gen = gen
        self._up = uploader
        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = False
        self._err = None
        self.decode_intervals: List[Tuple[float, float]] = []
        self.decode_ms = 0.0
        self.rows = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="spark-rapids-torch-io-prefetch")
        self._thread.start()

    def _run(self):
        try:
            while not self._stop:
                t0 = time.perf_counter()
                try:
                    host = next(self._gen)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                self.decode_intervals.append((t0, t1))
                self.decode_ms += (t1 - t0) * 1e3
                self.rows += host.num_rows
                self._q.put(self._up.upload(host))
        except BaseException as e:       # surfaces at the consumer's get()
            self._err = e
        finally:
            self._q.put(self._DONE)

    def get(self) -> Optional[Table]:
        """The next chunk on the device, or None at the end of the
        stream. Re-raises a decode-thread error on the consumer thread."""
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            return None
        return self._up.accept(*item)

    def close(self) -> None:
        """Retire the decode thread (the consumer stopped early, or the
        stream ended): keep draining until the thread exits, so that a
        put() blocked on a full queue always wakes; then close the reader,
        whose file the degraded tier may be about to reopen."""
        import queue
        self._stop = True
        while self._thread.is_alive():
            try:
                while True:
                    item = self._q.get_nowait()
                    if item is not self._DONE:
                        self._up.discard(item[1])
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        try:
            while True:
                item = self._q.get_nowait()
                if item is not self._DONE:
                    self._up.discard(item[1])
        except queue.Empty:
            pass
        self._gen.close()


def _replay_start(plan: Plan, node_index: Dict[int, int], start: int,
                  results: Dict[int, Table]) -> int:
    """The first node the degraded tier runs: `start`, moved back until no
    node it runs needs an earlier output that was never materialized (a
    chain's interior, which ran a chunk at a time)."""
    while True:
        missing = [node_index[id(c)] for n in plan.nodes[start:]
                   for c in n.children
                   if node_index[id(c)] < start and id(c) not in results]
        if not missing:
            return start
        start = min(missing)


def _interval_overlap_ms(decode, process) -> float:
    """Total wall time in which decode intervals and processing intervals
    ran together: the prefetch's measured overlap. A linear merge: each
    list is chronological and internally non-overlapping."""
    total = 0.0
    i = j = 0
    while i < len(decode) and j < len(process):
        s1, e1 = decode[i]
        s2, e2 = process[j]
        total += max(0.0, min(e1, e2) - max(s1, s2))
        if e1 < e2:
            i += 1
        else:
            j += 1
    return total * 1e3


# HashAggregate ops that decompose into per-chunk partials and an exact
# merge over the partial rows (counts merge by summing)
_STREAM_AGG_MERGE = {"sum": "sum", "count": "sum", "size": "sum",
                     "min": "min", "max": "max"}


def _first_live(alive: torch.Tensor, n: int) -> torch.Tensor:
    """The first n live rows of `alive`, by an inclusive prefix count."""
    return alive & (torch.cumsum(alive.to(torch.int32), 0) <= n)
