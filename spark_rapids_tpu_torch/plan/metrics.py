"""Per-operator execution metrics.

Counterpart of `spark_rapids_tpu/plan/metrics.py` for the fields the eager
and capped tiers of this port record: rows in and out, output bytes, wall
time, the kernel-registry stamp ("cuda:hash_join", "cuda:fused_select" and
"cuda:topk" for the hand-written kernels, "torch:<op>" for their plain
fallbacks) and, in the capped tier, `escalations`: the cap growths charged
to an operator that has a capacity (an inner HashJoin, a keyed
HashAggregate). In the capped tier rows are live rows, counted on the
device and read once after the run, bytes those of the padded frames, and
wall time is the plan's only. The profile text carries the optimizer's
line with its decision sources, the certifier's footprint line, and the
capped tier's attempts, caps and graph replay. The recovery counters are
the reference's: `retries` (an operator re-run after an injected fault or
a RetryOOM), `backoff_ms` (the time backed off before them) and
`degraded` (the operator ran on the degraded CPU tier); a degraded plan's
profile says so in a DEGRADED line with the breaker's state. A Scan bound
to a Parquet source carries the reference's IO counters: row groups in
the file and pruned by footer statistics, compressed bytes never decoded,
the host decode time and its overlap with execution; the port adds the
host-to-device copy time (`io_h2d_ms`, CUDA events on the copy stream;
0.0 on the CPU). The distributed tier's counters are the reference's:
`sharding` (the output's distribution: "rows@P", "hash[k]@P",
"replicated@P" or "local"), `n_peers`, `exchange_how` (hash, broadcast,
gather, or "range" for the sample sort's exchange), `exchange_bytes` (the
wire form, live payload only, each edge once, a broadcast x (P - 1)),
`exchange_bytes_logical` (the unpacked payload), `exchange_codecs` and
`exchange_overlap_ms` (an async exchange's transfer time that ran beside
other plan work); the profile renders them on a `dist:` line. The
placement counters wait for ROADMAP queue A item 14.

The executor also opens a `utils.tracing.range_ctx("plan.<label>")`
around every eager operator (and `plan.capped.attempt` around every
capped attempt), so the same names appear in a `torch.profiler` trace
when SPARK_RAPIDS_TORCH_TRACE=1, with the card's kernels linked to the
operator that launched them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class OperatorMetrics:
    label: str                 # node label, e.g. HashJoin#3
    kind: str                  # node kind, e.g. HashJoin
    describe: str = ""         # the node's parameter summary
    rows_in: int = 0           # input rows (sum over children)
    rows_out: int = 0          # output rows
    bytes_out: int = 0         # output buffer bytes (data + validity)
    wall_ms: Optional[float] = None   # per-op wall time
    kernel: str = ""           # registry choice, "" without a dispatch
    escalations: int = 0       # cap growths charged to this node (capped)
    retries: int = 0           # re-runs after injected faults or RetryOOM
    backoff_ms: float = 0.0    # time backed off before those re-runs
    degraded: bool = False     # ran on the degraded CPU tier
    # streaming-scan counters (a Scan bound to a Parquet source)
    io_row_groups_total: int = 0
    io_row_groups_pruned: int = 0
    io_bytes_skipped: int = 0      # compressed chunk bytes never decoded
    io_decode_ms: float = 0.0      # host decode, summed over chunks
    io_overlap_ms: float = 0.0     # decode concurrent with execution
    io_h2d_ms: float = 0.0         # host-to-device copies, on the card
    # the distributed tier (plan/distributed.py)
    sharding: str = ""
    exchange_how: str = ""
    exchange_bytes: int = 0            # bytes on the wire (packed form)
    exchange_bytes_logical: int = 0    # unpacked payload bytes
    exchange_codecs: str = ""
    exchange_overlap_ms: float = 0.0
    n_peers: int = 0               # mesh size the operator ran over

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        # both byte counts under explicit names: `exchange_bytes` is the
        # wire form
        d["exchange_bytes_wire"] = self.exchange_bytes
        return d


def render_profile(rows: List[OperatorMetrics],
                   plan_wall_ms: Optional[float] = None,
                   device: str = "",
                   optimizer: Optional[Dict] = None,
                   attempts: int = 1,
                   caps: Optional[Dict] = None,
                   jit_cache_hits: int = 0, cert=None,
                   graph: bool = False, degraded: bool = False,
                   breaker: Optional[Dict] = None) -> str:
    """Human-readable profile table (the `profile()` text form)."""
    out = []
    if plan_wall_ms is not None:
        on = f" on {device}" if device else ""
        caps_s = f", {attempts} attempt(s) caps={caps}" if caps else ""
        hits_s = (f", {jit_cache_hits} program cache hit(s)"
                  if jit_cache_hits else "")
        graph_s = ", CUDA graph replayed" if graph else ""
        out.append(f"plan: {plan_wall_ms:.3f} ms{on}{caps_s}{hits_s}"
                   f"{graph_s}")
    if cert is not None:
        peak = ("unbounded" if cert.peak_bytes_hi is None
                else f"{cert.peak_bytes_hi} B")
        root_rows = ("unbounded" if cert.root.rows_hi is None
                     else str(cert.root.rows_hi))
        ub = (f", {len(cert.unbounded)} op(s) unbounded"
              if cert.unbounded else "")
        out.append(f"footprint: peak resident <= {peak} certified, "
                   f"root rows <= {root_rows}{ub}")
    if optimizer is not None:
        fired = optimizer.get("rules_fired") or {}
        pruned = optimizer.get("pruned_columns", 0)
        out.append(f"optimizer: rules_fired={fired or 'none'}"
                   + (f", pruned {pruned} column(s) "
                      f"(~{optimizer.get('pruned_bytes_est', 0)} B est)"
                      if pruned else "")
                   + f", fingerprint={optimizer.get('fingerprint', '')}")
        sources = optimizer.get("decision_sources") or {}
        tag = " [STATS REVERTED]" if optimizer.get("stats_reverted") else ""
        for key, src in sorted(sources.items()):
            out.append(f"  decision {key}: {src}{tag}")
    if degraded:
        reason = (breaker or {}).get("reason")
        state = (breaker or {}).get("state", "open")
        out.append(f"DEGRADED: breaker {state}"
                   f"{f' ({reason})' if reason else ''}; "
                   "plan completed on the CPU tier")
    hdr = (f"{'operator':<28} {'rows_in':>10} {'rows_out':>10} "
           f"{'bytes_out':>12} {'wall_ms':>9} {'retry':>5} "
           f"{'backoff':>8} {'deg':>4}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for m in rows:
        wall = f"{m.wall_ms:.3f}" if m.wall_ms is not None else "-"
        out.append(f"{m.label:<28} {m.rows_in:>10} {m.rows_out:>10} "
                   f"{m.bytes_out:>12} {wall:>9} {m.retries:>5} "
                   f"{m.backoff_ms:>8.1f} "
                   f"{'yes' if m.degraded else '-':>4}")
        if m.kernel:
            out.append(f"  kernel: {m.kernel}")
        if m.escalations:
            out.append(f"  escalations: {m.escalations}")
        if m.io_row_groups_total:
            kept = m.io_row_groups_total - m.io_row_groups_pruned
            out.append(f"  io: row groups {kept}/{m.io_row_groups_total} "
                       f"({m.io_row_groups_pruned} pruned), "
                       f"{m.io_bytes_skipped} B skipped, "
                       f"decode {m.io_decode_ms:.3f} ms, "
                       f"h2d {m.io_h2d_ms:.3f} ms, "
                       f"overlap {m.io_overlap_ms:.3f} ms")
        if m.sharding or m.exchange_how:
            parts = []
            if m.sharding:
                parts.append(f"sharding {m.sharding}")
            if m.exchange_how:
                ex = (f"exchange {m.exchange_how} "
                      f"{m.exchange_bytes} B moved")
                if m.exchange_bytes_logical and \
                        m.exchange_bytes_logical != m.exchange_bytes:
                    ex += f" ({m.exchange_bytes_logical} B logical)"
                parts.append(ex)
            if m.exchange_codecs:
                parts.append(f"codecs {m.exchange_codecs}")
            if m.exchange_overlap_ms:
                parts.append(f"overlap {m.exchange_overlap_ms:.3f} ms")
            out.append(f"  dist: {', '.join(parts)}")
    return "\n".join(out)
