"""Per-operator execution metrics.

Counterpart of `spark_rapids_tpu/plan/metrics.py` for the fields the eager
tier of this port records: rows in and out, output bytes, wall time and the
kernel-registry stamp ("cuda:hash_join", "torch:hash_join"). The retry,
IO, distributed and placement counters wait for their tiers.
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

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def render_profile(rows: List[OperatorMetrics],
                   plan_wall_ms: Optional[float] = None,
                   device: str = "") -> str:
    """Human-readable profile table (the `profile()` text form)."""
    out = []
    if plan_wall_ms is not None:
        on = f" on {device}" if device else ""
        out.append(f"plan: {plan_wall_ms:.3f} ms{on}")
    hdr = (f"{'operator':<28} {'rows_in':>10} {'rows_out':>10} "
           f"{'bytes_out':>12} {'wall_ms':>9}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for m in rows:
        wall = f"{m.wall_ms:.3f}" if m.wall_ms is not None else "-"
        out.append(f"{m.label:<28} {m.rows_in:>10} {m.rows_out:>10} "
                   f"{m.bytes_out:>12} {wall:>9}")
        if m.kernel:
            out.append(f"  kernel: {m.kernel}")
    return "\n".join(out)
