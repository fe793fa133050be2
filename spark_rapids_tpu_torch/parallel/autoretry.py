"""Host-side SplitAndRetry: grow static capacities until the overflow
flag clears.

Counterpart of `spark_rapids_tpu/parallel/autoretry.py:30-95`
(`CapacityOverflowError`, `_grown`, `auto_retry_overflow`), a copy of its
own: the reference module imports the distributed relational ops, which the
port does not have yet. Its `distributed_*_auto` wrappers come with the
distributed tier (ROADMAP queue A item 13).

A capped operator returns an overflow flag instead of a size: too small a
capacity gives a result that is flagged, never a wrong one that is not.
`auto_retry_overflow` runs an attempt, reads the flag (the one host read of
an attempt) and, while it is set, grows every capacity geometrically and
runs again, at most `max_attempts` times.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


class CapacityOverflowError(RuntimeError):
    """Retries exhausted with the overflow flag still set."""


def _grown(caps: Dict, grow: float) -> Dict:
    out = {}
    for k, v in caps.items():
        if isinstance(v, int):
            out[k] = max(v + 1, int(v * grow))
        else:
            out[k] = v * grow
    return out


def auto_retry_overflow(attempt: Callable[..., Tuple], caps: Dict,
                        max_attempts: int = 6, grow: float = 2.0,
                        ceil: Optional[Dict] = None):
    """Run `attempt(**caps)` until its overflow flag (the last element of
    the result tuple, a bool tensor) clears, growing every capacity by
    `grow` after each attempt that overflowed.

    `ceil` clamps the growth per capacity. It is advisory: when an attempt
    that ran with a clamped capacity still overflows, or the ceiling would
    block all growth, the ceiling is dropped and the geometric ladder goes
    on, so a wrong ceiling costs an attempt, never a result.

    Returns (result tuple, final caps); raises CapacityOverflowError after
    `max_attempts` attempts that all overflowed."""
    ceil = dict(ceil or {})
    clamped_last = False
    for i in range(max_attempts):
        out = attempt(**caps)
        if not bool(torch.any(out[-1])):       # the attempt's one host read
            return out, caps
        if clamped_last:
            ceil = {}           # a clamped attempt overflowed: distrust it
            clamped_last = False
        if i + 1 < max_attempts:
            grown = _grown(caps, grow)
            if ceil:
                capped = {k: max(caps[k], min(v, ceil[k]))
                          if k in ceil and isinstance(v, int) else v
                          for k, v in grown.items()}
                if capped == caps:
                    # the ceiling blocks all growth: the same caps would
                    # overflow again, so drop it and grow now
                    ceil = {}
                    caps = grown
                else:
                    clamped_last = capped != grown
                    caps = capped
            else:
                caps = grown
    raise CapacityOverflowError(
        f"overflow persisted after {max_attempts} attempts; final caps {caps}")
