"""Host-side SplitAndRetry: grow static capacities until the overflow
flag clears.

Counterpart of `spark_rapids_tpu/parallel/autoretry.py`
(`CapacityOverflowError`, `_grown`, `auto_retry_overflow` and the
`distributed_*_auto` wrappers, which retry the distributed ops of
`relational.py` with grown `key_cap`, `row_cap` or `slack`: the same
ladder, so the same attempt counts as the reference's).

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


def distributed_groupby_auto(mesh, keys, vals, aggs, key_cap: int,
                             axis: str = "data", max_attempts: int = 6):
    """`distributed_groupby`, retried with a doubled key_cap on overflow."""
    from .relational import distributed_groupby
    out, _ = auto_retry_overflow(
        lambda key_cap: distributed_groupby(mesh, keys, vals, aggs,
                                            key_cap=key_cap, axis=axis),
        {"key_cap": key_cap}, max_attempts)
    return out


def distributed_groupby_keyed_auto(mesh, key_words, key_specs, vals, aggs,
                                   key_cap: int, axis: str = "data",
                                   max_attempts: int = 6):
    from .relational import distributed_groupby_keyed
    out, _ = auto_retry_overflow(
        lambda key_cap: distributed_groupby_keyed(
            mesh, key_words, key_specs, vals, aggs, key_cap=key_cap,
            axis=axis),
        {"key_cap": key_cap}, max_attempts)
    return out


def distributed_inner_join_auto(mesh, lkeys, lvals, rkeys, rvals,
                                row_cap: int, slack: float = 2.0,
                                axis: str = "data", max_attempts: int = 6):
    """`distributed_inner_join` growing both row_cap (join output) and
    slack (bucket spills) on overflow."""
    from .relational import distributed_inner_join
    out, _ = auto_retry_overflow(
        lambda row_cap, slack: distributed_inner_join(
            mesh, lkeys, lvals, rkeys, rvals, row_cap=row_cap, slack=slack,
            axis=axis),
        {"row_cap": row_cap, "slack": slack}, max_attempts)
    return out


def distributed_inner_join_keyed_auto(mesh, l_words, lvals, r_words, rvals,
                                      key_specs, row_cap: int,
                                      slack: float = 2.0, axis: str = "data",
                                      max_attempts: int = 6):
    from .relational import distributed_inner_join_keyed
    out, _ = auto_retry_overflow(
        lambda row_cap, slack: distributed_inner_join_keyed(
            mesh, l_words, lvals, r_words, rvals, key_specs,
            row_cap=row_cap, slack=slack, axis=axis),
        {"row_cap": row_cap, "slack": slack}, max_attempts)
    return out


def distributed_left_join_auto(mesh, lkeys, lvals, rkeys, rvals,
                               row_cap: int, slack: float = 2.0,
                               axis: str = "data", max_attempts: int = 6):
    from .relational import distributed_left_join
    out, _ = auto_retry_overflow(
        lambda row_cap, slack: distributed_left_join(
            mesh, lkeys, lvals, rkeys, rvals, row_cap=row_cap, slack=slack,
            axis=axis),
        {"row_cap": row_cap, "slack": slack}, max_attempts)
    return out


def distributed_left_join_keyed_auto(mesh, l_words, lvals, r_words, rvals,
                                     key_specs, row_cap: int,
                                     slack: float = 2.0, axis: str = "data",
                                     max_attempts: int = 6):
    from .relational import distributed_left_join_keyed
    out, _ = auto_retry_overflow(
        lambda row_cap, slack: distributed_left_join_keyed(
            mesh, l_words, lvals, r_words, rvals, key_specs,
            row_cap=row_cap, slack=slack, axis=axis),
        {"row_cap": row_cap, "slack": slack}, max_attempts)
    return out


def distributed_broadcast_join_auto(mesh, lkeys, lvals, rkeys, rvals,
                                    row_cap: int, axis: str = "data",
                                    max_attempts: int = 6):
    """A broadcast join has no shuffle to spill: only row_cap grows."""
    from .relational import distributed_broadcast_join
    out, _ = auto_retry_overflow(
        lambda row_cap: distributed_broadcast_join(
            mesh, lkeys, lvals, rkeys, rvals, row_cap=row_cap, axis=axis),
        {"row_cap": row_cap}, max_attempts)
    return out


def distributed_broadcast_join_keyed_auto(mesh, l_words, lvals, r_words,
                                          rvals, key_specs, row_cap: int,
                                          axis: str = "data",
                                          max_attempts: int = 6):
    from .relational import distributed_broadcast_join_keyed
    out, _ = auto_retry_overflow(
        lambda row_cap: distributed_broadcast_join_keyed(
            mesh, l_words, lvals, r_words, rvals, key_specs,
            row_cap=row_cap, axis=axis),
        {"row_cap": row_cap}, max_attempts)
    return out


def distributed_sort_auto(mesh, keys, vals, slack: float = 2.0,
                          axis: str = "data", max_attempts: int = 6):
    """`distributed_sort`, growing slack on overflow (key skew past the
    sample sort's balance)."""
    from .relational import distributed_sort
    out, _ = auto_retry_overflow(
        lambda slack: distributed_sort(mesh, keys, vals, slack=slack,
                                       axis=axis),
        {"slack": slack}, max_attempts)
    return out
