"""Hash-partitioning claims of a plan's relations: the static half of the
distributed tier.

Counterpart of the partitioning transfer of `spark_rapids_tpu/plan/
distributed.py` (`transfer_part`, `part_satisfies`, `join_alignment`).
A claim is a frozenset of column-name tuples; rows equal on one of the
tuples are co-located. The verifier's partitioning layer
(`analysis/verifier.py`) re-derives every node's claim with these rules;
the mesh lowering and the optimizer's exchange planning, which follow the
same rules at run time, come with ROADMAP queue A item 13.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .expr import ColumnRef
from .nodes import (Exchange, Filter, FusedSelect, HashAggregate, HashJoin,
                    Limit, PlanNode, Project)

__all__ = ["transfer_part", "part_satisfies", "join_alignment"]


def transfer_part(node: PlanNode, child_parts: List[frozenset]) -> frozenset:
    """The hash-partitioning claim of `node`'s output given its
    children's."""
    if isinstance(node, (Filter, Limit)):
        return child_parts[0]
    if isinstance(node, (Project, FusedSelect)):
        renames = {}
        for out_name, e in node.exprs:
            if isinstance(e, ColumnRef) and e.name not in renames:
                renames[e.name] = out_name
        return frozenset(tuple(renames[c] for c in p)
                         for p in child_parts[0]
                         if all(c in renames for c in p))
    if isinstance(node, Exchange):
        if node.how == "hash":
            return frozenset({tuple(node.keys)})
        if node.how in ("broadcast", "gather"):
            return frozenset()
        return child_parts[0]
    if isinstance(node, HashJoin):
        lp = child_parts[0]
        broadcast = (isinstance(node.right, Exchange)
                     and node.right.how == "broadcast")
        if broadcast:
            # the probe side's rows never move
            return lp
        if node.how != "inner":
            # semi and anti joins keep the left relation, placed by its keys
            return frozenset({tuple(node.left_keys)})
        return frozenset({tuple(node.left_keys), tuple(node.right_keys)})
    if isinstance(node, HashAggregate):
        if not node.keys:
            return frozenset()
        # a child claim within the keys elides the exchange (rows stay,
        # so exactly those claims survive); otherwise the groups are
        # re-placed by the hash of the full key tuple
        keys = set(node.keys)
        sub = frozenset(p for p in child_parts[0] if set(p) <= keys)
        return sub if sub else frozenset({tuple(node.keys)})
    return frozenset()      # Sort/TopK (range), Union, Scan


def part_satisfies(part: frozenset, keys) -> bool:
    """Whether `part` co-locates every group of `keys`: a claimed tuple
    within the group keys suffices."""
    keyset = set(keys)
    return any(set(p) <= keyset for p in part)


def join_alignment(lpart: frozenset, rpart: frozenset, lkeys, rkeys
                   ) -> Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """The (left tuple, right tuple) under which both join sides are
    partitioned alike (the same permutation of the key pairing), so that
    matching rows are co-located; None when there is none."""
    lk, rk = tuple(lkeys), tuple(rkeys)
    for lp in lpart:
        if len(lp) != len(lk) or set(lp) != set(lk):
            continue
        rp = tuple(rk[lk.index(c)] for c in lp)
        if rp in rpart:
            return lp, rp
    return None
