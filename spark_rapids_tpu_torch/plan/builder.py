"""Validating plan builder: fluent construction + whole-DAG validation.

Counterpart of `spark_rapids_tpu/plan/builder.py`. `PlanBuilder` hands out
`Rel` wrappers whose chained methods append operator nodes; `Rel.build()`
(or `Plan(root)`) validates the DAG through the verifier's schema layer and
raises `PlanValidationError` naming the offending node.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union as TUnion

from .expr import Expr
from .nodes import (Exchange, Filter, HashAggregate, HashJoin, Limit,
                    PlanNode, PlanValidationError, Project, Scan, Sort,
                    Union)

__all__ = ["Plan", "PlanBuilder", "Rel", "PlanValidationError"]


def _toposort(root: PlanNode) -> List[PlanNode]:
    """Children-first order; each DAG-shared node appears exactly once."""
    order: List[PlanNode] = []
    seen = set()
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            order.append(node)
        else:
            stack.append((node, True))
            for c in node.children:
                if id(c) not in seen:
                    stack.append((c, False))
    return order


class Plan:
    """A validated operator DAG. `schemas` maps node id -> output names for
    every node resolvable from declared scan schemas."""

    def __init__(self, root: PlanNode):
        from ..analysis import verifier
        self.root = root
        self.nodes = _toposort(root)
        self.scans = [n for n in self.nodes if isinstance(n, Scan)]
        self.schemas = verifier.check_build(self)

    def resolve_schemas(self, bound: Optional[Dict[str, Sequence[str]]] = None,
                        strict: bool = True) -> Dict[int, Tuple[str, ...]]:
        """node id -> output names, with `bound` scan schemas from the
        actual tables (cross-checked against declarations)."""
        from ..analysis import verifier
        return verifier.resolve_schemas(self.nodes, bound, strict)

    @property
    def input_names(self) -> List[str]:
        return [s.source for s in self.scans]

    def __repr__(self):
        return f"Plan({self.root.label}, {len(self.nodes)} nodes)"


class Rel:
    """Fluent wrapper over one node; every method returns a new Rel."""

    def __init__(self, node: PlanNode):
        self.node = node

    def filter(self, predicate: Expr) -> "Rel":
        return Rel(Filter(self.node, predicate))

    def project(self, exprs: TUnion[Dict[str, Expr],
                                    Sequence[Tuple[str, Expr]]]) -> "Rel":
        items = list(exprs.items()) if isinstance(exprs, dict) else list(exprs)
        return Rel(Project(self.node, tuple(items)))

    def select(self, names: Sequence[str]) -> "Rel":
        from .expr import col
        return self.project([(n, col(n)) for n in names])

    def join(self, other: "Rel", left_on: TUnion[str, Sequence[str]],
             right_on: TUnion[str, Sequence[str], None] = None,
             how: str = "inner") -> "Rel":
        lk = (left_on,) if isinstance(left_on, str) else tuple(left_on)
        if right_on is None:
            rk = lk
        else:
            rk = (right_on,) if isinstance(right_on, str) else tuple(right_on)
        return Rel(HashJoin(self.node, other.node, lk, rk, how=how))

    def aggregate(self, keys: Sequence[str],
                  aggs: Sequence[Tuple[str, str, str]]) -> "Rel":
        return Rel(HashAggregate(self.node, tuple(keys),
                                 tuple(tuple(a) for a in aggs)))

    def sort(self, keys: Sequence[str],
             ascending: TUnion[bool, Sequence[bool]] = True) -> "Rel":
        asc = ((ascending,) * len(keys) if isinstance(ascending, bool)
               else tuple(ascending))
        return Rel(Sort(self.node, tuple(keys), asc))

    def limit(self, n: int) -> "Rel":
        return Rel(Limit(self.node, n))

    def exchange(self, keys: Sequence[str] = ()) -> "Rel":
        return Rel(Exchange(self.node, tuple(keys)))

    def union(self, *others: "Rel") -> "Rel":
        return Rel(Union((self.node,) + tuple(o.node for o in others)))

    def build(self) -> Plan:
        return Plan(self.node)


class PlanBuilder:
    """Entry point: `scan()` leaves, then chain on the returned Rel."""

    def scan(self, source: str,
             schema: Optional[Sequence[str]] = None) -> Rel:
        return Rel(Scan(source, None if schema is None else tuple(schema)))

    @staticmethod
    def union(rels: Sequence[Rel]) -> Rel:
        return Rel(Union(tuple(r.node for r in rels)))
