"""Static plan verifier: the schema-propagation layer.

Counterpart of the first layer of `spark_rapids_tpu/analysis/verifier.py`
(`_propagate_schemas`, `resolve_schemas`, `check_build`), with the same
error vocabulary: a `Violation` carries an invariant code and the offending
operator's label, raised as `PlanVerificationError`, which is still a
`PlanValidationError`. The builder validates through it at build time and
the executor at bind time. The dtype-typing and partitioning layers wait
for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..plan.nodes import PlanValidationError, Scan

__all__ = ["Violation", "PlanVerificationError", "check_build",
           "resolve_schemas"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: a code, the operator's label, a message."""
    invariant: str
    node: str
    message: str

    def __str__(self):
        return f"[{self.invariant}] {self.message}"


class PlanVerificationError(PlanValidationError):
    """A plan failed static verification; carries the `violations`."""

    def __init__(self, violations: List[Violation], context: str = ""):
        self.violations = list(violations)
        head = f"plan verification failed ({context}):\n" if context else ""
        super().__init__(head + "\n".join(str(v) for v in self.violations))


def _propagate_schemas(nodes, bound, strict
                       ) -> Tuple[Dict[int, Tuple[str, ...]],
                                  List[Violation]]:
    """node-id -> output names over a toposorted node list, collecting
    violations. A node whose schema cannot be derived poisons its subtree
    silently, so one authoring mistake yields one violation."""
    bound = bound or {}
    out: Dict[int, Tuple[str, ...]] = {}
    vs: List[Violation] = []
    broken = set()
    for node in nodes:
        if isinstance(node, Scan):
            schema = bound.get(node.source, node.schema)
            if schema is None and not strict:
                broken.add(id(node))
                continue
            if schema is None:
                vs.append(Violation(
                    "schema.unbound-scan", node.label,
                    f"{node.label}: input {node.source!r} is not bound "
                    f"and no schema was declared"))
                broken.add(id(node))
                continue
            schema = tuple(schema)
            if node.schema is not None and tuple(node.schema) != schema:
                vs.append(Violation(
                    "schema.binding-mismatch", node.label,
                    f"{node.label}: bound table schema {list(schema)} "
                    f"does not match declared {list(node.schema)}"))
                broken.add(id(node))
                continue
            try:
                # the cross-check above ran on the full schema; a pruned
                # projection narrows the output
                out[id(node)] = node.apply_projection(schema)
            except PlanValidationError as e:
                vs.append(Violation("schema", node.label, str(e)))
                broken.add(id(node))
            continue
        child_schemas = []
        ok = True
        for c in node.children:
            if id(c) not in out:
                ok = False
                break
            child_schemas.append(out[id(c)])
        if not ok:
            if strict and not any(id(c) in broken for c in node.children):
                vs.append(Violation(
                    "schema.unresolved", node.label,
                    f"{node.label}: child schema unresolved"))
            broken.add(id(node))
            continue
        try:
            out[id(node)] = tuple(node.output_names(child_schemas))
        except PlanValidationError as e:
            vs.append(Violation("schema", node.label, str(e)))
            broken.add(id(node))
    return out, vs


def resolve_schemas(nodes, bound=None, strict: bool = True
                    ) -> Dict[int, Tuple[str, ...]]:
    """Raising form of the schema layer (`Plan.resolve_schemas`)."""
    out, vs = _propagate_schemas(nodes, bound, strict)
    if vs:
        raise PlanVerificationError(vs)
    return out


def check_build(plan) -> Dict[int, Tuple[str, ...]]:
    """Build-time validation for `Plan.__init__`: duplicate-source check +
    non-strict schema propagation. Returns the resolvable schemas."""
    sources = [s.source for s in plan.scans]
    dup = {s for s in sources if sources.count(s) > 1}
    if dup:
        raise PlanVerificationError([Violation(
            "schema.duplicate-source", plan.root.label,
            f"multiple Scan nodes bind the same input(s) {sorted(dup)}; "
            "reuse one Scan node (the DAG executes it once)")])
    schemas, vs = _propagate_schemas(plan.nodes, None, strict=False)
    if vs:
        raise PlanVerificationError(vs)
    return schemas
