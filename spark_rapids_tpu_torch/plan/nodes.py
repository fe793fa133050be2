"""Typed physical-plan operator nodes.

Counterpart of `spark_rapids_tpu/plan/nodes.py`. Each node is an immutable
dataclass over child nodes, together a DAG (a shared subtree executes once
per run). `output_names(child_schemas)` is the single place each operator's
schema contract lives, with the reference's messages.

All node kinds are here so plans build as in the reference; the eager
executor of this port runs Scan, Filter, Project, HashJoin, HashAggregate
and Sort, and names the ROADMAP item that ports each other kind. Scans bind
materialized tables only: parquet sources, pruning predicates and the
optimizer's projections wait for their slices.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

from .expr import Expr

JOIN_TYPES = ("inner", "left_semi", "left_anti")
AGG_OPS = ("sum", "count", "min", "max", "mean", "size")

_ids = itertools.count()


class PlanValidationError(ValueError):
    """A plan failed schema/reference validation."""


def _require(cond: bool, msg: str):
    if not cond:
        raise PlanValidationError(msg)


def _missing_msg(label: str, what: str, missing, schema) -> str:
    return f"{label}: {what} {sorted(missing)} not in {list(schema)}"


@dataclasses.dataclass(frozen=True, eq=False)
class PlanNode:
    def __post_init__(self):
        object.__setattr__(self, "_id", next(_ids))

    @property
    def kind(self) -> str:
        return type(self).__name__

    @property
    def label(self) -> str:
        return f"{self.kind}#{self._id}"

    @property
    def children(self) -> Tuple["PlanNode", ...]:
        return ()

    def output_names(self, child_schemas) -> Tuple[str, ...]:
        raise NotImplementedError

    def describe(self) -> str:
        return ""


@dataclasses.dataclass(frozen=True, eq=False)
class Scan(PlanNode):
    """Leaf: one named input relation, bound at execute() to a Table
    (`inputs={name: table}`). A declared `schema` validates at build time
    and is checked against the binding."""
    source: str
    schema: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        super().__post_init__()
        if self.schema is not None:
            object.__setattr__(self, "schema", tuple(self.schema))

    def output_names(self, child_schemas):
        _require(self.schema is not None,
                 f"{self.label}: schema for input {self.source!r} is unknown "
                 "(declare it at scan() or bind inputs)")
        return self.schema

    def describe(self):
        return self.source


@dataclasses.dataclass(frozen=True, eq=False)
class Filter(PlanNode):
    child: PlanNode
    predicate: Expr

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        (schema,) = child_schemas
        missing = self.predicate.references() - set(schema)
        _require(not missing,
                 f"{self.label}: predicate references unknown column(s) "
                 f"{sorted(missing)} (have {list(schema)})")
        return schema

    def describe(self):
        return repr(self.predicate)


def _check_exprs(label, exprs, schema):
    names = [n for n, _ in exprs]
    _require(len(set(names)) == len(names),
             f"{label}: duplicate output name in {names}")
    for n, e in exprs:
        missing = e.references() - set(schema)
        _require(not missing,
                 f"{label}: {n!r} references unknown column(s) "
                 f"{sorted(missing)} (have {list(schema)})")
    return tuple(names)


@dataclasses.dataclass(frozen=True, eq=False)
class Project(PlanNode):
    """Full projection: the output is exactly `exprs` [(name, Expr)]."""
    child: PlanNode
    exprs: Tuple[Tuple[str, Expr], ...]

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "exprs", tuple(
            (n, e) for n, e in self.exprs))

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        (schema,) = child_schemas
        return _check_exprs(self.label, self.exprs, schema)

    def describe(self):
        return ", ".join(f"{e!r} AS {n}" for n, e in self.exprs)


@dataclasses.dataclass(frozen=True, eq=False)
class FusedSelect(PlanNode):
    """Filter + Project in one operator (made by the optimizer)."""
    child: PlanNode
    predicate: Expr
    exprs: Tuple[Tuple[str, Expr], ...]

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "exprs", tuple(
            (n, e) for n, e in self.exprs))

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        (schema,) = child_schemas
        missing = self.predicate.references() - set(schema)
        _require(not missing,
                 f"{self.label}: predicate references unknown column(s) "
                 f"{sorted(missing)} (have {list(schema)})")
        return _check_exprs(self.label, self.exprs, schema)

    def describe(self):
        proj = ", ".join(f"{e!r} AS {n}" for n, e in self.exprs)
        return f"{self.predicate!r} -> {proj}"


@dataclasses.dataclass(frozen=True, eq=False)
class HashJoin(PlanNode):
    """Equi-join on key column lists. `inner` outputs left++right columns;
    semi/anti output the left columns only."""
    left: PlanNode
    right: PlanNode
    left_keys: Tuple[str, ...]
    right_keys: Tuple[str, ...]
    how: str = "inner"

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "left_keys", tuple(self.left_keys))
        object.__setattr__(self, "right_keys", tuple(self.right_keys))
        _require(self.how in JOIN_TYPES,
                 f"{self.label}: join type {self.how!r} not in {JOIN_TYPES}")
        _require(len(self.left_keys) == len(self.right_keys) > 0,
                 f"{self.label}: key lists must be equal-length and "
                 f"non-empty (got {self.left_keys} vs {self.right_keys})")

    @property
    def children(self):
        return (self.left, self.right)

    def output_names(self, child_schemas):
        lschema, rschema = child_schemas
        missing = set(self.left_keys) - set(lschema)
        _require(not missing, _missing_msg(self.label, "left key(s)",
                                           missing, lschema))
        missing = set(self.right_keys) - set(rschema)
        _require(not missing, _missing_msg(self.label, "right key(s)",
                                           missing, rschema))
        if self.how != "inner":
            return lschema
        dup = set(lschema) & set(rschema)
        _require(not dup,
                 f"{self.label}: output name collision {sorted(dup)} — "
                 "project/rename one side first")
        return lschema + rschema

    def describe(self):
        on = ", ".join(f"{l} = {r}"
                       for l, r in zip(self.left_keys, self.right_keys))
        return f"{self.how} ({on})"


@dataclasses.dataclass(frozen=True, eq=False)
class HashAggregate(PlanNode):
    """Group by `keys`, computing `aggs` [(column, op, out_name)]; empty
    `keys` is a global (one-row) aggregate. Output: keys ++ out names."""
    child: PlanNode
    keys: Tuple[str, ...]
    aggs: Tuple[Tuple[str, str, str], ...]

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "aggs", tuple(
            (c, o, n) for c, o, n in self.aggs))
        _require(len(self.aggs) > 0,
                 f"{self.label}: at least one aggregation is required")
        for c, o, n in self.aggs:
            _require(o in AGG_OPS,
                     f"{self.label}: unknown aggregation {o!r} (have "
                     f"{AGG_OPS})")
        if not self.keys:
            for c, o, n in self.aggs:
                _require(o in ("sum", "min", "max", "count", "size"),
                         f"{self.label}: global {o!r} is not supported "
                         "(sum/min/max/count/size only)")

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        (schema,) = child_schemas
        missing = set(self.keys) - set(schema)
        _require(not missing, _missing_msg(self.label, "group key(s)",
                                           missing, schema))
        for c, o, n in self.aggs:
            _require(o == "size" or c in schema,
                     f"{self.label}: aggregated column {c!r} not in "
                     f"{list(schema)}")
        names = list(self.keys) + [n for _, _, n in self.aggs]
        _require(len(set(names)) == len(names),
                 f"{self.label}: duplicate output name in {names}")
        return tuple(names)

    def describe(self):
        aggs = ", ".join(f"{o}({c}) AS {n}" for c, o, n in self.aggs)
        return f"keys=[{', '.join(self.keys)}] {aggs}"


def _sort_keys_check(node, schema):
    missing = set(node.keys) - set(schema)
    _require(not missing, _missing_msg(node.label, "sort key(s)", missing,
                                       schema))
    return schema


@dataclasses.dataclass(frozen=True, eq=False)
class Sort(PlanNode):
    child: PlanNode
    keys: Tuple[str, ...]
    ascending: Tuple[bool, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "keys", tuple(self.keys))
        asc = self.ascending
        if isinstance(asc, bool):
            asc = (asc,) * len(self.keys)
        elif not asc:
            asc = (True,) * len(self.keys)
        object.__setattr__(self, "ascending", tuple(asc))
        _require(len(self.keys) > 0, f"{self.label}: needs sort keys")
        _require(len(self.ascending) == len(self.keys),
                 f"{self.label}: ascending list must match the key count")

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        return _sort_keys_check(self, child_schemas[0])

    def describe(self):
        return ", ".join(f"{k} {'ASC' if a else 'DESC'}"
                         for k, a in zip(self.keys, self.ascending))


@dataclasses.dataclass(frozen=True, eq=False)
class TopK(PlanNode):
    """Sort + Limit in one operator (made by the optimizer)."""
    child: PlanNode
    keys: Tuple[str, ...]
    ascending: Tuple[bool, ...]
    n: int

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "ascending", tuple(self.ascending))
        _require(len(self.keys) > 0, f"{self.label}: needs sort keys")
        _require(len(self.ascending) == len(self.keys),
                 f"{self.label}: ascending list must match the key count")
        _require(self.n >= 0, f"{self.label}: negative limit {self.n}")

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        return _sort_keys_check(self, child_schemas[0])

    def describe(self):
        keys = ", ".join(f"{k} {'ASC' if a else 'DESC'}"
                         for k, a in zip(self.keys, self.ascending))
        return f"top {self.n} by {keys}"


@dataclasses.dataclass(frozen=True, eq=False)
class Limit(PlanNode):
    child: PlanNode
    n: int

    def __post_init__(self):
        super().__post_init__()
        _require(self.n >= 0, f"{self.label}: negative limit {self.n}")

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        return child_schemas[0]

    def describe(self):
        return str(self.n)


@dataclasses.dataclass(frozen=True, eq=False)
class Union(PlanNode):
    """UNION ALL of same-schema inputs (by name, positional)."""
    inputs: Tuple[PlanNode, ...]

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "inputs", tuple(self.inputs))
        _require(len(self.inputs) >= 2,
                 f"{self.label}: needs at least two inputs")

    @property
    def children(self):
        return self.inputs

    def output_names(self, child_schemas):
        first = child_schemas[0]
        for s in child_schemas[1:]:
            _require(tuple(s) == tuple(first),
                     f"{self.label}: input schemas differ: {list(first)} vs "
                     f"{list(s)}")
        return first

    def describe(self):
        return f"{len(self.inputs)} inputs"


EXCHANGE_KINDS = ("hash", "broadcast", "gather", "identity")


@dataclasses.dataclass(frozen=True, eq=False)
class Exchange(PlanNode):
    """Distribution boundary of the distributed tier."""
    child: PlanNode
    keys: Tuple[str, ...] = ()
    how: str = ""

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "keys", tuple(self.keys))
        if not self.how:
            object.__setattr__(self, "how",
                               "hash" if self.keys else "identity")
        _require(self.how in EXCHANGE_KINDS,
                 f"{self.label}: exchange kind {self.how!r} not in "
                 f"{EXCHANGE_KINDS}")
        _require(self.how != "hash" or len(self.keys) > 0,
                 f"{self.label}: hash exchange needs partition keys")

    @property
    def children(self):
        return (self.child,)

    def output_names(self, child_schemas):
        (schema,) = child_schemas
        missing = set(self.keys) - set(schema)
        _require(not missing, _missing_msg(self.label, "partition key(s)",
                                           missing, schema))
        return schema

    def describe(self):
        if self.how == "hash":
            return f"hash[{', '.join(self.keys)}]"
        return self.how
