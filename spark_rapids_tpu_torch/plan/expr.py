"""Expression mini-language for plan predicates and projections.

Counterpart of `spark_rapids_tpu/plan/expr.py` for column references,
literals and the `_BIN_FNS` operators. `evaluate(table)` returns an (n,)
tensor on the table's device. Literals follow the reference's x64
promotion: a Python int is int64, a float float64, a bool bool.

Null semantics are the reference's: expressions read the data buffer only;
rows whose inputs are null must be dropped by validity-aware operators.
Scalar aggregates and the optimizer's folding helpers wait for the port of
the optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet

import torch


class Expr:
    """Base expression. Build with `col`/`lit` and python operators."""

    def references(self) -> FrozenSet[str]:
        raise NotImplementedError

    def evaluate(self, table) -> torch.Tensor:
        raise NotImplementedError

    def _bin(self, op: str, other) -> "BinOp":
        return BinOp(op, self, _wrap(other))

    def __eq__(self, other):                       # noqa: D105
        return self._bin("==", other)

    def __ne__(self, other):
        return self._bin("!=", other)

    __hash__ = None   # comparison builds expressions; not hashable

    def __lt__(self, other):
        return self._bin("<", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __ge__(self, other):
        return self._bin(">=", other)

    def __and__(self, other):
        return self._bin("&", other)

    def __or__(self, other):
        return self._bin("|", other)

    def __add__(self, other):
        return self._bin("+", other)

    def __radd__(self, other):
        return _wrap(other)._bin("+", self)

    def __sub__(self, other):
        return self._bin("-", other)

    def __rsub__(self, other):
        return _wrap(other)._bin("-", self)

    def __mul__(self, other):
        return self._bin("*", other)

    def __rmul__(self, other):
        return _wrap(other)._bin("*", self)

    def __invert__(self):
        return UnaryOp("~", self)

    def __neg__(self):
        return UnaryOp("-", self)


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnRef(Expr):
    name: str

    def references(self):
        return frozenset((self.name,))

    def evaluate(self, table):
        return table[self.name].data

    def __repr__(self):
        return self.name


def _literal_dtype(value) -> torch.dtype:
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int64
    if isinstance(value, float):
        return torch.float64
    raise TypeError(f"unsupported literal {value!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: Any

    def references(self):
        return frozenset()

    def evaluate(self, table):
        return torch.full((table.num_rows,), self.value,
                          dtype=_literal_dtype(self.value),
                          device=table.device)

    def __repr__(self):
        return repr(self.value)


_BIN_FNS = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "&": lambda a, b: a & b, "|": lambda a, b: a | b,
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
}


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def references(self):
        return self.left.references() | self.right.references()

    def evaluate(self, table):
        return _BIN_FNS[self.op](self.left.evaluate(table),
                                 self.right.evaluate(table))

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class UnaryOp(Expr):
    op: str
    child: Expr

    def references(self):
        return self.child.references()

    def evaluate(self, table):
        v = self.child.evaluate(table)
        return ~v if self.op == "~" else -v

    def __repr__(self):
        return f"{self.op}{self.child!r}"


def col(name: str) -> ColumnRef:
    """Reference a column of the input relation by name."""
    return ColumnRef(name)


def lit(value) -> Literal:
    """A literal, broadcast to the relation's length."""
    return Literal(value)
