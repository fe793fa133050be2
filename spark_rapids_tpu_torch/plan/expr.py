"""Expression mini-language for plan predicates and projections.

Counterpart of `spark_rapids_tpu/plan/expr.py` for column references,
literals, the `_BIN_FNS` operators and the optimizer's helpers (`fold`,
`substitute`, `has_scalar_agg`). `evaluate(table)` returns an (n,) tensor
on the table's device.

Literals are weakly typed, as the reference's `jnp.full` literals are under
x64 (`promote`): against a column the column's dtype wins, and the
literal's value wraps at that width (INT8 `b * 3` of 100 is 44). An int
literal against a bool column gives int64, a float literal against an
integer or bool column float64. A literal alone, or a literal-only
subtree, stays weak int64/float64 (bool literals are strong bool). The
reference's type errors are kept: `-` of two bools, `&`/`|` of floats and
unary `-` of a bool raise TypeError. A `*` with one bool operand and a
float result is the select `where(b, x, +0.0)`, as XLA computes the
reference's `jnp.multiply` (queue C6): False times NaN, inf or -0.0 is
+0.0. `fold` keeps Python's arithmetic, as the reference's fold does, so
a folded `lit(False) * lit(nan)` is NaN there and here.

Null semantics are the reference's: expressions read the data buffer only;
rows whose inputs are null must be dropped by validity-aware operators.

A scalar aggregate (`scalar_max(col("rev"))`, `ScalarAgg`) reduces its
child over the WHOLE input relation to a 0-d tensor that broadcasts into
the rest of the expression: q23's `rev > 0.95 * MAX(rev)` scalar subquery.
It stays on the tensor's device (never read to the host) and is a strong
operand, so `lit(0.95) * scalar_max(int64)` is float64 and the comparison
runs in float64, as in the reference. Like the reference it reads the
child's data only, nulls included (ROADMAP queue C records this), and an
empty relation raises ValueError for max and min. `evaluate` takes the
capped tier's `alive` mask as the reference's does; only a scalar
aggregate reads it, reducing over the live rows (dead ones take the
reduction's identity). Everything else is computed on every row, dead ones
included, and the caller masks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet, Tuple

import torch

from ..ops import aggregate


class Expr:
    """Base expression. Build with `col`/`lit` and python operators."""

    def references(self) -> FrozenSet[str]:
        raise NotImplementedError

    def evaluate(self, table, alive=None) -> torch.Tensor:
        """(n,) tensor of the expression over `table` (0-d for a bare
        scalar aggregate); `alive`, the capped tier's live-row mask, binds
        scalar aggregates only."""
        return self._eval(table, alive)[0]

    def _eval(self, table, alive=None) -> Tuple[torch.Tensor, bool]:
        """(values, weak): `weak` marks a result whose dtype yields to a
        strongly typed operand, as a weak-typed JAX array does."""
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

    def _eval(self, table, alive=None):
        c = table[self.name]
        if c.dtype.is_string or c.dtype.is_nested:
            # the reference evaluates such a column to its raw buffer
            # (spark_rapids_tpu/plan/expr.py:104-105: a STRING's chars), no
            # string semantics to port
            raise TypeError(f"{c.dtype!r} column {self.name!r} in an "
                            "expression: plan expressions take fixed-width "
                            "columns only (a stated limit: the reference "
                            "has no string or nested semantics there)")
        return c.data, False

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

    def _eval(self, table, alive=None):
        dt = _literal_dtype(self.value)
        return (torch.full((table.num_rows,), self.value, dtype=dt,
                           device=table.device), dt != torch.bool)

    def __repr__(self):
        return repr(self.value)


_COMPARE = ("==", "!=", "<", "<=", ">", ">=")
_INTS = (torch.int8, torch.int16, torch.int32, torch.int64)


def _rank(dt: torch.dtype) -> int:
    """0 bool, 1 integer, 2 floating: the categories weak typing orders."""
    return 0 if dt == torch.bool else 1 if dt in _INTS else 2


def promote(op: str, a: torch.dtype, a_weak: bool, b: torch.dtype,
            b_weak: bool) -> Tuple[torch.dtype, bool]:
    """The dtype both operands of `op` convert to, and whether the result
    is weak, by the reference's x64 rules. A weak operand takes a strong
    operand's dtype unless its category is higher (an int over a bool
    gives int64, a float over an integer or bool float64, both still
    weak); two strong or two weak operands promote as torch and JAX both
    do for these dtypes. Raises TypeError where the reference raises."""
    if a_weak == b_weak:
        dt, weak = torch.promote_types(a, b), a_weak
    else:
        (s, w) = (b, a) if a_weak else (a, b)
        if _rank(w) > _rank(s):
            dt, weak = (torch.int64 if _rank(w) == 1 else torch.float64), True
        else:
            dt, weak = s, False
    if op in ("&", "|") and dt.is_floating_point:
        raise TypeError(f"{op!r} does not accept {dt}")
    if op == "-" and dt == torch.bool:
        raise TypeError("'-' does not accept two bool operands")
    return dt, weak and op not in _COMPARE


def unary_check(op: str, dt: torch.dtype) -> None:
    if op == "-" and dt == torch.bool:
        raise TypeError("unary '-' does not accept bool")
    if op == "~" and dt.is_floating_point:
        raise TypeError(f"'~' does not accept {dt}")


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

    def _eval(self, table, alive=None):
        a, aw = self.left._eval(table, alive)
        b, bw = self.right._eval(table, alive)
        dt, weak = promote(self.op, a.dtype, aw, b.dtype, bw)
        if self.op == "*" and dt.is_floating_point and (
                (a.dtype == torch.bool) != (b.dtype == torch.bool)):
            # queue C6: XLA rewrites a bool converted to float times x into
            # a select, so a False row gives +0.0 whatever x is
            bsel, x = (a, b) if a.dtype == torch.bool else (b, a)
            return torch.where(bsel, x.to(dt), torch.zeros(
                (), dtype=dt, device=x.device)), weak
        return _BIN_FNS[self.op](a.to(dt), b.to(dt)), weak

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class UnaryOp(Expr):
    op: str
    child: Expr

    def references(self):
        return self.child.references()

    def _eval(self, table, alive=None):
        v, weak = self.child._eval(table, alive)
        unary_check(self.op, v.dtype)
        return (~v if self.op == "~" else -v), weak

    def __repr__(self):
        return f"{self.op}{self.child!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarAgg(Expr):
    """Aggregate (`op`: max, min or sum) of `child` over the whole input
    relation, a 0-d tensor broadcast into the enclosing expression; with
    `alive` it reduces over the live rows only. Float results have the
    reference's bits: its summation order (`aggregate.blocked_sum`), -0.0
    below 0.0 and the canonical NaN (`aggregate.float_extreme`)."""
    op: str                  # max | min | sum
    child: Expr

    def references(self):
        return self.child.references()

    def _eval(self, table, alive=None):
        v, weak = self.child._eval(table, alive)
        if alive is not None:
            v = torch.where(alive, v, _reduce_identity(self.op, v.dtype))
        if self.op == "sum":
            return ((aggregate.blocked_sum(v) if v.is_floating_point()
                     else v.sum()), weak)
        if v.numel() == 0:
            raise ValueError(f"zero-size array to reduction operation "
                             f"{self.op} which has no identity")
        if v.is_floating_point():
            return aggregate.float_extreme(self.op, v), weak
        return (v.max() if self.op == "max" else v.min()), weak

    def __repr__(self):
        return f"{self.op}({self.child!r})"


def _reduce_identity(op: str, dt: torch.dtype):
    """The identity of `op` over `dt`: 0 for a sum, the lowest value for a
    max and the highest for a min (the infinities for floats)."""
    if op == "sum":
        return 0
    if dt.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dt)
    return info.min if op == "max" else info.max


# ---- structural helpers (the optimizer's expression toolkit) ----------------

def _foldable(v) -> bool:
    """Folded Python arithmetic matches int64 evaluation only while the
    value fits int64; an int outside it stays unfolded, where evaluation
    wraps."""
    if isinstance(v, bool) or not isinstance(v, int):
        return True
    return -(2 ** 63) <= v < 2 ** 63


def fold(e: Expr) -> Expr:
    """Constant-fold literal-only subtrees bottom-up: `BinOp(lit, lit)` and
    `UnaryOp(lit)` become a `Literal` of the Python value, comparisons
    included, so a literal predicate reduces to `Literal(True/False)`.
    Returns `e` itself when nothing folded (callers detect a rewrite by
    identity)."""
    if isinstance(e, BinOp):
        l, r = fold(e.left), fold(e.right)
        if isinstance(l, Literal) and isinstance(r, Literal):
            v = _BIN_FNS[e.op](l.value, r.value)
            if _foldable(v):
                return Literal(v)
        if l is e.left and r is e.right:
            return e
        return BinOp(e.op, l, r)
    if isinstance(e, UnaryOp):
        c = fold(e.child)
        if isinstance(c, Literal):
            if e.op == "~":
                # Python's ~True is -2; `~` of a bool tensor is logical not
                v = (not c.value) if isinstance(c.value, bool) else ~c.value
            else:
                v = -c.value
            if _foldable(v):
                return Literal(v)
        return e if c is e.child else UnaryOp(e.op, c)
    if isinstance(e, ScalarAgg):
        # never folds itself: over a literal its value depends on the rows
        c = fold(e.child)
        return e if c is e.child else ScalarAgg(e.op, c)
    return e


def substitute(e: Expr, mapping) -> Expr:
    """Replace every `ColumnRef(name)` with `mapping[name]`: a predicate
    rewritten through a Project during pushdown. Unmapped names raise
    KeyError (callers guard with references())."""
    if isinstance(e, ColumnRef):
        return mapping[e.name]
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute(e.left, mapping),
                     substitute(e.right, mapping))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, substitute(e.child, mapping))
    if isinstance(e, ScalarAgg):
        return ScalarAgg(e.op, substitute(e.child, mapping))
    return e


def has_scalar_agg(e: Expr) -> bool:
    """Whether `e` holds a whole-relation scalar aggregate: such an
    expression is not row-wise, so the optimizer skips rewrites that change
    the row set under it (pushdown below a join or union, limit
    pushdown)."""
    if isinstance(e, ScalarAgg):
        return True
    if isinstance(e, BinOp):
        return has_scalar_agg(e.left) or has_scalar_agg(e.right)
    if isinstance(e, UnaryOp):
        return has_scalar_agg(e.child)
    return False


def col(name: str) -> ColumnRef:
    """Reference a column of the input relation by name."""
    return ColumnRef(name)


def lit(value) -> Literal:
    """A literal, broadcast to the relation's length."""
    return Literal(value)


def scalar_max(e) -> ScalarAgg:
    return ScalarAgg("max", _wrap(e))


def scalar_min(e) -> ScalarAgg:
    return ScalarAgg("min", _wrap(e))


def scalar_sum(e) -> ScalarAgg:
    return ScalarAgg("sum", _wrap(e))
