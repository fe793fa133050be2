"""FusedSelect: a predicate and the stable compaction of the columns a
projection needs, in one operator. The plain PyTorch version, the
predicate's program for the kernel, and the registry's signature.

Counterpart of the wiring half of `spark_rapids_tpu/ops/select_pallas.py`
(`needed_columns`, `make_signature`, `_supports`); the CUDA kernel is in
`select_cuda.py`. `fused_select_plain` is what the eager tier's
FusedSelect computes without the kernel:
`apply_boolean_mask(table.select(needed), predicate.evaluate(table))`.
`PLAIN_CALLS` counts its runs.

`compile_predicate` alone decides which predicates the kernel takes: it
flattens the expression tree into the kernel's postfix program
(`csrc/fused_select.cu`) and raises for what the program cannot express.
Every instruction carries the dtype that `plan.expr.promote` gives its
operands, and each operand the conversion to that dtype, so the kernel
computes each value at the width and in the floating-point format
`Expr.evaluate` computes it in, and raises where it raises. The kernel
takes every bool, integer and float predicate over fixed-width columns,
64-bit integers, literal-only predicates and scalar subqueries
(`ScalarAgg`, reduced before the launch and read as a one-value column)
included, and a `*` of a bool and a float as the select `Expr.evaluate`
computes (the reference's
Pallas kernel declined all three: Mosaic has no 64-bit vectors, and its
tiles came from a column). Its limits are the program's struct: MAX_PROG
instructions over MAX_PRED_COLS distinct columns. Operands are ordered so
that the deeper subtree runs first, which keeps any program of MAX_PROG
instructions within the MAX_STACK registers of the kernel's stack.

A `Program` also carries what the kernel's launch needs of it: its
argument struct (`PredArgs`) filled but for the columns' pointers, and
whether it runs on 32-bit values. `cached_program` keeps compiled
programs, keyed by `program_key`: the predicate's structure with every
literal's type and exact value, and the dtypes of the columns it reads.
The dispatch (`make_signature`) and the kernel's wrapper compile a
predicate once; a program compiled for other dtypes or literals is never
returned.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch

from ..columnar import Table
from ..dtypes import Kind
from .gather import apply_boolean_mask

MAX_PROG, MAX_PRED_COLS, MAX_STACK = 128, 32, 8

# compacted (projection-referenced) columns: every fixed-width kind the
# reference's kernel round-trips, DECIMAL128 (16 bytes a row inside the
# kernel) and STRING (the kernel writes the kept rows' indices, and the
# wrapper gathers the strings); the reference's kernel took neither
DATA_KINDS = frozenset(k.value for k in (
    Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.DATE32, Kind.FLOAT32,
    Kind.DECIMAL32, Kind.INT64, Kind.TIMESTAMP_US, Kind.TIMESTAMP_S,
    Kind.TIMESTAMP_MS, Kind.DECIMAL64, Kind.FLOAT64, Kind.DECIMAL128,
    Kind.STRING))

PLAIN_CALLS = {"fused_select": 0}

OPCODES = {"load": 0, "lit": 1, "==": 2, "!=": 3, "<": 4, "<=": 5, ">": 6,
           ">=": 7, "&": 8, "|": 9, "+": 10, "-": 11, "*": 12, "~": 13,
           "neg": 14}
TYPES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
         torch.int64: 4, torch.float32: 5, torch.float64: 6}
COMPARES = frozenset(OPCODES[o] for o in ("==", "!=", "<", "<=", ">", ">="))
# an operand's conversion to its instruction's dtype (flags bits 0-1 for
# the left operand, 2-3 for the right): wrap an integer at a narrower
# width, an integer or bool to a float, a float64 rounded to float32
CV_NONE, CV_WRAP, CV_TO_FLOAT, CV_TO_F32 = 0, 1, 2, 3
FLAG_SWAP = 16     # the right operand was computed first: it lies below
# a `*` with one bool operand and a float result is a select on the bool
# (queue C6): bit 5 when the left operand is the bool, bit 6 the right
FLAG_SEL_L, FLAG_SEL_R = 32, 64


def fused_select_plain(table: Table, predicate, needed) -> Table:
    """The compacted `needed` columns of the rows where `predicate` holds,
    in row order, validity included."""
    PLAIN_CALLS["fused_select"] += 1
    return apply_boolean_mask(table.select(list(needed)),
                              predicate.evaluate(table))


class PredArgs(ctypes.Structure):
    """The count kernel's argument struct (csrc/fused_select.cu Pred)."""
    _fields_ = [("data", ctypes.c_void_p * MAX_PRED_COLS),
                ("width", ctypes.c_int * MAX_PRED_COLS),
                ("kind", ctypes.c_int * MAX_PRED_COLS),
                ("lit", ctypes.c_longlong * MAX_PROG),
                ("arg", ctypes.c_short * MAX_PROG),
                ("op", ctypes.c_ubyte * MAX_PROG),
                ("ty", ctypes.c_ubyte * MAX_PROG),
                ("flags", ctypes.c_ubyte * MAX_PROG),
                ("len", ctypes.c_int),
                ("ncols", ctypes.c_int),
                ("narrow", ctypes.c_int)]


@dataclasses.dataclass
class Program:
    """Postfix predicate: instructions (opcode, type code, column index,
    literal word, flags) over `columns`, needing a stack of `depth`
    values. A literal word is an integer's value or a float's float64
    bits. A column is a table column's name, or ("agg", k) for the k-th
    scalar aggregate of `scalar_aggs` (a one-value column), each of dtype
    `dtypes`. `narrow`: the kernel may evaluate it on 32-bit values;
    `args`: the bytes of its `PredArgs`, every field filled but `data`."""
    columns: list
    code: List[List[int]]
    depth: int
    narrow: bool
    args: bytes
    dtypes: List[torch.dtype]


def scalar_aggs(predicate) -> list:
    """The predicate's scalar aggregates (`ScalarAgg`), in pre-order: the
    kernel reads each as a one-value column, reduced before the launch
    (`scalar_values`)."""
    from ..plan import expr as pexpr
    out = []

    def walk(e):
        if isinstance(e, pexpr.ScalarAgg):
            out.append(e)
        elif isinstance(e, pexpr.BinOp):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, pexpr.UnaryOp):
            walk(e.child)
    walk(predicate)
    return out


def scalar_values(prog: "Program", predicate, table: Table) -> list:
    """The 0-d tensors of the program's scalar columns: each scalar
    aggregate reduced over the whole table, as `Expr.evaluate` reduces it
    (an empty table raises, as there)."""
    vals = [a.evaluate(table) for a in scalar_aggs(predicate)]
    for name, dt in zip(prog.columns, prog.dtypes):
        if isinstance(name, tuple) and vals[name[1]].dtype != dt:
            raise TypeError(f"scalar aggregate {name[1]} is "
                            f"{vals[name[1]].dtype}, the program reads {dt}")
    return vals


def _value_dtype(e, table: Table) -> Tuple[torch.dtype, bool]:
    """(dtype, weak) of `e` as `Expr.evaluate` computes it, without
    computing it."""
    from ..plan import expr as pexpr
    if isinstance(e, pexpr.ColumnRef):
        return table[e.name].data.dtype, False
    if isinstance(e, pexpr.Literal):
        dt = pexpr._literal_dtype(e.value)
        return dt, dt != torch.bool
    if isinstance(e, pexpr.BinOp):
        a, aw = _value_dtype(e.left, table)
        b, bw = _value_dtype(e.right, table)
        dt, weak = pexpr.promote(e.op, a, aw, b, bw)
        return (torch.bool, False) if e.op in pexpr._COMPARE else (dt, weak)
    if isinstance(e, pexpr.UnaryOp):
        dt, weak = _value_dtype(e.child, table)
        pexpr.unary_check(e.op, dt)
        return dt, weak
    if isinstance(e, pexpr.ScalarAgg):
        dt, weak = _value_dtype(e.child, table)
        if e.op == "sum" and not dt.is_floating_point:
            dt = torch.int64            # torch sums bool and ints in int64
        return dt, weak
    raise TypeError(f"the fused_select kernel does not evaluate {e!r}")


def _narrow(code: List[List[int]], dtypes: List[torch.dtype]) -> bool:
    """Every instruction's type at most 32 bits and every column an
    integer or bool of at most 4 bytes. Wraps and compares at those widths
    depend on the low 32 bits only, so the values are those of the 64-bit
    evaluation."""
    return (all(ty <= TYPES[torch.int32] for _, ty, _, _, _ in code)
            and all(not d.is_floating_point and d.itemsize <= 4
                    for d in dtypes))


COL_SCALAR = 4     # csrc/fused_select.cu: a one-value column


def _args(code: List[List[int]], columns, dtypes: List[torch.dtype],
          narrow: bool) -> bytes:
    p = PredArgs()
    for i, (name, d) in enumerate(zip(columns, dtypes)):
        p.width[i] = d.itemsize
        # csrc/fused_select.cu COL_*: integer, bool or float storage
        p.kind[i] = 1 if d == torch.bool else 2 if d.is_floating_point else 0
        if isinstance(name, tuple):
            p.kind[i] |= COL_SCALAR
    for k, (op, ty, arg, lit, flags) in enumerate(code):
        p.op[k], p.ty[k], p.arg[k], p.lit[k] = op, ty, arg, lit
        p.flags[k] = flags
    p.len, p.ncols, p.narrow = len(code), len(dtypes), int(narrow)
    return bytes(p)


def _type_code(dt: torch.dtype) -> int:
    try:
        return TYPES[dt]
    except KeyError:
        raise TypeError(f"the fused_select kernel evaluates bool, integer "
                        f"and float predicates, not {dt}") from None


def _conversion(d: torch.dtype, dt: torch.dtype) -> int:
    if d == dt:
        return CV_NONE
    if dt.is_floating_point:
        if not d.is_floating_point:
            return CV_TO_FLOAT
        return CV_TO_F32 if dt == torch.float32 else CV_NONE
    # an integer or bool operand of an integer instruction: a narrower one
    # is already exact at its width
    wide = d != torch.bool and torch.iinfo(d).bits > torch.iinfo(dt).bits
    return CV_WRAP if wide else CV_NONE


def _literal_word(value, dt: torch.dtype) -> int:
    """The kernel's word for a literal converted to `dt` as Expr.evaluate
    converts it (`torch.full` in the literal's own dtype, then `.to`)."""
    from ..plan import expr as pexpr
    try:
        v = torch.full((1,), value, dtype=pexpr._literal_dtype(value))
    except RuntimeError as e:                 # out of int64's range
        raise ValueError(f"literal {value!r}: {e}") from None
    v = v.to(dt)
    if dt.is_floating_point:
        return int(v.to(torch.float64).view(torch.int64)[0])
    return int(v.to(torch.int64)[0])


def compile_predicate(predicate, table: Table) -> Program:
    """The kernel's program for `predicate` over `table`'s columns. Raises
    TypeError where `Expr.evaluate` does and for expressions the program
    has no instruction for; raises ValueError for a non-bool result, an
    int literal outside int64 or a program over the kernel's limits."""
    from ..plan import expr as pexpr
    columns: list = []
    col_dtype: Dict[object, torch.dtype] = {}
    code: List[List[int]] = []
    need: Dict[int, int] = {}
    depth = [0, 0]                       # current, most
    agg_index = {id(a): k for k, a in enumerate(scalar_aggs(predicate))}

    def registers(e) -> int:
        """Stack slots e's code needs when the deeper operand runs first
        (Sethi-Ullman)."""
        if isinstance(e, pexpr.BinOp):
            a, b = registers(e.left), registers(e.right)
            r = max(a, b) if a != b else a + 1
        elif isinstance(e, pexpr.UnaryOp):
            r = registers(e.child)
        else:
            r = 1
        need[id(e)] = r
        return r

    def push():
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])

    def go(e) -> Tuple[torch.dtype, bool]:
        """Appends e's code; returns its (dtype, weak). Every value on the
        stack is exact at its own dtype."""
        if isinstance(e, (pexpr.ColumnRef, pexpr.ScalarAgg)):
            if isinstance(e, pexpr.ColumnRef):
                key, (dt, weak) = e.name, (table[e.name].data.dtype, False)
            else:
                key, (dt, weak) = (("agg", agg_index[id(e)]),
                                   _value_dtype(e, table))
            if key not in columns:
                columns.append(key)
                col_dtype[key] = dt
            code.append([OPCODES["load"], _type_code(dt),
                         columns.index(key), 0, 0])
            push()
            return dt, weak
        if isinstance(e, pexpr.Literal):
            dt = pexpr._literal_dtype(e.value)          # raises TypeError
            code.append([OPCODES["lit"], _type_code(dt), 0,
                         _literal_word(e.value, dt), 0])
            push()
            return dt, dt != torch.bool
        if isinstance(e, pexpr.BinOp):
            swap = need[id(e.right)] > need[id(e.left)]
            if swap:
                rd, rw = go(e.right)
                ri = len(code) - 1
            ld, lw = go(e.left)
            li = len(code) - 1
            if not swap:
                rd, rw = go(e.right)
                ri = len(code) - 1
            dt, weak = pexpr.promote(e.op, ld, lw, rd, rw)
            ty = _type_code(dt)
            flags = FLAG_SWAP if swap else 0
            if e.op == "*" and dt.is_floating_point and (
                    (ld == torch.bool) != (rd == torch.bool)):
                flags |= FLAG_SEL_L if ld == torch.bool else FLAG_SEL_R
            for child, d, i, shift in ((e.left, ld, li, 0),
                                       (e.right, rd, ri, 2)):
                cv = _conversion(d, dt)
                if cv and isinstance(child, pexpr.Literal):
                    # converted here, as Expr.evaluate converts it
                    code[i][1] = ty
                    code[i][3] = _literal_word(child.value, dt)
                else:
                    flags |= cv << shift      # the kernel converts it
            code.append([OPCODES[e.op], ty, 0, 0, flags])
            depth[0] -= 1
            if OPCODES[e.op] in COMPARES:
                return torch.bool, False
            return dt, weak
        if isinstance(e, pexpr.UnaryOp):
            dt, weak = go(e.child)
            pexpr.unary_check(e.op, dt)
            code.append([OPCODES["~" if e.op == "~" else "neg"],
                         _type_code(dt), 0, 0, 0])
            return dt, weak
        raise TypeError(f"the fused_select kernel does not evaluate {e!r}")

    registers(predicate)
    out, _ = go(predicate)
    if out != torch.bool:
        raise ValueError(f"a predicate must be bool, got {out}")
    # MAX_PROG instructions hold at most 64 operands, which the deeper-
    # first order evaluates in 7 slots, so the stack check cannot fire
    # before the length check
    if (len(code) > MAX_PROG or depth[1] > MAX_STACK
            or len(columns) > MAX_PRED_COLS):
        raise ValueError(f"predicate program of {len(code)} instructions, "
                         f"stack {depth[1]}, {len(columns)} columns exceeds "
                         f"the kernel's {MAX_PROG}/{MAX_STACK}/"
                         f"{MAX_PRED_COLS}")
    dtypes = [col_dtype[c] for c in columns]
    narrow = _narrow(code, dtypes)
    return Program(columns, code, depth[1], narrow,
                   _args(code, columns, dtypes, narrow), dtypes)


class _Uncached(Exception):
    """An expression the key does not describe: compile without the
    cache (compile_predicate raises for it)."""


def _structure(e) -> tuple:
    from ..plan import expr as pexpr
    if isinstance(e, pexpr.ColumnRef):
        return ("col", e.name)
    if isinstance(e, pexpr.Literal):
        v = e.value
        # a float by its bits' text, so -0.0, 0.0 and NaN stay apart
        return ("lit", type(v).__name__,
                v.hex() if isinstance(v, float) else v)
    if isinstance(e, pexpr.BinOp):
        return ("bin", e.op, _structure(e.left), _structure(e.right))
    if isinstance(e, pexpr.UnaryOp):
        return ("un", e.op, _structure(e.child))
    if isinstance(e, pexpr.ScalarAgg):
        return ("agg", e.op, _structure(e.child))
    raise _Uncached


def program_key(predicate, table: Table) -> tuple:
    """What `compile_predicate`'s program depends on: the tree, each
    literal's type and value, each read column's dtype."""
    refs = sorted(predicate.references())
    return (_structure(predicate),
            tuple((name, table[name].data.dtype) for name in refs))


_PROGRAMS: Dict[tuple, Program] = {}
_MAX_CACHED = 1024


def cached_program(predicate, table: Table) -> Program:
    """`compile_predicate(predicate, table)`, compiled once per
    `program_key`; errors are raised, not kept."""
    try:
        key = program_key(predicate, table)
    except _Uncached:
        return compile_predicate(predicate, table)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = compile_predicate(predicate, table)
        if len(_PROGRAMS) >= _MAX_CACHED:
            _PROGRAMS.clear()
        _PROGRAMS[key] = prog
    return prog


def needed_columns(table: Table, exprs) -> List[str]:
    """The columns a FusedSelect compacts: the union of projection
    references, or, for an all-literal projection, the first input column
    as the row-count carrier. One definition for the executor's dispatch
    and `make_signature`, so the signature describes exactly what the
    kernel is handed."""
    needed = sorted(set().union(*(e.references() for _, e in exprs))
                    if exprs else set())
    if not needed and table.names:
        needed = [table.names[0]]
    return needed


def make_signature(table: Table, predicate, exprs, tier: str):
    """Signature of a FusedSelect dispatch: the needed columns, with
    whether `compile_predicate` takes the predicate folded in as an extra
    (the tree itself is not hashable)."""
    from .registry import Signature
    needed = needed_columns(table, exprs)
    cols = [table[c] for c in needed if c in table.names]
    data_ok = all(c.dtype.kind.value in DATA_KINDS for c in cols)
    try:
        cached_program(predicate, table)
        pred_ok = True
    except (TypeError, ValueError):
        pred_ok = False
    return Signature.of(cols, tier=tier, predicate_ok=pred_ok,
                        data_ok=data_ok)


def supports(sig) -> bool:
    return (sig.extra("tier") == "eager"
            and bool(sig.extra("predicate_ok"))
            and bool(sig.extra("data_ok")))
