"""FusedSelect in the port against the JAX package: the plain version
against `select_pallas.fused_select_compact` (Pallas interpret mode) and
against `apply_boolean_mask`, bit for bit with validity and row order, on
the cases of tests/test_kernel_registry.py; the CUDA kernel's predicate
program (run here with torch ops, as the kernel runs it) against
`Expr.evaluate`; the registry's declines against `select_pallas._supports`:
the port's kernel takes every predicate the reference's takes, and also
64-bit integer and float predicates, int literals outside int32 and
literal-only predicates; the program cache, keyed on the tree, its
literals and the column dtypes."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu.ops import apply_boolean_mask as japply
from spark_rapids_tpu.ops import select_pallas
from spark_rapids_tpu.plan import expr as jexpr

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.ops import select, select_cuda
from spark_rapids_tpu_torch.ops.registry import REGISTRY
from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
from spark_rapids_tpu_torch.plan import expr as texpr
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

_FS_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.float32,
              np.float64, np.bool_]


def _fs_arrays(n=700, seed=0, with_nulls=True):
    """test_kernel_registry.py's `_fs_table`, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, dt in enumerate(_FS_DTYPES):
        if dt is np.bool_:
            arr = rng.integers(0, 2, n).astype(bool)
        elif np.issubdtype(dt, np.floating):
            arr = rng.standard_normal(n).astype(dt)
            arr[rng.random(n) < 0.05] = np.nan
        else:
            info = np.iinfo(dt)
            arr = rng.integers(info.min, info.max, n, dtype=dt,
                               endpoint=True)
        valid = (rng.random(n) > 0.15) if (with_nulls and i % 2) else None
        out[f"c_{np.dtype(dt).name}"] = (arr, valid)
    out["sel"] = (rng.integers(0, 50, n).astype(np.int32), None)
    return out


def _tables(arrays):
    jt = JTable([JColumn.from_numpy(a, validity=v)
                 for a, v in arrays.values()], names=list(arrays))
    tt = table_from_numpy(
        list(arrays), [a for a, _ in arrays.values()],
        [v for _, v in arrays.values()],
        ["bool" if a.dtype == np.bool_ else a.dtype.name
         for a, _ in arrays.values()], device="cpu")
    return jt, tt


def _assert_same(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert jc.dtype.kind.value == tc.dtype.kind.value
        data, valid = tc.to_numpy()
        npt.assert_array_equal(np.asarray(jc.data), data)
        jv = None if jc.validity is None else np.asarray(jc.validity)
        nj = np.zeros(jt.num_rows, bool) if jv is None else ~jv
        nt = np.zeros(tt.num_rows, bool) if valid is None else ~valid
        npt.assert_array_equal(nj, nt)


def _pred(m, which):
    col, lit = m.col, m.lit
    return {
        "or": (col("sel") < 25) | (col("sel") > 48),
        "eq": col("sel") == 7,
        "arith": (col("sel") + 3) * 2 > 40,
        "not_and_or": ~(col("sel") >= 10) & (col("c_bool") |
                                             (col("sel") != 3)),
        "sub_lit": col("sel") - 60 < lit(-30),
        "int8_wrap": (col("c_int8") + 100) > 50,
        "int32_wrap": col("c_int32") * 3 < col("c_int32"),
        "int64": (col("c_int64") > 0) & (col("sel") < 10),
        "none": col("sel") > 10 ** 6,
    }[which]


_FLOATS = {select.TYPES[torch.float32]: torch.float32,
           select.TYPES[torch.float64]: torch.float64}


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float64).view(torch.int64)


def _wrap(v: torch.Tensor, ty: int) -> torch.Tensor:
    dt = {v: k for k, v in select.TYPES.items()}[ty]
    return (v != 0).to(torch.int64) if ty == 0 else v.to(dt).to(torch.int64)


def _eval_program(prog, table, pred) -> torch.Tensor:
    """(n,) bool: the program run as csrc/fused_select.cu runs it, every
    value in 64 bits (floats as their float64 bits), operands converted
    where the instruction's flags say, integer results wrapped to its
    width, float32 arithmetic in float32; a scalar aggregate's column
    holds its one value in every row."""
    n = table.num_rows
    st = []
    names = {v: k for k, v in select.OPCODES.items()}
    scalars = select.scalar_values(prog, pred, table)
    for op, ty, arg, word, flags in prog.code:
        name = names[op]
        if name == "load":
            col = prog.columns[arg]
            d = (scalars[col[1]].expand(n) if isinstance(col, tuple)
                 else table[col].data)
            st.append(_bits(d) if d.is_floating_point()
                      else d.to(torch.int64))
        elif name == "lit":
            st.append(torch.full((n,), word, dtype=torch.int64))
        elif name == "~":
            v = st.pop()
            st.append((v == 0).to(torch.int64) if ty == 0 else ~v)
        elif name == "neg":
            v = st.pop()
            st.append(_bits(-v.view(torch.float64)) if ty in _FLOATS
                      else _wrap(-v, ty))
        else:
            s0, s1 = st.pop(), st.pop()
            a, b = (s0, s1) if flags & select.FLAG_SWAP else (s1, s0)
            conv = []
            for v, cv in ((a, flags & 3), (b, (flags >> 2) & 3)):
                if cv == select.CV_WRAP:
                    v = _wrap(v, ty)
                elif cv == select.CV_TO_FLOAT:
                    v = _bits(v.to(_FLOATS[ty]))
                elif cv == select.CV_TO_F32:
                    v = _bits(v.view(torch.float64).to(torch.float32))
                conv.append(v)
            a, b = conv
            fn = texpr._BIN_FNS[name]
            if flags & (select.FLAG_SEL_L | select.FLAG_SEL_R):
                # queue C6: `*` of a bool and a float selects on the bool
                c, x = (a, b) if flags & select.FLAG_SEL_L else (b, a)
                st.append(torch.where(c != 0, x, torch.zeros_like(x)))
            elif ty in _FLOATS:
                x = a.view(torch.float64).to(_FLOATS[ty])
                y = b.view(torch.float64).to(_FLOATS[ty])
                r = fn(x, y)
                st.append(r.to(torch.int64) if op in select.COMPARES
                          else _bits(r))
            else:
                r = fn(a, b)
                st.append(r.to(torch.int64) if op in select.COMPARES
                          else _wrap(r, ty))
    return st[0] != 0


def _same_as_evaluate(pred, tt):
    prog = select.compile_predicate(pred, tt)
    assert prog.depth <= select.MAX_STACK
    assert torch.equal(_eval_program(prog, tt, pred), pred.evaluate(tt))
    return prog


def _check(arrays, which, needed, pallas=True):
    jt, tt = _tables(arrays)
    jp, tp = _pred(jexpr, which), _pred(texpr, which)
    got = select.fused_select_plain(tt, tp, needed)
    _assert_same(japply(jt.select(needed), jp.evaluate(jt)), got)
    if pallas:
        _assert_same(select_pallas.fused_select_compact(
            jt, jp, needed, block_rows=256), got)
    # the kernel's program, run as the kernel runs it
    _same_as_evaluate(tp, tt)
    return got


@pytest.mark.parametrize("with_nulls", [False, True])
def test_dtype_matrix_matches_pallas(with_nulls):
    arrays = _fs_arrays(with_nulls=with_nulls)
    needed = [n for n in arrays if n != "sel"]
    got = _check(arrays, "or", needed)
    assert 0 < got.num_rows < 700


@pytest.mark.parametrize("which", ["eq", "arith", "not_and_or", "sub_lit"])
def test_predicate_shapes_match_pallas(which):
    _check(_fs_arrays(), which, ["c_int64"])


@pytest.mark.parametrize("which", ["int8_wrap", "int32_wrap", "int64"])
def test_wrapping_and_64_bit_predicates(which):
    # the Pallas kernel takes the wrap cases; 64-bit predicates only the
    # port's kernel takes, so they compare with the mask path alone
    _check(_fs_arrays(), which, ["c_int64", "c_bool"],
           pallas=which != "int64")


def test_literal_weak_typing_parity():
    rng = np.random.default_rng(12)
    n = 400
    arrays = {"b": (rng.integers(-128, 127, n, dtype=np.int8,
                                 endpoint=True), None),
              "v": (np.arange(n, dtype=np.int64), None)}
    jt, tt = _tables(arrays)
    jp = (jexpr.col("b") + 100) > 50          # wraps in int8 near the top
    tp = (texpr.col("b") + 100) > 50
    got = select.fused_select_plain(tt, tp, ["v"])
    _assert_same(select_pallas.fused_select_compact(jt, jp, ["v"],
                                                    block_rows=256), got)
    _same_as_evaluate(tp, tt)
    # a literal-only predicate, which the optimizer folds and the
    # reference's kernel declines: the port's kernel evaluates it as well
    folded_away = texpr.BinOp(">", texpr.BinOp("+", texpr.Literal(2),
                                               texpr.Literal(3)),
                              texpr.Literal(4))
    sig = select.make_signature(tt, folded_away, (("v", texpr.col("v")),),
                                "eager")
    assert select.supports(sig)
    _same_as_evaluate(folded_away, tt)


_C6_PREDS = {
    "b*f==0": lambda m: m.col("c_bool") * m.col("c_float64") == 0.0,
    "f*b<=0": lambda m: m.col("c_float64") * m.col("c_bool") <= m.lit(0.0),
    "b*f32==0": lambda m: m.col("c_bool") * m.col("c_float32") == 0.0,
    "lit_false*f==0": lambda m: m.lit(False) * m.col("c_float64") == 0.0,
    "(b*nan)!=(b*nan)": lambda m: (m.col("c_bool") * m.lit(float("nan")))
    != (m.col("c_bool") * m.lit(float("nan"))),
    "b*f32+1>0": lambda m: m.col("c_bool") * m.col("c_float32") + 1.0 > 0,
}


@pytest.mark.parametrize("which", sorted(_C6_PREDS))
def test_bool_times_float_predicates_match_jax(which):
    """Queue C6 through a FusedSelect: the float columns hold NaN, ±inf
    and -0.0, and `*` of a bool and a float is where(b, x, +0.0) in the
    plain version, in the kernel's program (FLAG_SEL_L/R) and in JAX."""
    arrays = _fs_arrays(n=64, seed=6)
    for name in ("c_float32", "c_float64"):
        a = arrays[name][0].copy()
        a[:8] = [np.nan, np.inf, -np.inf, -0.0, np.nan, np.inf, -np.inf,
                 -0.0]
        arrays[name] = (a, arrays[name][1])
    b = arrays["c_bool"][0].copy()
    b[:8] = [False] * 4 + [True] * 4
    arrays["c_bool"] = (b, None)
    jt, tt = _tables(arrays)
    jp, tp = _C6_PREDS[which](jexpr), _C6_PREDS[which](texpr)
    needed = ["c_float64", "c_float32", "sel"]
    got = select.fused_select_plain(tt, tp, needed)
    _assert_same(japply(jt.select(needed), jp.evaluate(jt)), got)
    prog = _same_as_evaluate(tp, tt)
    flags = [f for *_, f in prog.code]
    assert any(f & (select.FLAG_SEL_L | select.FLAG_SEL_R) for f in flags)


_SCALAR_PREDS = {
    "int_gt_max": lambda m: m.col("sel") > m.scalar_max(m.col("sel")) - 5,
    "f64_le_min": lambda m: m.col("c_float64")
    <= m.scalar_min(m.col("c_float64")) + 1.0,
    "f32_sum": lambda m: m.col("c_float32") * 100.0
    > m.scalar_sum(m.col("c_float32")),
    "int8_sum_wide": lambda m: m.col("c_int8")
    < m.scalar_sum(m.col("c_int8")),
    "bool_max_and": lambda m: m.scalar_max(m.col("c_bool"))
    & (m.col("sel") < 9),
    "q23_shape": lambda m: m.col("c_int64")
    > m.lit(0.95) * m.scalar_max(m.col("c_int64")),
    "two_aggs": lambda m: (m.col("sel") >= m.scalar_min(m.col("sel")))
    & (m.col("sel") * 2 > m.scalar_max(m.col("sel") + 1)),
}


@pytest.mark.parametrize("which", sorted(_SCALAR_PREDS))
def test_scalar_subquery_predicates_match_jax(which):
    """A scalar subquery in a FusedSelect predicate (the fuzz corpus draws
    them): the kernel's program reads each `ScalarAgg` as a one-value
    column reduced before the launch; the plain version, the program and
    JAX agree, and the registry takes the predicate."""
    arrays = _fs_arrays(n=300, seed=9)
    jt, tt = _tables(arrays)
    jm = type("M", (), {"col": staticmethod(jexpr.col),
                        "lit": staticmethod(jexpr.lit),
                        "scalar_max": staticmethod(jexpr.scalar_max),
                        "scalar_min": staticmethod(jexpr.scalar_min),
                        "scalar_sum": staticmethod(jexpr.scalar_sum)})
    jp, tp = _SCALAR_PREDS[which](jm), _SCALAR_PREDS[which](texpr)
    needed = ["sel", "c_float64"]
    got = select.fused_select_plain(tt, tp, needed)
    _assert_same(japply(jt.select(needed), jp.evaluate(jt)), got)
    prog = _same_as_evaluate(tp, tt)
    aggs = select.scalar_aggs(tp)
    assert sum(isinstance(c, tuple) for c in prog.columns) == len(aggs)
    assert select.supports(select.make_signature(
        tt, tp, (("x", texpr.col("sel")),), "eager"))
    # cached on the structure: an equal tree elsewhere reuses the program
    assert select.cached_program(_SCALAR_PREDS[which](texpr), tt) is \
        select.cached_program(tp, tt)


def test_all_dead_and_empty():
    got = _check(_fs_arrays(), "none", ["c_int32"])
    assert got.num_rows == 0
    arrays = {"a": (np.zeros(0, np.int32), None)}
    jt, tt = _tables(arrays)
    got = select.fused_select_plain(tt, texpr.col("a") > 0, ["a"])
    ref = select_pallas.fused_select_compact(jt, jexpr.col("a") > 0, ["a"],
                                             block_rows=256)
    _assert_same(ref, got)
    assert got["a"].dtype == tdt.INT32


def _decline_cases(m):
    col = m.col
    return [
        ("sel", col("sel") > 0, "eager"),
        ("float64 predicate", col("c_float64") > 0.0, "eager"),
        ("float literal", col("sel") > 0.5, "eager"),
        ("int64 predicate", col("c_int64") > 0, "eager"),
        ("int64 and wide literal", col("c_int64") > 2 ** 40, "eager"),
        ("int32 and wide literal", col("sel") > 2 ** 40, "eager"),
        ("capped tier", col("sel") > 0, "capped"),
        ("literal predicate", m.lit(True) & m.lit(False), "eager"),
        ("bool column", col("c_bool") | (col("c_int8") < 0), "eager"),
    ]


# the predicates the port's kernel takes and the reference's declines
_WIDENED = {"float64 predicate", "float literal", "int64 predicate",
            "int64 and wide literal", "int32 and wide literal",
            "literal predicate"}


def test_declines_match_the_reference_but_64_bit():
    arrays = _fs_arrays(n=50)
    jt, tt = _tables(arrays)
    for (what, jp, tier), (_, tp, _) in zip(_decline_cases(jexpr),
                                            _decline_cases(texpr)):
        exprs_j = (("x", jexpr.col("c_int32")),)
        exprs_t = (("x", texpr.col("c_int32")),)
        ref = select_pallas._supports(select_pallas.make_signature(
            jt, jp, exprs_j, tier))
        got = select.supports(select.make_signature(tt, tp, exprs_t, tier))
        assert got == (True if what in _WIDENED else ref), what
        assert ref == (what not in _WIDENED and tier == "eager"), what
        ch = REGISTRY.select("fused_select", select.make_signature(
            tt, tp, exprs_t, tier), backend="cuda")
        assert ch.fallback != got
        assert ch.label == ("cuda:fused_select" if got
                            else "torch:fused_select")


def test_program_raises_as_evaluate_does():
    arrays = _fs_arrays(n=20)
    _, tt = _tables(arrays)
    for bad in (texpr.col("c_bool") - texpr.col("c_bool"),
                -texpr.col("c_bool") > 0):
        with pytest.raises(TypeError):
            bad.evaluate(tt)
        with pytest.raises(TypeError):
            select.compile_predicate(bad, tt)
    with pytest.raises(ValueError, match="must be bool"):
        select.compile_predicate(texpr.col("sel") + 1, tt)
    for bad in ((texpr.col("c_float32") > 0) & texpr.col("c_float64"),
                ~texpr.col("c_float32") > 0):
        with pytest.raises(TypeError):
            bad.evaluate(tt)
        with pytest.raises(TypeError):
            select.compile_predicate(bad, tt)
    huge = texpr.col("c_int64") > 2 ** 63
    with pytest.raises(RuntimeError):
        huge.evaluate(tt)
    with pytest.raises(ValueError, match="literal"):
        select.compile_predicate(huge, tt)
    assert not select.supports(select.make_signature(
        tt, huge, (("x", texpr.col("sel")),), "eager"))


@pytest.mark.parametrize("tree", [
    # a weak int64 intermediate meets an int8 column: the kernel wraps it
    lambda c, l: ((c("c_bool") == l(True)) + 300) == c("c_int8"),
    lambda c, l: (c("c_int8") * 3 + (c("sel") > 5)) < l(2 ** 40 + 7),
    lambda c, l: -(c("c_int16") * 2) >= c("c_int8"),
    lambda c, l: ~(c("c_int32") + 2 ** 31 - 1) > l(0),
    # float32 arithmetic in float32, an int32 or int64 operand rounded
    lambda c, l: (c("c_float32") + c("c_int32")) * 0.1 > c("c_float32"),
    lambda c, l: c("c_float32") * c("c_int64") < l(-1.5e18),
    # an integer or bool meeting a float literal: float64
    lambda c, l: (c("c_int32") * 1.0) > l(16777216.5),
    lambda c, l: (c("c_bool") + 0.25) * c("c_int8") >= c("c_float64"),
    # a weak float64 intermediate meeting float32 rounds to float32
    lambda c, l: (c("c_int16") + 0.1) * c("c_float32") != c("c_float32"),
    # float32 subnormals, NaN and negative zero
    lambda c, l: c("c_float32") * 1e-39 != l(0.0),
    lambda c, l: -(c("c_float64") - c("c_float64")) == l(0.0),
    lambda c, l: (c("c_float32") == c("c_float32")) | (c("sel") < 3),
    # float64 and float32 columns: float64
    lambda c, l: c("c_float32") * c("c_float64") - 0.5 <= c("c_float64"),
])
def test_program_wraps_as_evaluate(tree):
    arrays = _fs_arrays(n=2000)
    _, tt = _tables(arrays)
    _same_as_evaluate(tree(texpr.col, texpr.lit), tt)


def _right_deep(c, names, op):
    e = c(names[-1])
    for name in reversed(names[:-1]):
        e = texpr.BinOp(op, c(name), e)
    return e


def test_program_orders_operands_to_fit_the_stack():
    # a right-nested chain of 20 columns needs 20 slots in written order;
    # running the deeper operand first needs 2
    arrays = _fs_arrays(n=500)
    _, tt = _tables(arrays)
    names = ["c_int8", "c_int16", "c_int32", "sel"] * 5
    for op in ("+", "-", "*"):
        pred = _right_deep(texpr.col, names, op) < texpr.col("c_int64")
        prog = _same_as_evaluate(pred, tt)
        assert prog.depth == 2
        assert select.supports(select.make_signature(
            tt, pred, (("x", texpr.col("sel")),), "eager"))
    # two balanced trees of 32 operands, compared: 127 instructions in 7
    # slots; one more operand exceeds the program's 128 instructions
    def balanced(names):
        leaves = [texpr.col(n) for n in names]
        while len(leaves) > 1:
            leaves = [a - b for a, b in zip(leaves[::2], leaves[1::2])]
        return leaves[0]
    pred = balanced(["c_int32", "sel"] * 16) != balanced(["c_int8"] * 32)
    assert _same_as_evaluate(pred, tt).depth == 7
    for pred in (pred | texpr.col("c_bool"), balanced(["sel"] * 64) > 0):
        with pytest.raises(ValueError, match="exceeds"):
            select.compile_predicate(pred, tt)
        assert not select.supports(select.make_signature(
            tt, pred, (("x", texpr.col("sel")),), "eager"))


def test_plan_fused_select_forced_kernel_runs_plain_on_cpu(monkeypatch):
    arrays = _fs_arrays(n=300)
    _, tt = _tables(arrays)
    b = PlanBuilder()
    plan = (b.scan("t", schema=list(arrays))
             .filter((texpr.col("sel") < 20) & (texpr.col("c_int64") > 0))
             .project({"v": texpr.col("c_int16"), "w": texpr.col("c_bool")})
             .build())
    want = PlanExecutor(device="cpu", optimize=False).execute(plan,
                                                              {"t": tt})
    # the plain version counts its own runs, wherever it is called from
    for force, stamp, plain in ((False, "torch:fused_select", 1),
                                (True, "cuda:fused_select", 1)):
        if force:
            monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS",
                               "fused_select=cuda")
        select_cuda.reset_counters()
        res = PlanExecutor(device="cpu").execute(plan, {"t": tt})
        assert [m.kernel for m in res.metrics.values()
                if m.kind == "FusedSelect"] == [stamp]
        assert select_cuda.PLAIN_CALLS == {"fused_select": plain}
        assert select_cuda.LAUNCHES == {"count": 0, "compact": 0}
        for a, c in zip(want.table.columns, res.table.columns):
            assert torch.equal(a.data, c.data)
            assert (a.validity is None) == (c.validity is None)


def test_program_cache_keys_on_structure_literals_and_dtypes():
    rng = np.random.default_rng(13)
    a = rng.integers(-5, 5, 50)
    _, t32 = _tables({"a": (a.astype(np.int32), None),
                      "b": (a.astype(np.int8), None)})
    _, t64 = _tables({"a": (a.astype(np.int64), None),
                      "b": (a.astype(np.int8), None)})
    col, lit = texpr.col, texpr.lit

    def tree(v):
        return (col("a") * 3 + col("b")) < lit(v)
    p32 = select.cached_program(tree(7), t32)
    # the same tree built anew over the same dtypes: the same program
    assert select.cached_program(tree(7), t32) is p32
    assert p32.code == select.compile_predicate(tree(7), t32).code
    # other column dtypes, another literal, or a literal of another type:
    # another program, the one compile_predicate gives
    for other, tbl in ((tree(7), t64), (tree(8), t32), (tree(7.0), t32),
                       (tree(True), t32)):
        q = select.cached_program(other, tbl)
        assert q is not p32
        fresh = select.compile_predicate(other, tbl)
        assert (q.code, q.args) == (fresh.code, fresh.args)
        _same_as_evaluate(other, tbl)
    assert select.cached_program(tree(7), t64).code != p32.code
    # the kernel's argument struct travels with the program: its column
    # widths are those of the dtypes the program was compiled for
    a32, a64 = (select.PredArgs.from_buffer_copy(
        select.cached_program(tree(7), t).args) for t in (t32, t64))
    assert (a32.width[0], a64.width[0]) == (4, 8)
    assert (a32.narrow, a64.narrow) == (1, 0)
    # 0.0 and -0.0 are equal as Python values but not as literals
    z = select.cached_program(col("a") * lit(0.0) < lit(1.0), t32)
    nz = select.cached_program(col("a") * lit(-0.0) < lit(1.0), t32)
    assert z is not nz and z.code != nz.code
    # the signature's check goes through the same cache
    sig = select.make_signature(t32, tree(7), (("x", col("a")),), "eager")
    assert select.supports(sig)
    assert select.cached_program(tree(7), t32) is p32


def test_narrow_programs_are_exactly_the_32_bit_ones():
    arrays = _fs_arrays(n=200)
    _, tt = _tables(arrays)
    col, lit = texpr.col, texpr.lit
    cases = [((col("c_int32") < 10) & (col("sel") > 0), True),
             ((col("c_int8") + 100) > col("c_int16"), True),
             (~(col("sel") >= 10) & col("c_bool"), True),
             (col("c_int64") > 0, False),                  # an INT64 column
             # the weak literal wraps to the column's INT32, as evaluate
             (col("sel") < 2 ** 40, True),
             ((lit(2 ** 40) + lit(1)) > col("sel"), False),   # an int64 sum
             (col("sel") * 1.5 > 2.0, False),              # float64
             (col("c_float32") > lit(0.0), False)]
    for pred, narrow in cases:
        prog = select.cached_program(pred, tt)
        assert prog.narrow == narrow, pred
        _same_as_evaluate(pred, tt)
