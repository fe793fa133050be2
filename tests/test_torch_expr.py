"""The port's expression evaluation against the JAX package's, dtype and
value: literals are weakly typed in both (the column's dtype wins
promotion and the literal wraps at its width), and both raise on the same
type errors. Plus `fold`, `substitute` and the literal-only rules the
optimizer relies on."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu.plan import expr as jexpr

from spark_rapids_tpu_torch import table_from_numpy
from spark_rapids_tpu_torch.plan import expr as texpr

_KINDS = ["bool", "int8", "int16", "int32", "int64", "float32", "float64"]


def _values(kind):
    """Each type's edges, and a few values between them."""
    if kind == "bool":
        return np.array([False, True, True, False])
    dt = np.dtype(kind)
    if dt.kind == "f":
        fi = np.finfo(dt)
        return np.array([0.0, -0.0, -1.5, 16777217.0, fi.max, fi.min,
                         np.inf, np.nan], dtype=dt)
    ii = np.iinfo(dt)
    return np.array([ii.min, ii.min + 1, -1, 0, 1, 100, ii.max - 1, ii.max],
                    dtype=dt)


def _tables(arrays):
    """{name: array} as a JAX-package table and a port table (CPU)."""
    names = list(arrays)
    jt = JTable([JColumn.from_numpy(a) for a in arrays.values()],
                names=names)
    kinds = [("bool" if a.dtype == np.bool_ else a.dtype.name)
             for a in arrays.values()]
    tt = table_from_numpy(names, list(arrays.values()),
                          [None] * len(names), kinds, device="cpu")
    return jt, tt


def _build(mod, tree):
    """An expression of `mod` (jexpr or texpr) from a nested tuple:
    ("col", name), ("lit", v), (op, a, b) or ("u~"/"u-", a)."""
    tag = tree[0]
    if tag == "col":
        return mod.col(tree[1])
    if tag == "lit":
        return mod.Literal(tree[1])
    if tag in ("u~", "u-"):
        return mod.UnaryOp(tag[1], _build(mod, tree[1]))
    return mod.BinOp(tag, _build(mod, tree[1]), _build(mod, tree[2]))


def _assert_same(tree, arrays):
    jt, tt = _tables(arrays)
    try:
        want = np.asarray(_build(jexpr, tree).evaluate(jt))
    except TypeError:
        with pytest.raises(TypeError):
            _build(texpr, tree).evaluate(tt)
        return
    got = _build(texpr, tree).evaluate(tt).numpy()
    assert got.dtype == want.dtype, (tree, got.dtype, want.dtype)
    npt.assert_array_equal(got, want)


_OPS = ["==", "!=", "<", "<=", ">", ">=", "&", "|", "+", "-", "*"]
_LITS = {"int": 300, "float": 16777216.5, "bool": True}


@pytest.mark.parametrize("op", _OPS)
@pytest.mark.parametrize("lit", sorted(_LITS))
@pytest.mark.parametrize("kind", _KINDS)
def test_column_op_literal_matches_jax(kind, lit, op):
    arrays = {"a": _values(kind)}
    v = _LITS[lit]
    _assert_same((op, ("col", "a"), ("lit", v)), arrays)
    _assert_same((op, ("lit", v), ("col", "a")), arrays)
    # a weak intermediate meets the column again
    _assert_same(("+" if kind != "bool" else "|",
                  (op, ("col", "a"), ("lit", v)), ("col", "a")), arrays)


@pytest.mark.parametrize("unary", ["u~", "u-"])
@pytest.mark.parametrize("kind", _KINDS)
def test_unary_matches_jax(kind, unary):
    arrays = {"a": _values(kind)}
    _assert_same((unary, ("col", "a")), arrays)
    _assert_same((unary, ("+", ("col", "a"), ("lit", 1))), arrays)


@pytest.mark.parametrize("tree,arrays", [
    # the three cases that differed before literals became weak
    ((">", ("+", ("col", "a"), ("lit", 1)), ("lit", 0)),
     {"a": np.array([2147483647, 0], np.int32)}),
    (("*", ("col", "b"), ("lit", 3)), {"b": np.array([100, -3], np.int8)}),
    ((">", ("*", ("col", "a"), ("lit", 1.0)), ("lit", 16777216.5)),
     {"a": np.array([16777217, 16777216], np.int32)}),
    # a weak float64 intermediate yields to a float32 column
    (("+", ("*", ("col", "i"), ("lit", 1.0)), ("col", "f")),
     {"i": np.array([16777217, 3], np.int32),
      "f": np.array([0.5, 1.0], np.float32)}),
    # a bool column and an int literal give weak int64, which then wraps
    # at the int8 column's width
    (("==", ("+", ("==", ("col", "c"), ("lit", True)), ("lit", 300)),
      ("col", "b")),
     {"c": np.array([True, False]), "b": np.array([45, 44], np.int8)}),
    # literal-only subtrees stay weak int64 against an int8 column
    (("+", ("+", ("lit", 2), ("lit", 3)), ("col", "b")),
     {"b": np.array([127, -128], np.int8)}),
    (("+", ("u~", ("lit", 3)), ("col", "b")),
     {"b": np.array([127, -128], np.int8)}),
    # out-of-range literals wrap, they do not raise
    (("==", ("col", "b"), ("lit", 2 ** 40)),
     {"b": np.array([0, 1], np.int8)}),
    # a literal alone, and two literals, are int64 / float64 / bool
    (("lit", 7), {"b": np.array([0, 1], np.int8)}),
    (("lit", 2.5), {"b": np.array([0, 1], np.int8)}),
    (("&", ("lit", True), ("lit", False)), {"b": np.array([0, 1], np.int8)}),
    (("*", ("lit", 2 ** 62), ("lit", 4)), {"b": np.array([0, 1], np.int8)}),
    # two columns of different widths promote as both packages do
    (("+", ("col", "b"), ("col", "f")),
     {"b": np.array([5, -7], np.int8), "f": np.array([0.5, 1.5],
                                                     np.float32)}),
    (("*", ("col", "b"), ("col", "l")),
     {"b": np.array([5, -7], np.int8), "l": np.array([2 ** 40, 3])}),
])
def test_promotion_cases_match_jax(tree, arrays):
    _assert_same(tree, arrays)


# ---- queue C6: a bool times a float ------------------------------------------

_C6_FLOATS = [np.nan, np.inf, -np.inf, -0.0, 0.0, 2.5, -np.nan, -1e30]
_C6_BOOLS = [False, True, False, True, False, False, True, True]
_C6_CASES = {
    "b*f": ("*", ("col", "b"), ("col", "f")),
    "f*b": ("*", ("col", "f"), ("col", "b")),
    "lit_false*f": ("*", ("lit", False), ("col", "f")),
    "f*lit_true": ("*", ("col", "f"), ("lit", True)),
    "b*lit_nan": ("*", ("col", "b"), ("lit", float("nan"))),
    "lit_-0*b": ("*", ("lit", -0.0), ("col", "b")),
    "lit_inf*b": ("*", ("lit", float("inf")), ("col", "b")),
    "(b&b)*f": ("*", ("&", ("col", "b"), ("col", "b")), ("col", "f")),
    "(b*f)+f": ("+", ("*", ("col", "b"), ("col", "f")), ("col", "f")),
    "lit_false*lit_nan": ("*", ("lit", False), ("lit", float("nan"))),
}


@pytest.mark.parametrize("case", sorted(_C6_CASES))
@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_bool_times_float_is_a_select_as_in_jax(kind, case):
    """Queue C6: where `*` has one bool operand and a float result, both
    packages give where(b, x, +0.0): False times NaN, inf or -0.0 is +0.0,
    True times x is x. Bit for bit, the sign of zero and NaN bits
    included."""
    arrays = {"b": np.array(_C6_BOOLS), "f": np.array(_C6_FLOATS, kind)}
    jt, tt = _tables(arrays)
    tree = _C6_CASES[case]
    want = np.asarray(_build(jexpr, tree).evaluate(jt))
    got = _build(texpr, tree).evaluate(tt).numpy()
    assert got.dtype == want.dtype
    npt.assert_array_equal(_bits(got), _bits(want))
    if tree[0] == "*" and tree[1] == ("col", "b"):
        # the select itself: +0.0 on every False row
        assert not np.signbit(got[~np.array(_C6_BOOLS)]).any()
        assert (got[~np.array(_C6_BOOLS)] == 0).all()


def test_bool_times_float_literals_fold_as_the_reference_folds():
    """The reference's `fold` computes a literal-only `*` in Python, so
    `lit(False) * lit(nan)` folds to NaN while its evaluation is 0.0
    (queue C's reference deviations); the port's fold follows it."""
    tree = ("*", ("lit", False), ("lit", float("nan")))
    j = jexpr.fold(_build(jexpr, tree))
    t = texpr.fold(_build(texpr, tree))
    assert isinstance(t, texpr.Literal) and np.isnan(t.value)
    assert repr(j) == repr(t)
    jt, tt = _tables({"b": np.array([False])})
    assert float(np.asarray(_build(jexpr, tree).evaluate(jt))[0]) == 0.0
    assert float(_build(texpr, tree).evaluate(tt)[0]) == 0.0


def test_subnormal_sums_follow_ieee_where_xla_cpu_flushes():
    """A reference deviation the port does not follow (queue C): XLA on
    the CPU flushes subnormal results of float arithmetic to zero, so the
    reference's `f + f` over 1e-310 is 0.0. The port adds as IEEE and
    Spark do, 2e-310; a select (True * 1e-310) moves no arithmetic, so
    there both give 1e-310."""
    arrays = {"b": np.array([True]), "f": np.array([1e-310])}
    jt, tt = _tables(arrays)
    add = ("+", ("col", "f"), ("col", "f"))
    assert float(np.asarray(_build(jexpr, add).evaluate(jt))[0]) == 0.0
    assert float(_build(texpr, add).evaluate(tt)[0]) == 2e-310
    sel = ("*", ("col", "b"), ("col", "f"))
    assert float(np.asarray(_build(jexpr, sel).evaluate(jt))[0]) == 1e-310
    assert float(_build(texpr, sel).evaluate(tt)[0]) == 1e-310


# ---- the optimizer's expression helpers -------------------------------------

def test_fold_matches_reference():
    cases = [("+", ("lit", 2), ("lit", 3)),
             ("<", ("lit", 1), ("lit", 2)),
             ("&", ("<", ("lit", 1), ("lit", 2)), ("==", ("lit", 3),
                                                   ("lit", 4))),
             ("u~", ("lit", True)), ("u~", ("lit", 3)), ("u-", ("lit", 5)),
             ("*", ("+", ("lit", 2), ("lit", 3)), ("col", "v")),
             ("+", ("lit", 2 ** 62), ("lit", 2 ** 62)),
             ("+", ("col", "a"), ("col", "b"))]
    for tree in cases:
        j = jexpr.fold(_build(jexpr, tree))
        t = texpr.fold(_build(texpr, tree))
        assert repr(j) == repr(t)
        assert type(j).__name__ == type(t).__name__
    e = texpr.col("a") + texpr.col("b")
    assert texpr.fold(e) is e                   # nothing folded: identity


def test_substitute_and_scalar_agg():
    e = (texpr.col("a") > 5) & (texpr.col("b") == 1)
    s = texpr.substitute(e, {"a": texpr.col("x"), "b": texpr.lit(1)})
    assert repr(s) == "((x > 5) & (1 == 1))"
    with pytest.raises(KeyError):
        texpr.substitute(e, {"a": texpr.col("x")})
    assert not texpr.has_scalar_agg(e)


# ---- scalar aggregates (q23's scalar subquery) -------------------------------

def _agg_values(kind, n, seed):
    """Values whose float sums depend on the order of the adds (wide
    magnitudes, -0.0) and whose extremes tie at signed zeros."""
    rng = np.random.default_rng(seed)
    if np.dtype(kind).kind == "f":
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 17, n))
        v[::7] = -0.0
        return v.astype(kind)
    ii = np.iinfo(kind)
    return rng.integers(ii.min // 4, ii.max // 4, n).astype(kind)


def _bits(a):
    a = np.asarray(a)
    return a.reshape(-1).view(np.uint8)


@pytest.mark.parametrize("alive_share", [None, 0.6])
@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("kind", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("n", [1, 31, 1000])
def test_scalar_agg_matches_jax(kind, op, alive_share, n):
    """The 0-d result: dtype and bits, over every row or the live ones."""
    v = _agg_values(kind, n, seed=n)
    jt, tt = _tables({"v": v})
    alive = None
    if alive_share is not None:
        alive = np.random.default_rng(n + 1).random(n) < alive_share
        alive[0] = True
    je = jexpr.ScalarAgg(op, jexpr.col("v"))
    te = texpr.ScalarAgg(op, texpr.col("v"))
    want = np.asarray(je.evaluate(jt, None if alive is None else
                                  jexpr.jnp.asarray(alive)))
    got = te.evaluate(tt, None if alive is None else
                      torch.from_numpy(alive)).numpy()
    assert got.shape == () and got.dtype == want.dtype, (got, want)
    npt.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_scalar_agg_float_edges_match_jax(kind):
    """NaN gives the canonical NaN; -0.0 orders below 0.0."""
    for arr in ([1.0, np.nan], [np.nan], [-0.0, 0.0], [0.0, -0.0],
                [-0.0] * 33):
        jt, tt = _tables({"v": np.array(arr, dtype=kind)})
        for op in ("max", "min", "sum"):
            want = np.asarray(jexpr.ScalarAgg(op, jexpr.col("v"))
                              .evaluate(jt))
            got = texpr.ScalarAgg(op, texpr.col("v")).evaluate(tt).numpy()
            npt.assert_array_equal(_bits(got), _bits(want))


def test_threshold_compares_in_float64():
    """`rev > 0.95 * max(rev)` over INT64 runs in float64, as in the
    reference: at max = 100,000,007 the threshold is 95,000,006.65, so rev
    = 95,000,007 passes; in float32 both round to 95,000,008 and it would
    not."""
    rev = np.array([95_000_007, 100_000_007, 95_000_006, 3], dtype=np.int64)
    jt, tt = _tables({"rev": rev})
    je = jexpr.col("rev") > jexpr.lit(0.95) * jexpr.scalar_max(
        jexpr.col("rev"))
    te = texpr.col("rev") > texpr.lit(0.95) * texpr.scalar_max(
        texpr.col("rev"))
    want = np.asarray(je.evaluate(jt))
    got = te.evaluate(tt).numpy()
    npt.assert_array_equal(got, want)
    npt.assert_array_equal(got, [True, True, False, False])
    prod = texpr.lit(0.95) * texpr.scalar_max(texpr.col("rev"))
    assert prod.evaluate(tt).numpy().dtype == np.asarray(
        (jexpr.lit(0.95) * jexpr.scalar_max(jexpr.col("rev"))).evaluate(jt)
    ).dtype == np.float64
    f32 = np.float32(95_000_007) > np.float32(0.95) * np.float32(100_000_007)
    assert not f32                     # the case float32 gets wrong
    # 2^53 + 1 is not a float64: the max converts as the reference's does
    big = np.array([2 ** 53 + 1, 2 ** 53], dtype=np.int64)
    jt, tt = _tables({"rev": big})
    npt.assert_array_equal(te.evaluate(tt).numpy(),
                           np.asarray(je.evaluate(jt)))


def test_scalar_agg_reads_null_rows_as_the_reference_does():
    """The child's nulls are not excluded: the reference reduces the data
    buffer (ROADMAP queue C records the deviation from Spark)."""
    v = np.array([5, 9_000, 7], dtype=np.int64)
    valid = np.array([True, False, True])
    jt = JTable([JColumn.from_numpy(v, validity=valid)], names=["v"])
    tt = table_from_numpy(["v"], [v], [valid], ["int64"], device="cpu")
    for op in ("max", "min", "sum"):
        want = np.asarray(jexpr.ScalarAgg(op, jexpr.col("v")).evaluate(jt))
        got = texpr.ScalarAgg(op, texpr.col("v")).evaluate(tt).numpy()
        npt.assert_array_equal(got, want)
    assert int(texpr.scalar_max(texpr.col("v")).evaluate(tt)) == 9_000


def test_scalar_agg_over_an_empty_relation():
    """max and min raise ValueError in both packages; a sum is 0."""
    jt, tt = _tables({"v": np.zeros(0, dtype=np.int64)})
    for op in ("max", "min"):
        with pytest.raises(ValueError):
            jexpr.ScalarAgg(op, jexpr.col("v")).evaluate(jt)
        with pytest.raises(ValueError, match="zero-size"):
            texpr.ScalarAgg(op, texpr.col("v")).evaluate(tt)
        with pytest.raises(ValueError, match="zero-size"):
            (texpr.col("v") > texpr.ScalarAgg(op, texpr.col("v"))
             ).evaluate(tt)
    assert int(np.asarray(jexpr.scalar_sum(jexpr.col("v")).evaluate(jt))) \
        == int(texpr.scalar_sum(texpr.col("v")).evaluate(tt)) == 0


def test_scalar_agg_helpers_match_reference():
    """fold, substitute, has_scalar_agg and repr for scalar aggregates."""
    def build(mod):
        return mod.col("rev") > (mod.lit(2) * mod.lit(3)) * mod.scalar_max(
            mod.col("rev") + (mod.lit(1) - mod.lit(1)))
    j, t = build(jexpr), build(texpr)
    assert repr(jexpr.fold(j)) == repr(texpr.fold(t))
    assert repr(texpr.fold(t)) == "(rev > (6 * max((rev + 0))))"
    assert texpr.has_scalar_agg(t) and texpr.has_scalar_agg(~t)
    assert texpr.has_scalar_agg(texpr.scalar_min(1))
    assert not texpr.has_scalar_agg(texpr.col("rev") > 3)
    s = texpr.substitute(t, {"rev": texpr.col("x")})
    assert repr(s) == repr(jexpr.substitute(j, {"rev": jexpr.col("x")}))
    assert repr(s) == "(x > ((2 * 3) * max((x + (1 - 1)))))"
    assert s.references() == frozenset({"x"})
    for name in ("max", "min", "sum"):
        e = getattr(texpr, f"scalar_{name}")(texpr.col("a"))
        assert isinstance(e, texpr.ScalarAgg) and e.op == name
    m = texpr.scalar_sum(texpr.lit(2))
    assert texpr.fold(m) is m                  # never folds itself
