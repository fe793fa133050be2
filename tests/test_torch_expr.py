"""The port's expression evaluation against the JAX package's, dtype and
value: literals are weakly typed in both (the column's dtype wins
promotion and the literal wraps at its width), and both raise on the same
type errors. Plus `fold`, `substitute` and the literal-only rules the
optimizer relies on."""
import numpy as np
import numpy.testing as npt
import pytest

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
