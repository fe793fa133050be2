"""STRING, LIST and STRUCT columns in the port's substrate against the JAX
package on the CPU, on the same values: `Column.from_pylist`/`to_pylist`,
the JAX -> numpy -> port round trip (`interop.column_from_buffers`, nested
two deep with nulls at every level), `take`, `concat_columns`,
`utils.bitmask`, and string columns reaching plan keys and expressions.
Buffers are compared bit for bit, validity included."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.ops import copying as jcopying
from spark_rapids_tpu.ops import gather as jgather
from spark_rapids_tpu.utils import bitmask as jbitmask

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column, Table, make_string_column
from spark_rapids_tpu_torch.interop import (Buffers, column_from_buffers,
                                            table_from_buffers)
from spark_rapids_tpu_torch.ops import copying, gather
from spark_rapids_tpu_torch.utils import bitmask
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

STRINGS = ["", "a", None, "héllo wörld", "日本語のテキスト", "x" * 33, None,
           "tail!", b"\xed\x9f\xa0\xed\x9f\xa1 raw", "0123"]


def port_dtype(jd) -> tdt.DType:
    return tdt.DType(tdt.Kind(jd.kind.value), jd.precision, jd.scale,
                     tuple(port_dtype(c) for c in jd.children),
                     tuple(jd.field_names))


def buffers(jc: JColumn) -> Buffers:
    """A JAX column's host buffers, children first."""
    def arr(a):
        return None if a is None else np.asarray(a)
    return Buffers(port_dtype(jc.dtype), jc.length, arr(jc.data),
                   arr(jc.validity), arr(jc.offsets),
                   tuple(buffers(c) for c in jc.children))


def assert_same(tc: Column, jc: JColumn):
    """Equal dtype, length and buffers at every depth."""
    assert tc.dtype == port_dtype(jc.dtype) and tc.length == jc.length
    for t, j in ((tc.data, jc.data), (tc.offsets, jc.offsets)):
        assert (t is None) == (j is None)
        if t is not None:
            npt.assert_array_equal(t.numpy(), np.asarray(j))
            assert t.numpy().dtype == np.asarray(j).dtype
    assert (tc.validity is None) == (jc.validity is None)
    if tc.validity is not None:
        npt.assert_array_equal(tc.validity.numpy(), np.asarray(jc.validity))
    assert len(tc.children) == len(jc.children)
    for a, b in zip(tc.children, jc.children):
        assert_same(a, b)


def jstrings(vals):
    return JColumn.from_pylist(vals, jdt.STRING)


def tstrings(vals):
    return Column.from_pylist(vals, tdt.STRING, device="cpu")


def nested_pair(seed=0, n=23):
    """The same columns in both packages, nested two deep, nulls at every
    level: STRUCT<a: LIST<STRING>, b: STRUCT<x: INT64, y: STRING>>,
    LIST<LIST<INT32>> and LIST<STRUCT<p: DECIMAL128, q: BOOL>>."""
    rng = np.random.default_rng(seed)

    def valid(m, p=0.2):
        return rng.random(m) > p

    def strs(m):
        return [None if rng.random() < 0.2 else
                "".join(chr(int(c)) for c in rng.integers(97, 123,
                                                          rng.integers(0, 9)))
                for _ in range(m)]

    def offs(m, hi):
        lens = rng.integers(0, hi, m)
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)

    # a: LIST<STRING>
    o_a = offs(n, 4)
    s_a = strs(int(o_a[-1]))
    v_a = valid(n)
    # b: STRUCT<x: INT64, y: STRING>
    x = rng.integers(-2**62, 2**62, n)
    v_x, s_y, v_b = valid(n), strs(n), valid(n)
    v_top = valid(n)
    # LIST<LIST<INT32>>
    o_outer = offs(n, 3)
    o_inner = offs(int(o_outer[-1]), 4)
    ints = rng.integers(-2**31, 2**31, int(o_inner[-1])).astype(np.int32)
    v_ints, v_inner, v_outer = (valid(int(o_inner[-1])),
                                valid(int(o_outer[-1])), valid(n))
    # LIST<STRUCT<p: DECIMAL128, q: BOOL>>
    o_ls = offs(n, 3)
    m = int(o_ls[-1])
    decs = [None if rng.random() < 0.2 else
            int(rng.integers(-10**18, 10**18)) * 10**19 for _ in range(m)]
    bools = rng.random(m) > 0.5
    v_q, v_st, v_ls = valid(m), valid(m), valid(n)

    def build(C, dt, arr):
        a = C.make_list(arr(o_a), strings_of(C, s_a), arr(v_a))
        b = C.make_struct(arr(v_b), x=fixed(C, x, dt.INT64, arr(v_x)),
                          y=strings_of(C, s_y))
        top = C.make_struct(arr(v_top), a=a, b=b)
        inner = C.make_list(arr(o_inner), fixed(C, ints, dt.INT32,
                                                arr(v_ints)), arr(v_inner))
        outer = C.make_list(arr(o_outer), inner, arr(v_outer))
        st = C.make_struct(arr(v_st), p=decimal(C, dt, decs),
                           q=fixed(C, bools, dt.BOOL, arr(v_q)))
        return [top, outer, C.make_list(arr(o_ls), st, arr(v_ls))]

    def strings_of(C, vals):
        return (JColumn.from_pylist(vals, jdt.STRING) if C is JColumn
                else Column.from_pylist(vals, tdt.STRING, device="cpu"))

    def fixed(C, a, dt, v):
        if C is JColumn:
            return JColumn.from_numpy(a, dtype=dt, validity=v)
        return Column(dt, len(a), torch.tensor(a, dtype=dt.storage_dtype()),
                      v)

    def decimal(C, dt, vals):
        if C is JColumn:
            return JColumn.from_pylist(vals, jdt.decimal(38, 2))
        return Column.from_pylist(vals, tdt.decimal(38, 2), device="cpu")

    return (build(JColumn, jdt, jnp.asarray),
            build(Column, tdt, torch.as_tensor))


# ---- the substrate -----------------------------------------------------------

def test_string_columns_match_jax():
    jc, tc = jstrings(STRINGS), tstrings(STRINGS)
    assert_same(tc, jc)
    assert tc.to_pylist() == jc.to_pylist()
    npt.assert_array_equal(tc.string_lengths().numpy(),
                           np.asarray(jc.string_lengths()))
    assert tc.null_count() == 2 and tc.nbytes() == (
        tc.data.numel() + 4 * 11 + 10)
    made = make_string_column(tc.data, tc.offsets.to(torch.int64),
                              tc.validity)
    assert made.offsets.dtype == torch.int32 and \
        made.to_pylist() == tc.to_pylist()
    empty = tstrings([])
    assert empty.length == 0 and empty.to_pylist() == []


def test_nested_columns_match_jax_and_move_together():
    jcols, tcols = nested_pair()
    for jc, tc in zip(jcols, tcols):
        assert_same(tc, jc)
        assert tc.to_pylist() == jc.to_pylist()
        assert tc.to("cpu").to_pylist() == tc.to_pylist()
    assert repr(tcols[0].dtype) == repr(jcols[0].dtype)
    assert tcols[0].dtype.is_nested and not tcols[0].dtype.is_string
    t = Table(tcols, ["s", "ll", "ls"])
    assert t.num_rows == 23 and t.nbytes() == sum(c.nbytes() for c in tcols)
    assert t.to_pydict()["ll"] == jcols[1].to_pylist()
    with pytest.raises(TypeError, match="child"):
        Column(tdt.list_(tdt.INT64), 1, None, None,
               torch.tensor([0, 1], dtype=torch.int32),
               (tstrings(["a"]),))
    with pytest.raises(ValueError, match="length"):
        Column.make_struct(a=tstrings(["a"]), b=tstrings(["a", "b"]))


def test_from_pylist_of_nested_values():
    dt = tdt.struct(k=tdt.STRING, v=tdt.list_(tdt.INT64))
    vals = [{"k": "a", "v": [1, None]}, None, {"k": None, "v": []},
            {"k": "日本", "v": None}]
    c = Column.from_pylist(vals, dt, device="cpu")
    assert c.to_pylist() == vals
    assert c.children[1].to_pylist() == [[1, None], None, [], None]


def test_jax_round_trip_nested_two_deep_with_nulls():
    """JAX -> numpy -> port: every buffer crosses bit for bit, and the
    port's buffers rebuild the same JAX columns."""
    jcols, _ = nested_pair(seed=4, n=31)
    jcols.append(jstrings(STRINGS * 3 + [None]))
    t = table_from_buffers([f"c{i}" for i in range(4)],
                           [buffers(c) for c in jcols], device="cpu")
    for jc, tc in zip(jcols, t.columns):
        assert_same(tc, jc)
        assert tc.to_pylist() == jc.to_pylist()

    def back(tc):
        kids = tuple(back(k) for k in tc.children)

        def arr(x):
            return None if x is None else jnp.asarray(x.numpy())
        return JColumn(dtype=jax_dtype(tc.dtype), length=tc.length,
                       data=arr(tc.data), validity=arr(tc.validity),
                       offsets=arr(tc.offsets), children=kids)
    for jc, tc in zip(jcols, t.columns):
        assert back(tc).to_pylist() == jc.to_pylist()
    single = column_from_buffers(buffers(jcols[3]), device="cpu")
    assert single.to_pylist() == jcols[3].to_pylist()


def jax_dtype(dt: tdt.DType):
    return jdt.DType(jdt.Kind(dt.kind.value), dt.precision, dt.scale,
                     tuple(jax_dtype(c) for c in dt.children),
                     tuple(dt.field_names))


# ---- gather and concat ---------------------------------------------------------

@pytest.mark.parametrize("which", ["string", "struct", "list_list",
                                   "list_struct"])
def test_take_matches_jax(which):
    jcols, tcols = nested_pair(seed=7, n=29)
    jcols.insert(0, jstrings(STRINGS * 3))
    tcols.insert(0, tstrings(STRINGS * 3))
    i = ["string", "struct", "list_list", "list_struct"].index(which)
    jc, tc = jcols[i], tcols[i]
    rng = np.random.default_rng(i)
    idx = rng.integers(-1, tc.length, 40).astype(np.int32)
    idx[:3] = [-1, 0, tc.length - 1]
    want = jgather.take(jc, jnp.asarray(idx))
    got = gather.take(tc, torch.tensor(idx))
    assert_same(got, want)
    assert got.to_pylist() == want.to_pylist()
    # no null index: no validity added, an empty map gives an empty column
    keep = np.abs(idx).astype(np.int64)
    assert gather.take(tc, torch.tensor(keep)).to_pylist() == \
        jgather.take(jc, jnp.asarray(keep)).to_pylist()
    assert gather.take(tc, torch.zeros(0, dtype=torch.int64)).length == 0


@pytest.mark.parametrize("which", ["string", "struct", "list_list",
                                   "decimal128"])
def test_concat_matches_jax(which):
    parts = []
    for seed, n in ((1, 11), (2, 0), (3, 17)):
        jcols, tcols = nested_pair(seed=seed, n=n)
        vals = (STRINGS * 2)[:n]
        jcols.insert(0, jstrings(vals))
        tcols.insert(0, tstrings(vals))
        dec = [None if k % 5 == 0 else (k - 7) * 10**30 for k in range(n)]
        jcols.append(JColumn.from_pylist(dec, jdt.decimal(38, 0)))
        tcols.append(Column.from_pylist(dec, tdt.decimal(38, 0),
                                        device="cpu"))
        parts.append((jcols, tcols))
    i = {"string": 0, "struct": 1, "list_list": 2, "decimal128": 4}[which]
    want = jcopying.concat_columns([p[0][i] for p in parts])
    got = copying.concat_columns([p[1][i] for p in parts])
    assert_same(got, want)
    assert got.to_pylist() == want.to_pylist()


def test_bitmask_matches_jax():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 8, 9, 64, 100):
        v = rng.random(n) > 0.4
        packed = bitmask.pack_validity(torch.tensor(v))
        want = np.asarray(jbitmask.pack_validity(jnp.asarray(v)))
        npt.assert_array_equal(packed.numpy(), want)
        assert packed.dtype == torch.uint8
        npt.assert_array_equal(bitmask.unpack_validity(packed, n).numpy(), v)
    a = torch.tensor([0b1010, 0xF0], dtype=torch.uint8)
    b = torch.tensor([0b0101, 0x0F], dtype=torch.uint8)
    npt.assert_array_equal(bitmask.bitmask_bitwise_or([a, b]).numpy(),
                           np.asarray(jbitmask.bitmask_bitwise_or(
                               [jnp.asarray(a.numpy()),
                                jnp.asarray(b.numpy())])))
    with pytest.raises(ValueError):
        bitmask.bitmask_bitwise_or([])
    with pytest.raises(ValueError):
        bitmask.bitmask_bitwise_or([a, a[:1]])


# ---- strings in plans ----------------------------------------------------------

def _plan_inputs():
    from spark_rapids_tpu_torch import table_from_numpy
    f = table_from_numpy(["k", "v"], [np.array([1, 2, 3, 2], np.int64),
                                      np.array([5, 6, 7, 8], np.int64)],
                         [None, None], ["int64", "int64"], device="cpu")
    f = Table(list(f.columns) + [tstrings(["a", None, "cc", "d"])],
              ["k", "v", "s"])
    d = Table([Column.from_pylist([2, 3], tdt.INT64, device="cpu"),
               tstrings(["x", "y"])], ["dk", "ds"])
    return {"f": f, "d": d}


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["eager", "capped"])
def test_string_keys_and_expressions_raise_by_item(mode, optimize):
    """String keys (sort, join, group, TopK) run in the eager tier, equal to
    the JAX package's eager executor; in the capped tier they raise
    TypeError naming the reference's limit (its max_string_length under
    jit), as string expressions raise naming the stated limit (fixed-width
    columns only)."""
    from spark_rapids_tpu import plan as jplan
    from spark_rapids_tpu.columnar import Table as JTable
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col
    ex = PlanExecutor(mode=mode, device="cpu", optimize=optimize)
    inputs = _plan_inputs()
    jinputs = {k: JTable([JColumn(
        dtype=jax_dtype(c.dtype), length=c.length,
        data=jnp.asarray(c.data.numpy()),
        validity=None if c.validity is None else jnp.asarray(
            c.validity.numpy()),
        offsets=None if c.offsets is None else jnp.asarray(
            c.offsets.numpy())) for c in t.columns], names=list(t.names))
        for k, t in inputs.items()}

    def keyed(b, c):
        f = b.scan("f", schema=["k", "v", "s"])
        d = b.scan("d", schema=["dk", "ds"])
        return [f.sort(["s"]),
                f.join(d, left_on="s", right_on="ds"),
                f.aggregate(["s"], [("v", "sum", "t")]),
                f.sort(["v"]).limit(2).sort(["s"], ascending=[False]),
                f.sort(["s"]).limit(3)]
    for rel, jrel in zip(keyed(PlanBuilder(), col),
                         keyed(jplan.PlanBuilder(), jplan.col)):
        if mode == "capped":
            with pytest.raises(TypeError, match="max_string_length"):
                ex.execute(rel.build(), inputs)
            continue
        got = ex.execute(rel.build(), inputs).table
        want = jplan.PlanExecutor(mode="eager", optimize=optimize).execute(
            jrel.build(), jinputs).table
        assert list(got.names) == list(want.names)
        for tc, jc in zip(got.columns, want.columns):
            assert tc.to_pylist() == jc.to_pylist()
    b = PlanBuilder()
    f = b.scan("f", schema=["k", "v", "s"])
    d = b.scan("d", schema=["dk", "ds"])
    for rel in (f.filter(col("s") == col("s")),
                f.project({"t": col("s")}).filter(col("t") > 0)):
        with pytest.raises(TypeError, match="fixed-width columns only"):
            ex.execute(rel.build(), inputs)
    # as a payload, a string column passes a filter, a join and a sort
    rel = (f.filter(col("v") > 5).join(d, left_on="k", right_on="dk")
           .sort(["v"]))
    got = ex.execute(rel.build(), inputs).compact()
    assert got.to_pydict() == {"k": [2, 3, 2], "v": [6, 7, 8],
                               "s": [None, "cc", "d"], "dk": [2, 3, 2],
                               "ds": ["x", "y", "x"]}
