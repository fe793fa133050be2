"""STRING, DECIMAL128 and float keys in the port against the JAX package on
the CPU, on the same values: `sorted_order` (both directions, both null
orders, mixed with integer and float keys; nested keys raise), groupby on
those keys with string min and max (all-null groups, an empty table),
every join form (inner, left, full, semi, anti, `null_equal`, the capped
forms), the hash-join kernel's plain version (forced with
SPARK_RAPIDS_TORCH_KERNELS=hash_join=cuda on CPU tensors) against
`join.inner_join`, queue C 7's float join through the forced kernel path,
the TopK kernel's plain version and descriptor against the reference's
sort and slice, FusedSelect's plain version with STRING and DECIMAL128
payloads, and the five copying functions `split_table`, `halve_table`,
`replace_nulls`, `if_else` and `drop_duplicates`.

Exact: buffers are compared byte for byte (offsets, chars, limbs, float
bits), validity included. Sizes are small and few string widths appear,
so the JAX package compiles few programs."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.ops import aggregate as jagg
from spark_rapids_tpu.ops import copying as jcopying
from spark_rapids_tpu.ops import gather as jgather
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.ops import sort as jsort

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.interop import Buffers, column_from_buffers
from spark_rapids_tpu_torch.ops import aggregate, copying, join, join_cuda
from spark_rapids_tpu_torch.ops import select, sort, topk
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

# one width bucket (16 bytes) for the reference's padded chars
WORDS = ["", "a", "a\x00", "ab", "abc", "abcdefgh", "abcdefghi", "é",
         "日本", "pre_1", "pre_12", "pre_123", b"\xff\xfe", b"\x80", "Z",
         "zzzzzzzzzzzzzzz"]
DECS = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64, -2 ** 64,
        2 ** 96 + 5, 12345, -12345]
FLOATS = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.5, -1.5]


def port_dtype(jd) -> tdt.DType:
    return tdt.DType(tdt.Kind(jd.kind.value), jd.precision, jd.scale,
                     tuple(port_dtype(c) for c in jd.children),
                     tuple(jd.field_names))


def buffers(jc: JColumn) -> Buffers:
    def arr(a):
        return None if a is None else np.asarray(a)
    return Buffers(port_dtype(jc.dtype), jc.length, arr(jc.data),
                   arr(jc.validity), arr(jc.offsets),
                   tuple(buffers(c) for c in jc.children))


def tcol(jc: JColumn) -> Column:
    return column_from_buffers(buffers(jc), "cpu")


def ttable(jt: JTable) -> Table:
    return Table([tcol(c) for c in jt.columns], list(jt.names))


def assert_col(jc: JColumn, tc: Column):
    """Equal dtype, length, buffers (floats and limbs by their bytes) and
    validity."""
    assert tc.dtype == port_dtype(jc.dtype) and tc.length == jc.length
    for t, j in ((tc.data, jc.data), (tc.offsets, jc.offsets)):
        assert (t is None) == (j is None)
        if t is not None:
            want = np.asarray(j)
            got = t.numpy()
            assert got.dtype == want.dtype
            npt.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert (tc.validity is None) == (jc.validity is None)
    if tc.validity is not None:
        npt.assert_array_equal(tc.validity.numpy(), np.asarray(jc.validity))


def assert_table(jt: JTable, tt: Table):
    assert list(jt.names) == list(tt.names)
    for a, b in zip(jt.columns, tt.columns):
        assert_col(a, b)


def pick(rng, values, n, null_p):
    idx = rng.integers(0, len(values), n)
    valid = rng.random(n) >= null_p
    return [values[i] if v else None for i, v in zip(idx, valid)]


def jcolumn(values, kind):
    if kind == "string":
        return JColumn.from_pylist(values, jdt.STRING)
    if kind == "decimal":
        return JColumn.from_pylist(values, jdt.decimal(38, 2))
    if kind in ("float32", "float64"):
        arr = np.array([0.0 if v is None else v for v in values],
                       dtype=kind)
        valid = np.array([v is not None for v in values])
        return JColumn.from_numpy(arr, validity=None if valid.all()
                                  else valid)
    arr = np.array([0 if v is None else v for v in values], dtype=kind)
    valid = np.array([v is not None for v in values])
    return JColumn.from_numpy(arr, validity=None if valid.all() else valid)


VALUES = {"string": WORDS, "decimal": DECS, "float32": FLOATS,
          "float64": FLOATS, "int32": list(range(-3, 4))}


def key_columns(kind, n, seed, null_p=0.15):
    rng = np.random.default_rng(seed)
    j = jcolumn(pick(rng, VALUES[kind], n, null_p), kind)
    return j, tcol(j)


# ---- sort --------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [("string",), ("decimal",),
                                   ("string", "int32"),
                                   ("decimal", "float64", "string")])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("nulls", [None, "first", "last"])
def test_sorted_order_matches_jax(kinds, ascending, nulls):
    jcols, tcols = zip(*[key_columns(k, 40, i + 7)
                         for i, k in enumerate(kinds)])
    asc = [ascending] + [not ascending] * (len(kinds) - 1)
    want = jsort.sorted_order(list(jcols), asc, nulls)
    got = sort.sorted_order(list(tcols), asc, nulls)
    npt.assert_array_equal(np.asarray(want.data), got.data.numpy())
    # the table sort moves every column with its keys, strings included
    jt = JTable(list(jcols), [f"c{i}" for i in range(len(kinds))])
    assert_table(jsort.sort_table(jt, None, asc, nulls),
                 sort.sort_table(ttable(jt), None, asc, nulls))


def test_nested_keys_raise_as_the_reference():
    ints = JColumn.from_pylist([1, 2, 3], jdt.INT32)
    lst = JColumn.make_list(jnp.asarray([0, 1, 3], jnp.int32), ints)
    st = JColumn.make_struct(a=JColumn.from_pylist([1, 2], jdt.INT32))
    for jc in (lst, st):
        with pytest.raises(TypeError, match="unsupported sort key dtype"):
            jsort.sorted_order(jc)
        with pytest.raises(TypeError, match="unsupported sort key dtype"):
            sort.sorted_order(tcol(jc))
    jt = JTable([lst, JColumn.from_pylist([1, 2], jdt.INT64)], ["l", "v"])
    with pytest.raises(TypeError, match="nested group keys"):
        jagg.groupby_aggregate(jt, ["l"], [("v", "sum")])
    with pytest.raises(TypeError, match="nested group keys"):
        aggregate.groupby_aggregate(ttable(jt), ["l"], [("v", "sum")])


# ---- groupby -----------------------------------------------------------------

@pytest.mark.parametrize("keys", [("string",), ("decimal",),
                                  ("string", "decimal")])
def test_groupby_on_string_and_decimal_keys_matches_jax(keys):
    rng = np.random.default_rng(3)
    n = 40
    cols = [jcolumn(pick(rng, VALUES[k], n, 0.15), k) for k in keys]
    cols.append(jcolumn(pick(rng, list(range(10)), n, 0.2), "int64"))
    names = [f"k{i}" for i in range(len(keys))] + ["v"]
    jt = JTable(cols, names)
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "size")]
    assert_table(jagg.groupby_aggregate(jt, names[:-1], aggs),
                 aggregate.groupby_aggregate(ttable(jt), names[:-1], aggs))


@pytest.mark.parametrize("ops", [("min",), ("max",), ("min", "max"),
                                 ("max", "min", "count")])
@pytest.mark.parametrize("n", [0, 1, 40])
def test_string_min_max_matches_jax(ops, n):
    rng = np.random.default_rng(11 + n)
    keys = pick(rng, [1, 2, 3, 4], n, 0.1)
    vals = pick(rng, WORDS, n, 0.3)
    if n == 40:                          # one all-null group
        vals = [None if k == 4 else v for k, v in zip(keys, vals)]
    jt = JTable([jcolumn(keys, "int64"), jcolumn(vals, "string")],
                ["k", "s"])
    aggs = [("s", op) for op in ops]
    want = jagg.groupby_aggregate(jt, ["k"], aggs)
    got = aggregate.groupby_aggregate(ttable(jt), ["k"], aggs)
    assert_table(want, got)
    if n == 40:
        assert None in got.columns[1].to_pylist()
    with pytest.raises(TypeError, match="max_string_length"):
        aggregate.groupby_aggregate_capped(ttable(jt), ["k"], aggs, 8)


# ---- joins -------------------------------------------------------------------

JOIN_KINDS = ["string", "decimal", "float32", "float64"]


def _maps(want, got):
    for w, g in zip(want, got):
        w = w.data if isinstance(w, (JColumn, Column)) else w
        g = g.data if isinstance(g, Column) else g
        npt.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("kind", JOIN_KINDS)
def test_joins_match_jax_pair_for_pair(kind, null_equal):
    jl, tl = key_columns(kind, 30, 1)
    jr, tr = key_columns(kind, 20, 2)
    for name in ("inner_join", "left_join", "full_join"):
        _maps(getattr(jjoin, name)([jl], [jr], null_equal),
              getattr(join, name)([tl], [tr], null_equal))
    for name in ("left_semi_join", "left_anti_join"):
        _maps([getattr(jjoin, name)([jl], [jr], null_equal)],
              [getattr(join, name)([tl], [tr], null_equal)])
    rng = np.random.default_rng(4)
    la, ra = rng.random(30) > 0.2, rng.random(20) > 0.2
    for cap in (0, 7, 60):
        for name in ("inner_join_capped", "left_join_capped"):
            _maps(getattr(jjoin, name)([jl], [jr], cap,
                                       lalive=jnp.asarray(la),
                                       ralive=jnp.asarray(ra),
                                       null_equal=null_equal),
                  getattr(join, name)([tl], [tr], cap,
                                      lalive=torch.tensor(la),
                                      ralive=torch.tensor(ra),
                                      null_equal=null_equal))
    _maps([jjoin.semi_join_mask([jl], [jr], lalive=jnp.asarray(la),
                                null_equal=null_equal)],
          [join.semi_join_mask([tl], [tr], lalive=torch.tensor(la),
                               null_equal=null_equal)])


def test_join_key_dtypes_must_match():
    a = JColumn.from_pylist([1, 2], jdt.decimal(38, 2))
    b = JColumn.from_pylist([1, 2], jdt.decimal(38, 3))
    with pytest.raises(TypeError, match="join key concat dtype mismatch"):
        jjoin.inner_join([a], [b])
    with pytest.raises(TypeError, match="join key concat dtype mismatch"):
        join.inner_join([tcol(a)], [tcol(b)])
    with pytest.raises(TypeError, match="join key concat dtype mismatch"):
        join_cuda.inner_join_hash([tcol(a)], [tcol(b)])


@pytest.mark.parametrize("kinds", [("string",), ("decimal",), ("float32",),
                                   ("float64",), ("string", "int32"),
                                   ("decimal", "float64")])
@pytest.mark.parametrize("nr", [60, 700])
def test_hash_join_plain_version_matches_inner_join(kinds, nr):
    """The hash-join kernels' plain versions (the small route's table up to
    512 build rows, the large route's past it) give `join.inner_join`'s
    pairs, in order, and the JAX package's; the capped form its capped
    join's."""
    rng = np.random.default_rng(nr)
    jl = [jcolumn(pick(rng, VALUES[k], 500, 0.1), k) for k in kinds]
    jr = [jcolumn(pick(rng, VALUES[k], nr, 0.1), k) for k in kinds]
    tl, tr = [tcol(c) for c in jl], [tcol(c) for c in jr]
    assert join_cuda.is_large(join_cuda._capacity(nr)) == (nr > 512)
    got = join_cuda.inner_join_hash(tl, tr)
    _maps(join.inner_join(tl, tr), got)
    _maps(jjoin.inner_join(jl, jr), got)
    la, ra = rng.random(500) > 0.3, rng.random(nr) > 0.3
    cap = got[0].length // 2 + 1
    _maps(join.inner_join_capped(tl, tr, cap, lalive=torch.tensor(la),
                                 ralive=torch.tensor(ra)),
          join_cuda.inner_join_capped_hash(tl, tr, cap,
                                           lalive=torch.tensor(la),
                                           ralive=torch.tensor(ra)))


def test_float_join_on_the_forced_kernel_path(monkeypatch):
    """Queue C 7: [0.0, -0.0, NaN, 1.5] x [-0.0, NaN, 2.0] through the plan
    executor with the hash-join kernel forced: 3 pairs, as the JAX
    package's and the sort-based join's."""
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=cuda")
    for dt in ("float32", "float64"):
        jl = jcolumn([0.0, -0.0, float("nan"), 1.5], dt)
        jr = jcolumn([-0.0, float("nan"), 2.0], dt)
        b = PlanBuilder()
        plan = b.scan("a", schema=["x"]).join(
            b.scan("b", schema=["y"]), left_on="x", right_on="y").build()
        join_cuda.reset_counters()
        res = PlanExecutor(device="cpu").execute(
            plan, {"a": Table([tcol(jl)], ["x"]),
                   "b": Table([tcol(jr)], ["y"])})
        assert [m.kernel for m in res.metrics.values()
                if m.kind == "HashJoin"] == ["cuda:hash_join"]
        assert join_cuda.PLAIN_CALLS == {"build": 1, "count": 1,
                                         "emit": 1, "exists": 0,
                                         "capped": 0}
        assert res.table.num_rows == 3
        _maps(jjoin.inner_join([jl], [jr]),
              join_cuda.inner_join_hash([tcol(jl)], [tcol(jr)]))
        assert join_cuda._supports(join_cuda.make_signature(
            [tcol(jl)], [tcol(jr)], "inner", "eager"))


# ---- TopK --------------------------------------------------------------------

@pytest.mark.parametrize("keys,asc", [(("s",), (True,)), (("s",), (False,)),
                                      (("d",), (False,)),
                                      (("d", "s"), (True, False)),
                                      (("i", "s"), (False, True))])
@pytest.mark.parametrize("k", [1, 7, 50])
def test_topk_plain_and_descriptor_match_jax(keys, asc, k):
    rng = np.random.default_rng(21)
    n = 40
    jt = JTable([jcolumn(pick(rng, WORDS, n, 0.15), "string"),
                 jcolumn(pick(rng, DECS, n, 0.15), "decimal"),
                 jcolumn(pick(rng, [0, 1, 2], n, 0.0), "int32")],
                ["s", "d", "i"])
    tt = ttable(jt)
    want = jsort.sort_table(jt, list(keys), list(asc))
    want = jgather.take_table(want, jnp.arange(min(k, n)))
    assert_table(want, topk.topk_plain(tt, keys, asc, k))
    # the kernel's words, built from the descriptor, order as the sort
    words = topk.encode_words(tt, keys, asc)
    assert torch.equal(words, topk.order_words(tt, keys, asc))
    d = topk.describe_keys(tt, keys, asc)
    assert d.n_words == words.shape[0] == topk.n_words(
        topk.make_signature(tt, keys, asc, k, "eager"))
    u = words.numpy().astype(np.uint64)
    order = np.lexsort(u[::-1])
    npt.assert_array_equal(order[:min(k, n)],
                           np.asarray(jsort.sorted_order(
                               [jt[c] for c in keys], list(asc)).data)
                           [:min(k, n)])


def test_topk_reads_a_string_keys_word_count_once(monkeypatch):
    """The longest string is a host read: one a STRING key and call. The
    signature's `words` build the descriptor with no second read, and the
    executor hands them to the TopK it chose."""
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor
    reads = []
    real = topk.max_string_length
    monkeypatch.setattr(topk, "max_string_length",
                        lambda c: reads.append(c.length) or real(c))
    jt = JTable([jcolumn(WORDS, "string"),
                 jcolumn(list(range(len(WORDS))), "int32")], ["s", "i"])
    t = ttable(jt)
    keys, asc = ["i", "s"], [False, True]
    sig = topk.make_signature(t, keys, asc, 3, "eager")
    assert reads == [len(WORDS)]
    d = topk.describe_keys(t, keys, asc, sig.extra("words"))
    assert reads == [len(WORDS)]
    want = topk.describe_keys(t, keys, asc)
    assert len(reads) == 2
    assert (d.word_key, d.word_rank, d.word_part, d.n_words) == (
        want.word_key, want.word_rank, want.word_part, want.n_words)
    assert [k.nw for k in d.keys] == [k.nw for k in want.keys]
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "topk=cuda")
    plan = PlanBuilder().scan("t", schema=["s", "i"]).sort(
        ["s"], [False]).limit(4).build()
    reads.clear()
    res = PlanExecutor(device="cpu").execute(plan, {"t": t})
    assert [m.kernel for m in res.metrics.values()
            if m.kind == "TopK"] == ["cuda:topk"]
    assert reads == [len(WORDS)]
    want = jgather.take_table(jsort.sort_table(jt, ["s"], [False]),
                              jnp.arange(4))
    assert_table(want, res.table)


def test_topk_word_limit_declines():
    """A STRING key of 8 * (MAX_WORDS - 2) + 1 bytes is 95 chars words, its
    length and the row index: 97 words, over the kernels' 96."""
    for extra, ok in ((0, True), (1, False)):
        s = "q" * (8 * (topk.MAX_WORDS - 2) + extra)
        t = Table([Column.from_pylist([s, "a"], tdt.STRING, device="cpu")],
                  ["s"])
        sig = topk.make_signature(t, ["s"], [True], 1, "eager")
        assert topk.supports(sig) is ok
        assert topk.n_words(sig) == topk.MAX_WORDS + (not ok)


# ---- FusedSelect ---------------------------------------------------------------

def test_fused_select_plain_carries_string_and_decimal_payloads():
    from spark_rapids_tpu_torch.plan import col
    rng = np.random.default_rng(5)
    n = 40
    jt = JTable([jcolumn(pick(rng, list(range(10)), n, 0.0), "int32"),
                 jcolumn(pick(rng, WORDS, n, 0.2), "string"),
                 jcolumn(pick(rng, DECS, n, 0.2), "decimal")],
                ["p", "s", "d"])
    tt = ttable(jt)
    for lo in (-1, 4, 10):
        mask = np.asarray(jt["p"].data) < lo
        want = jgather.apply_boolean_mask(JTable([jt["s"], jt["d"]],
                                                 ["s", "d"]),
                                          jnp.asarray(mask))
        got = select.fused_select_plain(tt, col("p") < lo, ["s", "d"])
        assert_table(want, got)
        sig = select.make_signature(tt, col("p") < lo,
                                    (("s", col("s")), ("d", col("d"))),
                                    "eager")
        assert select.supports(sig)


# ---- copying -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["string", "decimal", "float64", "int32"])
def test_copying_functions_match_jax(kind):
    rng = np.random.default_rng(9)
    n = 24
    a = jcolumn(pick(rng, VALUES[kind], n, 0.25), kind)
    b = jcolumn(pick(rng, VALUES[kind], n, 0.25), kind)
    m = jcolumn(pick(rng, [True, False], n, 0.2), "bool")
    jt = JTable([a, b], ["a", "b"])
    tt = ttable(jt)
    for splits in ([], [5], [0, 24], [3, 3, 17]):
        for w, g in zip(jcopying.split_table(jt, splits),
                        copying.split_table(tt, splits)):
            assert_table(w, g)
    for w, g in zip(jcopying.halve_table(jt), copying.halve_table(tt)):
        assert_table(w, g)
    with pytest.raises(ValueError, match="invalid split points"):
        copying.split_table(tt, [30])
    fill = {"string": "FILL", "decimal": [7, 0, 0, 0], "float64": 2.5,
            "int32": 9}[kind]
    assert_col(jcopying.replace_nulls(a, fill),
               copying.replace_nulls(tcol(a), fill))
    assert_col(jcopying.if_else(m, a, b),
               copying.if_else(tcol(m), tcol(a), tcol(b)))
    assert_table(jcopying.drop_duplicates(jt, ["a"]),
                 copying.drop_duplicates(tt, ["a"]))
    assert_table(jcopying.drop_duplicates(jt), copying.drop_duplicates(tt))


def test_copying_errors_match_jax():
    lst = JColumn.make_list(jnp.asarray([0, 1, 1], jnp.int32),
                            JColumn.from_pylist([1], jdt.INT32),
                            jnp.asarray([True, False]))
    for fn, args in (("replace_nulls", (lst, 0)),
                     ("if_else", (JColumn.from_pylist([True, False],
                                                      jdt.BOOL), lst, lst))):
        with pytest.raises(TypeError, match="nested"):
            getattr(jcopying, fn)(*args)
        with pytest.raises(TypeError, match="nested"):
            getattr(copying, fn)(*[tcol(x) if isinstance(x, JColumn) else x
                                   for x in args])
    s, i = JColumn.from_pylist(["a"], jdt.STRING), \
        JColumn.from_pylist([1], jdt.INT32)
    m = JColumn.from_pylist([True], jdt.BOOL)
    with pytest.raises(TypeError, match="if_else dtype mismatch"):
        copying.if_else(tcol(m), tcol(s), tcol(i))
    empty = JTable([JColumn.from_pylist([], jdt.STRING)], ["s"])
    assert copying.drop_duplicates(ttable(empty)).num_rows == 0


# ---- the capped tier ----------------------------------------------------------

def _plans(builder, col):
    b = builder()
    j = b.scan("f", schema=["k", "x", "v"]).join(
        b.scan("d", schema=["dk", "w"]), left_on="k", right_on="dk")
    return [j.aggregate(["x"], [("v", "sum", "s"), ("w", "max", "m")]),
            j.filter(col("v") > 2).sort(["k", "v"],
                                        ascending=[False, True]).limit(7),
            b.scan("f", schema=["k", "x", "v"]).aggregate(
                ["k"], [("v", "count", "c")])]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("optimize", [False, True])
def test_decimal_and_float_keys_capped_match_jax(which, optimize):
    """A DECIMAL128-keyed join, a FLOAT64-keyed aggregate and a DECIMAL128
    TopK through both packages' capped tiers: `compact()` equal, and equal
    to the port's eager run."""
    from spark_rapids_tpu import plan as jplan
    from spark_rapids_tpu.plan import stats
    from spark_rapids_tpu_torch import plan as tplan
    rng = np.random.default_rng(17)
    n = 30
    jt = {"f": JTable([jcolumn(pick(rng, DECS, n, 0.1), "decimal"),
                       jcolumn(pick(rng, FLOATS, n, 0.1), "float64"),
                       jcolumn(pick(rng, list(range(6)), n, 0.0), "int64")],
                      ["k", "x", "v"]),
          "d": JTable([jcolumn(DECS[:7] + [None], "decimal"),
                       jcolumn(list(range(8)), "int64")], ["dk", "w"])}
    tt = {k: ttable(t) for k, t in jt.items()}
    with stats.scoped_store(None):
        want = jplan.PlanExecutor(mode="capped", optimize=optimize).execute(
            _plans(jplan.PlanBuilder, jplan.col)[which].build(), jt)
    plan = _plans(tplan.PlanBuilder, tplan.col)[which].build()
    got = tplan.PlanExecutor(mode="capped", device="cpu",
                             optimize=optimize).execute(plan, tt)
    eager = tplan.PlanExecutor(device="cpu", optimize=optimize).execute(
        plan, tt)
    def rows(t):
        """Each column's values, a float's as its bits (NaN compares)."""
        out = {}
        for name, c in zip(t.names, t.columns):
            vals = c.to_pylist()
            if c.dtype.is_floating:
                bits = np.asarray(c.data).view(
                    np.int32 if c.dtype.kind.value == "float32"
                    else np.int64)
                vals = [None if v is None else int(b)
                        for v, b in zip(vals, bits)]
            out[name] = vals
        return out
    w, g = want.compact(), got.compact()
    assert rows(g) == rows(eager.table) == rows(w)
    assert g.num_rows > 0
