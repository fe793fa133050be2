"""The capped tier's operators in the port against the JAX package, op by
op, on inputs made with numpy from a seed: the capped hash join (the plain
mirror of the kernels on CPU tensors, and the sort-based plain version)
against `join_pallas.inner_join_capped_pallas` in interpret mode and
`ops.inner_join_capped`; the capped TopK against `topk_pallas.topk_capped`
in interpret mode; `sort_table_capped`, `semi_join_mask` and
`groupby_aggregate_capped` against theirs; `auto_retry_overflow` against
the reference's. Tolerance: none, every output bit for bit (floats as
their bits); a capped groupby's rows past its group count are not defined
in either package, so only its live rows are compared."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.ops import join_pallas, topk_pallas
from spark_rapids_tpu.ops.aggregate import \
    groupby_aggregate_capped as j_groupby_capped
from spark_rapids_tpu.ops.join import inner_join_capped as j_join_capped
from spark_rapids_tpu.ops.join import semi_join_mask as j_semi_mask
from spark_rapids_tpu.ops.sort import sort_table_capped as j_sort_capped
from spark_rapids_tpu.parallel import autoretry as j_autoretry

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.ops import join, join_cuda, topk, topk_cuda
from spark_rapids_tpu_torch.ops.aggregate import groupby_aggregate_capped
from spark_rapids_tpu_torch.ops.sort import sort_table_capped
from spark_rapids_tpu_torch.parallel import autoretry

_DT = {np.dtype(np.int64): tdt.INT64, np.dtype(np.int32): tdt.INT32,
       np.dtype(np.float64): tdt.FLOAT64, np.dtype(np.int8): tdt.INT8}


def _cols(arrays):
    """[(data, validity or None)] -> (JAX columns, port columns)."""
    jc = [JColumn.from_numpy(a, validity=v) for a, v in arrays]
    tc = [Column.from_numpy(a, _DT[a.dtype], v, device="cpu")
          for a, v in arrays]
    return jc, tc


def _tables(names, arrays):
    jc, tc = _cols(arrays)
    return JTable(jc, names=list(names)), Table(tc, list(names))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int64) if x.dtype == np.float64 else x


def _same(ref, got, what=""):
    """Equal tuples of arrays: (JAX arrays, torch tensors)."""
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, (what, i)
        np.testing.assert_array_equal(_bits(r), _bits(g),
                                      err_msg=f"{what} part {i}")


def _same_tables(jt, tt, rows=None):
    assert list(jt.names) == list(tt.names)
    for a, b in zip(jt.columns, tt.columns):
        ad, bd = _bits(a.data), _bits(b.data.numpy())
        av = None if a.validity is None else np.asarray(a.validity)
        bv = None if b.validity is None else b.validity.numpy()
        if rows is not None:
            ad, bd = ad[rows], bd[rows]
            av = None if av is None else av[rows]
            bv = None if bv is None else bv[rows]
        np.testing.assert_array_equal(ad, bd, err_msg=str(b.dtype))
        assert (av is None) == (bv is None)
        if av is not None:
            np.testing.assert_array_equal(av, bv)


def _join_case(name, rng, nl, nr):
    """(left arrays, right arrays) of one key layout."""
    if name == "int64":
        return ([(rng.integers(0, 40, nl).astype(np.int64),
                  rng.random(nl) > 0.05)],
                [(rng.integers(0, 40, nr).astype(np.int64), None)])
    if name == "int32":
        return ([(rng.integers(-20, 20, nl).astype(np.int32), None)],
                [(rng.integers(-20, 20, nr).astype(np.int32),
                  rng.random(nr) > 0.1)])
    return ([(rng.integers(0, 40, nl).astype(np.int64), None),
             (rng.integers(0, 3, nl).astype(np.int32),
              rng.random(nl) > 0.05)],
            [(rng.integers(0, 40, nr).astype(np.int64), None),
             (rng.integers(0, 3, nr).astype(np.int32), None)])


def _both_capped_joins(lc, rc, cap, la, ra):
    """The port's two capped joins: the kernels' plain mirror and the
    sort-based plain version; they must agree with each other."""
    lal, ral = torch.from_numpy(la), torch.from_numpy(ra)
    got = join_cuda.inner_join_capped_hash(lc, rc, cap, lalive=lal,
                                           ralive=ral)
    plain = join.inner_join_capped(lc, rc, cap, lalive=lal, ralive=ral)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("keys", ["int64", "int32", "two keys"])
def test_capped_join_matches_jax(keys):
    rng = np.random.default_rng(7)
    nl, nr = 900, 180
    la_np, ra_np = _join_case(keys, rng, nl, nr)
    (jl, tl), (jr, tr) = _cols(la_np), _cols(ra_np)
    la, ra = rng.random(nl) > 0.4, rng.random(nr) > 0.4
    roomy = j_join_capped(jl, jr, row_cap=8192, lalive=jnp.asarray(la),
                          ralive=jnp.asarray(ra))
    total = int(np.asarray(roomy[2]).sum())
    assert 13 < total < 8192
    for cap in (0, 1, 13, total - 1, total, total + 1, 8192):
        ref = j_join_capped(jl, jr, row_cap=cap, lalive=jnp.asarray(la),
                            ralive=jnp.asarray(ra))
        got = _both_capped_joins(tl, tr, cap, la, ra)
        _same(ref, got, f"{keys} cap={cap}")
        if cap in (13, total) and keys != "int32":
            pal = join_pallas.inner_join_capped_pallas(
                jl, jr, row_cap=cap, lalive=jnp.asarray(la),
                ralive=jnp.asarray(ra))
            _same(pal, got, f"{keys} cap={cap} vs pallas")


def test_capped_join_without_masks_and_empty_sides():
    rng = np.random.default_rng(9)
    la_np, ra_np = _join_case("int64", rng, 300, 50)
    (jl, tl), (jr, tr) = _cols(la_np), _cols(ra_np)
    ref = join_pallas.inner_join_capped_pallas(jl, jr, row_cap=64)
    got = join_cuda.inner_join_capped_hash(tl, tr, 64)
    _same(ref, got, "no masks")
    assert bool(got[3])                      # overflows at 64
    (je, te) = _cols([(np.zeros(0, np.int64), None)])
    for left, right in (((je, te), (jr, tr)), ((jl, tl), (je, te))):
        ref = j_join_capped(left[0], right[0], row_cap=16)
        for got in (join_cuda.inner_join_capped_hash(left[1], right[1], 16),
                    join.inner_join_capped(left[1], right[1], 16)):
            _same(ref, got, "empty side")
            assert not bool(got[2].any()) and not bool(got[3])


def test_capped_join_large_route_matches_jax():
    """A 700-row build (2,048 slots: the large route's table layout and
    64-bit list entries in the kernels' plain mirror) against the
    reference's sort-based capped join, with both sides' rows half dead."""
    rng = np.random.default_rng(10)
    nl, nr = 3000, 700
    la_np, ra_np = _join_case("two keys", rng, nl, nr)
    (jl, tl), (jr, tr) = _cols(la_np), _cols(ra_np)
    assert join_cuda.is_large(join_cuda._capacity(nr))
    la, ra = rng.random(nl) > 0.5, rng.random(nr) > 0.5
    roomy = j_join_capped(jl, jr, row_cap=nl * 8, lalive=jnp.asarray(la),
                          ralive=jnp.asarray(ra))
    total = int(np.asarray(roomy[2]).sum())
    for cap in (0, total // 2, total, nl * 8):
        ref = j_join_capped(jl, jr, row_cap=cap, lalive=jnp.asarray(la),
                            ralive=jnp.asarray(ra))
        _same(ref, _both_capped_joins(tl, tr, cap, la, ra), f"cap={cap}")


def _topk_tables(rng, n):
    return _tables(["k", "f", "pay"],
                   [(rng.integers(-99, 99, n).astype(np.int64),
                     rng.random(n) > 0.1),
                    (np.where(rng.random(n) < 0.1, -0.0,
                              rng.standard_normal(n)), None),
                    (rng.integers(0, 7, n).astype(np.int32), None)])


@pytest.mark.parametrize("share", [0.6, 0.0, 1.0])
def test_topk_capped_matches_jax(share):
    rng = np.random.default_rng(5)
    n = 500
    jt, tt = _topk_tables(rng, n)
    alive = rng.random(n) < share
    for keys, asc, k in ((["k", "f"], [True, False], 37),
                         (["pay", "f"], [False, True], 128)):
        rt, ra = topk_pallas.topk_capped(jt, keys, asc, k,
                                         jnp.asarray(alive), block_rows=256)
        gt, ga = topk_cuda.topk_capped(tt, keys, asc, k,
                                       torch.from_numpy(alive))
        np.testing.assert_array_equal(np.asarray(ra), ga.numpy())
        _same_tables(rt, gt)
    # k past the rows: the whole table; k = 0: no rows
    gt, ga = topk.topk_capped_plain(tt, ["k"], [True], n + 5,
                                    torch.from_numpy(alive))
    assert gt.num_rows == n and int(ga.sum()) == int(alive.sum())
    gt, ga = topk.topk_capped_plain(tt, ["k"], [True], 0,
                                    torch.from_numpy(alive))
    assert gt.num_rows == 0 and ga.shape == (0,)


def test_topk_capped_equals_capped_sort_prefix():
    """The live rows of the capped TopK are the first n live rows of the
    capped sort, as the reference's registry test holds its kernel; the
    words the kernels build (no alive word: the capped form reads `alive`
    beside them) equal `order_words`."""
    rng = np.random.default_rng(6)
    n, k = 800, 11
    _, tt = _topk_tables(rng, n)
    for share in (0.6, 0.0):
        alive = torch.from_numpy(rng.random(n) < share)
        st, salive = sort_table_capped(tt, key_names=["k", "pay"],
                                       ascending=[False, True], alive=alive)
        live = torch.nonzero(salive & (torch.cumsum(
            salive.to(torch.int32), 0) <= k)).reshape(-1)
        gt, ga = topk_cuda.topk_capped(tt, ["k", "pay"], [False, True], k,
                                       alive)
        idx = torch.nonzero(ga).reshape(-1)
        assert torch.equal(idx, torch.arange(live.shape[0]))
        for a, b in zip(st.columns, gt.columns):
            assert torch.equal(a.data[live], b.data[idx])
        assert torch.equal(topk.encode_words(tt, ["k", "f"], [False, True]),
                           topk.order_words(tt, ["k", "f"], [False, True]))


def test_sort_table_capped_matches_jax():
    rng = np.random.default_rng(11)
    n = 500
    jt, tt = _topk_tables(rng, n)
    for share in (0.7, 0.0, 1.0):
        alive = rng.random(n) < share
        rt, ra = j_sort_capped(jt, key_names=["k", "f"],
                               ascending=[True, False],
                               alive=jnp.asarray(alive))
        gt, ga = sort_table_capped(tt, key_names=["k", "f"],
                                   ascending=[True, False],
                                   alive=torch.from_numpy(alive))
        np.testing.assert_array_equal(np.asarray(ra), ga.numpy())
        _same_tables(rt, gt)
    rt, ra = j_sort_capped(jt, key_names=["pay"])
    gt, ga = sort_table_capped(tt, key_names=["pay"])
    np.testing.assert_array_equal(np.asarray(ra), ga.numpy())
    _same_tables(rt, gt)


@pytest.mark.parametrize("keys", ["int64", "two keys"])
def test_semi_join_mask_matches_jax(keys):
    rng = np.random.default_rng(12)
    nl, nr = 600, 90
    la_np, ra_np = _join_case(keys, rng, nl, nr)
    (jl, tl), (jr, tr) = _cols(la_np), _cols(ra_np)
    for lp, rp in ((0.5, 0.5), (1.0, 1.0), (1.0, 0.0)):
        la, ra = rng.random(nl) < lp, rng.random(nr) < rp
        ref = np.asarray(j_semi_mask(jl, jr, lalive=jnp.asarray(la),
                                     ralive=jnp.asarray(ra)))
        got = join.semi_join_mask(tl, tr, lalive=torch.from_numpy(la),
                                  ralive=torch.from_numpy(ra)).numpy()
        np.testing.assert_array_equal(ref, got)          # semi: la & mask
        np.testing.assert_array_equal(la & ~ref, la & ~got)   # anti


_AGGS = [("x", "sum"), ("x", "mean"), ("x", "min"), ("x", "max"),
         ("y", "sum"), ("y", "count"), ("x", "size"), ("y", "max")]


def _groupby_inputs(rng, n, groups):
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6, n)
    x[rng.random(n) < 0.1] = -0.0
    x[rng.random(n) < 0.03] = np.nan
    return _tables(["k", "x", "y"],
                   [(rng.integers(0, groups, n).astype(np.int64),
                     rng.random(n) > 0.1),
                    (x, rng.random(n) > 0.1),
                    (rng.integers(-5, 5, n).astype(np.int8), None)])


def _same_groupby(jt, tt, alive, key_cap):
    ref, rvalid, rovf = j_groupby_capped(jt, ["k"], _AGGS, key_cap=key_cap,
                                         alive=jnp.asarray(alive))
    got, gvalid, govf = groupby_aggregate_capped(
        tt, ["k"], _AGGS, key_cap=key_cap, alive=torch.from_numpy(alive))
    rvalid = np.asarray(rvalid)
    np.testing.assert_array_equal(rvalid, gvalid.numpy())
    assert bool(rovf) == bool(govf) and got.num_rows == key_cap
    _same_tables(ref, got, rows=rvalid)
    return int(rvalid.sum()), bool(govf)


@pytest.mark.parametrize("share", [1.0, 0.6, 0.0])
def test_groupby_capped_matches_jax(share):
    """FLOAT64 sums and means with -0.0, NaN and nulls, INT8 sums, counts,
    sizes and extremes, at caps below, at and above the group count (20
    keys and the null key: 21 groups), dead rows excluded."""
    rng = np.random.default_rng(3)
    n = 600
    jt, tt = _groupby_inputs(rng, n, 20)
    alive = rng.random(n) < share
    live_groups = None
    for key_cap in (1, 16, 21, 22, 1000):
        live, ovf = _same_groupby(jt, tt, alive, key_cap)
        assert ovf == (share > 0 and key_cap < 21)
        live_groups = live if live_groups is None else max(live_groups, live)
    assert live_groups == (21 if share > 0 else 0)


def test_groupby_capped_dead_rows_stay_out_of_the_last_group():
    """The cap equal to the live group count with dead rows after the last
    live group in sort order: the dead rows' values (large, and in a key
    the live rows share) must not reach its sums, on the plain segment sum
    or the kernel's `starts` (the spare bucket ends the last kept group)."""
    n = 40
    k = np.repeat(np.arange(4, dtype=np.int64), 10)
    x = np.full(n, -0.0)
    x[5:10] = 1e300
    alive = np.ones(n, bool)
    alive[5:10] = False              # dead rows inside group 0's key
    alive[30:] = False               # and the whole last key
    jt, tt = _tables(["k", "x", "y"], [(k, None), (x, None),
                                       (k.astype(np.int8), None)])
    live, ovf = _same_groupby(jt, tt, alive, 3)
    assert live == 3 and not ovf
    got, valid, _ = groupby_aggregate_capped(
        tt, ["k"], [("x", "sum")], key_cap=3, alive=torch.from_numpy(alive))
    s = got.columns[1].data.numpy()
    assert valid.all() and not np.signbit(s).any() and (s == 0).all()
    # past the cap: group ids are clamped into the spare bucket
    live, ovf = _same_groupby(jt, tt, np.ones(n, bool), 2)
    assert live == 2 and ovf


def test_auto_retry_overflow_matches_jax():
    """The same attempts, caps and result as the reference's loop:
    geometric growth, the ceiling clamping growth, dropped when a clamped
    attempt still overflows or when it would block all growth, and the
    error once the attempts run out."""
    def script(needed, log):
        def attempt(**caps):
            log.append(dict(caps))
            ovf = any(caps[k] < v for k, v in needed.items())
            return ("result", torch.tensor(ovf))
        return attempt

    def jscript(needed, log):
        def attempt(**caps):
            log.append(dict(caps))
            ovf = any(caps[k] < v for k, v in needed.items())
            return ("result", jnp.asarray(ovf))
        return attempt

    cases = [
        ({"row_cap": 100}, {"row_cap": 7}, None, 6),
        ({"row_cap": 100, "key_cap": 3}, {"row_cap": 7, "key_cap": 1}, None,
         6),
        ({"row_cap": 100}, {"row_cap": 7}, {"row_cap": 50}, 6),   # dropped
        ({"row_cap": 40}, {"row_cap": 7}, {"row_cap": 50}, 6),    # clamps
        ({"row_cap": 100}, {"row_cap": 60}, {"row_cap": 60}, 6),  # blocks
        ({"row_cap": 10 ** 6}, {"row_cap": 1}, None, 4),          # exhausts
    ]
    for needed, start, ceil, attempts in cases:
        jl, tl = [], []
        try:
            jout = j_autoretry.auto_retry_overflow(
                jscript(needed, jl), dict(start), attempts, ceil=ceil)
        except j_autoretry.CapacityOverflowError:
            jout = None
        if jout is None:
            with pytest.raises(autoretry.CapacityOverflowError):
                autoretry.auto_retry_overflow(script(needed, tl),
                                              dict(start), attempts,
                                              ceil=ceil)
        else:
            tout = autoretry.auto_retry_overflow(script(needed, tl),
                                                 dict(start), attempts,
                                                 ceil=ceil)
            assert tout[1] == jout[1] and tout[0][0] == jout[0][0]
        assert tl == jl, (needed, start, ceil)


# ---- the capped kernels' CPU mirrors -----------------------------------------
#
# `join_cuda.probe_capped_plain` (the capped probe: per-tile sums, their
# exclusive prefix, each tile's pairs from its offset, every slot written)
# and `topk.topk_capped_mirror` (dead rows as sentinel tuples, the live
# count beside) against the plain versions and the JAX package. The JAX
# results are computed once per case (`_jax_join`, `_jax_topk`).

_MIRROR_TILE = 64        # mirror tiles of 64 rows: several a case


def _mirror_join_case(case):
    """(JAX left, right keys, port left, right keys, left alive, right
    alive) for one case, from a seed."""
    rng = np.random.default_rng(31)
    nl, nr = 300, 40
    if case == "many_to_many":       # 3 keys: each live row 10+ pairs
        lk = rng.integers(0, 3, nl).astype(np.int64)
        rk = rng.integers(0, 3, nr).astype(np.int64)
    else:
        lk = rng.integers(0, 30, nl).astype(np.int64)
        rk = rng.integers(0, 30, nr).astype(np.int64)
    if case == "zero_rows":
        rk = rk[:0]
    (jl, tl), (jr, tr) = _cols([(lk, rng.random(nl) > 0.1)]), _cols(
        [(rk, None)])
    la = rng.random(nl) < (0.0 if case == "all_dead" else 0.6)
    ra = rng.random(rk.shape[0]) < 0.8
    return jl, jr, tl, tr, la, ra


_JAX_CAPPED = {}


def _jax_join(case, cap):
    key = ("join", case, cap)
    if key not in _JAX_CAPPED:
        jl, jr, _, _, la, ra = _mirror_join_case(case)
        _JAX_CAPPED[key] = j_join_capped(jl, jr, row_cap=cap,
                                         lalive=jnp.asarray(la),
                                         ralive=jnp.asarray(ra))
    return _JAX_CAPPED[key]


def _mirror_join(case, cap):
    _, _, tl, tr, la, ra = _mirror_join_case(case)
    lal, ral = torch.from_numpy(la), torch.from_numpy(ra)
    if tr[0].length == 0:
        return join_cuda.inner_join_capped_hash(tl, tr, cap, lalive=lal,
                                                ralive=ral)
    table = join_cuda.build_table_plain(tr, join_cuda._capacity(
        tr[0].length), ral)
    return join_cuda.probe_capped_plain(tl, table, tr, cap, lal,
                                        tile=_MIRROR_TILE)


@pytest.mark.parametrize("case,cap", [
    ("int64", "total"), ("int64", "total+1"), ("int64", "half"),
    ("many_to_many", "total"), ("many_to_many", "half"),
    ("all_dead", "total+1"), ("zero_rows", "total+1")])
def test_capped_probe_mirror_matches_jax(case, cap):
    """The capped probe's mirror at row_cap equal to the total, the total
    + 1 and half the total (overflowing): all four outputs bit for bit
    those of `join.inner_join_capped` and the JAX package's capped join;
    a many-to-many key whose pairs cross the mirror's 64-row tiles; every
    probe row dead; a zero-row build side."""
    roomy = _jax_join(case, 8192)
    total = int(np.asarray(roomy[2]).sum())
    if case in ("all_dead", "zero_rows"):
        assert total == 0
    else:
        assert total > 2 * _MIRROR_TILE
    row_cap = {"total": total, "total+1": total + 1,
               "half": total // 2}[cap]
    ref = _jax_join(case, row_cap)
    got = _mirror_join(case, row_cap)
    _same(ref, got, f"{case} {cap}")
    _, _, tl, tr, la, ra = _mirror_join_case(case)
    plain = join.inner_join_capped(tl, tr, row_cap,
                                   lalive=torch.from_numpy(la),
                                   ralive=torch.from_numpy(ra))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert bool(got[3]) == (cap == "half")


def _jax_topk(share, keys, asc, k):
    key = ("topk", share, tuple(keys), tuple(asc), k)
    if key not in _JAX_CAPPED:
        jt, _, alive = _mirror_topk_case(share)
        _JAX_CAPPED[key] = topk_pallas.topk_capped(
            jt, keys, asc, k, jnp.asarray(alive), block_rows=256)
    return _JAX_CAPPED[key]


def _mirror_topk_case(share):
    rng = np.random.default_rng(41)
    n = 240                      # one block of the reference's kernel
    jt, tt = _topk_tables(rng, n)
    return jt, tt, rng.random(n) < share


@pytest.mark.parametrize("share", [0.0, 0.6, 1.0])
def test_capped_topk_mirror_matches_jax(share):
    """The capped TopK's mirror (dead rows as sentinel tuples, n_live
    counted beside) at 0%, 60% and 100% live, with k below, at and above
    the live count and k = 0: equal to `topk.topk_capped_plain` and to
    the JAX package's `topk_capped` in interpret mode at one block."""
    _, tt, alive = _mirror_topk_case(share)
    live = int(alive.sum())
    ta = torch.from_numpy(alive)
    for keys, asc, k in ((["k", "f"], [True, False], 17),
                         (["pay", "k"], [False, True], max(live + 9, 1)),
                         (["f"], [True], 0)):
        got = topk.topk_capped_mirror(tt, keys, asc, k, ta)
        want = topk.topk_capped_plain(tt, keys, asc, k, ta)
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[0].columns, want[0].columns):
            assert torch.equal(a.data, b.data)
        assert int(got[1].sum()) == min(k, live)
        if k:
            rt, ra = _jax_topk(share, keys, asc, k)
            np.testing.assert_array_equal(np.asarray(ra), got[1].numpy())
            _same_tables(rt, got[0])
        else:
            assert got[0].num_rows == 0
