"""The rest of the port's `ops/join.py` (outer joins, `null_equal`, the
capped joins and the span functions) against the JAX package's on the CPU,
on the same numpy inputs, split from tests/test_torch_join.py so that the
two files spread over two test workers. Inner, left and full joins, semi
and anti, under `null_equal` both ways, pair for pair in order; the capped
joins with alive masks at caps below, at and above the match count; the
span functions' counts, lows and orders and their expansion. The tolerance
is exact: join maps are integers.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.ops import join as tjoin


def _tcol(jc: JColumn) -> TColumn:
    v = None if jc.validity is None else np.asarray(jc.validity)
    return TColumn.from_numpy(np.asarray(jc.data),
                              tdt.DType(tdt.Kind(jc.dtype.kind.value),
                                        jc.dtype.precision, jc.dtype.scale),
                              v, device="cpu")


def _assert_maps(ref, got):
    rl, rr = ref
    gl, gr = got
    npt.assert_array_equal(np.asarray(rl.data), gl.data.numpy())
    npt.assert_array_equal(np.asarray(rr.data), gr.data.numpy())
    assert gl.data.dtype == torch.int32 and gr.data.dtype == torch.int32



def _outer_keys(rng, kind, n, two_keys):
    """Random INT64 or FLOAT64 key columns with nulls: small ranges so
    runs repeat; floats with NaN, ±0.0 and inf, which match as the
    reference's total order says."""
    cols = []
    for _ in range(2 if two_keys else 1):
        if kind == "int64":
            d = rng.integers(-4, 5, n).astype(np.int64)
        else:
            d = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25,
                                     np.inf]), n)
        v = rng.random(n) > 0.25
        cols.append(JColumn.from_numpy(d, validity=v))
    return cols


_OUTER_CASES = [(kind, nl, nr, two)
                for kind in ("int64", "float64")
                for nl, nr in ((0, 5), (7, 0), (40, 25), (300, 90))
                for two in (False, True)]


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("kind,nl,nr,two", _OUTER_CASES)
def test_joins_match_jax_pair_for_pair(kind, nl, nr, two, null_equal):
    """inner, left and full joins, semi and anti, under `null_equal` both
    ways: the gather maps equal the reference's pair for pair, in order."""
    from spark_rapids_tpu.ops import join as jjoin
    rng = np.random.default_rng(nl * 1000 + nr + two)
    jl, jr = _outer_keys(rng, kind, nl, two), _outer_keys(rng, kind, nr, two)
    tl, tr = [_tcol(c) for c in jl], [_tcol(c) for c in jr]
    for name in ("inner_join", "left_join", "full_join"):
        _assert_maps(getattr(jjoin, name)(jl, jr, null_equal),
                     getattr(tjoin, name)(tl, tr, null_equal))
    for name in ("left_semi_join", "left_anti_join"):
        want = getattr(jjoin, name)(jl, jr, null_equal)
        got = getattr(tjoin, name)(tl, tr, null_equal)
        npt.assert_array_equal(np.asarray(want.data), got.data.numpy())
    # a left join keeps every left row; null_equal changes what matches
    lm, rm = tjoin.left_join(tl, tr, null_equal)
    assert set(lm.data.tolist()) == set(range(nl))


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("kind,nl,nr,two", _OUTER_CASES)
def test_capped_joins_match_jax(kind, nl, nr, two, null_equal):
    """left_join_capped (lmap, rmap, rvalid, valid, overflow),
    inner_join_capped and semi_join_mask with alive masks, at caps below,
    at and above the match count, equal the reference's element for
    element."""
    import jax.numpy as jnp
    from spark_rapids_tpu.ops import join as jjoin
    rng = np.random.default_rng(nl * 7 + nr + two)
    jl, jr = _outer_keys(rng, kind, nl, two), _outer_keys(rng, kind, nr, two)
    tl, tr = [_tcol(c) for c in jl], [_tcol(c) for c in jr]
    la, ra = rng.random(nl) > 0.2, rng.random(nr) > 0.2
    full = int(tjoin.left_join(tl, tr, null_equal)[0].length)
    for cap in sorted({0, full // 2, full + 9}):
        want = jjoin.left_join_capped(jl, jr, cap, lalive=jnp.asarray(la),
                                      ralive=jnp.asarray(ra),
                                      null_equal=null_equal)
        got = tjoin.left_join_capped(tl, tr, cap, lalive=torch.tensor(la),
                                     ralive=torch.tensor(ra),
                                     null_equal=null_equal)
        assert len(got) == 5
        for w, g in zip(want, got):
            npt.assert_array_equal(np.asarray(w), g.numpy())
        want = jjoin.inner_join_capped(jl, jr, cap, lalive=jnp.asarray(la),
                                       ralive=jnp.asarray(ra),
                                       null_equal=null_equal)
        got = tjoin.inner_join_capped(tl, tr, cap, lalive=torch.tensor(la),
                                      ralive=torch.tensor(ra),
                                      null_equal=null_equal)
        for w, g in zip(want, got):
            npt.assert_array_equal(np.asarray(w), g.numpy())
    npt.assert_array_equal(
        np.asarray(jjoin.semi_join_mask(jl, jr, lalive=jnp.asarray(la),
                                        null_equal=null_equal)),
        tjoin.semi_join_mask(tl, tr, lalive=torch.tensor(la),
                             null_equal=null_equal).numpy())
    # without masks the capped left join is the eager one's prefix
    lm, rm, rv, v, ovf = tjoin.left_join_capped(tl, tr, full + 3,
                                                null_equal=null_equal)
    el, er = tjoin.left_join(tl, tr, null_equal)
    assert not bool(ovf) and int(v.sum()) == full
    npt.assert_array_equal(lm[:full].numpy(), el.data.numpy())
    npt.assert_array_equal(np.where(rv[:full].numpy(), rm[:full].numpy(),
                                    -1), er.data.numpy())


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_join_spans_and_expand_spans_match_jax(kind):
    """The public span functions: counts, lo and rorder (matchable right
    rows first, then n) from the same union operands and match masks, and
    their expansion into static slots, outer or not, with and without an
    emit count, padded slots included."""
    import jax.numpy as jnp
    from spark_rapids_tpu.ops import join as jjoin
    from spark_rapids_tpu.ops.sort import _key_operands as jkey_operands
    from spark_rapids_tpu_torch.ops.sort import _key_operands
    rng = np.random.default_rng(5)
    for nl, nr in ((0, 4), (6, 0), (120, 60)):
        (jl,), (jr,) = (_outer_keys(rng, kind, nl, False),
                        _outer_keys(rng, kind, nr, False))
        jops = jkey_operands(jjoin._concat_columns(jl, jr), True, None)
        tops = _key_operands(tjoin._concat(_tcol(jl), _tcol(jr)), True, None)
        lv, rv = rng.random(nl) > 0.3, rng.random(nr) > 0.3
        want = jjoin.join_spans(jops, jnp.asarray(lv), jnp.asarray(rv),
                                nl=nl)
        got = tjoin.join_spans(tops, torch.tensor(lv), torch.tensor(rv),
                               nl=nl)
        for w, g in zip(want, got):
            npt.assert_array_equal(np.asarray(w), g.numpy())
        eff = rng.integers(0, 3, nl)
        for outer in (False, True):
            for total in (0, 200):
                for e in (None, eff):
                    w = jjoin.expand_spans(*want, total=total, outer=outer,
                                           eff=None if e is None
                                           else jnp.asarray(e))
                    g = tjoin.expand_spans(*got, total=total, outer=outer,
                                           eff=None if e is None
                                           else torch.tensor(e))
                    for a, b in zip(w, g):
                        npt.assert_array_equal(np.asarray(a), b.numpy())


def test_null_equal_matches_null_keys_only_when_asked():
    """Null keys match each other under null_equal, and alive masks still
    exclude their rows."""
    lk = [TColumn.from_pylist([None, 1, None, 2], tdt.INT64, device="cpu")]
    rk = [TColumn.from_pylist([None, 2, None], tdt.INT64, device="cpu")]
    lm, rm = tjoin.inner_join(lk, rk)
    assert list(zip(lm.data.tolist(), rm.data.tolist())) == [(3, 1)]
    lm, rm = tjoin.inner_join(lk, rk, null_equal=True)
    assert list(zip(lm.data.tolist(), rm.data.tolist())) == [
        (0, 0), (0, 2), (2, 0), (2, 2), (3, 1)]
    lm, rm = tjoin.full_join(lk, rk)
    assert list(zip(lm.data.tolist(), rm.data.tolist())) == [
        (0, -1), (1, -1), (2, -1), (3, 1), (-1, 0), (-1, 2)]
    mask = tjoin.semi_join_mask(lk, rk, ralive=torch.tensor([False, True,
                                                             True]),
                                null_equal=True)
    assert mask.tolist() == [True, False, True, True]
    mask = tjoin.semi_join_mask(lk, rk, lalive=torch.tensor([False, True,
                                                             True, True]),
                                ralive=torch.tensor([False, True, False]),
                                null_equal=True)
    assert mask.tolist() == [False, False, False, True]
