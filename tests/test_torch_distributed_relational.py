"""The port's distributed relational ops (`parallel/relational.py`) and
their `_auto` wrappers (`parallel/autoretry.py`) against the JAX
package's on 2-peer meshes (the JAX side jit-compiled, each op as its
own program), with the reference tests' shapes scaled down: every
returned array element for element, padded slots, valid masks and
overflow flags included; caps that fit and caps that overflow; typed
keys (nullable INT64 and STRING words) and a narrowed-word repartition.
The `_auto` wrappers run the JAX wrapper with its op jit-compiled (the
same function, compiled once) and must return what the port's returns.
Tolerance: exact (integers)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu import parallel as jpar
from spark_rapids_tpu.parallel import autoretry as jauto
from spark_rapids_tpu.plan import transport as jtr

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import parallel as tpar
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.parallel import partition_cuda
from spark_rapids_tpu_torch.parallel import relational as trel
from spark_rapids_tpu_torch.plan import transport as ttr

P = 2
_JM = jpar.make_mesh(P)
_TM = tpar.make_mesh(P, devices=["cpu"] * P)
_N = 64


def _flat(x):
    if isinstance(x, (list, tuple)):
        out = []
        for y in x:
            out.extend(_flat(y))
        return out
    return [x]


def _same(jout, tout):
    j, t = _flat(jout), _flat(tout)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _data(seed=0, nk=9):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nk, _N), rng.integers(-50, 50, _N),
            rng.integers(0, 12, _N), rng.integers(0, 9, _N),
            rng.random(_N) < 0.8)


def _typed(seed):
    """Nullable INT64 and STRING key words in both packages."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 5, _N)
    valid = rng.random(_N) < 0.85
    pool = ["", "ab", "abcdefgh", "zz", "q"]
    strs = [pool[i] for i in rng.integers(0, len(pool), _N)]
    jw, specs = jpar.encode_key_columns(
        [JColumn.from_numpy(ints, jdt.INT64, valid),
         JColumn.from_pylist(strs, jdt.STRING)], max_bytes=[None, 8])
    tw, tspecs = tpar.encode_key_columns(
        [TColumn.from_numpy(ints, tdt.INT64, valid, device="cpu"),
         TColumn.from_pylist(strs, tdt.STRING, device="cpu")],
        max_bytes=[None, 8])
    return jw, specs, tw, tspecs


@pytest.mark.parametrize("key_cap", [3])       # overflows; fits: _auto
def test_groupby_equals_jax(key_cap):
    k, v, _, _, _ = _data()
    (jk, jv), (tk, tv) = _both(k, v)
    aggs = ["sum", "count", "min", "max"]
    j = jax.jit(lambda a, b: jpar.distributed_groupby(
        _JM, a, b, aggs, key_cap=key_cap))(jk, jv)
    _same(j, tpar.distributed_groupby(_TM, tk, tv, aggs, key_cap=key_cap))
    assert bool(np.asarray(j[-1]).any()) == (key_cap == 3)


def test_groupby_multi_and_local_equal_jax():
    k, v, k2, v2, alive = _data(1)
    (jk, jv, jk2, jv2, jal), (tk, tv, tk2, tv2, tal) = _both(k, v, k2, v2,
                                                             alive)
    aggs = [(0, "sum"), (1, "max"), (0, "count"), (1, "min")]
    j = jax.jit(lambda a, b, c, d, e: jpar.distributed_groupby_multi(
        _JM, [a, b], [c, d], aggs, key_cap=48, alive=e))(jk, jk2, jv, jv2,
                                                         jal)
    _same(j, tpar.distributed_groupby_multi(_TM, [tk, tk2], [tv, tv2], aggs,
                                            key_cap=48, alive=tal))
    j = jax.jit(lambda a, b, c, e: jpar.distributed_local_groupby(
        _JM, [a, b], [c], aggs[:1], key_cap=8, alive=e))(jk, jk2, jv, jal)
    _same(j, tpar.distributed_local_groupby(_TM, [tk, tk2], [tv], aggs[:1],
                                            key_cap=8, alive=tal))


def test_groupby_keyed_equals_jax():
    jw, specs, tw, tspecs = _typed(2)
    _, v, _, _, alive = _data(2)
    (jv, jal), (tv, tal) = _both(v, alive)
    aggs = [(0, "sum"), (0, "count")]
    j = jax.jit(lambda ws, b, e: jpar.distributed_groupby_keyed(
        _JM, ws, specs, [b], aggs, key_cap=32, alive=e))(jw, jv, jal)
    t = tpar.distributed_groupby_keyed(_TM, tw, tspecs, [tv], aggs,
                                       key_cap=32, alive=tal)
    _same(j, t)
    jd = jpar.decode_key_columns(j[0], specs, alive=j[2])
    td = tpar.decode_key_columns(t[0], tspecs, alive=t[2])
    assert [c.to_pylist() for c in jd] == [c.to_pylist() for c in td]


@pytest.mark.parametrize("narrow", [False, True])
def test_repartition_keyed_equals_jax(narrow):
    jw, specs, tw, tspecs = _typed(3)
    _, v, _, _, alive = _data(3)
    (jv, jal), (tv, tal) = _both(v, alive)
    jrefs, trefs, codecs = [], [], None
    if narrow:
        jw, jplans, _, _ = jtr.narrow_words(jw, jal)
        tw, tplans, _, _ = ttr.narrow_words(tw, tal)
        codecs = tuple(p.codec for p in tplans)
        jrefs = [jnp.full((1,), p.ref, jnp.int64) for p in jplans
                 if p.codec != "raw"]
        trefs = [torch.full((1,), p.ref, dtype=torch.int64) for p in tplans
                 if p.codec != "raw"]
        assert codecs == tuple(p.codec for p in jplans) and "for8" in codecs
    j = jax.jit(lambda ws, b, e, rs: jpar.distributed_repartition_keyed(
        _JM, ws, specs, [b], slack=1.0, alive=e, word_codecs=codecs,
        word_refs=rs or None))(jw, jv, jal, jrefs)
    _same(j, tpar.distributed_repartition_keyed(
        _TM, tw, tspecs, [tv], slack=1.0, alive=tal, word_codecs=codecs,
        word_refs=trefs or None))


# the shuffled inner form: the meshed plans' joins
@pytest.mark.parametrize("how,rep", [("inner", True), ("left_semi", False),
                                     ("left_anti", True)])
def test_colocated_join_equals_jax(how, rep):
    jw, specs, tw, tspecs = _typed(4)
    jr, _, tr, _ = _typed(5)
    _, v, _, v2, alive = _data(4)
    (jv, jv2, jal), (tv, tv2, tal) = _both(v, v2, alive)
    jfn = jax.jit(lambda a, b, c, d, e: jpar.distributed_colocated_join_keyed(
        _JM, a, [b], c, [d], specs, row_cap=96, how=how, lalive=e,
        r_replicated=rep))
    _same(jfn(jw, jv, jr, jv2, jal),
          tpar.distributed_colocated_join_keyed(
              _TM, tw, [tv], tr, [tv2], tspecs, row_cap=96, how=how,
              lalive=tal, r_replicated=rep))


def test_sort_equals_jax():
    """The int64 sort and the keyed sort with two payloads and an alive
    mask (an overflowing slack: the _auto test)."""
    k, v, _, v2, alive = _data(6, nk=40)
    (jk, jv, jv2, jal), (tk, tv, tv2, tal) = _both(k, v, v2, alive)
    j = jax.jit(lambda a, b: jpar.distributed_sort(_JM, a, b))(jk, jv)
    _same(j, tpar.distributed_sort(_TM, tk, tv))
    jw, specs, tw, tspecs = _typed(6)
    j = jax.jit(lambda ws, b, c, e: jpar.distributed_sort_keyed(
        _JM, ws, specs, [b, c], alive=e))(jw, jv, jv2, jal)
    _same(j, tpar.distributed_sort_keyed(_TM, tw, tspecs, [tv, tv2],
                                         alive=tal))


@pytest.mark.parametrize("op", ["distributed_left_semi_join",
                                "distributed_left_anti_join"])
def test_int_semi_anti_equal_jax(op):
    lk, lv, rk, _, _ = _data(8)
    (a, b, c), (x, y, z) = _both(lk, lv, rk)
    j = jax.jit(lambda *xs: getattr(jpar, op)(_JM, *xs, slack=1.0))(a, b, c)
    _same(j, getattr(tpar, op)(_TM, x, y, z, slack=1.0))


# the keyed inner, left and broadcast joins: the _auto test
@pytest.mark.parametrize("op", ["distributed_left_semi_join_keyed",
                                "distributed_left_anti_join_keyed"])
def test_keyed_joins_equal_jax(op):
    jw, specs, tw, tspecs = _typed(9)
    jr, _, tr, _ = _typed(10)
    _, v, _, _, _ = _data(9)
    (jv,), (tv,) = _both(v)
    j = jax.jit(lambda a, b, c: getattr(jpar, op)(
        _JM, a, [b], c, specs))(jw, jv, jr)
    _same(j, getattr(tpar, op)(_TM, tw, [tv], tr, tspecs))


# ---- the _auto wrappers ------------------------------------------------------------

def _is_arrays(a):
    if isinstance(a, jax.Array):
        return True
    return (isinstance(a, (list, tuple)) and bool(a)
            and all(isinstance(x, jax.Array) for x in a))


def _jitted(fn):
    """`fn` (a JAX distributed op) compiled once per set of static
    arguments (the mesh, specs, aggregate lists and caps close over; the
    arrays and lists of arrays are traced)."""
    cache = {}

    def call(mesh, *args, **kw):
        dyn = [_is_arrays(a) for a in args]
        static = [None if d else a for a, d in zip(args, dyn)]
        key = (tuple(dyn), repr(static), repr(sorted(kw.items())))
        if key not in cache:
            def run(*xs):
                it = iter(xs)
                return fn(mesh, *[next(it) if d else s
                                  for d, s in zip(dyn, static)], **kw)
            cache[key] = jax.jit(run)
        return cache[key](*[a for a, d in zip(args, dyn) if d])
    return call


@pytest.mark.parametrize("name,cap", [("groupby", {"key_cap": 6}),
                                      ("inner_join", {"row_cap": 128}),
                                      ("left_join", {"row_cap": 128}),
                                      ("broadcast_join", {"row_cap": 128}),
                                      ("sort", {"slack": 0.5})])
def test_auto_wrappers_equal_jax(monkeypatch, name, cap):
    """An undersized cap grows to the same final caps (the outputs' shapes
    are the caps) and results as the JAX wrapper's; the keyed forms too
    for the joins and the groupby."""
    op = f"distributed_{name}"
    monkeypatch.setattr(jauto, op, _jitted(getattr(jpar, op)))
    calls = []
    real = getattr(trel, op)
    monkeypatch.setattr(trel, op, lambda *a, **k: calls.append(k) or
                        real(*a, **k))
    lk, lv, rk, rv, _ = _data(11)
    (a, b, c, d), (w, x, y, z) = _both(lk, lv, rk, rv)
    auto = f"{op}_auto"
    if name == "groupby":
        j = getattr(jauto, auto)(_JM, a, b, ["sum", "count"], **cap)
        t = getattr(tpar, auto)(_TM, w, x, ["sum", "count"], **cap)
    elif name == "sort":
        j = getattr(jauto, auto)(_JM, a, b, **cap)
        t = getattr(tpar, auto)(_TM, w, x, **cap)
    else:
        j = getattr(jauto, auto)(_JM, a, b, c, d, **cap)
        t = getattr(tpar, auto)(_TM, w, x, y, z, **cap)
    _same(j, t)
    assert not np.asarray(j[-1]).any()
    assert len(calls) > 1          # the first caps overflowed
    if name == "sort":
        return
    kop = f"{op}_keyed"
    monkeypatch.setattr(jauto, kop, _jitted(getattr(jpar, kop)))
    jw, specs, tw, tspecs = _typed(12)
    jr, _, tr, _ = _typed(13)
    # caps that fit at once: the ladder is the one checked above
    if name == "groupby":
        j = jauto.distributed_groupby_keyed_auto(
            _JM, jw, specs, [b], [(0, "sum")], key_cap=64)
        t = tpar.distributed_groupby_keyed_auto(
            _TM, tw, tspecs, [x], [(0, "sum")], key_cap=64)
    else:
        j = getattr(jauto, f"{kop}_auto")(_JM, jw, [b], jr, [d], specs,
                                          row_cap=1024)
        t = getattr(tpar, f"{kop}_auto")(_TM, tw, [x], tr, [z], tspecs,
                                         row_cap=1024)
    _same(j, t)
    assert not np.asarray(j[-1]).any()


def test_ops_run_the_plain_map_and_hash_on_the_cpu():
    partition_cuda.reset_counters()
    lk, lv, rk, rv, _ = _data(14)
    tpar.distributed_inner_join(_TM, *_both(lk, lv, rk, rv)[1], row_cap=64)
    assert partition_cuda.PLAIN_CALLS["exchange_map"] == 2
    assert partition_cuda.LAUNCHES["exchange_map"] == 0
