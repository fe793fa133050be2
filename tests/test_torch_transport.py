"""The port's exchange transport (`plan/transport.py`) against the JAX
package's: `pack_device`'s planes (dtype and every element, dead slots
included), plans, wire and logical bytes and codec notes for each codec
set and `none`; `unpack_device` and its numpy mirror; `narrow_words` and
`widen_words`; `pack_bits_device`; `pack_host`'s codec choices, byte
counts and planes (raw, FOR, dictionary and run length), `unpack_host`
and `unpack_host_device`; and `resolve_codecs`. Tolerance: exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.plan import transport as jtr

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.plan import transport as ttr

_N = 64


def _cols(seed=0):
    """Both packages' columns: narrowable and wide integers, nullable
    ones, a bool, a float, a constant, all live ranges the codecs test."""
    rng = np.random.default_rng(seed)
    spec = [("small", "INT64", rng.integers(-100, 100, _N), None),
            ("mid", "INT32", rng.integers(0, 40000, _N).astype(np.int32),
             rng.random(_N) < 0.8),
            ("wide", "INT64", rng.integers(-2 ** 40, 2 ** 40, _N), None),
            ("i16", "INT16", rng.integers(-300, 300, _N).astype(np.int16),
             rng.random(_N) < 0.5),
            ("flag", "BOOL", rng.random(_N) < 0.5, rng.random(_N) < 0.9),
            ("x", "FLOAT64", rng.standard_normal(_N), None),
            ("const", "INT64", np.full(_N, 7), None),
            ("sorted", "INT64", np.sort(rng.integers(0, 5, _N)), None)]
    jc = [JColumn.from_numpy(a, getattr(jdt, d), v) for _, d, a, v in spec]
    tc = [TColumn.from_numpy(a, getattr(tdt, d), v, device="cpu")
          for _, d, a, v in spec]
    return [s[0] for s in spec], jc, tc


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(j, t)


_CODECS = ["auto", "none", "for", "bitpack", "for,bitpack", "dict,rle"]


@pytest.mark.parametrize("codecs", _CODECS)
def test_pack_device_planes_equal_jax(codecs):
    names, jc, tc = _cols()
    live = np.random.default_rng(1).random(_N) < 0.7
    jp = jtr.pack_device(jc, names, jnp.asarray(live),
                         jtr.resolve_codecs(codecs))
    tp = ttr.pack_device(tc, names, torch.from_numpy(live),
                         ttr.resolve_codecs(codecs))
    assert (jp.n_planes, jp.wire_row_bytes, jp.logical_row_bytes,
            jp.codec_str) == (tp.n_planes, tp.wire_row_bytes,
                              tp.logical_row_bytes, tp.codec_str)
    assert [(p.name, p.codec, p.ref, p.plane, p.vplane, p.vbit)
            for p in jp.plans] == [(p.name, p.codec, p.ref, p.plane,
                                    p.vplane, p.vbit) for p in tp.plans]
    for a, b in zip(jp.planes, tp.planes):
        _eq(a, b)
    for a, b in zip(jtr.unpack_device(jp.planes, jp),
                    ttr.unpack_device(tp.planes, tp)):
        v = live & np.asarray(a.null_mask)
        np.testing.assert_array_equal(np.asarray(a.data)[v],
                                      b.data.numpy()[v])
        np.testing.assert_array_equal(np.asarray(a.null_mask),
                                      b.null_mask.numpy())
    host = [np.asarray(p) for p in jp.planes]
    for (a, av), (b, bv) in zip(jtr.unpack_device_np(host, jp),
                                ttr.unpack_device_np(
                                    [p.view(torch.int16).numpy().view(
                                        np.uint16) if p.dtype == torch.uint16
                                     else p.view(torch.int32).numpy().view(
                                         np.uint32)
                                     if p.dtype == torch.uint32
                                     else p.numpy() for p in tp.planes],
                                    tp)):
        _eq(a, b)
        assert (av is None) == (bv is None)
        if av is not None:
            _eq(av, bv)


def test_narrow_and_widen_words_equal_jax():
    rng = np.random.default_rng(3)
    words = [rng.integers(5, 200, _N), rng.integers(-2 ** 20, 2 ** 20, _N),
             rng.integers(0, 2 ** 31, _N) + 2 ** 40,
             rng.integers(-2 ** 62, 2 ** 62, _N),
             (rng.random(_N) < 0.5).astype(np.int64)]
    words[1][:3] = 2 ** 63 - 1                 # dead slots' sentinel
    live = np.ones(_N, bool)
    live[:3] = False
    jp, jplans, jwire, jnote = jtr.narrow_words(
        [jnp.asarray(w) for w in words], jnp.asarray(live))
    tp, tplans, twire, tnote = ttr.narrow_words(
        [torch.from_numpy(w) for w in words], torch.from_numpy(live))
    assert [(p.codec, p.ref, p.nbytes) for p in jplans] == \
        [(p.codec, p.ref, p.nbytes) for p in tplans]
    assert (jwire, jnote) == (twire, tnote)
    assert [p.codec for p in tplans] == ["for8", "for32", "for32", "raw",
                                         "for8"]
    for a, b in zip(jp, tp):
        _eq(a, b)
    for a, b in zip(jtr.widen_words(jp, jplans), ttr.widen_words(tp, tplans)):
        np.testing.assert_array_equal(np.asarray(a)[live], b.numpy()[live])


@pytest.mark.parametrize("n", [0, 1, 8, 13, 64])
def test_pack_bits_equal_jax(n):
    mask = np.random.default_rng(n).random(n) < 0.5
    jplane, jn = jtr.pack_bits_device(jnp.asarray(mask))
    tplane, tn = ttr.pack_bits_device(torch.from_numpy(mask))
    assert jn == tn
    _eq(jplane, tplane)
    np.testing.assert_array_equal(ttr.unpack_bits_np(tplane.numpy(), n),
                                  mask)


@pytest.mark.parametrize("codecs", _CODECS)
def test_pack_host_equal_jax(codecs):
    names, jc, tc = _cols(seed=5)
    jh = jtr.pack_host(jc, names, jtr.resolve_codecs(codecs))
    th = ttr.pack_host(tc, names, ttr.resolve_codecs(codecs))
    assert (jh.n, jh.names, jh.wire_bytes, jh.logical_bytes,
            jh.codec_str) == (th.n, th.names, th.wire_bytes,
                              th.logical_bytes, th.codec_str)
    for a, b in zip(jh.cols, th.cols):
        assert (a.codec, a.ref, a.vpacked) == (b.codec, b.ref, b.vpacked)
        for x, y in ((a.data, b.data), (a.values, b.values),
                     (a.lengths, b.lengths), (a.validity, b.validity)):
            assert (x is None) == (y is None)
            if x is not None:
                _eq(x, y)
    for a, b, c in zip(jtr.unpack_host(jh), ttr.unpack_host(th),
                       ttr.unpack_host_device(th, lambda x: x)):
        np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
        np.testing.assert_array_equal(b.data.numpy(), c.data.numpy())
        np.testing.assert_array_equal(np.asarray(a.null_mask),
                                      c.null_mask.numpy())


def test_resolve_codecs_equal_jax():
    for spec in ("auto", "none", "for", " dict , rle ", "bitpack,for"):
        assert jtr.resolve_codecs(spec) == ttr.resolve_codecs(spec)
    for mod in (jtr, ttr):
        with pytest.raises(ValueError, match="unknown exchange codec"):
            mod.resolve_codecs("for,zstd")
    assert ttr.ALL_CODECS == jtr.ALL_CODECS
