"""The port's typed key codec (`parallel/keys.py`) against the JAX
package's, over every kind of the width table: the words and specs of
`encode_key_column(s)`, `decode_key_columns` (with and without an alive
mask), `keys_null_mask` and `spark_partition_hash`, on columns with nulls
and without; -0.0, NaN payloads and infinities; empty strings and strings
exactly `max_bytes` long; DECIMAL128 at its extremes; a spec forced onto
the side without nulls; and the errors. Tolerance: exact (words and
hashes are integers; decoded floats compared by their bits), except where
the reference flushes a float subnormal or decodes FLOAT64 inexactly
(ROADMAP queue C, deviation 12): there the port is held to the input's
bits and Spark's hash of them, and to the JAX package on the other
rows."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.parallel import keys as jkeys

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.ops import hash_cuda
from spark_rapids_tpu_torch.parallel import keys as tkeys

_N = 24


def _bits64(vals):
    return np.array(vals, dtype=np.uint64).view(np.float64)


def _bits32(vals):
    return np.array(vals, dtype=np.uint32).view(np.float32)


def _floats(rng, width):
    specials = ([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5] if width == 64 else
                [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5])
    if width == 64:
        nans = _bits64([0x7FF8000000000000, 0x7FF0000000000001,
                        0xFFF8000000000123, 0x0000000000000001])
        body = rng.standard_normal(_N - len(specials) - len(nans))
        return np.concatenate([np.array(specials), nans, body])
    nans = _bits32([0x7FC00000, 0x7F800001, 0xFFC00123, 0x00000001])
    body = rng.standard_normal(_N - len(specials) - len(nans)).astype(
        np.float32)
    return np.concatenate([np.array(specials, np.float32), nans, body])


_FIXED = {
    "bool": ("BOOL", lambda r: r.random(_N) < 0.5),
    "int8": ("INT8", lambda r: r.integers(-128, 128, _N).astype(np.int8)),
    "int16": ("INT16", lambda r: r.integers(-2 ** 15, 2 ** 15, _N)
              .astype(np.int16)),
    "int32": ("INT32", lambda r: r.integers(-2 ** 31, 2 ** 31, _N)
              .astype(np.int32)),
    "int64": ("INT64", lambda r: np.concatenate(
        [[-2 ** 63, 2 ** 63 - 2, 0, -1],
         r.integers(-2 ** 62, 2 ** 62, _N - 4)]).astype(np.int64)),
    "date32": ("DATE32", lambda r: r.integers(-9999, 99999, _N)
               .astype(np.int32)),
    "timestamp_us": ("TIMESTAMP_US", lambda r: r.integers(
        -2 ** 60, 2 ** 60, _N).astype(np.int64)),
    "timestamp_s": ("TIMESTAMP_S", lambda r: r.integers(
        -2 ** 40, 2 ** 40, _N).astype(np.int64)),
    "timestamp_ms": ("TIMESTAMP_MS", lambda r: r.integers(
        -2 ** 50, 2 ** 50, _N).astype(np.int64)),
    "decimal32": (("decimal", 9, 2), lambda r: r.integers(
        -10 ** 9 + 1, 10 ** 9, _N).astype(np.int32)),
    "decimal64": (("decimal", 18, 3), lambda r: r.integers(
        -10 ** 18 + 1, 10 ** 18, _N).astype(np.int64)),
    "float32": ("FLOAT32", lambda r: _floats(r, 32)),
    "float64": ("FLOAT64", lambda r: _floats(r, 64)),
}


def _dtype(mod, spec):
    if isinstance(spec, tuple):
        return mod.decimal(spec[1], spec[2])
    return getattr(mod, spec)


def _make(kind, nulls, seed=0):
    """The same column in both packages."""
    rng = np.random.default_rng(seed)
    valid = (rng.random(_N) < 0.75) if nulls else None
    if kind in _FIXED:
        spec, gen = _FIXED[kind]
        arr = gen(rng)
        return (JColumn.from_numpy(arr, _dtype(jdt, spec), valid),
                TColumn.from_numpy(arr, _dtype(tdt, spec), valid,
                                   device="cpu"))
    if kind == "decimal128":
        ext = [2 ** 127 - 1, -2 ** 127, 10 ** 38 - 1, -10 ** 38 + 1, 0, 1,
               -1, 2 ** 64, -2 ** 64, 2 ** 63 - 1]
        vals = ext + [int(x) * 10 ** 20 + int(y) for x, y in zip(
            rng.integers(-10 ** 17, 10 ** 17, _N - len(ext)),
            rng.integers(0, 10 ** 18, _N - len(ext)))]
        if nulls:
            vals = [v if ok else None for v, ok in zip(vals, valid)]
        return (JColumn.from_pylist(vals, jdt.decimal(38, 4)),
                TColumn.from_pylist(vals, tdt.decimal(38, 4), device="cpu"))
    assert kind == "string"
    pool = ["", "a", "abcdefgh", "abcdefghi", "0123456789abcdef",
            "été", "zzzzzzzzzzzzzzzz", "b", "ab"]
    vals = [pool[i] for i in rng.integers(0, len(pool), _N)]
    if nulls:
        vals = [v if ok else None for v, ok in zip(vals, valid)]
    return (JColumn.from_pylist(vals, jdt.STRING),
            TColumn.from_pylist(vals, tdt.STRING, device="cpu"))


_KINDS = list(_FIXED) + ["decimal128", "string"]
_UNHASHED = ("timestamp_s", "timestamp_ms")   # TypeError in both packages


def _assert_words(jw, tw, rows=None):
    """Equal words; `rows` (a mask) limits the comparison to them."""
    assert len(jw) == len(tw)
    for j, t in zip(jw, tw):
        assert t.dtype == torch.int64
        j, t = np.asarray(j), t.numpy()
        if rows is not None:
            j, t = j[rows], t[rows]
        np.testing.assert_array_equal(j, t)


def _assert_spec(js, ts):
    assert (js.dtype.kind.name, js.n_words, js.nullable, js.max_bytes) == \
        (ts.dtype.kind.name, ts.n_words, ts.nullable, ts.max_bytes)


def _canonical(x):
    """The values a float key decodes to: NaN canonical, -0.0 +0.0."""
    x = np.where(np.isnan(x), np.array(np.nan, x.dtype), x)
    return np.where(x == 0, np.zeros((), x.dtype), x)


def _subnormal(x):
    return (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)


def _assert_columns(jc, tc, original=None):
    """Decoded columns equal. A float key decodes in the port to exactly
    its canonical input; the JAX package rebuilds FLOAT64 from the bits by
    arithmetic with `jnp.exp2`, which on the CPU is off by up to 2 ULP for
    some values (ROADMAP queue C, deviation 12), so there the JAX side is
    held to 2 ULP and the port to the input's exact bits."""
    assert jc.dtype.kind.name == tc.dtype.kind.name
    jv = np.asarray(jc.null_mask)
    np.testing.assert_array_equal(jv, tc.null_mask.numpy())
    if tc.dtype.is_floating:
        jd, td = np.asarray(jc.data), tc.data.numpy()
        width = np.uint64 if jd.dtype == np.float64 else np.uint32
        if original is not None:
            np.testing.assert_array_equal(
                _canonical(original).view(width)[jv], td.view(width)[jv])
        keep = jv if original is None else jv & ~_subnormal(original)
        if jd.dtype == np.float64:
            np.testing.assert_array_max_ulp(jd[keep], td[keep], maxulp=2)
        else:
            np.testing.assert_array_equal(jd.view(width)[keep],
                                          td.view(width)[keep])
    else:
        assert jc.to_pylist() == tc.to_pylist()


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("kind", _KINDS)
def test_codec_and_hash_equal_jax(kind, nulls):
    jc, tc = _make(kind, nulls, seed=len(kind))
    mb = 16 if kind == "string" else None
    jw, js = jkeys.encode_key_column(jc, max_bytes=mb)
    tw, ts = tkeys.encode_key_column(tc, max_bytes=mb)
    original = tc.data.numpy() if tc.dtype.is_floating else None
    # subnormals: the reference folds them into +0.0 (deviation 12)
    plain = None if original is None else ~_subnormal(original)
    _assert_words(jw, tw, plain)
    _assert_spec(js, ts)
    (jd,) = jkeys.decode_key_columns(jw, [js])
    (td,) = tkeys.decode_key_columns(tw, [ts])
    _assert_columns(jd, td, original)
    alive = np.arange(_N) % 3 != 0
    (jd,) = jkeys.decode_key_columns(jw, [js], alive=jnp.asarray(alive))
    (td,) = tkeys.decode_key_columns(tw, [ts], alive=torch.from_numpy(alive))
    _assert_columns(jd, td, original)
    np.testing.assert_array_equal(np.asarray(jkeys.keys_null_mask(jw, [js])),
                                  tkeys.keys_null_mask(tw, [ts]).numpy())
    if kind in _UNHASHED:
        with pytest.raises(TypeError):
            jkeys.spark_partition_hash(jw, [js])
        with pytest.raises(TypeError):
            tkeys.spark_partition_hash(tw, [ts])
        return
    hash_cuda.reset_counters()
    got = tkeys.spark_partition_hash(tw, [ts]).numpy()
    assert hash_cuda.PLAIN_CALLS["murmur"] == 1    # the row hash's route
    want = np.asarray(jkeys.spark_partition_hash(jw, [js]))
    if kind in ("float32", "float64"):
        # the reference hashes its decoded, subnormal-flushed value
        # (deviation 12): equal on the rows it decodes exactly; the port
        # hashes the canonical input as Spark does
        (jd,) = jkeys.decode_key_columns(jw, [js])
        bits = np.uint64 if kind == "float64" else np.uint32
        exact = (np.asarray(jd.data).view(bits)
                 == _canonical(original).view(bits))
        assert exact.mean() > 0.5
        ints = _canonical(original).view(
            np.int64 if kind == "float64" else np.int32).copy()
        spark = hash_cuda.murmur_hash3_32(
            [TColumn(tdt.INT64 if kind == "float64" else tdt.INT32, _N,
                     torch.from_numpy(ints), tc.validity)],
            seed=42).data.numpy()
        np.testing.assert_array_equal(got, spark)
        np.testing.assert_array_equal(got[exact], want[exact])
    else:
        np.testing.assert_array_equal(want, got)


def test_multi_column_tuple_and_forced_specs():
    """A three-column key tuple (string, DECIMAL128, float) with nulls on
    one side: the other side encoded under its specs gets the flag words;
    the tuple's words, decode and hash equal the JAX package's."""
    cols = [_make("string", True, 1), _make("decimal128", False, 2),
            _make("float64", True, 3)]
    jw, js = jkeys.encode_key_columns([c[0] for c in cols],
                                      max_bytes=[16, None, None])
    tw, ts = tkeys.encode_key_columns([c[1] for c in cols],
                                      max_bytes=[16, None, None])
    _assert_words(jw, tw, ~_subnormal(cols[2][1].data.numpy()))
    for a, b in zip(js, ts):
        _assert_spec(a, b)
    other = [_make("string", False, 4), _make("decimal128", False, 5),
             _make("float64", False, 6)]
    jw2, _ = jkeys.encode_key_columns([c[0] for c in other], specs=js)
    tw2, _ = tkeys.encode_key_columns([c[1] for c in other], specs=ts)
    _assert_words(jw2, tw2, ~_subnormal(other[2][1].data.numpy()))
    # the string and DECIMAL128 part of the tuple (the float's hash is
    # deviation 12's)
    np.testing.assert_array_equal(
        np.asarray(jkeys.spark_partition_hash(jw2[:-2], js[:-1])),
        tkeys.spark_partition_hash(tw2[:-2], ts[:-1]).numpy())
    for a, b, c in zip(jkeys.decode_key_columns(jw, js),
                       tkeys.decode_key_columns(tw, ts), cols):
        _assert_columns(a, b, c[1].data.numpy()
                        if b.dtype.is_floating else None)


def test_codec_errors_equal_jax():
    jc, tc = _make("int32", True)
    _, jspec = jkeys.encode_key_column(_make("int32", False)[0])
    _, tspec = tkeys.encode_key_column(_make("int32", False)[1])
    with pytest.raises(ValueError, match="non-nullable"):
        jkeys.encode_key_column(jc, spec=jspec)
    with pytest.raises(ValueError, match="non-nullable"):
        tkeys.encode_key_column(tc, spec=tspec)
    js_f = jkeys.encode_key_column(_make("float64", False)[0])[1]
    ts_f = tkeys.encode_key_column(_make("float64", False)[1])[1]
    with pytest.raises(TypeError, match="spec dtype"):
        jkeys.encode_key_column(jc, spec=js_f)
    with pytest.raises(TypeError, match="spec dtype"):
        tkeys.encode_key_column(tc, spec=ts_f)
    js_col, ts_col = _make("string", False)
    with pytest.raises(ValueError, match="pad_to=8 is smaller"):
        jkeys.encode_key_column(js_col, max_bytes=8)
    with pytest.raises(ValueError, match="pad_to=8 is smaller"):
        tkeys.encode_key_column(ts_col, max_bytes=8)
    jl, tl = _make("string", False, 9)   # default width: the longest row
    _assert_words(jkeys.encode_key_column(jl)[0],
                  tkeys.encode_key_column(tl)[0])
