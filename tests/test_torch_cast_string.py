"""The port's string -> integer, string -> float and base-conversion casts
(`spark_rapids_tpu_torch/ops/cast_string.py`) against the JAX package's on
the same strings, bit for bit; and the cast kernels' row code
(csrc/cast_string.cu, csrc/cast_string_to_float.cu) built with the host's
C++ compiler against the plain version.

Each JAX function runs at one fixed width (`pad_to`) per type and flags,
its result cached for the module: every call compiles its padded program.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.ops import cast_string as jcs
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import cast_cuda
from spark_rapids_tpu_torch.ops import cast_string as tcs
from test_cast_string import ANSI_STRINGS, ANSI_VALID, ANSI_VALUES
from torch_cast_inputs import (EDGE, build_host, host_cast,
                               random_hex_strings, random_number_strings,
                               with_nulls)
from torch_cast_jax import (assert_same_error, assert_same_tensors,
                            assert_same_values, string_columns)

PAD = 128
INTS = ["INT8", "INT16", "INT32", "INT64"]
CORPUS = with_nulls(EDGE + random_number_strings(0, 1500, max_digits=30), 1
                    ) + ANSI_STRINGS


def _float_edges():
    """Powers of ten and their neighbours around 2^53 and 2^64, values
    near the subnormal and overflow edges, and printed random float64s
    over every exponent."""
    out = []
    for k in range(13, 21):
        out += [str(10**k - 1), str(10**k), str(10**k + 1),
                str(10**k + 3), f"{10**k - 48}"]
    for e in (305, 307, 308, 309, 310, 320, 323, 324, 325, 330):
        out += [f"1e-{e}", f"4.9e-{e}", f"2.5e-{e}", f"9.99e-{e}",
                f"123456789012345678e-{e + 17}"]
    out += ["1.7976931348623157e308", "1.7976931348623159e308", "9e308",
            "2.2250738585072014e-308", "2.2250738585072009e-308",
            "1.1754943508222875e-38", "1.1754942e-38", "1.4e-45", "7e-46",
            "3.4028235e38", "3.4028236e38"]
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**63, 600).astype(np.uint64)
    out += [repr(float(x)) for x in bits.view(np.float64)
            if np.isfinite(x)]
    return out


FLOAT_EDGES = _float_edges()


@functools.lru_cache(None)
def columns(name):
    vals = {"corpus": CORPUS, "edges": FLOAT_EDGES,
            "hex": with_nulls(random_hex_strings(3, 1200) + EDGE, 2),
            "clean": ["1", " 2 ", None, "-3", "+0", "007", "\t9\n"]}[name]
    return string_columns(vals)


@functools.lru_cache(None)
def jax_cast(fn, name, kind, **kw):
    col = columns(name)[0]
    return getattr(jcs, fn)(col, jdt.DType(jdt.Kind[kind]), pad_to=PAD, **kw)


@pytest.mark.parametrize("kind", INTS)
@pytest.mark.parametrize("strip", [True, False])
def test_string_to_integer_equals_jax(kind, strip):
    got = tcs.string_to_integer(columns("corpus")[1],
                                tdt.DType(tdt.Kind[kind]), strip=strip,
                                pad_to=PAD)
    assert_same_values(got, jax_cast("string_to_integer", "corpus", kind,
                                     strip=strip))


@pytest.mark.parametrize("kind", ["INT32", "INT64"])
def test_golden_ansi_corpus(kind):
    """tests/test_cast_string.py's vectors (the reference's
    tests/cast_string.cpp:99-106)."""
    col = TCol.from_pylist(ANSI_STRINGS, tdt.STRING, device="cpu")
    got = tcs.string_to_integer(col, tdt.DType(tdt.Kind[kind]))
    valid = np.array(ANSI_VALID, bool)
    np.testing.assert_array_equal(got.null_mask.numpy(), valid)
    np.testing.assert_array_equal(got.data.numpy()[valid],
                                  np.array(ANSI_VALUES)[valid])


@pytest.mark.parametrize("fn,kind", [("string_to_integer", "INT32"),
                                     ("string_to_integer", "INT8"),
                                     ("string_to_float", "FLOAT64")])
def test_ansi_error_equals_jax(fn, kind):
    """The first failing row and its string, as the JAX package raises."""
    with pytest.raises(jcs.CastError) as want:
        jax_cast(fn, "corpus", kind, ansi_mode=True)
    with pytest.raises(tcs.CastError) as got:
        getattr(tcs, fn)(columns("corpus")[1], tdt.DType(tdt.Kind[kind]),
                         ansi_mode=True, pad_to=PAD)
    assert_same_error(got.value, want.value)


@pytest.mark.parametrize("strings,row", [
    (["1.5", "infx", None, "-Infinity"], None),
    (["1.5", "infx", "nanx", "2"], 2),
    (["1.5", "Infinity ", " 1e5 ", "1e5x"], 3)])
def test_float_ansi_skips_inf_with_junk_as_jax_does(strings, row):
    """'inf' followed by junk is invalid without an ANSI error;
    'nan' with junk raises (cast_string.py:361-369)."""
    jc, tc = string_columns(strings)

    def first_error(fn, col, dtypes_):
        try:
            out = fn(col, dtypes_.FLOAT64, ansi_mode=True, pad_to=PAD)
            return None, out
        except (jcs.CastError, tcs.CastError) as e:
            return (e.row_number, e.string_with_error), None
    want, jout = first_error(jcs.string_to_float, jc, jdt)
    got, tout = first_error(tcs.string_to_float, tc, tdt)
    assert got == want
    assert (got is None) == (row is None) and (row is None or got[0] == row)
    if got is None:
        assert_same_values(tout, jout)


def test_ansi_clean_rows_equal_jax():
    got = tcs.string_to_integer(columns("clean")[1], tdt.INT64,
                                ansi_mode=True, pad_to=PAD)
    assert_same_values(got, jax_cast("string_to_integer", "clean", "INT64",
                                     ansi_mode=True))


@pytest.mark.parametrize("kind", ["FLOAT32", "FLOAT64"])
@pytest.mark.parametrize("name", ["corpus", "edges"])
def test_string_to_float_equals_jax(kind, name):
    got = tcs.string_to_float(columns(name)[1], tdt.DType(tdt.Kind[kind]),
                              pad_to=PAD)
    assert_same_values(got, jax_cast("string_to_float", name, kind))


def test_log10_steps_equal_jax():
    """`LOG10_STEPS` is where the JAX package's floor(log10(d)) + 1 turns:
    held against jnp.log10 on the float64s around every step and on
    integers near every power of ten."""
    import jax.numpy as jnp
    xs = []
    for t in tcs.LOG10_STEPS:
        b = np.array([t], np.float64).view(np.int64)[0]
        xs.append(np.arange(b - 40, b + 40, dtype=np.int64).view(np.float64))
    for k in range(1, 20):
        xs.append(np.array([10.0**k - j for j in range(-3, 4)]))
    x = np.concatenate(xs)
    x = x[x >= 1]
    want = np.floor(np.asarray(jnp.log10(x))).astype(np.int64) + 1
    got = tcs.num_digits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("base", [10, 16])
@pytest.mark.parametrize("kind", ["INT32", "INT64"])
def test_string_to_integer_with_base_equals_jax(base, kind):
    got = tcs.string_to_integer_with_base(columns("hex")[1],
                                          tdt.DType(tdt.Kind[kind]),
                                          base=base, pad_to=PAD)
    assert_same_values(got, jax_cast("string_to_integer_with_base", "hex",
                                     kind, base=base))


def test_bad_base_and_pad_raise_as_jax_does():
    col = columns("clean")[1]
    with pytest.raises(tcs.CastError, match="Bases supported"):
        tcs.string_to_integer_with_base(col, tdt.INT32, base=8)
    with pytest.raises(tcs.CastError, match="Bases supported"):
        tcs.integer_to_string_with_base(
            TCol.from_pylist([1], tdt.INT32, device="cpu"), base=2)
    with pytest.raises(ValueError, match="pad_to"):
        tcs.string_to_integer(col, tdt.INT32, pad_to=2)
    with pytest.raises(TypeError):
        tcs.string_to_integer(col, tdt.FLOAT32)


def test_entry_points_count_plain_runs_and_wrappers_take_cuda_only():
    col = columns("clean")[1]
    cast_cuda.reset_counters()
    tcs.string_to_integer(col, tdt.INT32)
    tcs.string_to_float(col, tdt.FLOAT32)
    tcs.string_to_integer_with_base(col, tdt.INT64, base=16)
    assert cast_cuda.PLAIN_CALLS["to_integer"] == 1
    assert cast_cuda.PLAIN_CALLS["to_float"] == 1
    assert cast_cuda.PLAIN_CALLS["to_integer_base"] == 1
    assert sum(cast_cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        cast_cuda.to_integer(col, tdt.INT32, False, True)
    with pytest.raises(ValueError, match="CUDA"):
        cast_cuda.to_float(col, tdt.FLOAT64, False)


def test_sliced_and_empty_columns():
    """Offsets that start past 0, and a column of empty strings whose
    chars buffer is empty."""
    full = columns("corpus")[1]
    sliced = TCol(tdt.STRING, full.length - 5, full.data,
                  full.validity[5:], full.offsets[5:])
    want = tcs.string_to_float(full, tdt.FLOAT64)
    got = tcs.string_to_float(sliced, tdt.FLOAT64)
    assert_same_tensors(got.data, want.data[5:])
    assert torch.equal(got.validity, want.validity[5:])
    empty = TCol.from_pylist([b"", None, b""], tdt.STRING, device="cpu")
    assert empty.data.numel() == 0
    assert tcs.string_to_integer(empty, tdt.INT32).to_pylist() == [None] * 3


# ---- the kernels' row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cast_string_host")
    libs = {name: build_host(name, d)
            for name in ("cast_string", "cast_string_to_float")}
    if any(v is None for v in libs.values()):
        pytest.skip("needs a host C++ compiler to build the kernels' row "
                    "code")
    return libs


@functools.lru_cache(None)
def kernel_rows():
    """The edge corpus, the float edges and 4,000 random rows."""
    vals = (CORPUS + FLOAT_EDGES
            + with_nulls(random_number_strings(11, 4000, max_digits=40), 12))
    return TCol.from_pylist(vals, tdt.STRING, device="cpu")


def _same_kernel_result(got, want_col, want_err):
    out, ok, err = got
    assert_same_tensors(out, want_col.data)
    assert torch.equal(ok, want_col.validity)
    if want_err is not None:
        assert torch.equal(err, want_err)


@pytest.mark.parametrize("kind", INTS)
@pytest.mark.parametrize("strip", [True, False])
@pytest.mark.parametrize("ansi", [False, True])
def test_integer_kernel_rows_equal_plain(host_libs, kind, strip, ansi):
    col = kernel_rows()
    dt = tdt.DType(tdt.Kind[kind])
    got = host_cast(host_libs["cast_string"], "host_to_integer", col, dt,
                    ansi=ansi, strip=strip)
    _same_kernel_result(got, *tcs.string_to_integer_plain(col, dt, ansi,
                                                          strip))


@pytest.mark.parametrize("base", [10, 16])
@pytest.mark.parametrize("kind", ["INT8", "INT64"])
def test_base_kernel_rows_equal_plain(host_libs, base, kind):
    col = TCol.from_pylist(with_nulls(random_hex_strings(21, 4000) + EDGE,
                                      22), tdt.STRING, device="cpu")
    dt = tdt.DType(tdt.Kind[kind])
    got = host_cast(host_libs["cast_string"], "host_to_integer", col, dt,
                    base=base)
    want = tcs.string_to_integer_with_base_plain(col, dt, base)
    _same_kernel_result(got, want, None)


@pytest.mark.parametrize("source", ["cast_string", "cast_string_to_float"])
def test_kernel_rows_without_flags_equal_plain(host_libs, source):
    """A launch outside ANSI passes no flag buffer: the row code skips the
    flag and writes the same values and validity."""
    col = kernel_rows()
    if source == "cast_string":
        got = host_cast(host_libs[source], "host_to_integer", col, tdt.INT64,
                        flags=False)
        want = tcs.string_to_integer_plain(col, tdt.INT64)[0]
    else:
        got = host_cast(host_libs[source], "host_to_float", col, tdt.FLOAT64,
                        flags=False)
        want = tcs.string_to_float_plain(col, tdt.FLOAT64)[0]
    assert got[2] is None
    _same_kernel_result(got, want, None)


@pytest.mark.parametrize("kind", ["FLOAT32", "FLOAT64"])
def test_float_kernel_rows_equal_plain(host_libs, kind):
    col = kernel_rows()
    dt = tdt.DType(tdt.Kind[kind])
    got = host_cast(host_libs["cast_string_to_float"], "host_to_float", col,
                    dt)
    _same_kernel_result(got, *tcs.string_to_float_plain(col, dt))
