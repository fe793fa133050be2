"""The port's FLOAT -> string (`ops/cast_float_to_string.py`, Java's
Float/Double.toString over Ryu) and integer -> string in base 10 or 16
(`ops/cast_string.py` `integer_to_string_with_base`) against the JAX
package's, offsets and chars byte for byte; and csrc/number_to_string.cu's
row code built with the host's C++ compiler against the plain version.

Random float bit patterns cover every exponent, as
tests/test_float_to_string.py draws them. The JAX package compiles Ryu per
width and type (seconds each): one call per type, cached for the module.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import cast_float_to_string as jcfs
from spark_rapids_tpu.ops import cast_string as jcs
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import cast_cuda
from spark_rapids_tpu_torch.ops import cast_float_to_string as tcfs
from spark_rapids_tpu_torch.ops import cast_string as tcs
from test_float_to_string import GOLDEN_F32, GOLDEN_F64, java_to_string
from torch_cast_inputs import build_host, host_to_string
from torch_cast_jax import assert_same_strings, numpy_columns

SPECIAL32 = np.array([0x0, 0x80000000, 0x1, 0x80000001, 0x7F800000,
                      0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F7FFFFF,
                      0x00800000, 0x007FFFFF], np.uint32)
SPECIAL64 = np.array([0x0, 1 << 63, 0x1, 0x7FF0000000000000,
                      0xFFF0000000000000, 0x7FF8000000000000,
                      0x7FEFFFFFFFFFFFFF, 0x0010000000000000,
                      0x000FFFFFFFFFFFFF], np.uint64)


def float_values(kind, seed, n=3000):
    """Random bit patterns (every exponent, both signs), the specials,
    Java's plain/scientific edges and values of a few digits."""
    rng = np.random.default_rng(seed)
    if kind == "FLOAT32":
        bits = rng.integers(0, 2**32, n).astype(np.uint32)
        edges = np.array([1e7, 9999999.0, 1e-3, 9.999999e-4, 0.1, 100.0,
                          123456789012.34, 3.4028235e38, 1.17549435e-38],
                         np.float32)
        return np.concatenate([bits.view(np.float32), SPECIAL32.view(
            np.float32), edges, rng.normal(0, 1e4, 300).astype(np.float32)])
    bits = (rng.integers(0, 2**63, n).astype(np.uint64)
            | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63)))
    edges = np.array([1e7, 9999999.999999998, 1e-3, 9.999999999999998e-4,
                      0.1, 1e22, 1e23, 5e-324, 2.2250738585072014e-308,
                      1.7976931348623157e308, 123.456], np.float64)
    return np.concatenate([bits.view(np.float64), SPECIAL64.view(np.float64),
                           edges, rng.normal(0, 1e6, 300)])


@functools.lru_cache(None)
def float_columns(kind):
    x = float_values(kind, {"FLOAT32": 1, "FLOAT64": 2}[kind])
    valid = np.random.default_rng(7).random(len(x)) > 0.1
    return numpy_columns(x, kind, valid)


@pytest.mark.parametrize("kind", ["FLOAT32", "FLOAT64"])
def test_float_to_string_equals_jax(kind):
    jc, tc = float_columns(kind)
    assert_same_strings(tcfs.float_to_string(tc), jcfs.float_to_string(jc))


@pytest.mark.parametrize("kind,golden", [("FLOAT32", GOLDEN_F32),
                                         ("FLOAT64", GOLDEN_F64)])
def test_golden_vectors(kind, golden):
    """tests/test_float_to_string.py's vectors (the reference's
    tests/cast_float_to_string.cpp)."""
    npt = np.float32 if kind == "FLOAT32" else np.float64
    col = TCol.from_numpy(np.array([v for v, _ in golden], npt),
                          tdt.DType(tdt.Kind[kind]), device="cpu")
    assert tcfs.float_to_string(col).to_pylist() == [w for _, w in golden]


@pytest.mark.parametrize("kind", ["FLOAT32", "FLOAT64"])
def test_random_floats_equal_java_oracle(kind):
    """The test oracle of tests/test_float_to_string.py (numpy's shortest
    digits in Java's layout) on other random bits than the JAX
    comparison's."""
    x = float_values(kind, 40)
    col = TCol.from_numpy(x, tdt.DType(tdt.Kind[kind]), device="cpu")
    got = tcfs.float_to_string(col).to_pylist()
    assert got == [java_to_string(float(v), kind == "FLOAT32") for v in x]


INT_KINDS = {"INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
             "INT64": np.int64, "UINT64": np.uint64}


@functools.lru_cache(None)
def int_columns(kind):
    npt = INT_KINDS[kind]
    info = np.iinfo(npt)
    rng = np.random.default_rng(len(kind))
    arr = rng.integers(info.min, info.max, size=800, dtype=npt,
                       endpoint=True)
    arr[:6] = [info.min, info.max, 0, 1, info.max // 16, info.min + 1]
    return numpy_columns(arr, kind, rng.random(800) > 0.1)


@pytest.mark.parametrize("kind", list(INT_KINDS))
@pytest.mark.parametrize("base", [10, 16])
def test_integer_to_string_with_base_equals_jax(kind, base):
    """Null rows keep their data's string, as the JAX package writes
    them."""
    jc, tc = int_columns(kind)
    assert_same_strings(tcs.integer_to_string_with_base(tc, base),
                        jcs.integer_to_string_with_base(jc, base))


def test_entry_points_count_plain_runs():
    cast_cuda.reset_counters()
    tcfs.float_to_string(float_columns("FLOAT32")[1])
    tcs.integer_to_string_with_base(int_columns("INT8")[1], 16)
    assert cast_cuda.PLAIN_CALLS["from_float"] == 1
    assert cast_cuda.PLAIN_CALLS["from_integer_base"] == 1
    assert sum(cast_cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        cast_cuda.from_float(float_columns("FLOAT32")[1])
    with pytest.raises(TypeError):
        tcfs.float_to_string(int_columns("INT8")[1])


def test_empty_and_all_null_columns():
    empty = TCol.from_numpy(np.zeros(0, np.float64), tdt.FLOAT64,
                            device="cpu")
    out = tcfs.float_to_string(empty)
    assert out.length == 0 and out.offsets.tolist() == [0]
    nulls = TCol.from_pylist([None, None], tdt.FLOAT32, device="cpu")
    out = tcfs.float_to_string(nulls)
    assert out.offsets.tolist() == [0, 0, 0] and out.data.numel() == 0


# ---- the kernel's row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("number_to_string",
                     tmp_path_factory.mktemp("number_to_string_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    return lib


@pytest.mark.parametrize("kind", ["FLOAT32", "FLOAT64"])
@pytest.mark.parametrize("seed", [11, 12])
def test_float_kernel_rows_equal_plain(host_lib, kind, seed):
    x = float_values(kind, seed, n=20_000)
    valid = np.random.default_rng(seed).random(len(x)) > 0.1
    col = TCol.from_numpy(x, tdt.DType(tdt.Kind[kind]), valid, device="cpu")
    offsets, chars = host_to_string(host_lib, col, cast_cuda.NS_FLOAT)
    want = tcfs.float_to_string_plain(col)
    assert torch.equal(offsets, want.offsets)
    assert torch.equal(chars, want.data)


@pytest.mark.parametrize("kind", list(INT_KINDS) + ["UINT8"])
@pytest.mark.parametrize("base", [10, 16])
def test_integer_kernel_rows_equal_plain(host_lib, kind, base):
    npt = dict(INT_KINDS, UINT8=np.uint8)[kind]
    info = np.iinfo(npt)
    rng = np.random.default_rng(base)
    arr = rng.integers(info.min, info.max, size=5000, dtype=npt,
                       endpoint=True)
    arr[:3] = [info.min, info.max, 0]
    col = TCol.from_numpy(arr, tdt.DType(tdt.Kind[kind]),
                          rng.random(5000) > 0.1, device="cpu")
    offsets, chars = host_to_string(host_lib, col, cast_cuda.NS_INT, base)
    want = tcs.integer_to_string_with_base_plain(col, base)
    assert torch.equal(offsets, want.offsets)
    assert torch.equal(chars, want.data)
