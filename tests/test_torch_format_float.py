"""The port's `format_float` (`ops/format_float.py`, Spark's
format_number) against the JAX package's, offsets and chars byte for byte,
and against tests/test_float_to_string.py's decimal oracle; and
csrc/number_to_string.cu's format row code built with the host's C++
compiler against the plain version.

The JAX package compiles Ryu and its fill per digit count, width and type
(seconds each): three calls, cached for the module.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import importlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import cast_cuda
from test_float_to_string import FORMAT_GOLDEN_F32, spark_format_number
from test_torch_float_to_string import float_values
from torch_cast_inputs import build_host, host_to_string
from torch_cast_jax import assert_same_strings, numpy_columns

# the modules: the packages' `format_float` is the function
jff = importlib.import_module("spark_rapids_tpu.ops.format_float")
tff = importlib.import_module("spark_rapids_tpu_torch.ops.format_float")


@functools.lru_cache(None)
def columns(kind):
    x = float_values(kind, {"FLOAT32": 3, "FLOAT64": 4}[kind], n=1500)
    valid = np.random.default_rng(9).random(len(x)) > 0.1
    return numpy_columns(x, kind, valid)


@pytest.mark.parametrize("kind,digits", [("FLOAT32", 5), ("FLOAT64", 2),
                                         ("FLOAT64", 30)])
def test_format_float_equals_jax(kind, digits):
    """Random bits over every exponent: 300+ integer digits near 1e308."""
    jc, tc = columns(kind)
    assert_same_strings(tff.format_float(tc, digits),
                        jff.format_float(jc, digits))


def test_golden_vectors():
    """tests/test_float_to_string.py's vectors (the reference's
    tests/format_float.cpp)."""
    vals = np.array([v for v, _ in FORMAT_GOLDEN_F32], np.float32)
    col = TCol.from_numpy(vals, tdt.FLOAT32, device="cpu")
    assert tff.format_float(col, 5).to_pylist() == [
        w for _, w in FORMAT_GOLDEN_F32]


@pytest.mark.parametrize("d", [0, 1, 2, 6])
def test_format_equals_decimal_oracle(d):
    rng = np.random.default_rng(100 + d)
    vals = np.concatenate([
        rng.uniform(-1e6, 1e6, 300), rng.uniform(-1, 1, 200),
        rng.uniform(-1e12, 1e12, 100),
        10.0 ** rng.integers(-8, 12, 100) * rng.choice([-1, 1], 100),
        np.array([0.95, 0.05, 0.15, 0.25, 0.005, 9.99, 99.995, 0.999999,
                  1e-10, 1e300, -1e300])])
    col = TCol.from_numpy(vals, tdt.FLOAT64, device="cpu")
    assert tff.format_float(col, d).to_pylist() == [
        spark_format_number(float(v), d, False) for v in vals]


def test_bad_digits_and_types_raise():
    col = columns("FLOAT64")[1]
    with pytest.raises(ValueError, match="digits"):
        tff.format_float(col, 31)
    with pytest.raises(TypeError):
        tff.format_float(TCol.from_pylist([1], tdt.INT32, device="cpu"), 2)
    cast_cuda.reset_counters()
    tff.format_float(col, 1)
    assert cast_cuda.PLAIN_CALLS["format_float"] == 1


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("number_to_string",
                     tmp_path_factory.mktemp("format_float_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    return lib


@pytest.mark.parametrize("kind", ["FLOAT32", "FLOAT64"])
@pytest.mark.parametrize("digits", [0, 1, 3, 7, 17, 30])
def test_format_kernel_rows_equal_plain(host_lib, kind, digits):
    x = float_values(kind, 50 + digits, n=6000)
    valid = np.random.default_rng(digits).random(len(x)) > 0.1
    col = TCol.from_numpy(x, tdt.DType(tdt.Kind[kind]), valid, device="cpu")
    offsets, chars = host_to_string(host_lib, col, cast_cuda.NS_FORMAT,
                                    digits)
    want = tff.format_float_plain(col, digits)
    assert torch.equal(offsets, want.offsets)
    assert torch.equal(chars, want.data)
