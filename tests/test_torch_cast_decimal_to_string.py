"""The port's DECIMAL32/64/128 -> string (`ops/cast_decimal_to_string.py`,
Java's BigDecimal.toString) against the JAX package's, offsets and chars
byte for byte; and csrc/number_to_string.cu's decimal format built with
the host's C++ compiler against the plain version."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import cast_decimal_to_string as jcds
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import cast_cuda
from spark_rapids_tpu_torch.ops import cast_decimal_to_string as tcds
from torch_cast_inputs import build_host, host_to_string
from torch_cast_jax import assert_same_strings, numpy_columns


def _decimals(kind, seed, n=1200):
    """Values of every digit count, both signs, the type's extremes, and
    nulls, as a numpy buffer (DECIMAL128: Python ints)."""
    rng = np.random.default_rng(seed)
    if kind == "DECIMAL128":
        vals = [int(v) * int(rng.integers(1, 10**18))
                * int(rng.integers(1, 100)) // 10**int(rng.integers(0, 36))
                for v in rng.integers(-10**18, 10**18, size=n)]
        vals += [0, 1, -1, 10**38 - 1, -(10**38 - 1), 2**127 - 1, -2**127,
                 10**7, -10**6, 10**6]
        return [v if rng.random() > 0.05 else None for v in vals]
    bits = 32 if kind == "DECIMAL32" else 64
    dt = np.int32 if bits == 32 else np.int64
    arr = rng.integers(-2**(bits - 1), 2**(bits - 1), size=n).astype(dt)
    arr[:10] = [0, 1, -1, 10, -10, 100000, -1000000, np.iinfo(dt).min,
                np.iinfo(dt).max, 5]
    arr[10:600] //= (10 ** rng.integers(0, bits // 4, 590)).astype(dt)
    return arr, rng.random(n) > 0.1


DEC_CASES = [("DECIMAL32", 9, 2), ("DECIMAL32", 9, 0), ("DECIMAL32", 9, 9),
             ("DECIMAL64", 18, 4), ("DECIMAL64", 18, -3),
             ("DECIMAL64", 18, 18), ("DECIMAL128", 38, 10),
             ("DECIMAL128", 38, 0), ("DECIMAL128", 38, 38),
             ("DECIMAL128", 38, -5)]


def _dec_columns(kind, precision, scale):
    from spark_rapids_tpu import dtypes as jdt
    from spark_rapids_tpu.columnar import Column as JCol
    data = _decimals(kind, precision * 100 + scale)
    if kind == "DECIMAL128":
        return (JCol.from_pylist(data, jdt.decimal(precision, scale)),
                TCol.from_pylist(data, tdt.decimal(precision, scale),
                                 device="cpu"))
    arr, valid = data
    return numpy_columns(arr, kind, valid, precision, scale)


@pytest.mark.parametrize("kind,precision,scale", DEC_CASES)
def test_decimal_to_string_equals_jax(kind, precision, scale):
    jc, tc = _dec_columns(kind, precision, scale)
    got = tcds.decimal_to_non_ansi_string(tc)
    assert_same_strings(got, jcds.decimal_to_non_ansi_string(jc))


def test_decimal_to_string_rejects_non_decimal():
    with pytest.raises(TypeError, match="decimal"):
        tcds.decimal_to_non_ansi_string(
            TCol.from_pylist([1], tdt.INT32, device="cpu"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("number_to_string",
                     tmp_path_factory.mktemp("decimal_to_string_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    return lib


@pytest.mark.parametrize("kind,precision,scale", DEC_CASES)
def test_decimal_to_string_kernel_rows_equal_plain(host_lib, kind,
                                                   precision, scale):
    tc = _dec_columns(kind, precision, scale)[1]
    offsets, chars = host_to_string(host_lib, tc,
                                    cast_cuda.NS_DECIMAL, scale)
    want = tcds.decimal_to_non_ansi_string_plain(tc)
    assert torch.equal(offsets, want.offsets)
    assert torch.equal(chars, want.data)
