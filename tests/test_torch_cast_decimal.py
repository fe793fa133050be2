"""The port's string -> DECIMAL32/64/128 cast (`ops/cast_decimal.py`)
against the JAX package's, bit for bit; and the kernel's row code
(csrc/cast_decimal.cu) built with the host's C++ compiler against the
plain version.

Each JAX function runs at one fixed width (`pad_to`) per precision, scale
and flags, its result cached for the module.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import pytest
import torch

from spark_rapids_tpu.ops import cast_decimal as jcd
from spark_rapids_tpu.ops.cast_string import CastError as JaxCastError
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import cast_cuda
from spark_rapids_tpu_torch.ops import cast_decimal as tcd
from spark_rapids_tpu_torch.ops import cast_string as tcs
from test_cast_string import ANSI_STRINGS
from torch_cast_inputs import (EDGE, build_host, host_cast,
                               random_number_strings, with_nulls)
from torch_cast_jax import (assert_same_error, assert_same_tensors,
                            assert_same_values, string_columns)

PAD = 128
CORPUS = with_nulls(EDGE + random_number_strings(5, 1500, max_digits=42),
                    6) + ANSI_STRINGS + [
    "9.5", "99.5", "999.5", "0.95", "9999999.995", "-9.5", "1e-1", "1e+1",
    "0e999", "5e-2", "0.0000000005", "12345678901234567890123456789012345678",
    "1234567890123456789012345678901234567.5", ".5", "-.5", "5.", "+.e",
    "1.5e", "1.5E+", " 1.5 ", "1.5e 3", "1.5e3 ", "1.5 e3",
    "9223372036854775807e0", "1e9223372036854775807",
    "1e-9223372036854775808", "1e18446744073709551616"]
# (precision, scale, strip): every storage width, scales below 0, at 0,
# and up to the precision
CASES = [(9, 2, True), (9, 2, False), (5, 0, True), (1, 0, True),
         (18, 4, True), (18, -3, False), (20, -2, True), (38, 10, True),
         (38, 0, False), (38, 38, True), (10, 10, True), (7, -3, True)]
# the JAX package's compile per case is most of this file's time: its
# comparisons take ten of the cases, the kernel's all twelve
JAX_CASES = [c for c in CASES if c not in ((1, 0, True), (10, 10, True))]


@functools.lru_cache(None)
def corpus():
    return string_columns(CORPUS)


@functools.lru_cache(None)
def jax_decimal(precision, scale, strip, ansi=False):
    return jcd.string_to_decimal(corpus()[0], precision, scale,
                                 ansi_mode=ansi, strip=strip, pad_to=PAD)


@pytest.mark.parametrize("precision,scale,strip", JAX_CASES)
def test_string_to_decimal_equals_jax(precision, scale, strip):
    got = tcd.string_to_decimal(corpus()[1], precision, scale, strip=strip,
                                pad_to=PAD)
    assert got.dtype == tdt.decimal(precision, scale)
    assert_same_values(got, jax_decimal(precision, scale, strip))


def test_string_to_decimal_ansi_error_equals_jax():
    with pytest.raises(JaxCastError) as want:
        jax_decimal(9, 2, True, ansi=True)
    with pytest.raises(tcs.CastError) as got:
        tcd.string_to_decimal(corpus()[1], 9, 2, ansi_mode=True, pad_to=PAD)
    assert_same_error(got.value, want.value)


def test_string_to_decimal_counts_plain_runs():
    col = TCol.from_pylist(["1.5", None], tdt.STRING, device="cpu")
    cast_cuda.reset_counters()
    assert tcd.string_to_decimal(col, 5, 1).to_pylist() == [15, None]
    assert cast_cuda.PLAIN_CALLS["to_decimal"] == 1
    with pytest.raises(ValueError, match="CUDA"):
        cast_cuda.to_decimal(col, 5, 1, False, True)
    with pytest.raises(ValueError, match="precision"):
        tcd.string_to_decimal(col, 39, 0)


# ---- the kernels' row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cast_decimal_host")
    libs = {"cast_decimal": build_host("cast_decimal", d)}
    if any(v is None for v in libs.values()):
        pytest.skip("needs a host C++ compiler to build the kernels' row "
                    "code")
    return libs


@functools.lru_cache(None)
def kernel_rows():
    vals = CORPUS + with_nulls(random_number_strings(15, 2000,
                                                     max_digits=45), 16)
    return TCol.from_pylist(vals, tdt.STRING, device="cpu")


@pytest.mark.parametrize("precision,scale,strip", CASES)
def test_decimal_kernel_rows_equal_plain(host_libs, precision, scale,
                                         strip):
    col = kernel_rows()
    dt = tdt.decimal(precision, scale)
    out, ok, err = host_cast(host_libs["cast_decimal"], "host_to_decimal",
                             col, dt, strip=strip, precision=precision,
                             scale=scale)
    want, want_err = tcd.string_to_decimal_plain(col, precision, scale,
                                                 False, strip)
    assert_same_tensors(out, want.data)
    assert torch.equal(ok, want.validity)
    assert torch.equal(err, want_err)


@pytest.mark.parametrize("precision,scale", [(9, 2), (38, 10)])
def test_decimal_kernel_rows_without_flags_equal_plain(host_libs, precision,
                                                       scale):
    """A launch outside ANSI passes no flag buffer: the row code skips the
    flag and writes the same values and validity."""
    col = kernel_rows()
    out, ok, err = host_cast(host_libs["cast_decimal"], "host_to_decimal",
                             col, tdt.decimal(precision, scale),
                             precision=precision, scale=scale, flags=False)
    want, _ = tcd.string_to_decimal_plain(col, precision, scale)
    assert err is None
    assert_same_tensors(out, want.data)
    assert torch.equal(ok, want.validity)
