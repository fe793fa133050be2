"""The port's calendar rebase (`spark_rapids_tpu_torch/ops/datetime_rebase.py`)
against the JAX package's, bit for bit: DATE32 and TIMESTAMP_US both ways
over random days from 0001 to 2100 (a fifth before the switch) and int32
and int64's edges, every row, null rows too; the JAX tests' oracle dates;
the errors; the kernel's row code (csrc/datetime_rebase.cu) built with the
host's C++ compiler against the plain version; and `api.DateTimeRebase`.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import ctypes
import functools

import numpy as np
import pytest
import torch

from spark_rapids_tpu import api as japi
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu.ops import datetime_rebase as jdr
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import datetime_rebase as tdr
from torch_cast_inputs import build_host
from torch_cast_jax import assert_same_column
from torch_datetime_inputs import (DAY_US, GAP_DAYS, GREG_TO_JULIAN,
                                   GREGORIAN_START_DAYS, JULIAN_TO_GREG,
                                   MODERN_DAYS, TIMES_OF_DAY, greg_days,
                                   julian_days_from_ymd, rebase_days,
                                   rebase_micros)

N = 20_000
KINDS = {"DATE32": rebase_days, "TIMESTAMP_US": rebase_micros}
DIRECTIONS = {"to_julian": (jdr.rebase_gregorian_to_julian,
                            tdr.rebase_gregorian_to_julian),
              "to_gregorian": (jdr.rebase_julian_to_gregorian,
                               tdr.rebase_julian_to_gregorian)}


@functools.lru_cache(None)
def columns(kind):
    v, valid = KINDS[kind](3, N)
    return (JCol.from_numpy(v, jdt.DType(jdt.Kind[kind]), validity=valid),
            TCol.from_numpy(v, tdt.DType(tdt.Kind[kind]), valid,
                            device="cpu"))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_rebase_equals_jax(kind, direction):
    jc, tc = columns(kind)
    jf, tf = DIRECTIONS[direction]
    assert_same_column(tf(tc), jf(jc))


def _days(values):
    return TCol.from_numpy(np.array(values, np.int32), tdt.DATE32,
                           device="cpu")


def test_oracle_dates():
    """The JAX tests' oracle: Gregorian dates read as Julian ones and back,
    the 1582-10-05..14 gap, modern days unchanged both ways, and micros
    keeping their time of day."""
    got = tdr.rebase_gregorian_to_julian(_days(
        [greg_days(*d) for d, _ in GREG_TO_JULIAN])).to_pylist()
    assert got == [want for _, want in GREG_TO_JULIAN]
    got = tdr.rebase_julian_to_gregorian(_days(
        [d for d, _ in JULIAN_TO_GREG])).to_pylist()
    assert got == [want for _, want in JULIAN_TO_GREG]
    assert tdr.rebase_gregorian_to_julian(_days(GAP_DAYS)).to_pylist() == \
        [GREGORIAN_START_DAYS] * len(GAP_DAYS)
    for fn in (tdr.rebase_gregorian_to_julian, tdr.rebase_julian_to_gregorian):
        assert fn(_days(MODERN_DAYS)).to_pylist() == MODERN_DAYS
    base = greg_days(1500, 1, 1)
    micros = TCol.from_numpy(np.array([base * DAY_US + t for t in
                                       TIMES_OF_DAY], np.int64),
                             tdt.TIMESTAMP_US, device="cpu")
    want_day = julian_days_from_ymd(1500, 1, 1)
    assert tdr.rebase_gregorian_to_julian(micros).to_pylist() == [
        want_day * DAY_US + t for t in TIMES_OF_DAY]


def test_round_trip_off_the_gap():
    v, _ = rebase_days(5, 5000)
    back = tdr.rebase_julian_to_gregorian(tdr.rebase_gregorian_to_julian(
        _days(v))).data.numpy()
    keep = ((v < GREGORIAN_START_DAYS - 10) | (v >= GREGORIAN_START_DAYS)) & (
        v > -(2**31) + 10**6) & (v < 2**31 - 10**6)
    np.testing.assert_array_equal(back[keep], v[keep])


def test_nulls_and_errors_equal_jax():
    """A null row keeps its validity (the random columns' nulls are held
    to the JAX package above), and the wrong type raises its error."""
    rows = [0, None, greg_days(1500, 1, 1)]
    got = tdr.rebase_gregorian_to_julian(TCol.from_pylist(
        rows, tdt.DATE32, device="cpu")).to_pylist()
    assert got == [0, None, julian_days_from_ymd(1500, 1, 1)]
    for fn_j, fn_t in DIRECTIONS.values():
        with pytest.raises(TypeError) as want:
            fn_j(JCol.from_pylist([1], jdt.INT64))
        with pytest.raises(TypeError) as got:
            fn_t(TCol.from_pylist([1], tdt.INT64, device="cpu"))
        assert str(got.value) == str(want.value)
    empty = tdr.rebase_gregorian_to_julian(_days([]))
    assert empty.length == 0 and empty.data.dtype == torch.int32


def test_facade_equals_jax():
    jc, tc = columns("DATE32")
    j = japi.DateTimeRebase.rebaseGregorianToJulian(jc)
    t = api.DateTimeRebase.rebaseGregorianToJulian(tc)
    assert_same_column(t, j)
    assert_same_column(api.DateTimeRebase.rebaseJulianToGregorian(t),
                       japi.DateTimeRebase.rebaseJulianToGregorian(j))


# ---- the kernel's row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("datetime_rebase",
                     tmp_path_factory.mktemp("datetime_rebase_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    lib.host_rebase.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_rows_equal_plain(host_lib, kind, direction):
    _, tc = columns(kind)
    to_julian = direction == "to_julian"
    out = torch.empty_like(tc.data)
    assert host_lib.host_rebase(int(kind == "TIMESTAMP_US"), int(to_julian),
                                tc.data.data_ptr(), tc.length,
                                out.data_ptr()) == 0
    assert torch.equal(out, tdr.rebase_plain(tc, to_julian))
