"""Proleptic-Gregorian <-> Julian calendar rebase of DATE32 and
TIMESTAMP_US columns (`DateTimeRebase`).

Counterpart of `spark_rapids_tpu/ops/datetime_rebase.py` (the reference's
datetime_rebase.cu), with Spark's `localRebaseGregorianToJulianDays`,
`localRebaseJulianToGregorianDays`, `rebaseGregorianToJulianMicros` and
`rebaseJulianToGregorianMicros` (UTC):

- a value on or after the Gregorian start (1582-10-15, day -141,427; for
  micros 1582-10-15T00:00:00Z) is unchanged;
- an earlier day is read as a date in one calendar and written as the
  same date in the other (Howard Hinnant's civil and Julian day
  algorithms); a Gregorian date in 1582-10-05..14, which exists in
  neither, rebases to the Gregorian start;
- a micros value splits into a floor day and the microsecond of the day,
  the day (narrowed to int32) is rebased, and the two are put back
  together with int64 wraparound.

Every integer division is the JAX package's floor division, written out
as `torch.div(..., rounding_mode="floor")`; a DATE32 result wraps to
int32 as the JAX package's `astype` does. On a CUDA column the rebase
kernel runs (`datetime_rebase_cuda`, csrc/datetime_rebase.cu: one thread
a row) or the call raises; on a CPU column the plain version runs. Every
row is computed, null rows too; the validity passes through.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..dtypes import Kind
from . import datetime_rebase_cuda
from .datetime_rebase_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["rebase_gregorian_to_julian", "rebase_julian_to_gregorian",
           "GREGORIAN_START_DAYS", "LAST_SWITCH_GREGORIAN_MICROS",
           "LAUNCHES", "PLAIN_CALLS", "reset_counters"]

GREGORIAN_START_DAYS = -141427                    # 1582-10-15
LAST_SWITCH_GREGORIAN_MICROS = -12219292800000000  # 1582-10-15T00:00:00Z
MICROS_PER_SECOND = 1_000_000
SECONDS_PER_DAY = 86_400
MICROS_PER_DAY = SECONDS_PER_DAY * MICROS_PER_SECOND


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), proleptic Gregorian."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def _day_of_year(m, d):
    return _fdiv(153 * torch.where(m > 2, m - 3, m + 9) + 2, 5) + d - 1


def _days_from_civil(y, m, d):
    """(year, month, day) proleptic Gregorian -> days since 1970-01-01."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + _day_of_year(m, d)
    return era * 146097 + doe - 719468


def _days_from_julian(y, m, d):
    """(year, month, day) Julian calendar -> days since 1970-01-01."""
    year = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(year >= 0, year, year - 3), 4)
    yoe = year - era * 4
    doe = yoe * 365 + _day_of_year(m, d)
    return era * 1461 + doe - 719470


def _julian_from_days(days):
    """days since 1970-01-01 -> (year, month, day), Julian calendar."""
    z = days.to(torch.int64) + 719470
    era = _fdiv(torch.where(z >= 0, z, z - 1460), 1461)
    doe = z - era * 1461
    yoe = _fdiv(doe - _fdiv(doe, 1460), 365)
    y = yoe + era * 4
    doy = doe - 365 * yoe
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def _greg_to_julian_days(days):
    """(n,) int64 rebased days of (n,) int32 days."""
    y, m, d = _civil_from_days(days)
    gap = (y == 1582) & (m == 10) & (d >= 5) & (d <= 14)
    rebased = torch.where(gap, torch.full_like(y, GREGORIAN_START_DAYS),
                          _days_from_julian(y, m, d))
    return torch.where(days >= GREGORIAN_START_DAYS, days.to(torch.int64),
                       rebased)


def _julian_to_greg_days(days):
    y, m, d = _julian_from_days(days)
    return torch.where(days >= GREGORIAN_START_DAYS, days.to(torch.int64),
                       _days_from_civil(y, m, d))


def _rebase_micros(micros, day_fn):
    micros = micros.to(torch.int64)
    days = _fdiv(micros, MICROS_PER_DAY)
    tod = micros - days * MICROS_PER_DAY              # [0, MICROS_PER_DAY)
    # the reference narrows the day to int32 before rebasing it
    out = day_fn(days.to(torch.int32)) * MICROS_PER_DAY + tod
    return torch.where(micros >= LAST_SWITCH_GREGORIAN_MICROS, micros, out)


def rebase_plain(col: Column, to_julian: bool) -> torch.Tensor:
    """The rebased data buffer of a DATE32 or TIMESTAMP_US column, in
    torch ops (any device); only the rows before the switch are computed,
    the others copied."""
    day_fn = _greg_to_julian_days if to_julian else _julian_to_greg_days
    data = col.data
    out = data.clone()
    if col.dtype.kind == Kind.DATE32:
        early = data < GREGORIAN_START_DAYS
        out[early] = day_fn(data[early]).to(torch.int32)
    else:
        early = data < LAST_SWITCH_GREGORIAN_MICROS
        out[early] = _rebase_micros(data[early], day_fn)
    return out


def _rebase(col: Column, to_julian: bool) -> Column:
    if col.dtype.kind not in (Kind.DATE32, Kind.TIMESTAMP_US):
        raise TypeError(
            "The input must be either day or microsecond timestamps to rebase.")
    op = "to_julian" if to_julian else "to_gregorian"
    if col.device.type == "cpu":
        PLAIN_CALLS[op] += 1
        out = rebase_plain(col, to_julian)
    else:
        out = datetime_rebase_cuda.rebase(col, to_julian)
    return Column(col.dtype, col.length, out, col.validity)


def rebase_gregorian_to_julian(col: Column) -> Column:
    """Spark localRebaseGregorianToJulianDays / rebaseGregorianToJulianMicros
    (datetime_rebase.cu:345-358)."""
    return _rebase(col, True)


def rebase_julian_to_gregorian(col: Column) -> Column:
    """Spark localRebaseJulianToGregorianDays / rebaseJulianToGregorianMicros
    (datetime_rebase.cu:360-373)."""
    return _rebase(col, False)
