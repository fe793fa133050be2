"""The port's time-zone conversions (`spark_rapids_tpu_torch/ops/timezones.py`)
against the JAX package's, bit for bit: every supported zone of the JAX
tests both ways over random timestamps of 1900-2100 with nulls and int64's
edges, every unit, fixed offsets, short ids and Spark's legacy forms, the
zones' tables, the supported set, the errors, and the oracle (`zoneinfo`
with fold=0) on the JAX tests' instants; the database's shutdown and
reload; the kernel's row code (csrc/timezones.cu) built with the host's
C++ compiler against the plain version; and `api.GpuTimeZoneDB`.
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
from spark_rapids_tpu.ops import timezones as jtz
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import timezones as ttz
from torch_cast_inputs import build_host
from torch_cast_jax import assert_same_column
from torch_datetime_inputs import (FIXED_MICROS, FIXED_ZONES,
                                   KIRITIMATI_GAP_WALL, SUPPORTED_ZONES,
                                   UNSUPPORTED_ZONE, UTC_TO_ZONE_MICROS,
                                   ZONE_TO_UTC_MICROS, timestamps,
                                   utc_to_wall_oracle, wall_to_utc_oracle)

N = 4096
UNITS = {"TIMESTAMP_S": 1, "TIMESTAMP_MS": 1_000, "TIMESTAMP_US": 1_000_000}
DIRECTIONS = {"to_utc": (jtz.from_timestamp_to_utc_timestamp,
                         ttz.from_timestamp_to_utc_timestamp),
              "from_utc": (jtz.from_utc_timestamp_to_timestamp,
                           ttz.from_utc_timestamp_to_timestamp)}


@functools.lru_cache(None)
def columns(unit):
    v, valid = timestamps(9, N, scale=UNITS[unit])
    return (JCol.from_numpy(v, jdt.DType(jdt.Kind[unit]), validity=valid),
            TCol.from_numpy(v, tdt.DType(tdt.Kind[unit]), valid,
                            device="cpu"))


def us_columns(micros):
    a = np.array(micros, np.int64)
    return (JCol.from_numpy(a, jdt.TIMESTAMP_US),
            TCol.from_numpy(a, tdt.TIMESTAMP_US, device="cpu"))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("zone", SUPPORTED_ZONES)
def test_supported_zone_equals_jax_and_the_oracle(zone, direction):
    assert ttz.is_supported_time_zone(zone) == jtz.is_supported_time_zone(zone)
    if not ttz.is_supported_time_zone(zone):
        pytest.skip(f"{zone} has recurring DST rules in this tzdata")
    jf, tf = DIRECTIONS[direction]
    jc, tc = columns("TIMESTAMP_US")
    assert_same_column(tf(tc, zone), jf(jc, zone))
    micros = ZONE_TO_UTC_MICROS if direction == "to_utc" else \
        UTC_TO_ZONE_MICROS
    oracle = wall_to_utc_oracle if direction == "to_utc" else \
        utc_to_wall_oracle
    assert tf(us_columns(micros)[1], zone).to_pylist() == oracle(micros, zone)


@pytest.mark.parametrize("unit", UNITS)
def test_units_equal_jax(unit):
    jc, tc = columns(unit)
    for jf, tf in DIRECTIONS.values():
        for zone in ("Asia/Tokyo", "Asia/Kolkata"):
            assert_same_column(tf(tc, zone), jf(jc, zone))


@pytest.mark.parametrize("zone,offset", FIXED_ZONES)
def test_fixed_offsets_equal_jax(zone, offset):
    jc, tc = us_columns(FIXED_MICROS)
    for name, (jf, tf) in DIRECTIONS.items():
        got = tf(tc, zone)
        assert_same_column(got, jf(jc, zone))
        sign = -1 if name == "to_utc" else 1
        assert got.to_pylist() == [m + sign * offset * 1_000_000
                                   for m in FIXED_MICROS]


def test_kiritimati_skipped_day():
    """Noon of 1994-12-31, which Kiritimati skipped, resolves with the
    offset before the transition (fold=0), as the JAX package does."""
    jc, tc = us_columns([KIRITIMATI_GAP_WALL])
    got = ttz.from_timestamp_to_utc_timestamp(tc, "Pacific/Kiritimati")
    assert got.to_pylist() == wall_to_utc_oracle([KIRITIMATI_GAP_WALL],
                                                 "Pacific/Kiritimati")
    assert_same_column(got, jtz.from_timestamp_to_utc_timestamp(
        jc, "Pacific/Kiritimati"))


def test_tables_and_ids_equal_jax():
    """Each zone's transition table, the supported set over good, bad and
    unsupported ids, and Spark's legacy id fixups."""
    tdb, jdb = ttz.TimeZoneDB.instance(), jtz.TimeZoneDB.instance()
    for zone in SUPPORTED_ZONES + [z for z, _ in FIXED_ZONES]:
        if not jtz.is_supported_time_zone(zone):
            continue
        tkey, trows = tdb._table_for(zone)
        jkey, jrows = jdb._table_for(zone)
        assert tkey == jkey
        for t, j in zip(trows, jrows):
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype
    ids = [UNSUPPORTED_ZONE, "not/a_zone", "+19:00", "+08:99", "GMT+8",
           "UTC+08:00:30", "Z", "CTT", "PST", "Etc/GMT+5", " Asia/Tokyo "]
    assert [ttz.is_supported_time_zone(z) for z in ids] == \
        [jtz.is_supported_time_zone(z) for z in ids]
    for raw in ("+8:00", "-09:3", "+05:30", "UTC"):
        assert ttz.normalize_zone_id(raw) == jtz.normalize_zone_id(raw)


def test_errors_equal_jax():
    jc, tc = us_columns([0])
    for zone in (UNSUPPORTED_ZONE, "not/a_zone", "+08:99", "+19:00"):
        if zone == UNSUPPORTED_ZONE and jtz.is_supported_time_zone(zone):
            continue
        with pytest.raises(ValueError) as want:
            jtz.from_utc_timestamp_to_timestamp(jc, zone)
        with pytest.raises(ValueError) as got:
            ttz.from_utc_timestamp_to_timestamp(tc, zone)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as want:
        jtz.from_utc_timestamp_to_timestamp(
            JCol.from_pylist([1], jdt.INT64), "UTC")
    with pytest.raises(TypeError) as got:
        ttz.from_utc_timestamp_to_timestamp(
            TCol.from_pylist([1], tdt.INT64, device="cpu"), "UTC")
    assert str(got.value) == str(want.value)


def test_shutdown_and_reload_give_equal_results():
    jc, tc = columns("TIMESTAMP_MS")
    before = ttz.from_utc_timestamp_to_timestamp(tc, "Asia/Shanghai")
    db1 = ttz.TimeZoneDB.cache_database()
    assert ttz.TimeZoneDB.cache_database() is db1
    ttz.TimeZoneDB.shutdown()
    loader = ttz.TimeZoneDB.cache_database_async()
    loader.join(timeout=60)
    assert not loader.is_alive()
    db2 = ttz.TimeZoneDB.cache_database()
    assert db2 is not db1
    after = ttz.from_utc_timestamp_to_timestamp(tc, "Asia/Shanghai")
    assert torch.equal(after.data, before.data)
    assert_same_column(after, jtz.from_utc_timestamp_to_timestamp(
        jc, "Asia/Shanghai"))


def test_facade_equals_jax():
    api.GpuTimeZoneDB.cacheDatabase()
    japi.GpuTimeZoneDB.cacheDatabase()
    assert api.GpuTimeZoneDB.isSupportedTimeZone("Asia/Shanghai")
    assert not api.GpuTimeZoneDB.isSupportedTimeZone("not/a_zone")
    jc, tc = columns("TIMESTAMP_US")
    j = japi.GpuTimeZoneDB.fromTimestampToUtcTimestamp(jc, "Asia/Shanghai")
    t = api.GpuTimeZoneDB.fromTimestampToUtcTimestamp(tc, "Asia/Shanghai")
    assert_same_column(t, j)
    assert_same_column(
        api.GpuTimeZoneDB.fromUtcTimestampToTimestamp(t, "Asia/Shanghai"),
        japi.GpuTimeZoneDB.fromUtcTimestampToTimestamp(j, "Asia/Shanghai"))
    api.GpuTimeZoneDB.shutdown()
    japi.GpuTimeZoneDB.shutdown()


# ---- the kernel's row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("timezones", tmp_path_factory.mktemp("timezones_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    P = ctypes.c_void_p
    lib.host_convert.argtypes = [P, ctypes.c_longlong, P, P, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, P]
    return lib


@pytest.mark.parametrize("unit", UNITS)
def test_kernel_rows_equal_plain(host_lib, unit):
    _, tc = columns(unit)
    scale = UNITS[unit]
    for zone in SUPPORTED_ZONES + ["+05:30"]:
        if not ttz.is_supported_time_zone(zone):
            continue
        utc, loc, offs = ttz.TimeZoneDB.instance().tables_on(
            zone, torch.device("cpu"))
        for to_utc, keys in ((True, loc), (False, utc)):
            out = torch.empty_like(tc.data)
            assert host_lib.host_convert(
                tc.data.data_ptr(), tc.length, keys.data_ptr(),
                offs.data_ptr(), keys.numel(), int(to_utc), scale,
                out.data_ptr()) == 0
            assert torch.equal(out, ttz.convert_plain(tc.data, keys, offs,
                                                      to_utc, scale))
