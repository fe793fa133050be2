"""Timestamp <-> UTC conversion in a time zone (`GpuTimeZoneDB`).

Counterpart of `spark_rapids_tpu/ops/timezones.py` (the reference's
GpuTimeZoneDB.java and timezones.cu). The host half is the JAX package's,
copied: it parses the system's TZif files (RFC 8536), keeps the zones
without a recurring DST rule (a TZif footer with a ',' is one; fixed
offsets always), and builds per zone three arrays, as GpuTimeZoneDB's
`loadData` does:

    utc_instants  int64 seconds  (searched when converting UTC -> zone)
    tz_instants   int64 seconds  (searched when converting zone -> UTC)
    offsets       int32 seconds  (the offset after each transition)

Row 0 is the (INT64_MIN, INT64_MIN, first standard offset) sentinel; a
gap stores (instant, instant + offset after), an overlap (instant,
instant + offset before), Spark's disambiguation. Zone ids go through
Spark's legacy fixups and java.time's `SHORT_IDS`.

A conversion truncates each timestamp to epoch seconds toward zero, finds
its transition by `searchsorted(side="right")` over the zone's keys,
scales the offset found back to the column's unit (s, ms or us) and adds
it (from UTC) or subtracts it (to UTC), with int64 wraparound. On a CUDA
column the conversion kernel runs (`timezones_cuda`, csrc/timezones.cu:
one thread a row, the zone's table in shared memory) or the call raises;
on a CPU column the plain version runs. Every row is computed, null rows
too; the validity passes through. The database caches one tensor triple
per (zone, device), unpadded: the JAX package's INT64_MAX pads never
change a right-side search's offset.
"""
from __future__ import annotations

import dataclasses
import os
import re
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import Kind
from . import timezones_cuda
from .timezones_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["TimeZoneDB", "from_timestamp_to_utc_timestamp",
           "from_utc_timestamp_to_timestamp", "is_supported_time_zone",
           "normalize_zone_id", "SHORT_IDS", "LAUNCHES", "PLAIN_CALLS",
           "reset_counters"]

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

# java.time.ZoneId.SHORT_IDS, applied by the reference's getZoneId
# (GpuTimeZoneDB.java:257)
SHORT_IDS = {
    "ACT": "Australia/Darwin", "AET": "Australia/Sydney",
    "AGT": "America/Argentina/Buenos_Aires", "ART": "Africa/Cairo",
    "AST": "America/Anchorage", "BET": "America/Sao_Paulo",
    "BST": "Asia/Dhaka", "CAT": "Africa/Harare", "CNT": "America/St_Johns",
    "CST": "America/Chicago", "CTT": "Asia/Shanghai",
    "EAT": "Africa/Addis_Ababa", "ECT": "Europe/Paris",
    "IET": "America/Indiana/Indianapolis", "IST": "Asia/Kolkata",
    "JST": "Asia/Tokyo", "MIT": "Pacific/Apia", "NET": "Asia/Yerevan",
    "NST": "Pacific/Auckland", "PLT": "Asia/Karachi",
    "PNT": "America/Phoenix", "PRT": "America/Puerto_Rico",
    "PST": "America/Los_Angeles", "SST": "Pacific/Guadalcanal",
    "VST": "Asia/Ho_Chi_Minh",
    "EST": "-05:00", "MST": "-07:00", "HST": "-10:00",
}

_TZPATHS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo",
            "/usr/share/lib/zoneinfo", "/etc/zoneinfo")

# the unit of each timestamp kind, in its ticks a second
SCALES = {Kind.TIMESTAMP_S: 1, Kind.TIMESTAMP_MS: 1_000,
          Kind.TIMESTAMP_US: 1_000_000}


# ---- TZif parsing (host side; RFC 8536) -------------------------------------

@dataclasses.dataclass
class _TzifData:
    trans_times: List[int]        # transition instants, UTC seconds
    trans_types: List[int]        # index into utoffs per transition
    utoffs: List[int]             # seconds east of UTC per local time type
    isdsts: List[bool]
    footer: str                   # POSIX TZ string ('' if none / v1)


def _parse_tzif(path: str) -> _TzifData:
    with open(path, "rb") as f:
        raw = f.read()

    def parse_block(buf, off, time_size):
        magic, version = struct.unpack_from(">4sc", buf, off)
        if magic != b"TZif":
            raise ValueError(f"{path}: not a TZif file")
        isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = \
            struct.unpack_from(">6I", buf, off + 20)
        p = off + 44
        fmt = ">%d%s" % (timecnt, "q" if time_size == 8 else "l")
        trans = list(struct.unpack_from(fmt, buf, p)) if timecnt else []
        p += timecnt * time_size
        types = (list(struct.unpack_from(">%dB" % timecnt, buf, p))
                 if timecnt else [])
        p += timecnt
        utoffs, isdsts = [], []
        for i in range(typecnt):
            utoff, isdst, _desig = struct.unpack_from(">lBB", buf, p + 6 * i)
            utoffs.append(utoff)
            isdsts.append(bool(isdst))
        p += 6 * typecnt + charcnt
        p += leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return version, trans, types, utoffs, isdsts, p

    version, trans, types, utoffs, isdsts, end = parse_block(raw, 0, 4)
    footer = ""
    if version != b"\x00":
        # v2+: a second, 64-bit data block follows, then the footer string
        _, trans, types, utoffs, isdsts, end = parse_block(raw, end, 8)
        nl1 = raw.index(b"\n", end)
        nl2 = raw.index(b"\n", nl1 + 1)
        footer = raw[nl1 + 1:nl2].decode("ascii", errors="replace")
    return _TzifData(trans, types, utoffs, isdsts, footer)


def _zone_is_supported(tz: _TzifData) -> bool:
    """The reference's supported set (GpuTimeZoneDB.java:236-240): a fixed
    offset, or rules with no recurring transition rule (a ',' in the
    footer)."""
    return "," not in tz.footer


def _build_transition_rows(tz: _TzifData
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(utc_instants, tz_instants, offsets), as GpuTimeZoneDB.loadData."""
    utc, loc, off = [INT64_MIN], [INT64_MIN], []
    if not tz.trans_times:
        # a fixed-offset zone: the sentinel row with its lone offset
        off.append(tz.utoffs[0] if tz.utoffs else 0)
    else:
        # before the first transition: the first standard (non-DST) type,
        # else type 0 (tzfile(5), java.time's initial standard offset)
        before = next((u for u, d in zip(tz.utoffs, tz.isdsts) if not d),
                      tz.utoffs[0])
        off.append(before)
        for t, ty in zip(tz.trans_times, tz.trans_types):
            after = tz.utoffs[ty]
            utc.append(t)
            # a gap (clocks jump forward) against the instant + the offset
            # after; an overlap against the instant + the offset before
            loc.append(t + after if after > before else t + before)
            off.append(after)
            before = after
    return (np.array(utc, dtype=np.int64), np.array(loc, dtype=np.int64),
            np.array(off, dtype=np.int32))


# ---- zone ids (the Spark / java.time surface) --------------------------------

_OFFSET_RE = re.compile(
    r"^(?P<sign>[+-])(?P<h>\d{1,2})(?::?(?P<m>\d{2})(?::?(?P<s>\d{2}))?)?$")


def normalize_zone_id(tz_str: str) -> str:
    """Spark's pre-3.0 zone-id fixups (GpuTimeZoneDB.getZoneId :251-258)."""
    tz_str = re.sub(r"(\+|\-)(\d):", r"\g<1>0\g<2>:", tz_str, count=1)
    tz_str = re.sub(r"(\+|\-)(\d\d):(\d)$", r"\g<1>\g<2>:0\g<3>", tz_str,
                    count=1)
    return tz_str


def _resolve_zone(tz_str: str):
    """("fixed", offset seconds) or ("region", the zone's path id)."""
    s = normalize_zone_id(tz_str.strip())
    s = SHORT_IDS.get(s, s)
    if s in ("Z", "UTC", "GMT", "UT", "Etc/UTC", "Etc/GMT"):
        return ("fixed", 0)
    for prefix in ("UTC", "GMT", "UT"):
        if s.startswith(prefix) and len(s) > len(prefix):
            s = s[len(prefix):]
            break
    m = _OFFSET_RE.match(s)
    if m:
        mins, secs = int(m.group("m") or 0), int(m.group("s") or 0)
        if mins > 59 or secs > 59:  # ZoneOffset.of rejects +08:99
            raise ValueError(f"invalid zone offset: {tz_str}")
        total = int(m.group("h")) * 3600 + mins * 60 + secs
        if total > 18 * 3600:  # java.time's limit: +/-18:00
            raise ValueError(f"zone offset out of range: {tz_str}")
        return ("fixed", -total if m.group("sign") == "-" else total)
    for root in _TZPATHS:
        if os.path.isfile(os.path.join(root, s)):
            return ("region", s)
    raise ValueError(f"unknown time zone: {tz_str}")


# ---- the database singleton ------------------------------------------------

class TimeZoneDB:
    """The cached transition database (GpuTimeZoneDB.java:60-202: an
    idempotent cache, an asynchronous load, shutdown)."""

    _instance: Optional["TimeZoneDB"] = None
    _lock = threading.Lock()

    def __init__(self):
        # zone key -> (utc_instants, tz_instants, offsets), numpy
        self._tables: Dict[str, Tuple[np.ndarray, np.ndarray,
                                      np.ndarray]] = {}
        # (zone key, device) -> the same three as tensors
        self._device: Dict[Tuple[str, torch.device],
                           Tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor]] = {}
        self._table_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "TimeZoneDB":
        with cls._lock:
            if cls._instance is None:
                cls._instance = TimeZoneDB()
            return cls._instance

    @classmethod
    def cache_database(cls) -> "TimeZoneDB":
        return cls.instance()

    @classmethod
    def cache_database_async(cls) -> threading.Thread:
        t = threading.Thread(target=cls.cache_database, daemon=True,
                             name="torch-tzdb-loader")
        t.start()
        return t

    @classmethod
    def shutdown(cls) -> None:
        """Drop the cached database; a later cache_database() reloads it
        (GpuTimeZoneDB.java:161-176)."""
        with cls._lock:
            cls._instance = None

    def _table_for(self, tz_str: str):
        kind, key = _resolve_zone(tz_str)
        cache_key = f"fixed:{key}" if kind == "fixed" else key
        with self._table_lock:
            if cache_key in self._tables:
                return cache_key, self._tables[cache_key]
            if kind == "fixed":
                rows = (np.array([INT64_MIN], np.int64),
                        np.array([INT64_MIN], np.int64),
                        np.array([key], np.int32))
            else:
                path = next(os.path.join(r, key) for r in _TZPATHS
                            if os.path.isfile(os.path.join(r, key)))
                tz = _parse_tzif(path)
                if not _zone_is_supported(tz):
                    raise ValueError(f"Unsupported timezone: {tz_str}")
                rows = _build_transition_rows(tz)
            self._tables[cache_key] = rows
            return cache_key, rows

    def tables_on(self, tz_str: str, device: torch.device):
        """The zone's (utc_instants, tz_instants, offsets) on `device`."""
        key, rows = self._table_for(tz_str)
        with self._table_lock:
            if (key, device) not in self._device:
                self._device[(key, device)] = tuple(
                    torch.from_numpy(a).to(device) for a in rows)
            return self._device[(key, device)]


def is_supported_time_zone(tz_str: str) -> bool:
    try:
        TimeZoneDB.instance()._table_for(tz_str)
        return True
    except ValueError:
        return False


def convert_plain(ts: torch.Tensor, keys: torch.Tensor,
                  offsets: torch.Tensor, to_utc: bool,
                  scale: int) -> torch.Tensor:
    """The converted (n,) int64 timestamps, in torch ops (any device)."""
    ts = ts.to(torch.int64)
    # epoch seconds, truncated toward zero (timezones.cu:74-76)
    epoch_s = torch.div(ts, scale, rounding_mode="trunc")
    idx = torch.searchsorted(keys, epoch_s, right=True)
    off = offsets[idx - 1].to(torch.int64) * scale
    return ts - off if to_utc else ts + off


def _convert(column: Column, tz_str: str, to_utc: bool) -> Column:
    if column.dtype.kind not in SCALES:
        raise TypeError(f"expected a timestamp column, got {column.dtype}")
    db = TimeZoneDB.cache_database()
    utc_i, tz_i, offs = db.tables_on(tz_str, column.device)
    keys = tz_i if to_utc else utc_i
    scale = SCALES[column.dtype.kind]
    op = "to_utc" if to_utc else "from_utc"
    if column.device.type == "cpu":
        PLAIN_CALLS[op] += 1
        out = convert_plain(column.data, keys, offs, to_utc, scale)
    else:
        out = timezones_cuda.convert(column, keys, offs, to_utc, scale)
    return Column(column.dtype, column.length, out, column.validity)


def from_timestamp_to_utc_timestamp(column: Column, tz_str: str) -> Column:
    """Read `column` as wall-clock time in `tz_str`; return UTC instants
    (GpuTimeZoneDB.fromTimestampToUtcTimestamp :204-217)."""
    return _convert(column, tz_str, to_utc=True)


def from_utc_timestamp_to_timestamp(column: Column, tz_str: str) -> Column:
    """UTC instants to wall-clock time in `tz_str`
    (GpuTimeZoneDB.fromUtcTimestampToTimestamp :219-232)."""
    return _convert(column, tz_str, to_utc=False)
