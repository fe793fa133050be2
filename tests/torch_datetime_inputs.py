"""Inputs and oracles shared by the port's time-zone, calendar-rebase,
Z-order and histogram tests and `chip_smoke.py` phase 17: the JAX tests'
cases and their independent oracles (`zoneinfo` with fold=0 for the zones,
`datetime` and a Julian day count for the calendars, scalar bit loops for
Z-order, a scalar percentile), and random inputs made from seeds. Uses
numpy and the standard library only."""
import datetime
import math
from zoneinfo import ZoneInfo

import numpy as np

UTC = datetime.timezone.utc
US = 1_000_000
DAY_US = 86_400 * US

# ---- time zones (tests/test_timezones.py's cases) ----------------------------

SUPPORTED_ZONES = ["Asia/Shanghai", "America/Phoenix", "Pacific/Kiritimati",
                   "Asia/Kolkata", "Asia/Tokyo"]
UTC_TO_ZONE_MICROS = [0, 1_700_000_000_000_000, -123_456_000_000,
                      631_152_000_000_000, 86_399_999_999]
ZONE_TO_UTC_MICROS = [0, 1_700_000_000_000_000, 631_152_000_000_000,
                      946_684_800_000_000]
# (zone id, its offset in seconds): fixed offsets, short ids and Spark's
# legacy (+|-)h:mm form
FIXED_ZONES = [("+08:00", 8 * 3600), ("-09:30", -(9 * 3600 + 30 * 60)),
               ("UTC", 0), ("GMT+05:30", 5 * 3600 + 30 * 60),
               ("UTC-3:00", -3 * 3600), ("EST", -5 * 3600),
               ("HST", -10 * 3600), ("+8:00", 8 * 3600)]
FIXED_MICROS = [0, 1_000_000, -1, 1_700_000_000_123_456,
                1_600_000_000_000_000]
UNSUPPORTED_ZONE = "America/Los_Angeles"
# Kiritimati skipped 1994-12-31 (UTC-10:40 -> UTC+14): noon on that day
KIRITIMATI_GAP_WALL = int((datetime.datetime(1994, 12, 31, 12, 0) -
                           datetime.datetime(1970, 1, 1)).total_seconds()) * US


def wall_to_utc_oracle(micros, zone):
    """Micros read as wall-clock time in `zone` -> UTC micros (fold=0)."""
    tz = ZoneInfo(zone)
    out = []
    for us in micros:
        sec, frac = divmod(us, US)
        naive = datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=sec)
        aware = naive.replace(tzinfo=tz, fold=0)
        out.append(int(aware.timestamp()) * US + frac)
    return out


def utc_to_wall_oracle(micros, zone):
    tz = ZoneInfo(zone)
    out = []
    for us in micros:
        sec, frac = divmod(us, US)
        dt = datetime.datetime.fromtimestamp(sec, UTC).astimezone(tz)
        out.append(int(dt.replace(tzinfo=UTC).timestamp()) * US + frac)
    return out


def timestamps(seed, n, null_p=0.01, scale=US):
    """(values, validity): timestamps in `scale` ticks a second, uniform
    over 1900-01-01 .. 2100-01-01, with nulls and a few edge values."""
    rng = np.random.default_rng(seed)
    lo, hi = -2_208_988_800 * scale, 4_102_444_800 * scale
    v = rng.integers(lo, hi, n, dtype=np.int64)
    edges = [0, -1, 1, lo, hi - 1, -(2**63), 2**63 - 1]
    v[:len(edges)] = edges[:n]
    return v, rng.random(n) >= null_p


# ---- calendars (tests/test_datetime_rebase.py's cases) -----------------------

EPOCH_ORD = datetime.date(1970, 1, 1).toordinal()
GREGORIAN_START_DAYS = -141427                    # 1582-10-15
_MDAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def greg_days(y, m, d):
    return datetime.date(y, m, d).toordinal() - EPOCH_ORD


def julian_days_from_ymd(y, m, d):
    """Days since 1970-01-01 of a Julian-calendar date (a day count from
    Julian 0001-01-01, two days before the Gregorian one)."""
    yy = y - 1
    days = yy * 365 + yy // 4
    for mm in range(1, m):
        days += _MDAYS[mm - 1] + (1 if mm == 2 and y % 4 == 0 else 0)
    return days + d - 1 - EPOCH_ORD - 1


# Gregorian dates and the Julian days of the same dates; Julian dates and
# the Gregorian days (1500-02-29 exists only in the Julian calendar: the
# day after Gregorian 1500-02-28)
GREG_TO_JULIAN = [((1582, 10, 4), julian_days_from_ymd(1582, 10, 4)),
                  ((1500, 1, 1), julian_days_from_ymd(1500, 1, 1)),
                  ((1000, 6, 15), julian_days_from_ymd(1000, 6, 15)),
                  ((200, 2, 28), julian_days_from_ymd(200, 2, 28)),
                  ((4, 2, 29), julian_days_from_ymd(4, 2, 29)),
                  ((1, 1, 1), julian_days_from_ymd(1, 1, 1)),
                  ((1581, 12, 25), julian_days_from_ymd(1581, 12, 25))]
JULIAN_TO_GREG = [(julian_days_from_ymd(*d), want) for d, want in (
    ((1582, 10, 4), greg_days(1582, 10, 4)),
    ((1500, 2, 29), greg_days(1500, 2, 28) + 1),
    ((1000, 6, 15), greg_days(1000, 6, 15)),
    ((4, 2, 29), greg_days(4, 2, 29)),
    ((1, 1, 1), greg_days(1, 1, 1)))]
GAP_DAYS = [greg_days(1582, 10, d) for d in range(5, 15)]
MODERN_DAYS = [0, 1, 19000, GREGORIAN_START_DAYS, -100000]
TIMES_OF_DAY = [0, 1, 123456, DAY_US - 1]


def rebase_days(seed, n, null_p=0.01):
    """(int32 days, validity): 0001-01-01 .. 2100-12-31, a fifth of them
    before 1582-10-15, and the edges of int32 and of the switch."""
    rng = np.random.default_rng(seed)
    first, last = greg_days(1, 1, 1), greg_days(2100, 12, 31)
    early = rng.random(n) < 0.2
    v = np.where(early, rng.integers(first, GREGORIAN_START_DAYS, n),
                 rng.integers(GREGORIAN_START_DAYS, last + 1, n))
    edges = [-(2**31), 2**31 - 1, GREGORIAN_START_DAYS,
             GREGORIAN_START_DAYS - 1, GREGORIAN_START_DAYS - 10, -719468,
             -719469, -719468 - 146097, -719470 - 1461] + GAP_DAYS
    v[:len(edges)] = edges[:n]
    return v.astype(np.int32), rng.random(n) >= null_p


def rebase_micros(seed, n, null_p=0.01):
    """(int64 micros, validity): the days of `rebase_days` at random times
    of day, and int64's edges."""
    rng = np.random.default_rng(seed + 1)
    days, valid = rebase_days(seed, n, null_p)
    v = days.astype(np.int64) * DAY_US + rng.integers(0, DAY_US, n)
    edges = [-(2**63), 2**63 - 1, -12219292800000000, -12219292800000001]
    v[:len(edges)] = edges[:n]
    return v, valid


# ---- Z-order (tests/test_zorder.py's oracles) --------------------------------

ZORDER_TYPES = [("INT8", np.int8), ("INT16", np.int16), ("INT32", np.int32),
                ("INT64", np.int64), ("FLOAT32", np.float32),
                ("FLOAT64", np.float64), ("BOOL", np.bool_),
                ("UINT8", np.uint8), ("DATE32", np.int32),
                ("TIMESTAMP_US", np.int64)]
HILBERT_SHAPES = [(1, 1), (2, 2), (8, 2), (10, 3), (16, 4), (32, 2), (1, 64),
                  (4, 16), (32, 1), (21, 3)]


def zorder_values(rng, np_type, n):
    """n random values of a type: the whole range, NaN and -0.0 floats."""
    if np_type == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(np_type, np.floating):
        v = (rng.standard_normal(n) * 1e3).astype(np_type)
        v[::7] = np.nan
        v[3::11] = -0.0
        return v
    info = np.iinfo(np_type)
    return rng.integers(info.min, info.max, n, dtype=np_type, endpoint=True)


def zorder_columns(seed, np_type, ncols, n, null_p=0.1):
    """[(values, validity)] a column."""
    rng = np.random.default_rng(seed)
    return [(zorder_values(rng, np_type, n), rng.random(n) >= null_p)
            for _ in range(ncols)]


def unsigned_bits(v, valid, nbits):
    """Each value's nbits as a Python int (floats by their bits), nulls 0."""
    raw = np.asarray(v)
    if raw.dtype == np.bool_:
        raw = raw.astype(np.uint8)
    u = raw.view(f"u{raw.dtype.itemsize}").astype(np.uint64)
    return [int(x) & ((1 << nbits) - 1) if ok else 0
            for x, ok in zip(u.tolist(), valid)]


def oracle_interleave(rows, nbits):
    """rows: tuples of Python ints (masked to nbits) -> each row's bytes."""
    out = []
    for tup in rows:
        bits = [(v >> b) & 1 for b in range(nbits - 1, -1, -1) for v in tup]
        out.append([int("".join(map(str, bits[i:i + 8])), 2)
                    for i in range(0, len(bits), 8)])
    return out


def oracle_hilbert(point, bits):
    """Skilling's algorithm (Programming the Hilbert curve, 2004), scalar:
    transpose, then interleave; as a signed int64."""
    n = len(point)
    x = [p & ((1 << bits) - 1) for p in point]
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(n):
            if x[i] & q:
                x[0] ^= p
            else:
                t = (x[0] ^ x[i]) & p
                x[0] ^= t
                x[i] ^= t
        q >>= 1
    for i in range(1, n):
        x[i] ^= x[i - 1]
    t = 0
    q = 1 << (bits - 1)
    while q > 1:
        if x[n - 1] & q:
            t ^= q - 1
        q >>= 1
    x = [v ^ t for v in x]
    out = 0
    for b in range(bits - 1, -1, -1):
        for i in range(n):
            out = (out << 1) | ((x[i] >> b) & 1)
    return out - (1 << 64) if out >= (1 << 63) else out


# the first-order 2-D curve visits (0,0) (0,1) (1,1) (1,0)
HILBERT_2D = ([0, 0, 1, 1], [0, 1, 1, 0])


# ---- histograms (tests/test_histogram.py's cases) ----------------------------

PERCENTAGES = [[0.5], [0.0, 0.25, 0.5, 0.75, 1.0],
               [0.0, 0.1, 0.33, 0.5, 0.9, 1.0]]
ORACLE_HISTOGRAMS = [
    [(10, 1), (20, 1), (30, 1)],
    [(5, 10)],
    [(1, 1), (100, 99)],
    [(None, 1), (7, 3), (2, 2)],
    [(None, 1)],
    [(-5, 2), (0, 1), (5, 2)],
    [],
]
# a negative count, which only create_histogram_if_valid rejects: the
# running sums 3, 2, 4, 5 fall, and the JAX package counts the sums below
# each target (a binary search would not)
NEGATIVE_COUNT = ([1.0, 2.0, 3.0, 4.0], [3, -1, 2, 1], [0.0, 0.3, 0.5, 1.0],
                  [1.0, 1.2, 2.0, 4.0])


def percentile_oracle(pairs, percentages):
    """Spark's percentile of one histogram [(value or None, freq)] with
    non-negative counts: sorted, nulls dropped, floor/ceil interpolation."""
    live = sorted(p for p in pairs if p[0] is not None)
    if not live:
        return None
    acc, total = [], 0
    for _, f in live:
        total += f
        acc.append(total)

    def elem(target):
        return next((v for (v, _), a in zip(live, acc) if a >= target),
                    live[-1][0])
    out = []
    for pct in percentages:
        position = (acc[-1] - 1) * pct
        lo, hi = math.floor(position), math.ceil(position)
        lo_el, hi_el = elem(lo + 1), elem(hi + 1)
        out.append(float(lo_el) if hi == lo or hi_el == lo_el else
                   (hi - position) * lo_el + (position - lo) * hi_el)
    return out


def random_histograms(seed, n_hist, max_len, null_p=0.01, max_count=1000,
                      min_len=0, value_kind=np.float64):
    """(values, validity, counts, offsets) numpy arrays: n_hist histograms
    of min_len..max_len elements, values with ties (quarters in
    [-250, 250) for floats, [-1000, 1000) for integers), counts 0..max_count,
    int32 offsets."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, n_hist)
    offsets = np.zeros(n_hist + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    m = int(offsets[-1])
    raw = rng.integers(-1000, 1000, m)
    if np.issubdtype(value_kind, np.floating):
        values = (raw * 0.25).astype(value_kind)
    elif value_kind == np.bool_:
        values = raw > 0
    else:
        info = np.iinfo(value_kind)
        values = np.clip(raw, info.min, info.max).astype(value_kind)
    return (values, rng.random(m) >= null_p,
            rng.integers(0, max_count + 1, m).astype(np.int64),
            offsets.astype(np.int32))
