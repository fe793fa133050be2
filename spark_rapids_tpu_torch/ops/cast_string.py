"""Spark-exact string -> integer and string -> float casts, and the base
conversions (`conv`), ANSI-aware.

Counterpart of `spark_rapids_tpu/ops/cast_string.py` (the reference's
cast_string.cu:158-244, cast_string_to_float.cu:56-653 and
CastStringJni.cpp:159-258), with its semantics and quirks:

- whitespace is {space, \\r, \\t, \\n} (the base conversions' regex class
  adds \\f and \\v);
- integer casts take leading and trailing whitespace (`strip`), a sign,
  and outside ANSI mode truncate at the first '.' with the tail still
  validated; a value past the target type's limits is invalid;
- float casts: 'nan' only as the exact 3-char string, 'inf'/'infinity'
  must end the string (junk after it nulls the row without an ANSI
  error), at most 19 significant digits plus a guarded 20th, 4-digit
  exponents, one trailing f/F/d/D, and the value built in float64 as
  `sign * digits * 10^exp` (then cast for FLOAT32); '0e5' and '0\\n' are
  valid zeros and '0f' invalid;
- ANSI mode raises `CastError` with the first failing row and its string.

Each entry point runs the cast kernel (`cast_cuda`, csrc/cast_string.cu
and csrc/cast_string_to_float.cu, one thread a row over the offsets and
chars) on a CUDA column, or raises; on a CPU column it runs the plain
version (`*_plain`): the JAX package's padded-matrix algebra in PyTorch,
which the tests hold against the JAX package and the kernel against. The
plain version keeps `pad_to` (the width of its (n, L) char matrix, at
least the longest string); the kernel reads the chars through the offsets
and has no use for it.

Two things the JAX package computes on the CPU the plain version and the
kernel carry as they come out there:

- the float64 arithmetic runs with subnormals flushed to zero, detected
  after rounding, as XLA runs it on x86 (`ftz_mul`, `to_float32_ftz`);
- `floor(log10(d))` of the digits' float64 is XLA's log10 (log(x) times
  log10(e), not correctly rounded): where it turns is `LOG10_STEPS`.

A row the cast rejects has data 0 in both forms, where the JAX package
leaves whatever its algebra computed there; only its validity is defined.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..columnar import Column, make_string_column
from ..dtypes import DType, Kind
from . import cast_cuda
from .cast_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["CastError", "string_to_integer", "string_to_float",
           "string_to_integer_with_base", "integer_to_string_with_base",
           "LAUNCHES", "PLAIN_CALLS", "reset_counters"]


class CastError(RuntimeError):
    """ANSI cast failure carrying the first bad row (cast_string.hpp:26-56)."""

    def __init__(self, row_number: int, string_with_error: str):
        super().__init__(
            f"Error casting data on row {row_number}: {string_with_error!r}")
        self.row_number = row_number
        self.string_with_error = string_with_error


INT_LIMITS = {
    Kind.INT8: (-128, 127),
    Kind.INT16: (-32768, 32767),
    Kind.INT32: (-(2**31), 2**31 - 1),
    Kind.INT64: (-(2**63), 2**63 - 1),
}
INT64_MIN = -(2**63)


def wrap64(v: int) -> int:
    """A Python int mod 2^64 as the int64 of the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


# 10^k mod 2^64 for k in [0, 19] as int64 bits (10^19 > 2^63)
POW10_U64 = [wrap64(10 ** k) for k in range(20)]


# ---- unsigned 64-bit helpers over int64 (torch has no uint64 math on CPU) --

def ugt(a: torch.Tensor, b) -> torch.Tensor:
    """a > b as unsigned 64-bit values held in int64."""
    return (a ^ INT64_MIN) > (b ^ INT64_MIN if isinstance(b, torch.Tensor)
                              else wrap64(b) ^ INT64_MIN)


def ule(a: torch.Tensor, b) -> torch.Tensor:
    return ~ugt(a, b)


def ushr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-held unsigned values by 0 < k < 64."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def u64_to_f64(a: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit values (int64 bits) -> float64, rounded to nearest
    even: values at or above 2^63 convert halved with the lost bit kept
    sticky, then doubled."""
    big = a < 0
    half = ushr(a, 1) | (a & 1)
    return torch.where(big, half.to(torch.float64) * 2.0,
                       a.to(torch.float64))


# ---- the padded char matrix -------------------------------------------------

def _round_bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def check_pad_to(longest: int, pad_to: Optional[int]) -> None:
    """The JAX package's ValueError for a char matrix narrower than the
    longest string."""
    if pad_to is not None and longest > pad_to:
        raise ValueError(f"pad_to={pad_to} is smaller than the longest "
                         f"string ({longest})")


def padded_chars(col: Column, pad_to: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n, L) int32 chars zero-padded, (n,) int32 lengths): L is `pad_to`
    or the power-of-two bucket at or above the longest string. One host
    read: the longest length."""
    if not col.dtype.is_string:
        raise TypeError(f"expected a STRING column, got {col.dtype!r}")
    lens = col.string_lengths()
    longest = int(lens.max()) if col.length else 0
    check_pad_to(longest, pad_to)
    if pad_to is None:
        pad_to = _round_bucket(max(1, longest))
    dev = col.device
    pos = torch.arange(pad_to, dtype=torch.int64, device=dev)
    idx = col.offsets[:-1].to(torch.int64)[:, None] + pos[None, :]
    chars = col.data if col.data.numel() else torch.zeros(
        1, dtype=torch.uint8, device=dev)
    got = chars[idx.clamp(0, chars.numel() - 1)]
    inside = pos[None, :] < lens[:, None]
    return torch.where(inside, got, 0).to(torch.int32), lens


def strings_from_padded(padded: torch.Tensor, lengths: torch.Tensor,
                        validity: Optional[torch.Tensor]) -> Column:
    """A STRING column of each row's first `lengths` bytes of `padded`
    ((n, W) uint8), in row order; `lengths` as given, null rows too."""
    n, w = padded.shape
    lengths = lengths.to(torch.int32)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=padded.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    pos = torch.arange(w, device=padded.device)
    chars = padded[pos[None, :] < lengths[:, None]].to(torch.uint8)
    return make_string_column(chars, offsets, validity)


def ws4(C: torch.Tensor) -> torch.Tensor:
    return (C == 32) | (C == 13) | (C == 9) | (C == 10)


def first_idx(mask: torch.Tensor, default: int) -> torch.Tensor:
    """Per row the first True column of an (n, L) mask, else `default`."""
    has = mask.any(1)
    idx = mask.to(torch.uint8).argmax(1).to(torch.int32)
    return torch.where(has, idx, default)


def char_at(C: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row the char at a (clipped) index."""
    i = idx.clamp(0, C.shape[1] - 1).to(torch.int64)
    return C.gather(1, i[:, None])[:, 0]


def _pos(C: torch.Tensor) -> torch.Tensor:
    return torch.arange(C.shape[1], dtype=torch.int32, device=C.device)[None]


def _table(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


# ---- ANSI -------------------------------------------------------------------

def row_string(col: Column, row: int) -> str:
    """The row's string as the JAX package's `to_pylist` decodes it ('' for
    a null row)."""
    if not bool(col.null_mask[row]):
        return ""
    a, b = (int(x) for x in col.offsets[row:row + 2].tolist())
    return bytes(col.data[a:b].cpu().numpy()).decode("utf-8",
                                                     errors="replace")


def raise_first_error(col: Column, errors: torch.Tensor) -> None:
    """Raise CastError for the first flagged row (validate_ansi_column,
    cast_string.cu:601-634); one host read when no row is flagged."""
    n = errors.shape[0]
    if n == 0:
        return
    rows = torch.arange(n, dtype=torch.int64, device=errors.device)
    first = int(torch.where(errors, rows, n).min())
    if first < n:
        raise CastError(first, row_string(col, first))


def _finish(col: Column, out: Column, errors: torch.Tensor,
            ansi_mode: bool) -> Column:
    if ansi_mode:
        raise_first_error(col, errors)
    return out


def _on_cpu(col: Column) -> bool:
    return col.device.type == "cpu"


def _int_column(out_type: DType, val: torch.Tensor, valid: torch.Tensor
                ) -> Column:
    """(n,) int64 values -> a column of `out_type`, 0 on invalid rows,
    narrowed by truncation (the bits of a UINT64 kept)."""
    val = torch.where(valid, val, 0)
    st = out_type.storage_dtype()
    data = val.view(torch.uint64) if st == torch.uint64 else val.to(st)
    return Column(out_type, val.shape[0], data, valid)


# ---- string -> integer ------------------------------------------------------

def string_to_integer_plain(col: Column, out_type: DType,
                            ansi_mode: bool = False, strip: bool = True,
                            pad_to: Optional[int] = None
                            ) -> Tuple[Column, torch.Tensor]:
    """-> (the cast column, the ANSI error flags)."""
    tmin, tmax = INT_LIMITS[out_type.kind]
    C, lens = padded_chars(col, pad_to)
    n, L = C.shape
    dev = C.device
    pos = _pos(C)
    in_str = pos < lens[:, None]
    ws = ws4(C)
    digit = (C >= 48) & (C <= 57)
    dot = C == 46
    valid_in = col.null_mask

    if strip:
        nonws = ~ws & in_str
        i0 = torch.where(nonws.any(1), first_idx(nonws, 0), lens)
    else:
        i0 = torch.zeros(n, dtype=torch.int32, device=dev)
    c0 = char_at(C, i0)
    has_sign = ((c0 == 43) | (c0 == 45)) & (i0 < lens)
    neg = (c0 == 45) & has_sign
    istart = i0 + has_sign.to(torch.int32)
    valid = valid_in & (lens > 0) & (istart < lens)

    region = (pos >= istart[:, None]) & in_str
    valid &= ~(region & ~digit & ~dot & ~ws).any(1)
    ws_in = ws & region
    if strip:
        fw = first_idx(ws_in, L)
        valid &= ~(region & (pos >= fw[:, None]) & ~ws).any(1)
        valid &= fw != istart
    else:
        valid &= ~ws_in.any(1)
        fw = torch.full((n,), L, dtype=torch.int32, device=dev)
    dot_in = dot & region
    if ansi_mode:
        valid &= ~dot_in.any(1)
        first_dot = torch.full((n,), L, dtype=torch.int32, device=dev)
    else:
        first_dot = first_idx(dot_in, L)
        valid &= dot_in.sum(1) <= 1
    dend = torch.minimum(torch.minimum(first_dot, fw), lens)

    # each digit times 10^(its rank from the right), summed mod 2^64: exact
    # for the rows of at most 19 significant digits; more always overflow
    dig_run = (pos >= istart[:, None]) & (pos < dend[:, None])
    nzrun = dig_run & (C != 48)
    first_nz = torch.where(nzrun.any(1), first_idx(nzrun, 0), dend)
    nd_eff = dend - first_nz
    w = _table(POW10_U64, torch.int64, dev)[
        (dend[:, None] - 1 - pos).clamp(0, 19).to(torch.int64)]
    d = (C - 48).clamp(0, 9).to(torch.int64)
    dmask = dig_run & (pos >= first_nz[:, None])
    mag = torch.where(dmask, d * w, 0).sum(1)
    of = (nd_eff > 19) | torch.where(neg, ugt(mag, -tmin), ugt(mag, tmax))
    valid &= ~of
    out = _int_column(out_type, torch.where(neg, -mag, mag), valid)
    return out, valid_in & ~valid


def _check_int_type(out_type: DType) -> None:
    if out_type.kind not in INT_LIMITS:
        raise TypeError(f"not an integer type: {out_type!r}")


def string_to_integer(col: Column, out_type: DType, ansi_mode: bool = False,
                      strip: bool = True, pad_to: Optional[int] = None
                      ) -> Column:
    """Spark-exact string -> INT8/16/32/64 (cast_string.cu:158-244): invalid
    rows null, or CastError in ANSI mode."""
    _check_int_type(out_type)
    if _on_cpu(col):
        PLAIN_CALLS["to_integer"] += 1
        out, err = string_to_integer_plain(col, out_type, ansi_mode, strip,
                                           pad_to)
    else:
        out, err = cast_cuda.to_integer(col, out_type, ansi_mode, strip)
    return _finish(col, out, err, ansi_mode)


# ---- string -> float --------------------------------------------------------

MAX_HOLDING = (2**64 - 1 - 9) // 10     # cast_string_to_float.cu:396-404
P10_MIN, P10_MAX = -350, 350
# correctly rounded 10^k for k in [P10_MIN, P10_MAX]: 0 below 1e-323, inf
# above 1e308 (the JAX package's `_pow10` table)
POW10_F64 = [float(f"1e{i}") if -324 < i <= 308 else
             (0.0 if i <= -324 else float("inf"))
             for i in range(P10_MIN, P10_MAX + 1)]
# floor(log10(d)) + 1 for a float64 d holding an integer in [1, 2^64), as
# the JAX package's `jnp.log10` gives it on the CPU: 1 + the number of
# LOG10_STEPS at or below d. Step k is the least float64
# whose XLA log10 (log(d) * 0.43429448190325182) floors to k; it differs
# from 10^k where that product rounds across the integer (among integers:
# 10^15 + 3, 10^18 - 48). tests/test_torch_cast_string.py holds every step
# against jnp.log10 on the float64s around it.
LOG10_STEPS = [10.0, 100.0, 999.9999999999994, 10000.0, 99999.99999999994,
               999999.9999999987, 9999999.999999989, 100000000.0,
               999999999.9999976, 9999999999.999987, 99999999999.99998,
               999999999999.9973, 9999999999999.984, 99999999999999.78,
               1000000000000002.4, 1e16, 9.999999999999976e16,
               9.999999999999951e17, 9.999999999999998e18]
DBL_MIN = 2.2250738585072014e-308
FLT_MIN = 1.1754943508222875e-38


def num_digits(d: torch.Tensor) -> torch.Tensor:
    """floor(log10(d)) + 1 of float64s d >= 1, as the JAX package's."""
    steps = _table(LOG10_STEPS, torch.float64, d.device)
    return 1 + (d[:, None] >= steps[None, :]).sum(1).to(torch.int32)


def pow10(k: torch.Tensor) -> torch.Tensor:
    tbl = _table(POW10_F64, torch.float64, k.device)
    return tbl[(k - P10_MIN).clamp(0, P10_MAX - P10_MIN).to(torch.int64)]


def ftz_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b with a result below DBL_MIN flushed to a signed zero, the
    tininess judged after rounding (x86 under FTZ, as XLA runs on the
    CPU): the product is taken again 2^64 higher to see its rounding."""
    r = a * b
    high = (a * 18446744073709551616.0) * b
    tiny = high.abs() < DBL_MIN * 18446744073709551616.0
    return torch.where(tiny, torch.copysign(torch.zeros_like(r), r), r)


def to_float32_ftz(r: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 with a float32 result below FLT_MIN flushed to a
    signed zero, judged after rounding to 24 bits: |r| < FLT_MIN * (1 -
    2^-25) rounds below FLT_MIN. NaN is 0x7fc00000."""
    f = r.to(torch.float32)
    tiny = r.abs() < FLT_MIN * (1.0 - 2.0 ** -25)
    f = torch.where(tiny, torch.copysign(torch.zeros_like(f), f), f)
    # NaN as the CPU rounds it (0x7fc00000), whatever the device's cast
    nan = torch.tensor(0x7FC00000, dtype=torch.int32,
                       device=r.device).view(torch.float32)
    return torch.where(torch.isnan(r), nan, f)


def _ci_match(C, start, lens, word: bytes):
    m = torch.ones(C.shape[0], dtype=torch.bool, device=C.device)
    for k, ch in enumerate(word):
        c = char_at(C, start + k)
        m &= ((c == ch) | (c == ch - 32)) & (start + k < lens)
    return m


def string_to_float_plain(col: Column, out_type: DType,
                          ansi_mode: bool = False,
                          pad_to: Optional[int] = None
                          ) -> Tuple[Column, torch.Tensor]:
    """-> (the cast column, the ANSI error flags)."""
    C, lens = padded_chars(col, pad_to)
    n, L = C.shape
    dev = C.device
    pos = _pos(C)
    in_str = pos < lens[:, None]
    ws = ws4(C)
    digit = (C >= 48) & (C <= 57)
    dot = C == 46
    valid_in = col.null_mask
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)

    def skip_ws(start):
        m = ~ws & in_str & (pos >= start[:, None])
        return torch.where(m.any(1), first_idx(m, 0), lens)

    i0 = skip_ws(zeros)
    c0 = char_at(C, i0)
    has_sign = ((c0 == 43) | (c0 == 45)) & (i0 < lens)
    neg = (c0 == 45) & has_sign
    sign = torch.where(neg, -1.0, 1.0).to(torch.float64)
    p0 = i0 + has_sign.to(torch.int32)

    starts_nan = _ci_match(C, p0, lens, b"nan")
    nan_valid = starts_nan & (lens == 3)
    nan_except = starts_nan & (lens != 3)
    inf3 = _ci_match(C, p0, lens, b"inf") & ~starts_nan
    inf8 = inf3 & _ci_match(C, p0 + 3, lens, b"inity")
    inf_valid = (inf3 & (p0 + 3 == lens)) | (inf8 & (p0 + 8 == lens))

    reg = (pos >= p0[:, None]) & in_str
    nondig = reg & ~digit & ~dot
    term = torch.where(nondig.any(1), first_idx(nondig, 0), lens)
    mant = reg & (pos < term[:, None])
    dots_in_mant = (dot & mant).sum(1)
    multi_dot = dots_in_mant > 1
    dot_idx = first_idx(dot & mant, L)
    has_dot = dots_in_mant == 1
    stray_dot = (dot & in_str & (pos >= term[:, None])).any(1)

    predot_end = torch.minimum(dot_idx, term)
    nonzero_pre = mant & (pos < predot_end[:, None]) & (C != 48)
    first_nz = torch.where(nonzero_pre.any(1), first_idx(nonzero_pre, 0),
                           predot_end)
    z = first_nz - p0
    a1 = predot_end - first_nz
    a2 = torch.where(has_dot, term - dot_idx - 1, 0)
    total_digits = a1 + a2
    seen_digit = (z > 0) | (total_digits > 0)

    # the first min(total, 19) counted digits weighed by 10^(rank from the
    # 19th), then at most one guarded 20th (cast_string_to_float.cu:390-440)
    counted = (pos >= first_nz[:, None]) & (pos < term[:, None]) & digit
    ci = counted.to(torch.int32)
    r = ci.cumsum(1, dtype=torch.int32) - ci
    total_counted = ci.sum(1, dtype=torch.int32)
    k19 = total_counted.clamp(max=19)
    w19 = _table(POW10_U64, torch.int64, dev)[
        (k19[:, None] - 1 - r).clamp(0, 19).to(torch.int64)]
    d = (C - 48).clamp(0, 9).to(torch.int64)
    dval19 = torch.where(counted & (r < k19[:, None]), d * w19, 0).sum(1)
    d20 = torch.where(counted & (r == 19), d, 0).sum(1)
    ext = dval19 * 10 + d20
    extra_ok = ((total_counted >= 20) & ule(dval19, MAX_HOLDING)
                & ule(ext, MAX_HOLDING))
    dval = torch.where(extra_ok, ext, dval19)
    absorbed = k19 + extra_ok.to(torch.int32)
    truncated = total_digits - absorbed
    exp_base = truncated - torch.where(has_dot, total_digits - a1, 0)
    zero_mantissa = dval == 0

    ct = char_at(C, term)
    has_e = (term < lens) & ((ct == 101) | (ct == 69))
    ce = char_at(C, term + 1)
    e_sign_char = ((ce == 43) | (ce == 45)) & has_e & (term + 1 < lens)
    e_neg = (ce == 45) & e_sign_char
    estart = term + 1 + e_sign_char.to(torch.int32)
    nd = zeros.clone()
    eval_ = zeros.clone()
    for k in range(4):
        ck = char_at(C, estart + k)
        is_d = (ck >= 48) & (ck <= 57) & (estart + k < lens) & (nd == k)
        eval_ = torch.where(is_d, eval_ * 10 + (ck - 48), eval_)
        nd = nd + is_d.to(torch.int32)
    manual_exp = torch.where(e_neg, -eval_, eval_)
    exp_invalid = has_e & (nd == 0)
    after_exp = torch.where(has_e, estart + nd, term)

    cq = char_at(C, after_exp)
    has_suffix = (((cq == 102) | (cq == 70) | (cq == 100) | (cq == 68))
                  & (after_exp < lens))
    trailing_junk = skip_ws(after_exp + has_suffix.to(torch.int32)) < lens
    zero_junk = skip_ws(after_exp) < lens

    number_valid = (~multi_dot & ~stray_dot & seen_digit & ~exp_invalid
                    & torch.where(zero_mantissa, ~zero_junk, ~trailing_junk))
    valid = valid_in & torch.where(
        starts_nan, nan_valid, torch.where(inf3, inf_valid, number_valid))
    number_except = (multi_dot | stray_dot | ~seen_digit | exp_invalid
                     | torch.where(zero_mantissa, zero_junk, trailing_junk))
    except_flag = valid_in & torch.where(
        starts_nan, nan_except,
        torch.where(inf3, torch.zeros_like(valid), number_except))

    # the value in float64 (cast_string_to_float.cu:150-196)
    digitsf = sign * u64_to_f64(dval)
    exp_ten = exp_base + manual_exp
    shift = -307 - exp_ten
    nd10 = num_digits(u64_to_f64(torch.where(dval == 0, 1, dval)))
    sub = ftz_mul(digitsf / pow10(nd10 - 1 + shift),
                  pow10(exp_ten + nd10 - 1 + shift))
    expf = pow10(exp_ten.abs())
    normal = torch.where(exp_ten < 0, digitsf / expf, digitsf * expf)
    inf = sign * float("inf")
    result = torch.where(shift > 0, sub, normal)
    result = torch.where(exp_ten > 308, inf, result)
    result = torch.where(zero_mantissa, sign * 0.0, result)
    result = torch.where(inf3, inf, result)
    result = torch.where(starts_nan, float("nan"), result)
    result = torch.where(valid, result, 0.0)
    data = (to_float32_ftz(result) if out_type.kind == Kind.FLOAT32
            else result)
    out = Column(out_type, n, data, valid)
    return out, except_flag & ~valid


def _check_float_type(out_type: DType) -> None:
    if out_type.kind not in (Kind.FLOAT32, Kind.FLOAT64):
        raise TypeError(f"not a float type: {out_type!r}")


def string_to_float(col: Column, out_type: DType, ansi_mode: bool = False,
                    pad_to: Optional[int] = None) -> Column:
    """Spark-exact string -> FLOAT32/64 (cast_string_to_float.cu:56-653)."""
    _check_float_type(out_type)
    if _on_cpu(col):
        PLAIN_CALLS["to_float"] += 1
        out, err = string_to_float_plain(col, out_type, ansi_mode, pad_to)
    else:
        out, err = cast_cuda.to_float(col, out_type, ansi_mode)
    return _finish(col, out, err, ansi_mode)


# ---- base conversion (Spark `conv`), CastStringJni.cpp:159-258 --------------

def _check_base(base: int) -> None:
    if base not in (10, 16):
        raise CastError(0, f"Bases supported 10, 16; Actual: {base}")


def string_to_integer_with_base_plain(col: Column, out_type: DType,
                                      base: int = 10,
                                      pad_to: Optional[int] = None
                                      ) -> Column:
    C, lens = padded_chars(col, pad_to)
    n, L = C.shape
    dev = C.device
    pos = _pos(C)
    in_str = pos < lens[:, None]
    # the regex \s class: \f and \v count here
    ws = ws4(C) | (C == 12) | (C == 11)
    nonws = ~ws & in_str
    all_ws = ~nonws.any(1)
    i0 = torch.where(all_ws, lens, first_idx(nonws, 0))
    neg = (char_at(C, i0) == 45) & (i0 < lens)
    istart = i0 + neg.to(torch.int32)
    dec = (C >= 48) & (C <= 57)
    if base == 10:
        is_dig, dval = dec, C - 48
    else:
        lo, up = (C >= 97) & (C <= 102), (C >= 65) & (C <= 70)
        is_dig = dec | lo | up
        dval = torch.where(dec, C - 48, torch.where(lo, C - 87, C - 55))
    run = (pos >= istart[:, None]) & in_str
    non_dig = run & ~is_dig
    run_end = torch.where(non_dig.any(1), first_idx(non_dig, 0), lens)
    matched = run_end > istart
    # each digit times base^(its rank from the right) mod 2^64, summed
    # mod 2^64: the sequential val * base + d chain's bits
    btbl = _table([wrap64(pow(base, k, 2**64)) for k in range(max(L, 1))],
                  torch.int64, dev)
    wb = btbl[(run_end[:, None] - 1 - pos).clamp(0, L - 1).to(torch.int64)]
    brun = (pos >= istart[:, None]) & (pos < run_end[:, None])
    mag = torch.where(brun, dval.to(torch.int64) * wb, 0).sum(1)
    val = torch.where(matched, torch.where(neg, -mag, mag), 0)
    valid = col.null_mask & ~all_ws & (lens > 0)
    return _int_column(out_type, val, valid)


def string_to_integer_with_base(col: Column, out_type: DType,
                                base: int = 10, ansi_mode: bool = False,
                                pad_to: Optional[int] = None) -> Column:
    """toIntegersWithBase: the leading token of ^\\s*(-?[0-9a-fA-F]+).*;
    a row that does not match is 0 (not null), a whitespace-only row null,
    and the arithmetic wraps mod 2^64. `ansi_mode` raises nothing, as in
    the JAX package."""
    _check_base(base)
    if _on_cpu(col):
        PLAIN_CALLS["to_integer_base"] += 1
        return string_to_integer_with_base_plain(col, out_type, base, pad_to)
    return cast_cuda.to_integer_base(col, out_type, base)


def _u64_bits(col: Column) -> torch.Tensor:
    d = col.data
    if d.dtype == torch.uint64:
        return d.view(torch.int64)
    return d.to(torch.int64)


def integer_to_string_with_base_plain(col: Column, base: int = 10
                                      ) -> Column:
    """Base 10: the signed decimal (UINT64 unsigned); base 16: uppercase hex
    of the two's complement value, leading zeros stripped. A null row keeps
    its data's string (its validity off), as in the JAX package."""
    nbits = col.dtype.itemsize() * 8
    n = col.length
    dev = col.device
    u = _u64_bits(col)
    if base == 16:
        if nbits < 64:
            u = u & ((1 << nbits) - 1)
        ndig = nbits // 4
        shifts = torch.arange(ndig - 1, -1, -1, device=dev) * 4
        nib = ((u[:, None] >> shifts[None, :]) & 0xF).to(torch.int32)
        chars = torch.where(nib < 10, nib + 48, nib + 55)
        first = first_idx(nib != 0, ndig - 1).clamp(max=ndig - 1)
        idx = (first[:, None] + torch.arange(ndig, device=dev)[None, :]
               ).clamp(max=ndig - 1)
        out = chars.gather(1, idx.to(torch.int64))
        return strings_from_padded(out.to(torch.uint8), ndig - first,
                                   col.validity)
    if col.dtype.kind == Kind.UINT64:
        mag, neg = u, torch.zeros(n, dtype=torch.bool, device=dev)
    else:
        neg = u < 0
        mag = torch.where(neg, -u, u)     # -INT64_MIN keeps the 2^63 bits
    digs = []
    for _ in range(20):                   # unsigned divide by 10, LSB first
        q = ushr(mag, 1) // 5
        digs.append((mag - q * 10).to(torch.int32))
        mag = q
    dig = torch.stack(digs[::-1], 1)
    first = first_idx(dig != 0, 19).clamp(max=19)
    j = torch.arange(21, dtype=torch.int32, device=dev)[None, :]
    src = (first[:, None] + j - neg.to(torch.int32)[:, None]).clamp(0, 19)
    dchars = dig.gather(1, src.to(torch.int64)) + 48
    out = torch.where((j == 0) & neg[:, None], 45, dchars)
    return strings_from_padded(out.to(torch.uint8),
                               20 - first + neg.to(torch.int32),
                               col.validity)


def integer_to_string_with_base(col: Column, base: int = 10) -> Column:
    """fromIntegersWithBase (CastStringJni.cpp:218-258)."""
    _check_base(base)
    if col.dtype.kind not in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
                              Kind.UINT8, Kind.UINT64):
        raise TypeError(f"expected an integer column, got {col.dtype!r}")
    if _on_cpu(col):
        PLAIN_CALLS["from_integer_base"] += 1
        return integer_to_string_with_base_plain(col, base)
    return cast_cuda.from_integer_base(col, base)
