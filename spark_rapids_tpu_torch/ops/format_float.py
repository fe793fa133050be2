"""format_number(x, d): Spark's "#,###,###.##" float formatting.

Counterpart of `spark_rapids_tpu/ops/format_float.py` (the reference's
format_float.cu, format_float_fn :35, over ftos_converter.cuh :1174-1440):
Ryu's shortest digits rounded half-even to `d` fraction digits, commas
between thousands, NaN as U+FFFD, +-Infinity as U+221E, zero as "0.00..0".
A value near 1e308 writes 309 integer digits and 102 commas.

`format_float` runs csrc/number_to_string.cu (`cast_cuda.format_float`: a
length pass, the offsets, a write pass, one thread a row) on a CUDA
column, or raises; on a CPU column the plain version: the JAX package's
measure pass, then its fill of a char plane as wide as the longest row
(one host read), position by position. A null row's string is empty.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..dtypes import Kind
from . import cast_cuda
from .cast_float_to_string import decimal_length, ryu
from .cast_string import PLAIN_CALLS, POW10_U64, strings_from_padded

__all__ = ["format_float", "format_float_plain", "MAX_DIGITS"]

MAX_DIGITS = 30


def _p10(k: torch.Tensor) -> torch.Tensor:
    tbl = torch.tensor(POW10_U64, dtype=torch.int64, device=k.device)
    return tbl[k.clamp(0, 18).to(torch.int64)]


def _round_half_even(v, olength, keep):
    """Keep `keep` leading digits of v (olength digits), half-even
    (ftos_converter.cuh round_half_even :1195). v < 10^17."""
    div = _p10(olength - keep)
    mod = v % div
    num = v // div
    up = (mod * 2 > div) | ((mod * 2 == div) & (num % 2 == 1) & (mod != 0))
    return num + up.to(torch.int64)


def _digit_at(v, k):
    """Digit k (from the right) of v < 10^18; 0 beyond."""
    d = v // _p10(k) % 10
    return torch.where((k < 0) | (k > 18), 0, d)


def format_plan(d: int, D, exp, olength, sign, is_nan, is_inf, is_zero):
    """Per row the integer part's source (V shifted S digits, IL digits),
    the fraction's (leading zeros, F over F_width digits, a carry into
    the zeros) and the length, as the JAX package's `_format_plan`."""
    special = is_nan | is_inf | is_zero
    br_a = ~special & (exp < 0)
    br_b = ~special & (exp >= 0) & (exp + 1 >= olength)
    br_c = ~special & (exp >= 0) & (exp + 1 < olength)

    # value < 1
    neg_exp = (-exp - 1).clamp(min=0)
    z = neg_exp.clamp(max=d)
    proceed = d >= neg_exp
    actual_round = (d - neg_exp).clamp(min=0)
    actual_olength = torch.minimum(olength, actual_round)
    rounded_a = _round_half_even(D, olength, actual_round)
    carry_a = proceed & (rounded_a >= _p10(actual_olength))
    rounded_a = torch.where(carry_a, rounded_a - _p10(actual_olength),
                            rounded_a)
    rounded_a = torch.where(proceed, rounded_a, 0)
    a_width = torch.where(proceed, actual_olength, 0)

    # the point inside the digits
    temp_d = torch.where(exp + d + 1 > olength, olength - exp - 1,
                         torch.full_like(exp, d))
    rounded_c = _round_half_even(D, olength, exp + temp_d + 1)
    pw = _p10(temp_d)
    integer_c = rounded_c // pw
    decimal_c = rounded_c % pw
    int_len_c = decimal_length(integer_c)

    one = torch.ones_like(D)
    V = torch.where(br_b, D, torch.where(
        br_c, integer_c, torch.where(carry_a & (z == 0), one, 0)))
    S = torch.where(br_b, exp + 1 - olength, 0)
    IL = torch.where(br_b, exp + 1, torch.where(br_c, int_len_c, 1))
    IL_chars = IL + (IL - 1) // 3
    frac_lead = torch.where(br_a, z, 0)
    F = torch.where(br_a, rounded_a, torch.where(br_c, decimal_c, 0))
    F_width = torch.where(br_a, a_width, torch.where(br_c, temp_d, 0))
    carry_in_lead = br_a & carry_a & (z > 0)
    s = sign.to(torch.int32)
    length = s + IL_chars + (1 + d if d > 0 else 0)
    length = torch.where(is_zero, s + (2 + d if d > 0 else 1), length)
    length = torch.where(is_inf, s + 3, length)
    length = torch.where(is_nan, 3, length)
    return dict(V=V, S=S, IL_chars=IL_chars, F=F, F_width=F_width,
                frac_lead=frac_lead, carry_in_lead=carry_in_lead, s=s,
                length=length, is_nan=is_nan, is_inf=is_inf,
                is_zero=is_zero, sign=sign, special=special)


def _fill(plan, d: int, width: int):
    """The (n, width) char plane, position by position (`_fill`)."""
    n = plan["s"].shape[0]
    dev = plan["s"].device
    pos = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    col = (lambda k: plan[k][:, None])
    s, IL_chars, special = col("s"), col("IL_chars"), col("special")
    out = torch.full((n, width), ord(" "), dtype=torch.int64, device=dev)
    in_int = (pos >= s) & (pos < s + IL_chars) & ~special
    r = IL_chars - 1 - (pos - s)
    digit_idx = r - (r + 1) // 4
    int_digit = _digit_at(col("V"), digit_idx - col("S")) + ord("0")
    out = torch.where(in_int, torch.where(r % 4 == 3, ord(","), int_digit),
                      out)
    if d > 0:
        point = s + IL_chars
        out = torch.where((pos == point) & ~special, ord("."), out)
        f = pos - point - 1
        in_frac = (f >= 0) & (f < d) & ~special
        lead, Fw = col("frac_lead"), col("F_width")
        frac_digit = torch.where(
            f < lead,
            (col("carry_in_lead") & (f == lead - 1)).to(torch.int64),
            torch.where(f < lead + Fw,
                        _digit_at(col("F"), lead + Fw - 1 - f), 0))
        out = torch.where(in_frac, frac_digit + ord("0"), out)
    neg = col("sign") & ~col("is_nan")
    out = torch.where((pos == 0) & neg, ord("-"), out)
    zr = col("is_zero")
    out = torch.where(zr & (pos == s), ord("0"), out)
    if d > 0:
        out = torch.where(zr & (pos == s + 1), ord("."), out)
        out = torch.where(zr & (pos >= s + 2) & (pos < s + 2 + d), ord("0"),
                          out)
    for i, b in enumerate(b"\xef\xbf\xbd"):
        out = torch.where(col("is_nan") & (pos == i), b, out)
    for i, b in enumerate(b"\xe2\x88\x9e"):
        out = torch.where(col("is_inf") & (pos == s + i), b, out)
    return out.to(torch.uint8)


def _check(col: Column, digits: int) -> None:
    if not 0 <= digits <= MAX_DIGITS:
        raise ValueError(f"digits must be in [0, {MAX_DIGITS}]")
    if col.dtype.kind not in (Kind.FLOAT32, Kind.FLOAT64):
        raise TypeError(f"format_float expects a float column, got "
                        f"{col.dtype!r}")


def format_float_plain(col: Column, digits: int) -> Column:
    _check(col, digits)
    plan = format_plan(digits, *ryu(col.data))
    length = torch.where(col.null_mask, plan["length"], 0)
    width = max(1, int(length.max())) if col.length else 1
    return strings_from_padded(_fill(plan, digits, width), length,
                               col.validity)


def format_float(col: Column, digits: int) -> Column:
    """FLOAT32/FLOAT64 -> STRING with Spark's format_number
    (spark_rapids_jni::format_float, format_float.cu:119)."""
    _check(col, digits)
    if col.device.type == "cpu":
        PLAIN_CALLS["format_float"] += 1
        return format_float_plain(col, digits)
    return cast_cuda.format_float(col, digits)
