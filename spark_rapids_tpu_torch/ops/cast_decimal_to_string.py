"""DECIMAL32/64/128 -> STRING with Spark's non-ANSI formatting.

Counterpart of `spark_rapids_tpu/ops/cast_decimal_to_string.py` (the
reference's cast_decimal_to_string.cu:53-175): Java's
`BigDecimal.toString()`, plain `[-]integer.fraction` where the scale is at
least 0 and the adjusted exponent at least -6, else scientific
`[-]d.dddE+-x`.

`decimal_to_non_ansi_string` runs csrc/number_to_string.cu
(`cast_cuda.from_decimal`: a length pass, the offsets, a write pass, one
thread a row) on a CUDA column, or raises; on a CPU column the plain
version: every row's digits by long division by 10 (DECIMAL128 over
16-bit limbs, in int64), then the JAX package's positional layout over an
(n, width) char plane. A null row's string is empty.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..dtypes import Kind
from . import cast_cuda
from .cast_string import PLAIN_CALLS, strings_from_padded

__all__ = ["decimal_to_non_ansi_string", "decimal_to_non_ansi_string_plain"]

NDIGITS = {Kind.DECIMAL32: 10, Kind.DECIMAL64: 19, Kind.DECIMAL128: 39}


def _digits(col: Column, ndigits: int):
    """-> (negative, (n, ndigits) int64 digits of |v|, most significant
    first)."""
    if col.dtype.kind == Kind.DECIMAL128:
        w = col.data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        neg = (w[:, 3] >> 31) != 0
        # |v| as eight 16-bit limbs: two's complement negation, ~x + 1
        limbs = [(w[:, i // 2] >> (16 * (i % 2))) & 0xFFFF for i in range(8)]
        inv, carry = [], torch.ones_like(limbs[0])
        for x in limbs:
            t = (x ^ 0xFFFF) + carry
            inv.append(t & 0xFFFF)
            carry = t >> 16
        cur = [torch.where(neg, a, b) for a, b in zip(inv, limbs)]
        digs = []
        for _ in range(ndigits):
            r = torch.zeros_like(cur[0])
            for i in range(7, -1, -1):       # long division, high to low
                acc = (r << 16) | cur[i]
                cur[i] = acc // 10
                r = acc % 10
            digs.append(r)
    else:
        v = col.data.to(torch.int64)
        neg = v < 0
        # |INT64_MIN| as its digits: the last digit first, then the rest
        r0 = torch.where(neg, -(v % -10), v % 10)
        mag = torch.where(neg, v // -10, v // 10)
        digs = [r0]
        for _ in range(ndigits - 1):
            digs.append(mag % 10)
            mag = mag // 10
    return neg, torch.stack(digs[::-1], 1)


def decimal_to_non_ansi_string_plain(col: Column) -> Column:
    if not col.dtype.is_decimal:
        raise TypeError("Values for decimal_to_non_ansi_string function "
                        "must be a decimal type.")
    s = int(col.dtype.scale or 0)
    D = NDIGITS[col.dtype.kind]
    neg, dig = _digits(col, D)
    dev = dig.device
    nz = dig != 0
    ndig = torch.where(nz.any(1), D - nz.to(torch.uint8).argmax(1), 1)
    adjusted = ndig - 1 - s
    plain = (s >= 0) & (adjusted >= -6)
    negi = neg.to(torch.int64)

    int_len = (ndig - s).clamp(min=1)
    has_pt = 1 if s > 0 else 0
    p_len = negi + int_len + has_pt + max(s, 0)
    exp_abs = adjusted.abs()
    exp_ndig = 1 + (exp_abs >= 10).to(torch.int64) + (exp_abs >= 100).to(
        torch.int64)
    multi = ndig > 1
    s_len = negi + 1 + torch.where(multi, ndig, 0) + 2 + exp_ndig
    length = torch.where(plain, p_len, s_len)
    length = torch.where(col.null_mask, length, 0)
    W = 1 + max(D, s + 1) + 1 + max(s, 0) + 6
    j = torch.arange(W, device=dev)[None, :]

    def dig_at(idx):
        return dig.gather(1, idx.clamp(0, D - 1)) + ord("0")

    ng, nd, il = negi[:, None], ndig[:, None], int_len[:, None]
    b1 = ng + il
    b2 = b1 + has_pt
    p_char = torch.where(
        j < ng, ord("-"),
        torch.where(j < b1, dig_at(D - s - il + (j - ng)),
                    torch.where((j < b2) & (has_pt > 0), ord("."),
                                dig_at(D - s + (j - b2)))))
    ed = torch.stack([exp_abs // 100 % 10, exp_abs // 10 % 10, exp_abs % 10],
                     1)
    c1 = ng + 1
    c2 = c1 + multi.to(torch.int64)[:, None]
    c3 = c2 + torch.where(multi[:, None], nd - 1, 0)
    c4 = c3 + 1
    c5 = c4 + 1
    exp_at = ed.gather(1, (3 - exp_ndig[:, None] + (j - c5)).clamp(0, 2)) \
        + ord("0")
    s_char = torch.where(
        j < ng, ord("-"),
        torch.where(j < c1, dig_at(D - nd + (j - ng)),
                    torch.where(j < c2, ord("."),
                                torch.where(j < c3,
                                            dig_at(D - nd + 1 + (j - c2)),
                                            torch.where(j < c4, ord("E"),
                                                        torch.where(
                                            j < c5, torch.where(
                                                adjusted[:, None] >= 0,
                                                ord("+"), ord("-")),
                                            exp_at))))))
    chars = torch.where(plain[:, None], p_char, s_char)
    return strings_from_padded(chars.to(torch.uint8), length, col.validity)


def decimal_to_non_ansi_string(col: Column) -> Column:
    """Spark non-ANSI decimal formatting (cast_decimal_to_string.cu:210)."""
    if not col.dtype.is_decimal:
        raise TypeError("Values for decimal_to_non_ansi_string function "
                        "must be a decimal type.")
    if col.device.type == "cpu":
        PLAIN_CALLS["from_decimal"] += 1
        return decimal_to_non_ansi_string_plain(col)
    return cast_cuda.from_decimal(col)
