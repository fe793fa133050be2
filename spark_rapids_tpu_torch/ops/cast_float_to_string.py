"""FLOAT32/FLOAT64 -> STRING with Java's Float.toString / Double.toString.

Counterpart of `spark_rapids_tpu/ops/cast_float_to_string.py` (the
reference's cast_float_to_string.cu and ftos_converter.cuh: Ryu's shortest
round-trip digits, d2d :480 and f2d :659, and Java's layout, to_chars
:796): plain notation for 1e-3 <= |x| < 1e7, else "d.dddE<exp>"; "NaN",
"Infinity", "-Infinity", "0.0", "-0.0".

`float_to_string` runs csrc/number_to_string.cu (`cast_cuda.from_float`:
a length pass, the offsets, a write pass, one thread a row) on a CUDA
column, or raises; on a CPU column the plain version: the JAX package's
lane-parallel Ryu and its (n, 40) char plane in PyTorch. Torch has no
uint64 math on the CPU, so the plain version holds 64-bit values in int64
(the same bits; `cast_string.ugt`, `ushr`) and takes Ryu's 64 x 128-bit
products in 16-bit limbs, whose partial sums stay far inside int64. The
Ryu tables are made here with Python integers, as the JAX module makes
them.

A null row's string is empty.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..columnar import Column
from ..dtypes import Kind
from . import cast_cuda
from .cast_string import (PLAIN_CALLS, POW10_U64, strings_from_padded, ugt,
                          ushr, wrap64)

__all__ = ["float_to_string", "float_to_string_plain", "ryu",
           "float_bits"]


def pow5bits(e: int) -> int:
    return ((e * 1217359) >> 19) + 1


def log10_pow2(e: int) -> int:
    return (e * 78913) >> 18


def log10_pow5(e: int) -> int:
    return (e * 732923) >> 20


F_INV_BITS, F_POW_BITS = 59, 61      # FLOAT_POW5_INV_BITCOUNT, _BITCOUNT
D_INV_BITS, D_POW_BITS = 125, 125    # DOUBLE_POW5_INV_BITCOUNT, _BITCOUNT


def _pow5_table(count: int, bits: int):
    out = []
    for i in range(count):
        b = pow5bits(i)
        out.append(5**i << (bits - b) if b <= bits else 5**i >> (b - bits))
    return out


def _inv_table(count: int, bits: int):
    return [(1 << (bits + pow5bits(q) - 1)) // 5**q + 1
            for q in range(count)]


# Ryu's tables as Python integers: f32 factors below 2^64, f64 below 2^125
F_INV = _inv_table(32, F_INV_BITS)
F_POW5 = _pow5_table(49, F_POW_BITS)
D_INV = _inv_table(293, D_INV_BITS)
D_POW5 = _pow5_table(327, D_POW_BITS)
POW5 = [5**k for k in range(23)]

_TABLES: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _t(name: str, device) -> torch.Tensor:
    """A table as a tensor on `device`, made once."""
    key = (name, torch.device(device))
    if key not in _TABLES:
        if name in ("d_inv", "d_pow5"):
            src = D_INV if name == "d_inv" else D_POW5
            val = [[(v >> (16 * k)) & 0xFFFF for k in range(8)] for v in src]
        else:
            val = {"f_inv": [wrap64(v) for v in F_INV],
                   "f_pow5": [wrap64(v) for v in F_POW5],
                   "pow5": POW5, "pow10": POW10_U64,
                   "pow5bits": [pow5bits(i) for i in range(400)],
                   "l10p2": [log10_pow2(e) for e in range(1000)],
                   "l10p5": [log10_pow5(e) for e in range(1100)]}[name]
        _TABLES[key] = torch.tensor(val, dtype=torch.int64, device=device)
    return _TABLES[key]


def _i(x, lo: int, hi: int) -> torch.Tensor:
    return x.clamp(lo, hi).to(torch.int64)


def udiv10(x: torch.Tensor) -> torch.Tensor:
    """Unsigned x // 10 of int64-held 64-bit values."""
    return ushr(x, 1) // 5


def umod10(x: torch.Tensor) -> torch.Tensor:
    return x - udiv10(x) * 10


def mulshift32(m, factor, j):
    """(m * factor) >> j for m < 2^27, factor < 2^64 (int64 bits):
    (m * factor_hi + (m * factor_lo >> 32)) >> (j - 32), 0 where j - 32
    is out of [0, 64) (as XLA shifts)."""
    plo = m * (factor & 0xFFFFFFFF)
    phi = m * ushr(factor, 32)
    sh = j - 32
    out = (phi + (plo >> 32)) >> sh.clamp(0, 63)
    return torch.where((sh < 0) | (sh > 63), 0, out)


def mulshift128(m, flimbs, j):
    """floor(m * factor / 2^j) mod 2^64 for m < 2^56 and a factor below
    2^128 given as (n, 8) 16-bit limbs: a schoolbook product of 16-bit
    limbs (each column below 2^35), carried, then the 64 bits at j."""
    ml = [(m >> (16 * a)) & 0xFFFF for a in range(4)]
    cols = [torch.zeros_like(m) for _ in range(12)]
    for a in range(4):
        for b in range(8):
            cols[a + b] = cols[a + b] + ml[a] * flimbs[:, b]
    limbs, carry = [], torch.zeros_like(m)
    for k in range(12):
        s = cols[k] + carry
        limbs.append(s & 0xFFFF)
        carry = s >> 16
    P = torch.stack(limbs + [torch.zeros_like(m)] * 4, 1)      # (n, 16)
    s_idx = (j >> 4).to(torch.int64)
    off = j & 15
    g = P.gather(1, (s_idx[:, None] + torch.arange(5, device=m.device)
                     ).clamp(max=15))
    out = g[:, 0] >> off
    for t in range(1, 4):
        out = out | (g[:, t] << (16 * t - off))
    return out | torch.where(off == 0, 0, g[:, 4] << (64 - off))


def _removal(vr, vp, vm, vr_tz, vm_tz, last_removed, accept, max_iter):
    """Ryu's digit removal, both loops as one, unrolled to `max_iter` with
    lane masks, as the JAX package runs it."""
    removed = torch.zeros_like(vr, dtype=torch.int32)
    for _ in range(max_iter):
        c1 = udiv10(vp) > udiv10(vm)
        vm0 = umod10(vm) == 0
        c2 = ~c1 & vm_tz & vm0
        active = c1 | c2
        vm_tz = torch.where(c1, vm_tz & vm0, vm_tz)
        vr_tz = torch.where(active, vr_tz & (last_removed == 0), vr_tz)
        last_removed = torch.where(active, umod10(vr).to(torch.int32),
                                   last_removed)
        vr = torch.where(active, udiv10(vr), vr)
        vp = torch.where(active, udiv10(vp), vp)
        vm = torch.where(active, udiv10(vm), vm)
        removed = removed + active.to(torch.int32)
    last_removed = torch.where(vr_tz & (last_removed == 5) & (vr % 2 == 0),
                               4, last_removed)
    round_up = ((vr == vm) & (~accept | ~vm_tz)) | (last_removed >= 5)
    return vr + round_up.to(torch.int64), removed


def decimal_length(v: torch.Tensor) -> torch.Tensor:
    """Decimal digits of v (< 10^19, int64 bits)."""
    n = torch.ones_like(v, dtype=torch.int32)
    for k in range(1, 20):
        n = n + (~ugt(torch.full_like(v, POW10_U64[k]), v)).to(torch.int32)
    return n


def _ryu32(bits):
    dev = bits.device
    mantissa = bits & ((1 << 23) - 1)
    exponent = ((bits >> 23) & 0xFF).to(torch.int32)
    sign = ((bits >> 31) & 1) != 0
    is_nan = (exponent == 0xFF) & (mantissa != 0)
    is_inf = (exponent == 0xFF) & (mantissa == 0)
    is_zero = (exponent == 0) & (mantissa == 0)
    e2 = torch.where(exponent == 0, 1, exponent) - (127 + 23 + 2)
    m2 = torch.where(exponent == 0, mantissa, mantissa | (1 << 23))
    accept = (m2 & 1) == 0
    mv = 4 * m2
    mm_shift = ((mantissa != 0) | (exponent <= 1)).to(torch.int64)
    mp = mv + 2
    mm = mv - 1 - mm_shift
    inv, p5tab, p5 = _t("f_inv", dev), _t("f_pow5", dev), _t("pow5", dev)
    pb = _t("pow5bits", dev)
    pos = e2 >= 0

    # e2 >= 0
    e2p = e2.clamp(min=0)
    qp = _t("l10p2", dev)[_i(e2p, 0, 127)].to(torch.int32)
    kp = F_INV_BITS + pb[_i(qp, 0, 31)] - 1
    jp = -e2p + qp + kp
    fp = inv[_i(qp, 0, 31)]
    vr_p, vp_p, vm_p = (mulshift32(x, fp, jp) for x in (mv, mp, mm))
    lr_cond_p = (qp != 0) & (udiv10(vp_p - 1) <= udiv10(vm_p))
    qm1 = _i(qp - 1, 0, 31)
    lp = F_INV_BITS + pb[qm1] - 1
    lr_p = umod10(mulshift32(mv, inv[qm1], -e2p + qp - 1 + lp))
    lr_p = torch.where(lr_cond_p, lr_p, 0).to(torch.int32)
    q_le9 = qp <= 9
    mv5 = mv % 5 == 0
    p5q = p5[_i(qp, 0, 22)]
    vr_tz_p = q_le9 & mv5 & (mv % p5q == 0)
    vm_tz_p = q_le9 & ~mv5 & accept & (mm % p5q == 0)
    vp_p = vp_p - (q_le9 & ~mv5 & ~accept & (mp % p5q == 0)).to(torch.int64)

    # e2 < 0
    ne2 = (-e2).clamp(min=1)
    qn = _t("l10p5", dev)[_i(ne2, 0, 159)].to(torch.int32)
    i_n = ne2 - qn
    kn = pb[_i(i_n, 0, 48)] - F_POW_BITS
    jn = qn - kn
    fn = p5tab[_i(i_n, 0, 48)]
    vr_n, vp_n, vm_n = (mulshift32(x, fn, jn) for x in (mv, mp, mm))
    lr_cond_n = (qn != 0) & (udiv10(vp_n - 1) <= udiv10(vm_n))
    i1 = _i(i_n + 1, 0, 48)
    jn2 = qn - 1 - (pb[i1] - F_POW_BITS)
    lr_n = umod10(mulshift32(mv, p5tab[i1], jn2.clamp(min=33)))
    lr_n = torch.where(lr_cond_n, lr_n, 0).to(torch.int32)
    q_le1 = qn <= 1
    qc = _i(qn - 1, 0, 63)
    low = (torch.ones_like(mv) << qc) - 1
    vr_tz_n = torch.where(q_le1, True, (qn < 31) & ((mv & low) == 0))
    vm_tz_n = q_le1 & accept & (mm_shift == 1)
    vp_n = vp_n - (q_le1 & ~accept).to(torch.int64)

    e10 = torch.where(pos, qp, qn + e2)
    sel = (lambda a, b: torch.where(pos, a, b))
    digits, removed = _removal(sel(vr_p, vr_n), sel(vp_p, vp_n),
                               sel(vm_p, vm_n), sel(vr_tz_p, vr_tz_n),
                               sel(vm_tz_p, vm_tz_n), sel(lr_p, lr_n),
                               accept, max_iter=11)
    olength = decimal_length(digits)
    return (digits, e10 + removed + olength - 1, olength, sign, is_nan,
            is_inf, is_zero, removed)


def _ryu64(bits):
    dev = bits.device
    mantissa = bits & ((1 << 52) - 1)
    exponent = ((bits >> 52) & 0x7FF).to(torch.int32)
    sign = bits < 0
    is_nan = (exponent == 0x7FF) & (mantissa != 0)
    is_inf = (exponent == 0x7FF) & (mantissa == 0)
    is_zero = (exponent == 0) & (mantissa == 0)
    e2 = torch.where(exponent == 0, 1, exponent) - (1023 + 52 + 2)
    m2 = torch.where(exponent == 0, mantissa, mantissa | (1 << 52))
    accept = (m2 & 1) == 0
    mv = 4 * m2
    mm_shift = ((mantissa != 0) | (exponent <= 1)).to(torch.int64)
    mp = mv + 2
    mm = mv - 1 - mm_shift
    inv, p5tab, p5 = _t("d_inv", dev), _t("d_pow5", dev), _t("pow5", dev)
    pb = _t("pow5bits", dev)
    pos = e2 >= 0

    e2p = e2.clamp(min=0)
    qp = (_t("l10p2", dev)[_i(e2p, 0, 999)] - (e2p > 3).to(torch.int64)
          ).clamp(min=0).to(torch.int32)
    kp = D_INV_BITS + pb[_i(qp, 0, 292)] - 1
    jp = -e2p + qp + kp
    fp = inv[_i(qp, 0, 292)]
    vr_p, vp_p, vm_p = (mulshift128(x, fp, jp) for x in (mv, mp, mm))
    q_le21 = qp <= 21
    mv5 = mv % 5 == 0
    p5q = p5[_i(qp, 0, 22)]
    vr_tz_p = q_le21 & mv5 & (mv % p5q == 0)
    vm_tz_p = q_le21 & ~mv5 & accept & (mm % p5q == 0)
    vp_p = vp_p - (q_le21 & ~mv5 & ~accept & (mp % p5q == 0)
                   ).to(torch.int64)

    ne2 = (-e2).clamp(min=1)
    qn = (_t("l10p5", dev)[_i(ne2, 0, 1099)] - (ne2 > 1).to(torch.int64)
          ).clamp(min=0).to(torch.int32)
    i_n = ne2 - qn
    kn = pb[_i(i_n, 0, 326)] - D_POW_BITS
    jn = qn - kn
    fn = p5tab[_i(i_n, 0, 326)]
    vr_n, vp_n, vm_n = (mulshift128(x, fn, jn) for x in (mv, mp, mm))
    q_le1 = qn <= 1
    low = (torch.ones_like(mv) << _i(qn, 0, 63)) - 1
    vr_tz_n = torch.where(q_le1, True, (qn < 63) & ((mv & low) == 0))
    vm_tz_n = q_le1 & accept & (mm_shift == 1)
    vp_n = vp_n - (q_le1 & ~accept).to(torch.int64)

    e10 = torch.where(pos, qp, qn + e2)
    sel = (lambda a, b: torch.where(pos, a, b))
    digits, removed = _removal(sel(vr_p, vr_n), sel(vp_p, vp_n),
                               sel(vm_p, vm_n), sel(vr_tz_p, vr_tz_n),
                               sel(vm_tz_p, vm_tz_n),
                               torch.zeros_like(e2), accept, max_iter=20)
    olength = decimal_length(digits)
    return (digits, e10 + removed + olength - 1, olength, sign, is_nan,
            is_inf, is_zero, removed)


def float_bits(data: torch.Tensor) -> torch.Tensor:
    """A float column's bit patterns as int64 (float32's zero-extended)."""
    if data.dtype == torch.float32:
        return data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return data.view(torch.int64)


def ryu(data: torch.Tensor):
    """Ryu's shortest digits of float32 or float64 values -> (digits
    (int64), exp10, olength, sign, is_nan, is_inf, is_zero)."""
    return ryu_removed(data)[:7]


def ryu_removed(data: torch.Tensor):
    """`ryu` and, last, the digit-removal turns each row took (int32)."""
    bits = float_bits(data)
    return _ryu32(bits) if data.dtype == torch.float32 else _ryu64(bits)


PAD = 40      # the JAX package's char plane width; the longest is 24


def format_java(digits, exp10, olength, sign, is_nan, is_inf, is_zero):
    """Java's layout into an (n, PAD) uint8 plane and lengths, char for
    char as the JAX package scatters it."""
    n = digits.shape[0]
    dev = digits.device
    digits = torch.where(is_zero, 0, digits)
    olength = torch.where(is_zero, 1, olength)
    exp10 = torch.where(is_zero, 0, exp10)
    special = is_nan | is_inf
    plain = (exp10 >= -3) & (exp10 <= 6) & ~special
    sci = ~plain & ~special
    s = (sign & ~is_nan).to(torch.int32)
    idx_list, val_list = [], []

    def emit(p, ch, mask):
        idx_list.append(torch.where(mask, p, PAD).to(torch.int64))
        val_list.append(torch.full((n,), ch, dtype=torch.int64, device=dev)
                        if isinstance(ch, int) else ch.to(torch.int64))

    emit(torch.zeros_like(s), ord("-"), sign & ~is_nan)
    p10 = _t("pow10", dev)
    ip = exp10 + 1
    zneg = -exp10 - 1
    m = olength.clamp(min=2)
    for k in range(17):
        have = k < olength
        # digits < 10^17: digit k is below 10^16, a positive divisor
        d = digits // p10[_i(olength - 1 - k, 0, 18)] % 10 + ord("0")
        emit(s + torch.where(k < ip, k, k + 1), d, plain & (exp10 >= 0)
             & have)
        emit(s + 2 + zneg + k, d, plain & (exp10 < 0) & have)
        emit(s if k == 0 else s + 1 + k, d, sci & have)
    pge = plain & (exp10 >= 0)
    for t in range(7):
        emit(s + olength + t, ord("0"), pge & (olength + t < ip))
    emit(s + ip, ord("."), pge)
    emit(s + ip + 1, ord("0"), pge & (olength <= ip))
    plt = plain & (exp10 < 0)
    emit(s, ord("0"), plt)
    emit(s + 1, ord("."), plt)
    for t in range(2):
        emit(s + 2 + t, ord("0"), plt & (t < zneg))
    emit(s + 1, ord("."), sci)
    emit(s + 2, ord("0"), sci & (olength == 1))
    emit(s + m + 1, ord("E"), sci)
    eneg = exp10 < 0
    eabs = exp10.abs()
    emit(s + m + 2, ord("-"), sci & eneg)
    es = s + m + 2 + eneg.to(torch.int32)
    ne_dig = (1 + (eabs >= 10).to(torch.int32)
              + (eabs >= 100).to(torch.int32))
    emit(es, eabs // 100 % 10 + ord("0"), sci & (ne_dig == 3))
    emit(es + (ne_dig == 3).to(torch.int32), eabs // 10 % 10 + ord("0"),
         sci & (ne_dig >= 2))
    emit(es + ne_dig - 1, eabs % 10 + ord("0"), sci)
    for text, mask in (("NaN", is_nan), ("Infinity", is_inf)):
        base = torch.where(mask & sign & ~is_nan, 1, 0)
        for t, ch in enumerate(text):
            emit(base + t, ord(ch), mask)
    mat = torch.zeros((n, PAD + 1), dtype=torch.int64, device=dev)
    mat.scatter_(1, torch.stack(idx_list, 1), torch.stack(val_list, 1))
    frac = torch.where(olength > ip, olength - ip, 1)
    len_pge = s + ip + 1 + frac
    len_plt = s + 2 + zneg + olength
    len_sci = s + m + 2 + eneg.to(torch.int32) + ne_dig
    length = torch.where(pge, len_pge, torch.where(plt, len_plt, len_sci))
    length = torch.where(is_nan, 3, length)
    length = torch.where(is_inf, 8 + sign.to(torch.int32), length)
    return mat[:, :PAD].to(torch.uint8), length


def _check(col: Column) -> None:
    if col.dtype.kind not in (Kind.FLOAT32, Kind.FLOAT64):
        raise TypeError(f"expected a float column, got {col.dtype!r}")


def float_to_string_plain(col: Column) -> Column:
    _check(col)
    mat, length = format_java(*ryu(col.data))
    length = torch.where(col.null_mask, length, 0)
    return strings_from_padded(mat, length, col.validity)


def float_to_string(col: Column) -> Column:
    """FLOAT32/FLOAT64 -> Java toString text
    (spark_rapids_jni::float_to_string, cast_float_to_string.cu:119)."""
    _check(col)
    if col.device.type == "cpu":
        PLAIN_CALLS["from_float"] += 1
        return float_to_string_plain(col)
    return cast_cuda.from_float(col)
