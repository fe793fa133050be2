"""Spark-exact string -> DECIMAL32/64/128 cast.

Counterpart of `spark_rapids_tpu/ops/cast_decimal.py` (the reference's
validate_and_exponent cast_string.cu:247-374 and string_to_decimal_kernel
cast_string.cu:376-599), with its grammar and quirks:

- ws* sign? digits* ('.' digits*)? ([eE] sign? digits*)? ws*, no digit
  required ('.' and '+e5' parse to 0), trailing whitespace from the
  mantissa or right after the 'e' only ('1e5 ' is invalid), empty
  exponents fine ('1e', '1e+');
- digits accumulate up to `precision` significant ones or the scale's last
  digit, then round HALF_UP on the next digit, the carry that makes a
  power of ten growing the digit count (cast_string.cu:468-506);
- zero padding up to the point and out to the scale, each step checked
  against the storage type's limits; the significant digits before the
  point must fit precision - scale (cast_string.cu:547-553);
- the exponent accumulates in int64 (|e| > 2^63 invalid) and is clamped
  to +-2^40 before the point's arithmetic; '0e<big>' is null;
- ANSI mode raises `CastError` with the first failing row.

`string_to_decimal` runs csrc/cast_decimal.cu (`cast_cuda.to_decimal`, one
thread a row) on a CUDA column, or raises; on a CPU column the plain
version, `string_to_decimal_plain`: the JAX package's padded-matrix
algebra, its 256-bit magnitude in `decimal256`'s (n, 8) limbs. A rejected
row's data is 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from . import cast_cuda
from . import decimal256 as d256
from .cast_string import (POW10_U64, PLAIN_CALLS, char_at,
                          first_idx, padded_chars, raise_first_error, ugt,
                          ws4)

__all__ = ["string_to_decimal", "string_to_decimal_plain"]

BOUNDS = {
    Kind.DECIMAL32: (2**31 - 1, 2**31),
    Kind.DECIMAL64: (2**63 - 1, 2**63),
    Kind.DECIMAL128: (2**127 - 1, 2**127),
}
_PAD_STEPS = 40          # the padding loops' trip count (39 steps + 1)


def mul_small(a: torch.Tensor, v: int) -> torch.Tensor:
    """a * v mod 2^256 for a small v (< 2^31): (n, 8) limbs."""
    out, carry = [], torch.zeros_like(a[:, 0])
    for j in range(d256.NLIMBS):
        t = a[:, j] * v + carry
        out.append(t & d256.M32)
        carry = t >> 32
    return torch.stack(out, 1)


def string_to_decimal_plain(col: Column, precision: int, scale: int,
                            ansi_mode: bool = False, strip: bool = True,
                            pad_to: Optional[int] = None
                            ) -> Tuple[Column, torch.Tensor]:
    """-> (the cast column, the ANSI error flags)."""
    out_type = dtypes.decimal(precision, scale)
    tmax_pos, tmax_negmag = BOUNDS[out_type.kind]
    cudf_scale = -scale
    C, lens = padded_chars(col, pad_to)
    n, L = C.shape
    dev = C.device
    i64 = torch.int64
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None]
    in_str = pos < lens[:, None]
    ws = ws4(C)
    digit = (C >= 48) & (C <= 57)
    dot = C == 46
    valid_in = col.null_mask

    # leading whitespace, sign
    if strip:
        nonws = ~ws & in_str
        i0 = torch.where(nonws.any(1), first_idx(nonws, 0), lens)
    else:
        i0 = torch.zeros(n, dtype=torch.int32, device=dev)
    c0 = char_at(C, i0)
    has_sign = ((c0 == 43) | (c0 == 45)) & (i0 < lens)
    positive = ~((c0 == 45) & has_sign)
    istart = i0 + has_sign.to(torch.int32)
    valid = valid_in & (lens > 0) & (istart < lens)

    # structural regions
    region = (pos >= istart[:, None]) & in_str
    is_e = ((C == 101) | (C == 69)) & region
    e_idx = torch.where(is_e.any(1), first_idx(is_e, 0), lens)
    if strip:
        ws_in = ws & region
        fw = torch.where(ws_in.any(1), first_idx(ws_in, 0), lens)
    else:
        valid &= ~(ws & region).any(1)
        fw = lens
    mant_end = torch.minimum(torch.minimum(e_idx, fw), lens)
    mant = region & (pos < mant_end[:, None])
    dots_in_mant = (dot & mant).sum(1)
    dot_idx = torch.where(dots_in_mant > 0, first_idx(dot & mant, 0), lens)
    has_dot = dots_in_mant == 1

    has_e = e_idx < lens
    ce = char_at(C, e_idx + 1)
    e_sign_char = ((ce == 43) | (ce == 45)) & has_e & (e_idx + 1 < lens)
    exp_positive = ~((ce == 45) & e_sign_char)
    estart = e_idx + 1 + e_sign_char.to(torch.int32)

    fw_ok = (fw >= lens) | ((fw == mant_end) & (fw > istart)) | (
        fw == e_idx + 1)
    valid &= fw_ok
    valid &= ~(region & (pos >= fw[:, None]) & ~ws).any(1)
    valid &= dots_in_mant <= 1
    ok = (digit | (pos == dot_idx[:, None]) | (pos == e_idx[:, None])
          | ((pos == (e_idx + 1)[:, None]) & e_sign_char[:, None])
          | (ws & (pos >= fw[:, None])))
    valid &= ~(region & ~ok).any(1)

    # the exponent, in int64, checked against the storage bounds
    exp_region = region & (pos >= estart[:, None]) & (
        pos < torch.minimum(fw, lens)[:, None])
    emax = min(tmax_pos, 2**63 - 1)
    emin_mag = min(tmax_negmag, 2**63)
    d = (C - 48).clamp(0, 9).to(i64)
    em = exp_region & digit
    emi = em.to(torch.int32)
    erfr = emi.sum(1, keepdim=True) - emi.cumsum(1, dtype=torch.int32)
    e_nd_eff = torch.where(em & (C != 48), erfr + 1, 0).amax(1)
    wE = torch.tensor(POW10_U64, dtype=i64, device=dev)[
        erfr.clamp(0, 19).to(i64)]
    emag = torch.where(em, d * wE, 0).sum(1)
    eof = (e_nd_eff > 19) | torch.where(exp_positive, ugt(emag, emax),
                                        ugt(emag, emin_mag))
    valid &= ~eof
    exp_val = torch.where(exp_positive, emag, -emag).clamp(-(2**40), 2**40)

    # the point's location and each digit's significance
    dl = torch.where(has_dot, dot_idx - istart, mant_end - istart).to(i64)
    dl = dl + exp_val
    last_digit_cnt = dl + scale
    dmask = mant & digit
    dmi = dmask.to(i64)
    kidx = dmi.cumsum(1) - dmi
    nonzero_dig = dmask & (C != 48)
    anynz = nonzero_dig.to(i64).cumsum(1) > 0
    sig = dmask & (((kidx + 1) > dl[:, None]) | anynz)
    sgi = sig.to(i64)
    np_before = sgi.cumsum(1) - sgi
    accumulate = dmask & (np_before < precision) & (
        kidx < last_digit_cnt[:, None])
    nd_acc = accumulate.sum(1)
    np_final = (sig & accumulate).sum(1)

    stop_mask = dmask & ~accumulate
    has_round = stop_mask.any(1) & (last_digit_cnt >= 0)
    round_digit = torch.where(has_round,
                              char_at(C, first_idx(stop_mask, 0)) - 48, 0)
    sig_before_in_string = (dmask & (kidx < dl[:, None]) & anynz).sum(1)

    # the magnitude: each accumulated digit times 10^(accumulated digits to
    # its right), limb by limb, then one carry propagation
    bnd = torch.where(positive[:, None],
                      d256.from_int([tmax_pos], dev).expand(n, -1),
                      d256.from_int([tmax_negmag], dev).expand(n, -1))
    acc = accumulate.to(torch.int32)
    vrfr = acc.sum(1, keepdim=True) - acc.cumsum(1, dtype=torch.int32)
    widx = vrfr.clamp(0, 39).to(i64)
    tbl = d256.pow10_table(dev)
    carry = torch.zeros(n, dtype=i64, device=dev)
    limbs = []
    for j in range(d256.NLIMBS):
        s = torch.where(accumulate, d * tbl[:, j][widx], 0).sum(1)
        t = s + carry
        limbs.append(t & d256.M32)
        carry = t >> 32
    mag = torch.stack(limbs, 1)
    valid &= ~d256.lt_unsigned(bnd, mag)

    # HALF_UP on the next digit; a carry to a power of ten grows the count
    do_round = has_round & (round_digit >= 5)
    mag_r = d256.add_small(mag, 1)
    valid &= ~(d256.lt_unsigned(bnd, mag_r) & do_round)
    was_zero = d256.is_zero(mag)
    is_p10 = (mag_r[:, None, :] == tbl[None, 1:40, :]).all(2).any(1)
    grew = (do_round & ~was_zero & is_p10).to(i64)
    mag = torch.where(do_round[:, None], mag_r, mag)
    total_digits = nd_acc + grew
    np_final = np_final + grew
    dl = dl + grew

    # zero padding and the precision checks (cast_string.cu:538-585)
    sig_preceding_zeros = (-dl).clamp(min=0)
    zeros_to_decimal = (dl - total_digits - max(cudf_scale, 0)).clamp(min=0)
    sig_before_decimal = sig_before_in_string + zeros_to_decimal + grew
    valid &= (precision + cudf_scale) >= sig_before_decimal
    valid &= zeros_to_decimal <= 39

    def pad(mag, valid, steps, count=None):
        # the JAX loop's 40 turns, less those no row takes (one host read)
        turns = min(_PAD_STEPS, int(steps.max())) if n else 0
        for i in range(turns):
            active = i < steps
            mag_new = mul_small(mag, 10)
            of = d256.lt_unsigned(bnd, mag_new) & active
            mag = torch.where((active & ~of)[:, None], mag_new, mag)
            valid = valid & ~of
            if count is not None:
                count = count + active.to(i64)
        return mag, valid, count

    mag, valid, np_final = pad(mag, valid, zeros_to_decimal, np_final)
    digits_after = np_final - sig_before_decimal + sig_preceding_zeros
    digits_needed = torch.minimum(precision - sig_before_decimal,
                                  torch.full_like(dl, -cudf_scale))
    pad2 = (digits_needed - digits_after).clamp(min=0)
    valid &= pad2 <= 39
    mag, valid, _ = pad(mag, valid, pad2)

    signed = torch.where(positive[:, None], mag, d256.negate(mag))
    signed = torch.where(valid[:, None], signed, 0)
    if out_type.kind == Kind.DECIMAL128:
        data = d256.to_i128_limbs(signed)
    else:
        lo = signed[:, 0] | (signed[:, 1] << 32)
        data = lo.to(out_type.storage_dtype())
    return Column(out_type, n, data, valid), valid_in & ~valid


def string_to_decimal(col: Column, precision: int, scale: int,
                      ansi_mode: bool = False, strip: bool = True,
                      pad_to: Optional[int] = None) -> Column:
    """string -> decimal(precision, scale), the storage width by the
    precision as the reference's host API picks it
    (cast_string.cu:818-827)."""
    dtypes.decimal(precision, scale)          # rejects a bad precision
    if col.device.type == "cpu":
        PLAIN_CALLS["to_decimal"] += 1
        out, err = string_to_decimal_plain(col, precision, scale, ansi_mode,
                                           strip, pad_to)
    else:
        out, err = cast_cuda.to_decimal(col, precision, scale, ansi_mode,
                                        strip)
    if ansi_mode:
        raise_first_error(col, err)
    return out

