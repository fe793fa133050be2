"""DECIMAL128 arithmetic with 256-bit intermediates and Spark-exact rounding.

Counterpart of `spark_rapids_tpu/ops/decimal_utils.py` (the reference's
decimal_utils.cu: dec128_add_sub :561, dec128_multiplier :657,
dec128_divider :744, dec128_remainder :854). Each op returns
(overflow BOOL column, result column) like the Java facade's Table
{overflow, result} (DecimalUtils.java:46-178), both carrying the inputs'
combined validity. Scales are Spark scales (digits right of the point); the
reference's cudf scale is the negation. `cast_interim_result` keeps the
bug-compatible Spark < 3.4.2 multiply that first rounds the 256-bit product
to 38 digits (SPARK-40129).

- `add_decimal128`, `sub_decimal128`, `multiply_decimal128`,
  `divide_decimal128`, `remainder_decimal128`: the port's entry points. On
  CPU tensors they run the plain version; on CUDA tensors they launch the
  decimal kernel (`decimal_cuda.launch`, `csrc/decimal128.cu`) or raise,
  and never fall back.
- `*_plain`: the plain PyTorch version over `decimal256`'s limb math, on
  any device. The CPU runs it, and `chip_smoke.py` and the card's tests run
  it on CUDA tensors as the reference the kernel must equal bit for bit.
  Every row is computed, null rows too, as the reference computes them.
- `decimal128_op`: either form by the op's name, as the kernel names it.

`decimal_cuda.LAUNCHES` counts kernel launches and `PLAIN_CALLS` the
wrappers' plain runs, per op: "add", "sub", "multiply", "divide" (the
integer divide too) and "remainder".
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import dtypes
from ..columnar import Column
from ..dtypes import Kind
from . import decimal256 as d256
from . import decimal_cuda
from .decimal_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["add_decimal128", "sub_decimal128", "multiply_decimal128",
           "divide_decimal128", "remainder_decimal128", "decimal128_op",
           "LAUNCHES", "PLAIN_CALLS", "reset_counters"]


def _check(a: Column, b: Column, what: str) -> None:
    for c in (a, b):
        if c.dtype.kind != Kind.DECIMAL128:
            raise TypeError(f"{what} takes DECIMAL128 columns, got "
                            f"{c.dtype!r}")
    if a.length != b.length:
        raise ValueError(f"{what}: columns of {a.length} and {b.length} "
                         "rows")
    if a.device != b.device:
        raise ValueError(f"{what}: columns on {a.device} and {b.device}")


def combined_validity(a: Column, b: Column) -> Optional[torch.Tensor]:
    if a.validity is None and b.validity is None:
        return None
    return a.null_mask & b.null_mask


def result_columns(a: Column, b: Column, overflow: torch.Tensor,
                   data: torch.Tensor, scale: Optional[int]
                   ) -> Tuple[Column, Column]:
    """(overflow BOOL, result) with the combined validity; `data` is (n, 4)
    uint32 limbs of a decimal(38, scale), or with `scale` None (n,) INT64."""
    valid = combined_validity(a, b)
    dt = (dtypes.INT64 if scale is None
          else dtypes.DType(Kind.DECIMAL128, precision=38, scale=scale))
    return (Column(dtypes.BOOL, a.length, overflow, valid),
            Column(dt, a.length, data, valid))


def _on_cpu(a: Column) -> bool:
    return a.device.type == "cpu"


# ---- the plain version ------------------------------------------------------

def _limbs(col: Column) -> torch.Tensor:
    return d256.from_i128_limbs(col.data)


def _set_scale_and_round(data: torch.Tensor, old_scale: int,
                         new_scale: int) -> torch.Tensor:
    """A cudf-scale change (decimal_utils.cu:544-558): lowering the scale
    multiplies, raising it divides with HALF_UP."""
    if old_scale == new_scale:
        return data
    n, dev = data.shape[0], data.device
    if new_scale < old_scale:
        return d256.multiply(data, d256.pow_ten(old_scale - new_scale, n,
                                                dev))
    return d256.divide_and_round(data, d256.pow_ten(new_scale - old_scale,
                                                    n, dev))


def _decimal(a: Column, b: Column, overflow: torch.Tensor,
             limbs: torch.Tensor, scale: int) -> Tuple[Column, Column]:
    return result_columns(a, b, overflow, d256.to_i128_limbs(limbs), scale)


def add_decimal128_plain(a: Column, b: Column, target_scale: int,
                         is_sub: bool = False) -> Tuple[Column, Column]:
    """dec128_add / dec128_sub (decimal_utils.cu:561-654): both rescaled to
    the smaller cudf scale, added in 256 bits, rescaled to the target, more
    than 38 digits flagged."""
    _check(a, b, "add_decimal128")
    av, bv = _limbs(a), _limbs(b)
    a_scale, b_scale = -a.dtype.scale, -b.dtype.scale
    inter = min(a_scale, b_scale)
    av = _set_scale_and_round(av, a_scale, inter)
    bv = _set_scale_and_round(bv, b_scale, inter)
    if is_sub:
        bv = d256.negate(bv)
    s = _set_scale_and_round(d256.add(av, bv), inter, -target_scale)
    return _decimal(a, b, d256.is_greater_than_decimal_38(s), s,
                    target_scale)


def sub_decimal128_plain(a: Column, b: Column, target_scale: int
                         ) -> Tuple[Column, Column]:
    return add_decimal128_plain(a, b, target_scale, is_sub=True)


def multiply_decimal128_plain(a: Column, b: Column, product_scale: int,
                              cast_interim_result: bool = True
                              ) -> Tuple[Column, Column]:
    """dec128_multiplier (decimal_utils.cu:657-741)."""
    _check(a, b, "multiply_decimal128")
    av, bv = _limbs(a), _limbs(b)
    n, dev = av.shape[0], av.device
    product = d256.multiply(av, bv)
    mult_scale = torch.full((n,), -a.dtype.scale - b.dtype.scale,
                            dtype=torch.int32, device=dev)
    if cast_interim_result:
        # Spark < 3.4.2 first rounds the product to 38 digits (SPARK-40129)
        first = d256.precision10(product) - 38
        needs = first > 0
        rounded = d256.divide_and_round(
            product, d256.pow_ten(first.clamp(min=0), n, dev))
        product = torch.where(needs.unsqueeze(1), rounded, product)
        mult_scale = mult_scale + torch.where(needs, first, 0)
    exponent = -product_scale - mult_scale
    # exponent < 0: multiply up unless that passes 38 digits
    mul_overflow = (exponent < 0) & (d256.precision10(product) - exponent
                                     > 38)
    scaled_up = d256.multiply(product,
                              d256.pow_ten((-exponent).clamp(min=0), n, dev))
    scaled_down = d256.divide_and_round(
        product, d256.pow_ten(exponent.clamp(min=0), n, dev))
    result = torch.where((exponent < 0).unsqueeze(1), scaled_up,
                         torch.where((exponent > 0).unsqueeze(1),
                                     scaled_down, product))
    overflow = mul_overflow | d256.is_greater_than_decimal_38(result)
    return _decimal(a, b, overflow, result, product_scale)


def divide_decimal128_plain(a: Column, b: Column, quotient_scale: int,
                            is_int_div: bool = False
                            ) -> Tuple[Column, Column]:
    """dec128_divider (decimal_utils.cu:744-851). With `is_int_div` the
    quotient is rounded DOWN and returned as its low 64 bits, an INT64
    column; the overflow is still judged on the 128-bit value
    (DecimalUtilsTest.java:221-236)."""
    _check(a, b, "divide_decimal128")
    av, bv = _limbs(a), _limbs(b)
    n, dev = av.shape[0], av.device
    div_by_zero = d256.is_zero(bv)
    one = d256.pow_ten(0, n, dev)
    safe_d = torch.where(div_by_zero.unsqueeze(1), one, bv)
    n_shift_exp = -quotient_scale - (-a.dtype.scale + b.dtype.scale)
    if n_shift_exp > 0:
        # divide twice: the quotient, then the scale with rounding
        q1, _ = d256.divide(av, safe_d)
        scale_div = d256.pow_ten(n_shift_exp, n, dev)
        result = (d256.integer_divide(q1, scale_div) if is_int_div
                  else d256.divide_and_round(q1, scale_div))
    elif n_shift_exp < -38:
        # long division base 10^38 (decimal_utils.cu:795-826)
        num = d256.multiply(av, d256.pow_ten(38, n, dev))
        q1, r1 = d256.divide(num, safe_d)
        scale_mult = d256.pow_ten(-n_shift_exp - 38, n, dev)
        q2, r2 = d256.divide(d256.multiply(r1, scale_mult), safe_d)
        result = d256.add(d256.multiply(q1, scale_mult), q2)
        if not is_int_div:
            result = d256.round_from_remainder(result, r2, safe_d)
    else:
        num = av if n_shift_exp == 0 else d256.multiply(
            av, d256.pow_ten(-n_shift_exp, n, dev))
        result = (d256.integer_divide(num, safe_d) if is_int_div
                  else d256.divide_and_round(num, safe_d))
    result = torch.where(div_by_zero.unsqueeze(1), 0, result)
    overflow = div_by_zero | d256.is_greater_than_decimal_38(result)
    if is_int_div:
        lo64 = result[:, 0] | (result[:, 1] << 32)
        return result_columns(a, b, overflow, lo64, None)
    return _decimal(a, b, overflow, result, quotient_scale)


def remainder_decimal128_plain(a: Column, b: Column, remainder_scale: int
                               ) -> Tuple[Column, Column]:
    """dec128_remainder (decimal_utils.cu:854-971): Java's a % b =
    a - (a / b) * b, the sign the dividend's."""
    _check(a, b, "remainder_decimal128")
    av, bv = _limbs(a), _limbs(b)
    n, dev = av.shape[0], av.device
    div_by_zero = d256.is_zero(bv)
    safe_b = torch.where(div_by_zero.unsqueeze(1), d256.pow_ten(0, n, dev),
                         bv)
    abs_n, n_neg = d256.abs_(av)
    abs_d, _ = d256.abs_(safe_b)
    d_shift_exp = -remainder_scale + b.dtype.scale
    n_shift_exp = -remainder_scale + a.dtype.scale
    if d_shift_exp > 0:
        abs_d = d256.divide_and_round(abs_d,
                                      d256.pow_ten(d_shift_exp, n, dev))
    else:
        n_shift_exp -= d_shift_exp
    if n_shift_exp > 0:
        q1, _ = d256.divide(abs_n, abs_d)
        int_div = d256.integer_divide(q1, d256.pow_ten(n_shift_exp, n, dev))
    else:
        if n_shift_exp < 0:
            abs_n = d256.multiply(abs_n, d256.pow_ten(-n_shift_exp, n, dev))
        int_div = d256.integer_divide(abs_n, abs_d)
    less_n = d256.multiply(int_div, abs_d)
    if d_shift_exp < 0:
        less_n = d256.multiply(less_n, d256.pow_ten(-d_shift_exp, n, dev))
    rem = d256.add(abs_n, d256.negate(less_n))
    overflow = div_by_zero | d256.is_greater_than_decimal_38(rem)
    rem = torch.where(n_neg.unsqueeze(1), d256.negate(rem), rem)
    rem = torch.where(div_by_zero.unsqueeze(1), 0, rem)
    return _decimal(a, b, overflow, rem, remainder_scale)


# ---- the entry points: plain on CPU tensors, the kernel on CUDA ones --------

def _kernel(op: str, a: Column, b: Column, out_scale: int, flag: bool
            ) -> Tuple[Column, Column]:
    overflow, data = decimal_cuda.launch(op, a, b, out_scale, flag)
    int_div = op == "divide" and flag
    return result_columns(a, b, overflow, data,
                          None if int_div else out_scale)


def add_decimal128(a: Column, b: Column, target_scale: int,
                   is_sub: bool = False) -> Tuple[Column, Column]:
    """a + b (a - b with `is_sub`) at `target_scale`."""
    what = "sub" if is_sub else "add"
    _check(a, b, f"{what}_decimal128")
    if _on_cpu(a):
        PLAIN_CALLS[what] += 1
        return add_decimal128_plain(a, b, target_scale, is_sub)
    return _kernel(what, a, b, target_scale, is_sub)


def sub_decimal128(a: Column, b: Column, target_scale: int
                   ) -> Tuple[Column, Column]:
    return add_decimal128(a, b, target_scale, is_sub=True)


def multiply_decimal128(a: Column, b: Column, product_scale: int,
                        cast_interim_result: bool = True
                        ) -> Tuple[Column, Column]:
    """a * b at `product_scale`."""
    _check(a, b, "multiply_decimal128")
    if _on_cpu(a):
        PLAIN_CALLS["multiply"] += 1
        return multiply_decimal128_plain(a, b, product_scale,
                                         cast_interim_result)
    return _kernel("multiply", a, b, product_scale, cast_interim_result)


def divide_decimal128(a: Column, b: Column, quotient_scale: int,
                      is_int_div: bool = False) -> Tuple[Column, Column]:
    """a / b at `quotient_scale` (HALF_UP), or with `is_int_div` the
    integer quotient as INT64."""
    _check(a, b, "divide_decimal128")
    if _on_cpu(a):
        PLAIN_CALLS["divide"] += 1
        return divide_decimal128_plain(a, b, quotient_scale, is_int_div)
    return _kernel("divide", a, b, quotient_scale, is_int_div)


def remainder_decimal128(a: Column, b: Column, remainder_scale: int
                         ) -> Tuple[Column, Column]:
    """a % b at `remainder_scale`, the dividend's sign."""
    _check(a, b, "remainder_decimal128")
    if _on_cpu(a):
        PLAIN_CALLS["remainder"] += 1
        return remainder_decimal128_plain(a, b, remainder_scale)
    return _kernel("remainder", a, b, remainder_scale, False)


def decimal128_op(op: str, a: Column, b: Column, out_scale: int,
                  flag: bool = False, plain: bool = False
                  ) -> Tuple[Column, Column]:
    """One op by the kernel's name for it ("add", "sub", "multiply",
    "divide", "remainder"): `flag` is the multiply's `cast_interim_result`
    and the divide's `is_int_div` (unused by the others); `plain` runs the
    plain version on any device, else the entry point."""
    forms = {"add": (add_decimal128, add_decimal128_plain),
             "sub": (sub_decimal128, sub_decimal128_plain),
             "multiply": (multiply_decimal128, multiply_decimal128_plain),
             "divide": (divide_decimal128, divide_decimal128_plain),
             "remainder": (remainder_decimal128, remainder_decimal128_plain)}
    fn = forms[op][plain]
    if op in ("multiply", "divide"):
        return fn(a, b, out_scale, flag)
    return fn(a, b, out_scale)
