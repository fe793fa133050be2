"""256-bit integer limb arithmetic for DECIMAL128: the plain PyTorch version.

Counterpart of `spark_rapids_tpu/ops/decimal256.py`, with its semantics
(the reference's `chunked256`, decimal_utils.cu:32-244): every value is
two's complement mod 2^256 and every op wraps as the reference's does. It
is the plain version of the decimal kernel (`csrc/decimal128.cu`): the CPU
runs it, the tests hold the kernel and the JAX package against it, and
`chip_smoke.py` runs it on the card as the reference to compare with. No
entry point reaches it on a CUDA tensor.

A 256-bit value is an (n, 8) int64 tensor of 32-bit limbs, little-endian
(limb j holds bits [32j, 32j + 32), each in [0, 2^32)). Torch on the CPU
has no add, shift or compare on uint32/uint64, so the limbs live in int64:
a product of two limbs plus a limb and a carry is below 2^64 and wraps in
int64 to the same bits, and its high word is an arithmetic shift by 32 and
a mask (the emulated logical shift). Sums and compares of limbs stay far
inside int64.

Where the reference unrolls work over rows in lockstep, this version is
free to take another route to the same bits: `precision10` is a binary
search over the table of powers of ten (seven compares, not 77), and an
unsigned compare weighs the limbs' signs in base 3 in one reduction.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

NLIMBS = 8
M32 = 0xFFFFFFFF
_POW3 = [3 ** j for j in range(NLIMBS)]      # limb weights of a compare
_TABLES: Dict[torch.device, torch.Tensor] = {}


# ---- host helpers -----------------------------------------------------------

def from_int(values: Sequence[int], device) -> torch.Tensor:
    """Python ints -> (n, 8) limbs on `device`, two's complement mod
    2^256. The device has no default: no helper builds its limbs on the
    host unasked."""
    rows = []
    for v in values:
        u = int(v) & ((1 << 256) - 1)
        rows.append([(u >> (32 * j)) & M32 for j in range(NLIMBS)])
    return torch.tensor(rows, dtype=torch.int64,
                        device=device).reshape(len(rows), NLIMBS)


def to_int(limbs: torch.Tensor) -> list:
    """(n, 8) limbs -> signed 256-bit Python ints."""
    out = []
    for row in limbs.cpu().tolist():
        u = sum(int(w) << (32 * j) for j, w in enumerate(row))
        out.append(u - (1 << 256) if u >= (1 << 255) else u)
    return out


# ---- conversions ------------------------------------------------------------

def from_i128_limbs(limbs_u32: torch.Tensor) -> torch.Tensor:
    """A DECIMAL128 column's (n, 4) uint32 limbs, sign-extended to (n, 8)."""
    lo = limbs_u32.view(torch.int32).to(torch.int64) & M32
    neg = (lo[:, 3] >> 31) != 0
    ext = torch.where(neg, M32, 0).unsqueeze(1).expand(-1, 4)
    return torch.cat([lo, ext], dim=1)


def to_i128_limbs(x: torch.Tensor) -> torch.Tensor:
    """The low 128 bits as (n, 4) uint32 limbs (as_128_bits). The limbs
    pass through int32 by their bits: torch converts few ops to uint32."""
    lo = x[:, :4]
    return torch.where(lo > 0x7FFFFFFF, lo - (1 << 32), lo).to(
        torch.int32).view(torch.uint32)


# ---- add, negate, compare ---------------------------------------------------

def _stack(limbs) -> torch.Tensor:
    return torch.stack(limbs, dim=1)


def is_negative(x: torch.Tensor) -> torch.Tensor:
    return (x[:, 7] >> 31) != 0


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2^256 (chunked256::add)."""
    out = []
    carry = torch.zeros_like(a[:, 0])
    for j in range(NLIMBS):
        s = a[:, j] + b[:, j] + carry
        out.append(s & M32)
        carry = s >> 32
    return _stack(out)


def add_small(a: torch.Tensor, v) -> torch.Tensor:
    """a + v for a small non-negative v (< 2^32), scalar or per row."""
    out = []
    carry = torch.as_tensor(v, dtype=torch.int64, device=a.device
                            ).expand(a.shape[0])
    for j in range(NLIMBS):
        s = a[:, j] + carry
        out.append(s & M32)
        carry = s >> 32
    return _stack(out)


def negate(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement negation (chunked256::negate)."""
    return add_small(a ^ M32, 1)


def abs_(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|a|, a < 0); |-2^255| stays 2^255, read unsigned."""
    neg = is_negative(a)
    return torch.where(neg.unsqueeze(1), negate(a), a), neg


def _cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row the sign of the unsigned a - b: the sign of the top limb that
    differs, read off the limbs' signs weighed by 3^j."""
    w = torch.tensor(_POW3, dtype=torch.int64, device=a.device)
    return (torch.sign(a - b) * w).sum(dim=1)


def lt_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cmp(a, b) < 0


def gte_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cmp(a, b) >= 0


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=1)


# ---- multiply, shift, subtract ----------------------------------------------

def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The low 256 bits of a * b (decimal_utils.cu:127-147). Each step
    a_i * b_j + r + carry is below 2^64: int64 holds its bits."""
    r = [torch.zeros_like(a[:, 0]) for _ in range(NLIMBS)]
    for j in range(NLIMBS):
        carry = torch.zeros_like(a[:, 0])
        for i in range(NLIMBS - j):
            t = a[:, i] * b[:, j] + r[i + j] + carry
            r[i + j] = t & M32
            carry = (t >> 32) & M32
    return _stack(r)


def shift_left1(a: torch.Tensor) -> torch.Tensor:
    """a << 1 mod 2^256."""
    hi = a >> 31
    shifted = (a << 1) & M32
    return shifted | torch.nn.functional.pad(hi[:, :-1], (1, 0))


def _sub_borrow(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a - b mod 2^256, a < b unsigned)."""
    out = []
    borrow = torch.zeros_like(a[:, 0])
    for j in range(NLIMBS):
        t = a[:, j] - b[:, j] - borrow
        out.append(t & M32)
        borrow = (t < 0).to(torch.int64)
    return _stack(out), borrow != 0


def sub_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod 2^256."""
    return _sub_borrow(a, b)[0]


# ---- powers of ten ----------------------------------------------------------

def pow10_table(device) -> torch.Tensor:
    """10^0 .. 10^76 as (77, 8) limbs on `device`."""
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = from_int([10 ** k for k in range(77)], device)
    return _TABLES[device]


def pow_ten(k, n: int, device) -> torch.Tensor:
    """10^k as (n, 8) limbs, k a Python int or an (n,) integer tensor,
    clipped to [0, 76] as the reference clips it."""
    tbl = pow10_table(device)
    if isinstance(k, int):
        return tbl[min(max(k, 0), 76)].expand(n, NLIMBS)
    return tbl.index_select(0, k.to(torch.int64).clamp(0, 76))


def precision10(value: torch.Tensor) -> torch.Tensor:
    """Per row the first i in [0, 76] with 10^i >= |value|, 77 if none
    (decimal_utils.cu:520-535), as int32: a binary search."""
    a, _ = abs_(value)
    tbl = pow10_table(value.device)
    lo = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    hi = torch.full_like(lo, 77)
    for _ in range(7):                      # 2^7 > 78 candidates
        mid = (lo + hi) >> 1
        below = lt_unsigned(tbl.index_select(0, mid.clamp(max=76)), a)
        live = lo < hi
        lo = torch.where(live & below, mid + 1, lo)
        hi = torch.where(live & ~below, mid, hi)
    return lo.to(torch.int32)


def is_greater_than_decimal_38(a: torch.Tensor) -> torch.Tensor:
    """|a| >= 10^38: precision-38 overflow (decimal_utils.cu:537-542)."""
    mag, _ = abs_(a)
    return gte_unsigned(mag, pow10_table(a.device)[38].expand_as(mag))


# ---- division ---------------------------------------------------------------

def divide_unsigned(n: torch.Tensor, d: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary long division of unsigned n by unsigned d, 256 steps
    (decimal_utils.cu:149-168) -> (quotient, remainder). A zero d gives an
    all-ones quotient and the remainder n, as the reference's steps do;
    callers flag it before."""
    q = [torch.zeros_like(n[:, 0]) for _ in range(NLIMBS)]
    r = torch.zeros_like(n)
    for i in range(255, -1, -1):
        block, bit = divmod(i, 32)
        r = shift_left1(r)
        r[:, 0] |= (n[:, block] >> bit) & 1
        diff, below = _sub_borrow(r, d)
        ge = ~below
        r = torch.where(ge.unsqueeze(1), diff, r)
        q[block] = q[block] | (ge.to(torch.int64) << bit)
    return _stack(q), r


def divide(n: torch.Tensor, d: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed divide (decimal_utils.cu:170-191): the quotient's sign is
    sign(n) ^ sign(d), the remainder takes n's."""
    abs_n, n_neg = abs_(n)
    abs_d, d_neg = abs_(d)
    q, r = divide_unsigned(abs_n, abs_d)
    q = torch.where((n_neg ^ d_neg).unsqueeze(1), negate(q), q)
    r = torch.where(n_neg.unsqueeze(1), negate(r), r)
    return q, r


def round_from_remainder(q: torch.Tensor, r: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """HALF_UP from a remainder (decimal_utils.cu:193-224): |q| grows by
    one, away from zero in the direction sign(r) ^ sign(d), when
    2|r| >= |d|."""
    abs_r, r_neg = abs_(r)
    abs_d, d_neg = abs_(d)
    need_inc = gte_unsigned(shift_left1(abs_r), abs_d)
    down = (r_neg ^ d_neg).unsqueeze(1)
    need = need_inc.unsqueeze(1)
    minus_one = torch.full_like(q, M32)
    return torch.where(need & ~down, add_small(q, 1),
                       torch.where(need & down, add(q, minus_one), q))


def divide_and_round(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """divide, then HALF_UP (decimal_utils.cu:226-233)."""
    q, r = divide(n, d)
    return round_from_remainder(q, r, d)


def integer_divide(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """divide, the remainder dropped (DOWN, decimal_utils.cu:235-244)."""
    return divide(n, d)[0]
