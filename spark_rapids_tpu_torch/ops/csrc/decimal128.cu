// Spark-exact DECIMAL128 arithmetic for Hopper (sm_90a): add, subtract,
// multiply, divide, integer divide and remainder over (n, 4) u32-limb
// columns, with 256-bit intermediates, HALF_UP rounding and the precision-38
// overflow flag.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/decimal_utils.py
// (`add_decimal128` :58, `sub_decimal128` :77, `multiply_decimal128` :81,
// `divide_decimal128` :115, `remainder_decimal128` :175) over the limb math
// of spark_rapids_tpu/ops/decimal256.py; the reference's own CUDA is
// decimal_utils.cu (dec128_add_sub :561, dec128_multiplier :657,
// dec128_divider :744, dec128_remainder :854). Scales are Spark scales
// (digits right of the point) and each call's are the same for every row,
// so every branch on them is uniform. Every row is computed, null rows too,
// so the whole output equals the plain version's (ops/decimal256.py and
// ops/decimal_utils.py `*_plain`), not only the valid rows. The branches
// are the reference's, one for one: divide's three n_shift_exp branches
// (> 0: divide twice; < -38: long division base 10^38; else one), the
// remainder's d_shift_exp branches, the SPARK-40129 interim rounding of the
// product to 38 digits, HALF_UP away from zero by the signs, a zero divisor
// giving 0 with the overflow set, and the integer divide's low 64 bits with
// the overflow judged on the 128-bit value.
//
// The JAX design is shaped by the TPU: 32-bit limbs in u64 lanes, every row
// in lockstep through a 256-iteration fori_loop divide and 77 full-width
// compares for precision10. Here one thread computes one row (grid-stride
// loop) on four native u64 limbs: products from `__umul64hi`, adds and
// subtracts with explicit carries, precision10 a binary search (seven
// compares) over a __constant__ table of 10^0..10^76, the precision-38
// check one compare against 10^38. Work the row's data does not need is
// skipped where the result is the same bits: the interim rounding only when
// |product| > 10^38, the rescale only on the branch taken.
//
// What bounds it on this card, counted in the compiled code (cuobjdump
// -sass; chip_smoke.py counts the division step in each build): the
// entry's multiply (one input column as both operands, no rounding) runs
// 250 instructions a row, 107 of them on the 32-bit integer pipe (64 a
// clock an SM) and 99 IMADs on the FMA pipe beside it, 0.064 ms at 10M
// rows; it reads 16 B and writes 17 B a row, 330 MB, 0.0985 ms at
// 3.35 TB/s: bytes bound it. A divide is bound by its integer pipe: the
// division is still the reference's binary long division
// (decimal_utils.cu:149-168), 256 dependent steps of 65 instructions (53 on
// the integer pipe: shift the remainder, bring down a bit, a 4-limb
// subtract with borrow, selects, the quotient bit), one to three divisions
// a row by branch. A faster divide by powers of ten (most calls divide by
// 10^k) is later work (ROADMAP).
//
// The row arithmetic is also plain C++: compiled without nvcc the device
// qualifiers drop and `__umul64hi` takes a 128-bit host product, so it can
// be checked without a card: tests/test_torch_decimal.py builds it with
// the host compiler and holds it against the plain version.
//
// Plain C interface for ctypes. `dec_op` returns cudaGetLastError() after
// its launch (or cudaErrorInvalidValue for arguments it does not take); it
// never synchronises and allocates nothing.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEC_FN __device__ __forceinline__
#define DEC_CONST __constant__
#else
#define DEC_FN static inline
#define DEC_CONST static const
static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
}
#endif

#define THREADS 256

typedef uint64_t u64;

enum Op { OP_ADD = 0, OP_MUL = 1, OP_DIV = 2, OP_REM = 3 };

// little-endian 64-bit limbs of a two's complement value mod 2^256
struct U256 {
  u64 w[4];
};

// 10^0 .. 10^76 (pow_ten, decimal_utils.cu:678)
DEC_CONST u64 POW10[77][4] = {
    {0x0000000000000001ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^0
    {0x000000000000000Aull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^1
    {0x0000000000000064ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^2
    {0x00000000000003E8ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^3
    {0x0000000000002710ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^4
    {0x00000000000186A0ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^5
    {0x00000000000F4240ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^6
    {0x0000000000989680ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^7
    {0x0000000005F5E100ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^8
    {0x000000003B9ACA00ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^9
    {0x00000002540BE400ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^10
    {0x000000174876E800ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^11
    {0x000000E8D4A51000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^12
    {0x000009184E72A000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^13
    {0x00005AF3107A4000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^14
    {0x00038D7EA4C68000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^15
    {0x002386F26FC10000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^16
    {0x016345785D8A0000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^17
    {0x0DE0B6B3A7640000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^18
    {0x8AC7230489E80000ull, 0x0000000000000000ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^19
    {0x6BC75E2D63100000ull, 0x0000000000000005ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^20
    {0x35C9ADC5DEA00000ull, 0x0000000000000036ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^21
    {0x19E0C9BAB2400000ull, 0x000000000000021Eull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^22
    {0x02C7E14AF6800000ull, 0x000000000000152Dull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^23
    {0x1BCECCEDA1000000ull, 0x000000000000D3C2ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^24
    {0x161401484A000000ull, 0x0000000000084595ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^25
    {0xDCC80CD2E4000000ull, 0x000000000052B7D2ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^26
    {0x9FD0803CE8000000ull, 0x00000000033B2E3Cull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^27
    {0x3E25026110000000ull, 0x00000000204FCE5Eull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^28
    {0x6D7217CAA0000000ull, 0x00000001431E0FAEull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^29
    {0x4674EDEA40000000ull, 0x0000000C9F2C9CD0ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^30
    {0xC0914B2680000000ull, 0x0000007E37BE2022ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^31
    {0x85ACEF8100000000ull, 0x000004EE2D6D415Bull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^32
    {0x38C15B0A00000000ull, 0x0000314DC6448D93ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^33
    {0x378D8E6400000000ull, 0x0001ED09BEAD87C0ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^34
    {0x2B878FE800000000ull, 0x0013426172C74D82ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^35
    {0xB34B9F1000000000ull, 0x00C097CE7BC90715ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^36
    {0x00F436A000000000ull, 0x0785EE10D5DA46D9ull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^37
    {0x098A224000000000ull, 0x4B3B4CA85A86C47Aull, 0x0000000000000000ull,
     0x0000000000000000ull},  // 10^38
    {0x5F65568000000000ull, 0xF050FE938943ACC4ull, 0x0000000000000002ull,
     0x0000000000000000ull},  // 10^39
    {0xB9F5610000000000ull, 0x6329F1C35CA4BFABull, 0x000000000000001Dull,
     0x0000000000000000ull},  // 10^40
    {0x4395CA0000000000ull, 0xDFA371A19E6F7CB5ull, 0x0000000000000125ull,
     0x0000000000000000ull},  // 10^41
    {0xA3D9E40000000000ull, 0xBC627050305ADF14ull, 0x0000000000000B7Aull,
     0x0000000000000000ull},  // 10^42
    {0x6682E80000000000ull, 0x5BD86321E38CB6CEull, 0x00000000000072CBull,
     0x0000000000000000ull},  // 10^43
    {0x011D100000000000ull, 0x9673DF52E37F2410ull, 0x0000000000047BF1ull,
     0x0000000000000000ull},  // 10^44
    {0x0B22A00000000000ull, 0xE086B93CE2F768A0ull, 0x00000000002CD76Full,
     0x0000000000000000ull},  // 10^45
    {0x6F5A400000000000ull, 0xC5433C60DDAA1640ull, 0x0000000001C06A5Eull,
     0x0000000000000000ull},  // 10^46
    {0x5986800000000000ull, 0xB4A05BC8A8A4DE84ull, 0x00000000118427B3ull,
     0x0000000000000000ull},  // 10^47
    {0x7F41000000000000ull, 0x0E4395D69670B12Bull, 0x00000000AF298D05ull,
     0x0000000000000000ull},  // 10^48
    {0xF88A000000000000ull, 0x8EA3DA61E066EBB2ull, 0x00000006D79F8232ull,
     0x0000000000000000ull},  // 10^49
    {0xB564000000000000ull, 0x926687D2C40534FDull, 0x000000446C3B15F9ull,
     0x0000000000000000ull},  // 10^50
    {0x15E8000000000000ull, 0xB8014E3BA83411E9ull, 0x000002AC3A4EDBBFull,
     0x0000000000000000ull},  // 10^51
    {0xDB10000000000000ull, 0x300D0E549208B31Aull, 0x00001ABA4714957Dull,
     0x0000000000000000ull},  // 10^52
    {0x8EA0000000000000ull, 0xE0828F4DB456FF0Cull, 0x00010B46C6CDD6E3ull,
     0x0000000000000000ull},  // 10^53
    {0x9240000000000000ull, 0xC51999090B65F67Dull, 0x000A70C3C40A64E6ull,
     0x0000000000000000ull},  // 10^54
    {0xB680000000000000ull, 0xB2FFFA5A71FBA0E7ull, 0x006867A5A867F103ull,
     0x0000000000000000ull},  // 10^55
    {0x2100000000000000ull, 0xFDFFC78873D4490Dull, 0x04140C78940F6A24ull,
     0x0000000000000000ull},  // 10^56
    {0x4A00000000000000ull, 0xEBFDCB54864ADA83ull, 0x28C87CB5C89A2571ull,
     0x0000000000000000ull},  // 10^57
    {0xE400000000000000ull, 0x37E9F14D3EEC8920ull, 0x97D4DF19D6057673ull,
     0x0000000000000001ull},  // 10^58
    {0xE800000000000000ull, 0x2F236D04753D5B48ull, 0xEE50B7025C36A080ull,
     0x000000000000000Full},  // 10^59
    {0x1000000000000000ull, 0xD762422C946590D9ull, 0x4F2726179A224501ull,
     0x000000000000009Full},  // 10^60
    {0xA000000000000000ull, 0x69D695BDCBF7A87Aull, 0x17877CEC0556B212ull,
     0x0000000000000639ull},  // 10^61
    {0x4000000000000000ull, 0x2261D969F7AC94CAull, 0xEB4AE1383562F4B8ull,
     0x0000000000003E3Aull},  // 10^62
    {0x8000000000000000ull, 0x57D27E23ACBDCFE6ull, 0x30ECCC3215DD8F31ull,
     0x0000000000026E4Dull},  // 10^63
    {0x0000000000000000ull, 0x6E38ED64BF6A1F01ull, 0xE93FF9F4DAA797EDull,
     0x0000000000184F03ull},  // 10^64
    {0x0000000000000000ull, 0x4E3945EF7A25360Aull, 0x1C7FC3908A8BEF46ull,
     0x0000000000F31627ull},  // 10^65
    {0x0000000000000000ull, 0x0E3CBB5AC5741C64ull, 0x1CFDA3A5697758BFull,
     0x00000000097EDD87ull},  // 10^66
    {0x0000000000000000ull, 0x8E5F518BB6891BE8ull, 0x21E864761EA97776ull,
     0x000000005EF4A747ull},  // 10^67
    {0x0000000000000000ull, 0x8FB92F75215B1710ull, 0x5313EC9D329EAAA1ull,
     0x00000003B58E88C7ull},  // 10^68
    {0x0000000000000000ull, 0x9D3BDA934D8EE6A0ull, 0x3EC73E23FA32AA4Full,
     0x00000025179157C9ull},  // 10^69
    {0x0000000000000000ull, 0x245689C107950240ull, 0x73C86D67C5FAA71Cull,
     0x00000172EBAD6DDCull},  // 10^70
    {0x0000000000000000ull, 0x6B61618A4BD21680ull, 0x85D4460DBBCA8719ull,
     0x00000E7D34C64A9Cull},  // 10^71
    {0x0000000000000000ull, 0x31CDCF66F634E100ull, 0x3A4ABC8955E946FEull,
     0x000090E40FBEEA1Dull},  // 10^72
    {0x0000000000000000ull, 0xF20A1A059E10CA00ull, 0x46EB5D5D5B1CC5EDull,
     0x0005A8E89D752524ull},  // 10^73
    {0x0000000000000000ull, 0x746504382CA7E400ull, 0xC531A5A58F1FBB4Bull,
     0x003899162693736Aull},  // 10^74
    {0x0000000000000000ull, 0x8BF22A31BE8EE800ull, 0xB3F07877973D50F2ull,
     0x0235FADD81C2822Bull},  // 10^75
    {0x0000000000000000ull, 0x7775A5F171951000ull, 0x0764B4ABE8652979ull,
     0x161BCCA7119915B5ull},  // 10^76
};

struct Params {
  int a_scale;    // Spark scales: digits right of the point
  int b_scale;
  int out_scale;  // target / product / quotient / remainder scale
  int flag;       // add: subtract; multiply: interim cast; divide: integer
};

DEC_FN U256 u256(u64 w0, u64 w1, u64 w2, u64 w3) {
  U256 r;
  r.w[0] = w0;
  r.w[1] = w1;
  r.w[2] = w2;
  r.w[3] = w3;
  return r;
}

DEC_FN U256 pow_ten(int k) {  // clipped to [0, 76] as the reference clips
  k = k < 0 ? 0 : (k > 76 ? 76 : k);
  return u256(POW10[k][0], POW10[k][1], POW10[k][2], POW10[k][3]);
}

DEC_FN U256 from_i128(u64 lo, u64 hi) {
  const u64 ext = static_cast<u64>(static_cast<int64_t>(hi) >> 63);
  return u256(lo, hi, ext, ext);
}

DEC_FN bool is_neg(const U256& a) { return static_cast<int64_t>(a.w[3]) < 0; }

DEC_FN bool is_zero(const U256& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

DEC_FN U256 add(const U256& a, const U256& b) {
  U256 r;
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const u64 s = a.w[j] + b.w[j];
    const u64 c1 = s < a.w[j];
    r.w[j] = s + carry;
    carry = c1 | (r.w[j] < s);
  }
  return r;
}

DEC_FN U256 add_one(const U256& a) {
  U256 r;
  u64 carry = 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.w[j] = a.w[j] + carry;
    carry = r.w[j] < carry;
  }
  return r;
}

DEC_FN U256 sub_one(const U256& a) {
  U256 r;
  u64 borrow = 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.w[j] = a.w[j] - borrow;
    borrow = a.w[j] < borrow;
  }
  return r;
}

DEC_FN U256 negate(const U256& a) {
  return add_one(u256(~a.w[0], ~a.w[1], ~a.w[2], ~a.w[3]));
}

DEC_FN U256 abs_(const U256& a, bool& neg) {
  neg = is_neg(a);
  return neg ? negate(a) : a;
}

// r = a - b mod 2^256; returns a < b (unsigned)
DEC_FN bool sub_borrow(const U256& a, const U256& b, U256& r) {
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const u64 d = a.w[j] - b.w[j];
    const u64 b1 = a.w[j] < b.w[j];
    r.w[j] = d - borrow;
    borrow = b1 | (d < borrow);
  }
  return borrow != 0;
}

DEC_FN bool lt_u(const U256& a, const U256& b) {
  U256 t;
  return sub_borrow(a, b, t);
}

// the low 256 bits of a * b (decimal_utils.cu:127-147)
DEC_FN U256 mul(const U256& a, const U256& b) {
  u64 r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u64 carry = 0;
#pragma unroll
    for (int i = 0; i + j < 4; ++i) {
      u64 lo = a.w[i] * b.w[j];
      u64 hi = __umul64hi(a.w[i], b.w[j]);
      lo += r[i + j];
      hi += lo < r[i + j];
      lo += carry;
      hi += lo < carry;
      r[i + j] = lo;
      carry = hi;
    }
  }
  return u256(r[0], r[1], r[2], r[3]);
}

DEC_FN U256 shl1(const U256& a) {
  return u256(a.w[0] << 1, (a.w[1] << 1) | (a.w[0] >> 63),
              (a.w[2] << 1) | (a.w[1] >> 63), (a.w[3] << 1) | (a.w[2] >> 63));
}

// first i in [0, 76] with 10^i >= |value|, 77 if none
// (decimal_utils.cu:520-535): a binary search over the table
DEC_FN int precision10(const U256& value) {
  bool neg;
  const U256 a = abs_(value, neg);
  int lo = 0, hi = 77;
#pragma unroll
  for (int it = 0; it < 7; ++it) {  // 77 -> 38 -> 19 -> 9 -> 4 -> 2 -> 1 -> 0
    if (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lt_u(pow_ten(mid), a))
        lo = mid + 1;
      else
        hi = mid;
    }
  }
  return lo;
}

// |a| >= 10^38 (decimal_utils.cu:537-542)
DEC_FN bool gt38(const U256& a) {
  bool neg;
  return !lt_u(abs_(a, neg), pow_ten(38));
}

// binary long division, 256 steps (decimal_utils.cu:149-168). A zero d
// gives an all-ones quotient and the remainder n, as the reference's steps
// do; callers flag a zero divisor before.
DEC_FN void divide_unsigned(const U256& n, const U256& d, U256& q, U256& r) {
  r = u256(0, 0, 0, 0);
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    u64 nl = n.w[k], ql = 0;
#pragma unroll 1
    for (int bit = 0; bit < 64; ++bit) {
      r = shl1(r);
      r.w[0] |= nl >> 63;
      nl <<= 1;
      U256 diff;
      const bool below = sub_borrow(r, d, diff);
      if (!below) r = diff;
      ql = (ql << 1) | (below ? 0 : 1);
    }
    q.w[k] = ql;
  }
}

// signed: the quotient's sign is sign(n) ^ sign(d), the remainder takes n's
// (decimal_utils.cu:170-191)
DEC_FN void divide(const U256& n, const U256& d, U256& q, U256& r) {
  bool n_neg, d_neg;
  const U256 an = abs_(n, n_neg), ad = abs_(d, d_neg);
  divide_unsigned(an, ad, q, r);
  if (n_neg != d_neg) q = negate(q);
  if (n_neg) r = negate(r);
}

// HALF_UP: |q| grows by one away from zero, in the direction
// sign(r) ^ sign(d), when 2|r| >= |d| (decimal_utils.cu:193-224)
DEC_FN U256 round_from_remainder(const U256& q, const U256& r, const U256& d) {
  bool r_neg, d_neg;
  const U256 ar = abs_(r, r_neg), ad = abs_(d, d_neg);
  if (lt_u(shl1(ar), ad)) return q;
  return (r_neg != d_neg) ? sub_one(q) : add_one(q);
}

DEC_FN U256 divide_and_round(const U256& n, const U256& d) {
  U256 q, r;
  divide(n, d, q, r);
  return round_from_remainder(q, r, d);
}

DEC_FN U256 integer_divide(const U256& n, const U256& d) {
  U256 q, r;
  divide(n, d, q, r);
  return q;
}

// a cudf-scale change (decimal_utils.cu:544-558): lowering the scale
// multiplies, raising it divides with HALF_UP
DEC_FN U256 set_scale_and_round(const U256& v, int old_scale, int new_scale) {
  if (old_scale == new_scale) return v;
  if (new_scale < old_scale) return mul(v, pow_ten(old_scale - new_scale));
  return divide_and_round(v, pow_ten(new_scale - old_scale));
}

// ---- the four op families, one row each (decimal_utils.py's arms) --------
// Inside, scales are the reference's cudf scales: the negated Spark ones.

DEC_FN U256 row_add(U256 a, U256 b, const Params& p, bool& ovf) {
  const int a_scale = -p.a_scale, b_scale = -p.b_scale;
  const int inter = a_scale < b_scale ? a_scale : b_scale;
  a = set_scale_and_round(a, a_scale, inter);
  b = set_scale_and_round(b, b_scale, inter);
  if (p.flag) b = negate(b);
  const U256 s = set_scale_and_round(add(a, b), inter, -p.out_scale);
  ovf = gt38(s);
  return s;
}

DEC_FN U256 row_mul(const U256& a, const U256& b, const Params& p, bool& ovf) {
  U256 product = mul(a, b);
  int mult_scale = -p.a_scale - p.b_scale;
  if (p.flag) {
    // SPARK-40129: round the product to 38 digits first; precision10 > 38
    // exactly when |product| > 10^38
    bool neg;
    if (lt_u(pow_ten(38), abs_(product, neg))) {
      const int first = precision10(product) - 38;
      product = divide_and_round(product, pow_ten(first));
      mult_scale += first;
    }
  }
  const int exponent = -p.out_scale - mult_scale;
  bool mul_overflow = false;
  U256 result = product;
  if (exponent < 0) {
    mul_overflow = precision10(product) - exponent > 38;
    result = mul(product, pow_ten(-exponent));
  } else if (exponent > 0) {
    result = divide_and_round(product, pow_ten(exponent));
  }
  ovf = mul_overflow || gt38(result);
  return result;
}

DEC_FN U256 row_div(const U256& a, const U256& b, const Params& p, bool& ovf) {
  const bool div_by_zero = is_zero(b);
  const U256 d = div_by_zero ? u256(1, 0, 0, 0) : b;
  const bool int_div = p.flag != 0;
  const int n_shift_exp = -p.out_scale - (-p.a_scale + p.b_scale);
  U256 result;
  if (n_shift_exp > 0) {
    // divide twice: the quotient, then the scale with rounding
    U256 q1, r1;
    divide(a, d, q1, r1);
    const U256 scale_div = pow_ten(n_shift_exp);
    result = int_div ? integer_divide(q1, scale_div)
                     : divide_and_round(q1, scale_div);
  } else if (n_shift_exp < -38) {
    // long division base 10^38 (decimal_utils.cu:795-826)
    U256 q1, r1, q2, r2;
    divide(mul(a, pow_ten(38)), d, q1, r1);
    const U256 scale_mult = pow_ten(-n_shift_exp - 38);
    divide(mul(r1, scale_mult), d, q2, r2);
    result = add(mul(q1, scale_mult), q2);
    if (!int_div) result = round_from_remainder(result, r2, d);
  } else {
    const U256 num = n_shift_exp == 0 ? a : mul(a, pow_ten(-n_shift_exp));
    result = int_div ? integer_divide(num, d) : divide_and_round(num, d);
  }
  if (div_by_zero) result = u256(0, 0, 0, 0);
  ovf = div_by_zero || gt38(result);
  return result;
}

DEC_FN U256 row_rem(const U256& a, const U256& b, const Params& p, bool& ovf) {
  const bool div_by_zero = is_zero(b);
  bool n_neg, d_neg;
  U256 abs_n = abs_(a, n_neg);
  U256 abs_d = abs_(div_by_zero ? u256(1, 0, 0, 0) : b, d_neg);
  const int d_shift_exp = -p.out_scale + p.b_scale;
  int n_shift_exp = -p.out_scale + p.a_scale;
  if (d_shift_exp > 0)
    abs_d = divide_and_round(abs_d, pow_ten(d_shift_exp));
  else
    n_shift_exp -= d_shift_exp;
  U256 int_div;
  if (n_shift_exp > 0) {
    U256 q1, r1;
    divide(abs_n, abs_d, q1, r1);
    int_div = integer_divide(q1, pow_ten(n_shift_exp));
  } else {
    if (n_shift_exp < 0) abs_n = mul(abs_n, pow_ten(-n_shift_exp));
    int_div = integer_divide(abs_n, abs_d);
  }
  U256 less_n = mul(int_div, abs_d);
  if (d_shift_exp < 0) less_n = mul(less_n, pow_ten(-d_shift_exp));
  U256 rem = add(abs_n, negate(less_n));
  ovf = div_by_zero || gt38(rem);
  if (n_neg) rem = negate(rem);
  if (div_by_zero) rem = u256(0, 0, 0, 0);
  return rem;
}

// One row: a and b as (lo, hi) 64-bit halves of their 128 bits; the result's
// low 128 bits (the integer divide reads the low 64) and the overflow flag.
template <int OP>
DEC_FN void row_op(u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi, const Params& p,
                   u64& out_lo, u64& out_hi, bool& ovf) {
  const U256 a = from_i128(a_lo, a_hi), b = from_i128(b_lo, b_hi);
  U256 r;
  if (OP == OP_ADD)
    r = row_add(a, b, p, ovf);
  else if (OP == OP_MUL)
    r = row_mul(a, b, p, ovf);
  else if (OP == OP_DIV)
    r = row_div(a, b, p, ovf);
  else
    r = row_rem(a, b, p, ovf);
  out_lo = r.w[0];
  out_hi = r.w[1];
}

#ifdef __CUDACC__

template <int OP>
__global__ void __launch_bounds__(THREADS)
decimal_kernel(const ulonglong2* __restrict__ a,
               const ulonglong2* __restrict__ b, long long n, Params p,
               ulonglong2* __restrict__ out128, long long* __restrict__ out64,
               bool* __restrict__ overflow) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const ulonglong2 x = a[i], y = b[i];
    u64 lo, hi;
    bool ovf;
    row_op<OP>(x.x, x.y, y.x, y.y, p, lo, hi, ovf);
    if (out64 != nullptr)
      out64[i] = static_cast<long long>(lo);
    else
      out128[i] = make_ulonglong2(lo, hi);
    overflow[i] = ovf;
  }
}

static int blocks_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long need = (n + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

// One decimal op over n >= 1 rows. a, b: (n, 4) u32 limbs, 16-byte
// aligned. out: (n, 4) u32 limbs, or (n,) int64 for the integer divide
// (op OP_DIV with flag set). overflow: (n,) bool.
int dec_op(int op, const void* a, const void* b, long long n, int a_scale,
           int b_scale, int out_scale, int flag, void* out, void* overflow,
           void* stream) {
  if (n < 1 || a == nullptr || b == nullptr || out == nullptr ||
      overflow == nullptr || op < OP_ADD || op > OP_REM ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = {a_scale, b_scale, out_scale, flag};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  const ulonglong2* x = static_cast<const ulonglong2*>(a);
  const ulonglong2* y = static_cast<const ulonglong2*>(b);
  ulonglong2* o128 = static_cast<ulonglong2*>(out);
  long long* o64 = nullptr;
  if (op == OP_DIV && flag) {
    o64 = static_cast<long long*>(out);
    o128 = nullptr;
  }
  bool* ovf = static_cast<bool*>(overflow);
  switch (op) {
    case OP_ADD:
      decimal_kernel<OP_ADD><<<blocks, THREADS, 0, s>>>(x, y, n, p, o128,
                                                         o64, ovf);
      break;
    case OP_MUL:
      decimal_kernel<OP_MUL><<<blocks, THREADS, 0, s>>>(x, y, n, p, o128,
                                                         o64, ovf);
      break;
    case OP_DIV:
      decimal_kernel<OP_DIV><<<blocks, THREADS, 0, s>>>(x, y, n, p, o128,
                                                         o64, ovf);
      break;
    default:
      decimal_kernel<OP_REM><<<blocks, THREADS, 0, s>>>(x, y, n, p, o128,
                                                         o64, ovf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#endif  // __CUDACC__
