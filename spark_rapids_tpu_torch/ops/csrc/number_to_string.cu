// Numbers to strings for Hopper (sm_90a), one thread a row, in two passes:
// a length pass writes each row's byte count, the wrapper scans them into
// offsets (torch.cumsum) and reads the total once to allocate the chars,
// and a write pass writes each row at its offset. Four formats:
//
// - FLOAT32/64 -> Java's Float.toString / Double.toString: Ryu's shortest
//   round-trip digits, then Java's layout ("1.2345679E11", "0.001", "NaN");
// - format_number(x, d): the shortest digits rounded half-even to d
//   fraction digits, commas between thousands, U+FFFD for NaN and U+221E
//   for infinities (a value near 1e308 writes 309 integer digits);
// - DECIMAL32/64/128 -> Java's BigDecimal.toString();
// - INT8..INT64, UINT8, UINT64 -> base 10 (signed; UINT64 unsigned) or 16
//   (uppercase, the two's complement bits, leading zeros stripped).
//
// Replaces the XLA ops of spark_rapids_tpu/ops/cast_float_to_string.py
// (`float_to_string` :483: Ryu `_ryu_f32` :187, `_ryu_f64` :279, the
// layout `_format_java` :364), spark_rapids_tpu/ops/format_float.py
// (`format_float` :188), spark_rapids_tpu/ops/cast_decimal_to_string.py
// (`decimal_to_non_ansi_string` :67) and spark_rapids_tpu/ops/
// cast_string.py (`integer_to_string_with_base` :459); none is a
// pallas_call. The reference's own CUDA is cast_float_to_string.cu and
// ftos_converter.cuh (Ryu d2d :480, f2d :659, to_chars :796, the format
// half :1174-1440), format_float.cu and cast_decimal_to_string.cu, one
// thread a row with the same two passes.
//
// The JAX design is shaped by the TPU: Ryu's 64 x 128-bit products as
// 32-bit limb schoolbook products in u64 lanes, its digit-removal loop
// unrolled 20 times with lane masks, every character scattered into an
// (n, 40) plane (format_float: a plane as wide as its longest row, 450
// bytes a row once a value nears 1e308), then a compaction. Here each
// thread runs Ryu on its own value (native 64 x 64 -> 128-bit products,
// the loop leaving when its row is done, as many turns as the JAX loop's
// cap allows: 11 for float32, 20 for float64) and writes its bytes in
// place. The tables are the JAX module's, made in Python with exact
// integers (ops/cast_float_to_string.py) and passed in as one u64 tensor.
//
// What bounds it on this card: bytes, or for floats the Ryu arithmetic
// (three 64 x 128 products, the removal turns a row takes, each three
// divisions by 10, a division a digit written), as chip_smoke.py counts
// both from a run's rows. A
// null row's string is empty, except for the integer conversion, which
// writes a null row's data as the JAX package does.
//
// Plain C++ without nvcc: `host_number_to_string` runs both passes row by
// row (tests/test_torch_float_to_string.py).

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define NS_FN __host__ __device__ __forceinline__
#else
#define NS_FN static inline
#endif

#define THREADS 256

typedef unsigned long long u64;

enum NsOp { NS_FLOAT = 0, NS_FORMAT = 1, NS_DECIMAL = 2, NS_INT = 3 };

// the u64 table layout: F_INV (32), F_POW5 (49), D_INV (293 pairs lo, hi),
// D_POW5 (327 pairs)
#define T_F_INV 0
#define T_F_POW5 32
#define T_D_INV 81
#define T_D_POW5 (81 + 2 * 293)
#define T_SIZE (81 + 2 * 293 + 2 * 327)

NS_FN u64 ns_mulhi(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return static_cast<u64>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

NS_FN u64 ns_pow10(int k) {
  u64 p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

NS_FN int ns_pow5bits(int e) { return ((e * 1217359) >> 19) + 1; }
NS_FN int ns_log10_pow2(int e) { return (e * 78913) >> 18; }
NS_FN int ns_log10_pow5(int e) { return (e * 732923) >> 20; }
NS_FN int ns_clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (m * factor) >> j, 32 < j: as the JAX package splits it
NS_FN u64 ns_mulshift32(u64 m, u64 factor, int j) {
  const u64 plo = m * (factor & 0xFFFFFFFFULL);
  const u64 phi = m * (factor >> 32);
  const int sh = j - 32;             // out of [0, 64): 0, as XLA shifts
  return (sh < 0 || sh >= 64) ? 0 : (phi + (plo >> 32)) >> sh;
}

// floor(m * (hi:lo) / 2^j) mod 2^64, 0 <= j < 192
NS_FN u64 ns_mulshift128(u64 m, u64 lo, u64 hi, int j) {
  const u64 p0_lo = m * lo, p0_hi = ns_mulhi(m, lo);
  const u64 p1_lo = m * hi, p1_hi = ns_mulhi(m, hi);
  u64 w[3];
  w[0] = p0_lo;
  w[1] = p0_hi + p1_lo;
  w[2] = p1_hi + (w[1] < p0_hi ? 1 : 0);
  const int s = j >> 6, off = j & 63;
  if (j < 0 || s >= 3) return 0;
  const u64 a = w[s];
  const u64 b = s + 1 < 3 ? w[s + 1] : 0;
  return off == 0 ? a : (a >> off) | (b << (64 - off));
}

NS_FN int ns_decimal_length(u64 v) {
  int n = 1;
  u64 p = 10;
  for (int k = 1; k < 20; ++k) {
    if (v >= p) ++n;
    p *= 10;
  }
  return n;
}

struct Ryu {
  u64 digits;
  int exp10, olength;
  bool sign, nan, inf, zero;
};

// Ryu's digit removal, both loops as one, as the JAX package runs it: at
// most `max_iter` turns
NS_FN void ns_removal(u64 vr, u64 vp, u64 vm, bool vr_tz, bool vm_tz,
                      int last_removed, bool accept, int max_iter,
                      u64* digits, int* removed) {
  int r = 0;
  for (int it = 0; it < max_iter; ++it) {
    const bool c1 = vp / 10 > vm / 10;
    const bool vm0 = vm % 10 == 0;
    const bool c2 = !c1 && vm_tz && vm0;
    if (!(c1 || c2)) break;
    if (c1) vm_tz = vm_tz && vm0;
    vr_tz = vr_tz && last_removed == 0;
    last_removed = static_cast<int>(vr % 10);
    vr /= 10;
    vp /= 10;
    vm /= 10;
    ++r;
  }
  if (vr_tz && last_removed == 5 && vr % 2 == 0) last_removed = 4;
  const bool round_up = (vr == vm && (!accept || !vm_tz)) ||
                        last_removed >= 5;
  *digits = vr + (round_up ? 1 : 0);
  *removed = r;
}

NS_FN Ryu ns_ryu32(uint32_t bits, const u64* T) {
  Ryu out;
  const u64 mantissa = bits & ((1u << 23) - 1);
  const int exponent = static_cast<int>((bits >> 23) & 0xFF);
  out.sign = (bits >> 31) != 0;
  out.nan = exponent == 0xFF && mantissa != 0;
  out.inf = exponent == 0xFF && mantissa == 0;
  out.zero = exponent == 0 && mantissa == 0;
  const int e2 = (exponent == 0 ? 1 : exponent) - (127 + 23 + 2);
  const u64 m2 = exponent == 0 ? mantissa : (mantissa | (1u << 23));
  const bool accept = (m2 & 1) == 0;
  const u64 mv = 4 * m2;
  const u64 mm_shift = (mantissa != 0 || exponent <= 1) ? 1 : 0;
  const u64 mp = mv + 2, mm = mv - 1 - mm_shift;
  u64 vr, vp, vm;
  bool vr_tz, vm_tz;
  int lr, e10;
  if (e2 >= 0) {
    const int q = ns_log10_pow2(ns_clip(e2, 0, 127));
    const int k = 59 + ns_pow5bits(ns_clip(q, 0, 31)) - 1;
    const int j = -e2 + q + k;
    const u64 f = T[T_F_INV + ns_clip(q, 0, 31)];
    vr = ns_mulshift32(mv, f, j);
    vp = ns_mulshift32(mp, f, j);
    vm = ns_mulshift32(mm, f, j);
    lr = 0;
    if (q != 0 && (vp - 1) / 10 <= vm / 10) {
      const int qm1 = ns_clip(q - 1, 0, 31);
      const int l = 59 + ns_pow5bits(qm1) - 1;
      lr = static_cast<int>(
          ns_mulshift32(mv, T[T_F_INV + qm1], -e2 + q - 1 + l) % 10);
    }
    const bool q_le9 = q <= 9;
    const bool mv5 = mv % 5 == 0;
    u64 p5q = 1;
    for (int i = 0; i < ns_clip(q, 0, 22); ++i) p5q *= 5;
    vr_tz = q_le9 && mv5 && mv % p5q == 0;
    vm_tz = q_le9 && !mv5 && accept && mm % p5q == 0;
    vp -= (q_le9 && !mv5 && !accept && mp % p5q == 0) ? 1 : 0;
    e10 = q;
  } else {
    const int ne2 = -e2 < 1 ? 1 : -e2;
    const int q = ns_log10_pow5(ns_clip(ne2, 0, 159));
    const int i = ne2 - q;
    const int k = ns_pow5bits(ns_clip(i, 0, 48)) - 61;
    const int j = q - k;
    const u64 f = T[T_F_POW5 + ns_clip(i, 0, 48)];
    vr = ns_mulshift32(mv, f, j);
    vp = ns_mulshift32(mp, f, j);
    vm = ns_mulshift32(mm, f, j);
    lr = 0;
    if (q != 0 && (vp - 1) / 10 <= vm / 10) {
      const int i1 = ns_clip(i + 1, 0, 48);
      int j2 = q - 1 - (ns_pow5bits(i1) - 61);
      if (j2 < 33) j2 = 33;
      lr = static_cast<int>(ns_mulshift32(mv, T[T_F_POW5 + i1], j2) % 10);
    }
    if (q <= 1) {
      vr_tz = true;
    } else {
      const int qc = ns_clip(q - 1, 0, 63);
      vr_tz = q < 31 && (mv & ((1ULL << qc) - 1)) == 0;
    }
    vm_tz = q <= 1 && accept && mm_shift == 1;
    vp -= (q <= 1 && !accept) ? 1 : 0;
    e10 = q + e2;
  }
  int removed;
  ns_removal(vr, vp, vm, vr_tz, vm_tz, lr, accept, 11, &out.digits,
             &removed);
  out.olength = ns_decimal_length(out.digits);
  out.exp10 = e10 + removed + out.olength - 1;
  return out;
}

NS_FN Ryu ns_ryu64(u64 bits, const u64* T) {
  Ryu out;
  const u64 mantissa = bits & ((1ULL << 52) - 1);
  const int exponent = static_cast<int>((bits >> 52) & 0x7FF);
  out.sign = (bits >> 63) != 0;
  out.nan = exponent == 0x7FF && mantissa != 0;
  out.inf = exponent == 0x7FF && mantissa == 0;
  out.zero = exponent == 0 && mantissa == 0;
  const int e2 = (exponent == 0 ? 1 : exponent) - (1023 + 52 + 2);
  const u64 m2 = exponent == 0 ? mantissa : (mantissa | (1ULL << 52));
  const bool accept = (m2 & 1) == 0;
  const u64 mv = 4 * m2;
  const u64 mm_shift = (mantissa != 0 || exponent <= 1) ? 1 : 0;
  const u64 mp = mv + 2, mm = mv - 1 - mm_shift;
  u64 vr, vp, vm;
  bool vr_tz, vm_tz;
  int e10;
  if (e2 >= 0) {
    int q = ns_log10_pow2(ns_clip(e2, 0, 999)) - (e2 > 3 ? 1 : 0);
    if (q < 0) q = 0;
    const int k = 125 + ns_pow5bits(ns_clip(q, 0, 292)) - 1;
    const int j = -e2 + q + k;
    const u64* f = T + T_D_INV + 2 * ns_clip(q, 0, 292);
    vr = ns_mulshift128(mv, f[0], f[1], j);
    vp = ns_mulshift128(mp, f[0], f[1], j);
    vm = ns_mulshift128(mm, f[0], f[1], j);
    const bool q_le21 = q <= 21;
    const bool mv5 = mv % 5 == 0;
    u64 p5q = 1;
    for (int i = 0; i < ns_clip(q, 0, 22); ++i) p5q *= 5;
    vr_tz = q_le21 && mv5 && mv % p5q == 0;
    vm_tz = q_le21 && !mv5 && accept && mm % p5q == 0;
    vp -= (q_le21 && !mv5 && !accept && mp % p5q == 0) ? 1 : 0;
    e10 = q;
  } else {
    const int ne2 = -e2 < 1 ? 1 : -e2;
    int q = ns_log10_pow5(ns_clip(ne2, 0, 1099)) - (ne2 > 1 ? 1 : 0);
    if (q < 0) q = 0;
    const int i = ne2 - q;
    const int k = ns_pow5bits(ns_clip(i, 0, 326)) - 125;
    const int j = q - k;
    const u64* f = T + T_D_POW5 + 2 * ns_clip(i, 0, 326);
    vr = ns_mulshift128(mv, f[0], f[1], j);
    vp = ns_mulshift128(mp, f[0], f[1], j);
    vm = ns_mulshift128(mm, f[0], f[1], j);
    if (q <= 1) {
      vr_tz = true;
    } else {
      const int qc = ns_clip(q, 0, 63);
      vr_tz = q < 63 && (mv & ((1ULL << qc) - 1)) == 0;
    }
    vm_tz = q <= 1 && accept && mm_shift == 1;
    vp -= (q <= 1 && !accept) ? 1 : 0;
    e10 = q + e2;
  }
  int removed;
  ns_removal(vr, vp, vm, vr_tz, vm_tz, 0, accept, 20, &out.digits,
             &removed);
  out.olength = ns_decimal_length(out.digits);
  out.exp10 = e10 + removed + out.olength - 1;
  return out;
}

NS_FN void ns_put(uint8_t* dst, int pos, int c) {
  if (dst != nullptr) dst[pos] = static_cast<uint8_t>(c);
}

// digit k (0 = most significant) of an olength-digit value
NS_FN int ns_digit(u64 v, int olength, int k) {
  return static_cast<int>(v / ns_pow10(olength - 1 - k) % 10);
}

// Java's Float/Double.toString layout -> the row's length
NS_FN int ns_java(Ryu r, uint8_t* dst) {
  if (r.nan) {
    ns_put(dst, 0, 'N');
    ns_put(dst, 1, 'a');
    ns_put(dst, 2, 'N');
    return 3;
  }
  const int s = r.sign ? 1 : 0;
  if (s) ns_put(dst, 0, '-');
  if (r.inf) {
    const char* w = "Infinity";
    for (int t = 0; t < 8; ++t) ns_put(dst, s + t, w[t]);
    return s + 8;
  }
  u64 digits = r.digits;
  int olength = r.olength, exp10 = r.exp10;
  if (r.zero) {
    digits = 0;
    olength = 1;
    exp10 = 0;
  }
  if (exp10 >= -3 && exp10 <= 6) {
    if (exp10 >= 0) {
      const int ip = exp10 + 1;
      for (int k = 0; k < olength; ++k)
        ns_put(dst, s + (k < ip ? k : k + 1),
               '0' + ns_digit(digits, olength, k));
      for (int t = olength; t < ip; ++t) ns_put(dst, s + t, '0');
      ns_put(dst, s + ip, '.');
      if (olength <= ip) ns_put(dst, s + ip + 1, '0');
      return s + ip + 1 + (olength > ip ? olength - ip : 1);
    }
    const int zneg = -exp10 - 1;
    ns_put(dst, s, '0');
    ns_put(dst, s + 1, '.');
    for (int t = 0; t < zneg; ++t) ns_put(dst, s + 2 + t, '0');
    for (int k = 0; k < olength; ++k)
      ns_put(dst, s + 2 + zneg + k, '0' + ns_digit(digits, olength, k));
    return s + 2 + zneg + olength;
  }
  ns_put(dst, s, '0' + ns_digit(digits, olength, 0));
  ns_put(dst, s + 1, '.');
  if (olength == 1) ns_put(dst, s + 2, '0');
  for (int k = 1; k < olength; ++k)
    ns_put(dst, s + 1 + k, '0' + ns_digit(digits, olength, k));
  const int m = olength < 2 ? 2 : olength;
  ns_put(dst, s + m + 1, 'E');
  const bool eneg = exp10 < 0;
  const int eabs = eneg ? -exp10 : exp10;
  if (eneg) ns_put(dst, s + m + 2, '-');
  const int es = s + m + 2 + (eneg ? 1 : 0);
  const int ne = 1 + (eabs >= 10 ? 1 : 0) + (eabs >= 100 ? 1 : 0);
  if (ne == 3) ns_put(dst, es, '0' + eabs / 100 % 10);
  if (ne >= 2) ns_put(dst, es + ne - 2, '0' + eabs / 10 % 10);
  ns_put(dst, es + ne - 1, '0' + eabs % 10);
  return es + ne;
}

// ---- format_number --------------------------------------------------------

NS_FN u64 ns_round_half_even(u64 v, int olength, int keep) {
  const u64 div = ns_pow10(ns_clip(olength - keep, 0, 19));
  const u64 mod = v % div, num = v / div;
  const bool up = mod * 2 > div || (mod * 2 == div && num % 2 == 1 &&
                                    mod != 0);
  return num + (up ? 1 : 0);
}

// digit k (from the right) of v; 0 beyond
NS_FN int ns_digit_at(u64 v, long long k) {
  if (k < 0 || k > 18) return 0;
  return static_cast<int>(v / ns_pow10(static_cast<int>(k)) % 10);
}

NS_FN int ns_format(Ryu r, int d, uint8_t* dst) {
  const int s = r.sign ? 1 : 0;
  if (r.nan) {
    ns_put(dst, 0, 0xEF);
    ns_put(dst, 1, 0xBF);
    ns_put(dst, 2, 0xBD);
    return 3;
  }
  if (s) ns_put(dst, 0, '-');
  if (r.inf) {
    ns_put(dst, s, 0xE2);
    ns_put(dst, s + 1, 0x88);
    ns_put(dst, s + 2, 0x9E);
    return s + 3;
  }
  if (r.zero) {
    ns_put(dst, s, '0');
    if (d > 0) {
      ns_put(dst, s + 1, '.');
      for (int t = 0; t < d; ++t) ns_put(dst, s + 2 + t, '0');
      return s + 2 + d;
    }
    return s + 1;
  }
  const u64 D = r.digits;
  const int olength = r.olength, exp = r.exp10;
  u64 V = 0, F = 0;
  long long S = 0;
  int IL = 1, frac_lead = 0, F_width = 0;
  bool carry_in_lead = false;
  if (exp < 0) {                              // the value below 1
    const int neg_exp = -exp - 1;
    const int z = neg_exp < d ? neg_exp : d;
    const bool proceed = d >= neg_exp;
    const int actual_round = proceed ? d - neg_exp : 0;
    const int actual_olength = olength < actual_round ? olength
                                                      : actual_round;
    u64 rounded = ns_round_half_even(D, olength, actual_round);
    const u64 lim = ns_pow10(ns_clip(actual_olength, 0, 19));
    const bool carry = proceed && rounded >= lim;
    if (carry) rounded -= lim;
    if (!proceed) rounded = 0;
    V = (carry && z == 0) ? 1 : 0;
    frac_lead = z;
    F = rounded;
    F_width = proceed ? actual_olength : 0;
    carry_in_lead = carry && z > 0;
  } else if (exp + 1 >= olength) {            // every digit before the point
    V = D;
    S = exp + 1 - olength;
    IL = exp + 1;
  } else {                                    // the point inside the digits
    const int temp_d = exp + d + 1 > olength ? olength - exp - 1 : d;
    const u64 rounded = ns_round_half_even(D, olength, exp + temp_d + 1);
    const u64 pw = ns_pow10(ns_clip(temp_d, 0, 19));
    V = rounded / pw;
    F = rounded % pw;
    IL = ns_decimal_length(V);
    F_width = temp_d;
  }
  const int IL_chars = IL + (IL - 1) / 3;
  for (int r4 = 0; r4 < IL_chars; ++r4) {     // r4 counted from the right
    const int pos = s + IL_chars - 1 - r4;
    if (r4 % 4 == 3)
      ns_put(dst, pos, ',');
    else
      ns_put(dst, pos, '0' + ns_digit_at(V, r4 - (r4 + 1) / 4 - S));
  }
  if (d > 0) {
    const int point = s + IL_chars;
    ns_put(dst, point, '.');
    for (int f = 0; f < d; ++f) {
      int digit;
      if (f < frac_lead)
        digit = (carry_in_lead && f == frac_lead - 1) ? 1 : 0;
      else if (f < frac_lead + F_width)
        digit = ns_digit_at(F, frac_lead + F_width - 1 - f);
      else
        digit = 0;
      ns_put(dst, point + 1 + f, '0' + digit);
    }
    return s + IL_chars + 1 + d;
  }
  return s + IL_chars;
}

// ---- BigDecimal.toString ---------------------------------------------------

// digit idx (0 = most significant of D, clipped as the JAX package clips)
NS_FN int ns_dig_at(const uint8_t* dig, int D, int idx) {
  return '0' + dig[ns_clip(idx, 0, D - 1)];
}

NS_FN int ns_decimal(const uint32_t* limbs, int kind_bytes, int scale,
                     uint8_t* dst) {
  // |v| as four 32-bit words, and its D digits, most significant first
  uint32_t w[4] = {0, 0, 0, 0};
  bool neg;
  int D;
  if (kind_bytes == 16) {
    for (int i = 0; i < 4; ++i) w[i] = limbs[i];
    neg = (w[3] >> 31) != 0;
    if (neg) {
      u64 carry = 1;
      for (int i = 0; i < 4; ++i) {
        const u64 t = static_cast<u64>(~w[i]) + carry;
        w[i] = static_cast<uint32_t>(t);
        carry = t >> 32;
      }
    }
    D = 39;
  } else {
    long long v;
    if (kind_bytes == 4) {
      v = static_cast<int32_t>(limbs[0]);
      D = 10;
    } else {
      v = static_cast<long long>(limbs[0] | (static_cast<u64>(limbs[1])
                                             << 32));
      D = 19;
    }
    neg = v < 0;
    const u64 mag = neg ? 0 - static_cast<u64>(v) : static_cast<u64>(v);
    w[0] = static_cast<uint32_t>(mag);
    w[1] = static_cast<uint32_t>(mag >> 32);
  }
  uint8_t dig[39];
  for (int k = D - 1; k >= 0; --k) {
    u64 r = 0;
    for (int i = 3; i >= 0; --i) {
      const u64 acc = (r << 32) | w[i];
      w[i] = static_cast<uint32_t>(acc / 10);
      r = acc % 10;
    }
    dig[k] = static_cast<uint8_t>(r);
  }
  int ndig = 1;
  for (int k = 0; k < D; ++k)
    if (dig[k] != 0) {
      ndig = D - k;
      break;
    }
  const int adjusted = ndig - 1 - scale;
  const int ng = neg ? 1 : 0;
  if (ng) ns_put(dst, 0, '-');
  if (scale >= 0 && adjusted >= -6) {
    const int int_len = ndig - scale > 1 ? ndig - scale : 1;
    for (int k = 0; k < int_len; ++k)
      ns_put(dst, ng + k, ns_dig_at(dig, D, D - scale - int_len + k));
    if (scale > 0) {
      ns_put(dst, ng + int_len, '.');
      for (int k = 0; k < scale; ++k)
        ns_put(dst, ng + int_len + 1 + k, ns_dig_at(dig, D, D - scale + k));
      return ng + int_len + 1 + scale;
    }
    return ng + int_len;
  }
  ns_put(dst, ng, ns_dig_at(dig, D, D - ndig));
  int p = ng + 1;
  if (ndig > 1) {
    ns_put(dst, p++, '.');
    for (int k = 1; k < ndig; ++k)
      ns_put(dst, p++, ns_dig_at(dig, D, D - ndig + k));
  }
  ns_put(dst, p++, 'E');
  ns_put(dst, p++, adjusted >= 0 ? '+' : '-');
  const int eabs = adjusted < 0 ? -adjusted : adjusted;
  const int ne = 1 + (eabs >= 10 ? 1 : 0) + (eabs >= 100 ? 1 : 0);
  if (ne == 3) ns_put(dst, p++, '0' + eabs / 100 % 10);
  if (ne >= 2) ns_put(dst, p++, '0' + eabs / 10 % 10);
  ns_put(dst, p++, '0' + eabs % 10);
  return p;
}

// ---- integers in base 10 or 16 ---------------------------------------------

NS_FN int ns_integer(u64 bits, int nbits, bool is_unsigned, int base,
                     uint8_t* dst) {
  if (base == 16) {
    const u64 u = nbits < 64 ? bits & ((1ULL << nbits) - 1) : bits;
    int nd = 1;
    while (nd < nbits / 4 && (u >> (4 * nd)) != 0) ++nd;
    for (int k = 0; k < nd; ++k) {
      const int nib = static_cast<int>((u >> (4 * (nd - 1 - k))) & 0xF);
      ns_put(dst, k, nib < 10 ? '0' + nib : 'A' + nib - 10);
    }
    return nd;
  }
  const bool neg = !is_unsigned && static_cast<long long>(bits) < 0;
  u64 mag = neg ? 0 - bits : bits;
  const int nd = ns_decimal_length(mag);
  if (neg) ns_put(dst, 0, '-');
  const int s = neg ? 1 : 0;
  for (int k = nd - 1; k >= 0; --k) {
    ns_put(dst, s + k, '0' + static_cast<int>(mag % 10));
    mag /= 10;
  }
  return s + nd;
}

// ---- the passes ------------------------------------------------------------

struct NsArgs {
  int op;
  const void* data;
  const uint8_t* valid;      // null: every row valid
  int in_bytes;              // the input's element bytes (DECIMAL128: 16)
  int flag;                  // NS_INT: the input is unsigned
  int param;                 // NS_FORMAT: digits; NS_DECIMAL: scale;
                             // NS_INT: base
  const u64* tables;         // NS_FLOAT, NS_FORMAT: T_SIZE entries
  int32_t* lens;             // the length pass's output
  const int32_t* offsets;    // the write pass's input
  uint8_t* chars;            // the write pass's output
};

NS_FN u64 ns_load(const void* data, int bytes, long long i, bool sign) {
  switch (bytes) {
    case 1:
      return sign ? static_cast<u64>(static_cast<long long>(
                        static_cast<const int8_t*>(data)[i]))
                  : static_cast<const uint8_t*>(data)[i];
    case 2:
      return static_cast<u64>(static_cast<long long>(
          static_cast<const int16_t*>(data)[i]));
    case 4:
      return sign ? static_cast<u64>(static_cast<long long>(
                        static_cast<const int32_t*>(data)[i]))
                  : static_cast<const uint32_t*>(data)[i];
    default:
      return static_cast<const u64*>(data)[i];
  }
}

NS_FN int ns_row(const NsArgs& a, long long i, uint8_t* dst) {
  const bool valid = a.valid == nullptr || a.valid[i] != 0;
  if (!valid && a.op != NS_INT) return 0;
  switch (a.op) {
    case NS_FLOAT:
    case NS_FORMAT: {
      const Ryu r = a.in_bytes == 4
          ? ns_ryu32(static_cast<uint32_t>(ns_load(a.data, 4, i, false)),
                     a.tables)
          : ns_ryu64(ns_load(a.data, 8, i, false), a.tables);
      return a.op == NS_FLOAT ? ns_java(r, dst) : ns_format(r, a.param, dst);
    }
    case NS_DECIMAL:
      return ns_decimal(static_cast<const uint32_t*>(a.data) +
                            i * (a.in_bytes / 4),
                        a.in_bytes, a.param, dst);
    default:
      return ns_integer(ns_load(a.data, a.in_bytes, i, a.flag == 0),
                        8 * a.in_bytes, a.flag != 0, a.param, dst);
  }
}

NS_FN void ns_pass(const NsArgs& a, long long i) {
  if (a.chars == nullptr)
    a.lens[i] = ns_row(a, i, nullptr);
  else
    ns_row(a, i, a.chars + a.offsets[i]);
}

static NsArgs ns_args(int op, const void* data, const void* valid,
                      int in_bytes, int flag, int param, const void* tables,
                      void* lens, const void* offsets, void* chars) {
  NsArgs a;
  a.op = op;
  a.data = data;
  a.valid = static_cast<const uint8_t*>(valid);
  a.in_bytes = in_bytes;
  a.flag = flag;
  a.param = param;
  a.tables = static_cast<const u64*>(tables);
  a.lens = static_cast<int32_t*>(lens);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<uint8_t*>(chars);
  return a;
}

static bool ns_args_ok(const NsArgs& a, long long n) {
  const bool pass_ok = a.chars == nullptr ? a.lens != nullptr
                                          : a.offsets != nullptr;
  bool kind_ok;
  switch (a.op) {
    case NS_FLOAT:
      kind_ok = a.in_bytes == 4 || a.in_bytes == 8;
      break;
    case NS_FORMAT:
      kind_ok = (a.in_bytes == 4 || a.in_bytes == 8) && a.param >= 0 &&
                a.param <= 30;
      break;
    case NS_DECIMAL:
      kind_ok = a.in_bytes == 4 || a.in_bytes == 8 || a.in_bytes == 16;
      break;
    case NS_INT:
      kind_ok = (a.in_bytes == 1 || a.in_bytes == 2 || a.in_bytes == 4 ||
                 a.in_bytes == 8) && (a.param == 10 || a.param == 16);
      break;
    default:
      kind_ok = false;
  }
  const bool tables_ok = (a.op != NS_FLOAT && a.op != NS_FORMAT) ||
                         a.tables != nullptr;
  return n >= 1 && a.data != nullptr && pass_ok && kind_ok && tables_ok;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
number_to_string_kernel(NsArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    ns_pass(a, i);
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

// One pass over n >= 1 rows: with chars null the length pass (lens: (n,)
// int32), else the write pass (offsets: (n + 1,) int32 from the lengths).
// data: (n,) of in_bytes each (DECIMAL128: (n, 4) u32 limbs); valid: (n,)
// bool or null; tables: T_SIZE u64 for the float formats.
int ns_number_to_string(int op, const void* data, const void* valid,
                        long long n, int in_bytes, int flag, int param,
                        const void* tables, void* lens, const void* offsets,
                        void* chars, void* stream) {
  const NsArgs a = ns_args(op, data, valid, in_bytes, flag, param, tables,
                           lens, offsets, chars);
  if (!ns_args_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  number_to_string_kernel<<<blocks_for(n), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_number_to_string(int op, const void* data,
                                     const void* valid, long long n,
                                     int in_bytes, int flag, int param,
                                     const void* tables, void* lens,
                                     const void* offsets, void* chars) {
  const NsArgs a = ns_args(op, data, valid, in_bytes, flag, param, tables,
                           lens, offsets, chars);
  if (!ns_args_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) ns_pass(a, i);
  return 0;
}

#endif  // __CUDACC__
