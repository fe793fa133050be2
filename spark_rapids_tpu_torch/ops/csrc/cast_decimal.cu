// Spark-exact string -> DECIMAL32/64/128 for Hopper (sm_90a): one thread a
// row over a STRING column's offsets and chars.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/cast_decimal.py
// (`string_to_decimal` :67; no pallas_call). The reference's own CUDA is
// validate_and_exponent cast_string.cu:247-374 and string_to_decimal_kernel
// cast_string.cu:376-599, one thread a row. The JAX design pads the column
// into an (n, L) char matrix, validates the grammar as boolean planes,
// ranks the digits' significance by prefix sums, builds the value as a
// positional multiply-reduce into eight 32-bit limbs and pads it in two
// 40-step loops over all rows. Here one thread walks its row: the grammar
// (ws* sign? digits* ('.' digits*)? ([eE] sign? digits*)? ws*, trailing
// whitespace from the mantissa or right after the 'e'), the exponent in
// int64 against the storage bounds and clamped to +-2^40, then the digits
// in order, each significant once a nonzero digit is seen or its ordinal
// passes the point, accumulated while fewer than `precision` significant
// ones are in and the scale's last digit is not passed; HALF_UP on the next
// digit, the carry into a power of ten growing the digit count; the zero
// padding to the point and out to the scale, each step checked against the
// bound, and the precision check. The magnitude stays below 10^38 before
// the padding and below the bound (< 2^127) after each step, so two u64
// words hold it, a step checked as mag > bound / 10 before it multiplies.
//
// A row the cast rejects writes 0 and its validity off, as the plain
// version does; the ANSI error flag is valid-in and not valid.
//
// What bounds it on this card: bytes (offsets, validity and chars read;
// 4, 8 or 16 bytes of value, validity and, under ANSI, a flag written); a few integer
// instructions a char and a u128 multiply-add a digit.
//
// Plain C++ without nvcc: `host_to_decimal` loops over rows as the kernel
// does (tests/test_torch_cast_decimal.py).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CD_FN __host__ __device__ __forceinline__
#else
#define CD_FN static inline
#endif

#define THREADS 256

typedef unsigned long long u64;

CD_FN u64 cd_mulhi(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return static_cast<u64>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

struct U128 {
  u64 lo, hi;
};

CD_FN bool cd_gt(U128 a, U128 b) {
  return a.hi != b.hi ? a.hi > b.hi : a.lo > b.lo;
}
CD_FN bool cd_eq(U128 a, U128 b) { return a.hi == b.hi && a.lo == b.lo; }

// a * 10 + d, for a * 10 + d < 2^128
CD_FN U128 cd_mul10_add(U128 a, u64 d) {
  U128 r;
  r.lo = a.lo * 10;
  const u64 carry_mul = cd_mulhi(a.lo, 10);
  r.hi = a.hi * 10 + carry_mul;
  const u64 lo = r.lo + d;
  r.hi += lo < r.lo ? 1 : 0;
  r.lo = lo;
  return r;
}

CD_FN U128 cd_add1(U128 a) {
  U128 r = {a.lo + 1, a.hi};
  if (r.lo == 0) r.hi += 1;
  return r;
}

// bound / 10, rounded down
CD_FN U128 cd_div10(U128 a) {
  // long division over 32-bit pieces
  uint32_t w[4] = {static_cast<uint32_t>(a.lo),
                   static_cast<uint32_t>(a.lo >> 32),
                   static_cast<uint32_t>(a.hi),
                   static_cast<uint32_t>(a.hi >> 32)};
  u64 r = 0;
  for (int i = 3; i >= 0; --i) {
    const u64 acc = (r << 32) | w[i];
    w[i] = static_cast<uint32_t>(acc / 10);
    r = acc % 10;
  }
  U128 q = {w[0] | (static_cast<u64>(w[1]) << 32),
            w[2] | (static_cast<u64>(w[3]) << 32)};
  return q;
}

// v is 10^k for some k in [1, 38] (the plain version tries k up to 39;
// 10^39 is past every bound, and past 128 bits)
CD_FN bool cd_is_pow10(U128 v) {
  U128 p = {10, 0};
  for (int k = 1; k <= 38; ++k) {
    if (cd_eq(v, p)) return true;
    p = cd_mul10_add(p, 0);
  }
  return false;
}

CD_FN bool cd_ws(int c) { return c == 32 || c == 13 || c == 9 || c == 10; }
CD_FN bool cd_digit(int c) { return c >= 48 && c <= 57; }

struct DecParams {
  int precision, scale, strip;
  U128 bound_pos, bound_neg;   // the storage's largest value, |smallest|
  u64 emax, emin_mag;          // the exponent's bounds (int64 at most)
};

// -> validity; *out the signed value's two's complement low 128 bits
CD_FN bool cd_row(const uint8_t* s, int len, const DecParams& p, U128* out) {
  out->lo = out->hi = 0;
  int i0 = 0;
  if (p.strip) {
    i0 = len;
    for (int i = 0; i < len; ++i)
      if (!cd_ws(s[i])) {
        i0 = i;
        break;
      }
  }
  const bool has_sign = i0 < len && (s[i0] == '+' || s[i0] == '-');
  const bool positive = !(has_sign && s[i0] == '-');
  const int istart = i0 + (has_sign ? 1 : 0);
  if (len <= 0 || istart >= len) return false;

  // the grammar over [istart, len)
  int e_idx = len, fw = len;
  for (int i = istart; i < len; ++i)
    if (s[i] == 'e' || s[i] == 'E') {
      e_idx = i;
      break;
    }
  for (int i = istart; i < len; ++i)
    if (cd_ws(s[i])) {
      if (!p.strip) return false;
      fw = i;
      break;
    }
  const int mant_end = e_idx < fw ? e_idx : fw;
  int dots = 0, dot_idx = len;
  for (int i = istart; i < mant_end; ++i)
    if (s[i] == '.' && dots++ == 0) dot_idx = i;
  const bool has_dot = dots == 1;
  const bool has_e = e_idx < len;
  const int ce = e_idx + 1 < len ? s[e_idx + 1] : 0;
  const bool e_sign = (ce == '+' || ce == '-') && has_e && e_idx + 1 < len;
  const bool exp_positive = !(e_sign && ce == '-');
  const int estart = e_idx + 1 + (e_sign ? 1 : 0);
  if (!(fw >= len || (fw == mant_end && fw > istart) || fw == e_idx + 1))
    return false;
  if (dots > 1) return false;
  for (int i = istart; i < len; ++i) {
    const int c = s[i];
    if (i >= fw) {
      if (!cd_ws(c)) return false;
      continue;
    }
    if (!(cd_digit(c) || i == dot_idx || i == e_idx ||
          (i == e_idx + 1 && e_sign)))
      return false;
  }

  // the exponent, in int64, against the storage bounds
  const int eend = fw < len ? fw : len;
  int e_nd_eff = 0;
  bool e_seen_nz = false;
  u64 emag = 0;
  for (int i = estart; i < eend; ++i) {
    if (!cd_digit(s[i])) continue;
    e_seen_nz |= s[i] != '0';
    if (e_seen_nz) ++e_nd_eff;
    emag = emag * 10 + static_cast<u64>(s[i] - '0');
  }
  if (e_nd_eff > 19) return false;
  if (exp_positive ? emag > p.emax : emag > p.emin_mag) return false;
  long long exp_val = static_cast<long long>(exp_positive ? emag : 0 - emag);
  const long long clamp = 1LL << 40;
  if (exp_val > clamp) exp_val = clamp;
  if (exp_val < -clamp) exp_val = -clamp;

  // the digits of the mantissa, in order
  long long dl = (has_dot ? dot_idx - istart : mant_end - istart) + exp_val;
  const long long last_digit_cnt = dl + p.scale;
  long long kidx = 0, np_before = 0, nd_acc = 0, np_final = 0;
  long long sig_before_in_string = 0;
  bool anynz = false, has_round = false, stopped = false;
  int round_digit = 0;
  U128 mag = {0, 0};
  for (int i = istart; i < mant_end; ++i) {
    const int c = s[i];
    if (!cd_digit(c)) continue;
    anynz |= c != '0';
    const bool sig = (kidx + 1 > dl) || anynz;
    const bool acc = !stopped && np_before < p.precision &&
                     kidx < last_digit_cnt;
    if (acc) {
      mag = cd_mul10_add(mag, static_cast<u64>(c - '0'));
      ++nd_acc;
      if (sig) ++np_final;
    } else if (!stopped) {
      stopped = true;
      has_round = last_digit_cnt >= 0;
      round_digit = c - '0';
    }
    if (kidx < dl && anynz) ++sig_before_in_string;
    if (sig) ++np_before;
    ++kidx;
  }
  const U128 bound = positive ? p.bound_pos : p.bound_neg;
  if (cd_gt(mag, bound)) return false;

  // HALF_UP on the next digit; a carry into a power of ten grows the count
  long long grew = 0;
  if (has_round && round_digit >= 5) {
    const U128 r = cd_add1(mag);
    if (cd_gt(r, bound)) return false;
    if (!(mag.lo == 0 && mag.hi == 0) && cd_is_pow10(r)) grew = 1;
    mag = r;
  }
  const long long total_digits = nd_acc + grew;
  np_final += grew;
  dl += grew;

  // zero padding and the precision checks
  const long long cudf_scale = -p.scale;
  const long long sig_preceding_zeros = dl < 0 ? -dl : 0;
  long long ztd = dl - total_digits - (cudf_scale > 0 ? cudf_scale : 0);
  if (ztd < 0) ztd = 0;
  const long long sig_before_decimal = sig_before_in_string + ztd + grew;
  if (p.precision + cudf_scale < sig_before_decimal) return false;
  if (ztd > 39) return false;
  const U128 tenth = cd_div10(bound);
  for (long long k = 0; k < ztd; ++k) {
    if (cd_gt(mag, tenth)) return false;
    mag = cd_mul10_add(mag, 0);
  }
  np_final += ztd;
  const long long digits_after = np_final - sig_before_decimal +
                                 sig_preceding_zeros;
  long long digits_needed = p.precision - sig_before_decimal;
  if (p.scale < digits_needed) digits_needed = p.scale;
  long long pad2 = digits_needed - digits_after;
  if (pad2 < 0) pad2 = 0;
  if (pad2 > 39) return false;
  for (long long k = 0; k < pad2; ++k) {
    if (cd_gt(mag, tenth)) return false;
    mag = cd_mul10_add(mag, 0);
  }
  if (positive) {
    *out = mag;
  } else {                         // two's complement: ~mag + 1
    U128 inv = {~mag.lo, ~mag.hi};
    *out = cd_add1(inv);
  }
  return true;
}

struct DecArgs {
  const int32_t* offsets;
  const uint8_t* chars;
  const uint8_t* valid_in;
  int out_bytes;                 // 4, 8 or 16
  DecParams p;
  void* out;
  uint8_t* valid_out;
  uint8_t* err;                  // null: not ANSI
};

CD_FN void cd_store(const DecArgs& a, long long i) {
  const int start = a.offsets[i];
  const int len = a.offsets[i + 1] - start;
  const bool vin = a.valid_in == nullptr || a.valid_in[i] != 0;
  U128 v;
  const bool ok = cd_row(a.chars + start, len, a.p, &v) && vin;
  if (!ok) v.lo = v.hi = 0;
  if (a.out_bytes == 4) {
    static_cast<int32_t*>(a.out)[i] = static_cast<int32_t>(v.lo);
  } else if (a.out_bytes == 8) {
    static_cast<long long*>(a.out)[i] = static_cast<long long>(v.lo);
  } else {
    u64* o = static_cast<u64*>(a.out) + 2 * i;
    o[0] = v.lo;
    o[1] = v.hi;
  }
  a.valid_out[i] = ok;
  if (a.err != nullptr) a.err[i] = vin && !ok;
}

static DecArgs cd_args(const void* offsets, const void* chars,
                       const void* valid_in, int out_bytes, int precision,
                       int scale, int strip, void* out, void* valid_out,
                       void* err) {
  DecArgs a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<const uint8_t*>(chars);
  a.valid_in = static_cast<const uint8_t*>(valid_in);
  a.out_bytes = out_bytes;
  a.p.precision = precision;
  a.p.scale = scale;
  a.p.strip = strip;
  const int bits = 8 * out_bytes;
  if (bits == 128) {
    a.p.bound_pos.lo = ~0ULL;
    a.p.bound_pos.hi = (1ULL << 63) - 1;
    a.p.bound_neg.lo = 0;
    a.p.bound_neg.hi = 1ULL << 63;
    a.p.emax = (1ULL << 63) - 1;
    a.p.emin_mag = 1ULL << 63;
  } else {
    a.p.bound_pos.lo = (1ULL << (bits - 1)) - 1;
    a.p.bound_pos.hi = 0;
    a.p.bound_neg.lo = 1ULL << (bits - 1);
    a.p.bound_neg.hi = 0;
    a.p.emax = a.p.bound_pos.lo;
    a.p.emin_mag = a.p.bound_neg.lo;
  }
  a.out = out;
  a.valid_out = static_cast<uint8_t*>(valid_out);
  a.err = static_cast<uint8_t*>(err);
  return a;
}

static bool cd_args_ok(const DecArgs& a, long long n) {
  return n >= 1 && a.offsets != nullptr && a.out != nullptr &&
         a.valid_out != nullptr &&
         (a.out_bytes == 4 || a.out_bytes == 8 || a.out_bytes == 16) &&
         a.p.precision >= 1 && a.p.precision <= 38;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
cast_decimal_kernel(DecArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    cd_store(a, i);
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

// n >= 1 rows. offsets: (n + 1,) int32; chars: uint8; valid_in: (n,) bool
// or null; out: (n,) int32, (n,) int64 or (n, 4) u32 limbs (16-byte rows)
// by out_bytes; valid_out: (n,) bool; err: (n,) bool, or null but for
// ANSI.
int cd_to_decimal(const void* offsets, const void* chars,
                  const void* valid_in, long long n, int out_bytes,
                  int precision, int scale, int strip, void* out,
                  void* valid_out, void* err, void* stream) {
  const DecArgs a = cd_args(offsets, chars, valid_in, out_bytes, precision,
                            scale, strip, out, valid_out, err);
  if (!cd_args_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  cast_decimal_kernel<<<blocks_for(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_to_decimal(const void* offsets, const void* chars,
                               const void* valid_in, long long n,
                               int out_bytes, int precision, int scale,
                               int strip, void* out, void* valid_out,
                               void* err) {
  const DecArgs a = cd_args(offsets, chars, valid_in, out_bytes, precision,
                            scale, strip, out, valid_out, err);
  if (!cd_args_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) cd_store(a, i);
  return 0;
}

#endif  // __CUDACC__
