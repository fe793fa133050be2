// Spark-exact string -> FLOAT32/64 for Hopper (sm_90a): one thread a row
// over a STRING column's offsets and chars.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/cast_string.py
// (`string_to_float` :224; no pallas_call). The reference's own CUDA is
// cast_string_to_float.cu:56-653 (a warp a row). The JAX design pads the
// column into an (n, L) char matrix and builds every quantity of the parse
// (sign, 'nan'/'inf', the mantissa's end, the dots, the zeros stripped, the
// first 19 digits and a guarded 20th, the 4-digit exponent, the suffix and
// trailing whitespace) as boolean and integer planes; here one thread
// computes the same quantities on one walk of its row's bytes, predicate
// for predicate, and then the value exactly as the JAX package writes it in
// float64: sign * digits, divided or multiplied by a correctly rounded
// power of ten from `pow10` (a table the wrapper passes, 10^-350..10^350),
// and for exponents below -307 the two-step subnormal path with
// floor(log10(d)) + 1 read off `steps` (where the JAX package's log10
// turns, ops/cast_string.py LOG10_STEPS). Two effects of the JAX package on
// the CPU are kept: results below DBL_MIN flush to a signed zero (x86's
// FTZ, judged after rounding), and FLOAT32 is the float64 rounded once
// more, a result below FLT_MIN flushed the same way. NaN is 0x7ff8... in
// float64 and 0x7fc00000 in float32. Built with -fmad=false (cuda_build),
// though no product here feeds an add.
//
// A row the cast rejects writes 0 and its validity off; the ANSI error
// flag follows the JAX package: 'inf' with junk after it is invalid
// without an error.
//
// What bounds it on this card: bytes, as for the integer cast (offsets,
// validity and chars read; value, validity and, under ANSI, a flag
// written), plus two float64 divides or multiplies a row.
//
// Plain C++ without nvcc: `host_to_float` loops over rows as the kernel
// does (tests/test_torch_cast_string.py).

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CF_FN __host__ __device__ __forceinline__
#else
#define CF_FN static inline
#endif

#define THREADS 256
#define P10_MIN (-350)
#define P10_MAX 350
#define NSTEPS 19

typedef unsigned long long u64;

static const u64 MAX_HOLDING = (18446744073709551615ULL - 9) / 10;
#define DBL_MIN_ 2.2250738585072014e-308
#define FLT_MIN_ 1.1754943508222875e-38
#define TWO64 18446744073709551616.0

CF_FN bool cf_ws(int c) { return c == 32 || c == 13 || c == 9 || c == 10; }
CF_FN bool cf_digit(int c) { return c >= 48 && c <= 57; }

// the row's byte at i, 0 past its end (the plain version's padding)
CF_FN int cf_at(const uint8_t* s, int len, int i) {
  return (i >= 0 && i < len) ? s[i] : 0;
}

CF_FN bool cf_ci(const uint8_t* s, int len, int start, const char* w,
                 int wn) {
  for (int k = 0; k < wn; ++k) {
    const int c = cf_at(s, len, start + k);
    if (!(start + k < len && (c == w[k] || c == w[k] - 32))) return false;
  }
  return true;
}

CF_FN int cf_skip_ws(const uint8_t* s, int len, int start) {
  for (int i = start < 0 ? 0 : start; i < len; ++i)
    if (!cf_ws(s[i])) return i;
  return len;
}

CF_FN double cf_pow10(const double* pow10, long long k) {
  long long i = k - P10_MIN;
  if (i < 0) i = 0;
  if (i > P10_MAX - P10_MIN) i = P10_MAX - P10_MIN;
  return pow10[i];
}

CF_FN double cf_u64_to_f64(u64 v) {
#ifdef __CUDA_ARCH__
  return __ull2double_rn(v);
#else
  return static_cast<double>(v);
#endif
}

// a * b, a result below DBL_MIN after rounding flushed to a signed zero:
// the product taken again 2^64 higher shows its rounding
CF_FN double cf_ftz_mul(double a, double b) {
  const double r = a * b;
  const double high = (a * TWO64) * b;
  return fabs(high) < DBL_MIN_ * TWO64 ? copysign(0.0, r) : r;
}

struct FloatResult {
  double value;
  bool valid, except;
};

CF_FN FloatResult cf_row(const uint8_t* s, int len, bool valid_in,
                         const double* pow10, const double* steps) {
  FloatResult out = {0.0, false, false};
  const int i0 = cf_skip_ws(s, len, 0);
  const int c0 = cf_at(s, len, i0);
  const bool has_sign = (c0 == '+' || c0 == '-') && i0 < len;
  const bool neg = has_sign && c0 == '-';
  const double sign = neg ? -1.0 : 1.0;
  const int p0 = i0 + (has_sign ? 1 : 0);

  const bool starts_nan = cf_ci(s, len, p0, "nan", 3);
  const bool inf3 = !starts_nan && cf_ci(s, len, p0, "inf", 3);
  const bool inf8 = inf3 && cf_ci(s, len, p0 + 3, "inity", 5);
  const bool inf_valid = (inf3 && p0 + 3 == len) || (inf8 && p0 + 8 == len);

  // the mantissa [p0, term): digits and dots
  int term = len;
  for (int i = p0; i < len; ++i)
    if (!cf_digit(s[i]) && s[i] != '.') {
      term = i;
      break;
    }
  int dots = 0, dot_idx = len;
  for (int i = p0; i < term; ++i)
    if (s[i] == '.' && dots++ == 0) dot_idx = i;
  bool stray_dot = false;
  for (int i = term; i < len; ++i) stray_dot |= s[i] == '.';
  const bool multi_dot = dots > 1;
  const bool has_dot = dots == 1;
  const int predot_end = dot_idx < term ? dot_idx : term;
  int first_nz = predot_end;
  for (int i = p0; i < predot_end; ++i)
    if (s[i] != '0') {
      first_nz = i;
      break;
    }
  const int z = first_nz - p0;
  const int a1 = predot_end - first_nz;
  const int a2 = has_dot ? term - dot_idx - 1 : 0;
  const int total_digits = a1 + a2;
  const bool seen_digit = z > 0 || total_digits > 0;

  // the first 19 counted digits, then a guarded 20th
  u64 dval19 = 0, d20 = 0;
  int counted = 0;
  for (int i = first_nz; i < term; ++i) {
    if (!cf_digit(s[i])) continue;
    if (counted < 19)
      dval19 = dval19 * 10 + static_cast<u64>(s[i] - '0');
    else if (counted == 19)
      d20 = static_cast<u64>(s[i] - '0');
    ++counted;
  }
  const int k19 = counted < 19 ? counted : 19;
  const u64 ext = dval19 * 10 + d20;
  const bool extra_ok = counted >= 20 && dval19 <= MAX_HOLDING &&
                        ext <= MAX_HOLDING;
  const u64 dval = extra_ok ? ext : dval19;
  const int absorbed = k19 + (extra_ok ? 1 : 0);
  const int exp_base = (total_digits - absorbed) -
                       (has_dot ? total_digits - a1 : 0);
  const bool zero_mantissa = dval == 0;

  // the exponent: at most 4 digits
  const int ct = cf_at(s, len, term);
  const bool has_e = term < len && (ct == 'e' || ct == 'E');
  const int ce = cf_at(s, len, term + 1);
  const bool e_sign = (ce == '+' || ce == '-') && has_e && term + 1 < len;
  const bool e_neg = e_sign && ce == '-';
  const int estart = term + 1 + (e_sign ? 1 : 0);
  int nd = 0, ev = 0;
  for (int k = 0; k < 4; ++k) {
    const int ck = cf_at(s, len, estart + k);
    if (cf_digit(ck) && estart + k < len && nd == k) {
      ev = ev * 10 + (ck - '0');
      ++nd;
    }
  }
  const int manual_exp = e_neg ? -ev : ev;
  const bool exp_invalid = has_e && nd == 0;
  const int after_exp = has_e ? estart + nd : term;
  const int cq = cf_at(s, len, after_exp);
  const bool has_suffix = (cq == 'f' || cq == 'F' || cq == 'd' || cq == 'D') &&
                          after_exp < len;
  const bool trailing_junk =
      cf_skip_ws(s, len, after_exp + (has_suffix ? 1 : 0)) < len;
  const bool zero_junk = cf_skip_ws(s, len, after_exp) < len;

  const bool junk = zero_mantissa ? zero_junk : trailing_junk;
  const bool number_valid = !multi_dot && !stray_dot && seen_digit &&
                            !exp_invalid && !junk;
  const bool number_except = multi_dot || stray_dot || !seen_digit ||
                             exp_invalid || junk;
  out.valid = valid_in &&
              (starts_nan ? len == 3 : (inf3 ? inf_valid : number_valid));
  out.except = valid_in &&
               (starts_nan ? len != 3 : (inf3 ? false : number_except));
  if (!out.valid) return out;

  // the value in float64, as the JAX package builds it
  double result;
  const double inf = sign * INFINITY;
  if (starts_nan) {
    u64 bits = 0x7ff8000000000000ULL;
    memcpy(&result, &bits, 8);
  } else if (inf3) {
    result = inf;
  } else if (zero_mantissa) {
    result = sign * 0.0;
  } else {
    const double digitsf = sign * cf_u64_to_f64(dval);
    const long long exp_ten = static_cast<long long>(exp_base) + manual_exp;
    if (exp_ten > 308) {
      result = inf;
    } else {
      const long long shift = -307 - exp_ten;
      if (shift > 0) {
        const double d = cf_u64_to_f64(dval);
        int nd10 = 1;
        for (int k = 0; k < NSTEPS; ++k) nd10 += d >= steps[k] ? 1 : 0;
        result = cf_ftz_mul(digitsf / cf_pow10(pow10, nd10 - 1 + shift),
                            cf_pow10(pow10, exp_ten + nd10 - 1 + shift));
      } else {
        const long long e = exp_ten < 0 ? -exp_ten : exp_ten;
        const double expf = cf_pow10(pow10, e);
        result = exp_ten < 0 ? digitsf / expf : digitsf * expf;
      }
    }
  }
  out.value = result;
  return out;
}

// float64 -> float32 as the JAX package on the CPU rounds it: NaN to
// 0x7fc00000, a result below FLT_MIN after rounding to a signed zero
CF_FN float cf_to_f32(double r) {
  if (r != r) {
    const uint32_t bits = 0x7fc00000u;
    float f;
    memcpy(&f, &bits, 4);
    return f;
  }
  if (fabs(r) < FLT_MIN_ * (1.0 - 1.0 / 33554432.0))
    return copysign(0.0f, static_cast<float>(r));
  return static_cast<float>(r);
}

struct FloatArgs {
  const int32_t* offsets;
  const uint8_t* chars;
  const uint8_t* valid_in;
  const double* pow10;        // 701 entries: 10^-350 .. 10^350
  const double* steps;        // NSTEPS entries
  int is32;
  void* out;
  uint8_t* valid_out;
  uint8_t* err;               // null: not ANSI
};

CF_FN void cf_store(const FloatArgs& a, long long i) {
  const int start = a.offsets[i];
  const int len = a.offsets[i + 1] - start;
  const bool vin = a.valid_in == nullptr || a.valid_in[i] != 0;
  const FloatResult r = cf_row(a.chars + start, len, vin, a.pow10, a.steps);
  if (a.is32)
    static_cast<float*>(a.out)[i] = cf_to_f32(r.value);
  else
    static_cast<double*>(a.out)[i] = r.value;
  a.valid_out[i] = r.valid;
  if (a.err != nullptr) a.err[i] = r.except && !r.valid;
}

static FloatArgs cf_args(const void* offsets, const void* chars,
                         const void* valid_in, const void* pow10,
                         const void* steps, int is32, void* out,
                         void* valid_out, void* err) {
  FloatArgs a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<const uint8_t*>(chars);
  a.valid_in = static_cast<const uint8_t*>(valid_in);
  a.pow10 = static_cast<const double*>(pow10);
  a.steps = static_cast<const double*>(steps);
  a.is32 = is32;
  a.out = out;
  a.valid_out = static_cast<uint8_t*>(valid_out);
  a.err = static_cast<uint8_t*>(err);
  return a;
}

static bool cf_args_ok(const FloatArgs& a, long long n) {
  return n >= 1 && a.offsets != nullptr && a.pow10 != nullptr &&
         a.steps != nullptr && a.out != nullptr && a.valid_out != nullptr;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
cast_float_kernel(FloatArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    cf_store(a, i);
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
// or null; pow10: 701 float64; steps: 19 float64; out: (n,) float32 or
// float64; valid_out: (n,) bool; err: (n,) bool, or null but for ANSI.
int cf_to_float(const void* offsets, const void* chars, const void* valid_in,
                long long n, const void* pow10, const void* steps, int is32,
                void* out, void* valid_out, void* err, void* stream) {
  const FloatArgs a = cf_args(offsets, chars, valid_in, pow10, steps, is32,
                              out, valid_out, err);
  if (!cf_args_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  cast_float_kernel<<<blocks_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_to_float(const void* offsets, const void* chars,
                             const void* valid_in, long long n,
                             const void* pow10, const void* steps, int is32,
                             void* out, void* valid_out, void* err) {
  const FloatArgs a = cf_args(offsets, chars, valid_in, pow10, steps, is32,
                              out, valid_out, err);
  if (!cf_args_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) cf_store(a, i);
  return 0;
}

#endif  // __CUDACC__
