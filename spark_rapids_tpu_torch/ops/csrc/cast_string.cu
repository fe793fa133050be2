// Spark-exact string -> INT8/16/32/64 (with `strip` and ANSI mode) and
// `conv`'s string -> integer in base 10 or 16, for Hopper (sm_90a): one
// thread a row over a STRING column's offsets and chars.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/cast_string.py
// (`string_to_integer` :99, `string_to_integer_with_base` :400; no
// pallas_call). The reference's own CUDA is cast_string.cu:158-244 and
// CastStringJni.cpp:159-258, one thread a row as here. The JAX design pads
// the column into an (n, L) char matrix (a host read of the longest string
// first) and turns every rule into boolean planes over it, a dozen n x L x 4
// byte planes a call. Here each row walks its own bytes once, through the
// offsets, and every rule of the JAX algebra becomes the same predicate on
// that walk: the first non-whitespace byte, the sign, one pass that rejects
// a byte outside digits, '.' and whitespace and tracks the first
// whitespace and dots, the run of digits up to the first '.', and the
// digits after the leading zeros accumulated in u64 (more than 19 of them
// always overflow). The base conversion takes the JAX wrap of
// `pow(base, k, 2**64)` as the sequential val * base + d mod 2^64.
//
// A row the cast rejects writes 0 and its validity off, as the plain
// version (ops/cast_string.py `*_plain`) writes it; the ANSI error flag is
// valid-in and not valid.
//
// What bounds it on this card: bytes. A row reads its two offsets (8 B),
// its validity (1 B) and its chars, and writes its value, validity and,
// under ANSI, its flag; a handful of integer instructions a char. Rows of different lengths
// leave a warp's threads idle at the tail of the longest; for numbers
// (under 32 bytes) that costs less than the reads.
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_*` below loop over rows as the kernel does, so that
// tests/test_torch_cast_string.py builds this file with the host compiler
// and holds it against the plain version.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// none synchronises or allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CS_FN __host__ __device__ __forceinline__
#else
#define CS_FN static inline
#endif

#define THREADS 256

typedef unsigned long long u64;

CS_FN bool cs_ws4(int c) { return c == 32 || c == 13 || c == 9 || c == 10; }
CS_FN bool cs_digit(int c) { return c >= 48 && c <= 57; }

// string -> integer: the value's int64 bits (0 where invalid) and the
// validity. tmax: the type's largest value; tmin_mag: -(smallest).
CS_FN bool cs_row_to_integer(const uint8_t* s, int len, bool strip,
                             bool ansi, u64 tmax, u64 tmin_mag,
                             long long* out) {
  *out = 0;
  int i0 = 0;
  if (strip) {
    i0 = len;
    for (int i = 0; i < len; ++i)
      if (!cs_ws4(s[i])) {
        i0 = i;
        break;
      }
  }
  const bool has_sign = i0 < len && (s[i0] == '+' || s[i0] == '-');
  const bool neg = has_sign && s[i0] == '-';
  const int istart = i0 + (has_sign ? 1 : 0);
  if (len <= 0 || istart >= len) return false;
  int fw = len, first_dot = len, ndots = 0;
  for (int i = istart; i < len; ++i) {
    const int c = s[i];
    if (cs_ws4(c)) {
      if (!strip) return false;
      if (fw == len) fw = i;
    } else {
      if (fw != len) return false;        // non-whitespace after trailing ws
      if (c == '.') {
        if (ansi) return false;
        if (ndots++ == 0) first_dot = i;
      } else if (!cs_digit(c)) {
        return false;
      }
    }
  }
  if (strip && fw == istart) return false;
  if (ndots > 1) return false;
  int dend = first_dot < fw ? first_dot : fw;
  int first_nz = dend;
  for (int i = istart; i < dend; ++i)
    if (s[i] != '0') {
      first_nz = i;
      break;
    }
  if (dend - first_nz > 19) return false;
  u64 mag = 0;
  for (int i = first_nz; i < dend; ++i) mag = mag * 10 + (s[i] - '0');
  if (neg ? mag > tmin_mag : mag > tmax) return false;
  *out = static_cast<long long>(neg ? 0 - mag : mag);
  return true;
}

// `conv`: ^\s*(-?[0-9a-fA-F]+).* in base 10 or 16, mod 2^64; a row that
// does not match is 0, a whitespace-only (or empty) row invalid.
CS_FN bool cs_row_to_integer_base(const uint8_t* s, int len, int base,
                                  long long* out) {
  *out = 0;
  int i0 = len;
  for (int i = 0; i < len; ++i) {
    const int c = s[i];
    if (!(cs_ws4(c) || c == 12 || c == 11)) {
      i0 = i;
      break;
    }
  }
  if (i0 == len) return false;            // empty or only whitespace
  const bool neg = s[i0] == '-';
  u64 mag = 0;
  int i = i0 + (neg ? 1 : 0);
  const int istart = i;
  for (; i < len; ++i) {
    const int c = s[i];
    int d;
    if (cs_digit(c))
      d = c - '0';
    else if (base == 16 && c >= 'a' && c <= 'f')
      d = c - 'a' + 10;
    else if (base == 16 && c >= 'A' && c <= 'F')
      d = c - 'A' + 10;
    else
      break;
    mag = mag * static_cast<u64>(base) + static_cast<u64>(d);
  }
  if (i > istart) *out = static_cast<long long>(neg ? 0 - mag : mag);
  return true;
}

CS_FN void cs_store(void* out, int bytes, long long i, long long v) {
  switch (bytes) {
    case 1: static_cast<int8_t*>(out)[i] = static_cast<int8_t>(v); break;
    case 2: static_cast<int16_t*>(out)[i] = static_cast<int16_t>(v); break;
    case 4: static_cast<int32_t*>(out)[i] = static_cast<int32_t>(v); break;
    default: static_cast<long long*>(out)[i] = v;
  }
}

struct IntArgs {
  const int32_t* offsets;
  const uint8_t* chars;
  const uint8_t* valid_in;    // null: every row valid
  int out_bytes;
  int strip, ansi, base;      // base 0: the Spark cast, else `conv`
  u64 tmax, tmin_mag;
  void* out;
  uint8_t* valid_out;
  uint8_t* err;               // the cast under ANSI only, else null
};

CS_FN void cs_row(const IntArgs& a, long long i) {
  const int start = a.offsets[i];
  const int len = a.offsets[i + 1] - start;
  const bool vin = a.valid_in == nullptr || a.valid_in[i] != 0;
  long long v = 0;
  bool ok;
  if (a.base == 0)
    ok = cs_row_to_integer(a.chars + start, len, a.strip != 0, a.ansi != 0,
                           a.tmax, a.tmin_mag, &v);
  else
    ok = cs_row_to_integer_base(a.chars + start, len, a.base, &v);
  ok = ok && vin;
  cs_store(a.out, a.out_bytes, i, ok ? v : 0);
  a.valid_out[i] = ok;
  if (a.err != nullptr) a.err[i] = vin && !ok;
}

static bool cs_args_ok(const IntArgs& a, long long n) {
  return n >= 1 && a.offsets != nullptr && a.out != nullptr &&
         a.valid_out != nullptr &&
         (a.out_bytes == 1 || a.out_bytes == 2 || a.out_bytes == 4 ||
          a.out_bytes == 8) &&
         (a.base == 0 || a.base == 10 || a.base == 16);
}

static IntArgs cs_args(const void* offsets, const void* chars,
                       const void* valid_in, int out_bytes, int strip,
                       int ansi, int base, void* out, void* valid_out,
                       void* err) {
  IntArgs a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<const uint8_t*>(chars);
  a.valid_in = static_cast<const uint8_t*>(valid_in);
  a.out_bytes = out_bytes;
  a.strip = strip;
  a.ansi = ansi;
  a.base = base;
  const int bits = 8 * out_bytes;
  a.tmax = (1ULL << (bits - 1)) - 1;
  a.tmin_mag = 1ULL << (bits - 1);
  a.out = out;
  a.valid_out = static_cast<uint8_t*>(valid_out);
  a.err = static_cast<uint8_t*>(err);
  return a;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
cast_int_kernel(IntArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    cs_row(a, i);
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
// or null; out: (n,) of out_bytes each; valid_out, err: (n,) bool (err
// null for `conv` and but for ANSI). base 0: the Spark cast, 10 or 16: `conv`.
int cs_to_integer(const void* offsets, const void* chars,
                  const void* valid_in, long long n, int out_bytes,
                  int strip, int ansi, int base, void* out, void* valid_out,
                  void* err, void* stream) {
  const IntArgs a = cs_args(offsets, chars, valid_in, out_bytes, strip, ansi,
                            base, out, valid_out, err);
  if (!cs_args_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  cast_int_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_to_integer(const void* offsets, const void* chars,
                               const void* valid_in, long long n,
                               int out_bytes, int strip, int ansi, int base,
                               void* out, void* valid_out, void* err) {
  const IntArgs a = cs_args(offsets, chars, valid_in, out_bytes, strip, ansi,
                            base, out, valid_out, err);
  if (!cs_args_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) cs_row(a, i);
  return 0;
}

#endif  // __CUDACC__
