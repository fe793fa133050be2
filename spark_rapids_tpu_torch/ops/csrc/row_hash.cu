// Spark row hash for Hopper (sm_90a): murmur3_32 and/or xxhash64 of every
// row of a table, chained over its columns, for every kind Spark hashes:
// fixed-width values, strings, DECIMAL128 and (murmur3 only) lists, with
// structs flattened into their fields by the wrapper.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/ops/hash_pallas.py
// (`_hash_kernel_body`, launched by `_run_custom` for
// `murmur_hash3_32_pallas`, `xxhash64_pallas` and `fused_row_hash`), and the
// reference's byte path, which is XLA there, not Pallas (ops/hash.py
// `_mm_var` :85, `_xx_var` :178, `java_bigdecimal_bytes` :342,
// `_murmur_element` :408), and computes what they compute:
//
// - Per row, h starts at the seed (or at the running hash a previous launch
//   wrote, for tables of more than MAX_COLS leaf columns) and each column in
//   turn updates it; a null value leaves h unchanged.
// - Fixed-width values are encoded in-kernel as Spark hashes them: 1/2/4-byte
//   ints, bool and date32 as 4 bytes sign-extended; int64, timestamp_us and
//   decimal32/64 as 8 bytes sign-extended; float32/64 by their bits, every
//   NaN the canonical quiet NaN (0x7FC00000 / 0x7FF8000000000000); xxhash64
//   also folds -0.0 into +0.0, murmur3 does not (hash_pallas.py:308-309).
//   murmur3_32: one round per 4-byte word, then fmix(h ^ nbytes); xxhash64:
//   the small fixed-width path of xxhash64.cu.
// - A STRING hashes its bytes, read through its offsets. A DECIMAL128
//   hashes the minimal big-endian two's complement bytes of a Java
//   BigDecimal's unscaled value (1 to 16 bytes), built from its two 64-bit
//   halves in registers. murmur3 hashes 4-byte little-endian blocks, then
//   each of the 0-3 tail bytes as a sign-extended signed char (Spark's
//   variant), then fmix(h ^ length); xxhash64 takes 32-byte stripes from 32
//   bytes up, then 8-, 4- and 1-byte steps.
// - A LIST column (murmur3 only: Spark's xxhash64 rejects nested types)
//   carries per row the span [start, end) of its leaf elements, composed
//   through nested lists by the wrapper, and the leaf's validity: each
//   valid element in turn updates h, a null one is skipped. The row's
//   validity is the list's, ANDed with its parents'.
// - A STRUCT is not a column here: the wrapper passes its leaf fields in
//   order, each with the struct's validity ANDed into its own.
//
// One thread hashes one row (grid-stride loop) in native 64-bit integers,
// with funnel shifts for the 32-bit rotates; a string's bytes are read one
// at a time from its offset. A warp-per-long-string design is later work.
// Four kernels: the three fixed-width forms (murmur3, xxhash64, both)
// without the byte path, and `row_hash_bytes_kernel` for launches that
// hold strings, DECIMAL128 or lists, taking either or both hashes. Every
// kernel reads the columns' fields as arrays (`Cols`); the byte path's own
// fields (`ByteCols`) are a second parameter that only its kernel takes,
// so the fixed-width forms keep their parameter and code.
//
// What bounds it on this card: the bytes. A row of phase 5c's customer
// table reads 8 + 16 + 4 + (24 on average) + 4 + 1 + 16 bytes and writes 4
// (murmur3) or 8 (xxhash64): about 73 bytes, against about 130 integer
// instructions a row for murmur3 (14 rounds of 6, three fmix of 8 and the
// row's loop and loads), so at 3.35 TB/s and 16.7 T instructions/s the
// bytes take 2.6x longer. chip_smoke.py counts both bounds from each run's
// own lengths. Reading a string's bytes one at a time costs instructions,
// not bytes: neighbouring threads read neighbouring strings, so each
// sector comes from memory once.
//
// The row arithmetic (`hash_row`) is also plain C++: compiled without nvcc
// the qualifiers drop and the rotate is a shift pair, so
// tests/test_torch_hash_bytes.py builds it with the host compiler and holds
// it against the plain version.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// after its launch (or cudaErrorInvalidValue for arguments it does not
// take); it never synchronises and allocates nothing.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RH_FN __host__ __device__ __forceinline__
#define RH_MEMBER __host__ __device__ __forceinline__
#else
#define RH_FN static inline
#define RH_MEMBER inline
#endif

#define MAX_COLS 32
#define THREADS 256

enum Enc {
  ENC_INT4 = 0,    // bool, int8/16/32, date32: 4 bytes sign-extended
  ENC_INT8 = 1,    // int64, timestamp_us, decimal32/64: 8 bytes
  ENC_F32 = 2,
  ENC_F64 = 3,
  ENC_STRING = 4,  // chars through offsets
  ENC_DEC128 = 5,  // Java BigDecimal bytes of (n, 4) u32 limbs
};

// The leaf columns of a launch, the fields every kernel reads.
struct Cols {
  const void* data[MAX_COLS];            // values; STRING: chars
  const unsigned char* valid[MAX_COLS];  // torch.bool bytes; null = all valid
  int width[MAX_COLS];                   // storage bytes of a value
  int enc[MAX_COLS];                     // Enc: Spark's byte form
  int nc;
};

// The byte path's fields, read by `row_hash_bytes_kernel` only. For a
// LIST, `span_start`/`span_end` give each row's leaf elements and
// `elem_valid` the leaf's validity; `Cols` then describes the leaf.
struct ByteCols {
  const int* offsets[MAX_COLS];              // STRING: leaf rows + 1
  const int* span_start[MAX_COLS];           // LIST: (n,) first element
  const int* span_end[MAX_COLS];             // LIST: (n,) one past the last
  const unsigned char* elem_valid[MAX_COLS]; // LIST: null = all valid
};

RH_FN uint32_t rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

RH_FN uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

RH_FN int clz64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __clzll(static_cast<long long>(x));
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

// ---- murmur3_32 (Spark) ------------------------------------------------------

RH_FN uint32_t mm_round(uint32_t h, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h ^= k1;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

RH_FN uint32_t mm_fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Bytes [0, len) of `s` (s(i) is byte i): 4-byte little-endian blocks,
// then the tail bytes one at a time as signed chars (murmur_hash.cuh:74-93).
template <class Src>
RH_FN uint32_t mm_bytes(uint32_t h, const Src& s, int len) {
  const int nblocks = len / 4;
  for (int b = 0; b < nblocks; ++b) {
    const int o = 4 * b;
    h = mm_round(h, s(o) | (s(o + 1) << 8) | (s(o + 2) << 16) |
                        (s(o + 3) << 24));
  }
  for (int i = 4 * nblocks; i < len; ++i)
    h = mm_round(h, static_cast<uint32_t>(static_cast<int32_t>(
                        static_cast<int8_t>(s(i)))));
  return mm_fmix(h ^ static_cast<uint32_t>(len));
}

// ---- xxhash64 (Spark) --------------------------------------------------------

#define XX_P1 0x9E3779B185EBCA87ull
#define XX_P2 0xC2B2AE3D27D4EB4Full
#define XX_P3 0x165667B19E3779F9ull
#define XX_P4 0x85EBCA77C2B2AE63ull
#define XX_P5 0x27D4EB2F165667C5ull

RH_FN uint64_t xx_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= XX_P2;
  h ^= h >> 29;
  h *= XX_P3;
  return h ^ (h >> 32);
}

RH_FN uint64_t xx_round8(uint64_t h, uint64_t w) {
  h ^= rotl64(w * XX_P2, 31) * XX_P1;
  return rotl64(h, 27) * XX_P1 + XX_P4;
}

RH_FN uint64_t xx_round4(uint64_t h, uint64_t w) {
  h ^= w * XX_P1;
  return rotl64(h, 23) * XX_P2 + XX_P3;
}

// One 4- or 8-byte value (the zero-extended word for 4 bytes), seed h.
// Two branches with constant rotates: a select between the two rounds
// compiles to variable shifts.
RH_FN uint64_t xx_fixed(uint64_t h, uint64_t w, bool eight) {
  h += XX_P5 + (eight ? 8u : 4u);
  if (eight)
    h = xx_round8(h, w);
  else
    h = xx_round4(h, w);
  return xx_avalanche(h);
}

template <class Src>
RH_FN uint64_t le_word(const Src& s, int o, int nbytes) {
  uint64_t w = 0;
  for (int k = 0; k < nbytes; ++k)
    w |= static_cast<uint64_t>(s(o + k)) << (8 * k);
  return w;
}

RH_FN uint64_t xx_lane(uint64_t v, uint64_t w) {
  return rotl64(v + w * XX_P2, 31) * XX_P1;
}

RH_FN uint64_t xx_merge(uint64_t h, uint64_t v) {
  h ^= rotl64(v * XX_P2, 31) * XX_P1;
  return h * XX_P1 + XX_P4;
}

// Bytes [0, len) of `s`, seed h (xxhash64.cu:78-186).
template <class Src>
RH_FN uint64_t xx_bytes(uint64_t seed, const Src& s, int len) {
  int off = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + XX_P1 + XX_P2, v2 = seed + XX_P2, v3 = seed,
             v4 = seed - XX_P1;
    for (; off + 32 <= len; off += 32) {
      v1 = xx_lane(v1, le_word(s, off, 8));
      v2 = xx_lane(v2, le_word(s, off + 8, 8));
      v3 = xx_lane(v3, le_word(s, off + 16, 8));
      v4 = xx_lane(v4, le_word(s, off + 24, 8));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xx_merge(h, v1);
    h = xx_merge(h, v2);
    h = xx_merge(h, v3);
    h = xx_merge(h, v4);
  } else {
    h = seed + XX_P5;
  }
  h += static_cast<uint64_t>(len);
  for (; off + 8 <= len; off += 8) h = xx_round8(h, le_word(s, off, 8));
  if (off + 4 <= len) {
    h = xx_round4(h, le_word(s, off, 4));
    off += 4;
  }
  for (; off < len; ++off) {
    h ^= static_cast<uint64_t>(s(off)) * XX_P5;
    h = rotl64(h, 11) * XX_P1;
  }
  return xx_avalanche(h);
}

// ---- byte sources ------------------------------------------------------------

struct MemBytes {  // a string's chars
  const unsigned char* p;
  RH_MEMBER uint32_t operator()(int i) const { return p[i]; }
};

// java.math.BigDecimal.unscaledValue().toByteArray() of a two's complement
// 128-bit value: its minimal big-endian form, 1 to 16 bytes (hash.cuh:54-103).
struct DecBytes {
  uint64_t lo, hi;
  int len;
  RH_MEMBER uint32_t operator()(int i) const {
    const int k = len - 1 - i;  // little-endian byte index
    return static_cast<uint32_t>((k < 8 ? lo >> (8 * k) : hi >> (8 * (k - 8))) &
                                 0xFFu);
  }
};

RH_FN DecBytes dec_bytes(uint64_t lo, uint64_t hi) {
  // the sign needs one bit above the magnitude's: bit length / 8 + 1 bytes
  const bool neg = static_cast<int64_t>(hi) < 0;
  const uint64_t mlo = neg ? ~lo : lo, mhi = neg ? ~hi : hi;
  const int bits = mhi ? 128 - clz64(mhi) : (mlo ? 64 - clz64(mlo) : 0);
  DecBytes d = {lo, hi, bits / 8 + 1};
  return d;
}

// ---- fixed-width values ------------------------------------------------------

RH_FN long long load_int(const Cols& c, int j, long long i) {
  switch (c.width[j]) {
    case 1: return static_cast<const signed char*>(c.data[j])[i];
    case 2: return static_cast<const short*>(c.data[j])[i];
    case 4: return static_cast<const int*>(c.data[j])[i];
    default: return static_cast<const long long*>(c.data[j])[i];
  }
}

// The value Spark hashes, as its little-endian bits: the 32-bit word
// zero-extended for 4-byte forms. `fold_zero` maps -0.0 to +0.0.
RH_FN uint64_t encode(const Cols& c, int j, long long i, bool fold_zero) {
  switch (c.enc[j]) {
    case ENC_F32: {
      uint32_t b = static_cast<const uint32_t*>(c.data[j])[i];
      if ((b & 0x7FFFFFFFu) > 0x7F800000u) b = 0x7FC00000u;
      if (fold_zero && (b & 0x7FFFFFFFu) == 0u) b = 0u;
      return b;
    }
    case ENC_F64: {
      uint64_t b = static_cast<const uint64_t*>(c.data[j])[i];
      if ((b & 0x7FFFFFFFFFFFFFFFull) > 0x7FF0000000000000ull)
        b = 0x7FF8000000000000ull;
      if (fold_zero && (b & 0x7FFFFFFFFFFFFFFFull) == 0ull) b = 0ull;
      return b;
    }
    case ENC_INT4:
      return static_cast<uint32_t>(load_int(c, j, i));
    default:
      return static_cast<uint64_t>(load_int(c, j, i));
  }
}

RH_FN bool eight_bytes(const Cols& c, int j) {
  return c.enc[j] == ENC_INT8 || c.enc[j] == ENC_F64;
}

// ---- one element, one row ----------------------------------------------------

// One fixed-width value v (`encode`), murmur3 from h.
RH_FN uint32_t mm_fixed(uint32_t h, uint64_t v, bool eight) {
  uint32_t nh = mm_round(h, static_cast<uint32_t>(v));
  if (eight) nh = mm_round(nh, static_cast<uint32_t>(v >> 32));
  return mm_fmix(nh ^ (eight ? 8u : 4u));
}

RH_FN bool var_bytes(const Cols& c, int j) {
  return c.enc[j] == ENC_STRING || c.enc[j] == ENC_DEC128;
}

// Element k of leaf column j, a STRING or a DECIMAL128: its bytes.
RH_FN uint32_t mm_var(const Cols& c, const ByteCols* b, int j, long long k,
                      uint32_t h) {
  if (c.enc[j] == ENC_STRING) {
    const int s = b->offsets[j][k];
    const MemBytes m = {static_cast<const unsigned char*>(c.data[j]) + s};
    return mm_bytes(h, m, b->offsets[j][k + 1] - s);
  }
  const uint64_t* v = static_cast<const uint64_t*>(c.data[j]) + 2 * k;
  const DecBytes d = dec_bytes(v[0], v[1]);
  return mm_bytes(h, d, d.len);
}

RH_FN uint64_t xx_var(const Cols& c, const ByteCols* b, int j, long long k,
                      uint64_t h) {
  if (c.enc[j] == ENC_STRING) {
    const int s = b->offsets[j][k];
    const MemBytes m = {static_cast<const unsigned char*>(c.data[j]) + s};
    return xx_bytes(h, m, b->offsets[j][k + 1] - s);
  }
  const uint64_t* v = static_cast<const uint64_t*>(c.data[j]) + 2 * k;
  const DecBytes d = dec_bytes(v[0], v[1]);
  return xx_bytes(h, d, d.len);
}

// Row i through every column of `c`, from the running hashes mh / xh;
// `mm` and `xx` choose the hashes. BYTES false: fixed-width columns only,
// `b` is not read and the byte path is not compiled in.
template <bool BYTES>
RH_FN void hash_row(const Cols& c, const ByteCols* b, long long i, bool mm,
                    bool xx, uint32_t& mh, uint64_t& xh) {
  for (int j = 0; j < c.nc; ++j) {
    if (c.valid[j] != nullptr && !c.valid[j][i]) continue;
    if (BYTES && b->span_start[j] != nullptr) {  // a list: murmur3 only
      const int end = b->span_end[j][i];
      const unsigned char* ev = b->elem_valid[j];
      for (int k = b->span_start[j][i]; mm && k < end; ++k) {
        if (ev != nullptr && !ev[k]) continue;
        mh = var_bytes(c, j) ? mm_var(c, b, j, k, mh)
                             : mm_fixed(mh, encode(c, j, k, false),
                                        eight_bytes(c, j));
      }
      continue;
    }
    if (BYTES && var_bytes(c, j)) {
      if (mm) mh = mm_var(c, b, j, i, mh);
      if (xx) xh = xx_var(c, b, j, i, xh);
      continue;
    }
    // written out here: through a helper the flag is kept in a register
    // and tested again, 1% on the fixed-width forms
    const bool eight = c.enc[j] == ENC_INT8 || c.enc[j] == ENC_F64;
    if (mm) mh = mm_fixed(mh, encode(c, j, i, false), eight);
    if (xx) xh = xx_fixed(xh, encode(c, j, i, true), eight);
  }
}

// Whether a launch's columns need the byte path: strings, DECIMAL128 or
// lists.
static inline bool needs_bytes(const Cols& c, const ByteCols& b) {
  for (int j = 0; j < c.nc; ++j)
    if (c.enc[j] == ENC_STRING || c.enc[j] == ENC_DEC128 ||
        b.span_start[j] != nullptr)
      return true;
  return false;
}

static inline const void* at(const void* const* a, int j) {
  return a == nullptr ? nullptr : a[j];
}

// `rh_hash`'s arguments as a launch's Cols and ByteCols (slots from nc on
// unused), checked: 0 if the kernels take them. The byte path's arrays may
// be null: no column then has offsets or spans.
static inline int make_cols(const void* const* data, const void* const* valid,
                            const int* width, const int* enc,
                            const void* const* offsets,
                            const void* const* span_start,
                            const void* const* span_end,
                            const void* const* elem_valid, int nc, bool xx,
                            Cols& c, ByteCols& b) {
  if (nc < 1 || nc > MAX_COLS) return 1;
  c.nc = nc;
  for (int j = 0; j < MAX_COLS; ++j) {
    const bool used = j < nc;
    c.data[j] = used ? data[j] : nullptr;
    c.valid[j] = used ? static_cast<const unsigned char*>(valid[j]) : nullptr;
    c.width[j] = used ? width[j] : 8;
    c.enc[j] = used ? enc[j] : ENC_INT8;
    b.offsets[j] = static_cast<const int*>(used ? at(offsets, j) : nullptr);
    b.span_start[j] =
        static_cast<const int*>(used ? at(span_start, j) : nullptr);
    b.span_end[j] = static_cast<const int*>(used ? at(span_end, j) : nullptr);
    b.elem_valid[j] = static_cast<const unsigned char*>(
        used ? at(elem_valid, j) : nullptr);
    if (!used) continue;
    const int w = width[j], e = enc[j];
    const bool ok = (e == ENC_INT4 && (w == 1 || w == 2 || w == 4)) ||
                    (e == ENC_INT8 && (w == 4 || w == 8)) ||
                    (e == ENC_F32 && w == 4) || (e == ENC_F64 && w == 8) ||
                    (e == ENC_STRING && w == 1 && b.offsets[j] != nullptr) ||
                    (e == ENC_DEC128 && w == 16);
    const bool list = b.span_start[j] != nullptr;
    if (!ok || list != (b.span_end[j] != nullptr) || (list && xx)) return 1;
    // an empty chars or leaf buffer may have no address; rows always do
    if (c.data[j] == nullptr && !list && e != ENC_STRING) return 1;
  }
  return 0;
}

#ifdef __CUDACC__

// Row i's hashes, from the seeds or the running hashes, into the outputs.
template <bool BYTES>
__device__ __forceinline__ void hash_one(
    const Cols& c, const ByteCols* b, long long i, bool mm, bool xx,
    uint32_t mm_seed, uint64_t xx_seed, const int* mm_in,
    const long long* xx_in, int* mm_out, long long* xx_out) {
  uint32_t mh = 0u;
  uint64_t xh = 0ull;
  if (mm) mh = mm_in ? static_cast<uint32_t>(mm_in[i]) : mm_seed;
  if (xx) xh = xx_in ? static_cast<uint64_t>(xx_in[i]) : xx_seed;
  hash_row<BYTES>(c, b, i, mm, xx, mh, xh);
  if (mm) mm_out[i] = static_cast<int>(mh);
  if (xx) xx_out[i] = static_cast<long long>(xh);
}

// The fixed-width forms: the hashes chosen at compile time, no byte path,
// so their parameters, registers and instructions stay those of a
// fixed-width hash.
template <bool MM, bool XX>
__global__ void __launch_bounds__(THREADS)
row_hash_kernel(const __grid_constant__ Cols c, long long n,
                uint32_t mm_seed, uint64_t xx_seed, const int* mm_in,
                const long long* xx_in, int* mm_out, long long* xx_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    hash_one<false>(c, nullptr, i, MM, XX, mm_seed, xx_seed, mm_in, xx_in,
                    mm_out, xx_out);
}

// Launches with strings, DECIMAL128 or lists: either or both hashes, as
// the outputs say.
__global__ void __launch_bounds__(THREADS)
row_hash_bytes_kernel(const __grid_constant__ Cols c,
                      const __grid_constant__ ByteCols b, long long n,
                      uint32_t mm_seed, uint64_t xx_seed, const int* mm_in,
                      const long long* xx_in, int* mm_out,
                      long long* xx_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool mm = mm_out != nullptr, xx = xx_out != nullptr;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    hash_one<true>(c, &b, i, mm, xx, mm_seed, xx_seed, mm_in, xx_in, mm_out,
                   xx_out);
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

// Hash n rows of nc <= MAX_COLS leaf columns, given as arrays of their
// fields (`make_cols`). mm_out / xx_out choose the hashes (either or both
// non-null; lists take murmur3 only); mm_in / xx_in, when non-null, hold
// the running hashes to continue from instead of the seeds (they may alias
// the outputs).
int rh_hash(const void* const* data, const void* const* valid,
            const int* width, const int* enc, const void* const* offsets,
            const void* const* span_start, const void* const* span_end,
            const void* const* elem_valid, int nc, long long n,
            unsigned int mm_seed, unsigned long long xx_seed,
            const int* mm_in, const long long* xx_in, int* mm_out,
            long long* xx_out, void* stream) {
  Cols c;
  ByteCols b;
  if (n < 1 || (!mm_out && !xx_out) ||
      make_cols(data, valid, width, enc, offsets, span_start, span_end,
                elem_valid, nc, xx_out != nullptr, c, b))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (needs_bytes(c, b))
    row_hash_bytes_kernel<<<blocks, THREADS, 0, s>>>(
        c, b, n, mm_seed, xx_seed, mm_out ? mm_in : nullptr,
        xx_out ? xx_in : nullptr, mm_out, xx_out);
  else if (mm_out && xx_out)
    row_hash_kernel<true, true><<<blocks, THREADS, 0, s>>>(
        c, n, mm_seed, xx_seed, mm_in, xx_in, mm_out, xx_out);
  else if (mm_out)
    row_hash_kernel<true, false><<<blocks, THREADS, 0, s>>>(
        c, n, mm_seed, xx_seed, mm_in, nullptr, mm_out, nullptr);
  else
    row_hash_kernel<false, true><<<blocks, THREADS, 0, s>>>(
        c, n, mm_seed, xx_seed, nullptr, xx_in, nullptr, xx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#endif  // __CUDACC__
