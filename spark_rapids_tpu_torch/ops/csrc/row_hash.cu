// Fused Spark row hash for Hopper (sm_90a): murmur3_32 and/or xxhash64 of
// every row of a fixed-width table, chained over its columns.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/ops/hash_pallas.py
// (`_hash_kernel_body`, launched by `_run_custom` for
// `murmur_hash3_32_pallas`, `xxhash64_pallas` and `fused_row_hash`) and
// computes what it computes:
//
// - Per row, h starts at the seed (or at the running hash a previous launch
//   wrote, for tables wider than MAX_COLS) and each column in turn updates
//   it; a null value leaves h unchanged.
// - Each value is encoded in-kernel as Spark hashes it (the reference's
//   `_planes` / `_encode_fixed_u64`): 1/2/4-byte ints, bool and date32 as
//   4 bytes sign-extended; int64, timestamp_us and decimal32/64 as 8 bytes
//   sign-extended; float32/64 by their bits, every NaN replaced by the
//   canonical quiet NaN (0x7FC00000 / 0x7FF8000000000000). xxhash64 also
//   folds -0.0 into +0.0; murmur3 does not (hash_pallas.py:308-309).
// - murmur3_32: one round per 4-byte word, then fmix(h ^ nbytes).
//   xxhash64: the small fixed-width path of xxhash64.cu (seed + P5 + nbytes,
//   one 4- or 8-byte round, the avalanche).
//
// Hopper has native 64-bit integers, so the TPU kernel's u32-plane
// emulation of u64 math (16-bit-limb multiplies, carry compares) and its
// (rows/128, 128) tiling are not carried over: one thread hashes one row
// (grid-stride loop) in uint64_t, with funnel shifts for the rotates.
//
// What bounds it on this card: at 10M rows x 2 INT64 columns the fused call
// reads 160 MB and writes 120 MB (0.0836 ms at 3.35 TB/s), and does about
// 140 32-bit integer instructions per row (1.40 G, 0.0837 ms at the card's
// 16.7 T integer instructions/s): both bounds are near, the operations a
// hair above the bytes. Per 8-byte column, counted from this source with a
// 64-bit multiply by a constant as 3 IMADs, a 64-bit add, xor or rotate as
// 2 instructions and a 32-bit rotate as one funnel shift: murmur3 is two
// rounds of 6 plus the length xor and fmix (8), 21; xxhash64 is the seed add
// (2), the round (17) and the avalanche (13), 32; loading, encoding and the
// null test add 8 and the column loop 3. Two columns with both hashes:
// 2 x 64 = 128, plus the row's index, seeds and stores, 12: 140
// (chip_smoke.py counts the single-hash forms the same way). The kernel
// reads each value once with coalesced 8-byte loads and writes each hash
// once, so the design has nothing to save in bytes; making the arithmetic
// lean (no per-column width switch inside the row loop) is left for later.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// after its launch (or cudaErrorInvalidValue for arguments it does not
// take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 32
#define THREADS 256

enum Enc { ENC_INT4 = 0, ENC_INT8 = 1, ENC_F32 = 2, ENC_F64 = 3 };

struct Cols {
  const void* data[MAX_COLS];
  const unsigned char* valid[MAX_COLS];  // torch.bool bytes; null = all valid
  int width[MAX_COLS];                   // storage bytes: 1, 2, 4 or 8
  int enc[MAX_COLS];                     // Enc: Spark's byte form
  int nc;
};

__device__ __forceinline__ long long load_int(const Cols& c, int j,
                                              long long i) {
  switch (c.width[j]) {
    case 1: return static_cast<const signed char*>(c.data[j])[i];
    case 2: return static_cast<const short*>(c.data[j])[i];
    case 4: return static_cast<const int*>(c.data[j])[i];
    default: return static_cast<const long long*>(c.data[j])[i];
  }
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint32_t mm_round(uint32_t h, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h ^= k1;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t mm_fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

#define XX_P1 0x9E3779B185EBCA87ull
#define XX_P2 0xC2B2AE3D27D4EB4Full
#define XX_P3 0x165667B19E3779F9ull
#define XX_P4 0x85EBCA77C2B2AE63ull
#define XX_P5 0x27D4EB2F165667C5ull

__device__ __forceinline__ uint64_t xx_fixed(uint64_t h, uint64_t w,
                                             bool eight) {
  h += XX_P5 + (eight ? 8u : 4u);
  if (eight) {
    const uint64_t k1 = rotl64(w * XX_P2, 31) * XX_P1;
    h = rotl64(h ^ k1, 27) * XX_P1 + XX_P4;
  } else {
    h = rotl64(h ^ (w * XX_P1), 23) * XX_P2 + XX_P3;
  }
  h ^= h >> 33;
  h *= XX_P2;
  h ^= h >> 29;
  h *= XX_P3;
  return h ^ (h >> 32);
}

// The value Spark hashes, as its little-endian bits: the 32-bit word
// zero-extended for 4-byte forms. `fold_zero` maps -0.0 to +0.0.
__device__ __forceinline__ uint64_t encode(const Cols& c, int j, long long i,
                                           bool fold_zero) {
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

template <bool MM, bool XX>
__global__ void __launch_bounds__(THREADS)
row_hash_kernel(const __grid_constant__ Cols c, long long n,
                uint32_t mm_seed, uint64_t xx_seed, const int* mm_in,
                const long long* xx_in, int* mm_out, long long* xx_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t mh = 0u;
    uint64_t xh = 0ull;
    if (MM) mh = mm_in ? static_cast<uint32_t>(mm_in[i]) : mm_seed;
    if (XX) xh = xx_in ? static_cast<uint64_t>(xx_in[i]) : xx_seed;
    for (int j = 0; j < c.nc; ++j) {
      if (c.valid[j] != nullptr && !c.valid[j][i]) continue;
      const bool eight = c.enc[j] == ENC_INT8 || c.enc[j] == ENC_F64;
      if (MM) {
        const uint64_t v = encode(c, j, i, false);
        uint32_t nh = mm_round(mh, static_cast<uint32_t>(v));
        if (eight) nh = mm_round(nh, static_cast<uint32_t>(v >> 32));
        mh = mm_fmix(nh ^ (eight ? 8u : 4u));
      }
      if (XX) xh = xx_fixed(xh, encode(c, j, i, true), eight);
    }
    if (MM) mm_out[i] = static_cast<int>(mh);
    if (XX) xx_out[i] = static_cast<long long>(xh);
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

// Hash n rows of nc <= MAX_COLS columns. mm_out / xx_out choose the hashes
// (either or both non-null); mm_in / xx_in, when non-null, hold the running
// hashes to continue from instead of the seeds (they may alias the outputs).
int rh_hash(const void* const* data, const void* const* valid,
            const int* width, const int* enc, int nc, long long n,
            unsigned int mm_seed, unsigned long long xx_seed,
            const int* mm_in, const long long* xx_in, int* mm_out,
            long long* xx_out, void* stream) {
  if (nc < 1 || nc > MAX_COLS || n < 1 || (!mm_out && !xx_out))
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  c.nc = nc;
  for (int j = 0; j < MAX_COLS; ++j) {
    const bool used = j < nc;
    c.data[j] = used ? data[j] : nullptr;
    c.valid[j] = used ? static_cast<const unsigned char*>(valid[j]) : nullptr;
    c.width[j] = used ? width[j] : 8;
    c.enc[j] = used ? enc[j] : ENC_INT8;
    if (!used) continue;
    const int w = width[j], e = enc[j];
    const bool ok = (e == ENC_INT4 && (w == 1 || w == 2 || w == 4)) ||
                    (e == ENC_INT8 && (w == 4 || w == 8)) ||
                    (e == ENC_F32 && w == 4) || (e == ENC_F64 && w == 8);
    if (!ok || data[j] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (mm_out && xx_out)
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
