// Spark's bloom filter (BloomFilterImpl): put and probe of an INT64 column,
// for Hopper (sm_90a): one thread a row over the packed filter.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/bloom_filter.py
// (`_spark_bit_indexes` :67, `bloom_filter_put` :80, `bloom_filter_probe`
// :132; no pallas_call). The reference's own CUDA is bloom_filter.cu:75-366,
// one thread a row with atomicOr, as here. The JAX package keeps the filter
// unpacked, one uint8 lane a bit (64 MiB for an 8 MiB filter), because XLA
// and the TPU have no atomics: `put` is a scatter-max there. Here the filter
// is Spark's own packed longs (bit j in word j >> 6 at bit j & 63), and a
// row sets each of its k bits with a 64-bit atomicOr; `probe` ANDs k loads.
// A row's indexes: h1 = murmur3_32 of its 8 bytes with seed 0, h2 = the
// same with seed h1, combined = h1 + i * h2 (i = 1..k, 32-bit wrap),
// bit-flipped where its sign bit is set, then combined % num_bits (a real
// division: num_bits = 64 * num_longs need not be a power of two).
//
// What bounds it on this card: integer operations, then bytes. The column
// comes from device memory (8 B a row, a byte of validity, a byte of
// output for probe); the filter (512 KiB to 8 MiB here) stays in the 50 MB
// L2, where k atomics or loads a row land at random words. The hashes take
// some 40 integer instructions a row; the modulo here is a 64-bit
// division, which the bound counts as a multiply by the constant size's
// reciprocal (chip_smoke.py: 38 a row and 11 an index).
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_*` below loop over rows as the kernels do (an OR in place of
// the atomic), so that tests/test_torch_bloom_filter.py builds this file
// with the host compiler and holds it against the plain version.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// none synchronises or allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BF_FN __host__ __device__ __forceinline__
#else
#define BF_FN static inline
#endif

#define THREADS 256

typedef unsigned long long u64;

BF_FN uint32_t bf_rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

BF_FN uint32_t bf_round(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = bf_rotl(k, 15);
  k *= 0x1B873593u;
  h = bf_rotl(h ^ k, 13);
  return h * 5u + 0xE6546B64u;
}

// Spark's murmur3_32 of one long (its two little-endian words) and a seed
BF_FN uint32_t bf_murmur_long(u64 v, uint32_t seed) {
  uint32_t h = bf_round(seed, static_cast<uint32_t>(v));
  h = bf_round(h, static_cast<uint32_t>(v >> 32));
  h ^= 8u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// the i-th (1-based) bit index of a row whose hashes are h1, h2
BF_FN u64 bf_index(uint32_t h1, uint32_t h2, int i, u64 num_bits) {
  uint32_t combined = h1 + static_cast<uint32_t>(i) * h2;
  if (combined >> 31) combined = ~combined;
  return static_cast<u64>(combined) % num_bits;
}

struct BloomArgs {
  const long long* data;
  const uint8_t* valid;  // null: every row valid
  int num_hashes;
  u64 num_bits;
  u64* words;            // (num_bits / 64,)
  uint8_t* found;        // probe: (n,) bool
};

BF_FN void bf_or(u64* word, u64 bit) {
#ifdef __CUDA_ARCH__
  atomicOr(word, bit);
#else
  *word |= bit;
#endif
}

BF_FN void bf_put_row(const BloomArgs& a, long long i) {
  if (a.valid != nullptr && a.valid[i] == 0) return;
  const u64 v = static_cast<u64>(a.data[i]);
  const uint32_t h1 = bf_murmur_long(v, 0u), h2 = bf_murmur_long(v, h1);
  for (int k = 1; k <= a.num_hashes; ++k) {
    const u64 j = bf_index(h1, h2, k, a.num_bits);
    bf_or(a.words + (j >> 6), 1ULL << (j & 63));
  }
}

// every row, null or not, as the JAX package probes (the validity passes
// through)
BF_FN void bf_probe_row(const BloomArgs& a, long long i) {
  const u64 v = static_cast<u64>(a.data[i]);
  const uint32_t h1 = bf_murmur_long(v, 0u), h2 = bf_murmur_long(v, h1);
  bool hit = true;
  for (int k = 1; k <= a.num_hashes && hit; ++k) {
    const u64 j = bf_index(h1, h2, k, a.num_bits);
    hit = (a.words[j >> 6] >> (j & 63)) & 1ULL;
  }
  a.found[i] = hit;
}

static bool bf_args_ok(const BloomArgs& a, long long n, bool probe) {
  return n >= 1 && a.data != nullptr && a.words != nullptr &&
         a.num_hashes >= 1 && a.num_bits >= 64 && a.num_bits % 64 == 0 &&
         (!probe || a.found != nullptr);
}

static BloomArgs bf_args(const void* data, const void* valid, int num_hashes,
                         long long num_longs, void* words, void* found) {
  BloomArgs a;
  a.data = static_cast<const long long*>(data);
  a.valid = static_cast<const uint8_t*>(valid);
  a.num_hashes = num_hashes;
  a.num_bits = static_cast<u64>(num_longs) * 64;
  a.words = static_cast<u64*>(words);
  a.found = static_cast<uint8_t*>(found);
  return a;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
bf_put_kernel(BloomArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    bf_put_row(a, i);
}

__global__ void __launch_bounds__(THREADS)
bf_probe_kernel(BloomArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    bf_probe_row(a, i);
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

// n >= 1 rows. data: (n,) int64; valid: (n,) bool or null; words:
// (num_longs,) int64, the filter, updated in place.
int bf_put(const void* data, const void* valid, long long n, int num_hashes,
           long long num_longs, void* words, void* stream) {
  const BloomArgs a = bf_args(data, valid, num_hashes, num_longs, words,
                              nullptr);
  if (!bf_args_ok(a, n, false)) return static_cast<int>(cudaErrorInvalidValue);
  bf_put_kernel<<<blocks_for(n), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

// n >= 1 rows. data: (n,) int64; words: the filter; writes found: (n,)
// bool.
int bf_probe(const void* data, long long n, int num_hashes,
             long long num_longs, const void* words, void* found,
             void* stream) {
  const BloomArgs a = bf_args(data, nullptr, num_hashes, num_longs,
                              const_cast<void*>(words), found);
  if (!bf_args_ok(a, n, true)) return static_cast<int>(cudaErrorInvalidValue);
  bf_probe_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_put(const void* data, const void* valid, long long n,
                        int num_hashes, long long num_longs, void* words) {
  const BloomArgs a = bf_args(data, valid, num_hashes, num_longs, words,
                              nullptr);
  if (!bf_args_ok(a, n, false)) return 1;
  for (long long i = 0; i < n; ++i) bf_put_row(a, i);
  return 0;
}

extern "C" int host_probe(const void* data, long long n, int num_hashes,
                          long long num_longs, const void* words,
                          void* found) {
  const BloomArgs a = bf_args(data, nullptr, num_hashes, num_longs,
                              const_cast<void*>(words), found);
  if (!bf_args_ok(a, n, true)) return 1;
  for (long long i = 0; i < n; ++i) bf_probe_row(a, i);
  return 0;
}

// the bit indexes of each row, (n, num_hashes) int64
extern "C" int host_indexes(const void* data, long long n, int num_hashes,
                            long long num_longs, void* out) {
  const long long* d = static_cast<const long long*>(data);
  long long* o = static_cast<long long*>(out);
  const u64 num_bits = static_cast<u64>(num_longs) * 64;
  for (long long i = 0; i < n; ++i) {
    const u64 v = static_cast<u64>(d[i]);
    const uint32_t h1 = bf_murmur_long(v, 0u), h2 = bf_murmur_long(v, h1);
    for (int k = 1; k <= num_hashes; ++k)
      o[i * num_hashes + k - 1] =
          static_cast<long long>(bf_index(h1, h2, k, num_bits));
  }
  return 0;
}

#endif  // __CUDACC__
