// Hash-join build / probe-count / probe-emit kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of spark_rapids_tpu/ops/join_pallas.py:
//   hj_build  <- _build_kernel_body (via _build_table)
//   hj_count  <- _count_kernel_body (via _run_probe / _probe_counts)
//   hj_emit   <- _emit_kernel_body  (via _run_probe / _probe_emit)
// and computes the same functions:
//
// - Bucket hash: Spark murmur3_32 with seed 42, chained over the key
//   columns. 1/2/4-byte keys hash as one word (sign-extended through int32),
//   8-byte keys (and DECIMAL32, which hashes as a long) as two words, lo then
//   hi; each column ends with fmix(h ^ nbytes). Slot = (h + d) & (C - 1).
// - Build (one block): an open-addressing table of C <= 1024 slots in shared
//   memory, filled by the TPU kernel's parallel rounds: every unplaced valid
//   row proposes slot (h + d) & (C-1), the lowest row id wins a free slot
//   (shared-memory atomicMin), losers advance. Equal keys therefore land in
//   ascending-row chain order, which is what makes emission match the
//   sort-based fallback pair for pair. Invalid rows are never inserted. The
//   table is (slot_row, slot_hash): the winning row id (-1 = empty) and its
//   32-bit hash; the key values stay in the build columns.
// - Probe count: one thread per probe row, the table loaded into shared
//   memory once per block (grid-stride loop). Walk from the bucket to the
//   first empty slot; a slot matches when its hash equals the row's and
//   every key value equals the build row's. Invalid rows count 0.
// - Emit: the same walk, writing (probe row, build row) at starts[i] + k, so
//   pairs come out probe row ascending, then chain order. The TPU kernel
//   re-walked once per output slot; one walk per probe row gives the same
//   maps.
//
// Hopper has native 32- and 64-bit integers, so the TPU's u16-half and
// one-hot MXU gathers are not carried over.
//
// What bounds it on this card: bytes. A probe over 10M int64 keys reads
// 80 MB of keys and writes 40 MB of int32 counts (about 36 us at 3.35 TB/s);
// the table is at most 8 KB and lives in shared memory, so the walk itself
// touches no device memory. The emit reads every row's count, but keys and
// its int64 start only for rows with matches, and writes 8 bytes per pair
// (about 60 MB for q3's first join, 8.5% of whose rows match). The murmur3
// hashes are about 30 integer operations per 8-byte key, a few microseconds
// of the card's integer rate at 10M rows. The build moves a few KB and is
// bound by its launch and its rounds of block-wide barriers.
//
// Plain C interface for ctypes. Every entry point returns
// cudaGetLastError() after its launch (or cudaErrorInvalidValue for
// arguments it does not take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define MAX_KEYS 32
#define MAX_CAPACITY 1024
#define MAX_BUILD_ROWS 512
#define BUILD_THREADS 1024
#define PROBE_THREADS 256

struct Keys {
  const void* data[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];  // torch.bool bytes; null = all valid
  int width[MAX_KEYS];                   // storage bytes: 1, 2, 4 or 8
  int wide[MAX_KEYS];                    // hashed as 8 bytes
  int nk;
};

__device__ __forceinline__ long long load_key(const Keys& k, int j,
                                              long long i) {
  switch (k.width[j]) {
    case 1: return static_cast<const signed char*>(k.data[j])[i];
    case 2: return static_cast<const short*>(k.data[j])[i];
    case 4: return static_cast<const int*>(k.data[j])[i];
    default: return static_cast<const long long*>(k.data[j])[i];
  }
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
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

__device__ __forceinline__ bool row_valid(const Keys& k, long long i) {
  for (int j = 0; j < k.nk; ++j)
    if (k.valid[j] != nullptr && !k.valid[j][i]) return false;
  return true;
}

__device__ __forceinline__ uint32_t row_hash(const Keys& k, long long i) {
  uint32_t h = 42u;
  for (int j = 0; j < k.nk; ++j) {
    const long long v = load_key(k, j, i);
    uint32_t nh = mm_round(h, static_cast<uint32_t>(v));
    if (k.wide[j])
      nh = mm_round(nh, static_cast<uint32_t>(
                            static_cast<unsigned long long>(v) >> 32));
    h = mm_fmix(nh ^ (k.wide[j] ? 8u : 4u));
  }
  return h;
}

__device__ __forceinline__ bool keys_equal(const Keys& p, long long i,
                                           const Keys& b, int r) {
  for (int j = 0; j < p.nk; ++j)
    if (load_key(p, j, i) != load_key(b, j, r)) return false;
  return true;
}

__global__ void __launch_bounds__(BUILD_THREADS)
build_kernel(const __grid_constant__ Keys b, int n, int C, int* slot_row_out,
             uint32_t* slot_hash_out) {
  __shared__ int slot_row[MAX_CAPACITY];
  __shared__ uint32_t slot_hash[MAX_CAPACITY];
  __shared__ int proposal[MAX_CAPACITY];
  const int t = threadIdx.x;
  for (int s = t; s < C; s += blockDim.x) {
    slot_row[s] = -1;
    slot_hash[s] = 0u;
  }
  bool placed = true;            // threads past the rows never propose
  uint32_t h = 0u;
  if (t < n) {
    placed = !row_valid(b, t);   // invalid rows are never inserted
    h = row_hash(b, t);
  }
  uint32_t d = 0u;               // this row's probe distance
  __syncthreads();
  for (int round = 0; round < 2 * C + 2; ++round) {
    if (!__syncthreads_or(!placed)) break;
    for (int s = t; s < C; s += blockDim.x) proposal[s] = INT_MAX;
    __syncthreads();
    const int slot = static_cast<int>((h + d) & static_cast<uint32_t>(C - 1));
    if (!placed) atomicMin(&proposal[slot], t);
    __syncthreads();
    // a slot is free if it was empty when the round began
    const bool won = !placed && slot_row[slot] < 0 && proposal[slot] == t;
    __syncthreads();
    if (won) {
      slot_row[slot] = t;
      slot_hash[slot] = h;
      placed = true;
    } else if (!placed) {
      ++d;
    }
  }
  __syncthreads();
  for (int s = t; s < C; s += blockDim.x) {
    slot_row_out[s] = slot_row[s];
    slot_hash_out[s] = slot_hash[s];
  }
}

template <bool EMIT>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_kernel(const __grid_constant__ Keys p, long long n,
             const __grid_constant__ Keys b, const int* slot_row_g,
             const uint32_t* slot_hash_g, int C, int* counts,
             const long long* starts, int* out_l, int* out_r) {
  __shared__ int srow[MAX_CAPACITY];
  __shared__ uint32_t shash[MAX_CAPACITY];
  for (int s = threadIdx.x; s < C; s += blockDim.x) {
    srow[s] = slot_row_g[s];
    shash[s] = slot_hash_g[s];
  }
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    long long o = 0;
    if (EMIT) {
      if (counts[i] == 0) continue;
      o = starts[i];
    } else if (!row_valid(p, i)) {
      counts[i] = 0;
      continue;
    }
    const uint32_t h = row_hash(p, i);
    int c = 0;
    for (int d = 0; d <= C; ++d) {
      const int s = static_cast<int>((h + static_cast<uint32_t>(d)) & mask);
      const int r = srow[s];
      if (r < 0) break;            // linear probing: chain ends here
      if (shash[s] == h && keys_equal(p, i, b, r)) {
        if (EMIT) {
          out_l[o] = static_cast<int>(i);
          out_r[o] = r;
          ++o;
        } else {
          ++c;
        }
      }
    }
    if (!EMIT) counts[i] = c;
  }
}

static bool make_keys(Keys* k, const void* const* data,
                      const void* const* valid, const int* width,
                      const int* wide, int nk) {
  if (nk < 1 || nk > MAX_KEYS) return false;
  k->nk = nk;
  for (int j = 0; j < MAX_KEYS; ++j) {
    const bool used = j < nk;
    k->data[j] = used ? data[j] : nullptr;
    k->valid[j] = used ? static_cast<const unsigned char*>(valid[j]) : nullptr;
    k->width[j] = used ? width[j] : 8;
    k->wide[j] = used ? wide[j] : 0;
    if (used && width[j] != 1 && width[j] != 2 && width[j] != 4 &&
        width[j] != 8)
      return false;
  }
  return true;
}

static bool capacity_ok(int C) {
  return C >= 1 && C <= MAX_CAPACITY && (C & (C - 1)) == 0;
}

static int probe_blocks(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long need = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  const long long cap = static_cast<long long>(sms) * 8;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

int hj_build(const void* const* data, const void* const* valid,
             const int* width, const int* wide, int nk, long long n, int C,
             int* slot_row, uint32_t* slot_hash, void* stream) {
  Keys b;
  if (!make_keys(&b, data, valid, width, wide, nk) || n < 1 ||
      n > MAX_BUILD_ROWS || !capacity_ok(C) || 2 * n > C)
    return static_cast<int>(cudaErrorInvalidValue);
  build_kernel<<<1, BUILD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<int>(n), C, slot_row, slot_hash);
  return static_cast<int>(cudaGetLastError());
}

int hj_count(const void* const* pdata, const void* const* pvalid,
             const int* width, const int* wide, int nk, long long n,
             const void* const* bdata, const int* slot_row,
             const uint32_t* slot_hash, int C, int* counts, void* stream) {
  Keys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_keys(&p, pdata, pvalid, width, wide, nk) ||
      !make_keys(&b, bdata, no_valid, width, wide, nk) || n < 1 ||
      !capacity_ok(C))
    return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<false><<<probe_blocks(n), PROBE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, n, b, slot_row, slot_hash, C, counts, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int hj_emit(const void* const* pdata, const void* const* pvalid,
            const int* width, const int* wide, int nk, long long n,
            const void* const* bdata, const int* slot_row,
            const uint32_t* slot_hash, int C, const int* counts,
            const long long* starts, int* out_l, int* out_r, void* stream) {
  Keys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_keys(&p, pdata, pvalid, width, wide, nk) ||
      !make_keys(&b, bdata, no_valid, width, wide, nk) || n < 1 ||
      !capacity_ok(C))
    return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<true><<<probe_blocks(n), PROBE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, n, b, slot_row, slot_hash, C, const_cast<int*>(counts), starts,
      out_l, out_r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
