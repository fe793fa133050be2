// Shuffle bucket histogram for Hopper (sm_90a): counts[b] = number of rows
// whose partition id is b, for b in [0, P), any P >= 1.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/parallel/
// partition_pallas.py (`_hist_kernel`, launched by `histogram_pallas`) and
// computes what it computes: (P,) int32 counts of int32 ids; ids outside
// [0, P) are never counted (the TPU kernel's padding ids are P). The TPU
// kernel held its buckets in one lane plane, so it stopped at P = 128; this
// one has no such limit.
//
// The TPU kernel walked the rows in order on one core and kept the counts
// resident in VMEM across grid steps, with P compare-and-reduce passes per
// block. Here blocks run in parallel in no order, so each block keeps
// private counters in dynamic shared memory: `nsub` sub-histograms of P
// counters, warp w adding into sub-histogram w % nsub, each lane adding its
// own id with a shared-memory atomic. The grid is persistent (a few blocks
// an SM), each warp looping over steps of IN_FLIGHT 512-byte rows of 16-byte
// loads, all issued before the first is counted, with a trip count the same
// for all its lanes (ids past the end read as -1, never counted).
//
// At the block's end the copies are summed and published with one global
// atomicAdd per non-zero bucket: about 132 x 4 merges a call, whatever n.
// The host picks the most copies (up to one per warp) that fit in 48 KB:
// eight up to P = 1536, one up to P = 12288. Above that no copy fits,
// `nsub` is 0 and the adds go straight to global atomics on `counts`. The
// caller zeroes `counts`.
//
// A warp-aggregated form (__match_any_sync on the id, one add per distinct
// id a warp) was measured on the H100 and was slower at every P: the match
// costs more than the colliding shared atomics it saves (PERF.md §6).
//
// What bounds it on this card: bytes. 10M ids are 40 MB read (0.012 ms at
// 3.35 TB/s); the counts are 4P bytes. The rows are read with 16-byte loads
// (four ids per thread) where the pointer allows.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// after its launch (or cudaErrorInvalidValue for arguments it does not
// take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define SHARED_BYTES (48 * 1024)  // dynamic shared memory without opt-in
#define IN_FLIGHT 4               // 16-byte loads a lane issues at once

// One id from every lane of the warp: each lane adds its own id in [0, P).
__device__ __forceinline__ void count_one(int* hist, int P, int id) {
  if (static_cast<unsigned>(id) < static_cast<unsigned>(P))
    atomicAdd(&hist[id], 1);
}

__device__ __forceinline__ void count4(int* hist, int P, int4 v) {
  count_one(hist, P, v.x);
  count_one(hist, P, v.y);
  count_one(hist, P, v.z);
  count_one(hist, P, v.w);
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const int* part, long long n, int P, int nsub, int vec,
            int* counts) {
  extern __shared__ int sub[];  // nsub copies of P counters
  int* mine = nsub ? sub + (threadIdx.x / 32 % nsub) * P : counts;
  for (int s = threadIdx.x; s < nsub * P; s += THREADS) sub[s] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  long long done = 0;
  if (vec) {  // `part` is 16-byte aligned: four ids per load
    const long long nv = n / 4;
    const int4* p4 = reinterpret_cast<const int4*>(part);
    const int4 none = make_int4(-1, -1, -1, -1);
    for (long long b = warp * 32 * IN_FLIGHT; b < nv;
         b += warps * 32 * IN_FLIGHT) {
      int4 u[IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) {
        const long long i = b + 32 * k + lane;
        u[k] = i < nv ? p4[i] : none;
      }
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) count4(mine, P, u[k]);
    }
    done = nv * 4;
  }
  for (long long b = done + warp * 32; b < n; b += warps * 32) {
    const long long i = b + lane;
    count_one(mine, P, i < n ? part[i] : -1);
  }
  if (nsub == 0) return;  // the ids went to `counts` directly
  __syncthreads();
  for (int b = threadIdx.x; b < P; b += THREADS) {
    int total = 0;
    for (int w = 0; w < nsub; ++w) total += sub[w * P + b];
    if (total) atomicAdd(&counts[b], total);
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
  const long long need = (n + 4LL * THREADS - 1) / (4LL * THREADS);
  const long long cap = static_cast<long long>(sms) * 4;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

// Add the histogram of n ids to counts[0 .. P), which the caller zeroed.
int ph_histogram(const int* part, long long n, int P, int* counts,
                 void* stream) {
  if (n < 1 || P < 1 || !part || !counts)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long fit = SHARED_BYTES / (4LL * P);
  const int nsub = static_cast<int>(fit < WARPS ? fit : WARPS);
  const int vec = (reinterpret_cast<uintptr_t>(part) % 16) == 0;
  const size_t smem = static_cast<size_t>(nsub) * P * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hist_kernel<<<blocks_for(n), THREADS, smem, st>>>(part, n, P, nsub, vec,
                                                    counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
