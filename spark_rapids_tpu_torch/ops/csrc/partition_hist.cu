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
// counters, warp w adding into sub-histogram w % nsub, so that a warp's
// increments collide only with its own lanes and those of the warps that
// share its copy. At the block's end the copies are summed and published
// with one global atomicAdd per non-zero bucket. The host picks the most
// copies (up to one per warp) that fit in 48 KB: eight up to P = 1536, one
// up to P = 12288. Above that no copy fits, `nsub` is 0 and every id goes
// straight to a global atomicAdd on `counts`. The caller zeroes `counts`.
//
// What bounds it on this card: bytes. 10M ids are 40 MB read (0.012 ms at
// 3.35 TB/s); the counts are 4P bytes. The rows are read with 16-byte loads
// (four ids per thread) where the pointer allows. At P = 8 a warp's 32
// increments fall on 8 counters, and the shared-memory atomics serialise on
// them; warp aggregation (__match_any_sync) would remove that and is left
// for later.
//
// Plain C interface for ctypes. The entry point returns cudaGetLastError()
// after its launch (or cudaErrorInvalidValue for arguments it does not
// take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define SHARED_BYTES (48 * 1024)  // dynamic shared memory without opt-in

__device__ __forceinline__ void count(int* hist, int P, int id) {
  if (static_cast<unsigned>(id) < static_cast<unsigned>(P))
    atomicAdd(&hist[id], 1);
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const int* part, long long n, int P, int nsub, int vec,
            int* counts) {
  extern __shared__ int sub[];  // nsub copies of P counters
  int* mine = nsub ? sub + (threadIdx.x / 32 % nsub) * P : counts;
  for (int s = threadIdx.x; s < nsub * P; s += THREADS) sub[s] = 0;
  __syncthreads();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {  // `part` is 16-byte aligned: four ids per load
    const long long nv = n / 4;
    const int4* p4 = reinterpret_cast<const int4*>(part);
    for (long long i = tid; i < nv; i += stride) {
      const int4 v = p4[i];
      count(mine, P, v.x);
      count(mine, P, v.y);
      count(mine, P, v.z);
      count(mine, P, v.w);
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride) count(mine, P, part[i]);
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
  hist_kernel<<<blocks_for(n), THREADS, static_cast<size_t>(nsub) * P * 4,
                static_cast<cudaStream_t>(stream)>>>(part, n, P, nsub, vec,
                                                     counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
