// Per-group float64 sums in row order, for Hopper (sm_90a).
//
// The port's own kernel; no TPU kernel stands behind it. The reference's
// keyed float sum (spark_rapids_tpu/ops/aggregate.py, the scatter design:
// jax.ops.segment_sum over the key-sorted rows) is, on XLA CPU, a left fold
// of each group's values in row order from +0.0, and the port's CPU path
// (torch index_add_) gives the same bits. On the card index_add_ adds with
// atomics, in an order that changes from run to run, so its bits differ
// (ROADMAP queue C 4). This kernel computes the reference's order: group g
// is rows starts[g] .. starts[g + 1] - 1 (the last to n) of the key-sorted
// values, and its sum is ((0.0 + v0) + v1) + ... in that order.
//
// What bounds it: a left fold is one chain of dependent float64 adds a
// group, so a group of m rows takes m adds' latency, whatever the card's
// width; groups run in parallel, one warp each. The values cross device
// memory once (8 bytes a row). The warp's lanes load 256 values at a time,
// coalesced, into shared memory, and issue the next 256 before lane 0
// folds the current ones, so the loads hide behind the chain.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (or cudaErrorInvalidValue for arguments it does not take); it never
// synchronises and allocates nothing.

#include <cuda_runtime.h>

#define SS_THREADS 256
#define SS_WARPS (SS_THREADS / 32)
#define SS_PER_LANE 8
#define SS_CHUNK (32 * SS_PER_LANE)              // values a warp stages

__global__ void __launch_bounds__(SS_THREADS)
seg_sum_kernel(const double* __restrict__ v,
               const long long* __restrict__ starts, long long g, long long n,
               double* __restrict__ out) {
  __shared__ double stage[SS_WARPS][SS_CHUNK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* st = stage[warp];
  const long long warps = static_cast<long long>(gridDim.x) * SS_WARPS;
  for (long long grp = static_cast<long long>(blockIdx.x) * SS_WARPS + warp;
       grp < g; grp += warps) {
    const long long lo = starts[grp];
    const long long hi = grp + 1 < g ? starts[grp + 1] : n;
    double r[SS_PER_LANE];
#pragma unroll
    for (int k = 0; k < SS_PER_LANE; ++k) {
      const long long i = lo + k * 32 + lane;
      r[k] = i < hi ? __ldcs(v + i) : 0.0;
    }
    double acc = 0.0;
    for (long long base = lo; base < hi; base += SS_CHUNK) {
#pragma unroll
      for (int k = 0; k < SS_PER_LANE; ++k) st[k * 32 + lane] = r[k];
      __syncwarp();
      // the next chunk's loads, in flight while lane 0 folds this one
#pragma unroll
      for (int k = 0; k < SS_PER_LANE; ++k) {
        const long long i = base + SS_CHUNK + k * 32 + lane;
        r[k] = i < hi ? __ldcs(v + i) : 0.0;
      }
      if (lane == 0) {
        const int m = hi - base < SS_CHUNK ? static_cast<int>(hi - base)
                                           : SS_CHUNK;
#pragma unroll 16
        for (int j = 0; j < m; ++j) acc += st[j];
      }
      __syncwarp();
    }
    if (lane == 0) out[grp] = acc;
  }
}

extern "C" {

// v: (n,) float64, the key-sorted values; starts: (g,) int64, each group's
// first row, ascending, starts[0] = 0; out: (g,) float64
int ss_segment_sum(const double* v, const long long* starts, long long g,
                   long long n, double* out, void* stream) {
  if (g < 1 || n < 0 || v == nullptr || starts == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a warp a group, at most eight blocks an SM's worth of warps in flight
  const long long want = (g + SS_WARPS - 1) / SS_WARPS;
  const long long most = 8LL * sms;
  const unsigned int blocks =
      static_cast<unsigned int>(want < most ? want : most);
  seg_sum_kernel<<<blocks, SS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v, starts, g, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
