// Timestamp <-> UTC conversion in a time zone (GpuTimeZoneDB), for Hopper
// (sm_90a): one thread a row over the zone's transition table.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/timezones.py
// (`_convert_kernel` :296; no pallas_call). The reference's own CUDA is
// timezones.cu:50-90, a per-row upper_bound over the zone's span, as here.
// Each row truncates its timestamp to epoch seconds toward zero (C's `/`
// does; the JAX package writes the same fix-up of its floor division out),
// counts the zone's keys at or below it (an upper_bound: the JAX package's
// `searchsorted(side="right")`), takes the offset after the transition
// found, scales it to the column's unit (1, 1,000 or 1,000,000 ticks a
// second, a template parameter) and subtracts it (to UTC) or adds it (from
// UTC) in uint64, so that it wraps as XLA's int64 does (signed overflow is
// undefined in C++). Key 0 is INT64_MIN, so every row finds a transition.
//
// A zone without a recurring rule has a few to a few hundred transitions:
// each block loads the keys and offsets into shared memory once (12 bytes
// a transition, up to TZ_SHARED_MAX of them; a longer table is searched in
// device memory, where the L2 keeps it).
//
// What bounds it on this card: bytes. A row reads 8 bytes and writes 8;
// its search is log2(k) + 1 compares of shared memory, some 30 integer
// operations for the zones here, under the bytes' time at the card's
// integer rate (chip_smoke.py counts the bound).
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_convert` below loops over rows as the kernel does, so that
// tests/test_torch_timezones.py builds this file with the host compiler
// and holds it against the plain version.
//
// Plain C interface for ctypes: the launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// it neither synchronises nor allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TZ_FN __host__ __device__ __forceinline__
#else
#define TZ_FN static inline
#endif

#define THREADS 256
#define TZ_SHARED_MAX 2048

typedef long long i64;
typedef unsigned long long u64;

// keys at or below x, over k ascending keys
TZ_FN int tz_upper_bound(const i64* keys, int k, i64 x) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <i64 SCALE, bool TO_UTC>
TZ_FN i64 tz_row(i64 ts, const i64* keys, const int32_t* offsets, int k) {
  const int idx = tz_upper_bound(keys, k, ts / SCALE);
  // idx >= 1 (key 0 is INT64_MIN); 0 would read the last offset, as the
  // JAX package's offsets[-1] does
  const i64 off = static_cast<i64>(offsets[idx == 0 ? k - 1 : idx - 1]) *
                  SCALE;
  const u64 u = static_cast<u64>(ts), o = static_cast<u64>(off);
  return static_cast<i64>(TO_UTC ? u - o : u + o);
}

#ifdef __CUDACC__

template <i64 SCALE, bool TO_UTC>
__global__ void __launch_bounds__(THREADS)
tz_convert_kernel(const i64* ts, i64 n, const i64* keys,
                  const int32_t* offsets, int k, i64* out) {
  extern __shared__ i64 shared[];
  const bool in_shared = k <= TZ_SHARED_MAX;
  const i64* K = keys;
  const int32_t* O = offsets;
  if (in_shared) {
    int32_t* so = reinterpret_cast<int32_t*>(shared + k);
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      shared[j] = keys[j];
      so[j] = offsets[j];
    }
    __syncthreads();
    K = shared;
    O = so;
  }
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = tz_row<SCALE, TO_UTC>(ts[i], K, O, k);
}

static int blocks_for(i64 n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const i64 need = (n + THREADS - 1) / THREADS;
  const i64 cap = static_cast<i64>(sms) * 16;
  return static_cast<int>(need < cap ? need : cap);
}

template <i64 SCALE>
static void tz_launch(const i64* ts, i64 n, const i64* keys,
                      const int32_t* offsets, int k, bool to_utc, i64* out,
                      cudaStream_t s) {
  const size_t shared = k <= TZ_SHARED_MAX ? static_cast<size_t>(k) * 12 : 0;
  if (to_utc)
    tz_convert_kernel<SCALE, true><<<blocks_for(n), THREADS, shared, s>>>(
        ts, n, keys, offsets, k, out);
  else
    tz_convert_kernel<SCALE, false><<<blocks_for(n), THREADS, shared, s>>>(
        ts, n, keys, offsets, k, out);
}

extern "C" {

// n >= 1 rows of int64 timestamps in `scale` ticks a second (1, 1000 or
// 1000000); keys: (k,) ascending int64 seconds, keys[0] = INT64_MIN;
// offsets: (k,) int32 seconds; writes out: (n,) int64.
int tz_convert(const void* ts, long long n, const void* keys,
               const void* offsets, int k, int to_utc, int scale, void* out,
               void* stream) {
  if (n < 1 || k < 1 || ts == nullptr || keys == nullptr ||
      offsets == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const i64* t = static_cast<const i64*>(ts);
  const i64* kk = static_cast<const i64*>(keys);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  i64* w = static_cast<i64*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale == 1)
    tz_launch<1>(t, n, kk, o, k, to_utc != 0, w, s);
  else if (scale == 1000)
    tz_launch<1000>(t, n, kk, o, k, to_utc != 0, w, s);
  else if (scale == 1000000)
    tz_launch<1000000>(t, n, kk, o, k, to_utc != 0, w, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

template <i64 SCALE>
static void host_rows(const i64* ts, i64 n, const i64* keys,
                      const int32_t* offsets, int k, bool to_utc, i64* out) {
  for (i64 i = 0; i < n; ++i)
    out[i] = to_utc ? tz_row<SCALE, true>(ts[i], keys, offsets, k)
                    : tz_row<SCALE, false>(ts[i], keys, offsets, k);
}

extern "C" int host_convert(const void* ts, long long n, const void* keys,
                            const void* offsets, int k, int to_utc,
                            int scale, void* out) {
  if (n < 0 || k < 1) return 1;
  const i64* t = static_cast<const i64*>(ts);
  const i64* kk = static_cast<const i64*>(keys);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  i64* w = static_cast<i64*>(out);
  if (scale == 1)
    host_rows<1>(t, n, kk, o, k, to_utc != 0, w);
  else if (scale == 1000)
    host_rows<1000>(t, n, kk, o, k, to_utc != 0, w);
  else if (scale == 1000000)
    host_rows<1000000>(t, n, kk, o, k, to_utc != 0, w);
  else
    return 1;
  return 0;
}

#endif  // __CUDACC__
