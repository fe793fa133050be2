// Percentiles over histograms (Spark's percentile and approx_percentile,
// their final evaluation), for Hopper (sm_90a): one warp a histogram.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/histogram.py
// (`_percentile_kernel` :153; no pallas_call). The reference's own CUDA is
// histogram.cu:53-184, a thread a percentage over each histogram after a
// segmented sort. The JAX design finds each element by a segment sum of an
// (m, n_pct) indicator matrix; here a warp walks its own histogram once.
// The wrapper has sorted the elements (histogram, null last, value: three
// stable torch.sort passes, as the JAX package's lexsort), so histogram h
// is the sorted elements [offsets[h], offsets[h + 1]). The warp
//
// 1. drops the last element if it is null (`end`; only the last, as the
//    JAX package does), and gives a histogram left empty a null row;
// 2. scans the counts over [start, end) 32 at a time (shuffles and a
//    carry) into `acc`, int64 running sums, and notes whether any count
//    is negative; max_pos is the last sum less 1;
// 3. for each percentage: position = max_pos * pct, lower and higher its
//    floor and ceiling, and the element at start + the count of sums
//    below lower + 1 (and higher + 1), as the JAX package counts them:
//    where no count is negative the sums never fall and that count is a
//    binary search (one lane a percentage); where one is, the whole warp
//    counts linearly;
// 4. writes lo where higher == lower or the two elements are equal, else
//    (higher - position) * lo + (position - lower) * hi as XLA on the CPU
//    computes it: fma(higher - position, lo, (position - lower) * hi),
//    the second product rounded, then one rounding of the fused first
//    product and the sum (`__fma_rn`; the source is built with
//    -fmad=false, so that nvcc fuses nothing else).
//
// What bounds it on this card: bytes. The least work reads each element's
// value, validity and count once and writes n_pct doubles and a validity
// byte a histogram (chip_smoke.py counts the bound); the sums go through
// `acc` in device memory (8 bytes a element, written and read back by
// the same warp, mostly from the L1), and the sort before it moves more
// than the kernel does.
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_percentile` below runs each histogram as the warp does, its
// lanes in turn, so that tests/test_torch_histogram.py builds this file
// with the host compiler and holds it against the plain version.
//
// Plain C interface for ctypes: the launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// it neither synchronises nor allocates.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HG_FN __host__ __device__ __forceinline__
#else
#define HG_FN static inline
#endif

#define THREADS 256
#define WARP 32

typedef long long i64;
typedef unsigned long long u64;

struct HgArgs {
  const double* values;    // (m,) sorted
  const uint8_t* valid;    // (m,) sorted
  const i64* counts;       // (m,) sorted
  const int32_t* offsets;  // (n_hist + 1,)
  i64 n_hist, m;
  const double* pct;       // (n_pct,)
  int n_pct;
  i64* acc;                // (m,) scratch: the running sums
  double* out;             // (n_hist, n_pct)
  uint8_t* out_valid;      // (n_hist,)
};

// the rounded product, and a fused multiply-add (one rounding)
HG_FN double hg_mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
HG_FN double hg_fma(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return fma(a, b, c);
#endif
}

// [start, end) of histogram h; end <= start for one with no valid value
HG_FN void hg_bounds(const HgArgs& a, i64 h, i64* start, i64* end) {
  *start = a.offsets[h];
  const i64 try_end = a.offsets[h + 1];
  *end = (try_end > *start && a.valid[try_end - 1] == 0) ? try_end - 1
                                                         : try_end;
}

// the sums below target in acc[start, end), where they never fall
HG_FN i64 hg_lower_bound(const i64* acc, i64 start, i64 end, i64 target) {
  i64 lo = start, hi = end;
  while (lo < hi) {
    const i64 mid = lo + ((hi - lo) >> 1);
    if (acc[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - start;
}

HG_FN i64 hg_clip(i64 i, i64 m) { return i < 0 ? 0 : (i > m - 1 ? m - 1 : i); }

// the position and its floor and ceiling for percentage p
HG_FN double hg_position(const HgArgs& a, i64 max_pos, int p, i64* lower,
                         i64* higher) {
  const double position = hg_mul(static_cast<double>(max_pos), a.pct[p]);
  *lower = static_cast<i64>(floor(position));
  *higher = static_cast<i64>(ceil(position));
  return position;
}

// the percentile from the two elements' indexes (start + counts)
HG_FN double hg_value(const HgArgs& a, double position, i64 lower,
                      i64 higher, i64 lower_idx, i64 higher_idx) {
  const double lo = a.values[hg_clip(lower_idx, a.m)];
  const double hi = a.values[hg_clip(higher_idx, a.m)];
  if (higher == lower || hi == lo) return lo;
  return hg_fma(static_cast<double>(higher) - position, lo,
                hg_mul(position - static_cast<double>(lower), hi));
}

static bool hg_args_ok(const HgArgs& a) {
  return a.n_hist >= 1 && a.m >= 1 && a.n_pct >= 0 && a.values != nullptr &&
         a.valid != nullptr && a.counts != nullptr && a.offsets != nullptr &&
         a.acc != nullptr && a.out_valid != nullptr &&
         (a.n_pct == 0 || (a.pct != nullptr && a.out != nullptr));
}

static HgArgs hg_args(const void* values, const void* valid,
                      const void* counts, const void* offsets, i64 n_hist,
                      i64 m, const void* pct, int n_pct, void* acc, void* out,
                      void* out_valid) {
  HgArgs a;
  a.values = static_cast<const double*>(values);
  a.valid = static_cast<const uint8_t*>(valid);
  a.counts = static_cast<const i64*>(counts);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.n_hist = n_hist;
  a.m = m;
  a.pct = static_cast<const double*>(pct);
  a.n_pct = n_pct;
  a.acc = static_cast<i64*>(acc);
  a.out = static_cast<double*>(out);
  a.out_valid = static_cast<uint8_t*>(out_valid);
  return a;
}

#ifdef __CUDACC__

// the count of acc[start, end) below target, by the whole warp
__device__ __forceinline__ i64 hg_warp_count(const i64* acc, i64 start,
                                             i64 end, i64 target, int lane) {
  i64 cnt = 0;
  for (i64 base = start; base < end; base += WARP) {
    const bool below = base + lane < end && acc[base + lane] < target;
    cnt += __popc(__ballot_sync(0xFFFFFFFFu, below));
  }
  return cnt;
}

__global__ void __launch_bounds__(THREADS) hg_percentile_kernel(HgArgs a) {
  const int lane = threadIdx.x & (WARP - 1);
  const i64 warps = static_cast<i64>(gridDim.x) * (blockDim.x / WARP);
  for (i64 h = static_cast<i64>(blockIdx.x) * (blockDim.x / WARP) +
               threadIdx.x / WARP;
       h < a.n_hist; h += warps) {
    i64 start, end;
    hg_bounds(a, h, &start, &end);
    if (start >= end) {
      for (int p = lane; p < a.n_pct; p += WARP) a.out[h * a.n_pct + p] = 0.0;
      if (lane == 0) a.out_valid[h] = 0;
      continue;
    }
    // inclusive scan of the counts, 32 a step, with a carry
    u64 carry = 0;
    bool falls = false;
    for (i64 base = start; base < end; base += WARP) {
      const bool in = base + lane < end;
      const i64 c = in ? a.counts[base + lane] : 0;
      u64 s = static_cast<u64>(c);
      for (int d = 1; d < WARP; d <<= 1) {
        const u64 t = __shfl_up_sync(0xFFFFFFFFu, s, d);
        if (lane >= d) s += t;
      }
      s += carry;
      if (in) a.acc[base + lane] = static_cast<i64>(s);
      falls |= __any_sync(0xFFFFFFFFu, in && c < 0);
      carry = __shfl_sync(0xFFFFFFFFu, s, WARP - 1);
    }
    __syncwarp();
    const i64 max_pos = static_cast<i64>(carry - 1);
    if (!falls) {
      for (int p = lane; p < a.n_pct; p += WARP) {
        i64 lower, higher;
        const double pos = hg_position(a, max_pos, p, &lower, &higher);
        a.out[h * a.n_pct + p] = hg_value(
            a, pos, lower, higher,
            start + hg_lower_bound(a.acc, start, end, lower + 1),
            start + hg_lower_bound(a.acc, start, end, higher + 1));
      }
    } else {
      for (int p = 0; p < a.n_pct; ++p) {
        i64 lower, higher;
        const double pos = hg_position(a, max_pos, p, &lower, &higher);
        const i64 lo_idx =
            start + hg_warp_count(a.acc, start, end, lower + 1, lane);
        const i64 hi_idx =
            start + hg_warp_count(a.acc, start, end, higher + 1, lane);
        if (lane == 0)
          a.out[h * a.n_pct + p] =
              hg_value(a, pos, lower, higher, lo_idx, hi_idx);
      }
    }
    if (lane == 0) a.out_valid[h] = 1;
  }
}

static int blocks_for(i64 warps) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const i64 per_block = THREADS / WARP;
  const i64 need = (warps + per_block - 1) / per_block;
  const i64 cap = static_cast<i64>(sms) * 16;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

// n_hist >= 1 histograms over m >= 1 sorted elements: values (m,) float64,
// valid (m,) bool, counts (m,) int64, offsets (n_hist + 1,) int32, pct
// (n_pct,) float64; acc: (m,) int64 scratch; writes out (n_hist, n_pct)
// float64 and out_valid (n_hist,) bool.
int hg_percentile(const void* values, const void* valid, const void* counts,
                  const void* offsets, long long n_hist, long long m,
                  const void* pct, int n_pct, void* acc, void* out,
                  void* out_valid, void* stream) {
  const HgArgs a = hg_args(values, valid, counts, offsets, n_hist, m, pct,
                           n_pct, acc, out, out_valid);
  if (!hg_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  hg_percentile_kernel<<<blocks_for(n_hist), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

// each histogram as the warp runs it, its 32 lanes in turn
extern "C" int host_percentile(const void* values, const void* valid,
                               const void* counts, const void* offsets,
                               long long n_hist, long long m, const void* pct,
                               int n_pct, void* acc, void* out,
                               void* out_valid) {
  const HgArgs a = hg_args(values, valid, counts, offsets, n_hist, m, pct,
                           n_pct, acc, out, out_valid);
  if (!hg_args_ok(a)) return 1;
  for (i64 h = 0; h < a.n_hist; ++h) {
    i64 start, end;
    hg_bounds(a, h, &start, &end);
    if (start >= end) {
      for (int p = 0; p < a.n_pct; ++p) a.out[h * a.n_pct + p] = 0.0;
      a.out_valid[h] = 0;
      continue;
    }
    u64 carry = 0;
    bool falls = false;
    for (i64 base = start; base < end; base += WARP)
      for (i64 j = base; j < end && j < base + WARP; ++j) {
        carry += static_cast<u64>(a.counts[j]);
        a.acc[j] = static_cast<i64>(carry);
        falls |= a.counts[j] < 0;
      }
    const i64 max_pos = static_cast<i64>(carry - 1);
    for (int p = 0; p < a.n_pct; ++p) {
      i64 lower, higher;
      const double pos = hg_position(a, max_pos, p, &lower, &higher);
      i64 cnt[2] = {0, 0};
      const i64 targets[2] = {lower + 1, higher + 1};
      for (int k = 0; k < 2; ++k) {
        if (!falls) {
          cnt[k] = hg_lower_bound(a.acc, start, end, targets[k]);
        } else {
          for (i64 j = start; j < end; ++j) cnt[k] += a.acc[j] < targets[k];
        }
      }
      a.out[h * a.n_pct + p] =
          hg_value(a, pos, lower, higher, start + cnt[0], start + cnt[1]);
    }
    a.out_valid[h] = 1;
  }
  return 0;
}

#endif  // __CUDACC__
