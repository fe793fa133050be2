// TopK kernel for Hopper (sm_90a): the k smallest row tuples of a stable
// multi-key sort.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/ops/topk_pallas.py:
//   tk_select <- _topk_words / _topk_kernel_body (and the XLA sort that
//                merges the TPU's per-block candidates)
// and, with ops/topk_cuda.py around it, computes topk_table: the first
// min(k, rows) rows of sort_table(t, keys, ascending), ties included.
//
// - Tuples. The wrapper builds one 64-bit word per sort operand of
//   ops/sort.py's _key_operands (null rank, order-mapped value, descending
//   as bitwise NOT), with the sign bit flipped so that unsigned order is
//   the operand's signed order, and the row index as the last word. Every
//   tuple is unique, so the k smallest tuples in lexicographic order are
//   exactly the stable sort's first k rows. Words are word-major: word w
//   of row i is words[w * m + i].
// - Select. Each block loads a tile of T rows' tuples into shared memory
//   (rows past the end are all-ones sentinels, which sort last), sorts the
//   tile's row slots with a bitonic network (T/2 threads, one
//   compare-exchange each per stage, compares reading shared memory only)
//   and writes its k smallest tuples, k <= T. T is 1,024 rows for up to 24
//   words, 512 up to 48 and 256 up to 96, so the tile fits in shared
//   memory.
// - Merge, k <= T/2. The wrapper runs the same kernel again over the
//   candidates (blocks x k tuples), which shrinks them at least twofold,
//   until one block remains; that block's k tuples are the answer, in
//   order, and their last words are the row indices that take_table
//   gathers. The TPU ran k lexicographic arg-min passes per block and left
//   the merge to XLA's sort; here a sort of the tile in shared memory
//   replaces both, and no library sort runs.
// - Merge, k > T/2. A tile cannot halve k candidates, so the select keeps
//   min(k, T) per tile, a sorted run, and tk_merge merges runs in pairs,
//   keeping min(2L, k) of each pair, until one run remains. Each tuple
//   finds its place by a binary search in its partner run: i plus the
//   partner's tuples below it (strictly below for the left run, at or
//   below for the right one, so equal sentinels take distinct places).
//   This removes the TPU kernel's limit of 128 (its lane width): any k is
//   taken.
//
// What bounds it on this card. The function needs bytes only: the key
// columns read once and k rows written (130 MB on kernel_bench's table:
// 10M rows, k INT64 with nulls DESC and v FLOAT32 ASC, 39 us at 3.35 TB/s);
// the first launch reads the 4-word tuples, 320 MB (96 us). This design is
// bound by its sort instead: T log2(T)^2 / 4 compare-exchanges per tile,
// each a chain of dependent shared-memory reads behind a barrier, some
// 28,000 per 1,024-row tile; on an H100 80GB HBM3 at 700 W the five
// launches over that table take about 1 ms (PERF.md). Selecting the
// k smallest without sorting the whole tile is the next design's work. A
// merge pass reads every candidate's words in its binary search, log2(L)
// tuples each, from L2 once the runs are small.
//
// Plain C interface for ctypes. tk_select and tk_merge return
// cudaGetLastError() after their launch; they never synchronise and
// allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define TK_MAX_WORDS 96
#define TK_MERGE_THREADS 256

__device__ __forceinline__ bool tuple_less(const unsigned long long* s,
                                           int T, int W, int a, int b) {
  for (int w = 0; w < W; ++w) {
    const unsigned long long x = s[w * T + a], y = s[w * T + b];
    if (x != y) return x < y;
  }
  return false;
}

__global__ void tk_select_kernel(const unsigned long long* __restrict__ words,
                                 long long m, int W, int T, int k,
                                 unsigned long long* __restrict__ out,
                                 long long out_stride) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s = smem;                                // W x T
  unsigned short* slot = reinterpret_cast<unsigned short*>(s + W * T);
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int e = threadIdx.x; e < W * T; e += blockDim.x) {
    const int w = e / T, j = e - w * T;
    const long long row = base + j;
    s[e] = row < m ? words[static_cast<long long>(w) * m + row]
                   : ~0ull;
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x) slot[j] = j;
  __syncthreads();
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < T / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const int a = slot[i], b = slot[j];
        if (tuple_less(s, T, W, b, a) == up) {
          slot[i] = b;
          slot[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < W * k; e += blockDim.x) {
    const int w = e / k, j = e - w * k;
    out[static_cast<long long>(w) * out_stride +
        static_cast<long long>(blockIdx.x) * k + j] = s[w * T + slot[j]];
  }
}

// -1, 0 or 1: tuple i of a against tuple j of b (word-major, strides sa, sb)
__device__ __forceinline__ int tuple_cmp(const unsigned long long* a,
                                         long long sa, long long i,
                                         const unsigned long long* b,
                                         long long sb, long long j, int W) {
  for (int w = 0; w < W; ++w) {
    const unsigned long long x = a[w * sa + i], y = b[w * sb + j];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// runs: in holds R = m / L sorted runs of L tuples; run r and r ^ 1 merge
// into out's run r / 2, of which the first L2 = min(2L, k) are kept
__global__ void tk_merge_kernel(const unsigned long long* __restrict__ in,
                                long long m, int W, long long L, long long L2,
                                unsigned long long* __restrict__ out,
                                long long out_stride) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < m; e += step) {
    const long long run = e / L, i = e - run * L;
    const long long partner = (run ^ 1) * L;
    long long lo = 0;
    if (partner < m) {
      const bool right = (run & 1) != 0;
      long long hi = L;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        const int c = tuple_cmp(in, m, partner + mid, in, m, e, W);
        if (c < 0 || (right && c == 0)) lo = mid + 1; else hi = mid;
      }
    }
    const long long pos = i + lo;
    if (pos < L2) {
      const long long at = (run >> 1) * L2 + pos;
      for (int w = 0; w < W; ++w)
        out[w * out_stride + at] = in[w * m + e];
    }
  }
}

extern "C" {

int tk_tile_rows(int W) {
  if (W <= 24) return 1024;
  if (W <= 48) return 512;
  if (W <= TK_MAX_WORDS) return 256;
  return 0;
}

// words: W x m (word-major); out: W x (blocks * k) with blocks = ceil(m / T)
int tk_select(const void* words, long long m, int W, int k, void* out,
              void* stream) {
  const int T = tk_tile_rows(W);
  if (m <= 0 || W < 1 || T == 0 || k < 1 || k > T)
    return cudaErrorInvalidValue;
  const long long blocks = (m + T - 1) / T;
  const size_t smem = static_cast<size_t>(W) * T * 8 + T * 2;
  cudaError_t err = cudaFuncSetAttribute(
      tk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tk_select_kernel<<<static_cast<unsigned int>(blocks), T / 2, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(words), m, W, T, k,
      static_cast<unsigned long long*>(out), blocks * k);
  return static_cast<int>(cudaGetLastError());
}

// in: W x m, m a multiple of L; out: W x (ceil(m / L / 2) * L2), filled
// with all-ones sentinels beforehand (a run without a partner leaves its
// last L2 - L places to them)
int tk_merge(const void* in, long long m, int W, long long L, long long L2,
             void* out, void* stream) {
  if (m <= 0 || W < 1 || W > TK_MAX_WORDS || L < 1 || m % L != 0 ||
      L2 < L || L2 > 2 * L)
    return cudaErrorInvalidValue;
  const long long need = (m + TK_MERGE_THREADS - 1) / TK_MERGE_THREADS;
  const unsigned int blocks =
      static_cast<unsigned int>(need < (1 << 20) ? need : (1 << 20));
  const long long runs = m / L;
  tk_merge_kernel<<<blocks, TK_MERGE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(in), m, W, L, L2,
      static_cast<unsigned long long*>(out), (runs + 1) / 2 * L2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
