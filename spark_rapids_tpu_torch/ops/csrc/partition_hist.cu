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
//
// The same source holds the exchange map, `px_exchange_map` (below): the
// receiver-side gather map of the all-to-all exchange of P peers that live
// on this one card, built from per-block counts, a scan over the blocks
// and an in-block rank, with no sort. Its own comment says how.

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

// ---------------------------------------------------------------------------
// The exchange map: for partition ids `part` of P source peers, s rows each
// ((P, s) int32, peer i's rows at [i*s, (i+1)*s)), and a capacity `cap`,
//
//   counts[src][dst]        rows of source src whose id is dst, (P, P) int32;
//   gidx[dst][src][slot]    for slot < min(counts[src][dst], cap): the
//                           global row (src*s + r) of the slot-th row of
//                           source src in bucket dst, in row order; 0 in
//                           every other slot, (P, P, cap) int32.
//
// Replaces the reference's per-peer map (spark_rapids_tpu/parallel/
// shuffle.py:67-88: a stable argsort of the ids and two searchsorteds)
// followed by its tiled all_to_all (:103-112): on one card the all-to-all
// is a relabelling of the (src, dst) buckets, so the map is written
// straight into the received layout, and the payload is one gather
// through it. Rows past `cap` in a bucket are dropped and show as
// counts > cap; ids outside [0, P) fall in no bucket.
//
// A row's slot is its stable rank in its bucket, found without a sort in
// three launches:
//   1. xm_count: each block of BLOCK_ROWS rows of one source counts its
//      ids in shared memory (as ph_histogram does) and writes its P counts;
//   2. xm_scan: one thread a (source, bucket) turns the blocks' counts
//      into exclusive prefix sums in place and writes counts[src][dst];
//   3. xm_rank: each block walks its rows in rounds of THREADS rows, in
//      order. In a round, each warp groups its lanes by id
//      (__match_any_sync); a lane's rank is its block's running count of
//      its id, plus the lanes of the same id in the warps before it (each
//      warp's group sizes go to shared memory), plus the lanes of the
//      same id before it in its warp; then the running counts grow by the
//      round's groups. Rank = the block's prefix + that, and the lane
//      writes its global row into gidx when the rank is below `cap`.
//
// The limit: xm_rank keeps (WARPS + 1) x P int32 counters in 48 KB of
// shared memory, so P <= 1365 (px_max_partitions). The caller zeroes
// nothing: the entry point clears gidx itself. Rows are int32 global row
// ids, so P * s must stay below 2^31, as the reference's int32 map.
//
// What bounds it on this card: bytes. The ids are read twice (count and
// rank passes; the bound counts them once, 4 B a row) and each live map
// entry is written once (4 B); the scan reads and writes the P x P x
// blocks counts.

#define XM_BLOCK_ROWS 8192        // rows one block counts and ranks
#define XM_MAX_P (SHARED_BYTES / (4 * (WARPS + 1)))

__global__ void __launch_bounds__(THREADS)
xm_count(const int* part, long long s, int P, long long nb,
         int* block_counts) {
  extern __shared__ int cnt[];  // P counters
  const int src = blockIdx.y;
  const long long blk = blockIdx.x;
  for (int b = threadIdx.x; b < P; b += THREADS) cnt[b] = 0;
  __syncthreads();
  const int* p = part + static_cast<long long>(src) * s;
  const long long lo = blk * XM_BLOCK_ROWS;
  const long long hi = lo + XM_BLOCK_ROWS < s ? lo + XM_BLOCK_ROWS : s;
  for (long long r = lo + threadIdx.x; r < hi; r += THREADS)
    count_one(cnt, P, p[r]);
  __syncthreads();
  int* out = block_counts + (static_cast<long long>(src) * nb + blk) * P;
  for (int b = threadIdx.x; b < P; b += THREADS) out[b] = cnt[b];
}

// Exclusive prefix sums over the blocks, in place, per (source, bucket).
__global__ void xm_scan(int* block_counts, long long nb, int P,
                        int* counts) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(P) * P) return;
  const long long src = t / P;
  const int b = static_cast<int>(t % P);
  int* col = block_counts + src * nb * P + b;
  int running = 0;
  for (long long blk = 0; blk < nb; ++blk) {
    const int c = col[blk * P];
    col[blk * P] = running;
    running += c;
  }
  counts[t] = running;
}

__global__ void __launch_bounds__(THREADS)
xm_rank(const int* part, long long s, int P, long long nb, int cap,
        const int* block_base, int* gidx) {
  extern __shared__ int sh[];
  int* running = sh;       // P: the block's prefix plus its earlier rounds
  int* wc = sh + P;        // WARPS x P: this round's group size per warp
  const int src = blockIdx.y;
  const long long blk = blockIdx.x;
  const int* base = block_base + (static_cast<long long>(src) * nb + blk) * P;
  for (int b = threadIdx.x; b < P; b += THREADS) running[b] = base[b];
  for (int b = threadIdx.x; b < WARPS * P; b += THREADS) wc[b] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned before_me = (1u << lane) - 1u;
  const int* p = part + static_cast<long long>(src) * s;
  const long long lo = blk * XM_BLOCK_ROWS;
  const long long hi = lo + XM_BLOCK_ROWS < s ? lo + XM_BLOCK_ROWS : s;
  for (long long r0 = lo; r0 < hi; r0 += THREADS) {  // same trips block-wide
    const long long r = r0 + threadIdx.x;
    const int id = r < hi ? p[r] : -1;
    const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(P);
    const unsigned same = __match_any_sync(0xffffffffu, id);
    const int before = __popc(same & before_me);
    const int group = __popc(same);
    if (ok && before == 0) wc[warp * P + id] = group;
    __syncthreads();
    int rank = 0;
    if (ok) {
      rank = running[id] + before;
      for (int w = 0; w < warp; ++w) rank += wc[w * P + id];
    }
    __syncthreads();
    if (ok && before == 0) {
      atomicAdd(&running[id], group);
      wc[warp * P + id] = 0;
    }
    __syncthreads();
    if (ok && rank < cap)
      gidx[(static_cast<long long>(id) * P + src) * cap + rank] =
          static_cast<int>(static_cast<long long>(src) * s + r);
  }
}

extern "C" {

int px_max_partitions() { return XM_MAX_P; }

int px_block_rows() { return XM_BLOCK_ROWS; }

// counts: (P, P) int32; gidx: (P, P, cap) int32; scratch: (P, nb, P) int32
// with nb = ceil(s / px_block_rows()). Clears gidx, then three launches.
int px_exchange_map(const int* part, long long s, int P, int cap,
                    int* counts, int* gidx, int* scratch, void* stream) {
  if (s < 1 || P < 1 || P > XM_MAX_P || cap < 1 || !part || !counts ||
      !gidx || !scratch || static_cast<long long>(P) * s > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nb = (s + XM_BLOCK_ROWS - 1) / XM_BLOCK_ROWS;
  cudaError_t e = cudaMemsetAsync(
      gidx, 0, static_cast<size_t>(P) * P * cap * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(P));
  xm_count<<<grid, THREADS, static_cast<size_t>(P) * 4, st>>>(part, s, P,
                                                              nb, scratch);
  const long long pairs = static_cast<long long>(P) * P;
  xm_scan<<<static_cast<unsigned>((pairs + THREADS - 1) / THREADS), THREADS,
            0, st>>>(scratch, nb, P, counts);
  xm_rank<<<grid, THREADS, static_cast<size_t>(WARPS + 1) * P * 4, st>>>(
      part, s, P, nb, cap, scratch, gidx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
