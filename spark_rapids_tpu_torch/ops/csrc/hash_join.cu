// Hash-join build / probe-count / probe-emit / existence kernels for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of spark_rapids_tpu/ops/join_pallas.py:
//   hj_build  <- _build_kernel_body (via _build_table)
//   hj_count  <- _count_kernel_body (via _run_probe / _probe_counts)
//   hj_emit   <- _emit_kernel_body  (via _run_probe / _probe_emit)
//   hj_capped <- _count_kernel_body and _emit_kernel_body as
//                inner_join_capped_pallas (join_pallas.py:400) runs them
// and computes the same functions. hj_exists replaces no Pallas kernel: it
// is the semi and anti joins' probe (spark_rapids_tpu/ops/join.py
// left_semi_join, left_anti_join, semi_join_mask, sort-based there).
//
// - Bucket hash: Spark murmur3_32 with seed 42, chained over the key
//   columns. 1/2/4-byte keys hash as one word (sign-extended through int32),
//   8-byte keys (and DECIMAL32, which hashes as a long) as two words, lo then
//   hi; each column ends with fmix(h ^ nbytes). Slot = (h + d) & (C - 1).
// - Build: the open-addressing table that the TPU kernel's parallel rounds
//   leave (every unplaced valid row proposes slot (h + d) & (C-1), the
//   lowest row id wins a free slot, losers advance), slot for slot, but
//   computed without rounds (see "the build" below). Equal keys land in
//   ascending-row chain order, which is what makes emission match the
//   sort-based fallback pair for pair. Invalid rows are never inserted.
//   Two routes by capacity. Small, C <= 1,024 (build sides up to 512 rows,
//   the reference's limit): one block, everything in shared memory, written
//   out as (slot_row, slot_hash): the row id (-1 = empty) and its 32-bit
//   hash. Large, C up to 2^23 (2^22 build rows, a 64 MB table): six
//   ordinary launches, the table in global memory as one 8-byte word a
//   slot, hash << 32 | row, the word the probes read. The key values stay
//   in the build columns.
// - Probe count: per probe row, the build rows with equal keys, walking from
//   the bucket to the first empty slot; invalid rows count 0. Per tile of
//   PROBE_TILE = 2,048 rows the count also gives its sum, and the last
//   block to finish scans the tile sums into int64 tile offsets and the
//   total: the host reads the total (the one sync) and runs nothing over
//   the probe rows before the emit.
// - Emit: the (probe row, build row) pairs, probe row ascending, then chain
//   order. A row's first pair goes to its tile's offset plus the pairs of
//   the rows before it in its tile. The TPU kernel re-walked once per
//   output slot from every row's start; one walk per matched row gives the
//   same maps.
//
// - Key kinds: fixed-width integers take the kernels as below (K = Keys);
//   key sets with a STRING, DECIMAL128 or float column take a second
//   instantiation of every kernel (K = VKeys, the `_var` entry points:
//   "variable-width keys" below), so the integer joins keep their code.
//
// Hopper has native 32- and 64-bit integers, so the TPU's u16-half and
// one-hot MXU gathers are not carried over. Nor is the reference's VMEM
// limit of 512 build rows: past the small route's 1,024 slots the table
// lives in global memory (1 MB at q72's 52,000-row inventory, resident in
// L2), and the probes read it there.
//
// What bounds the probes on this card, and what the design does about it.
// The count over q3's first join (10M INT64 probe keys, 310 build rows, 8.5%
// of rows matched) must read 80 MB of keys and write 40 MB of counts: 36 us
// at 3.35 TB/s; its murmur3 hashes are about 20 us of the card's integer
// rate. On an H100 80GB HBM3 at 700 W it takes about twice that (PERF.md):
// its loads, hash and stores alone run near the byte bound; the rest is
// each warp's chain of dependent steps per 256 rows (Bloom test,
// compaction of candidates, walk, list) and their instructions, at the 24
// warps an SM holds at 80 registers a thread.
// - Count: a persistent grid (as many blocks as the card holds at once)
//   walks the tiles. Warp w of a block takes segment w of each tile
//   (PROBE_SEG = 256 rows), a lane 8 consecutive rows, and no warp waits for
//   another. A lane issues every key and validity load of its rows before
//   it hashes any: 16-byte vector loads where the column's address allows
//   (the kernel checks), scalar loads otherwise and at the column's end, so
//   a view at any element offset is exact. Counts are stored 16 bytes at a
//   time.
//   Each block stages in shared memory, once: the table as one word a slot
//   (hash | row id), so a step of the walk is one shared load; for every
//   occupied slot the build row's values of the first SMEM_KEY_COLS = 4 key
//   columns (32 KB at C = 1,024; key columns past the fourth are compared
//   against the build columns in global memory, since 32 columns x 8 B x
//   1,024 slots = 256 KB would not fit); and a 65,536-bit Bloom filter of
//   the build rows' hashes. A row the filter rejects counts 0 without a
//   walk (91% of q3's rows). The warp's other rows are compacted (ballots)
//   and walked 32 at a time, one a lane, so the walks run on full warps.
//   Per segment the warp writes a list of its matched rows (entries: row in
//   the tile, first matching slot, count), their number and its pairs; each
//   block sums its tiles' segments, and the last block scans the tiles.
//   Tile sums, offsets, total and the last block's ticket live in each
//   call's own scratch, the ticket zeroed on the launch stream, so calls on
//   two streams at once share nothing.
// - Emit: a persistent grid over the same tiles, warp w on segment w. It
//   reads the segment's list (4 bytes a matched row), never the counts or
//   the probe keys: a warp scan of the entries' counts gives each its
//   first pair, after the tile's offset and the tile's earlier segments.
//   Each entry walks from its first matching slot, taking the slots whose
//   hash and keys equal that slot's build row's. Re-hashing the matched
//   rows instead would read every row's count (40 MB) and the sectors that
//   hold a matched row's key (about a third of 80 MB); the list costs the
//   count 4 bytes a matched row written. The pairs go to the warp's part of
//   shared memory and out as one contiguous run per map; a segment of more
//   than EMIT_STAGE pairs (512 equal build keys give 512 a row) writes them
//   in place, in the same order. Its bound is the list, the pairs and the
//   table: 10.6 MB at q3's first join.
// - The large route's probes are the same kernels (count_kernel<true>,
//   emit_kernel<true>): they read the table and the build keys where they
//   lie instead of staging them, skip the Bloom filter (see Route<true>),
//   and write 64-bit list entries (row in the tile 11 bits, first slot 23,
//   count 30), since a slot needs up to 23 bits and a count up to the
//   ceiling.
// - Exists: the count's walk, stopping at a row's first match, one byte a
//   probe row (1 = it has a match), with the count's tiling, vector loads,
//   Bloom filter (small route) and ballot compaction, and nothing else: no
//   counts, lists, sums or total, so no host read. A semi join is the
//   mask, an anti join its complement.
// - Capped probe (hj_capped, the capped tier's inner join after the build
//   over the live build rows): the count's segments and the emit's walk
//   in one launch, over a padded probe frame whose rows are mostly dead.
//   It must read the live mask, the validity and the live rows' keys,
//   and write row_cap slots of two maps and `valid`: at q72's inventory
//   join some 0.03 ms of bytes. The TPU form's count and emit wrote and
//   read back a count and a list entry for every padded row, and torch
//   ops then masked every slot. Here a lane whose 8 rows are all dead
//   loads no key and a warp of dead rows hashes nothing; the lists stay
//   in shared memory; each tile's offset comes from a decoupled look-back
//   (tiles taken in order from a counter, so a tile waits only on tiles
//   that running blocks hold); every slot of the maps and `valid` and the
//   overflow flag are written by the kernel, so nothing runs over the
//   slots afterwards and nothing is read on the host.
// The build's bound is its bytes (keys in, table out). The small build is
// bound by its one launch; the large one by its six launches at q72's
// 52,000 rows (3-6 us each), and at q74's 489,258 strings by hashing the
// strings, the bucket fill's random writes and the table kernel's chain of
// dependent loads (PERF.md).
//
// Plain C interface for ctypes. Every entry point returns
// cudaGetLastError() after its launch (or cudaErrorInvalidValue for
// arguments it does not take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <type_traits>

#define MAX_KEYS 32
#define SMALL_CAPACITY 1024                      // the small route's tables
#define SMALL_BUILD_ROWS (SMALL_CAPACITY / 2)
#define MAX_CAPACITY (1 << 23)                   // the large route's tables
#define MAX_BUILD_ROWS (MAX_CAPACITY / 2)
#define BUILD_THREADS 1024
#define PROBE_THREADS 256
#define PROBE_WARPS (PROBE_THREADS / 32)
#define PROBE_R 8                                // rows a thread
#define PROBE_TILE (PROBE_THREADS * PROBE_R)     // rows a tile
#define SMEM_KEY_COLS 4                          // key columns in shared
#define PROBE_SEG (32 * PROBE_R)                 // rows a warp: a segment
#define PROBE_SEGS (PROBE_TILE / PROBE_SEG)      // segments a tile
#define EMIT_STAGE 256                           // pairs staged a segment
#define BLOOM_WORDS 2048                         // 65,536 bits

static_assert(PROBE_R == 8, "the vector loads and stores take 8 rows");
static_assert(SMALL_CAPACITY % PROBE_THREADS == 0,
              "a thread stages whole slots");

// a matched row's entry in its tile's list: its row in the tile (11 bits),
// its first matching slot and its count. The small route packs them in 32
// bits (slot 10 bits, count 11); the large route in 64 (slot 23, count 30).
#define ENT_SLOT_SHIFT 11
#define ENT_COUNT_SHIFT 21
#define WIDE_ENT_COUNT_SHIFT 34
static_assert(PROBE_TILE <= (1 << ENT_SLOT_SHIFT) &&
                  SMALL_CAPACITY <= (1 << (ENT_COUNT_SHIFT - ENT_SLOT_SHIFT)) &&
                  SMALL_BUILD_ROWS < (1 << (32 - ENT_COUNT_SHIFT)) &&
                  MAX_CAPACITY <= (1LL << (WIDE_ENT_COUNT_SHIFT -
                                          ENT_SLOT_SHIFT)) &&
                  MAX_BUILD_ROWS < (1LL << (64 - WIDE_ENT_COUNT_SHIFT)),
              "an entry's fields fit their bits");
// a segment's pairs fit an int: PROBE_SEG rows of at most MAX_BUILD_ROWS
static_assert(static_cast<long long>(PROBE_SEG) * MAX_BUILD_ROWS <= INT_MAX,
              "a segment's pairs fit 32 bits");



struct Keys {
  const void* data[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];  // torch.bool bytes; null = all valid
  const unsigned char* alive;            // the capped tier's live rows, or null
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

// one key column's step of the bucket hash
__device__ __forceinline__ uint32_t hash_col(uint32_t h, long long v,
                                             int wide) {
  uint32_t nh = mm_round(h, static_cast<uint32_t>(v));
  if (wide)
    nh = mm_round(nh, static_cast<uint32_t>(
                          static_cast<unsigned long long>(v) >> 32));
  return mm_fmix(nh ^ (wide ? 8u : 4u));
}

__device__ __forceinline__ bool row_valid(const Keys& k, long long i) {
  if (k.alive != nullptr && !k.alive[i]) return false;
  for (int j = 0; j < k.nk; ++j)
    if (k.valid[j] != nullptr && !k.valid[j][i]) return false;
  return true;
}

__device__ __forceinline__ uint32_t row_hash(const Keys& k, long long i) {
  uint32_t h = 42u;
  for (int j = 0; j < k.nk; ++j) h = hash_col(h, load_key(k, j, i), k.wide[j]);
  return h;
}

// ---- variable-width keys ---------------------------------------------------
//
// Key sets with a STRING, DECIMAL128, FLOAT32 or FLOAT64 column take their
// own instantiation of every kernel (K = VKeys), so the fixed-width kernels
// (K = Keys) keep their code and registers. A VKeys column has a kind:
// - VK_FIXED: an integer as Keys holds it (width 1, 2, 4 or 8, `wide`);
// - VK_F32, VK_F64: the float's bits normalized as ops/sort.py's
//   _float_total_order normalizes them (-0.0 becomes 0.0, every NaN the
//   canonical quiet NaN), then hashed and compared as a 4- or 8-byte int:
//   0.0 matches -0.0, and NaN matches NaN, as in the sort-based join;
// - VK_DEC128: (n, 4) u32 limbs, four rounds then fmix(h ^ 16);
// - VK_STRING: chars read through int32 offsets, hashed as Spark's murmur3
//   of bytes (the row hash's byte path: 4-byte little-endian blocks, each
//   tail byte a sign-extended signed char, fmix(h ^ length)); equal when
//   the lengths and then the bytes are. A string of 0 bytes reads nothing,
//   so an empty chars buffer may have a null pointer.
// The bucket hash is internal: only the plain version (ops/join_cuda.py)
// has to compute the same one, for the tables to be equal slot for slot.
// Keys are compared in full at every step of a walk (after the hash), not
// staged in shared memory: a probe row's key is read where it lies.
enum { VK_FIXED = 0, VK_F32 = 1, VK_F64 = 2, VK_DEC128 = 3, VK_STRING = 4 };

struct VKeys {
  const void* data[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];  // torch.bool bytes; null = all valid
  const unsigned char* alive;            // the capped tier's live rows, or null
  const int* offsets[MAX_KEYS];          // STRING: (n + 1,) int32
  int width[MAX_KEYS];                   // VK_FIXED: storage bytes
  int wide[MAX_KEYS];                    // hashed as 8 bytes
  int kind[MAX_KEYS];                    // VK_*
  int nk;
};

template <typename K>
struct IsVar : std::false_type {};
template <>
struct IsVar<VKeys> : std::true_type {};

__device__ __forceinline__ unsigned int norm_f32(unsigned int u) {
  if ((u & 0x7fffffffu) == 0u) return 0u;                       // -0.0
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc00000u;      // NaN
  return u;
}

__device__ __forceinline__ unsigned long long norm_f64(unsigned long long u) {
  const unsigned long long mag = u & 0x7fffffffffffffffull;
  if (mag == 0ull) return 0ull;
  if (mag > 0x7ff0000000000000ull) return 0x7ff8000000000000ull;
  return u;
}

// a fixed-width or float key's value as hash_col takes it
__device__ __forceinline__ long long vword(const VKeys& k, int j,
                                           long long i) {
  switch (k.kind[j]) {
    case VK_F32:
      return static_cast<int>(
          norm_f32(static_cast<const unsigned int*>(k.data[j])[i]));
    case VK_F64:
      return static_cast<long long>(
          norm_f64(static_cast<const unsigned long long*>(k.data[j])[i]));
    default:
      switch (k.width[j]) {
        case 1: return static_cast<const signed char*>(k.data[j])[i];
        case 2: return static_cast<const short*>(k.data[j])[i];
        case 4: return static_cast<const int*>(k.data[j])[i];
        default: return static_cast<const long long*>(k.data[j])[i];
      }
  }
}

__device__ __forceinline__ uint32_t mm_string(uint32_t h,
                                              const unsigned char* c,
                                              int len) {
  const int blocks = len >> 2;
  for (int q = 0; q < blocks; ++q) {
    const unsigned char* w = c + 4 * q;
    h = mm_round(h, static_cast<uint32_t>(w[0]) |
                        (static_cast<uint32_t>(w[1]) << 8) |
                        (static_cast<uint32_t>(w[2]) << 16) |
                        (static_cast<uint32_t>(w[3]) << 24));
  }
  for (int t = 4 * blocks; t < len; ++t)
    h = mm_round(h, static_cast<uint32_t>(static_cast<int>(
                        static_cast<signed char>(c[t]))));
  return mm_fmix(h ^ static_cast<uint32_t>(len));
}

__device__ __forceinline__ uint32_t row_hash(const VKeys& k, long long i) {
  uint32_t h = 42u;
  for (int j = 0; j < k.nk; ++j) {
    const int kind = k.kind[j];
    if (kind == VK_STRING) {
      const int a = k.offsets[j][i], e = k.offsets[j][i + 1];
      h = mm_string(h, static_cast<const unsigned char*>(k.data[j]) + a,
                    e - a);
    } else if (kind == VK_DEC128) {
      const uint32_t* q = static_cast<const uint32_t*>(k.data[j]) + 4 * i;
      h = mm_round(mm_round(mm_round(mm_round(h, q[0]), q[1]), q[2]), q[3]);
      h = mm_fmix(h ^ 16u);
    } else {
      h = hash_col(h, vword(k, j, i), k.wide[j]);
    }
  }
  return h;
}

__device__ __forceinline__ bool row_valid(const VKeys& k, long long i) {
  if (k.alive != nullptr && !k.alive[i]) return false;
  for (int j = 0; j < k.nk; ++j)
    if (k.valid[j] != nullptr && !k.valid[j][i]) return false;
  return true;
}

// row i of a and row r of b have equal keys (a and b: the same kinds)
__device__ __forceinline__ bool vkeys_equal(const VKeys& a, long long i,
                                            const VKeys& b, long long r) {
  for (int j = 0; j < a.nk; ++j) {
    const int kind = a.kind[j];
    if (kind == VK_STRING) {
      const int ai = a.offsets[j][i], bi = b.offsets[j][r];
      const int len = a.offsets[j][i + 1] - ai;
      if (b.offsets[j][r + 1] - bi != len) return false;
      const unsigned char* x = static_cast<const unsigned char*>(a.data[j]) + ai;
      const unsigned char* y = static_cast<const unsigned char*>(b.data[j]) + bi;
      for (int t = 0; t < len; ++t)
        if (x[t] != y[t]) return false;
    } else if (kind == VK_DEC128) {
      const uint32_t* x = static_cast<const uint32_t*>(a.data[j]) + 4 * i;
      const uint32_t* y = static_cast<const uint32_t*>(b.data[j]) + 4 * r;
      if (x[0] != y[0] || x[1] != y[1] || x[2] != y[2] || x[3] != y[3])
        return false;
    } else if (vword(a, j, i) != vword(b, j, r)) {
      return false;
    }
  }
  return true;
}

// ---- the build -------------------------------------------------------------
//
// The reference's rounds have a closed form. In round r every unplaced row
// has distance r and proposes h + r, so the unplaced rows of one home
// bucket b travel together and reach slot b + r in round r, where no other
// bucket's rows arrive in that round. A slot is taken by the first bucket
// to reach it with rows left, the one whose home is nearest, and that
// bucket gives its lowest remaining row. So, with cnt[s] the valid rows of
// bucket s and rem[s] = max(rem[s-1] + cnt[s] - 1, 0) the rows still
// waiting after slot s:
// - slot s is occupied iff rem[s-1] + cnt[s] > 0;
// - read each bucket's rows, in descending row order, as opening brackets
//   at its home slot and each occupied slot as a closing one: slot s takes
//   the row whose bracket it closes. That row's bucket is b = x + 1, for x
//   the last slot before s with rem[x] <= rem[s], and it is b's row at
//   index cnt[b] - 1 - (rem[s] - rem[x]) of its rows in ascending order.
//   The search back from s takes 1 + the row's distance steps: the work of
//   the rounds' proposals, done at once instead of round by round.
// - The maps x -> max(x + p, q) compose associatively, (p, q) then (p', q')
//   giving (p + p', max(q + p', q')), so rem is a scan of the slots' maps
//   (cnt[s] - 1, 0). The ring wraps: for T the composition of all C maps,
//   rem[C - 1] = T(T(0)), since n <= C / 2 leaves an empty slot, after
//   which a second lap is exact. The scan's p over slots [0, s) is also
//   the rows of the buckets before s, less s: the bucket offsets.
// - rounds = 1 + the largest distance of a placed row (0 when no row is
//   valid): the rounds the reference runs.
// The small build runs this in one block in shared memory, one launch. The
// large one takes six launches (bl_*_kernel): hash and count, the tiles'
// scan, the slots' scan, the rows into their buckets, each bucket's rows
// sorted, the table. Its search back from a slot reads minima of rem over
// blocks of 32, 1,024, 32,768 and 2^20 slots, so a chain of L equal keys
// costs O(L) reads, not O(L^2). No grid-wide barrier, no library call.

// warp-wide inclusive sum
template <typename T>
__device__ __forceinline__ T warp_incl(T x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

#define PQ_NONE (INT_MIN / 4)                    // the identity map's q

struct PQ {
  int p, q;
};

// the map a, then the map b
__device__ __forceinline__ PQ pq_then(PQ a, PQ b) {
  return PQ{a.p + b.p, max(a.q + b.p, b.q)};
}

// warp-wide inclusive composition, in lane order
__device__ __forceinline__ PQ warp_scan_pq(PQ x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int p = __shfl_up_sync(0xffffffffu, x.p, off);
    const int q = __shfl_up_sync(0xffffffffu, x.q, off);
    if (lane >= off) x = pq_then(PQ{p, q}, x);
  }
  return x;
}

// block-wide inclusive composition, in thread order (blockDim.x a multiple
// of 32); *total gets the whole block's. warp_tot: 32 entries of shared
// memory. Syncs the block.
__device__ __forceinline__ PQ block_scan_pq(PQ x, PQ* warp_tot, PQ* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  x = warp_scan_pq(x, lane);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const PQ w = lane < warps ? warp_tot[lane] : PQ{0, PQ_NONE};
    warp_tot[lane] = warp_scan_pq(w, lane);
  }
  __syncthreads();
  if (warp > 0) x = pq_then(warp_tot[warp - 1], x);
  *total = warp_tot[warps - 1];
  __syncthreads();                               // warp_tot is reused
  return x;
}

// rem[C - 1]: the ring's composition T applied twice to 0
__device__ __forceinline__ int ring_start(PQ T) {
  return max(max(T.p, T.q) + T.p, T.q);
}

// The small route, C <= SMALL_CAPACITY: one block, in shared memory. The
// rows go into their buckets in ascending order by counting, for each row,
// the rows before it with its bucket (at most 511 shared reads a thread).
template <typename K>
__global__ void __launch_bounds__(BUILD_THREADS)
build_kernel(const __grid_constant__ K b, int n, int C, int* slot_row_out,
             uint32_t* slot_hash_out) {
  __shared__ int cnt[SMALL_CAPACITY];
  __shared__ int off[SMALL_CAPACITY];
  __shared__ int rem[SMALL_CAPACITY];
  __shared__ int bucket[SMALL_BUILD_ROWS];       // -1: never inserted
  __shared__ uint32_t hs[SMALL_BUILD_ROWS];
  __shared__ int rows[SMALL_BUILD_ROWS];         // by bucket, ascending
  __shared__ PQ warp_tot[32];
  const int t = threadIdx.x;
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  if (t < C) cnt[t] = 0;
  __syncthreads();
  if (t < n) {
    const bool ok = row_valid(b, t);             // invalid rows never insert
    const uint32_t h = ok ? row_hash(b, t) : 0u;
    hs[t] = h;
    bucket[t] = ok ? static_cast<int>(h & mask) : -1;
    if (ok) atomicAdd(&cnt[h & mask], 1);
  }
  __syncthreads();
  const int c = t < C ? cnt[t] : 0;
  PQ T;
  const PQ incl = block_scan_pq(t < C ? PQ{c - 1, 0} : PQ{0, PQ_NONE},
                                warp_tot, &T);
  if (t < C) {
    rem[t] = max(ring_start(T) + incl.p, incl.q);
    off[t] = incl.p - (c - 1) + t;
  }
  __syncthreads();
  if (t < n && bucket[t] >= 0) {
    const int bk = bucket[t];
    int rank = 0;
    for (int j = 0; j < t; ++j) rank += bucket[j] == bk;
    rows[off[bk] + rank] = t;
  }
  __syncthreads();
  if (t < C) {
    int row = -1;
    uint32_t h = 0u;
    const int r = rem[t];
    if (rem[(t - 1) & mask] + c > 0) {
      int x = t - 1;                             // an empty slot has rem 0
      while (rem[x & mask] > r) --x;
      const int bk = (x + 1) & mask;
      row = rows[off[bk] + cnt[bk] - 1 - (r - rem[x & mask])];
      h = hs[row];
    }
    slot_row_out[t] = row;
    slot_hash_out[t] = h;
  }
}

// ---- the large route's build ----------------------------------------------

#define BL_THREADS 256
#define BL_PER 8                                 // slots a thread scans
#define BL_SCAN_THREADS 256                      // the scans' most a block
#define BL_STATE 8                               // ints of state, see below
#define BL_LEVELS 4                              // minima over 32^1 .. 32^4
#define SORT_SHORT 32                            // rows a thread sorts
#define SORT_CHUNK 2048                          // rows sorted in shared

// the scans' blocks take BL_PER slots a thread, C / BL_PER threads up to
// BL_SCAN_THREADS: a large table (C >= 2 * SMALL_CAPACITY) is whole tiles
// of at least 1,024 slots, so each block holds whole 1,024-slot minima
static_assert(2 * SMALL_CAPACITY >= 128 * BL_PER, "a block spans 1,024 slots");
static_assert(BL_STATE % 4 == 0, "cnt starts on 16 bytes");

// a tile's threads: C / BL_PER, at most BL_SCAN_THREADS
static int scan_threads(int C) {
  return C / BL_PER < BL_SCAN_THREADS ? C / BL_PER : BL_SCAN_THREADS;
}

// The large build's scratch, one int32 buffer that the wrapper allocates
// (hj_build_large_scratch ints) and the entry point carves. state: [0] and
// [1] the two scans' tickets, [2] the buckets listed, [3] rounds, [4]
// rem[C - 1], [5] the valid rows; it and cnt are zeroed on the stream.
// `fill` holds each valid row as row << 32 | its hash, by bucket, so the
// table's words are read in bucket order and no hash is gathered. cnt,
// off and rem start on 16 bytes (the scans load 8 slots as two int4), the
// 8-byte arrays on 8; state and cnt are adjacent, for one memset.
struct LargeBuild {
  int* state;
  int* cnt;                                      // C: rows a bucket
  int* off;                                      // C + 1: bucket offsets
  int* rem;                                      // C
  unsigned long long* fill;                      // n: rows by bucket
  unsigned long long* tmp;                       // n: the merges' other half
  int* mins[BL_LEVELS];                          // C >> 5k, at least 1
  PQ* tile;                                      // a scan tile's map
  PQ* tile_pre;                                  // the tiles' before it
  uint32_t* row_h;                               // n: a row's hash
  int* rank;                                     // n: in its bucket, -1 none
  int* list;                                     // n / 2 + 1: buckets > 1 row
};

static long long large_layout(long long n, int C, int* base, LargeBuild* L) {
  long long o = 0;
  auto take = [&](long long ints) {
    int* p = base == nullptr ? nullptr : base + o;
    o += ints;
    return p;
  };
  const long long tiles = C / (BL_PER * scan_threads(C));
  L->state = take(BL_STATE);
  L->cnt = take(C);
  L->off = take(C + 4LL);
  L->rem = take(C);
  L->fill = reinterpret_cast<unsigned long long*>(take(2 * n));
  L->tmp = reinterpret_cast<unsigned long long*>(take(2 * n));
  for (int k = 0; k < BL_LEVELS; ++k) {
    const long long m = static_cast<long long>(C) >> (5 * (k + 1));
    L->mins[k] = take(m > 0 ? m : 1);
  }
  L->tile = reinterpret_cast<PQ*>(take(2 * tiles));
  L->tile_pre = reinterpret_cast<PQ*>(take(2 * tiles));
  L->row_h = reinterpret_cast<uint32_t*>(take(n));
  L->rank = take(n);
  L->list = take(n / 2 + 1);
  return o;
}

// a thread's BL_PER slots of cnt (16-byte aligned)
__device__ __forceinline__ void load_slots(const int* a, int c[BL_PER]) {
  const int4 x = reinterpret_cast<const int4*>(a)[0];
  const int4 y = reinterpret_cast<const int4*>(a)[1];
  c[0] = x.x; c[1] = x.y; c[2] = x.z; c[3] = x.w;
  c[4] = y.x; c[5] = y.y; c[6] = y.z; c[7] = y.w;
}

__device__ __forceinline__ void store_slots(int* a, const int c[BL_PER]) {
  reinterpret_cast<int4*>(a)[0] = make_int4(c[0], c[1], c[2], c[3]);
  reinterpret_cast<int4*>(a)[1] = make_int4(c[4], c[5], c[6], c[7]);
}

// the composition of a thread's slots' maps (cnt - 1, 0)
__device__ __forceinline__ PQ compose_slots(const int c[BL_PER]) {
  PQ x{0, PQ_NONE};
#pragma unroll
  for (int r = 0; r < BL_PER; ++r) x = pq_then(x, PQ{c[r] - 1, 0});
  return x;
}

// 1. every valid row's hash and its rank in its bucket, counting the rows
// a bucket (one atomic for a warp's rows of one bucket); invalid rows get
// rank -1
template <typename K>
__global__ void __launch_bounds__(BL_THREADS)
bl_hash_kernel(const __grid_constant__ K b, long long n, int C,
               const __grid_constant__ LargeBuild L) {
  const int lane = threadIdx.x & 31;
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x; i0 < n;
       i0 += stride) {
    const long long i = i0 + threadIdx.x;
    const bool ok = i < n && row_valid(b, i);
    const uint32_t h = ok ? row_hash(b, i) : 0u;
    const unsigned int act = __ballot_sync(0xffffffffu, ok);
    int rank = -1;
    if (ok) {
      const unsigned int peers = __match_any_sync(act, h & mask);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&L.cnt[h & mask], __popc(peers));
      base = __shfl_sync(peers, base, leader);
      rank = base + __popc(peers & ((1u << lane) - 1u));
    }
    if (i < n) {
      L.row_h[i] = h;
      L.rank[i] = rank;
    }
  }
}

// 2. each tile's composition of its slots' maps (BL_PER slots a thread);
// the last block to finish composes the tiles: each tile's prefix, rem[C -
// 1] and the valid rows
__global__ void __launch_bounds__(BL_SCAN_THREADS)
bl_tiles_kernel(int C, const __grid_constant__ LargeBuild L) {
  __shared__ PQ warp_tot[32];
  __shared__ PQ incl_of[BL_SCAN_THREADS];
  __shared__ int last;
  const int tiles = C / (BL_PER * blockDim.x);
  int c[BL_PER];
  load_slots(L.cnt + (blockIdx.x * blockDim.x + threadIdx.x) * BL_PER, c);
  PQ T;
  block_scan_pq(compose_slots(c), warp_tot, &T);
  if (threadIdx.x == 0) L.tile[blockIdx.x] = T;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned int*>(&L.state[0]), 1u) ==
           static_cast<unsigned int>(tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int* tw = reinterpret_cast<const int*>(L.tile);
  const int per = (tiles + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < tiles ? lo + per : tiles;
  PQ acc{0, PQ_NONE};
  for (int j = lo; j < hi; ++j)
    acc = pq_then(acc, PQ{__ldcg(tw + 2 * j), __ldcg(tw + 2 * j + 1)});
  incl_of[threadIdx.x] = block_scan_pq(acc, warp_tot, &T);
  __syncthreads();
  PQ run = threadIdx.x > 0 ? incl_of[threadIdx.x - 1] : PQ{0, PQ_NONE};
  for (int j = lo; j < hi; ++j) {
    L.tile_pre[j] = run;
    run = pq_then(run, PQ{__ldcg(tw + 2 * j), __ldcg(tw + 2 * j + 1)});
  }
  if (threadIdx.x == 0) {
    L.state[4] = ring_start(T);
    L.state[5] = T.p + C;                        // every cnt summed
  }
}

// 3. per slot (BL_PER a thread): rem, its bucket's offset, the minima of
// rem over 32 and 1,024 slots, and the buckets of two rows or more listed;
// the last block to finish takes the minima over 32,768 and 2^20 slots
__global__ void __launch_bounds__(BL_SCAN_THREADS)
bl_slots_kernel(int C, const __grid_constant__ LargeBuild L) {
  __shared__ PQ warp_tot[32];
  __shared__ PQ incl_of[BL_SCAN_THREADS];
  __shared__ int warp_min[32];
  __shared__ int warp_list[32];
  __shared__ int list_at;
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = C / (BL_PER * blockDim.x);
  const int s0 = (blockIdx.x * blockDim.x + threadIdx.x) * BL_PER;
  int c[BL_PER];
  load_slots(L.cnt + s0, c);
  PQ T;
  incl_of[threadIdx.x] = block_scan_pq(compose_slots(c), warp_tot, &T);
  __syncthreads();
  PQ run = pq_then(L.tile_pre[blockIdx.x], threadIdx.x > 0
                                               ? incl_of[threadIdx.x - 1]
                                               : PQ{0, PQ_NONE});
  const int r_in = L.state[4];
  int off[BL_PER], rem[BL_PER], m = INT_MAX, multi = 0;
#pragma unroll
  for (int r = 0; r < BL_PER; ++r) {
    off[r] = run.p + s0 + r;
    run = pq_then(run, PQ{c[r] - 1, 0});
    rem[r] = max(r_in + run.p, run.q);
    m = min(m, rem[r]);
    multi += c[r] > 1;
  }
  store_slots(L.off + s0, off);
  store_slots(L.rem + s0, rem);
  if (s0 + BL_PER == C) L.off[C] = L.state[5];
  // the buckets of two rows or more: one atomic a block (a counter that
  // every block adds to)
  const int incl = warp_incl(multi, lane);
  if (lane == 31) warp_list[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int k = warp_list[w];
      warp_list[w] = sum;
      sum += k;
    }
    list_at = sum > 0 ? atomicAdd(&L.state[2], sum) : 0;
  }
  __syncthreads();
  int at = list_at + warp_list[warp] + incl - multi;
#pragma unroll
  for (int r = 0; r < BL_PER; ++r)
    if (c[r] > 1) L.list[at++] = s0 + r;
  // 32 slots: 4 threads; 1,024 slots: 4 warps
  m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = min(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if ((lane & 3) == 0) L.mins[0][s0 >> 5] = m;
  for (int o = 4; o < 32; o <<= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  if (threadIdx.x < blockDim.x / 128) {
    const int* w = warp_min + 4 * threadIdx.x;
    L.mins[1][(s0 - threadIdx.x * BL_PER) / 1024 + threadIdx.x] =
        min(min(w[0], w[1]), min(w[2], w[3]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned int*>(&L.state[1]), 1u) ==
           static_cast<unsigned int>(tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = 2; k < BL_LEVELS; ++k) {
    for (int g = threadIdx.x; g < (C >> (5 * (k + 1))); g += blockDim.x) {
      int mm = INT_MAX;
      for (int j = 0; j < 32; ++j)
        mm = min(mm, __ldcg(L.mins[k - 1] + 32 * g + j));
      L.mins[k][g] = mm;
    }
    __threadfence();
    __syncthreads();
  }
}

// 4. every valid row into its bucket's part of `fill`, at its rank, as
// row << 32 | hash
__global__ void __launch_bounds__(BL_THREADS)
bl_fill_kernel(long long n, int C, const __grid_constant__ LargeBuild L) {
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int k = L.rank[i];
    const uint32_t h = L.row_h[i];
    if (k >= 0)
      L.fill[L.off[h & mask] + k] =
          (static_cast<unsigned long long>(i) << 32) | h;
  }
}

// a bucket's entries, up to SORT_SHORT, sorted by one thread
__device__ __forceinline__ void sort_short(unsigned long long* a, int len) {
  unsigned long long v[SORT_SHORT];
  for (int i = 0; i < len; ++i) v[i] = a[i];
  for (int i = 1; i < len; ++i) {
    const unsigned long long x = v[i];
    int j = i - 1;
    for (; j >= 0 && v[j] > x; --j) v[j + 1] = v[j];
    v[j + 1] = x;
  }
  for (int i = 0; i < len; ++i) a[i] = v[i];
}

// A bucket's entries (distinct rows in the high half) sorted by the whole
// block: each SORT_CHUNK entries by a bitonic network in shared memory,
// then the sorted runs merged pairwise, between `a` and `tmp` (the same
// offsets of another buffer), each thread taking an even share of a pass's
// outputs from its merge-path split. Syncs the block.
__device__ void block_sort(unsigned long long* a, unsigned long long* tmp,
                           int len, unsigned long long* chunk) {
  for (int c0 = 0; c0 < len; c0 += SORT_CHUNK) {
    const int m = len - c0 < SORT_CHUNK ? len - c0 : SORT_CHUNK;
    int P = 1;
    while (P < m) P <<= 1;
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      chunk[i] = i < m ? a[c0 + i] : ~0ull;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < P; i += blockDim.x) {
          const int l = i ^ j;
          if (l > i) {
            const unsigned long long x = chunk[i], y = chunk[l];
            if ((x > y) == ((i & k) == 0)) {
              chunk[i] = y;
              chunk[l] = x;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < m; i += blockDim.x) a[c0 + i] = chunk[i];
    __syncthreads();
  }
  unsigned long long* src = a;
  unsigned long long* dst = tmp;
  for (int w = SORT_CHUNK; w < len; w <<= 1) {
    const int per = (len + blockDim.x - 1) / blockDim.x;
    int k = threadIdx.x * per;
    const int kend = k + per < len ? k + per : len;
    while (k < kend) {
      const int lo = k / (2 * w) * (2 * w);
      const int mid = lo + w < len ? lo + w : len;
      const int hi = lo + 2 * w < len ? lo + 2 * w : len;
      const int na = mid - lo, nb = hi - mid, d = k - lo;
      const unsigned long long* A = src + lo;
      const unsigned long long* B = src + mid;
      int l = d - nb > 0 ? d - nb : 0, h = d < na ? d : na;
      while (l < h) {
        const int mi = (l + h) >> 1;
        if (A[mi] < B[d - 1 - mi]) l = mi + 1;
        else h = mi;
      }
      int i = l, j = d - l;
      const int end = kend < hi ? kend : hi;
      for (; k < end; ++k)
        dst[k] = (j >= nb || (i < na && A[i] < B[j])) ? A[i++] : B[j++];
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  if (src != a)
    for (int i = threadIdx.x; i < len; i += blockDim.x) a[i] = src[i];
  __syncthreads();
}

// 5. the listed buckets' rows in ascending order: a thread sorts a bucket
// of up to SORT_SHORT rows, the block a longer one
__global__ void __launch_bounds__(BL_THREADS)
bl_sort_kernel(const __grid_constant__ LargeBuild L) {
  __shared__ unsigned long long chunk[SORT_CHUNK];
  __shared__ int longer[BL_THREADS];
  __shared__ int n_longer;
  const int listed = L.state[2];
  for (int e0 = blockIdx.x * BL_THREADS; e0 < listed;
       e0 += gridDim.x * BL_THREADS) {
    if (threadIdx.x == 0) n_longer = 0;
    __syncthreads();
    const int e = e0 + threadIdx.x;
    if (e < listed) {
      const int bk = L.list[e];
      const int a = L.off[bk], len = L.off[bk + 1] - a;
      if (len <= SORT_SHORT) sort_short(L.fill + a, len);
      else longer[atomicAdd(&n_longer, 1)] = bk;
    }
    __syncthreads();
    for (int j = 0; j < n_longer; ++j) {
      const int bk = longer[j];
      const int a = L.off[bk];
      block_sort(L.fill + a, L.tmp + a, L.off[bk + 1] - a, chunk);
    }
    __syncthreads();                             // n_longer is reset
  }
}

__device__ __forceinline__ const int* rem_level(const LargeBuild& L, int k) {
  switch (k) {
    case 0: return L.rem;
    case 1: return L.mins[0];
    case 2: return L.mins[1];
    case 3: return L.mins[2];
    default: return L.mins[3];
  }
}

// the last position x < s, counted back across the ring's start (so
// s - C <= x), with rem[x mod C] <= r. Level k holds rem's minima over
// blocks of 32^k slots; the search goes up a level when a block has no
// such slot and down into the first block that has one. An empty slot
// (rem 0) exists, so it ends within one lap.
__device__ __forceinline__ long long last_at_most(const LargeBuild& L, int C,
                                                  int s, int r) {
  int top = 0;
  while (top < BL_LEVELS && (C >> (5 * (top + 1))) > 0) ++top;
  int k = 0;
  long long x = static_cast<long long>(s) - 1;   // the last not ruled out
  for (;;) {
    const int sh = 5 * k;
    const long long entries = static_cast<long long>(C) >> sh;
    const int* lv = rem_level(L, k);
    const long long e = x >> sh;
    const long long stop = k == top ? e - entries + 1 : (e >> 5) << 5;
    long long f = e;
    while (f >= stop && lv[f & (entries - 1)] > r) --f;
    if (f >= stop) {
      if (k == 0) return f;
      x = ((f + 1) << sh) - 1;
      --k;
    } else if (k == top) {
      return x - C;                              // not reached: see above
    } else {
      x = (stop << sh) - 1;
      ++k;
    }
  }
}

// 6. every slot's word: hash << 32 | row, or 0xffffffff where empty; and
// rounds = 1 + the largest distance, taken once a block and only when it
// raises what an earlier block left
__global__ void __launch_bounds__(BL_THREADS)
bl_table_kernel(int C, const __grid_constant__ LargeBuild L,
                unsigned long long* __restrict__ table) {
  __shared__ int warp_max[BL_THREADS / 32];
  const int s = blockIdx.x * BL_THREADS + threadIdx.x;
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  const int c = L.cnt[s];
  const int r = L.rem[s];
  unsigned long long w = 0xffffffffull;
  int dist = -1;
  if (L.rem[(s - 1) & mask] + c > 0) {
    const long long x = last_at_most(L, C, s, r);
    const int bk = static_cast<int>((x + 1) & mask);
    const unsigned long long e =
        L.fill[L.off[bk] + L.cnt[bk] - 1 - (r - L.rem[x & mask])];
    w = (e << 32) | (e >> 32);                   // hash << 32 | row
    dist = static_cast<int>(s - (x + 1));
  }
  table[s] = w;
  for (int o = 16; o > 0; o >>= 1)
    dist = max(dist, __shfl_xor_sync(0xffffffffu, dist, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = dist;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < BL_THREADS / 32; ++w) dist = max(dist, warp_max[w]);
    if (dist >= 0 && dist + 1 > __ldcg(&L.state[3]))
      atomicMax(&L.state[3], dist + 1);
  }
}

// ---- the probes ----------------------------------------------------------

// The table in shared memory: for each slot one word, the build row's hash
// in the high half and its row id in the low half (-1: empty), so a step of
// the walk is one shared load; then for each slot the build row's values of
// the first nks key columns (as load_key gives them).
struct SmemTable {
  unsigned long long* ent;               // [C]
  long long* key;                        // [nks][C]
  int C, nks;
  __device__ __forceinline__ unsigned long long at(int s) const {
    return ent[s];
  }
  // key column j of build row r, in slot s (the first is always staged)
  __device__ __forceinline__ long long key_of(const Keys& b, int j, int s,
                                              int r) const {
    return j < nks ? key[j * C + s] : load_key(b, j, r);
  }
  __device__ __forceinline__ long long first_key(const Keys&, int s,
                                                 int) const {
    return key[s];
  }
};

// The large route's table, read where it lies in global memory (1 MB at
// 52,000 build rows, resident in L2): the same word a slot; every key
// value is read from the build columns.
struct GlobalTable {
  const unsigned long long* ent;         // [C]
  __device__ __forceinline__ unsigned long long at(int s) const {
    return __ldg(ent + s);
  }
  __device__ __forceinline__ long long key_of(const Keys& b, int j, int,
                                              int r) const {
    return load_key(b, j, r);
  }
  __device__ __forceinline__ long long first_key(const Keys& b, int,
                                                 int r) const {
    return load_key(b, 0, r);
  }
};

__device__ __forceinline__ int ent_row(unsigned long long e) {
  return static_cast<int>(static_cast<uint32_t>(e));
}

__device__ __forceinline__ uint32_t ent_hash(unsigned long long e) {
  return static_cast<uint32_t>(e >> 32);
}

static size_t table_bytes(int C, int nks) {
  return static_cast<size_t>(C) * (8 * nks + 8);
}

// stage the table; the caller syncs before reading it. A thread's slots'
// loads are issued together: two round trips to device memory in all.
// Variable-width keys stage no key values (nks = 0).
template <typename K>
__device__ __forceinline__ SmemTable stage_table(unsigned char* smem,
                                                 const K& b,
                                                 const int* slot_row,
                                                 const uint32_t* slot_hash,
                                                 int C, int nks) {
  constexpr int PER = SMALL_CAPACITY / PROBE_THREADS;
  SmemTable t;
  t.ent = reinterpret_cast<unsigned long long*>(smem);
  t.key = reinterpret_cast<long long*>(t.ent + C);
  t.C = C;
  t.nks = nks;
  int r[PER];
  uint32_t h[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = threadIdx.x + k * PROBE_THREADS;
    r[k] = s < C ? slot_row[s] : -1;
    h[k] = s < C ? slot_hash[s] : 0u;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = threadIdx.x + k * PROBE_THREADS;
    if (s < C)
      t.ent[s] = (static_cast<unsigned long long>(h[k]) << 32) |
                 static_cast<uint32_t>(r[k]);
  }
  if constexpr (!IsVar<K>::value) {
  for (int j = 0; j < nks; ++j) {
    long long v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = r[k] >= 0 ? load_key(b, j, r[k]) : 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int s = threadIdx.x + k * PROBE_THREADS;
      if (s < C) t.key[j * C + s] = v[k];
    }
  }
  }
  return t;
}

// probe row i (first key value v0) against build row r, in slot s
template <typename T, typename K>
__device__ __forceinline__ bool keys_equal(const K& p, long long i,
                                           long long v0, const K& b,
                                           int r, const T& t, int s) {
  if constexpr (IsVar<K>::value) {
    return vkeys_equal(p, i, b, r);
  } else {
    if (t.first_key(b, s, r) != v0) return false;
    for (int j = 1; j < p.nk; ++j)
      if (load_key(p, j, i) != t.key_of(b, j, s, r)) return false;
    return true;
  }
}

// build rows r (slot s) and r0 (slot s0) have equal keys
template <typename T, typename K>
__device__ __forceinline__ bool build_keys_equal(const K& b, const T& t,
                                                 int s, int r, int s0,
                                                 int r0) {
  if constexpr (IsVar<K>::value) {
    return vkeys_equal(b, r, b, r0);
  } else {
    for (int j = 0; j < b.nk; ++j)
      if (t.key_of(b, j, s, r) != t.key_of(b, j, s0, r0)) return false;
    return true;
  }
}

// the matches of probe row i (hash h) along its chain; *first gets the slot
// of the first
template <typename T, typename K>
__device__ __forceinline__ int count_row(const K& p, long long i,
                                         long long v0, uint32_t h,
                                         const K& b, const T& t, int C,
                                         int* first) {
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  int c = 0;
  for (int d = 0; d <= C; ++d) {
    const int s = static_cast<int>((h + static_cast<uint32_t>(d)) & mask);
    const unsigned long long e = t.at(s);
    const int r = ent_row(e);
    if (r < 0) break;                // linear probing: the chain ends here
    if (ent_hash(e) == h && keys_equal(p, i, v0, b, r, t, s)) {
      if (c == 0) *first = s;
      ++c;
    }
  }
  return c;
}

__device__ __forceinline__ long long sext(unsigned int x, int bits) {
  return static_cast<long long>(static_cast<int>(x << (32 - bits)) >>
                                (32 - bits));
}

// key column j of rows row0 .. row0 + 7 (0 past n): vector loads where the
// address allows, scalar ones otherwise
__device__ __forceinline__ void load_rows(const Keys& k, int j,
                                          long long row0, long long n,
                                          long long v[PROBE_R]) {
  const int w = k.width[j];
  const char* a = static_cast<const char*>(k.data[j]) + row0 * w;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a);
  const bool full = row0 + PROBE_R <= n;
  if (full && w == 8 && (addr & 15) == 0) {
    const longlong2* q = reinterpret_cast<const longlong2*>(a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const longlong2 x = __ldg(q + i);
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  } else if (full && w == 4 && (addr & 15) == 0) {
    const int4* q = reinterpret_cast<const int4*>(a);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int4 x = __ldg(q + i);
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else if (full && w == 2 && (addr & 15) == 0) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
    const unsigned int words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      v[r] = sext(words[r >> 1] >> (16 * (r & 1)), 16);
  } else if (full && w == 1 && (addr & 7) == 0) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(a));
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      v[r] = sext((r < 4 ? x.x : x.y) >> (8 * (r & 3)), 8);
  } else {
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      v[r] = row0 + r < n ? load_key(k, j, row0 + r) : 0;
  }
}

// ok[r] &= the byte of row row0 + r (a bool mask; rows past n untouched)
__device__ __forceinline__ void and_bytes(const unsigned char* mask,
                                          long long row0, long long n,
                                          bool ok[PROBE_R]) {
  const unsigned char* a = mask + row0;
  if (row0 + PROBE_R <= n && (reinterpret_cast<uintptr_t>(a) & 7) == 0) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(a));
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      ok[r] = ok[r] && (((r < 4 ? x.x : x.y) >> (8 * (r & 3))) & 0xffu);
  } else {
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      if (row0 + r < n) ok[r] = ok[r] && a[r] != 0;
  }
}

// rows row0 .. row0 + 7 inside n, live, with every key valid
template <typename K>
__device__ __forceinline__ void valid_rows(const K& k, long long row0,
                                           long long n, bool ok[PROBE_R]) {
#pragma unroll
  for (int r = 0; r < PROBE_R; ++r) ok[r] = row0 + r < n;
  if (k.alive != nullptr) and_bytes(k.alive, row0, n, ok);
  for (int j = 0; j < k.nk; ++j)
    if (k.valid[j] != nullptr) and_bytes(k.valid[j], row0, n, ok);
}

__device__ __forceinline__ void store_counts(int* counts, long long row0,
                                             long long n,
                                             const int c[PROBE_R]) {
  int* a = counts + row0;
  if (row0 + PROBE_R <= n && (reinterpret_cast<uintptr_t>(a) & 15) == 0) {
    reinterpret_cast<int4*>(a)[0] = make_int4(c[0], c[1], c[2], c[3]);
    reinterpret_cast<int4*>(a)[1] = make_int4(c[4], c[5], c[6], c[7]);
  } else {
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      if (row0 + r < n) a[r] = c[r];
  }
}

// What differs between the routes' probes: the table (staged in shared
// memory, or read in global memory), a list entry's width, and a walk's
// result, count | first slot << CF_SHIFT.
template <bool LARGE>
struct Route;

template <>
struct Route<false> {
  using Table = SmemTable;
  using Ent = unsigned int;
  using CF = int;
  static constexpr int CF_SHIFT = 16;
  static constexpr int COUNT_SHIFT = ENT_COUNT_SHIFT;
  static constexpr bool BLOOM = true;
};

template <>
struct Route<true> {
  using Table = GlobalTable;
  using Ent = unsigned long long;
  using CF = long long;
  static constexpr int CF_SHIFT = 32;
  static constexpr int COUNT_SHIFT = WIDE_ENT_COUNT_SHIFT;
  // a filter that fits shared memory (64 KB, 2^19 bits) passes 9% of the
  // non-matching rows at 52,000 keys and nearly all toward the ceiling;
  // each block would load it from global memory, and at q72's inventory
  // join nearly every probe row matches: the large route walks every
  // valid row
  static constexpr bool BLOOM = false;
};

// a candidate row on its way to the lane that walks it: its first key value,
// hash and row in the tile; back: its count | its first slot << CF_SHIFT
template <typename CF>
struct WalkSlot {
  long long v0;
  uint32_t h;
  CF x;
};

// A persistent grid: block g counts tiles g, g + G, ...; warp w of a block
// takes segment w of each tile (PROBE_SEG rows), a lane the 8 consecutive
// rows at lane * 8 of it. Per segment the warp writes the counts, its list
// of matched rows (entries, from the segment's first row on), their number
// and the segment's pairs; no warp waits for another. At the end the block
// sums its tiles' segments, and the last block to finish scans the tiles'
// pairs into offsets and the total. The tile arrays, total and ticket are
// the call's scratch (the ticket zeroed on the launch stream).
template <bool LARGE, typename K>
__global__ void __launch_bounds__(PROBE_THREADS)
count_kernel(const __grid_constant__ K p, long long n,
             const __grid_constant__ K b, const int* __restrict__ slot_row,
             const uint32_t* __restrict__ slot_hash,
             const unsigned long long* __restrict__ ent, int C, int nks,
             int* __restrict__ counts,
             typename Route<LARGE>::Ent* __restrict__ entries,
             int* __restrict__ seg_sum, int* __restrict__ seg_matched,
             long long* __restrict__ tile_sum, long long* __restrict__ tile_off,
             long long* __restrict__ total, unsigned int* ticket) {
  using R = Route<LARGE>;
  using CF = typename R::CF;
  using Ent = typename R::Ent;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_sum[PROBE_WARPS];
  __shared__ WalkSlot<CF> walk_q[PROBE_WARPS][32];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  typename R::Table t;
  unsigned int* bloom = nullptr;
  if constexpr (LARGE) {
    t.ent = ent;
  } else {
    t = stage_table(smem, b, slot_row, slot_hash, C, nks);
    // a Bloom filter of the build rows' hashes: bit h >> 16
    bloom = reinterpret_cast<unsigned int*>(t.key + nks * C);
    for (int w = threadIdx.x; w < BLOOM_WORDS; w += blockDim.x) bloom[w] = 0u;
    __syncthreads();
    for (int s = threadIdx.x; s < C; s += blockDim.x) {
      const unsigned long long e = t.ent[s];
      if (ent_row(e) >= 0)
        atomicOr(&bloom[ent_hash(e) >> 21], 1u << ((ent_hash(e) >> 16) & 31));
    }
    __syncthreads();
  }
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  WalkSlot<CF>* q = walk_q[warp];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long seg0 = tile * PROBE_TILE + warp * PROBE_SEG;
    if (seg0 >= n) continue;
    const long long row0 = seg0 + lane * PROBE_R;
    long long v0[PROBE_R];
    bool ok[PROBE_R];
    uint32_t h[PROBE_R];
    if constexpr (IsVar<K>::value) {
      // a variable-width row is hashed and compared where it lies; v0
      // carries its row
      valid_rows(p, row0, n, ok);
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) {
        v0[r] = row0 + r;
        h[r] = ok[r] ? row_hash(p, row0 + r) : 0u;
      }
    } else {
      // every load of the lane's rows before any hash
      load_rows(p, 0, row0, n, v0);
      valid_rows(p, row0, n, ok);
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r)
        h[r] = hash_col(42u, v0[r], p.wide[0]);
      for (int j = 1; j < p.nk; ++j) {
        long long v[PROBE_R];
        load_rows(p, j, row0, n, v);
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r)
          h[r] = hash_col(h[r], v[r], p.wide[j]);
      }
    }
    // rows whose hash no build row has count 0 without a walk; the warp's
    // other rows (its candidates) walk 32 at a time, one a lane
    unsigned int cand = 0;
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      if (ok[r] && (!R::BLOOM ||
                    (bloom[h[r] >> 21] >> ((h[r] >> 16) & 31) & 1u)))
        cand |= 1u << r;
    // candidate (lane, r) goes to place base[r] + (lower lanes with r)
    const unsigned int lower = (1u << lane) - 1u;
    int base[PROBE_R], K = 0;
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r) {
      const unsigned int bal = __ballot_sync(0xffffffffu, (cand >> r) & 1u);
      base[r] = K + __popc(bal & lower);
      K += __popc(bal);
    }
    CF cf[PROBE_R];                    // count | first matching slot << CF_SHIFT
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r) cf[r] = 0;
    for (int q0 = 0; q0 < K; q0 += 32) {
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) {
        const int idx = base[r] - q0;
        if ((cand & (1u << r)) && idx >= 0 && idx < 32)
          q[idx] = WalkSlot<CF>{v0[r], h[r],
                                static_cast<CF>(row0 - tile * PROBE_TILE) + r};
      }
      __syncwarp();
      if (q0 + lane < K) {
        const WalkSlot<CF> w = q[lane];
        int f = 0;
        const int n_match = count_row(p, tile * PROBE_TILE + w.x, w.v0, w.h,
                                      b, t, C, &f);
        q[lane].x = static_cast<CF>(n_match) |
                    (static_cast<CF>(f) << R::CF_SHIFT);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) {
        const int idx = base[r] - q0;
        if ((cand & (1u << r)) && idx >= 0 && idx < 32) cf[r] = q[idx].x;
      }
      __syncwarp();
    }
    int c[PROBE_R];
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      c[r] = static_cast<int>(cf[r] & ((CF(1) << R::CF_SHIFT) - 1));
    store_counts(counts, row0, n, c);
    // the segment's list, in row order: a lane's rows go after the matched
    // rows of the lower lanes
    int pairs = 0, k = 0, seg_rows = 0;
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r) {
      pairs += c[r];
      const unsigned int bal = __ballot_sync(0xffffffffu, c[r] > 0);
      k += __popc(bal & lower);
      seg_rows += __popc(bal);
    }
    Ent* list = entries + seg0;
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r) {
      if (c[r] > 0)
        list[k++] = static_cast<Ent>(row0 - tile * PROBE_TILE + r) |
                    (static_cast<Ent>(cf[r] >> R::CF_SHIFT) << ENT_SLOT_SHIFT) |
                    (static_cast<Ent>(c[r]) << R::COUNT_SHIFT);
    }
    pairs = __reduce_add_sync(0xffffffffu, pairs);
    if (lane == 0) {
      seg_sum[seg0 / PROBE_SEG] = pairs;
      seg_matched[seg0 / PROBE_SEG] = seg_rows;
    }
  }
  // the block's tiles: their segments' pairs summed (written by this
  // block's warps, visible after the barrier)
  __syncthreads();
  const long long segs = (n + PROBE_SEG - 1) / PROBE_SEG;
  const long long G = gridDim.x;
  for (long long tile = blockIdx.x + threadIdx.x * G; tile < tiles;
       tile += PROBE_THREADS * G) {
    long long sum = 0;
    for (long long sg = tile * PROBE_SEGS;
         sg < (tile + 1) * PROBE_SEGS && sg < segs; ++sg)
      sum += seg_sum[sg];
    tile_sum[tile] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: exclusive tile offsets and the total
  const int nt = static_cast<int>(tiles);
  const int per = (nt + PROBE_THREADS - 1) / PROBE_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nt ? lo + per : nt;
  long long sum = 0;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) sum += __ldcg(tile_sum + i);
  long long run = warp_incl(sum, lane);
  if (lane == 31) warp_sum[warp] = run;
  __syncthreads();
  run -= sum;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  if (threadIdx.x == PROBE_THREADS - 1) *total = run + sum;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) {
    tile_off[i] = run;
    run += __ldcg(tile_sum + i);
  }
}

// whether probe row i (hash h) has a match along its chain: count_row's
// walk, stopping at the first
template <typename T, typename K>
__device__ __forceinline__ bool exists_row(const K& p, long long i,
                                           long long v0, uint32_t h,
                                           const K& b, const T& t, int C) {
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  for (int d = 0; d <= C; ++d) {
    const int s = static_cast<int>((h + static_cast<uint32_t>(d)) & mask);
    const unsigned long long e = t.at(s);
    const int r = ent_row(e);
    if (r < 0) return false;             // linear probing: the chain ends
    if (ent_hash(e) == h && keys_equal(p, i, v0, b, r, t, s)) return true;
  }
  return false;
}

// rows row0 .. row0 + 7's flags (bit r: row row0 + r), one byte a row
__device__ __forceinline__ void store_flags(unsigned char* out,
                                            long long row0, long long n,
                                            unsigned int bits) {
  unsigned char* a = out + row0;
  if (row0 + PROBE_R <= n && (reinterpret_cast<uintptr_t>(a) & 7) == 0) {
    unsigned int w[2] = {0u, 0u};
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      w[r >> 2] |= ((bits >> r) & 1u) << (8 * (r & 3));
    *reinterpret_cast<uint2*>(a) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      if (row0 + r < n) a[r] = static_cast<unsigned char>((bits >> r) & 1u);
  }
}

// The semi and anti joins' probe: per probe row one byte, 1 when it has a
// match. count_kernel's grid, tiling, loads, Bloom filter (small route)
// and ballot compaction of the candidates, each walk stopping at its
// first match; no counts, lists or sums, so nothing to scan and no total.
template <bool LARGE, typename K>
__global__ void __launch_bounds__(PROBE_THREADS)
exists_kernel(const __grid_constant__ K p, long long n,
              const __grid_constant__ K b, const int* __restrict__ slot_row,
              const uint32_t* __restrict__ slot_hash,
              const unsigned long long* __restrict__ ent, int C, int nks,
              unsigned char* __restrict__ out) {
  using R = Route<LARGE>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WalkSlot<int> walk_q[PROBE_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  typename R::Table t;
  unsigned int* bloom = nullptr;
  if constexpr (LARGE) {
    t.ent = ent;
  } else {
    t = stage_table(smem, b, slot_row, slot_hash, C, nks);
    bloom = reinterpret_cast<unsigned int*>(t.key + nks * C);
    for (int w = threadIdx.x; w < BLOOM_WORDS; w += blockDim.x) bloom[w] = 0u;
    __syncthreads();
    for (int s = threadIdx.x; s < C; s += blockDim.x) {
      const unsigned long long e = t.ent[s];
      if (ent_row(e) >= 0)
        atomicOr(&bloom[ent_hash(e) >> 21], 1u << ((ent_hash(e) >> 16) & 31));
    }
    __syncthreads();
  }
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  WalkSlot<int>* q = walk_q[warp];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long seg0 = tile * PROBE_TILE + warp * PROBE_SEG;
    if (seg0 >= n) continue;
    const long long row0 = seg0 + lane * PROBE_R;
    long long v0[PROBE_R];
    bool ok[PROBE_R];
    uint32_t h[PROBE_R];
    if constexpr (IsVar<K>::value) {
      valid_rows(p, row0, n, ok);
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) {
        v0[r] = row0 + r;
        h[r] = ok[r] ? row_hash(p, row0 + r) : 0u;
      }
    } else {
      load_rows(p, 0, row0, n, v0);
      valid_rows(p, row0, n, ok);
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r)
        h[r] = hash_col(42u, v0[r], p.wide[0]);
      for (int j = 1; j < p.nk; ++j) {
        long long v[PROBE_R];
        load_rows(p, j, row0, n, v);
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r)
          h[r] = hash_col(h[r], v[r], p.wide[j]);
      }
    }
    unsigned int cand = 0;
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r)
      if (ok[r] && (!R::BLOOM ||
                    (bloom[h[r] >> 21] >> ((h[r] >> 16) & 31) & 1u)))
        cand |= 1u << r;
    const unsigned int lower = (1u << lane) - 1u;
    int base[PROBE_R], n_cand = 0;
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r) {
      const unsigned int bal = __ballot_sync(0xffffffffu, (cand >> r) & 1u);
      base[r] = n_cand + __popc(bal & lower);
      n_cand += __popc(bal);
    }
    unsigned int found = 0;
    for (int q0 = 0; q0 < n_cand; q0 += 32) {
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) {
        const int idx = base[r] - q0;
        if ((cand & (1u << r)) && idx >= 0 && idx < 32)
          q[idx] = WalkSlot<int>{v0[r], h[r],
                                 static_cast<int>(row0 - tile * PROBE_TILE) +
                                     r};
      }
      __syncwarp();
      if (q0 + lane < n_cand) {
        const WalkSlot<int> w = q[lane];
        q[lane].x = exists_row(p, tile * PROBE_TILE + w.x, w.v0, w.h, b, t, C);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) {
        const int idx = base[r] - q0;
        if ((cand & (1u << r)) && idx >= 0 && idx < 32 && q[idx].x != 0)
          found |= 1u << r;
      }
      __syncwarp();
    }
    store_flags(out, row0, n, found);
  }
}

static size_t count_smem_bytes(int C, int nks) {
  return table_bytes(C, nks) + sizeof(unsigned int) * BLOOM_WORDS;
}

static size_t emit_stage_bytes() {
  return 2 * sizeof(int) * PROBE_WARPS * EMIT_STAGE;
}

static size_t emit_smem_bytes(int C, int nks) {
  return table_bytes(C, nks) + emit_stage_bytes();
}

// A persistent grid over the count's tiles; warp w of a block takes segment
// w of each. Its first pair goes to the tile's offset plus the pairs of the
// tile's earlier segments; its list is taken 32 entries at a time, a warp
// scan of their counts giving each entry its first pair, and each entry
// walks from its first matching slot, taking the slots whose hash and keys
// equal that slot's build row's, until its count is reached. The pairs go
// to the warp's part of shared memory, then out as one run per map; a
// segment with more than EMIT_STAGE pairs writes them in place. Only pairs
// at positions below `limit` are written (the eager join passes the
// total): a tile or segment that starts at or past it is skipped, and a
// segment that crosses it writes its first pairs only.
template <bool LARGE, typename K>
__global__ void __launch_bounds__(PROBE_THREADS)
emit_kernel(const __grid_constant__ K b, const int* __restrict__ slot_row,
            const uint32_t* __restrict__ slot_hash,
            const unsigned long long* __restrict__ ent, int C, int nks,
            long long n,
            const typename Route<LARGE>::Ent* __restrict__ entries,
            const int* __restrict__ seg_sum,
            const int* __restrict__ seg_matched,
            const long long* __restrict__ tile_off, long long limit,
            int* __restrict__ out_l, int* __restrict__ out_r) {
  using R = Route<LARGE>;
  using Ent = typename R::Ent;
  // the pairs of a tile's earlier segments: up to 7 x 2^30 on the large route
  using Sum = typename std::conditional<LARGE, long long, int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  typename R::Table t;
  int* stage_l;
  if constexpr (LARGE) {
    t.ent = ent;
    stage_l = reinterpret_cast<int*>(smem) + warp * EMIT_STAGE;
  } else {
    t = stage_table(smem, b, slot_row, slot_hash, C, nks);
    stage_l = reinterpret_cast<int*>(t.key + nks * C) + warp * EMIT_STAGE;
  }
  int* stage_r = stage_l + PROBE_WARPS * EMIT_STAGE;
  const int mask = C - 1;
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  const long long segs = (n + PROBE_SEG - 1) / PROBE_SEG;
  __syncthreads();
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long sg = tile * PROBE_SEGS + warp;
    if (sg >= segs) continue;
    const int matched = seg_matched[sg];
    if (matched == 0 || tile_off[tile] >= limit) continue;
    // the pairs of the tile's earlier segments
    Sum earlier = lane < warp ? seg_sum[tile * PROBE_SEGS + lane] : 0;
    if constexpr (LARGE) {
      earlier = __shfl_sync(0xffffffffu, warp_incl(earlier, lane), 31);
    } else {
      earlier = __reduce_add_sync(0xffffffffu, earlier);
    }
    const int pairs = seg_sum[sg];
    // the pairs this segment may write: those before the limit
    const long long room = limit - tile_off[tile] - earlier;
    if (room <= 0) continue;
    const int keep = room < pairs ? static_cast<int>(room) : pairs;
    int* dst_l = out_l + tile_off[tile] + earlier;
    int* dst_r = out_r + tile_off[tile] + earlier;
    const bool staged = pairs <= EMIT_STAGE;
    int* to_l = staged ? stage_l : dst_l;
    int* to_r = staged ? stage_r : dst_r;
    const Ent* list = entries + sg * PROBE_SEG;
    int run = 0;                       // pairs of the earlier entries
    for (int e0 = 0; e0 < matched; e0 += 32) {
      const int e = e0 + lane;
      const Ent w = e < matched ? list[e] : Ent(0);
      const int cnt = static_cast<int>(w >> R::COUNT_SHIFT);
      const int incl = warp_incl(cnt, lane);
      int o = run + incl - cnt;
      run += __shfl_sync(0xffffffffu, incl, 31);
      if (cnt > 0) {
        const int row = static_cast<int>(tile * PROBE_TILE +
                                         (w & (PROBE_TILE - 1)));
        const int s0 = static_cast<int>(
            (w >> ENT_SLOT_SHIFT) &
            ((Ent(1) << (R::COUNT_SHIFT - ENT_SLOT_SHIFT)) - 1));
        const unsigned long long f = t.at(s0);
        const int r0 = ent_row(f);
        const uint32_t h0 = ent_hash(f);
        // staged pairs fit the stage; in place, none at or past `keep`
        const int end = staged || o + cnt <= keep ? o + cnt : keep;
        if (o < end) {
          to_l[o] = row;
          to_r[o] = r0;
        }
        ++o;
        for (int d = 1; o < end && d < C; ++d) {
          const int s = (s0 + d) & mask;
          const unsigned long long en = t.at(s);
          const int r = ent_row(en);
          if (r < 0) break;
          if (ent_hash(en) == h0 && build_keys_equal(b, t, s, r, s0, r0)) {
            to_l[o] = row;
            to_r[o] = r;
            ++o;
          }
        }
      }
    }
    if (staged) {
      __syncwarp();
      for (int o = lane; o < keep; o += 32) {
        dst_l[o] = stage_l[o];
        dst_r[o] = stage_r[o];
      }
      __syncwarp();
    }
  }
}

// ---- the capped probe ------------------------------------------------------
//
// The capped tier's inner join in one launch, over a padded probe frame
// whose rows are mostly dead: (row_cap,) maps, valid and overflow, no
// per-row counts or lists in device memory and nothing for the host to
// read. Tiles are taken in order from a counter (a block takes its next
// tile when it finishes one), so a tile's predecessors are all held by
// running blocks. Per tile:
// - count: count_kernel's segments, with the live mask read beside the
//   keys' validity; a lane whose 8 rows are all dead loads no key, a warp
//   whose 256 rows are all dead hashes nothing (ballot). Each warp keeps
//   its segment's list of matched rows in shared memory;
// - offset: the tile's pairs published in its word of `state` (flag 1:
//   the tile's own sum, 2: the sum of it and every tile before it, in the
//   low 62 bits), and its exclusive offset found by a decoupled look-back
//   over the words of the tiles before it, 32 at a time, by warp 0. (A
//   look-back a warp's segment, with no block barrier, measured slower:
//   eight times the chain of published words.)
// - emit: emit_kernel's walk over each segment's shared list, the pairs
//   below row_cap written at the tile's offset.
// Then each block waits for the last tile's word (the total) and writes
// its share of every slot's `valid` (slot < total) and the maps' zeros
// past the pairs; the block of the last tile writes `overflow`.
#define LB_SHIFT 62
#define LB_AGG 1ull                             // the tile's own pairs
#define LB_PREFIX 2ull                          // and every earlier tile's
#define LB_VALUE ((1ull << LB_SHIFT) - 1ull)

__device__ __forceinline__ unsigned long long lb_read(
    const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

__device__ __forceinline__ long long warp_sum_ll(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the pairs of the tiles before `tile` (> 0), by warp 0: lane l reads the
// word of tile - 1 - l (below tile 0: a prefix of 0) until none is 0, and
// the lanes up to the nearest prefix add up; else 32 tiles further back
__device__ __forceinline__ long long look_back(
    const unsigned long long* state, long long tile, int lane) {
  long long excl = 0;
  for (long long top = tile - 1;; top -= 32) {
    const long long t = top - lane;
    unsigned long long w = t >= 0 ? lb_read(state + t) : LB_PREFIX << LB_SHIFT;
    while (__any_sync(0xffffffffu, (w >> LB_SHIFT) == 0)) {
      if ((w >> LB_SHIFT) == 0) w = lb_read(state + t);
    }
    const unsigned int pre =
        __ballot_sync(0xffffffffu, (w >> LB_SHIFT) == LB_PREFIX);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl += warp_sum_ll(lane <= stop ? static_cast<long long>(w & LB_VALUE)
                                     : 0);
    if (pre) return excl;
  }
}

static size_t capped_smem_bytes(bool large, int C, int nks) {
  const size_t lists = static_cast<size_t>(PROBE_TILE) *
                       (large ? sizeof(unsigned long long) : sizeof(unsigned));
  return (large ? 0 : count_smem_bytes(C, nks)) + lists + emit_stage_bytes();
}

template <bool LARGE, typename K>
__global__ void __launch_bounds__(PROBE_THREADS)
capped_kernel(const __grid_constant__ K p, long long n,
              const __grid_constant__ K b, const int* __restrict__ slot_row,
              const uint32_t* __restrict__ slot_hash,
              const unsigned long long* __restrict__ ent, int C, int nks,
              long long row_cap, int* __restrict__ out_l,
              int* __restrict__ out_r, unsigned char* __restrict__ valid,
              unsigned char* __restrict__ overflow,
              unsigned long long* next_tile, unsigned long long* state) {
  using R = Route<LARGE>;
  using CF = typename R::CF;
  using Ent = typename R::Ent;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WalkSlot<CF> walk_q[PROBE_WARPS][32];
  __shared__ int seg_pairs[PROBE_WARPS], seg_rows[PROBE_WARPS];
  __shared__ long long tile_s, base_s, total_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  typename R::Table t;
  unsigned int* bloom = nullptr;
  unsigned char* rest = smem;
  if constexpr (LARGE) {
    t.ent = ent;
  } else {
    t = stage_table(smem, b, slot_row, slot_hash, C, nks);
    bloom = reinterpret_cast<unsigned int*>(t.key + nks * C);
    for (int w = threadIdx.x; w < BLOOM_WORDS; w += blockDim.x) bloom[w] = 0u;
    __syncthreads();
    for (int s = threadIdx.x; s < C; s += blockDim.x) {
      const unsigned long long e = t.ent[s];
      if (ent_row(e) >= 0)
        atomicOr(&bloom[ent_hash(e) >> 21], 1u << ((ent_hash(e) >> 16) & 31));
    }
    rest = reinterpret_cast<unsigned char*>(bloom + BLOOM_WORDS);
  }
  Ent* list = reinterpret_cast<Ent*>(rest) + warp * PROBE_SEG;
  int* stage_l = reinterpret_cast<int*>(reinterpret_cast<Ent*>(rest) +
                                        PROBE_TILE) + warp * EMIT_STAGE;
  int* stage_r = stage_l + PROBE_WARPS * EMIT_STAGE;
  const int mask = C - 1;
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  WalkSlot<CF>* q = walk_q[warp];
  const unsigned int lower = (1u << lane) - 1u;
  for (;;) {
    if (threadIdx.x == 0)
      tile_s = static_cast<long long>(atomicAdd(next_tile, 1ull));
    __syncthreads();                   // the table and Bloom filter, tile_s
    const long long tile = tile_s;
    if (tile >= tiles) break;
    // count: segment `warp` of the tile
    const long long seg0 = tile * PROBE_TILE + warp * PROBE_SEG;
    int pairs = 0, seg_matched = 0;
    if (seg0 < n) {
      const long long row0 = seg0 + lane * PROBE_R;
      bool ok[PROBE_R];
      valid_rows(p, row0, n, ok);
      bool live = false;
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) live = live || ok[r];
      if (__any_sync(0xffffffffu, live)) {
        long long v0[PROBE_R];
        uint32_t h[PROBE_R];
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r) {
          v0[r] = 0;
          h[r] = 0u;
        }
        if constexpr (IsVar<K>::value) {
#pragma unroll
          for (int r = 0; r < PROBE_R; ++r) {
            v0[r] = row0 + r;
            if (ok[r]) h[r] = row_hash(p, row0 + r);
          }
        } else if (live) {
          load_rows(p, 0, row0, n, v0);
#pragma unroll
          for (int r = 0; r < PROBE_R; ++r)
            h[r] = hash_col(42u, v0[r], p.wide[0]);
          for (int j = 1; j < p.nk; ++j) {
            long long v[PROBE_R];
            load_rows(p, j, row0, n, v);
#pragma unroll
            for (int r = 0; r < PROBE_R; ++r)
              h[r] = hash_col(h[r], v[r], p.wide[j]);
          }
        }
        unsigned int cand = 0;
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r)
          if (ok[r] && (!R::BLOOM ||
                        (bloom[h[r] >> 21] >> ((h[r] >> 16) & 31) & 1u)))
            cand |= 1u << r;
        int base[PROBE_R], K_ = 0;
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r) {
          const unsigned int bal = __ballot_sync(0xffffffffu, (cand >> r) & 1u);
          base[r] = K_ + __popc(bal & lower);
          K_ += __popc(bal);
        }
        CF cf[PROBE_R];
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r) cf[r] = 0;
        for (int q0 = 0; q0 < K_; q0 += 32) {
#pragma unroll
          for (int r = 0; r < PROBE_R; ++r) {
            const int idx = base[r] - q0;
            if ((cand & (1u << r)) && idx >= 0 && idx < 32)
              q[idx] = WalkSlot<CF>{
                  v0[r], h[r], static_cast<CF>(row0 - tile * PROBE_TILE) + r};
          }
          __syncwarp();
          if (q0 + lane < K_) {
            const WalkSlot<CF> w = q[lane];
            int f = 0;
            const int n_match = count_row(p, tile * PROBE_TILE + w.x, w.v0,
                                          w.h, b, t, C, &f);
            q[lane].x = static_cast<CF>(n_match) |
                        (static_cast<CF>(f) << R::CF_SHIFT);
          }
          __syncwarp();
#pragma unroll
          for (int r = 0; r < PROBE_R; ++r) {
            const int idx = base[r] - q0;
            if ((cand & (1u << r)) && idx >= 0 && idx < 32) cf[r] = q[idx].x;
          }
          __syncwarp();
        }
        // the segment's list, in row order, in shared memory
        int c[PROBE_R], k = 0;
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r) {
          c[r] = static_cast<int>(cf[r] & ((CF(1) << R::CF_SHIFT) - 1));
          pairs += c[r];
          const unsigned int bal = __ballot_sync(0xffffffffu, c[r] > 0);
          k += __popc(bal & lower);
          seg_matched += __popc(bal);
        }
#pragma unroll
        for (int r = 0; r < PROBE_R; ++r) {
          if (c[r] > 0)
            list[k++] = static_cast<Ent>(row0 - tile * PROBE_TILE + r) |
                        (static_cast<Ent>(cf[r] >> R::CF_SHIFT)
                         << ENT_SLOT_SHIFT) |
                        (static_cast<Ent>(c[r]) << R::COUNT_SHIFT);
        }
        pairs = __reduce_add_sync(0xffffffffu, pairs);
      }
    }
    if (lane == 0) {
      seg_pairs[warp] = pairs;
      seg_rows[warp] = seg_matched;
    }
    __syncthreads();
    // offset: publish the tile's pairs, look back for the earlier tiles'
    if (warp == 0) {
      const long long sum = warp_sum_ll(lane < PROBE_WARPS ? seg_pairs[lane]
                                                           : 0);
      if (lane == 0)
        atomicExch(state + tile,
                   ((tile == 0 ? LB_PREFIX : LB_AGG) << LB_SHIFT) |
                       static_cast<unsigned long long>(sum));
      const long long excl = tile == 0 ? 0 : look_back(state, tile, lane);
      if (lane == 0) {
        if (tile > 0)
          atomicExch(state + tile, (LB_PREFIX << LB_SHIFT) |
                                       static_cast<unsigned long long>(
                                           excl + sum));
        if (tile == tiles - 1) *overflow = excl + sum > row_cap;
        base_s = excl;
      }
    }
    __syncthreads();
    // emit: segment `warp`'s pairs below row_cap, at the tile's offset
    // plus the pairs of its earlier segments (as emit_kernel)
    const int matched = seg_rows[warp];
    long long start = base_s;
    for (int w = 0; w < warp; ++w) start += seg_pairs[w];
    if (matched > 0 && start < row_cap) {
      const int seg_total = seg_pairs[warp];
      const long long room = row_cap - start;
      const int keep = room < seg_total ? static_cast<int>(room) : seg_total;
      int* dst_l = out_l + start;
      int* dst_r = out_r + start;
      const bool staged = seg_total <= EMIT_STAGE;
      int* to_l = staged ? stage_l : dst_l;
      int* to_r = staged ? stage_r : dst_r;
      int run = 0;
      for (int e0 = 0; e0 < matched; e0 += 32) {
        const int e = e0 + lane;
        const Ent w = e < matched ? list[e] : Ent(0);
        const int cnt = static_cast<int>(w >> R::COUNT_SHIFT);
        const int incl = warp_incl(cnt, lane);
        int o = run + incl - cnt;
        run += __shfl_sync(0xffffffffu, incl, 31);
        if (cnt > 0) {
          const int row = static_cast<int>(tile * PROBE_TILE +
                                           (w & (PROBE_TILE - 1)));
          const int s0 = static_cast<int>(
              (w >> ENT_SLOT_SHIFT) &
              ((Ent(1) << (R::COUNT_SHIFT - ENT_SLOT_SHIFT)) - 1));
          const unsigned long long f = t.at(s0);
          const int r0 = ent_row(f);
          const uint32_t h0 = ent_hash(f);
          const int end = staged || o + cnt <= keep ? o + cnt : keep;
          if (o < end) {
            to_l[o] = row;
            to_r[o] = r0;
          }
          ++o;
          for (int d = 1; o < end && d < C; ++d) {
            const int s = (s0 + d) & mask;
            const unsigned long long en = t.at(s);
            const int r = ent_row(en);
            if (r < 0) break;
            if (ent_hash(en) == h0 && build_keys_equal(b, t, s, r, s0, r0)) {
              to_l[o] = row;
              to_r[o] = r;
              ++o;
            }
          }
        }
      }
      if (staged) {
        __syncwarp();
        for (int o = lane; o < keep; o += 32) {
          dst_l[o] = stage_l[o];
          dst_r[o] = stage_r[o];
        }
      }
    }
    __syncthreads();                   // the lists, stages and sums reused
  }
  // the slots: valid below the total, the maps' zeros past the pairs
  if (threadIdx.x == 0) {
    unsigned long long w = lb_read(state + tiles - 1);
    while ((w >> LB_SHIFT) != LB_PREFIX) {
      __nanosleep(64);
      w = lb_read(state + tiles - 1);
    }
    total_s = static_cast<long long>(w & LB_VALUE);
  }
  __syncthreads();
  const long long total = total_s;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       4 * g < row_cap; g += step) {
    const long long j = 4 * g;
    if (j + 4 <= row_cap) {
      reinterpret_cast<uchar4*>(valid)[g] =
          make_uchar4(j < total, j + 1 < total, j + 2 < total, j + 3 < total);
      if (j >= total) {
        reinterpret_cast<int4*>(out_l)[g] = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(out_r)[g] = make_int4(0, 0, 0, 0);
        continue;
      }
    }
    for (long long i = j; i < j + 4 && i < row_cap; ++i) {
      if (j + 4 > row_cap) valid[i] = i < total;
      if (i >= total) {
        out_l[i] = 0;
        out_r[i] = 0;
      }
    }
  }
}

static bool make_keys(Keys* k, const void* const* data,
                      const void* const* valid, const int* width,
                      const int* wide, int nk) {
  if (nk < 1 || nk > MAX_KEYS) return false;
  k->nk = nk;
  k->alive = nullptr;
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

// kind: VK_* per column; offsets: a STRING column's, null otherwise
static bool make_vkeys(VKeys* k, const void* const* data,
                       const void* const* valid, const void* const* offsets,
                       const int* width, const int* wide, const int* kind,
                       int nk) {
  if (nk < 1 || nk > MAX_KEYS) return false;
  k->nk = nk;
  k->alive = nullptr;
  for (int j = 0; j < MAX_KEYS; ++j) {
    const bool used = j < nk;
    k->data[j] = used ? data[j] : nullptr;
    k->valid[j] = used ? static_cast<const unsigned char*>(valid[j]) : nullptr;
    k->offsets[j] = used ? static_cast<const int*>(offsets[j]) : nullptr;
    k->width[j] = used ? width[j] : 8;
    k->wide[j] = used ? wide[j] : 0;
    k->kind[j] = used ? kind[j] : VK_FIXED;
    if (!used) continue;
    if (kind[j] < VK_FIXED || kind[j] > VK_STRING) return false;
    if (kind[j] == VK_STRING && offsets[j] == nullptr) return false;
    if (kind[j] == VK_FIXED && width[j] != 1 && width[j] != 2 &&
        width[j] != 4 && width[j] != 8)
      return false;
  }
  return true;
}

static bool capacity_ok(int C) {
  return C >= 1 && C <= MAX_CAPACITY && (C & (C - 1)) == 0;
}

// the blocks of `kernel` the card holds at once
template <typename K>
static cudaError_t resident_blocks(K kernel, size_t smem,
                                   long long* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        PROBE_THREADS, smem);
  *resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return err;
}

// as many blocks of `kernel` as the card holds at once, at most one a tile
template <typename K>
static cudaError_t probe_grid(K kernel, size_t smem, long long n,
                              unsigned int* blocks) {
  long long resident = 0;
  const cudaError_t err = resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  *blocks = static_cast<unsigned int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

// ---- launches, for either key type ------------------------------------------

template <typename K>
static int build_small(const K& b, long long n, int C, int* slot_row,
                       uint32_t* slot_hash, void* stream) {
  if (n < 1 || n > SMALL_BUILD_ROWS || !capacity_ok(C) ||
      C > SMALL_CAPACITY || 2 * n > C)
    return static_cast<int>(cudaErrorInvalidValue);
  build_kernel<K><<<1, BUILD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<int>(n), C, slot_row, slot_hash);
  return static_cast<int>(cudaGetLastError());
}

// the large route: six launches on the stream, after one memset of the
// scratch's state and counts
template <typename K>
static int build_large(const K& b, long long n, int C,
                       unsigned long long* table, int* scratch,
                       void* stream) {
  if (n < 1 || n > MAX_BUILD_ROWS || !capacity_ok(C) ||
      C <= SMALL_CAPACITY || 2 * n > C || table == nullptr ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  LargeBuild L;
  large_layout(n, C, scratch, &L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(int) * (BL_STATE + C), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid over the rows: a block 256 rows a step, at most 8 blocks an SM
  const long long want = (n + BL_THREADS - 1) / BL_THREADS;
  const unsigned int rows_grid = static_cast<unsigned int>(
      want < 8LL * sms ? want : 8LL * sms);
  const long long listed = n / 2 + 1;          // buckets of two rows or more
  const long long sort_want = (listed + BL_THREADS - 1) / BL_THREADS;
  const unsigned int sort_grid = static_cast<unsigned int>(
      sort_want < 4LL * sms ? sort_want : 4LL * sms);
  bl_hash_kernel<K><<<rows_grid, BL_THREADS, 0, s>>>(b, n, C, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int scan = scan_threads(C);
  bl_tiles_kernel<<<C / (BL_PER * scan), scan, 0, s>>>(C, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bl_slots_kernel<<<C / (BL_PER * scan), scan, 0, s>>>(C, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bl_fill_kernel<<<rows_grid, BL_THREADS, 0, s>>>(n, C, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bl_sort_kernel<<<sort_grid, BL_THREADS, 0, s>>>(L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bl_table_kernel<<<C / BL_THREADS, BL_THREADS, 0, s>>>(C, L, table);
  return static_cast<int>(cudaGetLastError());
}

// key columns staged in shared memory: none for variable-width keys
template <typename K>
static int staged_cols(const K& k) {
  if (IsVar<K>::value) return 0;
  return k.nk < SMEM_KEY_COLS ? k.nk : SMEM_KEY_COLS;
}

template <typename K>
static int count_launch(const K& p, long long n, const K& b,
                        const int* slot_row, const uint32_t* slot_hash,
                        const unsigned long long* ent, int C, int* counts,
                        void* entries, int* seg, long long* scratch,
                        void* stream) {
  const bool large = C > SMALL_CAPACITY;
  if (n < 1 || n > INT_MAX || !capacity_ok(C) || scratch == nullptr ||
      (large && ent == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nks = staged_cols(p);
  const size_t smem = large ? 0 : count_smem_bytes(C, nks);
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaSuccess;
  unsigned int blocks = 0;
  if (large) {
    err = probe_grid(count_kernel<true, K>, smem, n, &blocks);
  } else {
    err = cudaFuncSetAttribute(
        count_kernel<false, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(count_smem_bytes(SMALL_CAPACITY, SMEM_KEY_COLS)));
    if (err == cudaSuccess)
      err = probe_grid(count_kernel<false, K>, smem, n, &blocks);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch + 1, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  const long long segs = (n + PROBE_SEG - 1) / PROBE_SEG;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + 1);
  if (large)
    count_kernel<true, K><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, counts,
        static_cast<unsigned long long*>(entries), seg, seg + segs,
        scratch + 2, scratch + 2 + tiles, scratch, ticket);
  else
    count_kernel<false, K><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, counts,
        static_cast<unsigned int*>(entries), seg, seg + segs, scratch + 2,
        scratch + 2 + tiles, scratch, ticket);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
static int exists_launch(const K& p, long long n, const K& b,
                         const int* slot_row, const uint32_t* slot_hash,
                         const unsigned long long* ent, int C,
                         unsigned char* out, void* stream) {
  const bool large = C > SMALL_CAPACITY;
  if (n < 1 || n > INT_MAX || !capacity_ok(C) || out == nullptr ||
      (large && ent == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nks = staged_cols(p);
  const size_t smem = large ? 0 : count_smem_bytes(C, nks);
  cudaError_t err = cudaSuccess;
  unsigned int blocks = 0;
  if (large) {
    err = probe_grid(exists_kernel<true, K>, smem, n, &blocks);
  } else {
    err = cudaFuncSetAttribute(
        exists_kernel<false, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(count_smem_bytes(SMALL_CAPACITY, SMEM_KEY_COLS)));
    if (err == cudaSuccess)
      err = probe_grid(exists_kernel<false, K>, smem, n, &blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (large)
    exists_kernel<true, K><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, out);
  else
    exists_kernel<false, K><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
static int emit_launch(const K& b, long long n, const int* slot_row,
                       const uint32_t* slot_hash,
                       const unsigned long long* ent, int C,
                       const void* entries, const int* seg_sum,
                       const int* seg_matched, const long long* tile_off,
                       long long limit, int* out_l, int* out_r,
                       void* stream) {
  const bool large = C > SMALL_CAPACITY;
  if (n < 1 || n > INT_MAX || !capacity_ok(C) || (large && ent == nullptr) ||
      limit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nks = staged_cols(b);
  const size_t smem = large ? emit_stage_bytes() : emit_smem_bytes(C, nks);
  cudaError_t err = cudaSuccess;
  unsigned int blocks = 0;
  if (large) {
    err = probe_grid(emit_kernel<true, K>, smem, n, &blocks);
  } else {
    err = cudaFuncSetAttribute(
        emit_kernel<false, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(emit_smem_bytes(SMALL_CAPACITY, SMEM_KEY_COLS)));
    if (err == cudaSuccess)
      err = probe_grid(emit_kernel<false, K>, smem, n, &blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (large)
    emit_kernel<true, K><<<blocks, PROBE_THREADS, smem, s>>>(
        b, slot_row, slot_hash, ent, C, nks, n,
        static_cast<const unsigned long long*>(entries), seg_sum,
        seg_matched, tile_off, limit, out_l, out_r);
  else
    emit_kernel<false, K><<<blocks, PROBE_THREADS, smem, s>>>(
        b, slot_row, slot_hash, ent, C, nks, n,
        static_cast<const unsigned int*>(entries), seg_sum, seg_matched,
        tile_off, limit, out_l, out_r);
  return static_cast<int>(cudaGetLastError());
}

// the capped probe: as many blocks as the card holds at once, at most one
// a tile or a block's share of the slots (4 a thread, 8 rounds); the
// scratch (the tile counter, then a word a tile) zeroed on the stream
template <typename K>
static int capped_launch(const K& p, long long n, const K& b,
                         const int* slot_row, const uint32_t* slot_hash,
                         const unsigned long long* ent, int C,
                         long long row_cap, int* out_l, int* out_r,
                         unsigned char* valid, unsigned char* overflow,
                         unsigned long long* scratch, void* stream) {
  const bool large = C > SMALL_CAPACITY;
  if (n < 1 || n > INT_MAX || !capacity_ok(C) || row_cap < 0 ||
      row_cap > INT_MAX || scratch == nullptr || overflow == nullptr ||
      (large && ent == nullptr) ||
      (row_cap > 0 && (out_l == nullptr || out_r == nullptr ||
                       valid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nks = staged_cols(p);
  const size_t smem = capped_smem_bytes(large, C, nks);
  cudaError_t err = cudaSuccess;
  long long resident = 0;
  if (large) {
    err = cudaFuncSetAttribute(
        capped_kernel<true, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess)
      err = resident_blocks(capped_kernel<true, K>, smem, &resident);
  } else {
    err = cudaFuncSetAttribute(
        capped_kernel<false, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(
            capped_smem_bytes(false, SMALL_CAPACITY, SMEM_KEY_COLS)));
    if (err == cudaSuccess)
      err = resident_blocks(capped_kernel<false, K>, smem, &resident);
  }
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (1 + tiles),
                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fill = (row_cap + 32LL * PROBE_THREADS - 1) /
                         (32LL * PROBE_THREADS);
  long long want = tiles > fill ? tiles : fill;
  const unsigned int blocks = static_cast<unsigned int>(
      want < resident ? want : resident);
  if (large)
    capped_kernel<true, K><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, row_cap, out_l, out_r,
        valid, overflow, scratch, scratch + 1);
  else
    capped_kernel<false, K><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, row_cap, out_l, out_r,
        valid, overflow, scratch, scratch + 1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// the small route: C <= SMALL_CAPACITY, n <= C / 2. alive: (n,) bytes, the
// rows to insert besides the valid ones (the capped tier's live rows), or
// null for every row
int hj_build(const void* const* data, const void* const* valid,
             const int* width, const int* wide, int nk, long long n,
             const void* alive, int C, int* slot_row, uint32_t* slot_hash,
             void* stream) {
  Keys b;
  if (!make_keys(&b, data, valid, width, wide, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  b.alive = static_cast<const unsigned char*>(alive);
  return build_small(b, n, C, slot_row, slot_hash, stream);
}

// the large route: SMALL_CAPACITY < C <= MAX_CAPACITY, n <= C / 2. table:
// (C,) 8-byte words; scratch: hj_build_large_scratch(n, C) int32, each
// call's own; scratch[3] gets the rounds.
int hj_build_large(const void* const* data, const void* const* valid,
                   const int* width, const int* wide, int nk, long long n,
                   const void* alive, int C, unsigned long long* table,
                   int* scratch, void* stream) {
  Keys b;
  if (!make_keys(&b, data, valid, width, wide, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  b.alive = static_cast<const unsigned char*>(alive);
  return build_large(b, n, C, table, scratch, stream);
}

// the large build's scratch, in int32s, for n rows and C slots
long long hj_build_large_scratch(long long n, int C) {
  LargeBuild L;
  return large_layout(n, C, nullptr, &L);
}

// counts: (n,) int32; entries: (n,) uint32 on the small route, uint64 on the
// large one, segment k's list of matched rows from row k * PROBE_SEG on;
// seg: 2 * segs int32 (segs = ceil(n / PROBE_SEG)), the segments' pairs,
// then their matched rows. scratch: 2 + 2 * tiles int64 (tiles = ceil(n /
// PROBE_TILE)): [0] the total, [1] the ticket (zeroed here on the launch
// stream), the tiles' pairs, then their exclusive offsets. The table is
// (slot_row, slot_hash) on the small route (C <= SMALL_CAPACITY) and the
// large build's words `ent` on the large one.
int hj_count(const void* const* pdata, const void* const* pvalid,
             const int* width, const int* wide, int nk, long long n,
             const void* const* bdata, const int* slot_row,
             const uint32_t* slot_hash, const unsigned long long* ent, int C,
             int* counts, void* entries, int* seg, long long* scratch,
             void* stream) {
  Keys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_keys(&p, pdata, pvalid, width, wide, nk) ||
      !make_keys(&b, bdata, no_valid, width, wide, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return count_launch(p, n, b, slot_row, slot_hash, ent, C, counts, entries,
                      seg, scratch, stream);
}

// out: (n,) bytes, 1 where the probe row has a match in the table (small
// route: slot_row, slot_hash; large: ent), 0 elsewhere and for a row with
// a null key
int hj_exists(const void* const* pdata, const void* const* pvalid,
              const int* width, const int* wide, int nk, long long n,
              const void* const* bdata, const int* slot_row,
              const uint32_t* slot_hash, const unsigned long long* ent, int C,
              unsigned char* out, void* stream) {
  Keys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_keys(&p, pdata, pvalid, width, wide, nk) ||
      !make_keys(&b, bdata, no_valid, width, wide, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return exists_launch(p, n, b, slot_row, slot_hash, ent, C, out, stream);
}

// entries, seg_sum, seg_matched and tile_off: hj_count's, for n probe rows,
// with the same table; out_l, out_r: (limit,) int32 each, written at the
// pairs' positions below limit (the total or less: the eager join passes
// the total)
int hj_emit(const void* const* bdata, const int* width, const int* wide,
            int nk, long long n, const int* slot_row,
            const uint32_t* slot_hash, const unsigned long long* ent, int C,
            const void* entries, const int* seg_sum, const int* seg_matched,
            const long long* tile_off, long long limit, int* out_l,
            int* out_r, void* stream) {
  Keys b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_keys(&b, bdata, no_valid, width, wide, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return emit_launch(b, n, slot_row, slot_hash, ent, C, entries, seg_sum,
                     seg_matched, tile_off, limit, out_l, out_r, stream);
}

// The variable-width entry points: hj_build's, hj_build_large's,
// hj_count's, hj_emit's and hj_exists' contracts, for key sets with a
// STRING, DECIMAL128 or float column. Each column has a kind (VK_*) and, for
// STRING, its offsets.
int hj_build_var(const void* const* data, const void* const* valid,
                 const void* const* offsets, const int* width,
                 const int* wide, const int* kind, int nk, long long n,
                 const void* alive, int C, int* slot_row,
                 uint32_t* slot_hash, void* stream) {
  VKeys b;
  if (!make_vkeys(&b, data, valid, offsets, width, wide, kind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  b.alive = static_cast<const unsigned char*>(alive);
  return build_small(b, n, C, slot_row, slot_hash, stream);
}

int hj_build_large_var(const void* const* data, const void* const* valid,
                       const void* const* offsets, const int* width,
                       const int* wide, const int* kind, int nk,
                       long long n, const void* alive, int C,
                       unsigned long long* table, int* scratch,
                       void* stream) {
  VKeys b;
  if (!make_vkeys(&b, data, valid, offsets, width, wide, kind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  b.alive = static_cast<const unsigned char*>(alive);
  return build_large(b, n, C, table, scratch, stream);
}

int hj_count_var(const void* const* pdata, const void* const* pvalid,
                 const void* const* poffsets, const int* width,
                 const int* wide, const int* kind, int nk, long long n,
                 const void* const* bdata, const void* const* boffsets,
                 const int* slot_row, const uint32_t* slot_hash,
                 const unsigned long long* ent, int C, int* counts,
                 void* entries, int* seg, long long* scratch, void* stream) {
  VKeys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_vkeys(&p, pdata, pvalid, poffsets, width, wide, kind, nk) ||
      !make_vkeys(&b, bdata, no_valid, boffsets, width, wide, kind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return count_launch(p, n, b, slot_row, slot_hash, ent, C, counts, entries,
                      seg, scratch, stream);
}

int hj_emit_var(const void* const* bdata, const void* const* boffsets,
                const int* width, const int* wide, const int* kind, int nk,
                long long n, const int* slot_row, const uint32_t* slot_hash,
                const unsigned long long* ent, int C, const void* entries,
                const int* seg_sum, const int* seg_matched,
                const long long* tile_off, long long limit, int* out_l,
                int* out_r, void* stream) {
  VKeys b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_vkeys(&b, bdata, no_valid, boffsets, width, wide, kind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return emit_launch(b, n, slot_row, slot_hash, ent, C, entries, seg_sum,
                     seg_matched, tile_off, limit, out_l, out_r, stream);
}

int hj_exists_var(const void* const* pdata, const void* const* pvalid,
                  const void* const* poffsets, const int* width,
                  const int* wide, const int* kind, int nk, long long n,
                  const void* const* bdata, const void* const* boffsets,
                  const int* slot_row, const uint32_t* slot_hash,
                  const unsigned long long* ent, int C, unsigned char* out,
                  void* stream) {
  VKeys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_vkeys(&p, pdata, pvalid, poffsets, width, wide, kind, nk) ||
      !make_vkeys(&b, bdata, no_valid, boffsets, width, wide, kind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return exists_launch(p, n, b, slot_row, slot_hash, ent, C, out, stream);
}

// The capped tier's inner join after hj_build over the live build rows:
// palive (n,) bytes, the live probe rows (null: all); out_l, out_r
// (row_cap,) int32: the first row_cap pairs in probe-row, then chain order,
// 0 past them; valid (row_cap,) bytes, slot < total; overflow one byte,
// total > row_cap; scratch 1 + ceil(n / PROBE_TILE) 8-byte words, each
// call's own (zeroed here on the launch stream). The table as hj_count's.
int hj_capped(const void* const* pdata, const void* const* pvalid,
              const int* width, const int* wide, int nk, long long n,
              const void* palive, const void* const* bdata,
              const int* slot_row, const uint32_t* slot_hash,
              const unsigned long long* ent, int C, long long row_cap,
              int* out_l, int* out_r, unsigned char* valid,
              unsigned char* overflow, unsigned long long* scratch,
              void* stream) {
  Keys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_keys(&p, pdata, pvalid, width, wide, nk) ||
      !make_keys(&b, bdata, no_valid, width, wide, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  p.alive = static_cast<const unsigned char*>(palive);
  return capped_launch(p, n, b, slot_row, slot_hash, ent, C, row_cap, out_l,
                       out_r, valid, overflow, scratch, stream);
}

int hj_capped_var(const void* const* pdata, const void* const* pvalid,
                  const void* const* poffsets, const int* width,
                  const int* wide, const int* kind, int nk, long long n,
                  const void* palive, const void* const* bdata,
                  const void* const* boffsets, const int* slot_row,
                  const uint32_t* slot_hash, const unsigned long long* ent,
                  int C, long long row_cap, int* out_l, int* out_r,
                  unsigned char* valid, unsigned char* overflow,
                  unsigned long long* scratch, void* stream) {
  VKeys p, b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  if (!make_vkeys(&p, pdata, pvalid, poffsets, width, wide, kind, nk) ||
      !make_vkeys(&b, bdata, no_valid, boffsets, width, wide, kind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  p.alive = static_cast<const unsigned char*>(palive);
  return capped_launch(p, n, b, slot_row, slot_hash, ent, C, row_cap, out_l,
                       out_r, valid, overflow, scratch, stream);
}

}  // extern "C"
