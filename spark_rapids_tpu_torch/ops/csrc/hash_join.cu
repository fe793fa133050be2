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
// - Build: an open-addressing table filled by the TPU kernel's parallel
//   rounds: every unplaced valid row proposes slot (h + d) & (C-1), the
//   lowest row id wins a free slot, losers advance. Equal keys therefore
//   land in ascending-row chain order, which is what makes emission match
//   the sort-based fallback pair for pair. Invalid rows are never inserted.
//   Two routes by capacity. Small, C <= 1,024 (build sides up to 512 rows,
//   the reference's limit): one block, the table in shared memory
//   (shared-memory atomicMin), written out as (slot_row, slot_hash): the
//   winning row id (-1 = empty) and its 32-bit hash. Large, C up to 2^23
//   (2^22 build rows, a 64 MB table): a cooperative grid, the table in
//   global memory as one 8-byte word a slot, the rounds' claims settled by
//   atomicMin and one grid-wide barrier a round, stopping at the first
//   round in which no row is left to propose (build_large_kernel); the
//   table it leaves is hash << 32 | row, the word the probes read. The key
//   values stay in the build columns.
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
// The small build moves a few KB and is bound by its launch and its rounds
// of block-wide barriers; the large build by its rounds of grid-wide
// barriers (about a microsecond each on an H100), about 22 at 52,000 rows.
//
// Plain C interface for ctypes. Every entry point returns
// cudaGetLastError() after its launch (or cudaErrorInvalidValue for
// arguments it does not take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

#define MAX_KEYS 32
#define SMALL_CAPACITY 1024                      // the small route's tables
#define SMALL_BUILD_ROWS (SMALL_CAPACITY / 2)
#define MAX_CAPACITY (1 << 23)                   // the large route's tables
#define MAX_BUILD_ROWS (MAX_CAPACITY / 2)
#define BUILD_THREADS 1024
#define LARGE_BUILD_THREADS 512
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
  for (int j = 0; j < k.nk; ++j)
    if (k.valid[j] != nullptr && !k.valid[j][i]) return false;
  return true;
}

__device__ __forceinline__ uint32_t row_hash(const Keys& k, long long i) {
  uint32_t h = 42u;
  for (int j = 0; j < k.nk; ++j) h = hash_col(h, load_key(k, j, i), k.wide[j]);
  return h;
}

__global__ void __launch_bounds__(BUILD_THREADS)
build_kernel(const __grid_constant__ Keys b, int n, int C, int* slot_row_out,
             uint32_t* slot_hash_out) {
  __shared__ int slot_row[SMALL_CAPACITY];
  __shared__ uint32_t slot_hash[SMALL_CAPACITY];
  __shared__ int proposal[SMALL_CAPACITY];
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

// ---- the large route's build ----------------------------------------------

// A slot's word during the large build's rounds: empty (all ones), or the
// claim of the row that proposed it: 1 << 62 | round << 32 | row. A claim
// of round r is smaller than any claim of a later round, so atomicMin over
// a round's claims leaves the lowest row's claim in a slot that was empty
// when the round began, and no later claim displaces it: a slot taken in
// round r is occupied for every later round, as in the reference.
#define SLOT_EMPTY (~0ull)
#define ROW_PLACED 0xffffffffu                   // a row's distance, placed

__device__ __forceinline__ unsigned long long claim_word(int round, int row) {
  return (1ull << 62) | (static_cast<unsigned long long>(round) << 32) |
         static_cast<uint32_t>(row);
}

// The table of the large route, C > SMALL_CAPACITY: the same rounds as
// build_kernel over a cooperative grid, one grid-wide barrier a round. In
// round r a thread, for each of its unplaced rows, first settles the
// proposal of round r - 1: the row is placed if its slot holds its claim,
// else it advances; then it proposes round r's slot with an atomicMin of
// its claim. The barrier makes round r's claims final before round r + 1
// reads them. A round in which no row proposes ends the build. Then every
// slot becomes (hash << 32 | row), or (0 << 32 | 0xffffffff) where empty:
// the probes' word. Per row the state is its hash and distance (scratch);
// counters[0..2] count the proposals of rounds r mod 3, counters[3] gets
// the rounds.
__global__ void __launch_bounds__(LARGE_BUILD_THREADS)
build_large_kernel(const __grid_constant__ Keys b, int n, int C,
                   unsigned long long* __restrict__ table,
                   uint32_t* __restrict__ row_h, uint32_t* __restrict__ row_d,
                   int* counters) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int s = tid; s < C; s += stride) table[s] = SLOT_EMPTY;
  for (int i = tid; i < n; i += stride) {
    row_h[i] = row_hash(b, i);
    row_d[i] = row_valid(b, i) ? 0u : ROW_PLACED;  // invalid rows never insert
  }
  if (tid < 3) counters[tid] = 0;
  grid.sync();
  const uint32_t mask = static_cast<uint32_t>(C - 1);
  int round = 0;
  for (; round < 2 * C + 2; ++round) {
    // counters[(round + 1) % 3] was last read after round - 2's barrier
    if (tid == 0) atomicExch(&counters[(round + 1) % 3], 0);
    int proposed = 0;
    for (int i = tid; i < n; i += stride) {
      uint32_t d = row_d[i];
      if (d == ROW_PLACED) continue;
      const uint32_t h = row_h[i];
      if (round > 0) {
        const unsigned long long w = __ldcg(&table[(h + d) & mask]);
        if (w == claim_word(round - 1, i)) {
          row_d[i] = ROW_PLACED;
          continue;
        }
        row_d[i] = ++d;
      }
      atomicMin(&table[(h + d) & mask], claim_word(round, i));
      ++proposed;
    }
    proposed = __reduce_add_sync(0xffffffffu, proposed);
    if (lane == 0 && proposed > 0) atomicAdd(&counters[round % 3], proposed);
    grid.sync();
    if (__ldcg(&counters[round % 3]) == 0) break;
  }
  for (int s = tid; s < C; s += stride) {
    const unsigned long long w = __ldcg(&table[s]);
    const uint32_t r = static_cast<uint32_t>(w);
    table[s] = w == SLOT_EMPTY
                   ? 0xffffffffull
                   : (static_cast<unsigned long long>(row_h[r]) << 32) | r;
  }
  if (tid == 0) counters[3] = round;
}

// grid-wide barriers alone, at the large build's block size: its cost a round
__global__ void __launch_bounds__(LARGE_BUILD_THREADS)
barrier_kernel(int rounds, int* out) {
  cg::grid_group grid = cg::this_grid();
  for (int r = 0; r < rounds; ++r) grid.sync();
  if (grid.thread_rank() == 0) *out = rounds;
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
__device__ __forceinline__ SmemTable stage_table(unsigned char* smem,
                                                 const Keys& b,
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
  return t;
}

// probe row i (first key value v0) against build row r, in slot s
template <typename T>
__device__ __forceinline__ bool keys_equal(const Keys& p, long long i,
                                           long long v0, const Keys& b,
                                           int r, const T& t, int s) {
  if (t.first_key(b, s, r) != v0) return false;
  for (int j = 1; j < p.nk; ++j)
    if (load_key(p, j, i) != t.key_of(b, j, s, r)) return false;
  return true;
}

// build rows r (slot s) and r0 (slot s0) have equal keys
template <typename T>
__device__ __forceinline__ bool build_keys_equal(const Keys& b, const T& t,
                                                 int s, int r, int s0,
                                                 int r0) {
  for (int j = 0; j < b.nk; ++j)
    if (t.key_of(b, j, s, r) != t.key_of(b, j, s0, r0)) return false;
  return true;
}

// the matches of probe row i (hash h) along its chain; *first gets the slot
// of the first
template <typename T>
__device__ __forceinline__ int count_row(const Keys& p, long long i,
                                         long long v0, uint32_t h,
                                         const Keys& b, const T& t, int C,
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

// rows row0 .. row0 + 7 inside n with every key valid
__device__ __forceinline__ void valid_rows(const Keys& k, long long row0,
                                           long long n, bool ok[PROBE_R]) {
#pragma unroll
  for (int r = 0; r < PROBE_R; ++r) ok[r] = row0 + r < n;
  for (int j = 0; j < k.nk; ++j) {
    if (k.valid[j] == nullptr) continue;
    const unsigned char* a = k.valid[j] + row0;
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

// warp-wide inclusive sum
template <typename T>
__device__ __forceinline__ T warp_incl(T x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// A persistent grid: block g counts tiles g, g + G, ...; warp w of a block
// takes segment w of each tile (PROBE_SEG rows), a lane the 8 consecutive
// rows at lane * 8 of it. Per segment the warp writes the counts, its list
// of matched rows (entries, from the segment's first row on), their number
// and the segment's pairs; no warp waits for another. At the end the block
// sums its tiles' segments, and the last block to finish scans the tiles'
// pairs into offsets and the total. The tile arrays, total and ticket are
// the call's scratch (the ticket zeroed on the launch stream).
template <bool LARGE>
__global__ void __launch_bounds__(PROBE_THREADS)
count_kernel(const __grid_constant__ Keys p, long long n,
             const __grid_constant__ Keys b, const int* __restrict__ slot_row,
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
    // every load of the lane's rows before any hash
    long long v0[PROBE_R];
    load_rows(p, 0, row0, n, v0);
    bool ok[PROBE_R];
    valid_rows(p, row0, n, ok);
    uint32_t h[PROBE_R];
#pragma unroll
    for (int r = 0; r < PROBE_R; ++r) h[r] = hash_col(42u, v0[r], p.wide[0]);
    for (int j = 1; j < p.nk; ++j) {
      long long v[PROBE_R];
      load_rows(p, j, row0, n, v);
#pragma unroll
      for (int r = 0; r < PROBE_R; ++r) h[r] = hash_col(h[r], v[r], p.wide[j]);
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
// segment with more than EMIT_STAGE pairs writes them in place.
template <bool LARGE>
__global__ void __launch_bounds__(PROBE_THREADS)
emit_kernel(const __grid_constant__ Keys b, const int* __restrict__ slot_row,
            const uint32_t* __restrict__ slot_hash,
            const unsigned long long* __restrict__ ent, int C, int nks,
            long long n,
            const typename Route<LARGE>::Ent* __restrict__ entries,
            const int* __restrict__ seg_sum,
            const int* __restrict__ seg_matched,
            const long long* __restrict__ tile_off, int* __restrict__ out_l,
            int* __restrict__ out_r) {
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
    if (matched == 0) continue;
    // the pairs of the tile's earlier segments
    Sum earlier = lane < warp ? seg_sum[tile * PROBE_SEGS + lane] : 0;
    if constexpr (LARGE) {
      earlier = __shfl_sync(0xffffffffu, warp_incl(earlier, lane), 31);
    } else {
      earlier = __reduce_add_sync(0xffffffffu, earlier);
    }
    const int pairs = seg_sum[sg];
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
        const int end = o + cnt;
        to_l[o] = row;
        to_r[o] = r0;
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
      for (int o = lane; o < pairs; o += 32) {
        dst_l[o] = stage_l[o];
        dst_r[o] = stage_r[o];
      }
      __syncwarp();
    }
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

// as many blocks of `kernel` as the card holds at once, at most one a tile
template <typename K>
static cudaError_t probe_grid(K kernel, size_t smem, long long n,
                              unsigned int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        PROBE_THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  *blocks = static_cast<unsigned int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

// the cooperative grid of the large build: one block per LARGE_BUILD_THREADS
// rows, at most as many as the card holds at once (a grid barrier needs
// every block resident)
static cudaError_t large_build_grid(const void* kernel, long long rows,
                                    unsigned int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, LARGE_BUILD_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long want = (rows + LARGE_BUILD_THREADS - 1) / LARGE_BUILD_THREADS;
  *blocks = static_cast<unsigned int>(
      want < 1 ? 1 : (want < resident ? want : resident));
  return cudaSuccess;
}

extern "C" {

// the small route: C <= SMALL_CAPACITY, n <= C / 2
int hj_build(const void* const* data, const void* const* valid,
             const int* width, const int* wide, int nk, long long n, int C,
             int* slot_row, uint32_t* slot_hash, void* stream) {
  Keys b;
  if (!make_keys(&b, data, valid, width, wide, nk) || n < 1 ||
      n > SMALL_BUILD_ROWS || !capacity_ok(C) || C > SMALL_CAPACITY ||
      2 * n > C)
    return static_cast<int>(cudaErrorInvalidValue);
  build_kernel<<<1, BUILD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<int>(n), C, slot_row, slot_hash);
  return static_cast<int>(cudaGetLastError());
}

// the large route: SMALL_CAPACITY < C <= MAX_CAPACITY, n <= C / 2. table:
// (C,) 8-byte words; scratch: 2 * n + 4 int32, the rows' hashes and
// distances, then the round counters; scratch[2 * n + 3] gets the rounds.
int hj_build_large(const void* const* data, const void* const* valid,
                   const int* width, const int* wide, int nk, long long n,
                   int C, unsigned long long* table, int* scratch,
                   void* stream) {
  Keys b;
  if (!make_keys(&b, data, valid, width, wide, nk) || n < 1 ||
      n > MAX_BUILD_ROWS || !capacity_ok(C) || C <= SMALL_CAPACITY ||
      2 * n > C || table == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int blocks = 0;
  cudaError_t err = large_build_grid(
      reinterpret_cast<const void*>(build_large_kernel), n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = static_cast<int>(n);
  uint32_t* row_h = reinterpret_cast<uint32_t*>(scratch);
  uint32_t* row_d = row_h + n;
  int* counters = scratch + 2 * n;
  void* args[] = {&b, &rows, &C, &table, &row_h, &row_d, &counters};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_large_kernel), dim3(blocks),
      dim3(LARGE_BUILD_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `rounds` grid barriers on the large build's grid for `rows` rows; out:
// one int32. Times the barrier alone, for the large build's bound.
int hj_barrier(long long rows, int rounds, int* out, void* stream) {
  if (rows < 1 || rounds < 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int blocks = 0;
  cudaError_t err = large_build_grid(
      reinterpret_cast<const void*>(barrier_kernel), rows, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&rounds, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_kernel), dim3(blocks),
      dim3(LARGE_BUILD_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  const bool large = C > SMALL_CAPACITY;
  if (!make_keys(&p, pdata, pvalid, width, wide, nk) ||
      !make_keys(&b, bdata, no_valid, width, wide, nk) || n < 1 ||
      n > INT_MAX || !capacity_ok(C) || scratch == nullptr ||
      (large && ent == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nks = nk < SMEM_KEY_COLS ? nk : SMEM_KEY_COLS;
  const size_t smem = large ? 0 : count_smem_bytes(C, nks);
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaSuccess;
  unsigned int blocks = 0;
  if (large) {
    err = probe_grid(count_kernel<true>, smem, n, &blocks);
  } else {
    err = cudaFuncSetAttribute(
        count_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(count_smem_bytes(SMALL_CAPACITY, SMEM_KEY_COLS)));
    if (err == cudaSuccess)
      err = probe_grid(count_kernel<false>, smem, n, &blocks);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch + 1, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + PROBE_TILE - 1) / PROBE_TILE;
  const long long segs = (n + PROBE_SEG - 1) / PROBE_SEG;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + 1);
  if (large)
    count_kernel<true><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, counts,
        static_cast<unsigned long long*>(entries), seg, seg + segs,
        scratch + 2, scratch + 2 + tiles, scratch, ticket);
  else
    count_kernel<false><<<blocks, PROBE_THREADS, smem, s>>>(
        p, n, b, slot_row, slot_hash, ent, C, nks, counts,
        static_cast<unsigned int*>(entries), seg, seg + segs, scratch + 2,
        scratch + 2 + tiles, scratch, ticket);
  return static_cast<int>(cudaGetLastError());
}

// entries, seg_sum, seg_matched and tile_off: hj_count's, for n probe rows,
// with the same table; out_l, out_r: (total,) int32 each
int hj_emit(const void* const* bdata, const int* width, const int* wide,
            int nk, long long n, const int* slot_row,
            const uint32_t* slot_hash, const unsigned long long* ent, int C,
            const void* entries, const int* seg_sum, const int* seg_matched,
            const long long* tile_off, int* out_l, int* out_r,
            void* stream) {
  Keys b;
  const void* no_valid[MAX_KEYS] = {nullptr};
  const bool large = C > SMALL_CAPACITY;
  if (!make_keys(&b, bdata, no_valid, width, wide, nk) || n < 1 ||
      n > INT_MAX || !capacity_ok(C) || (large && ent == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nks = nk < SMEM_KEY_COLS ? nk : SMEM_KEY_COLS;
  const size_t smem = large ? emit_stage_bytes() : emit_smem_bytes(C, nks);
  cudaError_t err = cudaSuccess;
  unsigned int blocks = 0;
  if (large) {
    err = probe_grid(emit_kernel<true>, smem, n, &blocks);
  } else {
    err = cudaFuncSetAttribute(
        emit_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(emit_smem_bytes(SMALL_CAPACITY, SMEM_KEY_COLS)));
    if (err == cudaSuccess)
      err = probe_grid(emit_kernel<false>, smem, n, &blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (large)
    emit_kernel<true><<<blocks, PROBE_THREADS, smem, s>>>(
        b, slot_row, slot_hash, ent, C, nks, n,
        static_cast<const unsigned long long*>(entries), seg_sum,
        seg_matched, tile_off, out_l, out_r);
  else
    emit_kernel<false><<<blocks, PROBE_THREADS, smem, s>>>(
        b, slot_row, slot_hash, ent, C, nks, n,
        static_cast<const unsigned int*>(entries), seg_sum, seg_matched,
        tile_off, out_l, out_r);
  return static_cast<int>(cudaGetLastError());
}


}  // extern "C"
