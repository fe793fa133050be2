// Keyed aggregates by hashing (the groupby), for Hopper (sm_90a).
//
// The counterpart of the reference's registry op `groupby`
// (spark_rapids_tpu/ops/aggregate.py, `_groupby_kernel`), which sorts every
// row by its key tuple and reduces the sorted runs without a scatter: a
// trade its own docstring calls TPU-specific. On this card the rows are
// grouped in a hash table and reduced with atomics; only the G groups'
// representatives are ordered. Bit for bit what the port's plain groupby
// (ops/aggregate.py on CPU tensors) gives:
//
// - Groups. A group is a distinct key tuple as `sort._key_operands` tells
//   them apart: null in the same columns and equal in the others, floats
//   after the normalization of `_float_total_order` (-0.0 is 0.0, every
//   NaN one key), DECIMAL128 by its four limbs, STRING by length and
//   bytes (read through the offsets). Each group's representative is its
//   smallest row: the first row of its run under the plain version's
//   stable sort, which is where the key columns are taken from.
// - Insertion (gb_insert_kernel). One open-addressing table of C = a power
//   of two >= 1.5 n int32 slots (n: the rows, the padded rows in the
//   capped tier; sized on the host, never from a device count), each
//   holding a row of its group. A row hashes its keys (murmur3 steps), walks
//   from its bucket, claims an empty slot by compare-and-swap or stops at
//   the slot whose row's keys equal its own, and lowers the slot's row to
//   its own by atomicMin where its own is smaller (rare after a group's
//   first rows, so a hot key costs reads, not atomics). Claims take the
//   next group ids, one atomicAdd a block and pass; dead rows (the capped
//   tier's `alive`) are never inserted. The slot of each row goes to
//   `row_slot`. A lone integer key of 4 or 8 bytes (q23's, q5's) takes an
//   instantiation of its own, with no loop over key columns or kinds.
// - Order. The G representatives are sorted by key: on the host with the
//   port's `lex_order` over their G rows in the eager tier, which reads G
//   once (its one host read); in the capped tier, which reads nothing,
//   here: the representatives' order words (the operands of
//   `_key_operands`, fixed-width kinds only) bitonic-sorted in chunks of
//   SORT_CHUNK in shared memory, then merged pairwise (each entry finds its
//   place in the other run by binary search), every kernel looping over
//   the device's group count. gb_rank_kernel gives each occupied slot its
//   group's rank (-1 past the capped tier's key_cap) and each output row
//   its representative.
// - Aggregation (gb_agg_kernel). Counts, sizes, integer sums widened to
//   INT64 and wrapping like a Java long, and min/max over order words (the
//   total-order word for floats), all exact in any order, by rank: a
//   thread takes GB_ROWS rows 512 apart, and commits each row's value with
//   one atomic, or, where the warp's 32 rows share a rank (a one-group
//   aggregate), the warp adds them by shuffles and commits once. Where the
//   ranks fit (DENSE: every job's accumulators for all of them in shared
//   memory) the commits go to shared memory, sums and counts as two 32-bit
//   atomics (native, where a 64-bit shared add is not: a zipf key's
//   colliding lanes queue for less), to one of up to 32 copies of each
//   accumulator by lane where few groups leave room for them, and each
//   block adds its partials to the output once, at its end, so the hot
//   keys of a skewed column never queue on one global address; otherwise
//   (GLOBAL) each commit is one 64-bit global atomic. (Combining a warp's lanes of one rank first, by
//   __match_any_sync and shared memory, was slower on the H100.)
//   The eager tier chooses the route on the host from G; the capped tier
//   launches both and each reads the group count and returns at once when
//   it is the other's.
// - Float sums and means keep the reference's row-order fold: the caller
//   sorts the rows stably by their rank (`row_rank`, one int operand) and
//   the fold kernels below add each group's rows in that order.
//
// Bounds. The function must read each key column, each value and validity
// byte once and write the (G,) outputs: q23's sum(rev) by cust_sk reads 240
// MB (0.072 ms at 3.35 TB/s). This design adds the table's memset (4 C
// bytes), `row_slot` written and read (8 n bytes) and the representatives'
// sort.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue for arguments it does not
// take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define GB_MAX_KEYS 32
#define GB_THREADS 256
#define GB_ROWS 8
#define GB_TILE (GB_THREADS * GB_ROWS)     // rows an insertion block's pass
#define AGG_THREADS 512
#define AGG_TILE (AGG_THREADS * GB_ROWS)   // rows an aggregation block's pass
#define GB_MAX_JOBS 24                     // jobs a launch (kernel parameters)
#define GB_EMPTY (-1)                      // an empty slot
#define DENSE_BYTES (96 * 1024)            // a DENSE block's accumulators
#define SORT_CHUNK 1024                    // entries a block sorts alone
#define SORT_THREADS 512
#define FOLD_SHORT 32                      // rows a thread folds alone
#define FOLD_THREADS 128
#define FOLD_PAIRS (FOLD_THREADS / 64)     // (consumer, producer) warp pairs
#define FOLD_PER_LANE 16
#define FOLD_CHUNK (32 * FOLD_PER_LANE)    // rows a warp stages at a time

enum { OP_COUNT = 0, OP_SIZE = 1, OP_SUM = 2, OP_MIN = 3, OP_MAX = 4,
       OP_FSUM = 5 };
enum { T_I8 = 0, T_I16 = 1, T_I32 = 2, T_I64 = 3, T_F32 = 4, T_F64 = 5 };
// key kinds: an integer of `width` bytes (BOOL, INT8-64, DATE32, the
// TIMESTAMPs, DECIMAL32/64), FLOAT32, FLOAT64, DECIMAL128, STRING
enum { GK_INT = 0, GK_F32 = 1, GK_F64 = 2, GK_DEC128 = 3, GK_STRING = 4 };

struct Job {
  const void* data;             // values by row (null for count and size)
  const unsigned char* valid;   // validity by row, null: every row valid
  void* out;                    // (G,) int64 words or float64 sums
  int op;
  int type;
};

struct Jobs {
  Job j[GB_MAX_JOBS];
  int n;
};

struct GKeys {
  const void* data[GB_MAX_KEYS];
  const unsigned char* valid[GB_MAX_KEYS];   // null: every row valid
  const int* offsets[GB_MAX_KEYS];           // STRING: (n + 1,) int32
  int width[GB_MAX_KEYS];                    // GK_INT: storage bytes
  int kind[GB_MAX_KEYS];
  int nk;
};

// ---- keys: hash, equality, order words -------------------------------------
//
// The murmur3 steps and the float normalization are those of the hash
// join's variable-width keys (csrc/hash_join.cu, VKeys), copied so that the
// join's kernels keep their code; here a null hashes as a tag of its own
// and equals another null, where the join drops the row.

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

__device__ __forceinline__ bool gk_null(const GKeys& k, int j, long long i) {
  return k.valid[j] != nullptr && k.valid[j][i] == 0;
}

// a fixed-width key's value: integers sign-extended, floats normalized
__device__ __forceinline__ long long gk_word(const GKeys& k, int j,
                                             long long i) {
  switch (k.kind[j]) {
    case GK_F32:
      return static_cast<int>(
          norm_f32(static_cast<const unsigned int*>(k.data[j])[i]));
    case GK_F64:
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

__device__ __forceinline__ uint32_t gk_hash(const GKeys& k, long long i) {
  uint32_t h = 42u;
  for (int j = 0; j < k.nk; ++j) {
    const int kind = k.kind[j];
    if (gk_null(k, j, i)) {
      h = mm_fmix(mm_round(h, 0x9E3779B9u) ^ 1u);
    } else if (kind == GK_STRING) {
      const int a = k.offsets[j][i], e = k.offsets[j][i + 1];
      const unsigned char* c = static_cast<const unsigned char*>(k.data[j]) + a;
      const int len = e - a;
      for (int q = 0; q + 4 <= len; q += 4)
        h = mm_round(h, static_cast<uint32_t>(c[q]) |
                            (static_cast<uint32_t>(c[q + 1]) << 8) |
                            (static_cast<uint32_t>(c[q + 2]) << 16) |
                            (static_cast<uint32_t>(c[q + 3]) << 24));
      for (int t = len & ~3; t < len; ++t)
        h = mm_round(h, static_cast<uint32_t>(c[t]));
      h = mm_fmix(h ^ static_cast<uint32_t>(len));
    } else if (kind == GK_DEC128) {
      const uint32_t* q = static_cast<const uint32_t*>(k.data[j]) + 4 * i;
      h = mm_round(mm_round(mm_round(mm_round(h, q[0]), q[1]), q[2]), q[3]);
      h = mm_fmix(h ^ 16u);
    } else {
      const long long v = gk_word(k, j, i);
      const bool wide = k.width[j] == 8;
      h = mm_round(h, static_cast<uint32_t>(v));
      if (wide)
        h = mm_round(h, static_cast<uint32_t>(
                            static_cast<unsigned long long>(v) >> 32));
      h = mm_fmix(h ^ (wide ? 8u : 4u));
    }
  }
  return h;
}

// rows a and b are in one group
__device__ __forceinline__ bool gk_equal(const GKeys& k, long long a,
                                         long long b) {
  for (int j = 0; j < k.nk; ++j) {
    const bool na = gk_null(k, j, a);
    if (na != gk_null(k, j, b)) return false;
    if (na) continue;
    const int kind = k.kind[j];
    if (kind == GK_STRING) {
      const int ai = k.offsets[j][a], bi = k.offsets[j][b];
      const int len = k.offsets[j][a + 1] - ai;
      if (k.offsets[j][b + 1] - bi != len) return false;
      const unsigned char* x = static_cast<const unsigned char*>(k.data[j]);
      for (int t = 0; t < len; ++t)
        if (x[ai + t] != x[bi + t]) return false;
    } else if (kind == GK_DEC128) {
      const uint4 x = static_cast<const uint4*>(k.data[j])[a];
      const uint4 y = static_cast<const uint4*>(k.data[j])[b];
      if (x.x != y.x || x.y != y.y || x.z != y.z || x.w != y.w) return false;
    } else if (gk_word(k, j, a) != gk_word(k, j, b)) {
      return false;
    }
  }
  return true;
}

// The insertion's keys by shape: W = 0 any key set (gk_hash, gk_equal); W
// = 4 or 8 one integer key of W bytes (BOOL and narrower take W = 0), read
// with no loop over columns and no branch on kinds: the same hash and
// equality, at about half the instructions a row.
template <int W>
__device__ __forceinline__ long long one_key(const GKeys& k, long long i) {
  return W == 8 ? static_cast<const long long*>(k.data[0])[i]
                : static_cast<const int*>(k.data[0])[i];
}

template <int W>
__device__ __forceinline__ uint32_t key_hash(const GKeys& k, long long i) {
  if (W == 0) return gk_hash(k, i);
  if (gk_null(k, 0, i)) return mm_fmix(mm_round(42u, 0x9E3779B9u) ^ 1u);
  const long long v = one_key<W>(k, i);
  uint32_t h = mm_round(42u, static_cast<uint32_t>(v));
  if (W == 8)
    h = mm_round(h, static_cast<uint32_t>(
                        static_cast<unsigned long long>(v) >> 32));
  return mm_fmix(h ^ static_cast<uint32_t>(W));
}

template <int W>
__device__ __forceinline__ bool key_equal(const GKeys& k, long long a,
                                          long long b) {
  if (W == 0) return gk_equal(k, a, b);
  const bool na = gk_null(k, 0, a);
  if (na != gk_null(k, 0, b)) return false;
  return na || one_key<W>(k, a) == one_key<W>(k, b);
}

// Row `row`'s order words, ascending with nulls first, as `_key_operands`
// gives them for the fixed-width kinds: a null rank where the column has
// validity (0 null, 1 valid), then the value's words, zero under a null:
// integers as they are, floats by their total-order word, DECIMAL128 as its
// top 64 bits signed and its low 64 with the sign bit flipped.
__device__ __forceinline__ void gk_words(const GKeys& k, long long row,
                                         long long* w) {
  for (int j = 0; j < k.nk; ++j) {
    const bool nul = gk_null(k, j, row);
    if (k.valid[j] != nullptr) *w++ = nul ? 0 : 1;
    const int kind = k.kind[j];
    if (kind == GK_DEC128) {
      const ulonglong2 q = static_cast<const ulonglong2*>(k.data[j])[row];
      *w++ = nul ? 0 : static_cast<long long>(q.y);
      *w++ = nul ? 0 : static_cast<long long>(q.x ^ 0x8000000000000000ull);
      continue;
    }
    long long v = nul ? 0 : gk_word(k, j, row);
    if (kind == GK_F32) {
      const int b = static_cast<int>(v);
      v = b < 0 ? (~b ^ static_cast<int>(0x80000000u)) : b;
    } else if (kind == GK_F64) {
      v = v < 0 ? (~v ^ static_cast<long long>(0x8000000000000000ull)) : v;
    }
    *w++ = v;
  }
}

// ---- insertion -------------------------------------------------------------

// The slot of row i's group (hashed to h), claimed by compare-and-swap when
// the walk meets an empty slot (*claimed), and the row found there (row i
// when claimed). A plain, L1-cached load of a slot may be stale, but only
// as EMPTY (the swap then returns the occupant) or as a larger row of the
// slot's group (whose keys are the same): a slot, once claimed, only ever
// takes a smaller row of its group.
template <int W>
__device__ __forceinline__ int find_slot(const GKeys& keys, long long i,
                                         uint32_t h, int* table,
                                         unsigned mask, int* occ,
                                         bool* claimed) {
  int s = static_cast<int>(h & mask);
  for (;;) {
    int o = table[s];
    if (o == GB_EMPTY) {
      o = atomicCAS(table + s, GB_EMPTY, static_cast<int>(i));
      if (o == GB_EMPTY) {
        *claimed = true;
        *occ = static_cast<int>(i);
        return s;
      }
    }
    if (key_equal<W>(keys, o, i)) {
      *occ = o;
      return s;
    }
    s = static_cast<int>((s + 1) & mask);
  }
}

// A block takes GB_TILE rows a pass, GB_ROWS a thread 256 apart: their
// hashes first (every key load in flight at once), then their walks. A row
// that finds its group's slot holding a larger row lowers it by atomicMin
// (rare after a group's first rows: a hot key costs reads). The pass's
// claims take their group ids with one atomicAdd a block (a scan of the
// threads' claims), so that all-distinct keys do not queue on the counter.
template <int W>
__global__ void __launch_bounds__(GB_THREADS)
gb_insert_kernel(const __grid_constant__ GKeys keys, long long n,
                 const unsigned char* __restrict__ alive,
                 int* __restrict__ table, unsigned mask,
                 int* __restrict__ gid_slot,
                 int* __restrict__ row_slot,
                 unsigned long long* __restrict__ groups) {
  __shared__ int warp_first[GB_THREADS / 32];
  __shared__ long long block_first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long step = static_cast<long long>(gridDim.x) * GB_TILE;
  // block-uniform: every thread takes every pass (the barriers below)
  for (long long tile = static_cast<long long>(blockIdx.x) * GB_TILE;
       tile < n; tile += step) {
    uint32_t h[GB_ROWS];
    unsigned act = 0;
#pragma unroll
    for (int q = 0; q < GB_ROWS; ++q) {
      const long long i = tile + q * GB_THREADS + tid;
      h[q] = 0;
      if (i < n && (alive == nullptr || alive[i] != 0)) {
        act |= 1u << q;
        h[q] = key_hash<W>(keys, i);
      }
    }
    int s[GB_ROWS];
    unsigned claims = 0;
#pragma unroll
    for (int q = 0; q < GB_ROWS; ++q) {
      const long long i = tile + q * GB_THREADS + tid;
      s[q] = -1;
      if (act >> q & 1u) {
        int occ;
        bool claimed = false;
        s[q] = find_slot<W>(keys, i, h[q], table, mask, &occ, &claimed);
        if (claimed) claims |= 1u << q;
        else if (i < occ) atomicMin(table + s[q], static_cast<int>(i));
      }
      if (i < n) row_slot[i] = s[q];
    }
    // the claims' group ids: an exclusive scan over the block's threads
    const int mine = __popc(claims);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_first[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < GB_THREADS / 32; ++w) {
        const int c = warp_first[w];
        warp_first[w] = total;
        total += c;
      }
      block_first = total ? static_cast<long long>(atomicAdd(
                                groups, static_cast<unsigned long long>(total)))
                          : 0;
    }
    __syncthreads();
    if (claims) {
      int g = static_cast<int>(block_first) + warp_first[warp] + incl - mine;
#pragma unroll
      for (int q = 0; q < GB_ROWS; ++q)
        if (claims >> q & 1u) gid_slot[g++] = s[q];
    }
    __syncthreads();                 // warp_first is the next pass's
  }
}

// ---- the capped tier's order of the representatives ------------------------

__global__ void gb_words_kernel(const __grid_constant__ GKeys keys,
                                const unsigned long long* __restrict__ groups,
                                const int* __restrict__ gid_slot,
                                const int* __restrict__ table, int W,
                                long long* __restrict__ words) {
  const long long G = static_cast<long long>(*groups);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < G; g += stride)
    gk_words(keys, table[gid_slot[g]], words + g * W);
}

// group a's words before group b's (-1: past the groups, after every one)
__device__ __forceinline__ bool words_less(const long long* words, int W,
                                           int a, int b) {
  if (a < 0) return false;
  if (b < 0) return true;
  const long long* x = words + static_cast<long long>(a) * W;
  const long long* y = words + static_cast<long long>(b) * W;
  for (int j = 0; j < W; ++j)
    if (x[j] != y[j]) return x[j] < y[j];
  return false;
}

// each chunk of SORT_CHUNK group ids, bitonic-sorted in shared memory
__global__ void __launch_bounds__(SORT_THREADS)
gb_sort_chunks_kernel(const long long* __restrict__ words, int W,
                      const unsigned long long* __restrict__ groups,
                      int* __restrict__ out) {
  __shared__ int ids[SORT_CHUNK];
  const long long G = static_cast<long long>(*groups);
  for (long long c = blockIdx.x; c * SORT_CHUNK < G; c += gridDim.x) {
    const long long base = c * SORT_CHUNK;
    for (int t = threadIdx.x; t < SORT_CHUNK; t += blockDim.x)
      ids[t] = base + t < G ? static_cast<int>(base + t) : -1;
    __syncthreads();
    for (int k = 2; k <= SORT_CHUNK; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < SORT_CHUNK; t += blockDim.x) {
          const int p = t ^ j;
          if (p > t) {
            const int a = ids[t], b = ids[p];
            const bool up = (t & k) == 0;
            if (up ? words_less(words, W, b, a) : words_less(words, W, a, b)) {
              ids[t] = b;
              ids[p] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int t = threadIdx.x; t < SORT_CHUNK && base + t < G;
         t += blockDim.x)
      out[base + t] = ids[t];
    __syncthreads();
  }
}

// the entries of the sorted run [run, run + len) before group `me`
__device__ __forceinline__ long long count_less(const int* run, long long len,
                                                const long long* words, int W,
                                                int me) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (words_less(words, W, run[mid], me)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// one merge pass: runs of `width` sorted ids merged in pairs (the keys are
// distinct, so each entry's place is its index in its run plus the entries
// of the other run before it). A merge path (a thread writing consecutive
// outputs) measured slower at a few thousand groups and barely faster at
// 10M, where random reads of the words bound both.
__global__ void gb_merge_kernel(const long long* __restrict__ words, int W,
                                const unsigned long long* __restrict__ groups,
                                long long width, const int* __restrict__ src,
                                int* __restrict__ dst) {
  const long long G = static_cast<long long>(*groups);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < G; i += stride) {
    const long long L = (i / width & ~1LL) * width, M = L + width;
    const int me = src[i];
    if (M >= G) {
      dst[i] = me;
    } else if (i < M) {
      const long long E = M + width < G ? M + width : G;
      dst[i + count_less(src + M, E - M, words, W, me)] = me;
    } else {
      dst[L + (i - M) + count_less(src + L, width, words, W, me)] = me;
    }
  }
}

// ---- ranks and aggregation -------------------------------------------------

// rank r's slot gets r (or -1 at or past G_out) and output row r the
// group's representative
__global__ void gb_rank_kernel(const int* __restrict__ sorted,
                               const unsigned long long* __restrict__ groups,
                               long long G_out,
                               const int* __restrict__ gid_slot,
                               const int* __restrict__ table,
                               int* __restrict__ slot_rank,
                               long long* __restrict__ first_rows) {
  const long long G = static_cast<long long>(*groups);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < G; r += stride) {
    const int s = gid_slot[sorted[r]];
    if (r < G_out) {
      slot_rank[s] = static_cast<int>(r);
      first_rows[r] = table[s];
    } else {
      slot_rank[s] = -1;
    }
  }
}

__device__ __forceinline__ long long ident_max(int type) {
  switch (type) {
    case T_I8: return 127;
    case T_I16: return 32767;
    case T_I32: case T_F32: return 2147483647LL;
    default: return 0x7FFFFFFFFFFFFFFFLL;
  }
}

__device__ __forceinline__ long long ident_min(int type) {
  return -ident_max(type) - 1;
}

__device__ __forceinline__ long long identity(int op, int type) {
  return op == OP_MIN ? ident_max(type) : op == OP_MAX ? ident_min(type) : 0;
}

__device__ __forceinline__ long long combine(int op, long long a,
                                             long long b) {
  if (op == OP_MIN) return a < b ? a : b;
  if (op == OP_MAX) return a > b ? a : b;
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

// the value of `row` as an int64 word: integers sign-extended, floats as
// their total-order word (`sort._float_total_order`)
__device__ __forceinline__ long long word(const Job& jb, long long row) {
  switch (jb.type) {
    case T_I8: return static_cast<const signed char*>(jb.data)[row];
    case T_I16: return static_cast<const short*>(jb.data)[row];
    case T_I32: return static_cast<const int*>(jb.data)[row];
    case T_I64: return static_cast<const long long*>(jb.data)[row];
    case T_F32: {
      const float x = static_cast<const float*>(jb.data)[row];
      int b = x == 0.0f ? 0 : (x != x ? 0x7FC00000 : __float_as_int(x));
      return b < 0 ? (~b ^ static_cast<int>(0x80000000u)) : b;
    }
    default: {
      const double x = static_cast<const double*>(jb.data)[row];
      long long b = x == 0.0 ? 0LL
                             : (x != x ? 0x7FF8000000000000LL
                                       : __double_as_longlong(x));
      return b < 0 ? (~b ^ static_cast<long long>(0x8000000000000000ull))
                   : b;
    }
  }
}

__device__ __forceinline__ long long contribution(const Job& jb,
                                                  long long row) {
  if (jb.op == OP_SIZE) return 1;
  const bool ok = jb.valid == nullptr || jb.valid[row] != 0;
  if (jb.op == OP_COUNT) return ok ? 1 : 0;
  if (!ok) return identity(jb.op, jb.type);
  return word(jb, row);
}

// one atomic combine into *p (global or shared memory)
__device__ __forceinline__ void atomic_combine(int op, long long* p,
                                               long long v) {
  if (op == OP_MIN) atomicMin(p, v);
  else if (op == OP_MAX) atomicMax(p, v);
  else atomicAdd(reinterpret_cast<unsigned long long*>(p),
                 static_cast<unsigned long long>(v));
}

// *p += v, wrapping, in shared memory as two 32-bit atomics (native, where
// a 64-bit shared add is not, so colliding lanes queue for less): the low
// word's carry goes to the high word with it
__device__ __forceinline__ void shared_add64(long long* p, long long v) {
  unsigned* h = reinterpret_cast<unsigned*>(p);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned hi =
      static_cast<unsigned>(static_cast<unsigned long long>(v) >> 32);
  const unsigned old = atomicAdd(h, lo);
  const unsigned up = hi + (old + lo < old ? 1u : 0u);
  if (up != 0u) atomicAdd(h + 1, up);
}

// DENSE: shared accumulators for ranks [0, dense_cap); GLOBAL: straight to
// the outputs. Each launch returns at once unless min(groups, G_out) falls
// in its route (DENSE: <= dense_cap). DENSE keeps R copies of every
// accumulator, R the largest power of two up to 32 whose copies fit the
// shared memory given (R * geff * jobs words, chosen here from the group
// count): lane l commits to copy l % R, so the few groups of q5's
// aggregates do not queue a warp's lanes on one address; the copies are
// combined at the block's end. row_rank (null: not asked) receives each
// row's rank, G_out for a row that is dead or past the cap.
template <bool DENSE>
__global__ void __launch_bounds__(AGG_THREADS, 2)
gb_agg_kernel(const int* __restrict__ row_slot,
              const int* __restrict__ slot_rank, long long n,
              const unsigned long long* __restrict__ groups, long long G_out,
              long long dense_cap, int* __restrict__ row_rank,
              const __grid_constant__ Jobs jobs) {
  extern __shared__ long long acc[];        // DENSE: [jobs.n][geff][R]
  long long geff = static_cast<long long>(*groups);
  if (geff > G_out) geff = G_out;
  if (DENSE ? geff > dense_cap : geff <= dense_cap) return;
  const int tid = threadIdx.x, lane = tid & 31;
  int R = 1;
  if (DENSE) {
    while (R < 32 && 2LL * R * geff * jobs.n * 8 <= DENSE_BYTES) R *= 2;
    for (int jn = 0; jn < jobs.n; ++jn) {
      const long long id0 = identity(jobs.j[jn].op, jobs.j[jn].type);
      for (long long e = tid; e < geff * R; e += blockDim.x)
        acc[jn * geff * R + e] = id0;
    }
    __syncthreads();
  }
  const int copy = lane & (R - 1);
  const long long step = static_cast<long long>(gridDim.x) * AGG_TILE;
  for (long long tile = static_cast<long long>(blockIdx.x) * AGG_TILE;
       tile < n; tile += step) {
    int rk[GB_ROWS];
    bool uni[GB_ROWS];                       // the warp's rows share a rank
#pragma unroll
    for (int q = 0; q < GB_ROWS; ++q) {
      const long long i = tile + q * AGG_THREADS + tid;
      const int s = i < n ? row_slot[i] : -1;
      rk[q] = s >= 0 ? slot_rank[s] : -1;
    }
#pragma unroll
    for (int q = 0; q < GB_ROWS; ++q)
      uni[q] = __all_sync(0xFFFFFFFFu,
                          rk[q] == __shfl_sync(0xFFFFFFFFu, rk[q], 0));
    if (row_rank != nullptr) {
#pragma unroll
      for (int q = 0; q < GB_ROWS; ++q) {
        const long long i = tile + q * AGG_THREADS + tid;
        if (i < n) row_rank[i] = rk[q] >= 0 ? rk[q]
                                            : static_cast<int>(G_out);
      }
    }
    for (int jn = 0; jn < jobs.n; ++jn) {
      const Job& jb = jobs.j[jn];
      const int op = jb.op;
      const long long id0 = identity(op, jb.type);
      long long w[GB_ROWS];
#pragma unroll
      for (int q = 0; q < GB_ROWS; ++q)
        w[q] = rk[q] >= 0 ? contribution(jb, tile + q * AGG_THREADS + tid)
                          : id0;
      long long* base = DENSE ? acc + jn * geff * R
                              : static_cast<long long*>(jb.out);
      // a warp whose rows share one rank (q5's one-group aggregates) adds
      // them by shuffles and commits once; otherwise each lane commits
#pragma unroll
      for (int q = 0; q < GB_ROWS; ++q) {
        if (uni[q]) {
          long long a = w[q];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            a = combine(op, a, __shfl_xor_sync(0xFFFFFFFFu, a, o));
          if (lane == 0 && rk[q] >= 0)
            atomic_combine(op, base + (DENSE ? rk[q] * R : rk[q]), a);
        } else if (rk[q] >= 0) {
          if (!DENSE)
            atomic_combine(op, base + rk[q], w[q]);
          else if (op == OP_MIN || op == OP_MAX)
            atomic_combine(op, base + rk[q] * R + copy, w[q]);
          else
            shared_add64(base + rk[q] * R + copy, w[q]);
        }
      }
    }
  }
  if (DENSE) {
    __syncthreads();
    for (long long x = tid; x < jobs.n * geff; x += blockDim.x) {
      const Job& jb = jobs.j[x / geff];
      const long long id0 = identity(jb.op, jb.type);
      long long v = id0;
      for (int c = 0; c < R; ++c) v = combine(jb.op, v, acc[x * R + c]);
      if (v != id0)
        atomic_combine(jb.op, static_cast<long long*>(jb.out) + x % geff, v);
    }
  }
}

__global__ void gb_fill_kernel(long long G, long long fill_row,
                               long long* __restrict__ first_rows,
                               const __grid_constant__ Jobs jobs) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < G; k += stride) {
    if (first_rows != nullptr) first_rows[k] = fill_row;
    for (int jn = 0; jn < jobs.n; ++jn) {
      const Job& jb = jobs.j[jn];
      if (jb.op == OP_MIN || jb.op == OP_MAX)
        static_cast<long long*>(jb.out)[k] = identity(jb.op, jb.type);
    }
  }
}

// ---- the float fold -------------------------------------------------------
//
// A left fold from +0.0 of where(valid, float64(v), +0.0) in row order, the
// reference's order, over the rows sorted stably by rank. It is a chain of
// dependent float64 adds that cannot be split without changing bits: its
// bound is the longest group's rows times one add's latency. Groups of at
// most FOLD_SHORT rows take one thread each (32 groups a warp, the chains
// side by side); longer groups a pair of warps each: a producer warp
// gathers, converts and stages 512-row chunks in a double buffer in shared
// memory, and the consumer warp's lane 0 adds them, so that each add waits
// only on the one before it and no load shares the chain's scheduler. Each
// value kind has its own fold, with no branch on the kind inside it. NaN
// bits follow the CPU's: a fold that ends NaN is given the last NaN value's
// bits, quieted, or x86's default NaN (inf - inf) when no value was NaN; a
// float32 NaN widens as x86 widens it.

#define X86_DEFAULT_NAN 0xFFF8000000000000ull
#define F64_QUIET 0x0008000000000000ull

// A raw value as loaded: the narrow integer kinds sign-extended by the load
// itself into 32 bits, float32 as its bits, 64-bit kinds as they are, so
// that no instruction reads the loaded register until it is converted.
template <int TYPE> struct Raw { typedef long long T; };
template <> struct Raw<T_I8> { typedef int T; };
template <> struct Raw<T_I16> { typedef int T; };
template <> struct Raw<T_I32> { typedef int T; };
template <> struct Raw<T_F32> { typedef unsigned T; };

template <int TYPE>
__device__ __forceinline__ typename Raw<TYPE>::T load_raw(const void* data,
                                                          long long row) {
  if (TYPE == T_I8) return static_cast<const signed char*>(data)[row];
  if (TYPE == T_I16) return static_cast<const short*>(data)[row];
  if (TYPE == T_I32) return static_cast<const int*>(data)[row];
  if (TYPE == T_F32) return static_cast<const unsigned*>(data)[row];
  return static_cast<typename Raw<TYPE>::T>(
      static_cast<const long long*>(data)[row]);
}

// float64(v) as the CPU widens it: a float32 NaN keeps its sign and
// payload, quieted
template <int TYPE>
__device__ __forceinline__ double to_f64(typename Raw<TYPE>::T raw) {
  if (TYPE == T_F64) return __longlong_as_double(static_cast<long long>(raw));
  if (TYPE == T_I64) return __ll2double_rn(static_cast<long long>(raw));
  if (TYPE == T_F32) {
    const unsigned b = static_cast<unsigned>(raw);
    const float x = __uint_as_float(b);
    if (x != x) {
      const unsigned long long bits =
          (static_cast<unsigned long long>(b >> 31) << 63) |
          0x7FF0000000000000ull |
          (static_cast<unsigned long long>((b & 0x7FFFFFu) | 0x400000u)
           << 29);
      return __longlong_as_double(static_cast<long long>(bits));
    }
    return static_cast<double>(x);
  }
  return static_cast<double>(static_cast<int>(raw));
}

template <int TYPE>
__device__ __forceinline__ double fold_value(const Job& jb, long long row) {
  if (jb.valid != nullptr && jb.valid[row] == 0) return 0.0;
  return to_f64<TYPE>(load_raw<TYPE>(jb.data, row));
}

// a fold that ended NaN: the CPU's bits (the last NaN value, quieted, or
// the default NaN of inf - inf)
template <int TYPE>
__device__ double nan_bits(const Job& jb, const long long* order,
                           long long lo, long long hi) {
  unsigned long long bits = X86_DEFAULT_NAN;
  for (long long i = lo; i < hi; ++i) {
    const double x = fold_value<TYPE>(jb, order ? order[i] : i);
    if (x != x)
      bits = static_cast<unsigned long long>(__double_as_longlong(x)) |
             F64_QUIET;
  }
  return __longlong_as_double(static_cast<long long>(bits));
}

// group k's rows [lo, hi): starts[k] (-1: no row) to the next group's
// start, or to the kept rows' end
__device__ __forceinline__ bool group_rows(const long long* starts,
                                           long long k, long long G,
                                           long long end, long long* lo,
                                           long long* hi) {
  *lo = starts[k];
  if (*lo < 0) return false;
  const long long nx = k + 1 < G ? starts[k + 1] : -1;
  *hi = nx >= 0 ? nx : end;
  return true;
}

// one thread folds rows [lo, hi) of one job
template <int TYPE>
__device__ double fold_short(const Job& jb, const long long* order,
                             long long lo, long long hi) {
  double acc = 0.0;
  for (long long i = lo; i < hi; i += 4) {
    double x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = i + u < hi ? fold_value<TYPE>(jb, order ? order[i + u] : i + u)
                        : 0.0;
    // + 0.0 past the group leaves the sum as it is: it is never -0.0
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += x[u];
  }
  if (acc != acc) acc = nan_bits<TYPE>(jb, order, lo, hi);
  return acc;
}

__global__ void __launch_bounds__(FOLD_THREADS)
gb_fold_short_kernel(const long long* __restrict__ starts, long long G,
                     long long n, const long long* __restrict__ end_p,
                     const long long* __restrict__ order,
                     long long* __restrict__ long_list,
                     const __grid_constant__ Jobs jobs) {
  const long long end = end_p != nullptr ? *end_p : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < G; k += stride) {
    long long lo, hi;
    if (!group_rows(starts, k, G, end, &lo, &hi)) continue;
    if (hi - lo > FOLD_SHORT) {
      // a warp of the long kernel takes it
      const unsigned long long at =
          atomicAdd(reinterpret_cast<unsigned long long*>(long_list), 1ull);
      long_list[1 + at] = k;
      continue;
    }
    for (int jn = 0; jn < jobs.n; ++jn) {
      const Job& jb = jobs.j[jn];
      double acc;
      switch (jb.type) {
        case T_I8: acc = fold_short<T_I8>(jb, order, lo, hi); break;
        case T_I16: acc = fold_short<T_I16>(jb, order, lo, hi); break;
        case T_I32: acc = fold_short<T_I32>(jb, order, lo, hi); break;
        case T_I64: acc = fold_short<T_I64>(jb, order, lo, hi); break;
        case T_F32: acc = fold_short<T_F32>(jb, order, lo, hi); break;
        default: acc = fold_short<T_F64>(jb, order, lo, hi); break;
      }
      static_cast<double*>(jb.out)[k] = acc;
    }
  }
}

// acc + st[0] + st[1] + ... in order, over min(left, FOLD_CHUNK) values
__device__ __forceinline__ double fold_chunk(double acc, const double* st,
                                             long long left) {
  if (left < FOLD_CHUNK) {
    for (int j = 0; j < static_cast<int>(left); ++j) acc += st[j];
    return acc;
  }
#pragma unroll 32
  for (int j = 0; j < FOLD_CHUNK; ++j) acc += st[j];
  return acc;
}

// The loads of one producer lane for one chunk: its rows, their raw values
// and validity bytes. A position past the group loads the group's last row
// instead (the staging drops it), so every load is unconditional and no
// instruction reads a loaded register before the chunk is staged.
template <int TYPE>
struct Pipe {
  long long ix[FOLD_PER_LANE];
  typename Raw<TYPE>::T raw[FOLD_PER_LANE];
  unsigned char vb[FOLD_PER_LANE];
};

// ix <- the rows of the chunk at `first`
template <int TYPE>
__device__ __forceinline__ void fetch_rows(Pipe<TYPE>& p,
                                           const long long* order,
                                           long long first, long long hi,
                                           int lane) {
#pragma unroll
  for (int q = 0; q < FOLD_PER_LANE; ++q) {
    long long i = first + q * 32 + lane;
    i = i < hi ? i : hi - 1;
    p.ix[q] = order ? order[i] : i;
  }
}

// raw, vb <- the values and validity of the rows in ix
template <int TYPE>
__device__ __forceinline__ void fetch_values(Pipe<TYPE>& p, const Job& jb) {
#pragma unroll
  for (int q = 0; q < FOLD_PER_LANE; ++q) {
    p.raw[q] = load_raw<TYPE>(jb.data, p.ix[q]);
    p.vb[q] = jb.valid != nullptr ? jb.valid[p.ix[q]] : 1;
  }
}

// Named barriers of one (consumer, producer) warp pair: 64 threads each.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// The producer warp of a pair: stages the chunks of rows [lo, hi) of one
// job, converted, into the pair's two buffers in turn, each after the
// consumer has released it (the `empty` barrier) and announced through the
// `full` one. It loads the next chunk's values (their rows a chunk ahead)
// before it stages the current one, so only the staging waits on memory.
template <int TYPE>
__device__ __forceinline__ void fold_produce(const Job& jb,
                                             const long long* order,
                                             long long lo, long long hi,
                                             double (*buf)[FOLD_CHUNK],
                                             int full, int empty, int lane) {
  const long long chunks = (hi - lo + FOLD_CHUNK - 1) / FOLD_CHUNK;
  Pipe<TYPE> p;
  fetch_rows(p, order, lo, hi, lane);
  fetch_values<TYPE>(p, jb);
  fetch_rows(p, order, lo + FOLD_CHUNK, hi, lane);
  for (long long c = 0; c < chunks; ++c) {
    const long long base = lo + c * FOLD_CHUNK;
    const int b = static_cast<int>(c & 1);
    typename Raw<TYPE>::T raw[FOLD_PER_LANE];
    unsigned char vb[FOLD_PER_LANE];
#pragma unroll
    for (int q = 0; q < FOLD_PER_LANE; ++q) {
      raw[q] = p.raw[q];
      vb[q] = p.vb[q];
    }
    fetch_values<TYPE>(p, jb);
    fetch_rows(p, order, base + 2 * FOLD_CHUNK, hi, lane);
    if (c >= 2) pair_sync(empty + b);
#pragma unroll
    for (int q = 0; q < FOLD_PER_LANE; ++q)
      buf[b][q * 32 + lane] = base + q * 32 + lane < hi && vb[q] != 0
                                  ? to_f64<TYPE>(raw[q]) : 0.0;
    pair_arrive(full + b);
  }
}

// The consumer warp of a pair: lane 0 folds each staged chunk in order;
// the warp releases a buffer only when the producer will fill it again.
__device__ __forceinline__ double fold_consume(long long lo, long long hi,
                                               double (*buf)[FOLD_CHUNK],
                                               int full, int empty,
                                               int lane) {
  const long long chunks = (hi - lo + FOLD_CHUNK - 1) / FOLD_CHUNK;
  double acc = 0.0;
  for (long long c = 0; c < chunks; ++c) {
    const int b = static_cast<int>(c & 1);
    pair_sync(full + b);
    if (lane == 0)
      acc = fold_chunk(acc, buf[b], hi - lo - c * FOLD_CHUNK);
    __syncwarp();
    if (c + 2 < chunks) pair_arrive(empty + b);
  }
  return acc;
}

template <int TYPE>
__device__ __forceinline__ void fold_pair(const Job& jb,
                                          const long long* order,
                                          long long lo, long long hi,
                                          double (*buf)[FOLD_CHUNK],
                                          int bar, bool producer, int lane,
                                          double* out) {
  if (producer) {
    fold_produce<TYPE>(jb, order, lo, hi, buf, bar, bar + 2, lane);
  } else {
    double acc = fold_consume(lo, hi, buf, bar, bar + 2, lane);
    if (lane == 0) {
      if (acc != acc) acc = nan_bits<TYPE>(jb, order, lo, hi);
      *out = acc;
    }
  }
  // the next fold starts with both buffers free and every barrier between
  // its phases
  pair_sync(bar + 4);
}

// A long group a warp pair: the producer warp gathers, converts and stages
// 512-row chunks in a double buffer; the consumer warp's lane 0 adds them,
// so that its chain of adds shares its warp scheduler with no load (the
// pair's warps sit on different schedulers, warp w on w % 4).
__global__ void __launch_bounds__(FOLD_THREADS)
gb_fold_long_kernel(const long long* __restrict__ starts, long long G,
                    long long n, const long long* __restrict__ end_p,
                    const long long* __restrict__ order,
                    const long long* __restrict__ long_list,
                    const __grid_constant__ Jobs jobs) {
  __shared__ double stage[FOLD_PAIRS][2][FOLD_CHUNK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp >> 1;
  const bool producer = warp & 1;
  // named barriers: full bar, bar + 1; empty bar + 2, bar + 3; done bar + 4
  const int bar = 1 + 5 * pair;
  const long long end = end_p != nullptr ? *end_p : n;
  const long long count = long_list[0];
  const long long pairs = static_cast<long long>(gridDim.x) * FOLD_PAIRS;
  for (long long w = static_cast<long long>(blockIdx.x) * FOLD_PAIRS + pair;
       w < count; w += pairs) {
    const long long k = long_list[1 + w];
    long long lo, hi;
    group_rows(starts, k, G, end, &lo, &hi);
    for (int jn = 0; jn < jobs.n; ++jn) {
      const Job& jb = jobs.j[jn];
      double* out = static_cast<double*>(jb.out) + k;
      switch (jb.type) {
        case T_I8:
          fold_pair<T_I8>(jb, order, lo, hi, stage[pair], bar, producer,
                          lane, out);
          break;
        case T_I16:
          fold_pair<T_I16>(jb, order, lo, hi, stage[pair], bar, producer,
                           lane, out);
          break;
        case T_I32:
          fold_pair<T_I32>(jb, order, lo, hi, stage[pair], bar, producer,
                           lane, out);
          break;
        case T_I64:
          fold_pair<T_I64>(jb, order, lo, hi, stage[pair], bar, producer,
                           lane, out);
          break;
        case T_F32:
          fold_pair<T_F32>(jb, order, lo, hi, stage[pair], bar, producer,
                           lane, out);
          break;
        default:
          fold_pair<T_F64>(jb, order, lo, hi, stage[pair], bar, producer,
                           lane, out);
          break;
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

static unsigned grid_for(long long items, int per_block, int most) {
  const long long want = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(want < 1 ? 1 : (want < most ? want : most));
}

static int launch_folds(const long long* starts, long long G, long long n,
                        const long long* end_p, const long long* order,
                        long long* long_list, const Jobs& fj,
                        cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(long_list, 0, sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = 16 * sm_count();
  gb_fold_short_kernel<<<grid_for(G, FOLD_THREADS, most), FOLD_THREADS, 0,
                         st>>>(starts, G, n, end_p, order, long_list, fj);
  gb_fold_long_kernel<<<grid_for(G, FOLD_PAIRS, 8 * sm_count()),
                        FOLD_THREADS, 0, st>>>(starts, G, n, end_p, order,
                                               long_list, fj);
  return static_cast<int>(cudaGetLastError());
}

static int make_keys(GKeys* k, const void* const* data,
                     const void* const* valid, const void* const* offsets,
                     const int* width, const int* kind, int nk) {
  if (nk < 1 || nk > GB_MAX_KEYS) return 0;
  k->nk = nk;
  for (int j = 0; j < nk; ++j) {
    if (kind[j] < GK_INT || kind[j] > GK_STRING ||
        (kind[j] == GK_STRING && !offsets[j]) ||
        (kind[j] == GK_INT && width[j] != 1 && width[j] != 2 &&
         width[j] != 4 && width[j] != 8))
      return 0;
    k->data[j] = data[j];
    k->valid[j] = static_cast<const unsigned char*>(valid[j]);
    k->offsets[j] = static_cast<const int*>(offsets[j]);
    k->width[j] = width[j];
    k->kind[j] = kind[j];
  }
  return 1;
}

// The jobs of a call in launches of at most GB_MAX_JOBS, the float ones
// (OP_FSUM) apart; 0 if an argument is not taken.
static int make_jobs(Jobs* ij, int* n_int, Jobs* fj, int* n_flt,
                     const void* const* data, const void* const* valid,
                     void* const* out, const int* ops, const int* types,
                     int n_jobs) {
  int ni = 0, nf = 0;
  ij[0].n = 0;
  fj[0].n = 0;
  for (int q = 0; q < n_jobs; ++q) {
    const bool f = ops[q] == OP_FSUM;
    if (ops[q] < OP_COUNT || ops[q] > OP_FSUM || types[q] < T_I8 ||
        types[q] > T_F64 || !out[q] ||
        (ops[q] != OP_COUNT && ops[q] != OP_SIZE && !data[q]))
      return 0;
    Jobs* set = f ? fj : ij;
    int& k = f ? nf : ni;
    if (set[k].n == GB_MAX_JOBS) {
      if (++k == 8) return 0;
      set[k].n = 0;
    }
    Job& jb = set[k].j[set[k].n++];
    jb.data = data[q];
    jb.valid = static_cast<const unsigned char*>(valid[q]);
    jb.out = out[q];
    jb.op = ops[q];
    jb.type = types[q];
  }
  *n_int = ij[0].n ? ni + 1 : 0;
  *n_flt = fj[0].n ? nf + 1 : 0;
  return 1;
}

extern "C" {

// The insertion. Key columns: data, validity (null: all valid), offsets
// (STRING), width (GK_INT) and kind per column. alive: null, or (n,) bool.
// table: (C,) int32, C a power of two > n; gid_slot (each group's slot),
// row_slot: (n,) int32; groups: one uint64, the group count.
int gb_insert(const void* const* kdata, const void* const* kvalid,
              const void* const* koffsets, const int* kwidth,
              const int* kkind, int nk, long long n,
              const unsigned char* alive, int* table, long long C,
              int* gid_slot, int* row_slot,
              unsigned long long* groups, void* stream) {
  GKeys keys;
  if (n < 1 || C <= n || (C & (C - 1)) != 0 || C > (1LL << 31) || !table ||
      !gid_slot || !row_slot || !groups ||
      !make_keys(&keys, kdata, kvalid, koffsets, kwidth, kkind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(table, 0xFF, C * sizeof(int), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(groups, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = grid_for(n, GB_TILE, 8 * sm_count());
  const unsigned mask = static_cast<unsigned>(C - 1);
  const int one = nk == 1 && kkind[0] == GK_INT ? kwidth[0] : 0;
  if (one == 8)
    gb_insert_kernel<8><<<grid, GB_THREADS, 0, st>>>(
        keys, n, alive, table, mask, gid_slot, row_slot, groups);
  else if (one == 4)
    gb_insert_kernel<4><<<grid, GB_THREADS, 0, st>>>(
        keys, n, alive, table, mask, gid_slot, row_slot, groups);
  else
    gb_insert_kernel<0><<<grid, GB_THREADS, 0, st>>>(
        keys, n, alive, table, mask, gid_slot, row_slot, groups);
  return static_cast<int>(cudaGetLastError());
}

// The capped tier's order of the groups, with no host read: W order words a
// group into words ((bound, W) int64), then the sort of the group ids
// [0, groups) into buf_a or buf_b ((bound,) int32 each; bound >= the group
// count, the launches are sized by it). *which: the buffer that holds the
// order (0: buf_a).
int gb_sort_groups(const void* const* kdata, const void* const* kvalid,
                   const void* const* koffsets, const int* kwidth,
                   const int* kkind, int nk,
                   const unsigned long long* groups, const int* gid_slot,
                   const int* table, long long bound, int W,
                   long long* words, int* buf_a, int* buf_b, int* which,
                   void* stream) {
  GKeys keys;
  if (bound < 1 || W < 1 || !groups || !gid_slot || !table || !words ||
      !buf_a || !buf_b || !which ||
      !make_keys(&keys, kdata, kvalid, koffsets, kwidth, kkind, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < nk; ++j)
    if (kkind[j] == GK_STRING) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int most = 4 * sm_count();
  gb_words_kernel<<<grid_for(bound, 256, most), 256, 0, st>>>(
      keys, groups, gid_slot, table, W, words);
  gb_sort_chunks_kernel<<<grid_for(bound, SORT_CHUNK, 2 * sm_count()),
                          SORT_THREADS, 0, st>>>(words, W, groups, buf_a);
  int* src = buf_a;
  int* dst = buf_b;
  *which = 0;
  for (long long width = SORT_CHUNK; width < bound; width *= 2) {
    gb_merge_kernel<<<grid_for(bound, 256, most), 256, 0, st>>>(
        words, W, groups, width, src, dst);
    int* t = src;
    src = dst;
    dst = t;
    *which ^= 1;
  }
  return static_cast<int>(cudaGetLastError());
}

// The aggregation. row_slot: (n,) int32 from gb_insert; sorted: the group
// ids in key order (the groups' count of them); gid_slot, table: from
// gb_insert; slot_rank: (C,) int32 scratch. G_out: output rows (the group
// count, or the capped tier's key_cap); known: the group count is G_out
// (the eager tier), so one route is launched. first_rows: (G_out,) int64,
// each rank's representative (n - 1 where no group). row_rank: null, or
// (n,) int32, each row's rank (G_out: none). Jobs: data, valid, out, op and
// type per aggregation; outputs are (G_out,) int64 (op < OP_FSUM) or
// float64 (OP_FSUM, zeroed here and folded by gb_fold_rows).
int gb_aggregate(const int* row_slot, long long n,
                 const unsigned long long* groups, long long G_out, int known,
                 const int* sorted, const int* gid_slot, const int* table,
                 int* slot_rank, long long* first_rows, int* row_rank,
                 const void* const* data, const void* const* valid,
                 void* const* out, const int* ops, const int* types,
                 int n_jobs, void* stream) {
  if (n < 1 || G_out < 1 || n_jobs < 0 || !row_slot || !groups || !sorted ||
      !gid_slot || !table || !slot_rank || !first_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs ij[8], fj[8];
  int n_int = 0, n_flt = 0;
  if (!make_jobs(ij, &n_int, fj, &n_flt, data, valid, out, ops, types,
                 n_jobs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool dense_attr = false;
  if (!dense_attr) {
    cudaFuncSetAttribute(gb_agg_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         DENSE_BYTES);
    dense_attr = true;
  }
  // outputs start as their identities: zeros, the extremes for min/max,
  // n - 1 for the first rows
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < n_int && err == cudaSuccess; ++c)
    for (int q = 0; q < ij[c].n && err == cudaSuccess; ++q)
      if (ij[c].j[q].op != OP_MIN && ij[c].j[q].op != OP_MAX)
        err = cudaMemsetAsync(ij[c].j[q].out, 0, G_out * sizeof(long long),
                              st);
  for (int c = 0; c < n_flt && err == cudaSuccess; ++c)
    for (int q = 0; q < fj[c].n && err == cudaSuccess; ++q)
      err = cudaMemsetAsync(fj[c].j[q].out, 0, G_out * sizeof(double), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = 8 * sm_count();
  Jobs none;
  none.n = 0;
  for (int c = 0; c < (n_int ? n_int : 1); ++c)
    gb_fill_kernel<<<grid_for(G_out, 256, most), 256, 0, st>>>(
        G_out, n - 1, c == 0 ? first_rows : nullptr, n_int ? ij[c] : none);
  // the ranks: bounded by the group count, at most n
  gb_rank_kernel<<<grid_for(known ? G_out : n, 256, most), 256, 0, st>>>(
      sorted, groups, G_out, gid_slot, table, slot_rank, first_rows);
  const unsigned tiles = grid_for(n, AGG_TILE, 1 << 30);
  for (int c = 0; c < (n_int ? n_int : 1); ++c) {
    const Jobs& jb = n_int ? ij[c] : none;
    const long long per = jb.n ? DENSE_BYTES / (8LL * jb.n) : (1LL << 40);
    const long long cap = per < G_out ? per : G_out;
    const size_t smem = jb.n ? DENSE_BYTES : 0;
    int* rr = c == 0 ? row_rank : nullptr;
    const bool dense = known && G_out <= cap;
    if (!known || dense) {
      const int blocks = static_cast<int>(2 * sm_count());
      gb_agg_kernel<true><<<tiles < static_cast<unsigned>(blocks) ? tiles
                                                                  : blocks,
                            AGG_THREADS, smem, st>>>(
          row_slot, slot_rank, n, groups, G_out, cap, rr, jb);
    }
    if (!known || !dense)
      gb_agg_kernel<false><<<grid_for(n, AGG_TILE, 4 * sm_count()),
                             AGG_THREADS, 0, st>>>(
          row_slot, slot_rank, n, groups, G_out, cap, rr, jb);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float sums and means: rows [0, *end_p) of `order` (the rows stably
// sorted by rank), rank k's from starts[k] (-1: none) to the next rank's
// start or *end_p; out: (G,) float64, zeroed by gb_aggregate. long_list:
// (G + 1,) int64 scratch.
int gb_fold_rows(const long long* order, const long long* starts, long long G,
                 long long n, const long long* end_p, long long* long_list,
                 const void* const* data, const void* const* valid,
                 void* const* out, const int* types, int n_jobs,
                 void* stream) {
  if (n < 1 || G < 1 || n_jobs < 1 || !order || !starts || !end_p ||
      !long_list)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs ij[8], fj[8];
  int n_int = 0, n_flt = 0;
  int ops[8 * GB_MAX_JOBS];
  if (n_jobs > 8 * GB_MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q < n_jobs; ++q) ops[q] = OP_FSUM;
  if (!make_jobs(ij, &n_int, fj, &n_flt, data, valid, out, ops, types,
                 n_jobs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c = 0; c < n_flt; ++c) {
    const int rc = launch_folds(starts, G, n, end_p, order, long_list, fj[c],
                                st);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

// Per-group float64 sums in row order of contiguous, key-sorted values:
// group k is v[starts[k] .. starts[k + 1]) (the last to n). starts: (g,)
// int64 ascending from 0; out: (g,) float64; long_list: (g + 1,) int64
// scratch.
int gb_segment_sum(const double* v, const long long* starts, long long g,
                   long long n, double* out, long long* long_list,
                   void* stream) {
  if (g < 1 || n < 0 || !v || !starts || !out || !long_list)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs fj;
  fj.n = 1;
  fj.j[0].data = v;
  fj.j[0].valid = nullptr;
  fj.j[0].out = out;
  fj.j[0].op = OP_FSUM;
  fj.j[0].type = T_F64;
  return launch_folds(starts, g, n, nullptr, nullptr, long_list, fj,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
