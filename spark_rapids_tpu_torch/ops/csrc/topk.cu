// TopK kernels for Hopper (sm_90a): the k smallest row tuples of a stable
// multi-key sort.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/ops/topk_pallas.py:
//   tk_threshold, tk_select_keys <- _topk_words / _topk_kernel_body (and
//                the XLA sort that merges the TPU's per-block candidates)
// and, with ops/topk_cuda.py around it, computes topk_table: the first
// min(k, rows) rows of sort_table(t, keys, ascending), ties included; in
// their capped form (TkDesc.alive set) topk_capped (topk_pallas.py:179),
// the top k live rows.
//
// - Tuples, built in the kernel. The host compiles the keys into a TkDesc
//   passed by value (__grid_constant__): per key its data, width, kind
//   (bool, int, float32, float64, DECIMAL128, STRING), direction, validity
//   and null order, and per tuple word the key it comes from, whether it
//   is the key's null rank and which of the key's value words it is
//   (`part`). A DECIMAL128 key is two words, its top 64 bits signed and
//   its low 64 bits unsigned; a STRING key is nw big-endian 64-bit words
//   of its bytes read through its offsets, zero padded (nw from the
//   column's longest string, ops/topk.py value_words), then its length.
//   The DECIMAL128 and STRING kinds have kernels of their own
//   (tk_*_var_kernel), so that the fixed-width kinds' keep their
//   registers. A row's words are those of ops/topk.py order_words, one
//   per sort operand of ops/sort.py _key_operands, built from the columns
//   when
//   compared: a null rank (NULLS_FIRST ascending, NULLS_LAST descending)
//   before the value of a nullable key; the value zeroed where null;
//   floats through _float_total_order (-0.0 is 0, NaN canonical and
//   greatest, a negative value ~b ^ sign, in the float's own width);
//   descending as bitwise NOT; the sign bit flipped so that unsigned order
//   is signed order; the row index last. Every tuple is unique, so the k
//   smallest tuples in lexicographic order are the stable sort's first k.
//   No word matrix is written: the first launch reads the key columns.
// - Threshold select (tk_threshold: the route for every k and W whose
//   block state fits the card's opt-in shared memory, ops/topk.py). A
//   persistent grid of G blocks (ops/topk.py threshold_grid) strides over
//   tiles of TK_TILE rows, 8 a thread, each block keeping TK_AHEAD tiles of
//   its first two words' columns on their way to L2 (one bulk prefetch a
//   column). A block holds the ids of its best k, in no order, and a
//   threshold tuple no smaller than any of them (all ones until k rows
//   were seen). A row's words are compared with the threshold's, the first
//   differing word deciding, built only as far as needed; the ids of rows
//   strictly below it go to a buffer of TK_BUF ids (ballots, one shared
//   atomic a warp and tile). Before a tile the buffer cannot take, as soon
//   as k rows wait while the threshold is open, and at the end, the block
//   flushes: a radix select over the tuples' bytes of best and buffer,
//   most significant first, one word at a time built for the still
//   undecided elements, skipping the bytes they all share (an OR and an
//   AND), a 256-bin shared histogram for each other byte, keeps the k
//   smallest; the threshold becomes the path of bytes it took, then all
//   ones. The last block to finish (an atomic ticket, one word of the
//   call's own memory, zeroed on the launch stream) walks the other
//   blocks' k-tuple runs the same way, from their words, sorts its k
//   (bitonic, once) and writes their row indices. A small input runs in
//   one block and one launch. On data in no order a block keeps about
//   k ln(rows per block / k) rows; in the worst order (every row below the
//   threshold) it flushes every other tile, each a radix select, not a
//   sort.
// - Tile sort (tk_select_keys, tk_merge: the route for calls whose block
//   state does not fit). Each block of tk_select_keys loads a tile of T
//   rows' tuples into shared memory, built from the keys (rows past the
//   end are all-ones sentinels, which sort last), sorts the tile's slots
//   with a bitonic network and writes its min(k, T) smallest tuples as a
//   sorted run. T is 1,024 rows for up to 24 words, 512 up to 48 and 256
//   up to 96. tk_merge then merges the runs in pairs by binary search,
//   keeping min(2L, k), until one run remains, so any k is taken (the
//   TPU's 128 was its lane width).
//
// - The capped form. The reference ranks an alive word before the keys;
//   a dead row's identity never reaches the output (slots past n_live =
//   min(k, live rows) gather row 0), so here a dead row is no candidate:
//   the threshold walk never builds its words (a thread reads its rows'
//   alive bytes first), the tile sort makes it a sentinel, and the same
//   pass counts the live rows (a block sum; G > 1: one atomic a block).
//   The threshold kernel's last block (the tile route: tk_capped_final
//   after the merges) writes the row indices, 0 from n_live on, and the
//   (k,) alive mask. No alive word, no separate count, no copy.
//
// What bounds it on this card. The function needs bytes only: the key
// columns read once and k rows written (kernel_bench's table: 10M rows, k
// INT64 with nulls DESC and v FLOAT32 ASC, 130 MB, 39 us at 3.35 TB/s).
// On an H100 80GB HBM3 at 700 W (PERF.md) the threshold kernel
// takes 0.17-0.20 ms there at k = 50-100 (the tile route 0.98-1.03), in
// three parts of similar size: the walk's compares, which wait on their
// loads (about 1.4 TB/s); a block's flushes, two to three of some 15 us
// each, every one a chain of barriers; and the last block's merge of G x
// k candidates, which no other block shares. The tile sort is bound by
// its sort, T log2(T)^2 / 4 dependent compare-exchanges per tile.
//
// Plain C interface for ctypes. Entry points return cudaGetLastError()
// after their launch; they never synchronise and allocate nothing. Launches
// share no state: calls on several streams at once are independent.

#include <cuda_runtime.h>
#include <stdint.h>

#define TK_MAX_WORDS 96
#define TK_MAX_KEYS (TK_MAX_WORDS - 1)
#define TK_THREADS 256                  // threshold kernel
#define TK_ROWS 8                       // rows a thread per tile
#define TK_TILE (TK_THREADS * TK_ROWS)  // ops/topk.py TILE_ROWS
#define TK_BUF (2 * TK_TILE)            // ops/topk.py BUFFER
#define TK_PER 8                        // items a thread builds at a flush
#define TK_AHEAD 4                      // tiles a block prefetches ahead
#define TK_MERGE_THREADS 256
#define TK_INF 0xFFFFu

typedef unsigned long long u64;

#define TK_SIGN 0x8000000000000000ull

// key kinds (ops/topk.py KIND_*)
enum { KIND_BOOL = 0, KIND_INT, KIND_F32, KIND_F64, KIND_DEC, KIND_STR };

// A key, or (in a threshold block's copy, one a word) a key's word `part`.
// KIND_DEC: (n, 4) u32 limbs; part 0 is the top 64 bits, signed, part 1
// the low 64 bits, unsigned. KIND_STR: chars through int32 offsets; parts
// 0 .. nw - 1 are big-endian 64-bit words of the bytes, zero padded
// (unsigned), part nw the length.
struct TkKey {
  const void* data;
  const unsigned char* valid;   // null: no validity, no rank word
  const int* offsets;           // KIND_STR
  unsigned char width;          // 1, 2, 4, 8 or 16 bytes (KIND_STR: 1)
  unsigned char kind;           // KIND_*
  unsigned char desc;           // descending: bitwise NOT of the value
  unsigned char nulls_first;    // the null rank's polarity
  unsigned char part;           // the value word this entry builds
  unsigned char nw;             // KIND_STR: chars words
};

struct TkDesc {
  TkKey key[TK_MAX_KEYS];
  unsigned char word_key[TK_MAX_WORDS];   // the key a word comes from
  unsigned char word_rank[TK_MAX_WORDS];  // 1: the key's null rank
  unsigned char word_part[TK_MAX_WORDS];  // the key's value word
  int W;                                  // words, the row index last
  const unsigned char* alive;             // capped: the live rows
};

// _float_total_order on the bits, in the float's width, sign-extended
__device__ __forceinline__ long long f32_order(unsigned int u) {
  if ((u & 0x7fffffffu) == 0) u = 0;                          // -0.0
  else if ((u & 0x7fffffffu) > 0x7f800000u) u = 0x7fc00000u;  // NaN
  const int b = static_cast<int>(u);
  return b < 0 ? (~b ^ INT32_MIN) : b;
}

__device__ __forceinline__ long long f64_order(u64 u) {
  const u64 mag = u & 0x7fffffffffffffffull;
  if (mag == 0) u = 0;
  else if (mag > 0x7ff0000000000000ull) u = 0x7ff8000000000000ull;
  const long long b = static_cast<long long>(u);
  return b < 0 ? (~b ^ INT64_MIN) : b;
}

#define FOR_N _Pragma("unroll") for (int r = 0; r < N; ++r)

// The key c of the items e[i] whose load[i] is 0, N of them a thread: each
// row's validity and its value's order-mapped integer (before direction
// and null zeroing). Every load of the N items is issued before any is
// used. VAR: the key may be DECIMAL128 or STRING; the kernels of the
// fixed-width kinds are compiled without those branches, whose registers
// would slow them.
template <bool VAR, int N>
__device__ __forceinline__ void key_values(const TkKey& c,
                                           const long long* e,
                                           const int* load, bool* valid,
                                           long long* o) {
  if (c.valid != nullptr) {
    FOR_N valid[r] = load[r] != 0 || c.valid[e[r]] != 0;
  } else {
    FOR_N valid[r] = true;
  }
  if (VAR && c.kind == KIND_STR) {
    // unsigned words are flipped to signed order, as value_word flips back
    const unsigned char* q = static_cast<const unsigned char*>(c.data);
    int start[N], len[N];
    FOR_N {
      start[r] = load[r] == 0 ? c.offsets[e[r]] : 0;
      len[r] = load[r] == 0 ? c.offsets[e[r] + 1] - start[r] : 0;
    }
    if (c.part == c.nw) {
      FOR_N o[r] = len[r];
    } else {
      const int at = 8 * c.part;
      FOR_N {
        u64 u = 0;
        for (int b = 0; b < 8; ++b)
          u = (u << 8) | (at + b < len[r] ? q[start[r] + at + b] : 0u);
        o[r] = static_cast<long long>(u ^ TK_SIGN);
      }
    }
  } else if (VAR && c.kind == KIND_DEC) {
    // limbs 3, 2 (signed) or 1, 0 (unsigned, flipped to signed order)
    const unsigned int* q = static_cast<const unsigned int*>(c.data);
    const int hi = c.part == 0 ? 3 : 1;
    const u64 flip = c.part == 0 ? 0ull : TK_SIGN;
    FOR_N o[r] = load[r] == 0
                     ? static_cast<long long>(
                           ((static_cast<u64>(q[4 * e[r] + hi]) << 32) |
                            q[4 * e[r] + hi - 1]) ^ flip)
                     : 0;
  } else if (c.kind == KIND_BOOL) {
    const unsigned char* q = static_cast<const unsigned char*>(c.data);
    FOR_N o[r] = load[r] == 0 && q[e[r]] != 0;
  } else if (c.kind == KIND_F32) {
    const unsigned int* q = static_cast<const unsigned int*>(c.data);
    FOR_N o[r] = f32_order(load[r] == 0 ? q[e[r]] : 0u);
  } else if (c.kind == KIND_F64) {
    const u64* q = static_cast<const u64*>(c.data);
    FOR_N o[r] = f64_order(load[r] == 0 ? q[e[r]] : 0ull);
  } else if (c.width == 1) {
    const signed char* q = static_cast<const signed char*>(c.data);
    FOR_N o[r] = load[r] == 0 ? q[e[r]] : 0;
  } else if (c.width == 2) {
    const short* q = static_cast<const short*>(c.data);
    FOR_N o[r] = load[r] == 0 ? q[e[r]] : 0;
  } else if (c.width == 4) {
    const int* q = static_cast<const int*>(c.data);
    FOR_N o[r] = load[r] == 0 ? q[e[r]] : 0;
  } else {
    const long long* q = static_cast<const long long*>(c.data);
    FOR_N o[r] = load[r] == 0 ? q[e[r]] : 0;
  }
}

// A key's two words from its validity and order-mapped value: the null
// rank (0 or 1 by the polarity) and the value (descending as bitwise NOT,
// zeroed where null), each with the sign bit flipped.
__device__ __forceinline__ u64 rank_word(const TkKey& c, bool valid) {
  return static_cast<u64>(c.nulls_first ? valid : !valid) ^ TK_SIGN;
}

__device__ __forceinline__ u64 value_word(const TkKey& c, bool valid,
                                          long long o) {
  const long long v = c.desc ? ~o : o;
  return valid ? static_cast<u64>(v) ^ TK_SIGN : TK_SIGN;
}

// word w of row `row`'s tuple (the tile sort)
template <bool VAR>
__device__ __forceinline__ u64 tuple_word(const TkDesc& d, int w,
                                          long long row) {
  if (w == d.W - 1) return static_cast<u64>(row);
  const int load = 0;
  bool valid;
  long long o;
  if (VAR) {
    TkKey c = d.key[d.word_key[w]];
    c.part = d.word_part[w];
    key_values<true, 1>(c, &row, &load, &valid, &o);
    return d.word_rank[w] ? rank_word(c, valid) : value_word(c, valid, o);
  }
  const TkKey& c = d.key[d.word_key[w]];
  key_values<false, 1>(c, &row, &load, &valid, &o);
  return d.word_rank[w] ? rank_word(c, valid) : value_word(c, valid, o);
}

// ---- tile sort -------------------------------------------------------------

__device__ __forceinline__ bool tuple_less(const u64* s, int T, int W, int a,
                                           int b) {
  for (int w = 0; w < W; ++w) {
    const u64 x = s[w * T + a], y = s[w * T + b];
    if (x != y) return x < y;
  }
  return false;
}

// the tuples of a tile of T rows, built from the columns, sorted; the k
// smallest written as block b's run of out. ALIVE (the capped form): a
// dead row is a sentinel like a row past the end, and the tile's live rows
// are added to *live.
template <bool VAR, bool ALIVE>
__device__ __forceinline__ void select_tile(const TkDesc& d, long long m,
                                            int W, int T, int k,
                                            u64* __restrict__ out,
                                            long long out_stride,
                                            unsigned long long* live) {
  extern __shared__ u64 smem[];
  u64* s = smem;                                               // W x T
  unsigned short* slot = reinterpret_cast<unsigned short*>(s + W * T);
  const long long base = static_cast<long long>(blockIdx.x) * T;
  if (ALIVE) {
    int own = 0;
    for (int j = threadIdx.x; j < T; j += blockDim.x)
      own += base + j < m && d.alive[base + j] != 0;
    own = __reduce_add_sync(0xffffffffu, own);
    if ((threadIdx.x & 31) == 0 && own > 0)
      atomicAdd(live, static_cast<unsigned long long>(own));
  }
  for (int e = threadIdx.x; e < W * T; e += blockDim.x) {
    const int w = e / T, j = e - w * T;
    const long long row = base + j;
    if (row >= m || (ALIVE && d.alive[row] == 0)) s[e] = ~0ull;
    else s[e] = tuple_word<VAR>(d, w, row);
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

__global__ void tk_select_kernel(const __grid_constant__ TkDesc d,
                                 long long m, int W, int T, int k,
                                 u64* __restrict__ out,
                                 long long out_stride) {
  select_tile<false, false>(d, m, W, T, k, out, out_stride, nullptr);
}

__global__ void tk_select_var_kernel(const __grid_constant__ TkDesc d,
                                     long long m, int W, int T, int k,
                                     u64* __restrict__ out,
                                     long long out_stride) {
  select_tile<true, false>(d, m, W, T, k, out, out_stride, nullptr);
}

__global__ void tk_select_capped_kernel(const __grid_constant__ TkDesc d,
                                        long long m, int W, int T, int k,
                                        u64* __restrict__ out,
                                        long long out_stride,
                                        unsigned long long* live) {
  select_tile<false, true>(d, m, W, T, k, out, out_stride, live);
}

__global__ void tk_select_capped_var_kernel(const __grid_constant__ TkDesc d,
                                            long long m, int W, int T, int k,
                                            u64* __restrict__ out,
                                            long long out_stride,
                                            unsigned long long* live) {
  select_tile<true, true>(d, m, W, T, k, out, out_stride, live);
}

// the capped form's outputs from the final run's row-index word: slot i <
// n_live = min(k, live rows) holds its row and is live, the others row 0
__global__ void tk_capped_final_kernel(const u64* __restrict__ rows, int k,
                                       const unsigned long long* live,
                                       long long* __restrict__ out,
                                       unsigned char* __restrict__ out_alive) {
  const long long n_live = *live < static_cast<unsigned long long>(k)
                               ? static_cast<long long>(*live) : k;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    out[i] = i < n_live ? static_cast<long long>(rows[i]) : 0;
    out_alive[i] = i < n_live;
  }
}

// -1, 0 or 1: tuple i of a against tuple j of b (word-major, strides sa, sb)
__device__ __forceinline__ int tuple_cmp(const u64* a, long long sa,
                                         long long i, const u64* b,
                                         long long sb, long long j, int W) {
  for (int w = 0; w < W; ++w) {
    const u64 x = a[w * sa + i], y = b[w * sb + j];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// runs: in holds R = m / L sorted runs of L tuples; run r and r ^ 1 merge
// into out's run r / 2, of which the first L2 = min(2L, k) are kept
__global__ void tk_merge_kernel(const u64* __restrict__ in, long long m,
                                int W, long long L, long long L2,
                                u64* __restrict__ out, long long out_stride) {
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

// ---- threshold select ------------------------------------------------------

#define FOR_ROWS _Pragma("unroll") for (int r = 0; r < TK_ROWS; ++r)

// The descriptor as a block reads it, copied into shared memory once:
// word w's key entry (w < W - 1) and whether it is that key's null rank.
struct Words {
  TkKey key[TK_MAX_KEYS];
  unsigned char rank[TK_MAX_WORDS];
};

// A block's shared state (ops/topk.py threshold_smem). An element is an
// item id: a row, or in the merge a candidate of the W x (G k) runs; its
// words are built from the keys or read from the runs when needed.
//   ids  S = k + TK_BUF ids: [0, have) the best (in no order; k of them
//        once k rows were seen), then the buffer's
//   cur  S words: one word of every element, as a flush reads it
//   thr  W words: the threshold, a tuple no smaller than any of the best
//   fin  W x k words: the best k's tuples, to write a run and sort them
//   red  2 x (TK_THREADS / 32) words; hist 256 counts; sc the scalars
//   st   S bytes: an element's state in a flush; idx 2k: the final sort
struct Block {
  const Words* D;
  u64* ids;
  u64* cur;
  u64* thr;
  u64* fin;
  u64* red;
  int* hist;
  int* sc;
  unsigned char* st;
  unsigned short* idx;
  int S, k, W;
};

enum { SC_COUNT = 0, SC_LAST, SC_PICKED, SC_BIN, SC_BELOW, SC_INBIN,
       SC_HAVE };

// Word w of the items e[i] whose load[i] is 0, N of them a thread: a row's,
// built from the keys, or a candidate's, read from the W x stride
// candidate runs (written by other blocks: L2). A key's null rank is
// always followed by its value: for a rank word, `next` receives word
// w + 1 from the same loads.
template <bool KEYS, bool VAR, int N>
__device__ __forceinline__ void item_words(const Block& B, const u64* cand,
                                           long long stride, int w,
                                           const long long* e,
                                           const int* load, u64* x,
                                           u64* next = nullptr) {
  if (!KEYS) {
    FOR_N x[r] = load[r] == 0 ? __ldcg(cand + w * stride + e[r]) : 0;
    return;
  }
  if (w == B.W - 1) {
    FOR_N x[r] = static_cast<u64>(e[r]);
    return;
  }
  const TkKey& c = B.D->key[w];
  bool valid[N];
  long long o[N];
  const bool rank = B.D->rank[w];
  if (rank && next == nullptr) {
    FOR_N o[r] = 0;
    if (c.valid != nullptr) {
      FOR_N valid[r] = load[r] != 0 || c.valid[e[r]] != 0;
    } else {
      FOR_N valid[r] = true;
    }
  } else {
    key_values<VAR, N>(c, e, load, valid, o);
  }
  FOR_N {
    const u64 value = value_word(c, valid[r], o[r]);
    if (rank) {
      x[r] = rank_word(c, valid[r]);
      if (next != nullptr) next[r] = value;
    } else {
      x[r] = value;
    }
  }
}
#undef FOR_N

// word w of the elements [0, n) whose state is 0 (all with every_one)
// into `to`, each thread's TK_PER elements loaded together
template <bool KEYS, bool VAR>
__device__ void gather_word(const Block& B, const u64* cand,
                            long long stride, int w, int n, bool every_one,
                            u64* to, int to_stride) {
  for (int base = 0; base < n; base += TK_THREADS * TK_PER) {
    long long e[TK_PER];
    int load[TK_PER];
#pragma unroll
    for (int q = 0; q < TK_PER; ++q) {
      const int i = base + q * TK_THREADS + threadIdx.x;
      load[q] = i < n && (every_one || B.st[i] == 0) ? 0 : 2;
      e[q] = load[q] == 0 ? static_cast<long long>(B.ids[i]) : 0;
    }
    u64 x[TK_PER];
    item_words<KEYS, VAR, TK_PER>(B, cand, stride, w, e, load, x);
#pragma unroll
    for (int q = 0; q < TK_PER; ++q)
      if (load[q] == 0)
        to[(base + q * TK_THREADS + threadIdx.x) * to_stride] = x[q];
  }
}

// the byte of tuple word x a radix pass reads: byte j from the top
__device__ __forceinline__ int digit(u64 x, int j) {
  return static_cast<int>((x >> (56 - 8 * j)) & 0xffu);
}

// OR and AND of cur over the undecided elements [0, n): the bits they all
// share are where AND and OR agree
__device__ void reduce_word(const Block& B, int n, u64* o, u64* a) {
  u64 ro = 0, ra = ~0ull;
  for (int i = threadIdx.x; i < n; i += TK_THREADS) {
    if (B.st[i] == 0) {
      ro |= B.cur[i];
      ra &= B.cur[i];
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    ro |= __shfl_xor_sync(0xffffffffu, ro, d);
    ra &= __shfl_xor_sync(0xffffffffu, ra, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    B.red[warp] = ro;
    B.red[TK_THREADS / 32 + warp] = ra;
  }
  __syncthreads();
  ro = 0;
  ra = ~0ull;
  for (int v = 0; v < TK_THREADS / 32; ++v) {
    ro |= B.red[v];
    ra &= B.red[TK_THREADS / 32 + v];
  }
  __syncthreads();
  *o = ro;
  *a = ra;
}

// Keep the k smallest of the best and the buffer's `count` items, in no
// order, as the best, and set the threshold to a tuple no smaller than
// any of them: a radix select over the tuples' bytes, most significant
// first, one word at a time (built for the undecided elements only),
// skipping the bytes the undecided elements share. Up to k items are all
// kept, and the threshold stays open. Every thread of the block calls it.
template <bool KEYS, bool VAR>
__device__ void flush(const Block& B, const u64* cand, long long stride,
                      int count) {
  const int n = B.sc[SC_HAVE] + count;
  __syncthreads();                   // SC_HAVE read by all
  if (n <= B.k) {
    if (threadIdx.x == 0) B.sc[SC_HAVE] = n;
    __syncthreads();
    return;
  }
  for (int i = threadIdx.x; i < n; i += TK_THREADS) B.st[i] = 0;
  if (threadIdx.x == 0) B.sc[SC_PICKED] = 0;
  __syncthreads();
  // state: 0 undecided, 1 kept, 2 dropped; `need` more to keep
  int need = B.k;
  bool done = false;
  int w = 0;
  for (; w < B.W && !done; ++w) {
    gather_word<KEYS, VAR>(B, cand, stride, w, n, false, B.cur, 1);
    __syncthreads();
    u64 o, a;
    reduce_word(B, n, &o, &a);
    u64 bound = 0;
    for (int j = 0; j < 8; ++j) {
      if (done) {
        bound = (bound << 8) | 0xffu;            // past the deciding byte
        continue;
      }
      if (digit(o ^ a, j) == 0) {                // shared by the undecided
        bound = (bound << 8) | static_cast<u64>(digit(a, j));
        continue;
      }
      B.hist[threadIdx.x] = 0;                   // TK_THREADS == 256 bins
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += TK_THREADS)
        if (B.st[i] == 0) atomicAdd(&B.hist[digit(B.cur[i], j)], 1);
      __syncthreads();
      if (threadIdx.x < 32) {                    // the bin of the need-th
        const int lane = threadIdx.x;
        int own = 0;
        for (int d = 0; d < 8; ++d) own += B.hist[lane * 8 + d];
        int incl = own;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        int cum = incl - own;
        if (cum < need && need <= incl) {
          for (int d = 0; d < 8; ++d) {
            const int h = B.hist[lane * 8 + d];
            if (cum + h >= need) {
              B.sc[SC_BIN] = lane * 8 + d;
              B.sc[SC_BELOW] = cum;
              B.sc[SC_INBIN] = h;
              break;
            }
            cum += h;
          }
        }
      }
      __syncthreads();
      const int bin = B.sc[SC_BIN], below = B.sc[SC_BELOW];
      const bool all = below + B.sc[SC_INBIN] == need;
      for (int i = threadIdx.x; i < n; i += TK_THREADS) {
        if (B.st[i] == 0) {
          const int d = digit(B.cur[i], j);
          B.st[i] = d < bin || (d == bin && all) ? 1 : d > bin ? 2 : 0;
        }
      }
      bound = (bound << 8) | static_cast<u64>(bin);
      need -= below;
      done = all;
      __syncthreads();
    }
    if (threadIdx.x == 0) B.thr[w] = bound;
  }
  // the words after the deciding one: all ones
  if (threadIdx.x == 0)
    for (; w < B.W; ++w) B.thr[w] = ~0ull;
  // the kept, then (only where every byte tied: equal sentinels) as many
  // undecided as still needed, into cur, then back to ids[0, k)
  for (int i = threadIdx.x; i < n; i += TK_THREADS) {
    if (B.st[i] == 1) B.cur[atomicAdd(&B.sc[SC_PICKED], 1)] = B.ids[i];
  }
  __syncthreads();
  if (!done) {
    for (int i = threadIdx.x; i < n; i += TK_THREADS) {
      if (B.st[i] == 0) {
        const int at = atomicAdd(&B.sc[SC_PICKED], 1);
        if (at < B.k) B.cur[at] = B.ids[i];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < B.k; i += TK_THREADS) B.ids[i] = B.cur[i];
  if (threadIdx.x == 0) B.sc[SC_HAVE] = B.k;   // a threshold from rows now
  __syncthreads();
}

// Ask L2 for a tile's bytes of the first two words' keys (or the
// candidates' first two words), so that the walk's loads find them there:
// one bulk prefetch (the copy engine's, no registers or threads held) of
// each range's 16-byte-aligned part, issued by one thread.
__device__ __forceinline__ void prefetch_lines(const void* base,
                                               long long bytes) {
  if (threadIdx.x != 0) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  const uintptr_t lo = (a + 15) & ~static_cast<uintptr_t>(15);
  const long long n = static_cast<long long>(a + bytes - lo) & ~15LL;
  if (n >= 16)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::
                 "l"(lo), "r"(static_cast<unsigned int>(n)) : "memory");
}

template <bool KEYS, bool VAR>
__device__ __forceinline__ void prefetch_tile(const Block& B,
                                              const u64* cand,
                                              long long stride, long long t,
                                              long long n,
                                              const unsigned char* alive) {
  const long long lo = t * TK_TILE;
  if (lo >= n) return;
  const long long rows = n - lo < TK_TILE ? n - lo : TK_TILE;
  if (alive != nullptr) prefetch_lines(alive + lo, rows);
  if (!KEYS) {
    prefetch_lines(cand + lo, rows * 8);
    prefetch_lines(cand + stride + lo, rows * 8);
    return;
  }
  for (int w = 0; w < 2 && w < B.W - 1; ++w) {
    const TkKey& c = B.D->key[w];
    if (w == 1 && B.D->rank[0]) break;         // word 1 is key 0's value
    if (c.valid != nullptr) prefetch_lines(c.valid + lo, rows);
    if (VAR && c.kind == KIND_STR)
      prefetch_lines(c.offsets + lo, (rows + 1) * 4);
    else
      prefetch_lines(static_cast<const char*>(c.data) + lo * c.width,
                     rows * c.width);
  }
}

// Walk items [0, n) in tiles, tiles first, first + step, ..., skipping
// [skip_lo, skip_hi); append the ids of the items below the threshold to
// the buffer and flush it as needed. Every thread of the block calls it.
// ALIVE (the capped form's rows): a dead row is no candidate, and `live`
// counts the thread's live rows.
template <bool KEYS, bool VAR, bool ALIVE = false>
__device__ void walk(const Block& B, const u64* cand, long long stride,
                     long long n, long long first, long long step,
                     long long skip_lo, long long skip_hi,
                     const unsigned char* alive = nullptr,
                     unsigned long long* live = nullptr) {
  const int lane = threadIdx.x & 31;
  const unsigned int below_lane = (1u << lane) - 1u;
  int* count = B.sc + SC_COUNT;
  unsigned long long own = 0;
  // keep TK_AHEAD tiles on their way to L2
  for (int a = 0; a < TK_AHEAD; ++a)
    prefetch_tile<KEYS, VAR>(B, cand, stride, first + a * step, n,
                             ALIVE ? alive : nullptr);
  for (long long t = first; t * TK_TILE < n; t += step) {
    prefetch_tile<KEYS, VAR>(B, cand, stride, t + TK_AHEAD * step, n,
                             ALIVE ? alive : nullptr);
    const int c = *count;
    int have = B.sc[SC_HAVE];
    __syncthreads();                   // read by all before any append
    // before a tile the buffer cannot take, or, while the threshold is
    // still open, as soon as k rows wait
    if (c + TK_TILE > TK_BUF || (have < B.k && have + c >= B.k)) {
      flush<KEYS, VAR>(B, cand, stride, c);
      if (threadIdx.x == 0) *count = 0;
      have = B.sc[SC_HAVE];
      __syncthreads();
    }
    long long e[TK_ROWS];
    int state[TK_ROWS];                // 0 undecided, 1 below, 2 not below
    FOR_ROWS {
      e[r] = t * TK_TILE + r * TK_THREADS + threadIdx.x;
      state[r] = (e[r] < n && (e[r] < skip_lo || e[r] >= skip_hi)) ? 0 : 2;
    }
    if constexpr (ALIVE) {
      unsigned char a[TK_ROWS];
      FOR_ROWS a[r] = state[r] == 0 ? alive[e[r]] : 0;
      FOR_ROWS {
        own += a[r] != 0;
        if (a[r] == 0) state[r] = 2;
      }
    }
    // the first differing word decides; words are built only as far as a
    // row is undecided, for every undecided row of the thread together
    u64 next[TK_ROWS];
    bool have_next = false;
    for (int w = 0; w < B.W; ++w) {
      u64 x[TK_ROWS];
      if (have_next) {
        FOR_ROWS x[r] = next[r];
        have_next = false;
      } else if (KEYS && w < B.W - 1 && B.D->rank[w]) {
        item_words<KEYS, VAR, TK_ROWS>(B, cand, stride, w, e, state, x,
                                       next);
        have_next = true;
      } else {
        item_words<KEYS, VAR, TK_ROWS>(B, cand, stride, w, e, state, x);
      }
      const u64 thr = B.thr[w];
      bool open_row = false;
      FOR_ROWS {
        if (state[r] == 0) {
          if (x[r] != thr) state[r] = x[r] < thr ? 1 : 2;
          else open_row = true;
        }
      }
      if (!open_row) break;
    }
    // append the ids of the rows below the threshold: one shared atomic a
    // warp, the rows placed by their ballots; their words are built when
    // the buffer flushes
    unsigned int bal[TK_ROWS];
    int total = 0;
    FOR_ROWS {
      bal[r] = __ballot_sync(0xffffffffu, state[r] == 1);
      total += __popc(bal[r]);
    }
    if (total > 0) {
      int at = 0;
      if (lane == 0) at = atomicAdd(count, total);
      at = have + __shfl_sync(0xffffffffu, at, 0);
      FOR_ROWS {
        if (state[r] == 1)
          B.ids[at + __popc(bal[r] & below_lane)] = static_cast<u64>(e[r]);
        at += __popc(bal[r]);
      }
    }
    __syncthreads();
  }
  const int c = *count;
  if (c > 0) {
    flush<KEYS, VAR>(B, cand, stride, c);
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();
  }
  if (ALIVE) *live = own;
}

// the block's sum of every thread's x, to every thread (B.red as scratch)
__device__ unsigned long long block_sum(const Block& B,
                                        unsigned long long x) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) B.red[threadIdx.x >> 5] = x;
  __syncthreads();
  unsigned long long s = 0;
  for (int v = 0; v < TK_THREADS / 32; ++v) s += B.red[v];
  __syncthreads();
  return s;
}

// tuple a < tuple b, columns of fin (TK_INF: after every tuple)
__device__ __forceinline__ bool fin_less(const Block& B, int a, int b) {
  if (b == TK_INF) return a != TK_INF;
  if (a == TK_INF) return false;
  for (int w = 0; w < B.W; ++w) {
    const u64 x = B.fin[w * B.k + a], y = B.fin[w * B.k + b];
    if (x != y) return x < y;
  }
  return false;
}

// the best's tuples into fin, W x k, all ones past the ones it holds
template <bool KEYS, bool VAR>
__device__ void build_best(const Block& B, const u64* cand,
                           long long stride) {
  const int have = B.sc[SC_HAVE];
  for (int w = 0; w < B.W; ++w) {
    gather_word<KEYS, VAR>(B, cand, stride, w, have, true, B.fin + w * B.k, 1);
    for (int i = have + threadIdx.x; i < B.k; i += TK_THREADS)
      B.fin[w * B.k + i] = ~0ull;
  }
  __syncthreads();
}

// the best k in order: a bitonic network over their columns of fin,
// compared word by word (once a block, at the end)
__device__ void sort_best(const Block& B) {
  int P = 1;
  while (P < B.k) P <<= 1;
  for (int i = threadIdx.x; i < P; i += TK_THREADS)
    B.idx[i] = i < B.k ? static_cast<unsigned short>(i) : TK_INF;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += TK_THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const int a = B.idx[i], b = B.idx[j];
        if (fin_less(B, b, a) == up) {
          B.idx[i] = b;
          B.idx[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// cand: W x (G k) words, block b's run at [b k, b k + k), and ticket: the
// blocks that have finished, 0 at the launch (both unused for G = 1);
// out: k int64 row indices, the k smallest tuples' in order.
// CAPPED: only the rows d.alive marks are candidates; the live rows are
// counted in the walk (G > 1: summed in the 8-byte word after the
// ticket, 0 at the launch), and slot i < n_live = min(k, live rows) gets
// its row and out_alive 1, the others row 0 and 0.
template <bool VAR, bool CAPPED>
__device__ __forceinline__ void threshold_block(
    const TkDesc& d, long long m, int k, u64* __restrict__ cand,
    unsigned int* ticket, long long* __restrict__ out,
    unsigned char* __restrict__ out_alive) {
  extern __shared__ u64 smem[];
  const int W = d.W;
  Block B;
  B.S = k + TK_BUF;
  B.k = k;
  B.W = W;
  Words* D = reinterpret_cast<Words*>(smem);
  B.D = D;
  B.ids = smem + sizeof(Words) / 8;
  B.cur = B.ids + B.S;
  B.thr = B.cur + B.S;
  B.fin = B.thr + W;
  B.red = B.fin + static_cast<long long>(W) * k;
  B.hist = reinterpret_cast<int*>(B.red + 2 * (TK_THREADS / 32));
  B.sc = B.hist + 256;
  B.st = reinterpret_cast<unsigned char*>(B.sc + 8);
  B.idx = reinterpret_cast<unsigned short*>(B.st + ((B.S + 7) & ~7));
  for (int w = threadIdx.x; w < W - 1; w += TK_THREADS) {
    D->key[w] = d.key[d.word_key[w]];
    D->key[w].part = d.word_part[w];
    D->rank[w] = d.word_rank[w];
  }
  // no best yet: the threshold is open (all ones, above every tuple)
  for (int w = threadIdx.x; w < W; w += TK_THREADS) B.thr[w] = ~0ull;
  if (threadIdx.x == 0) {
    B.sc[SC_COUNT] = 0;
    B.sc[SC_HAVE] = 0;
  }
  __syncthreads();
  const int G = gridDim.x;
  unsigned long long live = 0;
  walk<true, VAR, CAPPED>(B, nullptr, 0, m, blockIdx.x, G, 0, 0, d.alive,
                          &live);
  if (CAPPED) live = block_sum(B, live);
  unsigned long long* live_all =
      reinterpret_cast<unsigned long long*>(ticket + 2);
  build_best<true, VAR>(B, nullptr, 0);
  if (G > 1) {
    const long long stride = static_cast<long long>(G) * k;
    const long long own = static_cast<long long>(blockIdx.x) * k;
    for (int e = threadIdx.x; e < W * k; e += TK_THREADS) {
      const int w = e / k, i = e - w * k;
      cand[w * stride + own + i] = B.fin[e];
    }
    // the best are now the block's run in the candidates
    for (int i = threadIdx.x; i < k; i += TK_THREADS) B.ids[i] = own + i;
    if (threadIdx.x == 0) B.sc[SC_HAVE] = k;
    if (CAPPED && threadIdx.x == 0) atomicAdd(live_all, live);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      B.sc[SC_LAST] =
          atomicAdd(ticket, 1u) == static_cast<unsigned int>(G - 1);
    __syncthreads();
    if (!B.sc[SC_LAST]) return;
    if (CAPPED) live = atomicAdd(live_all, 0ull);
    // the last block: every other run through the same threshold walk
    walk<false, false>(B, cand, stride, stride, 0, 1, own, own + k);
    build_best<false, false>(B, cand, stride);
  }
  sort_best(B);
  if (CAPPED) {
    const long long n_live = live < static_cast<unsigned long long>(k)
                                 ? static_cast<long long>(live) : k;
    for (int i = threadIdx.x; i < k; i += TK_THREADS) {
      out[i] = i < n_live
                   ? static_cast<long long>(B.fin[(W - 1) * k + B.idx[i]])
                   : 0;
      out_alive[i] = i < n_live;
    }
    return;
  }
  for (int i = threadIdx.x; i < k; i += TK_THREADS)
    out[i] = static_cast<long long>(B.fin[(W - 1) * k + B.idx[i]]);
}

__global__ void __launch_bounds__(TK_THREADS)
tk_threshold_kernel(const __grid_constant__ TkDesc d, long long m, int k,
                    u64* __restrict__ cand, unsigned int* ticket,
                    long long* __restrict__ out) {
  threshold_block<false, false>(d, m, k, cand, ticket, out, nullptr);
}

__global__ void __launch_bounds__(TK_THREADS)
tk_threshold_var_kernel(const __grid_constant__ TkDesc d, long long m, int k,
                        u64* __restrict__ cand, unsigned int* ticket,
                        long long* __restrict__ out) {
  threshold_block<true, false>(d, m, k, cand, ticket, out, nullptr);
}

__global__ void __launch_bounds__(TK_THREADS)
tk_threshold_capped_kernel(const __grid_constant__ TkDesc d, long long m,
                           int k, u64* __restrict__ cand,
                           unsigned int* ticket, long long* __restrict__ out,
                           unsigned char* __restrict__ out_alive) {
  threshold_block<false, true>(d, m, k, cand, ticket, out, out_alive);
}

__global__ void __launch_bounds__(TK_THREADS)
tk_threshold_capped_var_kernel(const __grid_constant__ TkDesc d,
                               long long m, int k, u64* __restrict__ cand,
                               unsigned int* ticket,
                               long long* __restrict__ out,
                               unsigned char* __restrict__ out_alive) {
  threshold_block<true, true>(d, m, k, cand, ticket, out, out_alive);
}

static int valid_desc(const TkDesc* d) {
  return d->W >= 1 && d->W <= TK_MAX_WORDS;
}

// whether a word of d comes from a DECIMAL128 or STRING key: the call
// takes the kernels compiled with those kinds
static bool var_desc(const TkDesc* d) {
  for (int w = 0; w < d->W - 1; ++w) {
    const int kind = d->key[d->word_key[w]].kind;
    if (kind == KIND_DEC || kind == KIND_STR) return true;
  }
  return false;
}

extern "C" {

int tk_tile_rows(int W) {
  if (W <= 24) return 1024;
  if (W <= 48) return 512;
  if (W <= TK_MAX_WORDS) return 256;
  return 0;
}

// shared bytes the threshold kernel needs (ops/topk.py threshold_smem)
long long tk_threshold_smem(int k, int W) {
  const long long S = k + TK_BUF;
  return static_cast<long long>(sizeof(Words)) +
         8LL * (2 * S + W + static_cast<long long>(W) * k +
                2 * (TK_THREADS / 32)) +
         4LL * (256 + 8) + ((S + 7) & ~7LL) + 4LL * k;
}

// the current device's SM count and opt-in shared memory per block
int tk_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// cand: W x (G k) words and ticket: one 32-bit word, zeroed here on the
// launch stream (both unused for G = 1); out: k int64 row indices.
// The capped form (d->alive and out_alive both given): ticket is two
// 8-byte words, the ticket and the live rows' count, both zeroed here;
// out_alive: k bytes
int tk_threshold(const TkDesc* d, long long m, int k, int G, void* cand,
                 void* ticket, void* out, void* out_alive, void* stream) {
  const bool capped = d->alive != nullptr;
  if (m <= 0 || k < 1 || k > m || G < 1 || !valid_desc(d) ||
      capped != (out_alive != nullptr) ||
      (G > 1 && (cand == nullptr || ticket == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem = tk_threshold_smem(k, d->W);
  const bool var = var_desc(d);
  cudaError_t err = cudaSuccess;
  if (capped) {
    auto kernel = var ? tk_threshold_capped_var_kernel
                      : tk_threshold_capped_kernel;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && G > 1)
      err = cudaMemsetAsync(ticket, 0, 2 * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<G, TK_THREADS, smem, s>>>(
        *d, m, k, static_cast<u64*>(cand),
        static_cast<unsigned int*>(ticket), static_cast<long long*>(out),
        static_cast<unsigned char*>(out_alive));
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = var ? tk_threshold_var_kernel : tk_threshold_kernel;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && G > 1)
    err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<G, TK_THREADS, smem, s>>>(
      *d, m, k, static_cast<u64*>(cand), static_cast<unsigned int*>(ticket),
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the tile sort's first launch: tuples built from the keys of d, 1 <= k <=
// T; out: W x (blocks * k) with blocks = ceil(m / T), block b's run sorted.
// The capped form (d->alive and live both given): dead rows are sentinels,
// and *live (one 8-byte word, zeroed here on the stream) counts the live
// rows
int tk_select_keys(const TkDesc* d, long long m, int k, void* out,
                   void* live, void* stream) {
  const int W = d->W;
  const int T = tk_tile_rows(W);
  const bool capped = d->alive != nullptr;
  if (!valid_desc(d) || m <= 0 || T == 0 || k < 1 || k > T ||
      capped != (live != nullptr))
    return cudaErrorInvalidValue;
  const long long blocks = (m + T - 1) / T;
  const size_t smem = static_cast<size_t>(W) * T * 8 + T * 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool var = var_desc(d);
  if (capped) {
    auto kernel = var ? tk_select_capped_var_kernel : tk_select_capped_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaMemsetAsync(live, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned int>(blocks), T / 2, smem, s>>>(
        *d, m, W, T, k, static_cast<u64*>(out), blocks * k,
        static_cast<unsigned long long*>(live));
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = var ? tk_select_var_kernel : tk_select_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), T / 2, smem, s>>>(
      *d, m, W, T, k, static_cast<u64*>(out), blocks * k);
  return static_cast<int>(cudaGetLastError());
}

// the tile route's capped outputs: rows, the final run's row-index word
// (k of them); live, tk_select_keys' count; out k int64, out_alive k bytes
int tk_capped_final(const void* rows, int k, const void* live, void* out,
                    void* out_alive, void* stream) {
  if (k < 1 || rows == nullptr || live == nullptr || out == nullptr ||
      out_alive == nullptr)
    return cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (k + threads - 1) / threads;
  tk_capped_final_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(rows), k,
      static_cast<const unsigned long long*>(live),
      static_cast<long long*>(out), static_cast<unsigned char*>(out_alive));
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
      static_cast<const u64*>(in), m, W, L, L2, static_cast<u64*>(out),
      (runs + 1) / 2 * L2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
