// Keyed aggregates over key-sorted rows (the groupby), for Hopper (sm_90a).
//
// The counterpart of the reference's registry op `groupby`
// (spark_rapids_tpu/ops/aggregate.py, `_groupby_kernel`, its scatter-free
// lowering over the sorted runs). The caller sorts the rows by key
// (`order`: sorted position -> row) and numbers the runs (`seg`: the group
// of each sorted position, ascending from 0). This file computes, in one
// pass over the sorted rows, every aggregation of one call, each value read
// through `order` (a gather), bit for bit what the port's plain version
// (ops/aggregate.py on CPU tensors) gives:
//
// - count (valid rows), size (all rows), and integer sums widened to INT64
//   and wrapping like a Java long: exact in any order;
// - min/max over order words: the value itself for integer kinds, the
//   total-order word of `sort._float_total_order` for floats (-0.0 folds
//   into 0.0, every NaN is the canonical one and orders greatest); a slot
//   with no valid row keeps the native kind's identity (INT8 127, not
//   INT64's);
// - float sums (and means, of any kind): the left fold from +0.0 of
//   where(valid, float64(v), +0.0) in row order, the reference's order.
//
// The integer family (gb_reduce_kernel). Bytes bound it: `seg`, `order`, each
// value (a gather) and validity byte cross device memory once. One block a
// tile of GB_TILE sorted rows. Each thread reduces GB_ROWS contiguous rows
// in registers: a run that starts and ends inside them is stored at once.
// The runs open at a thread's edges are joined across the warp by a
// segmented scan on head flags (__shfl_up_sync), then across the block
// through shared memory. A run closed inside the tile that also began there
// is stored with a plain store; a run cut by a tile edge (and the tile's
// last run, cut or not) adds its partial with one 64-bit atomic (atomicAdd on unsigned long long for sums and
// counts, which wraps as the plain version does; atomicMin/atomicMax on
// long long words). So a group over k tiles costs about k atomics, not its
// row count, and the hot keys of a skewed column never serialise the rows.
//
// The float fold (gb_fold_short_kernel, gb_fold_long_kernel). A left fold
// is a chain of dependent float64 adds that cannot be split without
// changing bits: its bound is the longest group's rows times one add's
// latency. Groups of at most FOLD_SHORT rows take one thread each (32 groups
// a warp, the chains side by side); longer groups a pair of warps each: a
// producer warp gathers, converts and stages 512-row chunks in a double
// buffer in shared memory, and the consumer warp's lane 0 adds them, so that
// each add waits only on the one before it and no load shares the chain's
// scheduler. Each value kind has its own fold, with no branch on the kind
// inside it. NaN bits follow the CPU's: a fold that ends NaN is given the
// last NaN value's bits, quieted, or x86's default NaN (inf - inf) when no
// value was NaN; a float32 NaN widens as x86 widens it.
//
// The capped tier. `n_live` (a device scalar, or null for all n rows) counts
// the live rows, which sort first; rows at or past it, and rows of groups at
// or past G (the cap), are not reduced: the kept rows are a prefix of the
// sort. Nothing is read on the host. meta[0] receives the kept rows, meta[1]
// the live groups (the capped tier's overflow test).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue for arguments it does not
// take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>

#define GB_THREADS 256
#define GB_WARPS (GB_THREADS / 32)
#define GB_ROWS 8
#define GB_TILE (GB_THREADS * GB_ROWS)     // sorted rows a block
#define GB_MAX_JOBS 24                     // jobs a launch (kernel parameters)
#define FOLD_SHORT 32                      // rows a thread folds alone
#define FOLD_THREADS 128
#define FOLD_PAIRS (FOLD_THREADS / 64)     // (consumer, producer) warp pairs
#define FOLD_PER_LANE 16
#define FOLD_CHUNK (32 * FOLD_PER_LANE)    // rows a warp stages at a time

enum { OP_COUNT = 0, OP_SIZE = 1, OP_SUM = 2, OP_MIN = 3, OP_MAX = 4,
       OP_FSUM = 5 };
enum { T_I8 = 0, T_I16 = 1, T_I32 = 2, T_I64 = 3, T_F32 = 4, T_F64 = 5 };

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

// ---- the integer family --------------------------------------------------

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

__device__ __forceinline__ void publish(const Job& jb, long long g,
                                        long long v, bool whole) {
  long long* out = static_cast<long long*>(jb.out) + g;
  if (whole) {
    *out = v;
  } else if (jb.op == OP_MIN) {
    atomicMin(out, v);
  } else if (jb.op == OP_MAX) {
    atomicMax(out, v);
  } else {
    atomicAdd(reinterpret_cast<unsigned long long*>(out),
              static_cast<unsigned long long>(v));
  }
}

__global__ void __launch_bounds__(GB_THREADS)
gb_reduce_kernel(const long long* __restrict__ seg,
                 const long long* __restrict__ order, long long n,
                 const long long* __restrict__ n_live, long long G,
                 long long* __restrict__ first_rows,
                 long long* __restrict__ starts, long long* __restrict__ meta,
                 int need_rows, const __grid_constant__ Jobs jobs) {
  __shared__ long long s_val[2][GB_WARPS];
  __shared__ int s_flag[2][GB_WARPS];
  long long live = n;
  if (n_live != nullptr && *n_live < n) live = *n_live;
  const long long tile = static_cast<long long>(blockIdx.x) * GB_TILE;
  if (tile >= live) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i0 = tile + static_cast<long long>(tid) * GB_ROWS;

  // this thread's rows: which are kept, which start a group
  long long s[GB_ROWS], o[GB_ROWS];
  unsigned kept = 0, head = 0;
  long long before = i0 > 0 && i0 - 1 < live ? seg[i0 - 1] : -1;
  const long long prev = before;
#pragma unroll
  for (int r = 0; r < GB_ROWS; ++r) {
    const long long i = i0 + r;
    s[r] = i < live ? seg[i] : G;
    o[r] = 0;
    if (s[r] < G) {
      kept |= 1u << r;
      if (i == 0 || s[r] != before) head |= 1u << r;
      if (need_rows || (head >> r & 1u)) o[r] = order[i];
    }
    before = s[r];
  }
  const long long nxt_i = i0 + GB_ROWS;
  const bool next_kept = nxt_i < live && seg[nxt_i] < G;
  if (first_rows != nullptr) {
#pragma unroll
    for (int r = 0; r < GB_ROWS; ++r) {
      const long long i = i0 + r;
      if (head >> r & 1u) {
        first_rows[s[r]] = o[r];
        if (starts != nullptr) starts[s[r]] = i;
      }
      if (kept >> r & 1u) {
        // the last kept row; the last live row
        const bool last_kept =
            r + 1 < GB_ROWS ? !(kept >> (r + 1) & 1u) : !next_kept;
        if (last_kept) meta[0] = i + 1;
      }
      if (i == live - 1) meta[1] = s[r] + 1;
    }
  }
  // the thread holding the tile's last kept row: it adds the run open at
  // the tile's end
  const int last_r = kept ? 31 - __clz(kept) : -1;
  const bool tail = last_r >= 0 &&
      (last_r < GB_ROWS - 1 || tid == GB_THREADS - 1 || !next_kept);
  const int first_head = head ? __ffs(head) - 1 : -1;

  for (int jn = 0; jn < jobs.n; ++jn) {
    const Job& jb = jobs.j[jn];
    const int op = jb.op;
    const long long id0 = identity(op, jb.type);
    // every row's load issued before the first is used (the stores below
    // may alias the values, as far as the compiler knows)
    long long w[GB_ROWS];
#pragma unroll
    for (int r = 0; r < GB_ROWS; ++r)
      w[r] = kept >> r & 1u ? contribution(jb, o[r]) : id0;
    long long acc = id0, first_part = id0, cur = 0;
    int seen = 0;
#pragma unroll
    for (int r = 0; r < GB_ROWS; ++r) {
      if (head >> r & 1u) {
        if (seen) publish(jb, cur, acc, true);   // a run inside the thread
        else first_part = acc;
        seen = 1;
        acc = id0;
        cur = s[r];
      }
      acc = combine(op, acc, w[r]);
    }
    if (!seen) first_part = acc;
    // inclusive segmented scan over the warp: (flag, value) pairs, a set
    // flag starting a new run
    int f = seen;
    long long v = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int fu = __shfl_up_sync(0xFFFFFFFFu, f, d);
      const long long vu = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= d) {
        if (!f) v = combine(op, vu, v);
        f |= fu;
      }
    }
    const int buf = jn & 1;
    if (lane == 31) {
      s_flag[buf][warp] = f;
      s_val[buf][warp] = v;
    }
    int fe = __shfl_up_sync(0xFFFFFFFFu, f, 1);
    long long ve = __shfl_up_sync(0xFFFFFFFFu, v, 1);
    if (lane == 0) {
      fe = 0;
      ve = id0;
    }
    __syncthreads();
    // the warps before this one
    int fw = 0;
    long long vw = id0;
    for (int k = 0; k < warp; ++k) {
      if (s_flag[buf][k]) {
        fw = 1;
        vw = s_val[buf][k];
      } else {
        vw = combine(op, vw, s_val[buf][k]);
      }
    }
    // E: the run open where this thread starts, from its head (or the
    // tile's start) to the row before this thread's first
    const int ef = fw | fe;
    const long long ev = fe ? ve : combine(op, vw, ve);
    if (seen && !(tid == 0 && first_head == 0)) {
      // the run open at this thread's start closes at its first head
      const long long g = first_head == 0 ? prev : s[first_head - 1];
      publish(jb, g, combine(op, ev, first_part), ef != 0);
    }
    if (tail) {
      // the tile's last run: cut by the tile's edge, or ending at it
      const long long sv = f ? v : combine(op, vw, v);
      publish(jb, s[last_r], sv, false);
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
    first_rows[k] = fill_row;
    for (int jn = 0; jn < jobs.n; ++jn) {
      const Job& jb = jobs.j[jn];
      if (jb.op == OP_MIN || jb.op == OP_MAX)
        static_cast<long long*>(jb.out)[k] = identity(jb.op, jb.type);
    }
  }
}

// ---- the float fold -------------------------------------------------------

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

extern "C" {

// One keyed aggregate. seg, order: (n,) int64, the sorted positions'
// groups (ascending from 0) and rows. n_live: null, or a device int64 of
// the live rows (a prefix of the sort). G: output slots; rows of groups at
// or past it are dropped. first_rows: (G,) int64, each group's first row
// (n - 1 where no kept row). starts: (G,) int64 scratch for the folds
// (null without a float job). meta: (2,) int64, the kept rows and the live
// groups. long_list: (G + 1,) int64 scratch (null without a float job).
// Jobs: data, valid, out, op and type per aggregation; outputs are (G,)
// int64 (op < OP_FSUM) or float64 (OP_FSUM). need_rows: some job reads
// values or validity.
int gb_groupby(const long long* seg, const long long* order, long long n,
               const long long* n_live, long long G, long long* first_rows,
               long long* starts, long long* meta, long long* long_list,
               const void* const* data, const void* const* valid,
               void* const* out, const int* ops, const int* types,
               int n_jobs, int need_rows, void* stream) {
  if (n < 1 || G < 1 || n_jobs < 0 || !seg || !order || !first_rows ||
      !meta)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Jobs ij[8], fj[8];
  int ni = 0, nf = 0;
  ij[0].n = 0;
  fj[0].n = 0;
  for (int q = 0; q < n_jobs; ++q) {
    const bool f = ops[q] == OP_FSUM;
    if (ops[q] < OP_COUNT || ops[q] > OP_FSUM || types[q] < T_I8 ||
        types[q] > T_F64 || !out[q] ||
        (ops[q] != OP_COUNT && ops[q] != OP_SIZE && !data[q]))
      return static_cast<int>(cudaErrorInvalidValue);
    Jobs* set = f ? fj : ij;
    int& k = f ? nf : ni;
    if (set[k].n == GB_MAX_JOBS) {
      if (++k == 8) return static_cast<int>(cudaErrorInvalidValue);
      set[k].n = 0;
    }
    Job& jb = set[k].j[set[k].n++];
    jb.data = data[q];
    jb.valid = static_cast<const unsigned char*>(valid[q]);
    jb.out = out[q];
    jb.op = ops[q];
    jb.type = types[q];
  }
  const int n_int = ij[0].n ? ni + 1 : 0;
  const int n_flt = fj[0].n ? nf + 1 : 0;
  if (n_flt && (!starts || !long_list))
    return static_cast<int>(cudaErrorInvalidValue);
  // outputs start as their identities: zeros, the extremes for min/max,
  // n - 1 for the first rows, -1 (no row) for the starts
  cudaError_t err = cudaMemsetAsync(meta, 0, 2 * sizeof(long long), st);
  for (int c = 0; c < n_int && err == cudaSuccess; ++c)
    for (int q = 0; q < ij[c].n && err == cudaSuccess; ++q)
      if (ij[c].j[q].op != OP_MIN && ij[c].j[q].op != OP_MAX)
        err = cudaMemsetAsync(ij[c].j[q].out, 0, G * sizeof(long long), st);
  for (int c = 0; c < n_flt && err == cudaSuccess; ++c)
    for (int q = 0; q < fj[c].n && err == cudaSuccess; ++q)
      err = cudaMemsetAsync(fj[c].j[q].out, 0, G * sizeof(double), st);
  if (err == cudaSuccess && n_flt)
    err = cudaMemsetAsync(starts, 0xFF, G * sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = 8 * sm_count();
  Jobs none;
  none.n = 0;
  for (int c = 0; c < (n_int ? n_int : 1); ++c)
    gb_fill_kernel<<<grid_for(G, 256, most), 256, 0, st>>>(
        G, n - 1, first_rows, n_int ? ij[c] : none);
  // the first launch also writes the heads and the meta
  const unsigned tiles = static_cast<unsigned>((n + GB_TILE - 1) / GB_TILE);
  for (int c = 0; c < (n_int ? n_int : 1); ++c)
    gb_reduce_kernel<<<tiles, GB_THREADS, 0, st>>>(
        seg, order, n, n_live, G, c == 0 ? first_rows : nullptr,
        n_flt ? starts : nullptr, meta, need_rows, n_int ? ij[c] : none);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c = 0; c < n_flt; ++c) {
    const int rc = launch_folds(starts, G, n, meta, order, long_list, fj[c],
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
