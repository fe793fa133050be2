// FusedSelect kernels for Hopper (sm_90a): a predicate and the stable
// compaction of the columns a projection needs.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/ops/select_pallas.py:
//   fs_count + fs_compact <- fused_select_compact / _kernel_body
// and computes the same function: the rows where the predicate holds, in
// ascending row order, of every needed column at its width (1, 2, 4 or 8
// bytes; a DECIMAL128 row's 16), with its validity bytes; for STRING
// columns it writes the kept rows' indices, through which ops/select_cuda.py
// gathers them. It equals
// apply_boolean_mask(t.select(needed), predicate.evaluate(t)).
//
// - Predicate. The host flattens the expression tree into a postfix program
//   (load column i, push literal, the binary operators == != < <= > >= & |
//   + - *, ~ and unary -), passed by value in a __grid_constant__ struct, so
//   one build serves every predicate (ops/select.py compile_predicate). The
//   stack is eight registers; the host runs the deeper operand first, so
//   the program's 128 instructions never need more. Every value is held in
//   64 bits: an integer or bool as its value, a float32 or float64 as the
//   float64 bits of its value. Each binary instruction carries the dtype
//   the weak-literal promotion of plan/expr.py gives its operands (bool,
//   int8-int64, float32, float64) and each operand's conversion to it:
//   an integer wraps at a narrower width, an integer or bool becomes a
//   float with round-to-nearest, a float64 rounds to float32. A scalar
//   subquery (ScalarAgg) is reduced by the wrapper before the launch and
//   read as a one-value column (COL_SCALAR) by every row. A `*` of a
//   bool and a float carries a flag and is the select where(b, x, +0.0)
//   (FLAG_SEL_L/R), so False times NaN, inf or -0.0 is +0.0. Integer
//   results wrap at the instruction's width, so INT8 `+` wraps at 8 bits
//   exactly as Expr.evaluate does (the low bits of a sum or product depend
//   only on the operands' low bits). Float arithmetic uses the _rn
//   intrinsics, one rounding per operator, so no multiply and add contract
//   into an FMA, and float32 results round to float32: the same values
//   PyTorch's elementwise kernels give. The predicate reads the data
//   buffers and ignores validity, as Expr.evaluate does.
// - Count (launch 1). A persistent grid, as many blocks as the card holds
//   at once, walks the tiles of FS_TILE = 2,048 rows, each block keeping
//   its next tile's predicate columns on their way to L2 (one bulk
//   prefetch a column). The program is copied into shared memory once a
//   block. A thread evaluates FS_R = 4 consecutive rows per step, two
//   steps a tile, so each program node's dispatch (its opcode, type,
//   flags and literal, the switches over them) is paid once for four
//   rows, each with its own register stack. A load reads the four rows
//   with one vector load (16 bytes for 4- and 8-byte columns, 8 for 2-byte
//   ones, 4 for bytes) where the address is aligned, which the kernel
//   checks; otherwise, and at the end of the column, with scalar loads, so
//   a column view at any element offset is exact. A program whose types
//   are all at most 32 bits, over integer and bool columns of at most 4
//   bytes, runs on 32-bit values (fs_count_kernel<int>; the host decides,
//   ops/select.py Program.narrow), where wraps and compares give the same
//   values as in 64 bits; the rest on 64-bit ones. The warp's 128 rows give
//   four mask words, assembled by shuffles in the ballot layout (bit i of
//   word w is row 32 w + i), and a tile's count goes to counts[tile]; the
//   last block to finish (an atomic ticket, one word of the call's own
//   scratch, zeroed on the launch stream) scans the counts into
//   exclusive tile offsets and the total, so the host reads one value (the
//   one sync, as the reference) and launches nothing before the
//   compaction.
// - Compact (launch 2). Each block compacts one tile: it reads the tile's
//   64 mask words at once, scans their popcounts into per-(step, warp)
//   offsets in shared memory (one warp, one barrier), and gives each kept
//   row its position: the tile offset, plus the rows kept before its step
//   and warp, plus __popc of the lower lanes' bits. Output order is
//   therefore ascending row id. Then per column every step's loads are
//   issued before any store, so a thread's eight rows are in flight
//   together. This replaces the TPU's one-hot matrix products on the MXU
//   and its jnp.repeat epilogue: Hopper has native ballots and popcounts,
//   and scatters a compacted row directly. A launch writes at most
//   FS_MAX_OUT columns; a wider projection takes further launches over the
//   same mask.
//
// What bounds it on this card. The function needs bytes only: the predicate
// columns read once, the kept rows' needed values read and written (on
// kernel_bench's table, 10M rows of INT32 a and b, 4% kept: 89 MB, 27 us at
// 3.35 TB/s). On an H100 80GB HBM3 at 700 W (PERF.md) the count
// kernel is bound by interpreting: each node costs about 8.4 us per 10M
// rows on 32-bit values (15 us on 64-bit ones), its instructions and the
// register moves of the stack, so a 7-node predicate takes 0.088 ms
// against its 0.024 ms of bytes; code generated per predicate would not
// pay that. The compaction costs about what the sectors the kept rows
// touch cost (0.043 ms at 4% kept, 0.019 ms at 0.1%), once its eight steps'
// loads overlap.
//
// Plain C interface for ctypes. Every entry point returns
// cudaGetLastError() after its launch; it never synchronises and
// allocates nothing. Launches share no state: calls on several streams at
// once are independent.

#include <cuda_runtime.h>
#include <stdint.h>

#define FS_THREADS 256
#define FS_R 4                               // rows a thread per node
#define FS_STEPS 2                           // count steps per tile
#define FS_TILE (FS_THREADS * FS_R * FS_STEPS)
#define FS_CSTEPS (FS_TILE / FS_THREADS)     // compact steps of 256 rows
#define FS_WARPS (FS_THREADS / 32)
#define FS_MAX_PRED_COLS 32
#define FS_MAX_PROG 128
#define FS_MAX_STACK 8
#define FS_MAX_OUT 32

// program opcodes (ops/select.py OPCODES)
enum {
  OP_LOAD = 0, OP_LIT, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
  OP_AND, OP_OR, OP_ADD, OP_SUB, OP_MUL, OP_NOT, OP_NEG
};
// value types (ops/select.py TYPES)
enum { TY_BOOL = 0, TY_I8, TY_I16, TY_I32, TY_I64, TY_F32, TY_F64 };
// operand conversions and flags (ops/select.py CV_*, FLAG_SWAP)
enum { CV_NONE = 0, CV_WRAP, CV_TO_FLOAT, CV_TO_F32 };
#define FLAG_SWAP 16
#define FLAG_SEL_L 32   // `*` of a bool and a float: a select on the left
#define FLAG_SEL_R 64   // operand, or on the right one (queue C6)
// column kinds; COL_SCALAR marks a one-value column that every row reads
// (a scalar subquery's result, computed before the launch)
enum { COL_INT = 0, COL_BOOL, COL_FLOAT };
#define COL_SCALAR 4

struct Pred {
  const void* data[FS_MAX_PRED_COLS];
  int width[FS_MAX_PRED_COLS];     // storage bytes: 1, 2, 4 or 8
  int kind[FS_MAX_PRED_COLS];      // COL_*, | COL_SCALAR
  long long lit[FS_MAX_PROG];      // a value, or a float's float64 bits
  short arg[FS_MAX_PROG];          // column of a load
  unsigned char op[FS_MAX_PROG];
  unsigned char ty[FS_MAX_PROG];
  unsigned char flags[FS_MAX_PROG];  // bits 0-1: the left operand's
                                     // CV_*, 2-3: the right's; FLAG_SWAP
  int len;
  int ncols;                       // columns in data/width/kind
  int narrow;                      // 1: 32-bit values suffice
};

// An output column: `width` bytes a row copied from src to dst (16: a
// DECIMAL128 row's four u32 limbs), or, with width 0, the kept rows'
// indices written to dst as int64 (src unused): the wrapper gathers STRING
// columns through them.
struct Out {
  const void* src[FS_MAX_OUT];
  const unsigned char* src_valid[FS_MAX_OUT];   // null: all valid
  void* dst[FS_MAX_OUT];
  unsigned char* dst_valid[FS_MAX_OUT];
  int width[FS_MAX_OUT];
  int ncols;
};

struct Limbs {
  unsigned int w[4];
};

__device__ __forceinline__ double as_f64(long long v) {
  return __longlong_as_double(v);
}

__device__ __forceinline__ long long f64_bits(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ long long f32_bits(float f) {
  return __double_as_longlong(static_cast<double>(f));   // exact
}

#define FOR_R _Pragma("unroll") for (int r = 0; r < FS_R; ++r)

// The program as a block reads it, copied from the parameter struct into
// shared memory once: an instruction a 32-bit word (opcode, type, flags,
// column) and its literal, a column its pointer and width | kind << 8.
struct Prog {
  unsigned int ins[FS_MAX_PROG];
  long long lit[FS_MAX_PROG];
  const void* col[FS_MAX_PRED_COLS];
  int cw[FS_MAX_PRED_COLS];
  int len;
  int ncols;
};

__device__ __forceinline__ void load_program(const Pred& p, Prog& s) {
  for (int k = threadIdx.x; k < p.len; k += blockDim.x) {
    s.ins[k] = p.op[k] | (p.ty[k] << 8) | (p.flags[k] << 16) |
               ((p.arg[k] & 0xff) << 24);
    s.lit[k] = p.lit[k];
  }
  for (int c = threadIdx.x; c < p.ncols; c += blockDim.x) {
    s.col[c] = p.data[c];
    s.cw[c] = p.width[c] | (p.kind[c] << 8);
  }
  if (threadIdx.x == 0) {
    s.len = p.len;
    s.ncols = p.ncols;
  }
}

// The evaluator's value type: long long for every program, int for a
// narrow one (every type at most 32 bits, no float, columns at most 4
// bytes), where 32-bit arithmetic gives the same values: wraps and
// compares at those widths read only the low 32 bits.
template <typename T> struct Unsigned;
template <> struct Unsigned<int> { typedef unsigned int type; };
template <> struct Unsigned<long long> { typedef unsigned long long type; };

template <typename T>
__device__ __forceinline__ void wrap_rows(T* v, int ty) {
  switch (ty) {
    case TY_BOOL: FOR_R v[r] = v[r] != 0; break;
    case TY_I8: FOR_R v[r] = static_cast<signed char>(v[r]); break;
    case TY_I16: FOR_R v[r] = static_cast<short>(v[r]); break;
    case TY_I32: FOR_R v[r] = static_cast<int>(v[r]); break;
    default: break;
  }
}

template <typename T>
__device__ __forceinline__ void convert_rows(T* v, int cv, int ty) {
  if (cv == CV_WRAP) {
    wrap_rows(v, ty);
    return;
  }
  if constexpr (sizeof(T) == 8) {
    if (cv == CV_TO_FLOAT) {
      if (ty == TY_F32) { FOR_R v[r] = f32_bits(__ll2float_rn(v[r])); }
      else { FOR_R v[r] = f64_bits(__ll2double_rn(v[r])); }
    } else if (cv == CV_TO_F32) {
      FOR_R v[r] = f32_bits(__double2float_rn(as_f64(v[r])));
    }
  }
}

// the one value of a COL_SCALAR column c, in every row's register
template <typename T>
__device__ __forceinline__ void load_scalar(const Prog& p, int c, T* v) {
  const void* base = p.col[c];
  const int kind = (p.cw[c] >> 8) & ~COL_SCALAR;
  T x = 0;
  switch (p.cw[c] & 0xff) {
    case 1: {
      const unsigned char b = __ldg(static_cast<const unsigned char*>(base));
      x = kind == COL_BOOL ? static_cast<T>(b != 0)
                           : static_cast<T>(static_cast<signed char>(b));
      break;
    }
    case 2: x = __ldg(static_cast<const short*>(base)); break;
    case 4: {
      const int w = __ldg(static_cast<const int*>(base));
      x = w;
      if constexpr (sizeof(T) == 8) {
        if (kind == COL_FLOAT) x = f32_bits(__int_as_float(w));
      }
      break;
    }
    default:
      if constexpr (sizeof(T) == 8) {
        x = __ldg(static_cast<const long long*>(base));
      }
      break;
  }
  FOR_R v[r] = x;
}

// rows row0 .. row0 + FS_R - 1 of column c, each as the value the program
// computes with (rows past n read as 0 and are never kept)
template <typename T>
__device__ __forceinline__ void load_rows(const Prog& p, int c,
                                          long long row0, long long n,
                                          T* v) {
  const bool full = row0 + FS_R <= n;
  const void* base = p.col[c];
  const int kind = p.cw[c] >> 8;
  if (kind & COL_SCALAR) {
    load_scalar(p, c, v);
    return;
  }
  switch (p.cw[c] & 0xff) {
    case 1: {
      const unsigned char* q = static_cast<const unsigned char*>(base) + row0;
      unsigned int x[FS_R];
      if (full && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
        const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(q));
        FOR_R x[r] = (w >> (8 * r)) & 0xffu;
      } else {
        FOR_R x[r] = row0 + r < n ? __ldg(q + r) : 0u;
      }
      if (kind == COL_BOOL) { FOR_R v[r] = x[r] != 0; }
      else { FOR_R v[r] = static_cast<signed char>(x[r]); }
      break;
    }
    case 2: {
      const short* q = static_cast<const short*>(base) + row0;
      if (full && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
        const unsigned long long w =
            __ldg(reinterpret_cast<const unsigned long long*>(q));
        FOR_R v[r] = static_cast<short>((w >> (16 * r)) & 0xffffu);
      } else {
        FOR_R v[r] = row0 + r < n ? __ldg(q + r) : 0;
      }
      break;
    }
    case 4: {
      const int* q = static_cast<const int*>(base) + row0;
      int x[FS_R];
      if (full && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(q));
        x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
      } else {
        FOR_R x[r] = row0 + r < n ? __ldg(q + r) : 0;
      }
      if constexpr (sizeof(T) == 8) {
        if (kind == COL_FLOAT) {
          FOR_R v[r] = f32_bits(__int_as_float(x[r]));
          break;
        }
      }
      FOR_R v[r] = x[r];
      break;
    }
    default: {
      if constexpr (sizeof(T) == 8) {
        const long long* q = static_cast<const long long*>(base) + row0;
        if (full && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
          const longlong2 lo = __ldg(reinterpret_cast<const longlong2*>(q));
          const longlong2 hi =
              __ldg(reinterpret_cast<const longlong2*>(q) + 1);
          v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
        } else {
          FOR_R v[r] = row0 + r < n ? __ldg(q + r) : 0;
        }
      }
      break;
    }
  }
}

// a binary operator on FS_R rows of operands already converted to ty; the
// result replaces a. Float32 operands hold float32 values, so narrowing
// them is exact; integer results wrap at ty's width.
template <typename T>
__device__ __forceinline__ void binop_rows(int op, int ty, T* a,
                                           const T* b) {
  if constexpr (sizeof(T) == 8) {
    if (ty >= TY_F32) {
      const bool f32 = ty == TY_F32;
      switch (op) {
        case OP_EQ: FOR_R a[r] = as_f64(a[r]) == as_f64(b[r]); break;
        case OP_NE: FOR_R a[r] = as_f64(a[r]) != as_f64(b[r]); break;
        case OP_LT: FOR_R a[r] = as_f64(a[r]) < as_f64(b[r]); break;
        case OP_LE: FOR_R a[r] = as_f64(a[r]) <= as_f64(b[r]); break;
        case OP_GT: FOR_R a[r] = as_f64(a[r]) > as_f64(b[r]); break;
        case OP_GE: FOR_R a[r] = as_f64(a[r]) >= as_f64(b[r]); break;
        case OP_ADD:
          if (f32) {
            FOR_R a[r] = f32_bits(__fadd_rn(static_cast<float>(as_f64(a[r])),
                                            static_cast<float>(as_f64(b[r]))));
          } else {
            FOR_R a[r] = f64_bits(__dadd_rn(as_f64(a[r]), as_f64(b[r])));
          }
          break;
        case OP_SUB:
          if (f32) {
            FOR_R a[r] = f32_bits(__fsub_rn(static_cast<float>(as_f64(a[r])),
                                            static_cast<float>(as_f64(b[r]))));
          } else {
            FOR_R a[r] = f64_bits(__dsub_rn(as_f64(a[r]), as_f64(b[r])));
          }
          break;
        default:
          if (f32) {
            FOR_R a[r] = f32_bits(__fmul_rn(static_cast<float>(as_f64(a[r])),
                                            static_cast<float>(as_f64(b[r]))));
          } else {
            FOR_R a[r] = f64_bits(__dmul_rn(as_f64(a[r]), as_f64(b[r])));
          }
          break;
      }
      return;
    }
  }
  typedef typename Unsigned<T>::type U;
  switch (op) {
    case OP_EQ: FOR_R a[r] = a[r] == b[r]; return;
    case OP_NE: FOR_R a[r] = a[r] != b[r]; return;
    case OP_LT: FOR_R a[r] = a[r] < b[r]; return;
    case OP_LE: FOR_R a[r] = a[r] <= b[r]; return;
    case OP_GT: FOR_R a[r] = a[r] > b[r]; return;
    case OP_GE: FOR_R a[r] = a[r] >= b[r]; return;
    case OP_AND: FOR_R a[r] = a[r] & b[r]; return;
    case OP_OR: FOR_R a[r] = a[r] | b[r]; return;
    case OP_ADD:
      FOR_R a[r] = static_cast<T>(static_cast<U>(a[r]) + static_cast<U>(b[r]));
      break;
    case OP_SUB:
      FOR_R a[r] = static_cast<T>(static_cast<U>(a[r]) - static_cast<U>(b[r]));
      break;
    default:
      FOR_R a[r] = static_cast<T>(static_cast<U>(a[r]) * static_cast<U>(b[r]));
      break;
  }
  wrap_rows(a, ty);
}

// The stack: FS_MAX_STACK slots of FS_R registers each. A slot is read and
// written through a switch on its (warp-uniform) index, so every register
// is addressed at compile time and nothing spills to local memory; the
// switch is paid once per node for FS_R rows.
#define FS_SLOT_GET(I) case I: FOR_R v[r] = st[I][r]; break;
#define FS_SLOT_PUT(I) case I: FOR_R st[I][r] = v[r]; break;
#define FS_SLOTS(M) M(0) M(1) M(2) M(3) M(4) M(5) M(6) M(7)

// FS_R bits: bit r set where row row0 + r < n satisfies the predicate
template <typename T>
__device__ unsigned int eval_rows(const Prog& p, long long row0,
                                  long long n) {
  typedef typename Unsigned<T>::type U;
  T st[FS_MAX_STACK][FS_R];
  int sp = 0;
  for (int k = 0; k < p.len; ++k) {
    const unsigned int ins = p.ins[k];
    const int op = ins & 0xff;
    const int ty = (ins >> 8) & 0xff;
    T v[FS_R];
    if (op == OP_LOAD || op == OP_LIT) {
      if (op == OP_LOAD) {
        load_rows(p, ins >> 24, row0, n, v);
      } else {
        const T lit = static_cast<T>(p.lit[k]);
        FOR_R v[r] = lit;
      }
      switch (sp) { FS_SLOTS(FS_SLOT_PUT) }
      ++sp;
      continue;
    }
    if (op == OP_NOT || op == OP_NEG) {
      switch (sp - 1) { FS_SLOTS(FS_SLOT_GET) }
      bool is_float = false;
      if constexpr (sizeof(T) == 8) is_float = ty >= TY_F32;
      if (op == OP_NOT) {
        if (ty == TY_BOOL) { FOR_R v[r] = v[r] == 0; }
        else { FOR_R v[r] = ~v[r]; }
      } else if (is_float) {
        if constexpr (sizeof(T) == 8) {
          FOR_R v[r] = f64_bits(-as_f64(v[r]));
        }
      } else {
        FOR_R v[r] = static_cast<T>(U(0) - static_cast<U>(v[r]));
        wrap_rows(v, ty);
      }
      switch (sp - 1) { FS_SLOTS(FS_SLOT_PUT) }
      continue;
    }
    // every stack value is exact at its own dtype; each operand converts
    // to the instruction's as the host says
    T lower[FS_R];
    switch (sp - 2) { FS_SLOTS(FS_SLOT_GET) }
    FOR_R lower[r] = v[r];
    switch (sp - 1) { FS_SLOTS(FS_SLOT_GET) }
    const int f = (ins >> 16) & 0xff;
    if (f & FLAG_SWAP) {         // the right operand lies below: exchange
      FOR_R {
        const T t = v[r];
        v[r] = lower[r];
        lower[r] = t;
      }
    }
    convert_rows(lower, f & 3, ty);
    convert_rows(v, (f >> 2) & 3, ty);
    if (f & (FLAG_SEL_L | FLAG_SEL_R)) {
      // a False row gives +0.0 whatever the float is, as Expr.evaluate
      // does; the bool, converted or not, is nonzero exactly when True
      const bool left = (f & FLAG_SEL_L) != 0;
      FOR_R {
        const T c = left ? lower[r] : v[r];
        const T x = left ? v[r] : lower[r];
        lower[r] = c != 0 ? x : T(0);
      }
    } else {
      binop_rows(op, ty, lower, v);
    }
    FOR_R v[r] = lower[r];
    --sp;
    switch (sp - 1) { FS_SLOTS(FS_SLOT_PUT) }
  }
  unsigned int bits = 0;
  FOR_R bits |= (row0 + r < n && st[0][r] != 0) ? (1u << r) : 0u;
  return bits;
}

// Ask L2 for tile t's predicate bytes: the interpreter waits on one load at
// a time, and finds them there. One bulk prefetch (the copy engine's) a
// column, of its 16-byte-aligned part, issued by one thread.
__device__ __forceinline__ void prefetch_tile(const Prog& p, long long t,
                                              long long n) {
  if (threadIdx.x != 0 || t * FS_TILE >= n) return;
  const long long rows = n - t * FS_TILE < FS_TILE ? n - t * FS_TILE
                                                   : FS_TILE;
  for (int c = 0; c < p.ncols; ++c) {
    if ((p.cw[c] >> 8) & COL_SCALAR) continue;    // one value, no rows
    const int width = p.cw[c] & 0xff;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p.col[c]) +
                        static_cast<uintptr_t>(t * FS_TILE * width);
    const uintptr_t lo = (a + 15) & ~static_cast<uintptr_t>(15);
    const long long bytes =
        static_cast<long long>(a + rows * width - lo) & ~15LL;
    if (bytes >= 16)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::
                   "l"(lo), "r"(static_cast<unsigned int>(bytes)) : "memory");
  }
}

// A persistent grid: block b evaluates tiles b, b + G, ..., each while the
// next one's predicate bytes are on their way to L2. T: the evaluator's
// value type.
template <typename T>
__global__ void __launch_bounds__(FS_THREADS)
fs_count_kernel(const __grid_constant__ Pred p, long long n,
                unsigned int* __restrict__ mask, int* __restrict__ counts,
                long long* __restrict__ starts,
                long long* __restrict__ total, unsigned int* ticket) {
  __shared__ Prog prog;
  __shared__ int warp_total[2][FS_WARPS];    // by tile parity
  __shared__ long long warp_sum[FS_WARPS];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (n + FS_TILE - 1) / FS_TILE;
  load_program(p, prog);
  __syncthreads();
  prefetch_tile(prog, blockIdx.x, n);
  int parity = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
    prefetch_tile(prog, t + gridDim.x, n);
    const long long base = t * FS_TILE;
    int kept = 0;
    for (int s = 0; s < FS_STEPS; ++s) {
      // the warp's 128 consecutive rows, FS_R a lane
      const long long wrow = base + s * (FS_THREADS * FS_R) +
                             warp * (32 * FS_R);
      const unsigned int bits = eval_rows<T>(prog, wrow + lane * FS_R, n);
      kept += __popc(bits);
      // mask word j of the warp: lanes 8j .. 8j + 7, FS_R bits each
      unsigned int w = bits << (FS_R * (lane & 7));
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      w |= __shfl_xor_sync(0xffffffffu, w, 2);
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      if ((lane & 7) == 0) mask[wrow / 32 + (lane >> 3)] = w;
    }
    kept = __reduce_add_sync(0xffffffffu, kept);
    if (lane == 0) warp_total[parity][warp] = kept;
    __syncthreads();
    if (threadIdx.x == 0) {
      int c = 0;
      for (int w = 0; w < FS_WARPS; ++w) c += warp_total[parity][w];
      counts[t] = c;
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: exclusive tile offsets and the total
  const int B = static_cast<int>(tiles);
  const int per = (B + FS_THREADS - 1) / FS_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < B ? lo + per : B;
  long long sum = 0;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) sum += __ldcg(counts + i);
  long long incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  long long run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  if (threadIdx.x == FS_THREADS - 1) *total = run + sum;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) {
    starts[i] = run;
    run += __ldcg(counts + i);
  }
}

// the kept rows among a thread's FS_CSTEPS rows (row0 + s * FS_THREADS,
// pos[s] >= 0) from src to dst[pos[s]]: all loads, then all stores
template <typename T>
__device__ __forceinline__ void copy_rows(const void* src, void* dst,
                                          long long row0,
                                          const long long* pos) {
  const T* in = static_cast<const T*>(src);
  T* out = static_cast<T*>(dst);
  T v[FS_CSTEPS];
#pragma unroll
  for (int s = 0; s < FS_CSTEPS; ++s)
    if (pos[s] >= 0) v[s] = in[row0 + s * FS_THREADS];
#pragma unroll
  for (int s = 0; s < FS_CSTEPS; ++s)
    if (pos[s] >= 0) out[pos[s]] = v[s];
}

// Each block compacts one tile: the positions of its kept rows first, then
// per column every step's loads before any store, so that the loads of a
// thread's eight rows are in flight together (a store could alias a later
// load, so the compiler keeps them in program order). WIDE adds the
// widths 0 (the kept rows' indices) and 16 (DECIMAL128); the fixed-width
// kernel is compiled without them, which would cost it registers.
template <bool WIDE>
__device__ __forceinline__ void compact_tile(const Out& o,
                                             const unsigned int* mask,
                                             const long long* starts) {
  __shared__ int off[FS_CSTEPS * FS_WARPS];   // (step, warp) offsets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * FS_TILE;
  // lane s of each warp loads the warp's mask word of step s
  unsigned int mine = 0;
  if (lane < FS_CSTEPS) {
    mine = mask[(base + lane * FS_THREADS) / 32 + warp];
    off[lane * FS_WARPS + warp] = __popc(mine);
  }
  __syncthreads();
  if (warp == 0) {                  // exclusive scan, step-major
    const int a = off[2 * lane], b = off[2 * lane + 1];
    int incl = a + b;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    off[2 * lane] = incl - a - b;
    off[2 * lane + 1] = incl - b;
  }
  __syncthreads();
  const long long start = starts[blockIdx.x];
  const unsigned int below = (1u << lane) - 1u;
  long long pos[FS_CSTEPS];
#pragma unroll
  for (int s = 0; s < FS_CSTEPS; ++s) {
    const unsigned int bits = __shfl_sync(0xffffffffu, mine, s);
    pos[s] = ((bits >> lane) & 1u)
                 ? start + off[s * FS_WARPS + warp] + __popc(bits & below)
                 : -1;
  }
  const long long row0 = base + threadIdx.x;
  for (int c = 0; c < o.ncols; ++c) {
    if (WIDE && o.width[c] == 0) {
      long long* out = static_cast<long long*>(o.dst[c]);
#pragma unroll
      for (int s = 0; s < FS_CSTEPS; ++s)
        if (pos[s] >= 0) out[pos[s]] = row0 + s * FS_THREADS;
      continue;
    }
    if (WIDE && o.width[c] == 16) {
      copy_rows<Limbs>(o.src[c], o.dst[c], row0, pos);
    } else switch (o.width[c]) {
      case 1:
        copy_rows<unsigned char>(o.src[c], o.dst[c], row0, pos);
        break;
      case 2:
        copy_rows<unsigned short>(o.src[c], o.dst[c], row0, pos);
        break;
      case 4:
        copy_rows<unsigned int>(o.src[c], o.dst[c], row0, pos);
        break;
      default:
        copy_rows<unsigned long long>(o.src[c], o.dst[c], row0, pos);
        break;
    }
    if (o.src_valid[c] != nullptr)
      copy_rows<unsigned char>(o.src_valid[c], o.dst_valid[c], row0, pos);
  }
}

__global__ void __launch_bounds__(FS_THREADS)
fs_compact_kernel(const __grid_constant__ Out o, long long n,
                  const unsigned int* __restrict__ mask,
                  const long long* __restrict__ starts) {
  compact_tile<false>(o, mask, starts);
}

__global__ void __launch_bounds__(FS_THREADS)
fs_compact_wide_kernel(const __grid_constant__ Out o, long long n,
                       const unsigned int* __restrict__ mask,
                       const long long* __restrict__ starts) {
  compact_tile<true>(o, mask, starts);
}

// as many blocks as the card holds at once, at most one a tile
template <typename T>
static int launch_count(const Pred* p, long long n, void* mask,
                        void* counts, void* starts, void* total,
                        void* ticket, void* stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fs_count_kernel<T>, FS_THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (n + FS_TILE - 1) / FS_TILE;
  const long long blocks = tiles < resident ? tiles : resident;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fs_count_kernel<T><<<static_cast<unsigned int>(blocks), FS_THREADS, 0, s>>>(
      *p, n, static_cast<unsigned int*>(mask), static_cast<int*>(counts),
      static_cast<long long*>(starts), static_cast<long long*>(total),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// mask: blocks * FS_TILE / 32 words; counts: blocks int32; starts: blocks
// int64 exclusive offsets; total: one int64, the rows kept; ticket: one
// 32-bit word, zeroed here on the launch stream
int fs_count(const Pred* p, long long n, void* mask, void* counts,
             void* starts, void* total, void* ticket, void* stream) {
  if (n <= 0 || p->len <= 0 || p->len > FS_MAX_PROG || p->ncols < 0 ||
      p->ncols > FS_MAX_PRED_COLS || ticket == nullptr)
    return cudaErrorInvalidValue;
  return p->narrow
             ? launch_count<int>(p, n, mask, counts, starts, total, ticket,
                                 stream)
             : launch_count<long long>(p, n, mask, counts, starts, total,
                                       ticket, stream);
}

int fs_compact(const Out* o, long long n, const void* mask,
               const void* starts, void* stream) {
  if (n <= 0 || o->ncols <= 0 || o->ncols > FS_MAX_OUT)
    return cudaErrorInvalidValue;
  const long long blocks = (n + FS_TILE - 1) / FS_TILE;
  bool wide = false;
  for (int c = 0; c < o->ncols; ++c)
    wide = wide || o->width[c] == 0 || o->width[c] == 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int* m = static_cast<const unsigned int*>(mask);
  const long long* st = static_cast<const long long*>(starts);
  if (wide)
    fs_compact_wide_kernel<<<static_cast<unsigned int>(blocks), FS_THREADS,
                             0, s>>>(*o, n, m, st);
  else
    fs_compact_kernel<<<static_cast<unsigned int>(blocks), FS_THREADS, 0,
                        s>>>(*o, n, m, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
