// FusedSelect kernels for Hopper (sm_90a): a predicate and the stable
// compaction of the columns a projection needs.
//
// Replaces the Pallas TPU kernel of spark_rapids_tpu/ops/select_pallas.py:
//   fs_count + fs_compact <- fused_select_compact / _kernel_body
// and computes the same function: the rows where the predicate holds, in
// ascending row order, of every needed column at its width (1, 2, 4 or 8
// bytes), with its validity bytes. It equals
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
//   float with round-to-nearest, a float64 rounds to float32. Integer
//   results wrap at the instruction's width, so INT8 `+` wraps at 8 bits
//   exactly as Expr.evaluate does (the low bits of a sum or product depend
//   only on the operands' low bits). Float arithmetic uses the _rn
//   intrinsics, one rounding per operator, so no multiply and add contract
//   into an FMA, and float32 results round to float32: the same values
//   PyTorch's elementwise kernels give. The predicate reads the data
//   buffers and ignores validity, as Expr.evaluate does.
// - Count (launch 1). Each block owns TILE = 2,048 rows in 8 steps of 256:
//   a thread evaluates one row per step, a warp ballot gives 32 predicate
//   bits, which are written as one mask word, and the block's count goes to
//   counts[block]. The host turns the counts into exclusive block offsets
//   and reads the total: the one host sync, the same the reference pays.
// - Compact (launch 2). Each block reads its tile's 64 mask words at once
//   and publishes their popcounts in shared memory behind one barrier. A
//   row's position is the block offset, plus the rows kept by earlier
//   steps, plus the earlier warps' counts of its step, plus __popc of the
//   lower lanes' bits. Output
//   order is therefore ascending row id. This replaces the TPU's one-hot
//   matrix products on the MXU and its jnp.repeat epilogue: Hopper has
//   native ballots and popcounts, and scatters a compacted row directly.
//   A launch writes at most FS_MAX_OUT columns; a wider projection takes
//   further launches over the same mask.
//
// What bounds it on this card. The function needs bytes only: the predicate
// columns read once, the kept rows' needed values read and written (on
// kernel_bench's table, 10M rows of INT32 a and b, 4% kept: 89 MB, 27 us at
// 3.35 TB/s). Launch 1 is bound by instructions instead: it interprets
// every program node for every row, about 22 us per node per 10M rows on
// an H100 80GB HBM3 at 700 W, so a 7-node predicate takes some 0.16 ms,
// six times its byte time (PERF.md). The register stack and literals
// converted on the host keep each node to a compare-and-branch dispatch
// and one 64-bit operation. Launch 2 reads the kept rows' values in 32-byte
// sectors, scattered where few rows are kept; it costs 0.07-0.08 ms there.
//
// Plain C interface for ctypes. Every entry point returns
// cudaGetLastError() after its launch; it never synchronises and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define FS_THREADS 256
#define FS_STEPS 8
#define FS_TILE (FS_THREADS * FS_STEPS)
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
// column kinds
enum { COL_INT = 0, COL_BOOL, COL_FLOAT };

struct Pred {
  const void* data[FS_MAX_PRED_COLS];
  int width[FS_MAX_PRED_COLS];     // storage bytes: 1, 2, 4 or 8
  int kind[FS_MAX_PRED_COLS];      // COL_*
  long long lit[FS_MAX_PROG];      // a value, or a float's float64 bits
  short arg[FS_MAX_PROG];          // column of a load
  unsigned char op[FS_MAX_PROG];
  unsigned char ty[FS_MAX_PROG];
  unsigned char flags[FS_MAX_PROG];  // bits 0-1: the left operand's
                                     // CV_*, 2-3: the right's; FLAG_SWAP
  int len;
};

struct Out {
  const void* src[FS_MAX_OUT];
  const unsigned char* src_valid[FS_MAX_OUT];   // null: all valid
  void* dst[FS_MAX_OUT];
  unsigned char* dst_valid[FS_MAX_OUT];
  int width[FS_MAX_OUT];
  int ncols;
};

__device__ __forceinline__ long long wrap(long long v, int ty) {
  switch (ty) {
    case TY_BOOL: return v != 0;
    case TY_I8: return static_cast<signed char>(v);
    case TY_I16: return static_cast<short>(v);
    case TY_I32: return static_cast<int>(v);
    default: return v;
  }
}

__device__ __forceinline__ double as_f64(long long v) {
  return __longlong_as_double(v);
}

__device__ __forceinline__ long long f64_bits(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ long long f32_bits(float f) {
  return __double_as_longlong(static_cast<double>(f));   // exact
}

__device__ __forceinline__ long long convert(long long v, int cv, int ty) {
  switch (cv) {
    case CV_WRAP: return wrap(v, ty);
    case CV_TO_FLOAT:
      return ty == TY_F32 ? f32_bits(__ll2float_rn(v))
                          : f64_bits(__ll2double_rn(v));
    case CV_TO_F32: return f32_bits(__double2float_rn(as_f64(v)));
    default: return v;
  }
}

__device__ __forceinline__ long long load_value(const Pred& p, int c,
                                                long long i) {
  switch (p.width[c]) {
    case 1:
      if (p.kind[c] == COL_BOOL)
        return static_cast<const unsigned char*>(p.data[c])[i] != 0;
      return static_cast<const signed char*>(p.data[c])[i];
    case 2: return static_cast<const short*>(p.data[c])[i];
    case 4:
      if (p.kind[c] == COL_FLOAT)
        return f32_bits(static_cast<const float*>(p.data[c])[i]);
      return static_cast<const int*>(p.data[c])[i];
    default: return static_cast<const long long*>(p.data[c])[i];
  }
}

// a binary operator on two float operands already converted to ty; the
// float32 ones hold float32 values, so narrowing them back is exact
__device__ __forceinline__ long long float_op(int op, int ty, long long a,
                                              long long b) {
  const double x = as_f64(a), y = as_f64(b);
  const bool f32 = ty == TY_F32;
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  switch (op) {
    case OP_EQ: return x == y;
    case OP_NE: return x != y;
    case OP_LT: return x < y;
    case OP_LE: return x <= y;
    case OP_GT: return x > y;
    case OP_GE: return x >= y;
    case OP_ADD: return f32 ? f32_bits(__fadd_rn(fx, fy))
                            : f64_bits(__dadd_rn(x, y));
    case OP_SUB: return f32 ? f32_bits(__fsub_rn(fx, fy))
                            : f64_bits(__dsub_rn(x, y));
    default: return f32 ? f32_bits(__fmul_rn(fx, fy))
                        : f64_bits(__dmul_rn(x, y));
  }
}

// The stack lives in eight registers, s0 the top: a push shifts every slot
// down one, a binary operator pops two and pushes one. Register moves are
// cheaper than the local-memory array a dynamically indexed stack would
// need, and FS_MAX_STACK bounds the depth the host may compile.
__device__ bool eval_pred(const Pred& p, long long i) {
  long long s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0, s7 = 0;
  for (int k = 0; k < p.len; ++k) {
    const int op = p.op[k];
    const int ty = p.ty[k];
    if (op == OP_LOAD || op == OP_LIT) {
      const long long v = op == OP_LOAD ? load_value(p, p.arg[k], i)
                                        : p.lit[k];
      s7 = s6; s6 = s5; s5 = s4; s4 = s3; s3 = s2; s2 = s1; s1 = s0; s0 = v;
      continue;
    }
    if (op == OP_NOT) { s0 = ty == TY_BOOL ? (s0 == 0) : ~s0; continue; }
    if (op == OP_NEG) {
      s0 = ty >= TY_F32 ? f64_bits(-as_f64(s0))
                        : wrap(static_cast<long long>(
                              0ull - static_cast<unsigned long long>(s0)),
                              ty);
      continue;
    }
    // every stack value is exact at its own dtype; each operand converts
    // to the instruction's as the host says
    const int f = p.flags[k];
    const bool swap = (f & FLAG_SWAP) != 0;
    const long long a = convert(swap ? s0 : s1, f & 3, ty);
    const long long b = convert(swap ? s1 : s0, (f >> 2) & 3, ty);
    long long r;
    if (ty >= TY_F32) {
      r = float_op(op, ty, a, b);
    } else {
      const unsigned long long ua = static_cast<unsigned long long>(a);
      const unsigned long long ub = static_cast<unsigned long long>(b);
      switch (op) {
        case OP_EQ: r = a == b; break;
        case OP_NE: r = a != b; break;
        case OP_LT: r = a < b; break;
        case OP_LE: r = a <= b; break;
        case OP_GT: r = a > b; break;
        case OP_GE: r = a >= b; break;
        case OP_AND: r = a & b; break;
        case OP_OR: r = a | b; break;
        case OP_ADD: r = wrap(static_cast<long long>(ua + ub), ty); break;
        case OP_SUB: r = wrap(static_cast<long long>(ua - ub), ty); break;
        default: r = wrap(static_cast<long long>(ua * ub), ty); break;
      }
    }
    s0 = r; s1 = s2; s2 = s3; s3 = s4; s4 = s5; s5 = s6; s6 = s7;
  }
  return s0 != 0;
}

__global__ void __launch_bounds__(FS_THREADS)
fs_count_kernel(const __grid_constant__ Pred p, long long n,
                unsigned int* __restrict__ mask, int* __restrict__ counts) {
  __shared__ int warp_total[FS_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * FS_TILE;
  int kept = 0;
  for (int s = 0; s < FS_STEPS; ++s) {
    const long long row = base + s * FS_THREADS + threadIdx.x;
    const bool keep = row < n && eval_pred(p, row);
    const unsigned int bits = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) {
      mask[(base + s * FS_THREADS) / 32 + warp] = bits;
      kept += __popc(bits);
    }
  }
  if (lane == 0) warp_total[warp] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < FS_WARPS; ++w) t += warp_total[w];
    counts[blockIdx.x] = t;
  }
}

__device__ __forceinline__ void copy_value(const void* src, void* dst,
                                           int width, long long from,
                                           long long to) {
  switch (width) {
    case 1: static_cast<unsigned char*>(dst)[to] =
                static_cast<const unsigned char*>(src)[from]; break;
    case 2: static_cast<unsigned short*>(dst)[to] =
                static_cast<const unsigned short*>(src)[from]; break;
    case 4: static_cast<unsigned int*>(dst)[to] =
                static_cast<const unsigned int*>(src)[from]; break;
    default: static_cast<unsigned long long*>(dst)[to] =
                 static_cast<const unsigned long long*>(src)[from]; break;
  }
}

__global__ void __launch_bounds__(FS_THREADS)
fs_compact_kernel(const __grid_constant__ Out o, long long n,
                  const unsigned int* __restrict__ mask,
                  const long long* __restrict__ starts) {
  __shared__ int cnt[FS_STEPS][FS_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * FS_TILE;
  // lane s of each warp loads the warp's mask word of step s: every word
  // of the tile is read at once, and one barrier publishes the counts
  unsigned int mine = 0;
  if (lane < FS_STEPS) {
    mine = mask[(base + lane * FS_THREADS) / 32 + warp];
    cnt[lane][warp] = __popc(mine);
  }
  __syncthreads();
  long long pos0 = starts[blockIdx.x];
  for (int s = 0; s < FS_STEPS; ++s) {
    const unsigned int bits = __shfl_sync(0xffffffffu, mine, s);
    if ((bits >> lane) & 1u) {
      long long pos = pos0 + __popc(bits & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += cnt[s][w];
      const long long row = base + s * FS_THREADS + threadIdx.x;
      for (int c = 0; c < o.ncols; ++c) {
        copy_value(o.src[c], o.dst[c], o.width[c], row, pos);
        if (o.src_valid[c] != nullptr)
          o.dst_valid[c][pos] = o.src_valid[c][row];
      }
    }
    for (int w = 0; w < FS_WARPS; ++w) pos0 += cnt[s][w];
  }
}

extern "C" {

int fs_count(const Pred* p, long long n, void* mask, void* counts,
             void* stream) {
  if (n <= 0 || p->len <= 0 || p->len > FS_MAX_PROG)
    return cudaErrorInvalidValue;
  const long long blocks = (n + FS_TILE - 1) / FS_TILE;
  fs_count_kernel<<<static_cast<unsigned int>(blocks), FS_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      *p, n, static_cast<unsigned int*>(mask), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int fs_compact(const Out* o, long long n, const void* mask,
               const void* starts, void* stream) {
  if (n <= 0 || o->ncols <= 0 || o->ncols > FS_MAX_OUT)
    return cudaErrorInvalidValue;
  const long long blocks = (n + FS_TILE - 1) / FS_TILE;
  fs_compact_kernel<<<static_cast<unsigned int>(blocks), FS_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *o, n, static_cast<const unsigned int*>(mask),
      static_cast<const long long*>(starts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
