// JCUDF row conversion for Hopper (sm_90a): a table of fixed-width columns
// to its row-major image (`to_rows`) and back (`from_rows`).
//
// Replaces the row-image assembly of spark_rapids_tpu/ops/row_conversion.py
// (`_to_rows_kernel` :165 / `_to_rows_concat_kernel` :225 and
// `_from_rows_kernel` :351 / `_from_rows_slice_kernel` :317, XLA ops under
// jax.jit there, not Pallas) and computes what they compute. The layout
// (row_conversion.py `row_layout`, RowConversion.java:44-117): each column
// at an offset aligned to min(width, 8), in order; validity bytes right
// after the last column (bit i % 8 of byte i // 8 set when column i is
// valid; a column without validity writes 1); zero padding to a multiple of
// 8 bytes. Every column's bytes are copied whatever its validity.
//
// Design: each block takes a tile of up to 32 consecutive rows at a time
// (grid-stride over tiles), so a tile's image is one contiguous span and
// a column's values for the tile are one short span.
// - `to_rows` stages the tile in shared memory: a warp per column, a lane
//   per row, copies the column's values in with coalesced loads, and a
//   warp per validity byte packs up to 8 columns' validity bits (1 where a
//   column has none). Then one thread per (row, 4-byte word of the tile's
//   image), a warp on 32 consecutive words of one row, assembles the words
//   and stores them: the stores are coalesced. A per-schema word plan,
//   built by the wrapper (row_conversion_cuda.py `word_plan`) and read
//   from global memory, gives each word's four bytes as shared-memory
//   addresses for the tile's row 0 and a row stride: a whole 4-byte word
//   of one column (every column of 4 bytes or more starts 4-aligned, so
//   its bytes always form whole words), or four single bytes (of a 1- or
//   2-byte column, a packed validity byte, or a staged row of zeros for
//   the padding), so the assembly does not branch on a byte's kind. The
//   wrapper sizes the tile to the shared memory the schema needs (32 rows
//   up to 7 KB a row; a row over 227 KB is not taken).
// - `from_rows`: one thread per (column, row of the tile), a warp on 32
//   rows of one column: each thread reads its value at the column's offset
//   in its row of the tile (through L1, where the tile's image stays for
//   the block's warps) and its validity bit, and the warp's stores to the
//   column and to its validity are coalesced.
// (PERF.md section 6 has the designs measured slower than these.)
//
// What bounds it on this card: the bytes. Per row, `to_rows` reads the sum
// of the column widths plus one byte for each column that has a validity,
// and writes row_size bytes; `from_rows` reads row_size and writes the
// widths plus one validity byte per column. At the reference bench's
// general shape (216 columns of the 9-kind cycle, no nulls, 1,048,576
// rows: benchmarks/bench_row_conversion.py:17-36) the widths sum to 744
// bytes, alignment pads the columns to 1,152, the 27 validity bytes end at
// 1,179 and the row pads to 1,184: each direction moves 744 + 1,184 =
// 1,928 bytes a row, 2.02 GB, 0.60 ms at 3.35 TB/s. The least instructions
// are a load and a store per image word (296 words a row, 0.62 G, 0.04 ms
// at 16.7 T/s): the bytes bound it. The design moves each byte once to and
// from memory; what keeps it from the bound is latency: a staging thread
// moves a value of 1-16 bytes at a time and each tile waits at two
// barriers (ROADMAP.md queue B 13).
//
// Plain C interface for ctypes. Each entry point returns
// cudaGetLastError() after its launch (or cudaErrorInvalidValue for
// arguments it does not take); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define TILE_ROWS 32           // rows a block takes at a time, at most
#define MAX_STAGE 232448       // shared memory a block can have (227 KB)
#define MAX_GROUPS 16          // from_rows' output buffers, at most

// A byte source of to_rows' plan (int32) is (sh << 24) | a: the byte of
// row r of the staged tile at a + (r << sh). A column 2^sh bytes wide has
// its values there; a packed validity byte and the zero of the padding
// have sh = 0. On a word's first source, WHOLE marks the whole 4-byte word
// at a + (r << sh).
#define SRC_WHOLE (1 << 29)
#define SRC_ADDR 0x3FFFF

// The schema: `meta` (device memory) holds the plan's row_words int4 byte
// sources, then per column its width, its byte offset in the row, 1 for
// BOOL, its staging offset in shared memory, and its output buffer and
// slot there (from_rows) (ncols int32 each).
struct Plan {
  const int4* words;                  // (row_words,) byte sources
  const int* width;                   // (ncols,) value bytes
  const int* offset;                  // (ncols,) byte offset in a row
  const int* is_bool;                 // (ncols,) 1 for BOOL columns
  const int* stage;                   // (ncols,) to_rows: staging offset
  const int* group;                   // (ncols,) from_rows: output buffer
  const int* slot;                    // (ncols,) from_rows: its slot there
  int ncols;
  int row_words;
  int validity_offset;                // first validity byte of a row
};

__device__ __forceinline__ long long tile_rows(long long tile, int tr,
                                               long long n, long long& r0) {
  r0 = tile * tr;
  return n - r0 < tr ? n - r0 : tr;
}

__device__ __forceinline__ int src_at(int s, int r) {
  return (s & SRC_ADDR) + (r << ((s >> 24) & 7));
}

// Copy `w` bytes (1, 2, 4, 8 or 16, aligned to min(w, 8)) from src to dst.
__device__ __forceinline__ void copy_value(unsigned char* dst,
                                           const unsigned char* src, int w) {
  switch (w) {
    case 1: dst[0] = src[0]; break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
      break;
    case 8:
      *reinterpret_cast<uint64_t*>(dst) =
          *reinterpret_cast<const uint64_t*>(src);
      break;
    default:  // 16: DECIMAL128
      reinterpret_cast<uint64_t*>(dst)[0] =
          reinterpret_cast<const uint64_t*>(src)[0];
      reinterpret_cast<uint64_t*>(dst)[1] =
          reinterpret_cast<const uint64_t*>(src)[1];
  }
}

// The staged tile (shared memory, the wrapper's `stage_layout`): each
// column's values for the tile's rows from p.stage[c], 16-aligned; from
// `vstage` the packed validity bytes, byte b of row r at vstage + b * tr +
// r; from `zstage` tr zero bytes.
__global__ void __launch_bounds__(THREADS)
rc_to_rows_kernel(const Plan p, const unsigned char* const* data,
                  const unsigned char* const* valid, long long n, int tr,
                  int vstage, int zstage, uint32_t* image) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int vbytes = (p.ncols + 7) >> 3;
  for (int i = threadIdx.x; i < tr; i += blockDim.x) sm[zstage + i] = 0;
  const long long tiles = (n + tr - 1) / tr;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    long long r0;
    const int rows = static_cast<int>(tile_rows(tile, tr, n, r0));
    // stage: a warp per column (then per validity byte), a lane per row
    for (int c = warp; c < p.ncols; c += warps) {
      const int w = p.width[c];
      if (lane < rows)
        copy_value(sm + p.stage[c] + lane * w, data[c] + (r0 + lane) * w, w);
    }
    for (int b = warp; b < vbytes; b += warps) {
      if (lane >= rows) continue;
      uint32_t v = 0u;
      for (int i = 0; i < 8 && 8 * b + i < p.ncols; ++i) {
        const unsigned char* vc = valid[8 * b + i];
        v |= static_cast<uint32_t>(vc == nullptr || vc[r0 + lane] != 0) << i;
      }
      sm[vstage + b * tr + lane] = static_cast<unsigned char>(v);
    }
    __syncthreads();
    // assemble: a warp on 32 consecutive words of one row at a time
    for (int r = warp; r < rows; r += warps) {
      uint32_t* out = image + (r0 + r) * p.row_words;
      for (int w = lane; w < p.row_words; w += 32) {
        const int4 q = p.words[w];
        uint32_t v;
        if (q.x & SRC_WHOLE)
          v = *reinterpret_cast<const uint32_t*>(sm + src_at(q.x, r));
        else
          v = sm[src_at(q.x, r)] | (sm[src_at(q.y, r)] << 8) |
              (sm[src_at(q.z, r)] << 16) |
              (static_cast<uint32_t>(sm[src_at(q.w, r)]) << 24);
        out[w] = v;
      }
    }
    __syncthreads();
  }
}

// from_rows' outputs: buffer g holds its columns one after another, n
// values each; the validities are an (ncols, n) byte matrix. A grid
// constant, so a column's buffer is read from the parameter by its index
// with no copy to the stack.
struct Outs {
  unsigned char* base[MAX_GROUPS];
};

__global__ void __launch_bounds__(THREADS)
rc_from_rows_kernel(const Plan p, const unsigned char* image, int row_size,
                    long long n, const __grid_constant__ Outs out,
                    unsigned char* out_valid) {
  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    long long r0;
    const int rows = static_cast<int>(tile_rows(tile, TILE_ROWS, n, r0));
    for (int k = threadIdx.x; k < rows * p.ncols; k += blockDim.x) {
      const int c = k / rows;
      const long long row = r0 + (k - c * rows);
      const unsigned char* src = image + row * row_size;
      const unsigned char* v = src + p.offset[c];  // aligned to min(w, 8)
      unsigned char* dst =
          out.base[p.group[c]] + (p.slot[c] * n + row) * p.width[c];
      if (p.is_bool[c])
        dst[0] = v[0] != 0;
      else
        copy_value(dst, v, p.width[c]);
      out_valid[c * n + row] =
          (src[p.validity_offset + c / 8] >> (c % 8)) & 1u;
    }
  }
}

static int blocks_for(long long n, int tr) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long tiles = (n + tr - 1) / tr;
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<int>(tiles < cap ? tiles : cap);
}

static Plan make_plan(const int* meta, int ncols, int row_words,
                      int validity_offset) {
  Plan p;
  p.words = reinterpret_cast<const int4*>(meta);
  p.width = meta + 4 * row_words;
  p.offset = p.width + ncols;
  p.is_bool = p.offset + ncols;
  p.stage = p.is_bool + ncols;
  p.group = p.stage + ncols;
  p.slot = p.group + ncols;
  p.ncols = ncols;
  p.row_words = row_words;
  p.validity_offset = validity_offset;
  return p;
}

extern "C" {

// `meta`: the schema (see `Plan`), device memory. `ptrs` (device memory):
// the ncols data pointers, then ncols validity pointers (null for all
// valid), as 64-bit words. to_rows
// stages tiles of `tile` rows in `stage_bytes` of shared memory, laid out
// as `rc_to_rows_kernel` says (the wrapper's `stage_layout`).
int rc_to_rows(const int* meta, const void* const* ptrs, int ncols,
               int row_words, int validity_offset, int tile, int vstage,
               int zstage, int stage_bytes, long long n, void* image,
               void* stream) {
  if (ncols < 1 || row_words < 1 || n < 1 || tile < 1 || tile > TILE_ROWS ||
      zstage < vstage + ((ncols + 7) / 8) * tile ||
      stage_bytes < zstage + tile || stage_bytes > MAX_STAGE || !meta ||
      !ptrs || !image)
    return static_cast<int>(cudaErrorInvalidValue);
  if (stage_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rc_to_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stage_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned char* const* data =
      reinterpret_cast<const unsigned char* const*>(ptrs);
  rc_to_rows_kernel<<<blocks_for(n, tile), THREADS, stage_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      make_plan(meta, ncols, row_words, validity_offset), data, data + ncols,
      n, tile, vstage, zstage, static_cast<uint32_t*>(image));
  return static_cast<int>(cudaGetLastError());
}

// from_rows reads the image (an 8-aligned address) TILE_ROWS rows a block
// at a time. `bases` (host memory): the ngroups output buffers, each
// holding its columns one after another (the plan's group and slot);
// `valid`: the (ncols, n) validity bytes.
int rc_from_rows(const int* meta, void* const* bases, int ngroups, int ncols,
                 int row_words, int validity_offset, long long n,
                 const void* image, void* valid, void* stream) {
  if (ncols < 1 || row_words < 1 || n < 1 || !meta || !bases ||
      ngroups < 1 || ngroups > MAX_GROUPS || !image || !valid ||
      reinterpret_cast<uintptr_t>(image) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Outs out = {};
  for (int g = 0; g < ngroups; ++g) {
    if (!bases[g]) return static_cast<int>(cudaErrorInvalidValue);
    out.base[g] = static_cast<unsigned char*>(bases[g]);
  }
  rc_from_rows_kernel<<<blocks_for(n, TILE_ROWS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      make_plan(meta, ncols, row_words, validity_offset),
      static_cast<const unsigned char*>(image), 4 * row_words, n, out,
      static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
