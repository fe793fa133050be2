// Delta Lake's Z-order helpers, InterleaveBits and the Hilbert index, for
// Hopper (sm_90a).
//
// Replaces the XLA ops of spark_rapids_tpu/ops/zorder.py (`interleave_bits`
// :59, `hilbert_index` :84; no pallas_call). The reference's own CUDA is
// zorder.cu:138-222 (one thread an output byte) and :224-273 (one thread a
// row), as here. The JAX design expands every row into an (n, 8 * width,
// ncols) byte plane and packs it with reshapes; here nothing but the output
// is written:
//
// - `zo_interleave`: one thread an output byte. Byte j of a row holds the
//   stream bits p = 8j .. 8j + 7, stream bit p being bit (8 * width - 1 -
//   p / ncols) of column p % ncols (MSB first, column 0 most significant);
//   a null reads 0 and a float its bits. Widths 1, 2, 4 and 8 are template
//   parameters.
// - `zo_hilbert`: one thread a row of INT32 columns. The coordinates,
//   zero-extended and masked to num_bits (nulls 0), go through Skilling's
//   inverse undo and Gray encoding, then their bits are interleaved,
//   dimension 0 most significant, in a uint64 register (bit 63 set where
//   num_bits * ncols = 64).
//
// Each kernel reads the columns' data and validity addresses from a small
// device array (every data address, then every validity address or 0).
//
// What bounds them on this card: bytes. The interleave reads each value
// once and writes as many bytes (a byte thread reads up to 8 values, most
// of them from the L1); the Hilbert index reads 4 bytes a column and
// writes 8 a row, and its transform is some 10 integer operations a bit
// and column, under the bytes' time at the card's integer rate
// (chip_smoke.py counts the bound).
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_*` below loop over bytes and rows as the kernels do, so that
// tests/test_torch_zorder.py builds this file with the host compiler and
// holds it against the plain version.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// none synchronises or allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ZO_FN __host__ __device__ __forceinline__
#else
#define ZO_FN static inline
#endif

#define THREADS 256
#define ZO_MAX_HILBERT_COLS 64

typedef long long i64;
typedef unsigned long long u64;

template <int W> struct ZoWord;
template <> struct ZoWord<1> { typedef uint8_t T; };
template <> struct ZoWord<2> { typedef uint16_t T; };
template <> struct ZoWord<4> { typedef uint32_t T; };
template <> struct ZoWord<8> { typedef u64 T; };

// column c's value at row i as unsigned bits, 0 where null
template <int W>
ZO_FN u64 zo_value(const i64* table, int ncols, int c, i64 i) {
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(table[ncols + c]);
  if (valid != nullptr && valid[i] == 0) return 0;
  typedef typename ZoWord<W>::T T;
  return static_cast<u64>(reinterpret_cast<const T*>(table[c])[i]);
}

// output byte g of the (n, ncols * W) interleaved bytes
template <int W>
ZO_FN uint8_t zo_interleave_byte(const i64* table, int ncols, i64 g) {
  const i64 row_bytes = static_cast<i64>(ncols) * W;
  const i64 i = g / row_bytes;
  const int j = static_cast<int>(g - i * row_bytes);
  unsigned byte = 0;
  for (int t = 0; t < 8; ++t) {
    const int p = 8 * j + t;
    const int b = p / ncols, c = p - b * ncols;
    const u64 v = zo_value<W>(table, ncols, c, i);
    byte |= static_cast<unsigned>((v >> (8 * W - 1 - b)) & 1ULL) << (7 - t);
  }
  return static_cast<uint8_t>(byte);
}

ZO_FN i64 zo_hilbert_row(const i64* table, int ncols, int num_bits, i64 i) {
  const uint32_t mask =
      num_bits == 32 ? 0xFFFFFFFFu : ((1u << num_bits) - 1u);
  uint32_t x[ZO_MAX_HILBERT_COLS];
  for (int c = 0; c < ncols; ++c)
    x[c] = static_cast<uint32_t>(zo_value<4>(table, ncols, c, i)) & mask;
  // Skilling's inverse undo
  for (uint32_t q = 1u << (num_bits - 1); q > 1; q >>= 1) {
    const uint32_t p = q - 1;
    for (int c = 0; c < ncols; ++c) {
      if (x[c] & q) {
        x[0] ^= p;
      } else {
        const uint32_t t = (x[0] ^ x[c]) & p;
        x[0] ^= t;
        x[c] ^= t;
      }
    }
  }
  // Gray encode
  for (int c = 1; c < ncols; ++c) x[c] = (x[c] ^ x[c - 1]) & mask;
  uint32_t t = 0;
  for (uint32_t q = 1u << (num_bits - 1); q > 1; q >>= 1)
    if (x[ncols - 1] & q) t ^= q - 1;
  for (int c = 0; c < ncols; ++c) x[c] = (x[c] ^ t) & mask;
  // interleave, dimension 0 most significant
  u64 out = 0;
  int b_index = num_bits * ncols - 1;
  for (int bit = num_bits - 1; bit >= 0; --bit)
    for (int c = 0; c < ncols; ++c, --b_index)
      if ((x[c] >> bit) & 1u) out |= 1ULL << b_index;
  return static_cast<i64>(out);
}

static bool zo_hilbert_ok(int ncols, int num_bits) {
  return ncols >= 1 && ncols <= ZO_MAX_HILBERT_COLS && num_bits >= 1 &&
         num_bits <= 32 && num_bits * ncols <= 64;
}

#ifdef __CUDACC__

template <int W>
__global__ void __launch_bounds__(THREADS)
zo_interleave_kernel(const i64* table, int ncols, i64 total, uint8_t* out) {
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 g = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < total; g += stride)
    out[g] = zo_interleave_byte<W>(table, ncols, g);
}

__global__ void __launch_bounds__(THREADS)
zo_hilbert_kernel(const i64* table, int ncols, int num_bits, i64 n,
                  i64* out) {
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = zo_hilbert_row(table, ncols, num_bits, i);
}

static int blocks_for(i64 n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const i64 need = (n + THREADS - 1) / THREADS;
  const i64 cap = static_cast<i64>(sms) * 16;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

// n >= 1 rows; table: (2 * ncols,) int64 device array of data addresses,
// then validity addresses (0: every row valid); width: bytes a value (1,
// 2, 4 or 8); writes out: (n, ncols * width) uint8.
int zo_interleave(const void* table, int ncols, int width, long long n,
                  void* out, void* stream) {
  if (n < 1 || ncols < 1 || table == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const i64* t = static_cast<const i64*>(table);
  uint8_t* o = static_cast<uint8_t*>(out);
  const i64 total = n * ncols * width;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(total);
  switch (width) {
    case 1: zo_interleave_kernel<1><<<blocks, THREADS, 0, s>>>(t, ncols, total, o); break;
    case 2: zo_interleave_kernel<2><<<blocks, THREADS, 0, s>>>(t, ncols, total, o); break;
    case 4: zo_interleave_kernel<4><<<blocks, THREADS, 0, s>>>(t, ncols, total, o); break;
    case 8: zo_interleave_kernel<8><<<blocks, THREADS, 0, s>>>(t, ncols, total, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// n >= 1 rows of ncols INT32 columns (table as above); writes out: (n,)
// int64.
int zo_hilbert(const void* table, int ncols, int num_bits, long long n,
               void* out, void* stream) {
  if (n < 1 || table == nullptr || out == nullptr ||
      !zo_hilbert_ok(ncols, num_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  zo_hilbert_kernel<<<blocks_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(table), ncols, num_bits, n,
      static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_interleave(const void* table, int ncols, int width,
                               long long n, void* out) {
  const i64* t = static_cast<const i64*>(table);
  uint8_t* o = static_cast<uint8_t*>(out);
  const i64 total = n * ncols * width;
  for (i64 g = 0; g < total; ++g) {
    switch (width) {
      case 1: o[g] = zo_interleave_byte<1>(t, ncols, g); break;
      case 2: o[g] = zo_interleave_byte<2>(t, ncols, g); break;
      case 4: o[g] = zo_interleave_byte<4>(t, ncols, g); break;
      case 8: o[g] = zo_interleave_byte<8>(t, ncols, g); break;
      default: return 1;
    }
  }
  return 0;
}

extern "C" int host_hilbert(const void* table, int ncols, int num_bits,
                            long long n, void* out) {
  if (!zo_hilbert_ok(ncols, num_bits)) return 1;
  for (i64 i = 0; i < n; ++i)
    static_cast<i64*>(out)[i] =
        zo_hilbert_row(static_cast<const i64*>(table), ncols, num_bits, i);
  return 0;
}

#endif  // __CUDACC__
