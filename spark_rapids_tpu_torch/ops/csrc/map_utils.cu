// Spark's from_json(col, 'MAP<STRING,STRING>') as raw key and value strings
// (MapUtils.extractRawMapFromJsonString), for Hopper (sm_90a): one thread a
// row over a STRING column's offsets and chars.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/map_utils.py
// (`_structure_kernel` :42, `_extract_pairs` :199; no pallas_call). The
// reference's own CUDA is map_utils.cu:68-731 (cudf's JSON tokenizer and a
// gather of the spans). The JAX design pads the column into an (n, L) char
// matrix, runs the string automaton as an associative scan of transition
// functions over (n, L, 3) int32 planes, reads the planes back to the host
// several times and gathers the spans through a padded matrix. Here each
// row walks its bytes once with the automaton (normal, in a string, after
// a backslash) and the bracket depth outside strings, which gives the
// row's shape (the JAX `broken`, `pair_broken`, `is_object`, `empty_row`)
// and its top-level colons; each colon's key runs back to the '{' or ','
// before it and its value on to the ',' or closing '}' after it, which a
// second cursor finds walking ahead of the first (each byte is stepped at
// most twice). ops/map_utils.py's docstring lists the rules.
//
// Two launches a call: `mu_rows` writes each row's error kind, validity,
// pair count and key and value byte counts; the wrapper scans them into
// the list and char offsets by torch.cumsum and reads, once, the first row
// of each error kind and the totals; `mu_pairs` writes every pair's key
// and value offsets and chars (one launch when no row has a pair).
//
// What bounds it on this card: bytes. A row reads its offsets (8 B), its
// validity and its chars twice (one read each launch), and writes 14 B of
// counts, then its pairs' offsets (8 B a pair) and chars. Some ten integer
// instructions a byte a walk (the bound counts 8 a byte once,
// chip_smoke.py). A thread walks its own row byte by byte, about five
// walks a row over both launches, so a warp's load touches up to 32 cache
// lines; rows of different lengths leave threads idle.
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_*` below loop over rows as the kernels do, so that
// tests/test_torch_map_utils.py builds this file with the host compiler and
// holds it against the plain version.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// none synchronises or allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MU_FN __host__ __device__ __forceinline__
#define MU_MEMBER __host__ __device__ __forceinline__
#else
#define MU_FN static inline
#define MU_MEMBER inline
#endif

#define THREADS 256

// the error kinds, in the order from_json reports them over the column
enum MuErr { MU_OK = 0, MU_BROKEN = 1, MU_PAIR_BROKEN = 2, MU_UNQUOTED = 3 };

MU_FN bool mu_ws(int c) { return c == ' ' || c == '\t' || c == '\n' || c == '\r'; }

// One byte through the automaton (0 normal, 1 in a string, 2 after a
// backslash in one) and the depth ('{' '[' open, '}' ']' close, outside
// strings). -> outside: the byte is outside a string; db, da: the depth
// before and after it.
struct MuCursor {
  int state, depth;
  MU_MEMBER void step(int c, bool* outside, int* db, int* da) {
    *outside = state == 0;
    *db = depth;
    if (state == 0) {
      if (c == '{' || c == '[') ++depth;
      else if (c == '}' || c == ']') --depth;
      state = c == '"' ? 1 : 0;
    } else if (state == 1) {
      state = c == '"' ? 0 : (c == '\\' ? 2 : 1);
    } else {
      state = 1;
    }
    *da = depth;
  }
};

// the row's shape (map_utils.py :52-113)
struct MuShape {
  bool broken, pair_broken, is_object, empty;
  int colons;  // the top-level ':'s
};

MU_FN MuShape mu_shape(const uint8_t* s, int len) {
  MuCursor cur = {0, 0};
  bool neg = false, has_content = false, top_junk = false;
  int first_nw = -1, last_nw = -1, commas = 0, opens = 0;
  MuShape r;
  r.colons = 0;
  for (int p = 0; p < len; ++p) {
    const int c = s[p];
    bool out;
    int db, da;
    cur.step(c, &out, &db, &da);
    if (da < 0) neg = true;
    const bool nonws = !mu_ws(c);
    if (nonws) {
      if (first_nw < 0) first_nw = p;
      last_nw = p;
      if (db >= 1 && da >= 1) has_content = true;
      if (out && db == 0 && da == 0) top_junk = true;
    }
    if (out && db == 1) {
      if (c == ':') ++r.colons;
      if (c == ',') ++commas;
    }
    if (out && db == 0 && c == '{') ++opens;
  }
  r.broken = cur.state != 0 || cur.depth != 0 || neg;
  r.empty = first_nw < 0;
  r.is_object = !r.empty && s[first_nw] == '{' && s[last_nw] == '}';
  r.pair_broken =
      r.is_object &&
      ((has_content ? r.colons != commas + 1 : (r.colons | commas) != 0) ||
       opens != 1 || top_junk);
  return r;
}

// [a, b) trimmed of whitespace, then stripped of its quotes when at least
// 2 bytes long with '"' at each end; an empty span ends at its start
// (map_utils.py `_extract_pairs` :203-221)
MU_FN void mu_trim(const uint8_t* s, int a, int b, int* ts, int* te,
                   bool* quoted) {
  int x = b, y = a;
  for (int p = a; p < b; ++p)
    if (!mu_ws(s[p])) {
      x = p;
      break;
    }
  for (int p = b - 1; p >= a; --p)
    if (!mu_ws(s[p])) {
      y = p + 1;
      break;
    }
  const bool empty = x >= y;
  *quoted = !empty && y - x >= 2 && s[x] == '"' && s[y - 1] == '"';
  if (*quoted) {
    ++x;
    --y;
  }
  *ts = x;
  *te = empty ? x : y;
}

// Each top-level colon's key and value span, in order: emit(ks, ke,
// quoted, vs, ve). The value's end is the first ',' at depth 1 or closing
// '}' after the colon, found by a second cursor that walks ahead.
template <class Emit>
MU_FN void mu_pairs(const uint8_t* s, int len, Emit& emit) {
  MuCursor cur = {0, 0}, ahead = {0, 0};
  int last_delim = -1, apos = 0, next_d = -1;
  for (int p = 0; p < len; ++p) {
    const int c = s[p];
    bool out;
    int db, da;
    cur.step(c, &out, &db, &da);
    if (out && ((c == '{' && db == 0) || (c == ',' && db == 1)))
      last_delim = p;
    if (!(out && c == ':' && db == 1)) continue;
    if (next_d <= p) {
      next_d = len;
      for (; apos < len; ++apos) {
        const int ca = s[apos];
        bool aout;
        int adb, ada;
        const MuCursor before = ahead;
        ahead.step(ca, &aout, &adb, &ada);
        if (apos > p && aout &&
            ((ca == ',' && adb == 1) || (ca == '}' && ada == 0))) {
          ahead = before;  // stays before the delimiter, for the next colon
          next_d = apos;
          break;
        }
      }
    }
    int ks, ke, vs, ve;
    bool kq, vq;
    mu_trim(s, last_delim + 1, p, &ks, &ke, &kq);
    mu_trim(s, p + 1, next_d, &vs, &ve, &vq);
    emit(ks, ke, kq, vs, ve);
  }
}

// pass 1: counts the pairs' bytes and whether every key was quoted
struct MuCount {
  long long key_bytes, value_bytes;
  bool unquoted;
  MU_MEMBER void operator()(int ks, int ke, bool kq, int vs, int ve) {
    key_bytes += ke - ks;
    value_bytes += ve - vs;
    unquoted |= !kq;
  }
};

// pass 2: writes each pair's key and value at the row's places
struct MuWrite {
  const uint8_t* s;
  long long pair, key_at, value_at;
  int32_t *key_offsets, *value_offsets;
  uint8_t *key_chars, *value_chars;
  MU_MEMBER void operator()(int ks, int ke, bool, int vs, int ve) {
    for (int p = ks; p < ke; ++p) key_chars[key_at++] = s[p];
    for (int p = vs; p < ve; ++p) value_chars[value_at++] = s[p];
    ++pair;
    key_offsets[pair] = static_cast<int32_t>(key_at);
    value_offsets[pair] = static_cast<int32_t>(value_at);
  }
};

struct RowsArgs {
  const int32_t* offsets;
  const uint8_t* chars;
  const uint8_t* valid_in;  // null: every row valid
  uint8_t* err;             // MuErr
  uint8_t* valid_out;       // a valid object or empty row
  int32_t* pairs;           // the top-level colons of a valid object row
  int32_t* key_bytes;       // its pairs' key and value bytes
  int32_t* value_bytes;
};

MU_FN void mu_rows_row(const RowsArgs& a, long long i) {
  const int base = a.offsets[i];
  const uint8_t* s = a.chars + base;
  const int len = a.offsets[i + 1] - base;
  const bool vin = a.valid_in == nullptr || a.valid_in[i] != 0;
  const MuShape sh = mu_shape(s, len);
  MuCount count = {0, 0, false};
  int err = MU_OK;
  if (vin && sh.broken) {
    err = MU_BROKEN;
  } else if (vin && sh.pair_broken) {
    err = MU_PAIR_BROKEN;
  } else if (vin && sh.is_object) {
    mu_pairs(s, len, count);
    if (count.unquoted) err = MU_UNQUOTED;
  }
  a.err[i] = static_cast<uint8_t>(err);
  a.valid_out[i] = vin && (sh.is_object || sh.empty);
  a.pairs[i] = vin && sh.is_object ? sh.colons : 0;
  a.key_bytes[i] = static_cast<int32_t>(count.key_bytes);
  a.value_bytes[i] = static_cast<int32_t>(count.value_bytes);
}

struct PairsArgs {
  const int32_t* offsets;
  const uint8_t* chars;
  const int64_t* pair_start;   // (n + 1,): the row's first pair
  const int64_t* key_start;    // (n,): the row's first key byte
  const int64_t* value_start;  // (n,)
  int32_t* key_offsets;        // (pairs + 1,), [0] already 0
  int32_t* value_offsets;
  uint8_t* key_chars;
  uint8_t* value_chars;
};

MU_FN void mu_pairs_row(const PairsArgs& a, long long i) {
  if (a.pair_start[i + 1] == a.pair_start[i]) return;
  const int base = a.offsets[i];
  MuWrite w = {a.chars + base, a.pair_start[i], a.key_start[i],
               a.value_start[i], a.key_offsets, a.value_offsets,
               a.key_chars, a.value_chars};
  mu_pairs(a.chars + base, a.offsets[i + 1] - base, w);
}

static bool mu_rows_ok(const RowsArgs& a, long long n) {
  return n >= 1 && a.offsets != nullptr && a.chars != nullptr &&
         a.err != nullptr && a.valid_out != nullptr && a.pairs != nullptr &&
         a.key_bytes != nullptr && a.value_bytes != nullptr;
}

static bool mu_pairs_ok(const PairsArgs& a, long long n) {
  return n >= 1 && a.offsets != nullptr && a.chars != nullptr &&
         a.pair_start != nullptr && a.key_start != nullptr &&
         a.value_start != nullptr && a.key_offsets != nullptr &&
         a.value_offsets != nullptr && a.key_chars != nullptr &&
         a.value_chars != nullptr;
}

static RowsArgs mu_rows_args(const void* offsets, const void* chars,
                             const void* valid_in, void* err, void* valid_out,
                             void* pairs, void* key_bytes,
                             void* value_bytes) {
  RowsArgs a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<const uint8_t*>(chars);
  a.valid_in = static_cast<const uint8_t*>(valid_in);
  a.err = static_cast<uint8_t*>(err);
  a.valid_out = static_cast<uint8_t*>(valid_out);
  a.pairs = static_cast<int32_t*>(pairs);
  a.key_bytes = static_cast<int32_t*>(key_bytes);
  a.value_bytes = static_cast<int32_t*>(value_bytes);
  return a;
}

static PairsArgs mu_pairs_args(const void* offsets, const void* chars,
                               const void* pair_start, const void* key_start,
                               const void* value_start, void* key_offsets,
                               void* value_offsets, void* key_chars,
                               void* value_chars) {
  PairsArgs a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<const uint8_t*>(chars);
  a.pair_start = static_cast<const int64_t*>(pair_start);
  a.key_start = static_cast<const int64_t*>(key_start);
  a.value_start = static_cast<const int64_t*>(value_start);
  a.key_offsets = static_cast<int32_t*>(key_offsets);
  a.value_offsets = static_cast<int32_t*>(value_offsets);
  a.key_chars = static_cast<uint8_t*>(key_chars);
  a.value_chars = static_cast<uint8_t*>(value_chars);
  return a;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
mu_rows_kernel(RowsArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    mu_rows_row(a, i);
}

__global__ void __launch_bounds__(THREADS)
mu_pairs_kernel(PairsArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    mu_pairs_row(a, i);
}

static int blocks_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long need = (n + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

// n >= 1 rows. offsets: (n + 1,) int32; chars: uint8; valid_in: (n,) bool
// or null. Writes err, valid_out: (n,) uint8; pairs, key_bytes,
// value_bytes: (n,) int32.
int mu_rows(const void* offsets, const void* chars, const void* valid_in,
            long long n, void* err, void* valid_out, void* pairs,
            void* key_bytes, void* value_bytes, void* stream) {
  const RowsArgs a = mu_rows_args(offsets, chars, valid_in, err, valid_out,
                                  pairs, key_bytes, value_bytes);
  if (!mu_rows_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  mu_rows_kernel<<<blocks_for(n), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

// n >= 1 rows, every valid object row free of errors. pair_start: (n + 1,)
// int64, the scan of `pairs`; key_start, value_start: (n,) int64, the
// exclusive scans of the byte counts. Writes key_offsets[1:] and
// value_offsets[1:] (int32) and the chars.
int mu_pairs(const void* offsets, const void* chars, long long n,
             const void* pair_start, const void* key_start,
             const void* value_start, void* key_offsets, void* value_offsets,
             void* key_chars, void* value_chars, void* stream) {
  const PairsArgs a = mu_pairs_args(offsets, chars, pair_start, key_start,
                                    value_start, key_offsets, value_offsets,
                                    key_chars, value_chars);
  if (!mu_pairs_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  mu_pairs_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_rows(const void* offsets, const void* chars,
                         const void* valid_in, long long n, void* err,
                         void* valid_out, void* pairs, void* key_bytes,
                         void* value_bytes) {
  const RowsArgs a = mu_rows_args(offsets, chars, valid_in, err, valid_out,
                                  pairs, key_bytes, value_bytes);
  if (!mu_rows_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) mu_rows_row(a, i);
  return 0;
}

extern "C" int host_pairs(const void* offsets, const void* chars, long long n,
                          const void* pair_start, const void* key_start,
                          const void* value_start, void* key_offsets,
                          void* value_offsets, void* key_chars,
                          void* value_chars) {
  const PairsArgs a = mu_pairs_args(offsets, chars, pair_start, key_start,
                                    value_start, key_offsets, value_offsets,
                                    key_chars, value_chars);
  if (!mu_pairs_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) mu_pairs_row(a, i);
  return 0;
}

#endif  // __CUDACC__
