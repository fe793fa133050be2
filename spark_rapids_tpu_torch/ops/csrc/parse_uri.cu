// Spark's parse_url: a URI's protocol, host, query and query parameter, for
// Hopper (sm_90a): one thread a row over a STRING column's offsets and chars.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/parse_uri.py (`_parse_kernel`
// :215, `_find_param_kernel` :509; no pallas_call). The reference's own CUDA
// is parse_uri.cu:92-875, one thread a row as here. The JAX design pads the
// column into an (n, L) char matrix (a host read of the longest string
// first) and runs java.net.URI's grammar as dozens of boolean planes over
// it, with the parameter search a loop over every pair start. Here each row
// walks its own bytes: the UTF-8 and charset check and the '%' escapes in
// one pass, then the scheme, the authority (user info, an IPv6 literal, an
// exact IPv4 or a hostname, the port, the registry fallback), the path and
// the query, each rule of the JAX algebra the same predicate on that walk
// (ops/parse_uri.py's docstring lists them). The parameter forms then look
// for the first pair start in the query whose raw bytes equal the
// parameter and an '='.
//
// Two launches a call: `pu_spans` writes each row's span (start, length)
// and validity; the wrapper scans the lengths into offsets by torch.cumsum,
// reads the char total once, and `pu_copy` copies each row's span.
//
// What bounds it on this card: bytes. A row reads its offsets (8 B), its
// validity and chars, and writes its span (9 B); the copy reads and writes
// the output chars. A character costs a few compares and a class test a
// rule that reads it (the bound counts 8 instructions a byte, and a row
// read up to its first byte that is never legal; chip_smoke.py). A thread
// walks its own row byte by byte, so a warp's load touches up to 32 cache
// lines, and rows of different lengths or paths leave threads idle: a
// later design stages a block's rows in shared memory with wide loads.
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_*` below loop over rows as the kernels do, so that
// tests/test_torch_parse_uri.py builds this file with the host compiler and
// holds it against the plain version.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// none synchronises or allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PU_FN __host__ __device__ __forceinline__
#else
#define PU_FN static inline
#endif

#define THREADS 256

typedef unsigned long long u64;

static const int PU_BIG = 1 << 30;  // "not found", as the JAX package's

// The byte classes of ops/parse_uri.py's TABLES, as bits of the ASCII bytes
// (0-63 in `lo`, 64-127 in `hi`); `other`: the bytes from 0x80.
struct Cls {
  u64 lo, hi;
  bool other;
};

// generated from ops/parse_uri.py TABLES (the '%' bit where `pct`)
#define CLS_SCHEME {0x03ff680000000000ULL, 0x07fffffe07fffffeULL, false}
#define CLS_USERINFO {0x2fff7ff200000000ULL, 0x47fffffe87fffffeULL, true}
#define CLS_REGISTRY {0x2fff7ff200000000ULL, 0x47fffffe87ffffffULL, true}
#define CLS_PATH {0x2ffffff200000000ULL, 0x47fffffe87ffffffULL, true}
#define CLS_URIC {0xaffffff200000000ULL, 0x47fffffeafffffffULL, true}
#define CLS_HOSTNAME {0x03ff600000000000ULL, 0x07fffffe07fffffeULL, false}
#define CLS_IPV6 {0x07ff400000000000ULL, 0x0000007e0000007eULL, false}
#define CLS_HEX {0x03ff000000000000ULL, 0x0000007e0000007eULL, false}
#define CLS_DIGITS {0x03ff000000000000ULL, 0x0000000000000000ULL, false}
#define CLS_ALPHA {0x0000000000000000ULL, 0x07fffffe07fffffeULL, false}

PU_FN bool pu_in(const Cls k, int c) {
  if (c >= 128) return k.other;
  return c < 64 ? ((k.lo >> c) & 1ULL) != 0 : ((k.hi >> (c - 64)) & 1ULL) != 0;
}

// the char at i, 0 outside the row (the padded matrix's zeros)
PU_FN int pu_at(const uint8_t* s, int len, int i) {
  return (i >= 0 && i < len) ? s[i] : 0;
}

PU_FN int pu_first(const uint8_t* s, int len, int b, int start) {
  for (int p = start < 0 ? 0 : start; p < len; ++p)
    if (s[p] == b) return p;
  return PU_BIG;
}

// every char of [a, b) in the class
PU_FN bool pu_all(const uint8_t* s, int len, const Cls k, int a, int b) {
  if (b > len) b = len;
  for (int p = a < 0 ? 0 : a; p < b; ++p)
    if (!pu_in(k, s[p])) return false;
  return true;
}

PU_FN bool pu_cont(int c) { return (c & 0xC0) == 0x80; }

// UTF-8, no ASCII control or space, no Unicode space or C1 control
// (parse_uri.py `_utf8_and_charset_valid`), and every '%' followed by two
// hex digits inside the row (`_escapes_valid`)
PU_FN bool pu_bytes_ok(const uint8_t* s, int len) {
  const Cls hex = CLS_HEX;
  for (int p = 0; p < len; ++p) {
    const int c = s[p];
    const int n1 = pu_at(s, len, p + 1), n2 = pu_at(s, len, p + 2),
              n3 = pu_at(s, len, p + 3);
    if (c < 0x21 || c == 0x7F) return false;
    if (c == '%' && !(p + 2 < len && pu_in(hex, n1) && pu_in(hex, n2)))
      return false;
    if (c < 0x80) continue;
    bool seq_ok;
    if (pu_cont(c)) {
      const int p1 = pu_at(s, len, p - 1), p2 = pu_at(s, len, p - 2),
                p3 = pu_at(s, len, p - 3);
      seq_ok = (p1 >= 0xC2 && p1 <= 0xF4) || (p2 >= 0xE0 && p2 <= 0xF4) ||
               (p3 >= 0xF0 && p3 <= 0xF4);
    } else if (c >= 0xC2 && c <= 0xDF) {
      seq_ok = pu_cont(n1) && p + 1 < len;
    } else if (c >= 0xE0 && c <= 0xEF) {
      seq_ok = pu_cont(n1) && pu_cont(n2) && p + 2 < len &&
               (c != 0xE0 || n1 >= 0xA0) && (c != 0xED || n1 <= 0x9F);
    } else if (c >= 0xF0 && c <= 0xF4) {
      seq_ok = pu_cont(n1) && pu_cont(n2) && pu_cont(n3) && p + 3 < len &&
               (c != 0xF0 || n1 >= 0x90) && (c != 0xF4 || n1 <= 0x8F);
    } else {
      seq_ok = false;  // 0xC0, 0xC1, 0xF5-0xFF
    }
    if (!seq_ok) return false;
    if (c == 0xC2 && n1 >= 0x80 && n1 <= 0xA0) return false;  // U+0080-00A0
    if (c == 0xE1 && n1 == 0x9A && n2 == 0x80) return false;  // U+1680
    if (c == 0xE2 && n1 == 0x80 &&
        ((n2 >= 0x80 && n2 <= 0x8A) || n2 == 0xA8 || n2 == 0xA9 || n2 == 0xAF))
      return false;                     // U+2000-200A, 2028, 2029, 202F
    if (c == 0xE2 && n1 == 0x81 && n2 == 0x9F) return false;  // U+205F
    if (c == 0xE3 && n1 == 0x80 && n2 == 0x80) return false;  // U+3000
  }
  return true;
}

// exact dotted-quad IPv4 over [start, end): 4 numbers of 1-3 digits, each
// at most 255 (parse_uri.py `_ipv4_ok`)
PU_FN bool pu_ipv4(const uint8_t* s, int len, int start, int end) {
  if (end <= start) return false;
  const Cls digits = CLS_DIGITS;
  int dots = 0, q = start;  // q: the current number's first char
  for (int p = start; p <= end; ++p) {
    const int c = pu_at(s, len, p);
    if (p < end && c != '.') {
      if (!pu_in(digits, c)) return false;
      continue;
    }
    // a '.' or the end closes the number [q, p)
    const int qlen = p - q;
    if (qlen == 0 || qlen > 3) return false;  // an edge or doubled '.'
    if (qlen == 3) {
      const int a = s[q], b = s[q + 1], d = s[q + 2];
      if (a > '2' || (a == '2' && (b > '5' || (b == '5' && d > '5'))))
        return false;
    }
    if (p < end) ++dots;
    q = p + 1;
  }
  return dots == 3;
}

// an IPv6 literal [a6 - 1, rb] (java's parseIPv6Reference, parse_uri.py
// :314-376): hex groups of 1-4 digits, at most one '::', an embedded IPv4
// only as the last group, 16 bytes (or at most 14 with '::')
PU_FN bool pu_ipv6(const uint8_t* s, int len, int a6, int rb) {
  if (!pu_all(s, len, CLS_IPV6, a6, rb)) return false;
  if (pu_at(s, len, a6) == ':' && pu_at(s, len, a6 + 1) != ':') return false;
  if (pu_at(s, len, rb - 1) == ':' && pu_at(s, len, rb - 2) != ':')
    return false;
  int n_dc = 0, n_hex = 0, n_v4 = 0, v4_start = 0;
  for (int p = a6; p < rb; ++p) {
    if (s[p] == ':') {
      if (p + 1 < rb && s[p + 1] == ':') ++n_dc;
      continue;
    }
    if (p > a6 && s[p - 1] != ':') continue;  // not a group's start
    int e = p;
    bool dot = false;
    while (e < rb && s[e] != ':') dot |= s[e++] == '.';
    if (dot) {
      if (e != rb) return false;  // an IPv4 group must be the last
      ++n_v4;
      v4_start = p;
    } else {
      if (e - p > 4) return false;
      ++n_hex;
    }
  }
  if (n_dc > 1 || n_v4 > 1) return false;
  const int bytes = 2 * n_hex + 4 * n_v4;
  if (n_dc > 0 ? bytes > 14 : bytes != 16) return false;
  return n_v4 == 0 || pu_ipv4(s, len, v4_start, rb);
}

// a hostname: labels of alphanumerics and '-', no '-' at a label's edge, no
// empty label, an optional trailing '.', the last label starting with a
// letter (parse_uri.py :397-418)
PU_FN bool pu_hostname(const uint8_t* s, int len, int hs, int he) {
  if (he <= hs || !pu_all(s, len, CLS_HOSTNAME, hs, he)) return false;
  for (int p = hs; p < he; ++p) {
    const bool prv_dot = p > hs && s[p - 1] == '.';
    if (s[p] == '-') {
      const bool nxt_dot = p + 1 < he && s[p + 1] == '.';
      if (nxt_dot || prv_dot || p == hs || p == he - 1) return false;
    } else if (s[p] == '.' && (prv_dot || p == hs)) {
      return false;
    }
  }
  const int eff_end = he - (pu_at(s, len, he - 1) == '.' ? 1 : 0);
  int last_label = hs;
  for (int p = hs; p < eff_end; ++p)
    if (s[p] == '.') last_label = p + 1;
  return pu_in(CLS_ALPHA, pu_at(s, len, last_label));
}

// one row's components: valid, and present / [start, end) of the scheme,
// the host and the query (the JAX `_parse_kernel`'s outputs)
struct PuRow {
  bool valid, scheme, host, query;
  int scheme_end, host_start, host_end, query_start, query_end;
};

PU_FN PuRow pu_parse(const uint8_t* s, int len) {
  PuRow r;
  r.valid = r.scheme = r.host = r.query = false;
  r.scheme_end = r.host_start = r.host_end = r.query_start = r.query_end = 0;
  if (!pu_bytes_ok(s, len)) return r;
  // the scheme: a ':' before any '/', '?' and '#'
  int delim0 = len;
  for (int p = 0; p < len; ++p)
    if (s[p] == '/' || s[p] == '?' || s[p] == '#') {
      delim0 = p;
      break;
    }
  const int colon0 = pu_first(s, len, ':', 0);
  const bool has_scheme = colon0 < delim0;
  if (has_scheme &&
      !(colon0 > 0 && pu_in(CLS_ALPHA, s[0]) &&
        pu_all(s, len, CLS_SCHEME, 1, colon0)))
    return r;
  const int ssp = has_scheme ? colon0 + 1 : 0;
  const int frag = pu_first(s, len, '#', ssp);
  const int body_end = frag < len ? frag : len;
  if (has_scheme && ssp >= body_end) return r;  // empty scheme-specific part
  const int c_ssp = pu_at(s, len, ssp);
  const bool hier = !has_scheme || c_ssp == '/' || ssp >= body_end;
  if (!hier && !pu_all(s, len, CLS_URIC, ssp, body_end)) return r;
  // the authority, path, query and fragment
  const bool has_auth = hier && c_ssp == '/' && pu_at(s, len, ssp + 1) == '/';
  const int auth_start = ssp + 2;
  int auth_end = ssp;
  if (has_auth) {
    auth_end = len;
    for (int p = auth_start; p < len; ++p)
      if (s[p] == '/' || s[p] == '?' || s[p] == '#') {
        auth_end = p;
        break;
      }
  }
  const bool empty_auth = has_auth && auth_end == auth_start;
  if (empty_auth && auth_start >= body_end) return r;
  const int path_start = has_auth ? auth_end : ssp;
  const int qmark = pu_first(s, len, '?', path_start);
  int path_end = qmark < frag ? qmark : frag;
  if (path_end > len) path_end = len;
  if (hier && !pu_all(s, len, CLS_PATH, path_start, path_end)) return r;
  const bool has_query = hier && qmark < body_end;
  if (has_query && !pu_all(s, len, CLS_URIC, qmark + 1, body_end)) return r;
  if (frag < len && !pu_all(s, len, CLS_URIC, frag + 1, len)) return r;
  // the authority: server-based, else a registry name
  bool server_ok = false;
  int host_start = auth_start, host_end = auth_end;
  if (has_auth && !empty_auth) {
    int amp = PU_BIG;
    for (int p = auth_start; p < auth_end; ++p)
      if (s[p] == '@') {
        amp = p;
        break;
      }
    const bool has_user = amp < auth_end;
    const bool user_ok =
        !has_user || pu_all(s, len, CLS_USERINFO, auth_start, amp);
    host_start = has_user ? amp + 1 : auth_start;
    if (pu_at(s, len, host_start) == '[') {
      int rb = PU_BIG;
      for (int p = host_start; p < auth_end; ++p)
        if (s[p] == ']') {
          rb = p;
          break;
        }
      bool v6_ok = rb < auth_end && pu_ipv6(s, len, host_start + 1, rb);
      if (v6_ok && rb + 1 < auth_end)
        v6_ok = s[rb + 1] == ':' &&
                pu_all(s, len, CLS_DIGITS, rb + 2, auth_end);
      server_ok = user_ok && v6_ok;
      host_end = rb + 1;  // getHost() keeps the brackets
    } else {
      int last_colon = -1;
      for (int p = host_start; p < auth_end; ++p)
        if (s[p] == ':') last_colon = p;
      const bool has_port = last_colon >= host_start;
      host_end = has_port ? last_colon : auth_end;
      const bool port_ok =
          !has_port || pu_all(s, len, CLS_DIGITS, last_colon + 1, auth_end);
      const bool host_ok = pu_hostname(s, len, host_start, host_end) ||
                           pu_ipv4(s, len, host_start, host_end);
      server_ok = user_ok && host_ok && port_ok;
    }
    if (!server_ok && !pu_all(s, len, CLS_REGISTRY, auth_start, auth_end))
      return r;
  }
  r.valid = true;
  r.scheme = has_scheme;
  r.scheme_end = colon0;
  r.host = server_ok;
  r.host_start = host_start;
  r.host_end = host_end;
  r.query = has_query;
  r.query_start = qmark + 1;
  r.query_end = body_end;
  return r;
}

// the value span of the first query pair whose raw bytes start with the
// parameter and '=' (parse_uri.py `_find_param_kernel`); false if none
PU_FN bool pu_find_param(const uint8_t* s, int qs, int qe, const uint8_t* prm,
                         int plen, int* vs, int* ve) {
  for (int p = qs; p < qe; ++p) {
    if (p > qs && s[p - 1] != '&') continue;  // not a pair start
    if (p + plen >= qe || s[p + plen] != '=') continue;
    bool eq = true;
    for (int i = 0; i < plen && eq; ++i) eq = s[p + i] == prm[i];
    if (!eq) continue;
    *vs = p + plen + 1;
    *ve = qe;
    for (int q = *vs; q < qe; ++q)
      if (s[q] == '&') {
        *ve = q;
        break;
      }
    return true;
  }
  return false;
}

enum PuOp { PU_PROTOCOL = 0, PU_HOST = 1, PU_QUERY = 2, PU_PARAM = 3 };

struct SpanArgs {
  int op;
  const int32_t* offsets;
  const uint8_t* chars;
  const uint8_t* valid_in;     // null: every row valid
  // PU_PARAM: a column (param_offsets set) or one literal (param_len bytes
  // at param_chars); `nonempty`: a match needs a non-empty parameter
  const int32_t* param_offsets;
  const uint8_t* param_chars;
  const uint8_t* param_valid;  // null: every parameter row valid
  int param_len, nonempty;
  int32_t* start;              // the span's first char in `chars`
  int32_t* length;             // the span's length where present, else 0
  uint8_t* valid_out;          // present, the row valid, its parameter too
};

PU_FN void pu_span_row(const SpanArgs& a, long long i) {
  const int base = a.offsets[i];
  const uint8_t* s = a.chars + base;
  const PuRow r = pu_parse(s, a.offsets[i + 1] - base);
  bool present = false;
  int st = 0, en = 0;
  bool pvalid = true;
  if (a.op == PU_PROTOCOL) {
    present = r.valid && r.scheme;
    en = r.scheme_end;
  } else if (a.op == PU_HOST) {
    present = r.valid && r.host;
    st = r.host_start;
    en = r.host_end;
  } else if (a.op == PU_QUERY) {
    present = r.valid && r.query;
    st = r.query_start;
    en = r.query_end;
  } else {
    const uint8_t* prm = a.param_chars;
    int plen = a.param_len;
    if (a.param_offsets != nullptr) {
      prm = a.param_chars + a.param_offsets[i];
      plen = a.param_offsets[i + 1] - a.param_offsets[i];
    }
    if (a.param_valid != nullptr) pvalid = a.param_valid[i] != 0;
    if (r.valid && r.query && (plen > 0 || !a.nonempty))
      present = pu_find_param(s, r.query_start, r.query_end, prm, plen, &st,
                              &en);
  }
  const bool vin = a.valid_in == nullptr || a.valid_in[i] != 0;
  a.start[i] = base + (present ? st : 0);
  a.length[i] = present ? en - st : 0;
  a.valid_out[i] = present && vin && pvalid;
}

// one row's span copied to its place in the output
PU_FN void pu_copy_row(const uint8_t* chars, const int32_t* start,
                       const int32_t* out_offsets, uint8_t* out,
                       long long i) {
  const int o = out_offsets[i], m = out_offsets[i + 1] - o;
  const uint8_t* src = chars + start[i];
  for (int k = 0; k < m; ++k) out[o + k] = src[k];
}

static bool pu_args_ok(const SpanArgs& a, long long n) {
  return n >= 1 && a.op >= PU_PROTOCOL && a.op <= PU_PARAM &&
         a.offsets != nullptr && a.chars != nullptr && a.start != nullptr &&
         a.length != nullptr && a.valid_out != nullptr &&
         (a.op != PU_PARAM || a.param_chars != nullptr) && a.param_len >= 0;
}

static SpanArgs pu_args(int op, const void* offsets, const void* chars,
                        const void* valid_in, const void* param_offsets,
                        const void* param_chars, const void* param_valid,
                        int param_len, int nonempty, void* start,
                        void* length, void* valid_out) {
  SpanArgs a;
  a.op = op;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.chars = static_cast<const uint8_t*>(chars);
  a.valid_in = static_cast<const uint8_t*>(valid_in);
  a.param_offsets = static_cast<const int32_t*>(param_offsets);
  a.param_chars = static_cast<const uint8_t*>(param_chars);
  a.param_valid = static_cast<const uint8_t*>(param_valid);
  a.param_len = param_len;
  a.nonempty = nonempty;
  a.start = static_cast<int32_t*>(start);
  a.length = static_cast<int32_t*>(length);
  a.valid_out = static_cast<uint8_t*>(valid_out);
  return a;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
pu_spans_kernel(SpanArgs a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    pu_span_row(a, i);
}

__global__ void __launch_bounds__(THREADS)
pu_copy_kernel(const uint8_t* chars, const int32_t* start,
               const int32_t* out_offsets, uint8_t* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    pu_copy_row(chars, start, out_offsets, out, i);
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
// or null; op 0-3 (PuOp); for op 3 the parameter column's offsets, chars
// and validity (or null offsets and `param_len` literal bytes at
// param_chars) and `nonempty`. Writes start, length: (n,) int32 and
// valid_out: (n,) bool.
int pu_spans(int op, const void* offsets, const void* chars,
             const void* valid_in, long long n, const void* param_offsets,
             const void* param_chars, const void* param_valid, int param_len,
             int nonempty, void* start, void* length, void* valid_out,
             void* stream) {
  const SpanArgs a = pu_args(op, offsets, chars, valid_in, param_offsets,
                             param_chars, param_valid, param_len, nonempty,
                             start, length, valid_out);
  if (!pu_args_ok(a, n)) return static_cast<int>(cudaErrorInvalidValue);
  pu_spans_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

// n >= 1 rows: out[out_offsets[i]:out_offsets[i + 1]] = the span of row i
// of `chars` from start[i].
int pu_copy(const void* chars, const void* start, const void* out_offsets,
            long long n, void* out, void* stream) {
  if (n < 1 || chars == nullptr || start == nullptr ||
      out_offsets == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  pu_copy_kernel<<<blocks_for(n), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chars), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(out_offsets), static_cast<uint8_t*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_spans(int op, const void* offsets, const void* chars,
                          const void* valid_in, long long n,
                          const void* param_offsets, const void* param_chars,
                          const void* param_valid, int param_len,
                          int nonempty, void* start, void* length,
                          void* valid_out) {
  const SpanArgs a = pu_args(op, offsets, chars, valid_in, param_offsets,
                             param_chars, param_valid, param_len, nonempty,
                             start, length, valid_out);
  if (!pu_args_ok(a, n)) return 1;
  for (long long i = 0; i < n; ++i) pu_span_row(a, i);
  return 0;
}

extern "C" int host_copy(const void* chars, const void* start,
                         const void* out_offsets, long long n, void* out) {
  for (long long i = 0; i < n; ++i)
    pu_copy_row(static_cast<const uint8_t*>(chars),
                static_cast<const int32_t*>(start),
                static_cast<const int32_t*>(out_offsets),
                static_cast<uint8_t*>(out), i);
  return 0;
}

#endif  // __CUDACC__
