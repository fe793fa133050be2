// Chunked parquet column-chunk reader (host-only C++).
//
// The PyTorch port's copy of spark_rapids_tpu/native/parquet_reader.cpp,
// built by spark_rapids_tpu_torch/native/build.py. It differs in its
// codecs only: snappy is decoded by snappy_uncompress below instead of
// libsnappy's C++ ABI, and zlib and zstd are linked where found.
//
// The reference's text follows. TPU-native counterpart of the cudf chunked parquet reader the reference
// jar re-exports (SURVEY.md §2.1 #17 feeds the filtered footer to "the cudf
// chunked parquet reader"; BASELINE.json configs[3] "chunked Parquet read →
// filter → project"). The GPU stack decodes pages with CUDA kernels; pages
// are a bitstream format (thrift headers, RLE/bit-packed hybrid levels,
// dictionary indices) that a TPU cannot branch through efficiently, so the
// decode hot path lives here as native host code and hands the TPU dense
// Arrow-layout buffers (values + validity + offsets) ready for device_put.
//
// Scope: flat schemas, standard 3-level LIST<primitive> (Spark array
// columns), STRUCT<primitive> at any nesting depth (validity rebuilt
// from raw def levels), and generalized nesting — MAP, LIST<STRUCT>,
// STRUCT<LIST>, LIST<LIST>, legacy 2-level lists — via kind-4 leaves that
// export raw (def, rep) level streams for host-side Dremel reassembly
// (io/parquet.py); truly exotic shapes are skipped whole, never
// mis-surfaced;
// PLAIN / RLE / PLAIN_DICTIONARY /
// RLE_DICTIONARY / DELTA_BINARY_PACKED / DELTA_LENGTH_BYTE_ARRAY /
// DELTA_BYTE_ARRAY / BYTE_STREAM_SPLIT encodings; DataPage v1+v2;
// UNCOMPRESSED / SNAPPY / GZIP /
// ZSTD codecs. Physical types BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE,
// BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY.
//
// C ABI (ctypes): pqr_open / pqr_* accessors / pqr_read_column / pqr_free.
// Two-phase reads: call with null outputs to size, then with buffers.

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

// The codec libraries are linked only where the build finds them
// (native/build.py passes PQR_HAVE_ZLIB / PQR_HAVE_ZSTD); a page whose
// library is absent raises, naming the codec and the library. Snappy is
// decoded here, on every machine (snappy_uncompress below), so no
// libsnappy and none of its C++ ABI is needed.
#if defined(PQR_HAVE_ZLIB) && __has_include(<zlib.h>)
#include <zlib.h>
#define PQR_ZLIB 1
#endif

#ifdef PQR_HAVE_ZSTD
// libzstd.so.1 may ship without its dev header; the two calls used here
// have a stable C ABI, so declare them when zstd.h is absent.
#if __has_include(<zstd.h>)
#include <zstd.h>
#else
extern "C" {
size_t ZSTD_decompress(void* dst, size_t dst_capacity, void const* src,
                       size_t compressed_size);
unsigned ZSTD_isError(size_t code);
}
#endif
#endif

namespace {

// ---- thrift compact protocol reader (subset) --------------------------------

struct TReader {
  uint8_t const* p;
  uint8_t const* end;

  uint8_t u8() {
    if (p >= end) throw std::runtime_error("thrift: eof");
    return *p++;
  }
  uint64_t uvarint() {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      uint8_t b = u8();
      v |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) throw std::runtime_error("thrift: varint overflow");
    }
  }
  int64_t zigzag() {
    uint64_t u = uvarint();
    return int64_t(u >> 1) ^ -int64_t(u & 1);
  }
  std::string binary() {
    uint64_t n = uvarint();
    if (uint64_t(end - p) < n) throw std::runtime_error("thrift: bad binary");
    std::string s(reinterpret_cast<char const*>(p), n);
    p += n;
    return s;
  }
  void skip(uint8_t type);
  void skip_struct() {
    int16_t fid = 0;
    while (true) {
      uint8_t b = u8();
      if (b == 0) return;
      uint8_t type = b & 0x0f;
      int16_t delta = (b >> 4) & 0x0f;
      fid = delta ? int16_t(fid + delta) : int16_t(zigzag());
      (void)fid;
      skip(type);
    }
  }
};

void TReader::skip(uint8_t type) {
  switch (type) {
    case 1:
    case 2: break;                        // bool true/false in field header
    case 3: u8(); break;                  // i8
    case 4:
    case 5:
    case 6: zigzag(); break;              // i16/i32/i64
    case 7: p += 8; break;                // double
    case 8: binary(); break;              // binary/string
    case 9: {                             // list
      uint8_t b = u8();
      uint64_t n = (b >> 4) & 0x0f;
      uint8_t et = b & 0x0f;
      if (n == 15) n = uvarint();
      for (uint64_t i = 0; i < n; i++) skip(et);
      break;
    }
    case 12: skip_struct(); break;        // struct
    default: throw std::runtime_error("thrift: unsupported type to skip");
  }
}

// iterate a struct's fields: cb(field_id, type, reader) returns true if it
// consumed the value, false to skip
template <typename F>
void read_struct(TReader& r, F&& cb) {
  int16_t fid = 0;
  while (true) {
    uint8_t b = r.u8();
    if (b == 0) return;
    uint8_t type = b & 0x0f;
    int16_t delta = (b >> 4) & 0x0f;
    fid = delta ? int16_t(fid + delta) : int16_t(r.zigzag());
    if (!cb(fid, type, r)) r.skip(type);
  }
}

template <typename F>
void read_list(TReader& r, F&& cb) {
  uint8_t b = r.u8();
  uint64_t n = (b >> 4) & 0x0f;
  uint8_t et = b & 0x0f;
  if (n == 15) n = r.uvarint();
  for (uint64_t i = 0; i < n; i++) cb(et, r);
}

// ---- parquet metadata model -------------------------------------------------

enum PhysType : int32_t {
  PT_BOOLEAN = 0, PT_INT32 = 1, PT_INT64 = 2, PT_INT96 = 3, PT_FLOAT = 4,
  PT_DOUBLE = 5, PT_BYTE_ARRAY = 6, PT_FLBA = 7,
};

struct LeafSchema {
  std::string name;       // dotted path for nested, plain name for flat
  int32_t phys_type = -1;
  int32_t type_length = 0;
  int32_t converted = -1;   // ConvertedType enum (UTF8=0, DATE=6, ...)
  int32_t scale = 0, precision = 0;
  bool optional = false;
  bool flat = true;         // top-level non-repeated primitive
  // repetition/definition structure (Dremel levels)
  int32_t max_def = 0;
  int32_t max_rep = 0;
  int32_t def_at_repeated = 0;  // cumulative def at the repeated node (lists)
  bool is_list = false;         // standard LIST shape: exactly one repeated
                                // ancestor over a primitive leaf
  // non-repeated leaf nested under plain (non-LIST/MAP, non-repeated)
  // groups — a STRUCT member; ancestor_defs[i] is the cumulative def level
  // at the i-th ancestor group (outermost first), or -1 if that group is
  // required (always valid)
  bool is_struct_member = false;
  std::vector<int32_t> ancestor_defs;
  // generalized nested ancestry (MAP, LIST<STRUCT>, STRUCT<LIST>,
  // LIST<LIST>, legacy 2-level lists): 4-int node records outermost first,
  // [type, level_a, level_b, path_segments] where
  //   type 0 STRUCT: level_a = def of the group if optional else -1
  //   type 1 LIST:   level_a = def at the repeated node (dar),
  //                  level_b = def of the (optional) LIST group else -1
  //   type 2 MAP:    like LIST; the leaf path ends in key / value
  // path_segments = how many dotted path segments the node consumes.
  bool nested_ok = false;
  std::vector<int32_t> anc_desc;
};

struct ChunkMeta {
  int32_t schema_idx = -1;  // into leaves
  int32_t codec = 0;
  int64_t num_values = 0;
  int64_t data_page_offset = -1;
  int64_t dict_page_offset = -1;
  int64_t total_compressed_size = 0;
};

struct RowGroup {
  int64_t num_rows = 0;
  std::vector<ChunkMeta> chunks;
};

struct DecodedChunk;

struct FileState {
  // non-owning view by default (zero-copy: Python keeps the mmap/bytes
  // alive for the handle's lifetime); `owned` is used by the copying open
  std::vector<uint8_t> owned;
  uint8_t const* data_ptr = nullptr;
  size_t data_len = 0;
  std::vector<LeafSchema> leaves;
  std::vector<RowGroup> groups;
  int64_t num_rows = 0;
  // sizing-phase decode results, consumed by the fill phase so each chunk
  // is decompressed+decoded exactly once
  std::map<std::pair<int32_t, int32_t>, std::shared_ptr<DecodedChunk>> cache;
  std::mutex cache_mu;
};

thread_local std::string g_error;

void parse_schema(TReader& r, std::vector<LeafSchema>& leaves) {
  // list<SchemaElement>; element 0 is the root group
  struct Elem {
    LeafSchema leaf;
    int32_t num_children = 0;
    int32_t repetition = 0;
    bool is_group = false;
  };
  std::vector<Elem> elems;
  read_list(r, [&](uint8_t, TReader& rr) {
    Elem e;
    bool has_type = false;
    read_struct(rr, [&](int16_t fid, uint8_t type, TReader& r3) {
      switch (fid) {
        case 1: e.leaf.phys_type = int32_t(r3.zigzag()); has_type = true; return true;
        case 2: e.leaf.type_length = int32_t(r3.zigzag()); return true;
        case 3: e.repetition = int32_t(r3.zigzag()); return true;
        case 4: e.leaf.name = r3.binary(); return true;
        case 5: e.num_children = int32_t(r3.zigzag()); return true;
        case 6: e.leaf.converted = int32_t(r3.zigzag()); return true;
        case 7: e.leaf.scale = int32_t(r3.zigzag()); return true;
        case 8: e.leaf.precision = int32_t(r3.zigzag()); return true;
        default: (void)type; return false;
      }
    });
    e.is_group = !has_type;
    elems.push_back(std::move(e));
  });
  if (elems.empty()) throw std::runtime_error("parquet: empty schema");
  // depth-first walk tracking Dremel levels: optional adds a definition
  // level, repeated adds one definition AND one repetition level. Parent
  // indices are recorded so the LIST-shape check below can inspect the
  // exact ancestry (a lone max_rep==1 test would also match MAP leaves,
  // LIST<STRUCT> members and STRUCT<LIST> fields).
  size_t pos = 1;
  struct Frame {
    int32_t remaining;
    int32_t def_level, rep_level;
    int32_t def_at_repeated;   // def at the innermost repeated ancestor
    std::string path;
    int32_t elem_idx;          // index into elems (-1 for root)
    int depth;
    bool plain_chain;          // every ancestor is a non-repeated,
                               // non-annotated group (STRUCT nesting)
    std::vector<int32_t> opt_ancestor_defs;
  };
  std::vector<Frame> stack{{elems[0].num_children, 0, 0, -1, "", 0, 0,
                            true, {}}};
  while (pos < elems.size() && !stack.empty()) {
    while (!stack.empty() && stack.back().remaining == 0) stack.pop_back();
    if (stack.empty()) break;
    stack.back().remaining--;
    Elem& e = elems[pos++];
    size_t const cur_idx = pos - 1;
    Frame const& top = stack.back();
    int depth = int(stack.size());
    int32_t def = top.def_level + (e.repetition != 0 ? 1 : 0);
    int32_t rep = top.rep_level + (e.repetition == 2 ? 1 : 0);
    int32_t dar = (e.repetition == 2) ? def : top.def_at_repeated;
    std::string path =
        top.path.empty() ? e.leaf.name : top.path + "." + e.leaf.name;
    if (e.is_group) {
      bool plain = top.plain_chain && e.repetition != 2 &&
                   e.leaf.converted != 1 && e.leaf.converted != 2 &&
                   e.leaf.converted != 3;   // not MAP/MAP_KEY_VALUE/LIST
      auto anc = top.opt_ancestor_defs;
      // one entry per ancestor group: its def level if optional, -1 if
      // required (always-valid) — index-aligned with the path segments
      anc.push_back(e.repetition == 1 ? def : -1);
      stack.push_back({e.num_children, def, rep, dar, path,
                       int32_t(cur_idx), depth, plain, std::move(anc)});
    } else {
      LeafSchema leaf = e.leaf;
      leaf.name = path;
      leaf.optional = e.repetition == 1;   // 0 required, 1 optional, 2 repeated
      leaf.flat = depth == 1 && e.repetition != 2;
      leaf.max_def = def;
      leaf.max_rep = rep;
      leaf.def_at_repeated = dar;
      // standard 3-level LIST over a primitive, and nothing else: the direct
      // parent is the repeated group with this leaf as its only child, the
      // grandparent is a top-level single-child group annotated LIST
      // (ConvertedType LIST == 3); MAP key_value groups (2 children) and
      // LIST<STRUCT> (parent is a struct group) fail these tests
      leaf.is_list = false;
      leaf.is_struct_member =
          depth > 1 && rep == 0 && e.repetition != 2 && top.plain_chain;
      if (leaf.is_struct_member) leaf.ancestor_defs = top.opt_ancestor_defs;
      if (rep == 1 && e.repetition != 2 && stack.size() >= 3) {
        Frame const& parent = stack[stack.size() - 1];
        Frame const& grand = stack[stack.size() - 2];
        Elem const& pe = elems[size_t(parent.elem_idx)];
        Elem const& ge = elems[size_t(grand.elem_idx)];
        leaf.is_list = pe.repetition == 2 && pe.num_children == 1 &&
                       grand.depth == 1 && ge.num_children == 1 &&
                       ge.leaf.converted == 3 && ge.repetition != 2;
      }
      // Generalized ancestry (the kind-4 decode path): fold the group chain
      // into STRUCT / LIST / MAP nodes per the parquet LogicalTypes
      // backward-compat rules. Anything that doesn't fold stays kind 3.
      {
        std::vector<int32_t> desc;
        bool ok = true;
        size_t j = 1;
        while (j < stack.size()) {
          Frame const& fr = stack[j];
          Elem const& E = elems[size_t(fr.elem_idx)];
          bool const is_rep = E.repetition == 2;
          bool const annot_list = E.leaf.converted == 3;
          bool const annot_map = E.leaf.converted == 1 || E.leaf.converted == 2;
          bool const next_rep =
              j + 1 < stack.size() &&
              elems[size_t(stack[j + 1].elem_idx)].repetition == 2;
          if (!is_rep && annot_map && next_rep) {
            // MAP group + repeated key_value group (2 children: key, value)
            int32_t null_def = E.repetition == 1 ? fr.def_level : -1;
            desc.insert(desc.end(),
                        {2, stack[j + 1].def_level, null_def, 2});
            j += 2;
          } else if (!is_rep && annot_list && next_rep) {
            Elem const& R = elems[size_t(stack[j + 1].elem_idx)];
            int32_t null_def = E.repetition == 1 ? fr.def_level : -1;
            desc.insert(desc.end(),
                        {1, stack[j + 1].def_level, null_def, 2});
            j += 2;
            if (R.num_children > 1) {
              // legacy: the repeated group IS the element struct — members
              // hang directly off it (no extra path segment, never null)
              desc.insert(desc.end(), {0, -1, -1, 0});
            }
          } else if (is_rep) {
            // bare repeated group (legacy 2-level list); the group is the
            // element when it has several children
            desc.insert(desc.end(), {1, fr.def_level, -1, 1});
            if (E.num_children > 1) desc.insert(desc.end(), {0, -1, -1, 0});
            j += 1;
          } else if (!annot_list && !annot_map) {
            // plain struct group
            int32_t opt = E.repetition == 1 ? fr.def_level : -1;
            desc.insert(desc.end(), {0, opt, -1, 1});
            j += 1;
          } else {
            ok = false;   // annotated group without its repeated child
            break;
          }
        }
        if (e.repetition == 2) {
          // repeated primitive leaf: legacy 2-level LIST of the value
          desc.insert(desc.end(), {1, def, -1, 0});
        }
        leaf.nested_ok = ok && rep >= 1 && rep <= 4 && !desc.empty();
        leaf.anc_desc = std::move(desc);
      }
      leaves.push_back(std::move(leaf));
    }
  }
}

void parse_footer(FileState& st) {
  uint8_t const* d = st.data_ptr;
  size_t sz = st.data_len;
  if (sz < 12 || std::memcmp(d + sz - 4, "PAR1", 4) != 0)
    throw std::runtime_error("parquet: bad magic");
  uint32_t flen;
  std::memcpy(&flen, d + sz - 8, 4);
  if (flen + 12ull > sz)
    throw std::runtime_error("parquet: footer length out of range");
  TReader r{d + sz - 8 - flen, d + sz - 8};

  read_struct(r, [&](int16_t fid, uint8_t type, TReader& rr) {
    if (fid == 2 && type == 9) {          // schema
      parse_schema(rr, st.leaves);
      return true;
    }
    if (fid == 3) { st.num_rows = rr.zigzag(); return true; }
    if (fid == 4 && type == 9) {          // row_groups
      read_list(rr, [&](uint8_t, TReader& r2) {
        RowGroup rg;
        read_struct(r2, [&](int16_t f2, uint8_t t2, TReader& r3) {
          if (f2 == 1 && t2 == 9) {       // columns: list<ColumnChunk>
            read_list(r3, [&](uint8_t, TReader& r4) {
              ChunkMeta cm;
              read_struct(r4, [&](int16_t f4, uint8_t t4, TReader& r5) {
                if (f4 == 3 && t4 == 12) {  // meta_data: ColumnMetaData
                  std::string path;
                  read_struct(r5, [&](int16_t f5, uint8_t t5, TReader& r6) {
                    switch (f5) {
                      case 3:  // path_in_schema: list<string>
                        if (t5 == 9) {
                          read_list(r6, [&](uint8_t, TReader& r7) {
                            if (!path.empty()) path += '.';
                            path += r7.binary();
                          });
                          return true;
                        }
                        return false;
                      case 4: cm.codec = int32_t(r6.zigzag()); return true;
                      case 5: cm.num_values = r6.zigzag(); return true;
                      case 7: cm.total_compressed_size = r6.zigzag(); return true;
                      case 9: cm.data_page_offset = r6.zigzag(); return true;
                      case 11: cm.dict_page_offset = r6.zigzag(); return true;
                      default: return false;
                    }
                  });
                  // match path to a leaf
                  for (size_t i = 0; i < st.leaves.size(); i++) {
                    if (st.leaves[i].name == path) {
                      cm.schema_idx = int32_t(i);
                      break;
                    }
                  }
                  return true;
                }
                return false;
              });
              rg.chunks.push_back(cm);
            });
            return true;
          }
          if (f2 == 3) { rg.num_rows = r3.zigzag(); return true; }
          return false;
        });
        st.groups.push_back(std::move(rg));
      });
      return true;
    }
    return false;
  });
}

// ---- page decode ------------------------------------------------------------

enum Codec : int32_t {
  C_UNCOMPRESSED = 0, C_SNAPPY = 1, C_GZIP = 2, C_ZSTD = 6,
};

// Snappy's raw block format (format_description.txt in the snappy
// sources): a varint of the uncompressed length, then elements whose tag
// byte's low two bits say literal (00), or copy with a 1-byte (01), 2-byte
// (10) or 4-byte (11) offset. Every length and offset is checked against
// both buffers; a copy may overlap its own output (a run), so it goes
// byte by byte.
void snappy_uncompress(uint8_t const* in, size_t n, uint8_t* out,
                       size_t out_size) {
  size_t ip = 0;
  uint64_t len = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= n || shift > 28)
      throw std::runtime_error("parquet: snappy length varint is corrupt");
    uint8_t b = in[ip++];
    len |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
  }
  if (len != out_size)
    throw std::runtime_error("parquet: snappy length does not match the "
                             "page header");
  size_t op = 0;
  while (ip < n) {
    uint8_t tag = in[ip++];
    size_t length, offset;
    switch (tag & 3) {
      case 0: {
        length = (tag >> 2) + 1;
        if (length > 60) {
          size_t extra = length - 60;  // 1-4 little-endian length bytes
          if (ip + extra > n)
            throw std::runtime_error("parquet: snappy literal is cut");
          size_t v = 0;
          for (size_t k = 0; k < extra; ++k) v |= size_t(in[ip + k]) << (8 * k);
          ip += extra;
          length = v + 1;
        }
        if (length > n - ip || length > out_size - op)
          throw std::runtime_error("parquet: snappy literal overruns");
        std::memcpy(out + op, in + ip, length);
        ip += length;
        op += length;
        continue;
      }
      case 1:
        if (ip + 1 > n) throw std::runtime_error("parquet: snappy copy is cut");
        length = 4 + ((tag >> 2) & 7);
        offset = (size_t(tag >> 5) << 8) | in[ip];
        ip += 1;
        break;
      case 2:
        if (ip + 2 > n) throw std::runtime_error("parquet: snappy copy is cut");
        length = 1 + (tag >> 2);
        offset = size_t(in[ip]) | (size_t(in[ip + 1]) << 8);
        ip += 2;
        break;
      default:
        if (ip + 4 > n) throw std::runtime_error("parquet: snappy copy is cut");
        length = 1 + (tag >> 2);
        offset = size_t(in[ip]) | (size_t(in[ip + 1]) << 8) |
                 (size_t(in[ip + 2]) << 16) | (size_t(in[ip + 3]) << 24);
        ip += 4;
        break;
    }
    if (offset == 0 || offset > op || length > out_size - op)
      throw std::runtime_error("parquet: snappy copy is out of range");
    for (size_t k = 0; k < length; ++k) out[op + k] = out[op + k - offset];
    op += length;
  }
  if (op != out_size)
    throw std::runtime_error("parquet: snappy output is short");
}

std::vector<uint8_t> decompress(int32_t codec, uint8_t const* in, size_t n,
                                size_t out_size) {
  std::vector<uint8_t> out(out_size);
  switch (codec) {
    case C_UNCOMPRESSED:
      if (n != out_size) throw std::runtime_error("parquet: size mismatch");
      std::memcpy(out.data(), in, n);
      return out;
    case C_SNAPPY:
      snappy_uncompress(in, n, out.data(), out_size);
      return out;
    case C_GZIP: {
#ifdef PQR_ZLIB
      z_stream zs{};
      if (inflateInit2(&zs, 15 + 32) != Z_OK)  // zlib or gzip stream
        throw std::runtime_error("parquet: zlib init failed");
      zs.next_in = const_cast<Bytef*>(in);
      zs.avail_in = uInt(n);
      zs.next_out = out.data();
      zs.avail_out = uInt(out_size);
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END || zs.total_out != out_size)
        throw std::runtime_error("parquet: gzip decode failed");
      return out;
#else
      throw std::runtime_error(
          "parquet: a GZIP page needs libz (zlib.h and libz.so.1), which "
          "this build did not find");
#endif
    }
    case C_ZSTD: {
#ifdef PQR_HAVE_ZSTD
      size_t rc = ZSTD_decompress(out.data(), out_size, in, n);
      if (ZSTD_isError(rc) || rc != out_size)
        throw std::runtime_error("parquet: zstd decode failed");
      return out;
#else
      throw std::runtime_error(
          "parquet: a ZSTD page needs libzstd.so.1, which this build did "
          "not find");
#endif
    }
    default:
      throw std::runtime_error("parquet: unsupported codec " +
                               std::to_string(codec));
  }
}

// RLE / bit-packed hybrid (parquet format §RLE). Decodes `count` values of
// `bit_width` into out.
void rle_decode(uint8_t const* p, uint8_t const* end, int bit_width,
                int64_t count, int32_t* out) {
  if (bit_width < 0 || bit_width > 32)   // file-supplied: must be validated
    throw std::runtime_error("parquet: bad RLE bit width " +
                             std::to_string(bit_width));
  if (bit_width == 0) {
    std::fill(out, out + count, 0);
    return;
  }
  int byte_width = (bit_width + 7) / 8;
  int64_t got = 0;
  while (got < count) {
    if (p >= end) throw std::runtime_error("parquet: rle eof");
    uint64_t header = 0;
    int shift = 0;
    while (true) {
      if (p >= end) throw std::runtime_error("parquet: rle eof");
      uint8_t b = *p++;
      header |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if (header & 1) {                       // bit-packed run
      int64_t groups = int64_t(header >> 1);
      int64_t nvals = groups * 8;
      int64_t nbytes = groups * bit_width;
      if (end - p < nbytes) throw std::runtime_error("parquet: rle eof");
      int64_t take = std::min(nvals, count - got);
      uint64_t mask = (bit_width == 32) ? 0xffffffffull
                                        : ((1ull << bit_width) - 1);
      uint64_t buf = 0;
      int bits_in = 0;
      uint8_t const* q = p;
      for (int64_t i = 0; i < take; i++) {
        while (bits_in < bit_width) {
          buf |= uint64_t(*q++) << bits_in;
          bits_in += 8;
        }
        out[got + i] = int32_t(buf & mask);
        buf >>= bit_width;
        bits_in -= bit_width;
      }
      p += nbytes;
      got += take;
    } else {                                // rle run
      int64_t run = int64_t(header >> 1);
      if (end - p < byte_width) throw std::runtime_error("parquet: rle eof");
      uint32_t v = 0;
      std::memcpy(&v, p, byte_width);       // byte_width <= 4 (bit_width<=32)
      p += byte_width;
      int64_t take = std::min(run, count - got);
      std::fill(out + got, out + got + take, int32_t(v));
      got += take;
    }
  }
}

// ---- DELTA encodings (parquet format Delta*.md; written by parquet-mr v2
// pages, e.g. Spark with parquet.writer.version=v2) ----------------------

// raw LSB-first bit-unpack (miniblock payload; not the RLE-hybrid form)
// `avail` = bytes readable from base; the 8-byte fast path is only taken
// when the full word load stays inside the buffer (a miniblock can end at
// the very end of a caller-borrowed mmap)
inline uint64_t read_bits_at(uint8_t const* base, uint64_t avail,
                             uint64_t bit_off, int w) {
  int const shift = int(bit_off & 7);
  uint64_t const byte0 = bit_off >> 3;
  if (w + shift <= 64 && byte0 + 8 <= avail) {
    uint64_t word;
    std::memcpy(&word, base + byte0, 8);
    uint64_t mask = (w == 64) ? ~uint64_t(0) : ((uint64_t(1) << w) - 1);
    return (word >> shift) & mask;
  }
  uint64_t v = 0;
  for (int b = 0; b < w; b++) {
    uint64_t bit = bit_off + b;
    v |= uint64_t((base[bit >> 3] >> (bit & 7)) & 1) << b;
  }
  return v;
}

// DELTA_BINARY_PACKED: <block_size><miniblocks/block><total><first zigzag>
// then per block: <min_delta zigzag><bit widths><packed miniblocks>.
// Values accumulate mod 2^64 (unsigned wrap is the spec'd behavior).
void delta_binary_unpack(uint8_t const*& pp, uint8_t const* end,
                         std::vector<int64_t>& vals) {
  TReader r{pp, end};
  uint64_t block_size = r.uvarint();
  uint64_t mb_per_block = r.uvarint();
  uint64_t total = r.uvarint();
  int64_t first = r.zigzag();
  if (mb_per_block == 0 || block_size == 0 || block_size % mb_per_block ||
      (block_size / mb_per_block) % 8)
    throw std::runtime_error("parquet: bad delta header");
  uint64_t per_mb = block_size / mb_per_block;
  // per_mb * 64 bits must not overflow the byte-size computation below —
  // a crafted header could otherwise wrap nbytes to 0 and pass the bounds
  // check (real writers use per_mb <= a few thousand)
  if (per_mb > (UINT64_MAX - 7) / 64)
    throw std::runtime_error("parquet: bad delta header");
  // clamp the reserve by the input size: a crafted header's total could
  // otherwise request a terabyte allocation from a 20-byte page
  vals.reserve(vals.size() +
               size_t(std::min<uint64_t>(total, uint64_t(end - r.p) * 8 + 1)));
  uint64_t produced = 0;
  uint64_t cur = uint64_t(first);
  if (total) { vals.push_back(first); produced = 1; }
  std::vector<uint8_t> widths(mb_per_block);
  while (produced < total) {
    int64_t min_delta = r.zigzag();
    if (uint64_t(end - r.p) < mb_per_block)
      throw std::runtime_error("parquet: delta eof");
    for (uint64_t m = 0; m < mb_per_block; m++) widths[m] = *r.p++;
    for (uint64_t m = 0; m < mb_per_block && produced < total; m++) {
      int w = widths[m];
      if (w > 64) throw std::runtime_error("parquet: bad delta bit width");
      uint64_t nbytes = (per_mb * uint64_t(w) + 7) / 8;
      if (uint64_t(end - r.p) < nbytes)
        throw std::runtime_error("parquet: delta eof");
      for (uint64_t i = 0; i < per_mb && produced < total; i++) {
        uint64_t packed =
            w ? read_bits_at(r.p, uint64_t(end - r.p), i * uint64_t(w), w) : 0;
        cur += uint64_t(min_delta) + packed;
        vals.push_back(int64_t(cur));
        produced++;
      }
      r.p += nbytes;
    }
  }
  pp = r.p;
}





struct PageHeader {
  int32_t type = -1;          // 0 data, 2 dictionary, 3 data_v2
  int32_t uncompressed_size = 0;
  int32_t compressed_size = 0;
  // v1 data page
  int32_t num_values = 0;
  int32_t encoding = -1;
  int32_t def_encoding = -1;
  // v2
  int32_t num_nulls = 0;
  int32_t num_rows = 0;
  int32_t def_len = 0, rep_len = 0;
  bool v2_compressed = true;
  // dictionary page
  int32_t dict_num_values = 0;
  int32_t dict_encoding = -1;
};

PageHeader read_page_header(TReader& r) {
  PageHeader h;
  read_struct(r, [&](int16_t fid, uint8_t type, TReader& rr) {
    switch (fid) {
      case 1: h.type = int32_t(rr.zigzag()); return true;
      case 2: h.uncompressed_size = int32_t(rr.zigzag()); return true;
      case 3: h.compressed_size = int32_t(rr.zigzag()); return true;
      case 5:                                   // DataPageHeader
        if (type == 12) {
          read_struct(rr, [&](int16_t f2, uint8_t, TReader& r2) {
            switch (f2) {
              case 1: h.num_values = int32_t(r2.zigzag()); return true;
              case 2: h.encoding = int32_t(r2.zigzag()); return true;
              case 3: h.def_encoding = int32_t(r2.zigzag()); return true;
              default: return false;
            }
          });
          return true;
        }
        return false;
      case 7:                                   // DictionaryPageHeader
        if (type == 12) {
          read_struct(rr, [&](int16_t f2, uint8_t, TReader& r2) {
            switch (f2) {
              case 1: h.dict_num_values = int32_t(r2.zigzag()); return true;
              case 2: h.dict_encoding = int32_t(r2.zigzag()); return true;
              default: return false;
            }
          });
          return true;
        }
        return false;
      case 8:                                   // DataPageHeaderV2
        if (type == 12) {
          h.type = 3;
          read_struct(rr, [&](int16_t f2, uint8_t t2, TReader& r2) {
            switch (f2) {
              case 1: h.num_values = int32_t(r2.zigzag()); return true;
              case 2: h.num_nulls = int32_t(r2.zigzag()); return true;
              case 3: h.num_rows = int32_t(r2.zigzag()); return true;
              case 4: h.encoding = int32_t(r2.zigzag()); return true;
              case 5: h.def_len = int32_t(r2.zigzag()); return true;
              case 6: h.rep_len = int32_t(r2.zigzag()); return true;
              case 7: h.v2_compressed = t2 == 1; return true;
              default: return false;
            }
          });
          return true;
        }
        return false;
      default: return false;
    }
  });
  return h;
}

// decoded column chunk, pre-binding into Arrow layout
struct DecodedChunk {
  std::vector<uint8_t> values;    // fixed width: num_valid * width; strings: chars
  std::vector<int32_t> lengths;   // strings: per present value
  std::vector<uint8_t> defined;   // per row (flat) / per element slot (list)
  int64_t num_rows = 0;           // rows (rep==0 entries for list chunks)
  // list chunks only (leaf.is_list):
  std::vector<int32_t> list_counts;  // element slots per row
  std::vector<uint8_t> list_valid;   // per-row list validity
  // struct members only: raw definition level per row (<= max_def <= 255)
  std::vector<uint8_t> def_levels;
  // generalized nested chunks (kind 4) only: raw repetition level per slot,
  // aligned with def_levels; Python does the multi-level Dremel reassembly
  std::vector<uint8_t> rep_levels;
};

inline int level_bit_width(int32_t max_level) {
  int w = 0;
  while ((1 << w) <= max_level) w++;   // values 0..max_level
  return max_level ? w : 0;
}

struct Dict {
  std::vector<uint8_t> fixed;     // fixed-width values
  std::vector<std::string> binary;
  int64_t count = 0;
};

int phys_width(int32_t pt, int32_t type_length) {
  switch (pt) {
    case PT_INT32: case PT_FLOAT: return 4;
    case PT_INT64: case PT_DOUBLE: return 8;
    case PT_INT96: return 12;
    case PT_FLBA: return type_length;
    default: return -1;
  }
}

void decode_plain(int32_t pt, int32_t type_length, uint8_t const* p,
                  uint8_t const* end, int64_t count, DecodedChunk& out) {
  if (pt == PT_BOOLEAN) {
    for (int64_t i = 0; i < count; i++) {
      int64_t bit = i;
      if (p + bit / 8 >= end) throw std::runtime_error("parquet: plain eof");
      out.values.push_back((p[bit / 8] >> (bit % 8)) & 1);
    }
    return;
  }
  if (pt == PT_BYTE_ARRAY) {
    for (int64_t i = 0; i < count; i++) {
      if (end - p < 4) throw std::runtime_error("parquet: plain eof");
      uint32_t n;
      std::memcpy(&n, p, 4);
      p += 4;
      if (uint64_t(end - p) < n) throw std::runtime_error("parquet: plain eof");
      out.values.insert(out.values.end(), p, p + n);
      out.lengths.push_back(int32_t(n));
      p += n;
    }
    return;
  }
  int w = phys_width(pt, type_length);
  if (w <= 0) throw std::runtime_error("parquet: bad type width");
  if (end - p < count * w) throw std::runtime_error("parquet: plain eof");
  out.values.insert(out.values.end(), p, p + count * w);
}

void decode_delta_binary(int32_t pt, uint8_t const* p, uint8_t const* end,
                         int64_t count, DecodedChunk& out) {
  if (pt != PT_INT32 && pt != PT_INT64)
    throw std::runtime_error("parquet: DELTA_BINARY_PACKED on non-int");
  std::vector<int64_t> vals;
  delta_binary_unpack(p, end, vals);
  if (int64_t(vals.size()) < count)
    throw std::runtime_error("parquet: delta value count short");
  if (pt == PT_INT32) {
    std::vector<int32_t> narrow(static_cast<size_t>(count));
    for (int64_t i = 0; i < count; i++) narrow[size_t(i)] = int32_t(vals[size_t(i)]);
    auto const* b = reinterpret_cast<uint8_t const*>(narrow.data());
    out.values.insert(out.values.end(), b, b + size_t(count) * 4);
  } else {
    auto const* b = reinterpret_cast<uint8_t const*>(vals.data());
    out.values.insert(out.values.end(), b, b + size_t(count) * 8);
  }
}

// BYTE_STREAM_SPLIT: w byte-streams of `count` bytes; byte j of value i
// lives at stream j offset i (improves float compressibility)
void decode_byte_stream_split(int32_t pt, int32_t type_length,
                              uint8_t const* p, uint8_t const* end,
                              int64_t count, DecodedChunk& out) {
  int w = phys_width(pt, type_length);
  if (w <= 0)
    throw std::runtime_error("parquet: BYTE_STREAM_SPLIT on variable type");
  if (end - p < count * w)
    throw std::runtime_error("parquet: byte-stream-split eof");
  size_t off = out.values.size();
  out.values.resize(off + size_t(count) * size_t(w));
  for (int j = 0; j < w; j++)
    for (int64_t i = 0; i < count; i++)
      out.values[off + size_t(i) * w + j] = p[size_t(j) * count + size_t(i)];
}

// DELTA_LENGTH_BYTE_ARRAY: delta-packed lengths, then concatenated bytes
void decode_delta_length_byte_array(int32_t pt, uint8_t const* p,
                                    uint8_t const* end, int64_t count,
                                    DecodedChunk& out) {
  if (pt != PT_BYTE_ARRAY)
    throw std::runtime_error("parquet: DELTA_LENGTH_BYTE_ARRAY on non-binary");
  std::vector<int64_t> lens;
  delta_binary_unpack(p, end, lens);
  if (int64_t(lens.size()) < count)
    throw std::runtime_error("parquet: delta length count short");
  for (int64_t i = 0; i < count; i++) {
    int64_t n = lens[size_t(i)];
    if (n < 0 || end - p < n)
      throw std::runtime_error("parquet: delta bytes eof");
    out.values.insert(out.values.end(), p, p + n);
    out.lengths.push_back(int32_t(n));
    p += n;
  }
}

// DELTA_BYTE_ARRAY: prefix lengths + suffix lengths (both delta-packed),
// then concatenated suffixes; value = previous[:prefix] + suffix
void decode_delta_byte_array(int32_t pt, int32_t type_length,
                             uint8_t const* p, uint8_t const* end,
                             int64_t count, DecodedChunk& out) {
  if (pt != PT_BYTE_ARRAY && pt != PT_FLBA)
    throw std::runtime_error("parquet: DELTA_BYTE_ARRAY on non-binary");
  std::vector<int64_t> prefix, suffix;
  delta_binary_unpack(p, end, prefix);
  delta_binary_unpack(p, end, suffix);
  if (int64_t(prefix.size()) < count || int64_t(suffix.size()) < count)
    throw std::runtime_error("parquet: delta byte-array count short");
  // previous value tracked as an (offset, length) view into out.values:
  // values are appended contiguously, so no temporary strings are needed
  size_t prev_off = out.values.size();
  int64_t prev_len = 0;
  for (int64_t i = 0; i < count; i++) {
    int64_t pl = prefix[size_t(i)], sl = suffix[size_t(i)];
    if (pl < 0 || sl < 0 || pl > prev_len || end - p < sl)
      throw std::runtime_error("parquet: delta byte-array eof");
    size_t off = out.values.size();
    out.values.resize(off + size_t(pl) + size_t(sl));
    // self-referential copy: resize may reallocate, so index after resize
    std::memcpy(out.values.data() + off, out.values.data() + prev_off,
                size_t(pl));
    std::memcpy(out.values.data() + off + size_t(pl), p, size_t(sl));
    p += sl;
    if (pt == PT_FLBA && pl + sl != int64_t(type_length))
      // a fixed-width column's values buffer is consumed as count*width
      // bytes downstream; one short value would silently shift every
      // later value
      throw std::runtime_error("parquet: delta FLBA length mismatch");
    out.lengths.push_back(int32_t(pl + sl));
    prev_off = off;
    prev_len = pl + sl;
  }
}

void load_dict(int32_t pt, int32_t type_length, uint8_t const* p,
               uint8_t const* end, int64_t count, Dict& dict) {
  dict.count = count;
  if (pt == PT_BYTE_ARRAY) {
    for (int64_t i = 0; i < count; i++) {
      if (end - p < 4) throw std::runtime_error("parquet: dict eof");
      uint32_t n;
      std::memcpy(&n, p, 4);
      p += 4;
      if (uint64_t(end - p) < n) throw std::runtime_error("parquet: dict eof");
      dict.binary.emplace_back(reinterpret_cast<char const*>(p), n);
      p += n;
    }
  } else {
    int w = phys_width(pt, type_length);
    if (w <= 0) throw std::runtime_error("parquet: dict on bad type");
    if (end - p < count * w) throw std::runtime_error("parquet: dict eof");
    dict.fixed.assign(p, p + count * w);
  }
}

void decode_dict_indices(int32_t pt, int32_t type_length, Dict const& dict,
                         uint8_t const* p, uint8_t const* end, int64_t count,
                         DecodedChunk& out) {
  if (p >= end) {
    if (count == 0) return;
    throw std::runtime_error("parquet: dict page eof");
  }
  int bw = *p++;  // leading bit width byte
  std::vector<int32_t> idx(count);
  rle_decode(p, end, bw, count, idx.data());
  if (pt == PT_BYTE_ARRAY) {
    for (int64_t i = 0; i < count; i++) {
      if (idx[i] < 0 || idx[i] >= dict.count)
        throw std::runtime_error("parquet: dict index out of range");
      auto const& s = dict.binary[idx[i]];
      out.values.insert(out.values.end(), s.begin(), s.end());
      out.lengths.push_back(int32_t(s.size()));
    }
  } else {
    int w = (pt == PT_BOOLEAN) ? 1 : phys_width(pt, type_length);
    for (int64_t i = 0; i < count; i++) {
      if (idx[i] < 0 || idx[i] >= dict.count)
        throw std::runtime_error("parquet: dict index out of range");
      out.values.insert(out.values.end(), dict.fixed.begin() + idx[i] * w,
                        dict.fixed.begin() + (idx[i] + 1) * w);
    }
  }
}

DecodedChunk decode_chunk(FileState const& st, ChunkMeta const& cm,
                          LeafSchema const& leaf) {
  DecodedChunk out;
  Dict dict;
  bool have_dict = false;
  int64_t remaining = cm.num_values;

  int64_t pos = cm.dict_page_offset >= 0 &&
                        cm.dict_page_offset < cm.data_page_offset
                    ? cm.dict_page_offset
                    : cm.data_page_offset;
  uint8_t const* base = st.data_ptr;
  uint8_t const* file_end = base + st.data_len;

  while (remaining > 0) {
    if (base + pos >= file_end) throw std::runtime_error("parquet: chunk eof");
    TReader hr{base + pos, file_end};
    PageHeader h = read_page_header(hr);
    uint8_t const* body = hr.p;
    if (file_end - body < h.compressed_size)
      throw std::runtime_error("parquet: page body eof");
    pos = (body - base) + h.compressed_size;

    if (h.type == 2) {                      // dictionary page
      auto plain = decompress(cm.codec, body, size_t(h.compressed_size),
                              size_t(h.uncompressed_size));
      load_dict(leaf.phys_type, leaf.type_length, plain.data(),
                plain.data() + plain.size(), h.dict_num_values, dict);
      have_dict = true;
      continue;
    }

    std::vector<int32_t> defs;
    std::vector<int32_t> reps;
    std::vector<uint8_t> plain;
    uint8_t const* vp;
    uint8_t const* vend;
    int64_t page_values = h.num_values;
    int const bw_def = level_bit_width(leaf.max_def);
    int const bw_rep = level_bit_width(leaf.max_rep);

    if (h.type == 0) {                      // data page v1
      plain = decompress(cm.codec, body, size_t(h.compressed_size),
                         size_t(h.uncompressed_size));
      uint8_t const* p = plain.data();
      uint8_t const* pe = p + plain.size();
      auto v1_levels = [&](int bw, std::vector<int32_t>& out_levels) {
        if (pe - p < 4) throw std::runtime_error("parquet: level eof");
        uint32_t dl;
        std::memcpy(&dl, p, 4);
        p += 4;
        if (uint64_t(pe - p) < dl) throw std::runtime_error("parquet: level eof");
        out_levels.resize(page_values);
        rle_decode(p, p + dl, bw, page_values, out_levels.data());
        p += dl;
      };
      if (bw_rep) v1_levels(bw_rep, reps);   // rep levels precede def levels
      if (bw_def) v1_levels(bw_def, defs);
      vp = p;
      vend = pe;
    } else if (h.type == 3) {               // data page v2
      uint8_t const* p = body;
      if (h.rep_len < 0 || h.def_len < 0 ||
          int64_t(h.rep_len) + h.def_len > h.compressed_size)
        throw std::runtime_error("parquet: bad v2 level lengths");
      if (h.rep_len) {
        if (!bw_rep)
          throw std::runtime_error("parquet: unexpected repetition levels");
        reps.resize(page_values);
        rle_decode(p, p + h.rep_len, bw_rep, page_values, reps.data());
      }
      if (h.def_len) {
        defs.resize(page_values);
        rle_decode(p + h.rep_len, p + h.rep_len + h.def_len, bw_def,
                   page_values, defs.data());
      }
      p += h.def_len + h.rep_len;
      int64_t data_comp = h.compressed_size - h.def_len - h.rep_len;
      int64_t data_un = h.uncompressed_size - h.def_len - h.rep_len;
      if (h.v2_compressed && cm.codec != C_UNCOMPRESSED) {
        plain = decompress(cm.codec, p, size_t(data_comp), size_t(data_un));
        vp = plain.data();
        vend = plain.data() + plain.size();
      } else {
        vp = p;
        vend = p + data_un;
      }
    } else {
      continue;                             // index or unknown page: skip
    }

    int64_t present = page_values;
    int64_t page_rows = page_values;
    if (leaf.is_list) {
      // Dremel reassembly, one repeated level: rep==0 starts a row;
      // def >= def_at_repeated means an element slot exists; def == max_def
      // means the element is non-null; def == def_at_repeated-1 is an empty
      // list; lower means the list (or an outer optional) is null
      if (defs.empty() || reps.empty())
        throw std::runtime_error("parquet: list page missing levels");
      int32_t const dar = leaf.def_at_repeated;
      present = 0;
      page_rows = 0;
      for (int64_t i = 0; i < page_values; i++) {
        if (reps[i] == 0) {
          page_rows++;
          out.list_counts.push_back(0);
          out.list_valid.push_back(uint8_t(defs[i] >= dar - 1));
        }
        if (out.list_counts.empty())
          throw std::runtime_error("parquet: page starts mid-row");
        if (defs[i] >= dar) {
          out.list_counts.back()++;
          bool def_full = defs[i] == leaf.max_def;
          out.defined.push_back(uint8_t(def_full));
          if (def_full) present++;
        }
      }
    } else if (leaf.nested_ok && !leaf.flat && !leaf.is_list &&
               !leaf.is_struct_member) {
      // kind-4 generalized nesting: export the raw (def, rep) streams and
      // decode values densely; Python reassembles all levels (numpy Dremel)
      if (defs.empty() || reps.empty())
        throw std::runtime_error("parquet: nested page missing levels");
      present = 0;
      page_rows = 0;
      for (int64_t i = 0; i < page_values; i++) {
        if (reps[i] == 0) page_rows++;
        bool const d = defs[i] == leaf.max_def;
        out.defined.push_back(uint8_t(d));
        out.def_levels.push_back(uint8_t(defs[i]));
        out.rep_levels.push_back(uint8_t(reps[i]));
        if (d) present++;
      }
    } else if (!defs.empty()) {
      present = 0;
      // any optional ancestor or member needs the raw levels (max_def==1
      // covers an optional struct whose members are all required)
      bool const keep_levels = leaf.is_struct_member && leaf.max_def > 0;
      for (int64_t i = 0; i < page_values; i++) {
        bool d = defs[i] == leaf.max_def;
        out.defined.push_back(uint8_t(d));
        if (keep_levels) out.def_levels.push_back(uint8_t(defs[i]));
        if (d) present++;
      }
    } else {
      out.defined.insert(out.defined.end(), size_t(page_values), uint8_t(1));
    }

    switch (h.encoding) {
      case 0:                               // PLAIN
        decode_plain(leaf.phys_type, leaf.type_length, vp, vend, present, out);
        break;
      case 2:                               // PLAIN_DICTIONARY
      case 8:                               // RLE_DICTIONARY
        if (!have_dict)
          throw std::runtime_error("parquet: dictionary page missing");
        decode_dict_indices(leaf.phys_type, leaf.type_length, dict, vp, vend,
                            present, out);
        break;
      case 3: {                             // RLE (booleans)
        if (leaf.phys_type != PT_BOOLEAN)
          throw std::runtime_error("parquet: RLE on non-boolean");
        if (vend - vp < 4) throw std::runtime_error("parquet: rle eof");
        uint32_t len;
        std::memcpy(&len, vp, 4);
        std::vector<int32_t> vals(present);
        rle_decode(vp + 4, vp + 4 + len, 1, present, vals.data());
        for (int64_t i = 0; i < present; i++)
          out.values.push_back(uint8_t(vals[i]));
        break;
      }
      case 5:                               // DELTA_BINARY_PACKED
        decode_delta_binary(leaf.phys_type, vp, vend, present, out);
        break;
      case 6:                               // DELTA_LENGTH_BYTE_ARRAY
        decode_delta_length_byte_array(leaf.phys_type, vp, vend, present, out);
        break;
      case 7:                               // DELTA_BYTE_ARRAY
        decode_delta_byte_array(leaf.phys_type, leaf.type_length, vp, vend,
                                present, out);
        break;
      case 9:                               // BYTE_STREAM_SPLIT
        decode_byte_stream_split(leaf.phys_type, leaf.type_length, vp, vend,
                                 present, out);
        break;
      default:
        throw std::runtime_error("parquet: unsupported encoding " +
                                 std::to_string(h.encoding));
    }
    remaining -= page_values;
    out.num_rows += page_rows;
  }
  return out;
}

}  // namespace

// ---- C ABI ------------------------------------------------------------------

extern "C" {

// copy=0: borrow the caller's buffer (caller must keep it alive until
// pqr_free — the Python reader holds the mmap); copy=1: own a copy.
void* pqr_open_ex(uint8_t const* buf, int64_t len, int32_t copy) {
  try {
    auto st = std::make_unique<FileState>();
    if (copy) {
      st->owned.assign(buf, buf + len);
      st->data_ptr = st->owned.data();
    } else {
      st->data_ptr = buf;
    }
    st->data_len = size_t(len);
    parse_footer(*st);
    return st.release();
  } catch (std::exception const& e) {
    g_error = e.what();
    return nullptr;
  }
}

void* pqr_open(uint8_t const* buf, int64_t len) {
  return pqr_open_ex(buf, len, 1);
}

char const* pqr_last_error() { return g_error.c_str(); }

int64_t pqr_num_rows(void* h) { return static_cast<FileState*>(h)->num_rows; }

int32_t pqr_num_row_groups(void* h) {
  return int32_t(static_cast<FileState*>(h)->groups.size());
}

int32_t pqr_num_leaves(void* h) {
  return int32_t(static_cast<FileState*>(h)->leaves.size());
}

int64_t pqr_row_group_num_rows(void* h, int32_t rg) {
  auto* st = static_cast<FileState*>(h);
  if (rg < 0 || size_t(rg) >= st->groups.size()) return -1;
  return st->groups[rg].num_rows;
}

// leaf schema accessors: name into caller buffer; ints via out params
// Shared lookup + size-then-fill cache protocol for both column entry
// points: the sizing call (fill=false) caches the decode, the fill call
// consumes it — chunks are never decompressed twice.
std::shared_ptr<DecodedChunk> get_chunk(FileState* st, int32_t rg,
                                        int32_t leaf, bool fill) {
  if (rg < 0 || size_t(rg) >= st->groups.size())
    throw std::runtime_error("row group out of range");
  auto const& grp = st->groups[rg];
  ChunkMeta const* cm = nullptr;
  for (auto const& c : grp.chunks)
    if (c.schema_idx == leaf) { cm = &c; break; }
  if (!cm) throw std::runtime_error("column chunk not found");
  auto key = std::make_pair(rg, leaf);
  std::shared_ptr<DecodedChunk> dcp;
  {
    std::lock_guard<std::mutex> lk(st->cache_mu);
    auto it = st->cache.find(key);
    if (it != st->cache.end()) {
      dcp = it->second;
      if (fill) st->cache.erase(it);
    }
  }
  if (!dcp) {
    dcp = std::make_shared<DecodedChunk>(
        decode_chunk(*st, *cm, st->leaves[leaf]));
    if (!fill) {
      std::lock_guard<std::mutex> lk(st->cache_mu);
      st->cache[key] = dcp;
    }
  }
  return dcp;
}

// 0 = flat primitive, 1 = LIST<primitive>, 2 = STRUCT member (primitive
// under plain groups), 3 = unsupported shape, 4 = generalized nesting
// (MAP / LIST<STRUCT> / STRUCT<LIST> / LIST<LIST> / legacy 2-level lists,
// decoded via pqr_read_nested_column + host-side Dremel reassembly)
int32_t pqr_leaf_kind(void* h, int32_t i) {
  auto* st = static_cast<FileState*>(h);
  if (i < 0 || size_t(i) >= st->leaves.size()) return -1;
  auto const& l = st->leaves[i];
  if (l.flat) return 0;
  if (l.is_list) return 1;
  if (l.is_struct_member) return 2;
  if (l.nested_ok) return 4;
  return 3;
}

// The generalized ancestry descriptor (4-int node records, see LeafSchema)
// plus the leaf's level bounds. Returns the int count, or -1 on error.
int32_t pqr_leaf_ancestry(void* h, int32_t i, int32_t* max_def,
                          int32_t* max_rep, int32_t* desc, int32_t cap) {
  auto* st = static_cast<FileState*>(h);
  if (i < 0 || size_t(i) >= st->leaves.size()) return -1;
  auto const& l = st->leaves[i];
  *max_def = l.max_def;
  *max_rep = l.max_rep;
  int32_t n = int32_t(l.anc_desc.size());
  for (int32_t k = 0; k < n && k < cap; k++) desc[k] = l.anc_desc[k];
  return n;
}

// Two-phase read of a generalized nested chunk (kind 4): sizing call
// (values==nullptr) fills *values_nbytes, *num_present and *num_slots;
// the fill call populates values (dense), lengths (strings; per present
// value), def_levels and rep_levels (num_slots bytes each).
int32_t pqr_read_nested_column(void* h, int32_t rg, int32_t leaf,
                               uint8_t* values, int64_t* values_nbytes,
                               int32_t* lengths, uint8_t* def_levels,
                               uint8_t* rep_levels, int64_t* num_slots,
                               int64_t* num_present) {
  auto* st = static_cast<FileState*>(h);
  try {
    if (leaf < 0 || size_t(leaf) >= st->leaves.size())
      throw std::runtime_error("leaf out of range");
    auto const& lf = st->leaves[leaf];
    if (!(lf.nested_ok && !lf.flat && !lf.is_list && !lf.is_struct_member))
      throw std::runtime_error("not a generalized nested column");
    auto dcp = get_chunk(st, rg, leaf, values != nullptr);
    DecodedChunk const& dc = *dcp;
    int64_t present = 0;
    for (uint8_t d : dc.defined) present += d;
    *values_nbytes = int64_t(dc.values.size());
    *num_present = present;
    *num_slots = int64_t(dc.def_levels.size());
    if (!values) return 0;
    std::memcpy(values, dc.values.data(), dc.values.size());
    if (lengths && !dc.lengths.empty())
      std::memcpy(lengths, dc.lengths.data(),
                  dc.lengths.size() * sizeof(int32_t));
    if (def_levels && !dc.def_levels.empty())
      std::memcpy(def_levels, dc.def_levels.data(), dc.def_levels.size());
    if (rep_levels && !dc.rep_levels.empty())
      std::memcpy(rep_levels, dc.rep_levels.data(), dc.rep_levels.size());
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

// ancestor def levels for a struct-member leaf, one per ancestor group
// outermost first (-1 = required group); returns the count, or -1 on error.
int32_t pqr_leaf_struct_info(void* h, int32_t i, int32_t* max_def,
                             int32_t* anc_defs, int32_t anc_cap) {
  auto* st = static_cast<FileState*>(h);
  if (i < 0 || size_t(i) >= st->leaves.size()) return -1;
  auto const& l = st->leaves[i];
  if (!l.is_struct_member) return -1;
  *max_def = l.max_def;
  int32_t n = int32_t(l.ancestor_defs.size());
  for (int32_t k = 0; k < n && k < anc_cap; k++) anc_defs[k] = l.ancestor_defs[k];
  return n;
}

// raw def levels of a sized-but-not-yet-consumed chunk (call between the
// sizing and fill calls of pqr_read_column); one byte per row
int32_t pqr_read_def_levels(void* h, int32_t rg, int32_t leaf, uint8_t* out) {
  auto* st = static_cast<FileState*>(h);
  try {
    if (leaf < 0 || size_t(leaf) >= st->leaves.size())
      throw std::runtime_error("leaf out of range");
    auto dcp = get_chunk(st, rg, leaf, false);
    if (dcp->def_levels.empty())
      throw std::runtime_error("no def levels for this chunk");
    std::memcpy(out, dcp->def_levels.data(), dcp->def_levels.size());
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

// Two-phase read of a LIST<primitive> column chunk (standard 3-level shape).
// Sizing call (values==nullptr) fills *values_nbytes, *num_present,
// *num_elem_slots and *num_rows; the fill call populates values, lengths
// (strings; per present value), elem_defined (num_elem_slots bytes),
// row_counts (num_rows int32) and row_valid (num_rows bytes).
int32_t pqr_read_list_column(void* h, int32_t rg, int32_t leaf,
                             uint8_t* values, int64_t* values_nbytes,
                             int32_t* lengths, uint8_t* elem_defined,
                             int64_t* num_elem_slots, int64_t* num_present,
                             int32_t* row_counts, uint8_t* row_valid,
                             int64_t* num_rows) {
  auto* st = static_cast<FileState*>(h);
  try {
    if (leaf < 0 || size_t(leaf) >= st->leaves.size())
      throw std::runtime_error("leaf out of range");
    if (!st->leaves[leaf].is_list)
      throw std::runtime_error("not a list column");
    auto dcp = get_chunk(st, rg, leaf, values != nullptr);
    DecodedChunk const& dc = *dcp;
    int64_t present = 0;
    for (uint8_t d : dc.defined) present += d;
    *values_nbytes = int64_t(dc.values.size());
    *num_present = present;
    *num_elem_slots = int64_t(dc.defined.size());
    *num_rows = dc.num_rows;
    if (!values) return 0;
    std::memcpy(values, dc.values.data(), dc.values.size());
    if (lengths && !dc.lengths.empty())
      std::memcpy(lengths, dc.lengths.data(),
                  dc.lengths.size() * sizeof(int32_t));
    if (elem_defined && !dc.defined.empty())
      std::memcpy(elem_defined, dc.defined.data(), dc.defined.size());
    if (row_counts && !dc.list_counts.empty())
      std::memcpy(row_counts, dc.list_counts.data(),
                  dc.list_counts.size() * sizeof(int32_t));
    if (row_valid && !dc.list_valid.empty())
      std::memcpy(row_valid, dc.list_valid.data(), dc.list_valid.size());
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

int32_t pqr_leaf_info(void* h, int32_t i, char* name_out, int32_t name_cap,
                      int32_t* phys_type, int32_t* type_length,
                      int32_t* converted, int32_t* scale, int32_t* precision,
                      int32_t* optional, int32_t* flat) {
  auto* st = static_cast<FileState*>(h);
  if (i < 0 || size_t(i) >= st->leaves.size()) return -1;
  auto const& l = st->leaves[i];
  if (int32_t(l.name.size()) + 1 > name_cap) return int32_t(l.name.size()) + 1;
  std::memcpy(name_out, l.name.c_str(), l.name.size() + 1);
  *phys_type = l.phys_type;
  *type_length = l.type_length;
  *converted = l.converted;
  *scale = l.scale;
  *precision = l.precision;
  *optional = l.optional ? 1 : 0;
  *flat = l.flat ? 1 : 0;
  return 0;
}

// Two-phase column read for one row group.
// Phase 1 (values==nullptr): returns 0 and fills *values_nbytes /
// *num_present. Phase 2: fills values (dense, nulls squeezed out),
// lengths (strings; else ignored), defined (num_rows bytes).
int32_t pqr_read_column(void* h, int32_t rg, int32_t leaf,
                        uint8_t* values, int64_t* values_nbytes,
                        int32_t* lengths, uint8_t* defined,
                        int64_t* num_present) {
  auto* st = static_cast<FileState*>(h);
  try {
    if (leaf < 0 || size_t(leaf) >= st->leaves.size())
      throw std::runtime_error("leaf out of range");
    auto const& lf = st->leaves[leaf];
    if (!lf.flat && !lf.is_struct_member)
      throw std::runtime_error(
          lf.is_list ? "list column: use pqr_read_list_column"
                     : "nested/repeated columns unsupported");
    auto dcp = get_chunk(st, rg, leaf, values != nullptr);
    DecodedChunk const& dc = *dcp;
    int64_t present = 0;
    for (uint8_t d : dc.defined) present += d;
    if (!values) {
      *values_nbytes = int64_t(dc.values.size());
      *num_present = present;
      return 0;
    }
    std::memcpy(values, dc.values.data(), dc.values.size());
    if (lengths && !dc.lengths.empty())
      std::memcpy(lengths, dc.lengths.data(),
                  dc.lengths.size() * sizeof(int32_t));
    if (defined)
      std::memcpy(defined, dc.defined.data(), dc.defined.size());
    *values_nbytes = int64_t(dc.values.size());
    *num_present = present;
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

void pqr_free(void* h) { delete static_cast<FileState*>(h); }

}  // extern "C"
