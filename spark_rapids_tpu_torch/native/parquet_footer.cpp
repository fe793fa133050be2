// Parquet footer parse / prune / filter / re-serialize (host-only C++).
//
// The PyTorch port's copy of spark_rapids_tpu/native/parquet_footer.cpp,
// unchanged, built by spark_rapids_tpu_torch/native/build.py.
//
// Equivalent of the reference's NativeParquetJni.cpp (see SURVEY.md §2.1
// #17): parse the thrift-TCompactProtocol FileMetaData from a footer
// buffer, prune columns against a flattened Spark schema request
// (names / num_children / tags with 0=VALUE 1=STRUCT 2=LIST 3=MAP,
// ParquetFooter.java:139-179), filter row groups to a split by the
// midpoint containment rule, and re-serialize with the [thrift][len][PAR1]
// framing.
//
// Design difference from the reference: instead of generated typed thrift
// structs (arrow's parquet_types.h), the footer is held as a *generic*
// compact-protocol value tree. Pruning edits the few fields it understands
// (schema list, num_children, row groups, column chunks) and every other
// field — statistics, logical types, encodings, future additions — round-
// trips byte-faithfully without this file knowing about them.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace {

// ---- compact protocol type codes -------------------------------------------
enum CType : uint8_t {
  CT_STOP       = 0,
  CT_TRUE       = 1,
  CT_FALSE      = 2,
  CT_BYTE       = 3,
  CT_I16        = 4,
  CT_I32        = 5,
  CT_I64        = 6,
  CT_DOUBLE     = 7,
  CT_BINARY     = 8,
  CT_LIST       = 9,
  CT_SET        = 10,
  CT_MAP        = 11,
  CT_STRUCT     = 12,
};

struct TVal {
  uint8_t type = CT_STOP;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string bin;
  std::vector<TVal> elems;                          // list / set
  uint8_t elem_type = CT_STOP;
  std::vector<std::pair<TVal, TVal>> kvs;           // map
  uint8_t key_type = CT_STOP, val_type = CT_STOP;
  std::vector<std::pair<int16_t, TVal>> fields;     // struct, in wire order

  TVal* field(int16_t id)
  {
    for (auto& [fid, v] : fields)
      if (fid == id) return &v;
    return nullptr;
  }
  int64_t field_i(int16_t id, int64_t dflt = 0)
  {
    auto* f = field(id);
    return f ? f->i : dflt;
  }
  void set_field_i(int16_t id, int64_t value)
  {
    if (auto* f = field(id)) { f->i = value; }
  }
};

// ---- reader ----------------------------------------------------------------

struct Reader {
  uint8_t const* p;
  uint8_t const* end;

  uint8_t u8()
  {
    if (p >= end) throw std::runtime_error("footer truncated");
    return *p++;
  }
  uint64_t uvarint()
  {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      uint8_t b = u8();
      v |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) throw std::runtime_error("varint overflow");
    }
  }
  int64_t zigzag() { uint64_t v = uvarint(); return int64_t(v >> 1) ^ -int64_t(v & 1); }

  TVal value(uint8_t type)
  {
    TVal out;
    out.type = type;
    switch (type) {
      case CT_TRUE: out.b = true; out.type = CT_TRUE; break;
      case CT_FALSE: out.b = false; out.type = CT_TRUE; break;  // canonical bool
      case CT_BYTE: out.i = int8_t(u8()); break;
      case CT_I16:
      case CT_I32:
      case CT_I64: out.i = zigzag(); break;
      case CT_DOUBLE: {
        uint64_t raw = 0;
        for (int k = 0; k < 8; ++k) raw |= uint64_t(u8()) << (8 * k);
        std::memcpy(&out.d, &raw, 8);
        break;
      }
      case CT_BINARY: {
        uint64_t n = uvarint();
        if (uint64_t(end - p) < n) throw std::runtime_error("binary truncated");
        out.bin.assign(reinterpret_cast<char const*>(p), n);
        p += n;
        break;
      }
      case CT_LIST:
      case CT_SET: {
        uint8_t hdr = u8();
        uint64_t n = hdr >> 4;
        out.elem_type = hdr & 0x0F;
        if (n == 15) n = uvarint();
        out.elems.reserve(n);
        for (uint64_t k = 0; k < n; ++k) {
          if (out.elem_type == CT_TRUE || out.elem_type == CT_FALSE) {
            TVal bv;
            bv.type = CT_TRUE;
            bv.b = (u8() == CT_TRUE);
            out.elems.push_back(std::move(bv));
          } else {
            out.elems.push_back(value(out.elem_type));
          }
        }
        break;
      }
      case CT_MAP: {
        uint64_t n = uvarint();
        if (n > 0) {
          uint8_t kv = u8();
          out.key_type = kv >> 4;
          out.val_type = kv & 0x0F;
          for (uint64_t k = 0; k < n; ++k) {
            TVal kval = value(out.key_type);
            TVal vval = value(out.val_type);
            out.kvs.emplace_back(std::move(kval), std::move(vval));
          }
        }
        break;
      }
      case CT_STRUCT: {
        int16_t last_id = 0;
        while (true) {
          uint8_t hdr = u8();
          if (hdr == CT_STOP) break;
          uint8_t ftype = hdr & 0x0F;
          int16_t delta = hdr >> 4;
          int16_t fid = delta ? int16_t(last_id + delta) : int16_t(zigzag());
          last_id = fid;
          out.fields.emplace_back(fid, value(ftype));
        }
        break;
      }
      default: throw std::runtime_error("unknown thrift compact type");
    }
    return out;
  }
};

// ---- writer ----------------------------------------------------------------

struct Writer {
  std::string out;

  void u8(uint8_t b) { out.push_back(char(b)); }
  void uvarint(uint64_t v)
  {
    while (v >= 0x80) { u8(uint8_t(v) | 0x80); v >>= 7; }
    u8(uint8_t(v));
  }
  void zigzag(int64_t v) { uvarint((uint64_t(v) << 1) ^ uint64_t(v >> 63)); }

  static uint8_t wire_type(TVal const& v, bool in_field)
  {
    if (v.type == CT_TRUE || v.type == CT_FALSE)
      return in_field ? (v.b ? CT_TRUE : CT_FALSE) : CT_TRUE;
    return v.type;
  }

  void value(TVal const& v)
  {
    switch (v.type) {
      case CT_TRUE:
      case CT_FALSE: break;  // bools in struct fields carry no payload
      case CT_BYTE: u8(uint8_t(v.i)); break;
      case CT_I16:
      case CT_I32:
      case CT_I64: zigzag(v.i); break;
      case CT_DOUBLE: {
        uint64_t raw;
        std::memcpy(&raw, &v.d, 8);
        for (int k = 0; k < 8; ++k) u8(uint8_t(raw >> (8 * k)));
        break;
      }
      case CT_BINARY:
        uvarint(v.bin.size());
        out.append(v.bin);
        break;
      case CT_LIST:
      case CT_SET: {
        uint64_t n = v.elems.size();
        uint8_t et = v.elem_type ? v.elem_type : uint8_t(CT_STRUCT);
        if (n < 15) u8(uint8_t((n << 4) | et));
        else { u8(uint8_t(0xF0 | et)); uvarint(n); }
        for (auto const& e : v.elems) {
          if (et == CT_TRUE || et == CT_FALSE) u8(e.b ? CT_TRUE : CT_FALSE);
          else value(e);
        }
        break;
      }
      case CT_MAP: {
        uvarint(v.kvs.size());
        if (!v.kvs.empty()) {
          u8(uint8_t((v.key_type << 4) | v.val_type));
          for (auto const& [k, val] : v.kvs) { value(k); value(val); }
        }
        break;
      }
      case CT_STRUCT: {
        int16_t last_id = 0;
        for (auto const& [fid, fv] : v.fields) {
          uint8_t ft = wire_type(fv, true);
          int16_t delta = int16_t(fid - last_id);
          if (delta > 0 && delta <= 15) u8(uint8_t((delta << 4) | ft));
          else { u8(ft); zigzag(fid); }
          last_id = fid;
          value(fv);
        }
        u8(CT_STOP);
        break;
      }
      default: throw std::runtime_error("cannot serialize type");
    }
  }
};

// ---- parquet-schema helpers ------------------------------------------------
// FileMetaData: 1 version, 2 schema, 3 num_rows, 4 row_groups, ...
// SchemaElement: 3 repetition, 4 name, 5 num_children, 6 converted_type,
//                10 logicalType (2: MAP, 3: LIST)
// RowGroup: 1 columns, 3 num_rows; ColumnChunk: 3 meta_data
// ColumnMetaData: 7 total_compressed_size, 9 data_page_offset,
//                 11 dictionary_page_offset

constexpr int CONVERTED_MAP = 1, CONVERTED_MAP_KV = 2, CONVERTED_LIST = 3;

struct SchemaNode {
  int se_index;                 // index into the flat schema element list
  std::vector<SchemaNode> children;
};

struct Request {
  std::string name;
  int tag;                      // 0 value, 1 struct, 2 list, 3 map
  std::vector<Request> children;
};

std::string lower(std::string s)
{
  for (auto& c : s)
    c = char(std::tolower(static_cast<unsigned char>(c)));
  return s;
}

class Footer {
 public:
  explicit Footer(uint8_t const* buf, int64_t len)
  {
    Reader r{buf, buf + len};
    meta_ = r.value(CT_STRUCT);
    if (!meta_.field(2)) throw std::runtime_error("no schema in footer");
  }

  void filter_groups(int64_t part_offset, int64_t part_length)
  {
    auto* rgs = meta_.field(4);
    if (!rgs) return;
    std::vector<TVal> kept;
    int64_t rows = 0;
    for (auto& rg : rgs->elems) {
      auto* cols = rg.field(1);
      if (!cols || cols->elems.empty()) continue;
      int64_t start = INT64_MAX, total = 0;
      for (auto& cc : cols->elems) {
        auto* md = cc.field(3);
        if (!md) continue;
        int64_t data_off = md->field_i(9);
        int64_t dict_off = md->field_i(11, 0);
        int64_t s = dict_off > 0 ? std::min(dict_off, data_off) : data_off;
        start = std::min(start, s);
        total += md->field_i(7);
      }
      // Spark's midpoint containment rule: the split owns a row group iff
      // it contains the group's byte midpoint.
      int64_t mid = start + total / 2;
      if (mid >= part_offset && mid < part_offset + part_length) {
        rows += rg.field_i(3);
        kept.push_back(std::move(rg));
      }
    }
    rgs->elems = std::move(kept);
    meta_.set_field_i(3, rows);
  }

  void prune(Request const& root, bool ignore_case)
  {
    auto& schema = meta_.field(2)->elems;
    if (schema.empty()) throw std::runtime_error("empty schema");
    // rebuild the tree from the flattened depth-first element list
    int cursor = 0;
    SchemaNode tree = build_node(schema, cursor);
    if (cursor != int(schema.size()))
      throw std::runtime_error("malformed schema tree");

    next_leaf_ = 0;
    std::vector<int> kept_leaves;
    std::vector<TVal> new_schema;
    // root element: copy, fix num_children afterwards
    TVal new_root = schema[tree.se_index];
    size_t root_slot = 0;
    new_schema.push_back(TVal{});  // placeholder
    int kept_children = 0;
    for (auto const& child : tree.children) {
      kept_children += match(schema, child, root.children, ignore_case,
                             new_schema, kept_leaves);
    }
    new_root.set_field_i(5, kept_children);
    new_schema[root_slot] = std::move(new_root);
    meta_.field(2)->elems = std::move(new_schema);

    // filter every row group's chunk list to the kept leaves
    if (auto* rgs = meta_.field(4)) {
      for (auto& rg : rgs->elems) {
        auto* cols = rg.field(1);
        if (!cols) continue;
        std::vector<TVal> kept_cols;
        for (int leaf : kept_leaves) {
          if (leaf < int(cols->elems.size()))
            kept_cols.push_back(std::move(cols->elems[leaf]));
        }
        cols->elems = std::move(kept_cols);
      }
    }
    // column_orders (field 7) holds one entry per leaf column — keep in sync
    if (auto* orders = meta_.field(7)) {
      std::vector<TVal> kept_orders;
      for (int leaf : kept_leaves) {
        if (leaf < int(orders->elems.size()))
          kept_orders.push_back(std::move(orders->elems[leaf]));
      }
      orders->elems = std::move(kept_orders);
    }
  }

  int64_t num_rows() { return meta_.field_i(3); }
  int num_row_groups()
  {
    auto* rgs = meta_.field(4);
    return rgs ? int(rgs->elems.size()) : 0;
  }

  // ---- per-row-group / per-chunk statistics (streaming-scan pruning) ----
  // The generic value tree already round-trips Statistics byte-faithfully;
  // these accessors read the few fields min/max pruning needs without
  // giving up the format-agnostic design above.
  // ColumnMetaData: 1 type, 3 path_in_schema, 7 total_compressed_size,
  // 12 statistics { 1 max, 2 min, 3 null_count, 5 max_value, 6 min_value }
  int64_t rg_num_rows(int rg) { return row_group(rg)->field_i(3); }
  int rg_num_chunks(int rg)
  {
    auto* cols = row_group(rg)->field(1);
    return cols ? int(cols->elems.size()) : 0;
  }
  void chunk_info(int rg, int col, std::string& path, int64_t& phys,
                  int64_t& compressed, int64_t& null_count)
  {
    TVal* md = chunk_meta(rg, col);
    phys = md->field_i(1, -1);
    compressed = md->field_i(7, 0);
    path.clear();
    if (auto* p = md->field(3)) {
      for (auto& seg : p->elems) {
        if (!path.empty()) path.push_back('.');
        path.append(seg.bin);
      }
    }
    null_count = -1;
    if (auto* st = md->field(12)) {
      if (auto* nc = st->field(3)) null_count = nc->i;
    }
  }
  // which: 0 = min, 1 = max. Returns false when the stat is absent.
  bool chunk_stat(int rg, int col, int which, std::string& out)
  {
    TVal* md = chunk_meta(rg, col);
    auto* st = md->field(12);
    if (!st) return false;
    // prefer the order-aware v2 fields (min_value/max_value); the
    // deprecated min/max pair is a fallback for old writers — but ONLY
    // for numeric types: legacy writers computed byte-array min/max with
    // SIGNED byte order (the spec says to ignore those), and serving
    // them as unsigned-order bounds could over-prune matching rows
    TVal* v = st->field(which == 0 ? 6 : 5);
    if (!v) {
      int64_t phys = md->field_i(1, -1);
      if (phys == 6 || phys == 7) return false;  // BYTE_ARRAY / FLBA
      v = st->field(which == 0 ? 2 : 1);
    }
    if (!v || v->type != CT_BINARY) return false;
    out = v->bin;
    return true;
  }
  int num_top_columns()
  {
    auto& schema = meta_.field(2)->elems;
    return schema.empty() ? 0 : int(schema[0].field_i(5));
  }

  std::string serialize()
  {
    Writer w;
    w.value(meta_);
    uint32_t n = uint32_t(w.out.size());
    for (int k = 0; k < 4; ++k) w.u8(uint8_t(n >> (8 * k)));
    w.out.append("PAR1");
    return std::move(w.out);
  }

 private:
  TVal meta_;
  int next_leaf_ = 0;

  TVal* row_group(int rg)
  {
    auto* rgs = meta_.field(4);
    if (!rgs || rg < 0 || rg >= int(rgs->elems.size()))
      throw std::runtime_error("row group index out of range");
    return &rgs->elems[size_t(rg)];
  }
  TVal* chunk_meta(int rg, int col)
  {
    auto* cols = row_group(rg)->field(1);
    if (!cols || col < 0 || col >= int(cols->elems.size()))
      throw std::runtime_error("column chunk index out of range");
    auto* md = cols->elems[size_t(col)].field(3);
    if (!md) throw std::runtime_error("column chunk has no metadata");
    return md;
  }

  static SchemaNode build_node(std::vector<TVal>& schema, int& cursor)
  {
    SchemaNode node;
    node.se_index = cursor++;
    int nc = int(schema[node.se_index].field_i(5));
    node.children.reserve(nc);
    for (int k = 0; k < nc; ++k)
      node.children.push_back(build_node(schema, cursor));
    return node;
  }

  static bool is_list(TVal& se)
  {
    if (se.field_i(6, -1) == CONVERTED_LIST) return true;
    auto* lt = se.field(10);
    return lt && lt->field(3) != nullptr;
  }
  static bool is_map(TVal& se)
  {
    int64_t ct = se.field_i(6, -1);
    if (ct == CONVERTED_MAP || ct == CONVERTED_MAP_KV) return true;
    auto* lt = se.field(10);
    return lt && lt->field(2) != nullptr;
  }
  static std::string se_name(TVal& se)
  {
    auto* f = se.field(4);
    return f ? f->bin : std::string();
  }

  // count leaves without keeping anything (for skipped subtrees)
  void skip_leaves(SchemaNode const& node)
  {
    if (node.children.empty()) {
      next_leaf_++;
      return;
    }
    for (auto const& c : node.children)
      skip_leaves(c);
  }

  // Emit `node` (and the matched part of its subtree) into new_schema.
  // Returns 1 if the node survived, 0 if it was dropped entirely.
  int match_one(std::vector<TVal>& schema, SchemaNode const& node,
                Request const& req, bool ignore_case,
                std::vector<TVal>& out, std::vector<int>& kept_leaves)
  {
    TVal& se = schema[node.se_index];
    bool const leaf = node.children.empty();
    switch (req.tag) {
      case 0: {  // VALUE
        if (!leaf)
          throw std::runtime_error("type mismatch: expected value for '" +
                                   se_name(se) + "'");
        kept_leaves.push_back(next_leaf_++);
        out.push_back(se);
        return 1;
      }
      case 1: {  // STRUCT
        if (leaf || is_list(se) || is_map(se))
          throw std::runtime_error("type mismatch: expected struct for '" +
                                   se_name(se) + "'");
        size_t slot = out.size();
        out.push_back(TVal{});
        int kept = 0;
        for (auto const& child : node.children)
          kept += match(schema, child, req.children, ignore_case, out,
                        kept_leaves);
        if (kept == 0) {
          out.resize(slot);
          return 0;
        }
        TVal copy = se;
        copy.set_field_i(5, kept);
        out[slot] = std::move(copy);
        return 1;
      }
      case 2: {  // LIST: wrapper group -> repeated group -> element
        if (leaf || !is_list(se) || node.children.size() != 1)
          throw std::runtime_error("type mismatch: expected list for '" +
                                   se_name(se) + "'");
        SchemaNode const& rep = node.children[0];
        TVal& rep_se = schema[rep.se_index];
        // modern 3-level lists nest the element under the repeated group;
        // legacy 2-level lists repeat the element directly
        bool three_level = !rep.children.empty() &&
                           rep.children.size() == 1 &&
                           se_name(rep_se) != "array" &&
                           !ends_with(se_name(rep_se), "_tuple");
        SchemaNode const& elem = three_level ? rep.children[0] : rep;
        Request const& relem = req.children.at(0);
        size_t slot = out.size();
        out.push_back(TVal{});
        int kept_elem;
        if (three_level) {
          size_t rep_slot = out.size();
          out.push_back(TVal{});
          kept_elem = match_one(schema, elem, relem, ignore_case, out,
                                kept_leaves);
          if (kept_elem) {
            TVal rep_copy = rep_se;
            rep_copy.set_field_i(5, 1);
            out[rep_slot] = std::move(rep_copy);
          } else {
            out.resize(slot);
            return 0;
          }
        } else {
          kept_elem = match_one(schema, elem, relem, ignore_case, out,
                                kept_leaves);
          if (!kept_elem) {
            out.resize(slot);
            return 0;
          }
        }
        TVal copy = se;
        copy.set_field_i(5, 1);
        out[slot] = std::move(copy);
        return 1;
      }
      case 3: {  // MAP: wrapper group -> repeated key_value -> key, value
        if (leaf || !is_map(se) || node.children.size() != 1)
          throw std::runtime_error("type mismatch: expected map for '" +
                                   se_name(se) + "'");
        SchemaNode const& kv = node.children[0];
        if (kv.children.size() != 2)
          throw std::runtime_error("unsupported map layout for '" +
                                   se_name(se) + "'");
        size_t slot = out.size();
        size_t leaf_slot = kept_leaves.size();
        out.push_back(TVal{});
        size_t kv_slot = out.size();
        out.push_back(TVal{});
        int kept_k = match_one(schema, kv.children[0], req.children.at(0),
                               ignore_case, out, kept_leaves);
        int kept_v = kept_k
                       ? match_one(schema, kv.children[1], req.children.at(1),
                                   ignore_case, out, kept_leaves)
                       : (skip_leaves(kv.children[1]), 0);
        if (!kept_k || !kept_v) {
          // a half-matched map is dropped whole: un-keep any leaf the key
          // side already recorded
          kept_leaves.resize(leaf_slot);
          out.resize(slot);
          return 0;
        }
        TVal kv_copy = schema[kv.se_index];
        kv_copy.set_field_i(5, 2);
        out[kv_slot] = std::move(kv_copy);
        TVal copy = se;
        copy.set_field_i(5, 1);
        out[slot] = std::move(copy);
        return 1;
      }
      default: throw std::runtime_error("bad request tag");
    }
  }

  // Match one parquet child against a set of requested children by name.
  // Returns 1 if kept.
  int match(std::vector<TVal>& schema, SchemaNode const& node,
            std::vector<Request> const& reqs, bool ignore_case,
            std::vector<TVal>& out, std::vector<int>& kept_leaves)
  {
    TVal& se = schema[node.se_index];
    std::string name = se_name(se);
    if (ignore_case) name = lower(name);
    for (auto const& r : reqs) {
      if (r.name == name)
        return match_one(schema, node, r, ignore_case, out, kept_leaves);
    }
    skip_leaves(node);  // not requested: drop, but keep leaf numbering
    return 0;
  }

  static bool ends_with(std::string const& s, std::string const& suffix)
  {
    return s.size() >= suffix.size() &&
           s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
  }
};

thread_local std::string g_error;

Request build_request(char const* const* names, int const* num_children,
                      int const* tags, int count, int& cursor)
{
  Request r;
  r.name = names[cursor];
  r.tag = tags[cursor];
  int nc = num_children[cursor];
  ++cursor;
  for (int k = 0; k < nc; ++k) {
    if (cursor >= count) throw std::runtime_error("malformed request schema");
    r.children.push_back(
      build_request(names, num_children, tags, count, cursor));
  }
  return r;
}

}  // namespace

extern "C" {

void* pqf_parse(uint8_t const* buf, int64_t len)
{
  try {
    return new Footer(buf, len);
  } catch (std::exception const& e) {
    g_error = e.what();
    return nullptr;
  }
}

char const* pqf_last_error() { return g_error.c_str(); }

int pqf_filter_groups(void* h, int64_t part_offset, int64_t part_length)
{
  try {
    static_cast<Footer*>(h)->filter_groups(part_offset, part_length);
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return 1;
  }
}

int pqf_prune(void* h, char const* const* names, int const* num_children,
              int const* tags, int count, int ignore_case)
{
  try {
    Request root;
    root.tag = 1;
    int cursor = 0;
    while (cursor < count)
      root.children.push_back(
        build_request(names, num_children, tags, count, cursor));
    static_cast<Footer*>(h)->prune(root, ignore_case != 0);
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return 1;
  }
}

int64_t pqf_num_rows(void* h) { return static_cast<Footer*>(h)->num_rows(); }
int pqf_num_row_groups(void* h)
{
  return static_cast<Footer*>(h)->num_row_groups();
}
int pqf_num_columns(void* h)
{
  return static_cast<Footer*>(h)->num_top_columns();
}

int64_t pqf_rg_num_rows(void* h, int rg)
{
  try {
    return static_cast<Footer*>(h)->rg_num_rows(rg);
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

int pqf_rg_num_chunks(void* h, int rg)
{
  try {
    return static_cast<Footer*>(h)->rg_num_chunks(rg);
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

int pqf_chunk_info(void* h, int rg, int col, char* path_buf, int64_t cap,
                   int64_t* phys, int64_t* compressed, int64_t* null_count)
{
  try {
    std::string path;
    static_cast<Footer*>(h)->chunk_info(rg, col, path, *phys, *compressed,
                                        *null_count);
    if (int64_t(path.size()) + 1 > cap) {
      g_error = "path buffer too small";
      return 1;
    }
    std::memcpy(path_buf, path.c_str(), path.size() + 1);
    return 0;
  } catch (std::exception const& e) {
    g_error = e.what();
    return 1;
  }
}

// >= 0: stat size (bytes written when out != nullptr); -1: stat absent
// (None-safe path — columns without statistics never prune); -2: error.
int64_t pqf_chunk_stat(void* h, int rg, int col, int which, uint8_t* out,
                       int64_t cap)
{
  try {
    std::string v;
    if (!static_cast<Footer*>(h)->chunk_stat(rg, col, which, v)) return -1;
    if (out == nullptr) return int64_t(v.size());
    if (cap < int64_t(v.size())) {
      g_error = "stat buffer too small";
      return -2;
    }
    std::memcpy(out, v.data(), v.size());
    return int64_t(v.size());
  } catch (std::exception const& e) {
    g_error = e.what();
    return -2;
  }
}

int64_t pqf_serialize(void* h, uint8_t* out, int64_t cap)
{
  try {
    std::string s = static_cast<Footer*>(h)->serialize();
    if (out == nullptr) return int64_t(s.size());
    if (cap < int64_t(s.size())) {
      g_error = "buffer too small";
      return -1;
    }
    std::memcpy(out, s.data(), s.size());
    return int64_t(s.size());
  } catch (std::exception const& e) {
    g_error = e.what();
    return -1;
  }
}

void pqf_free(void* h) { delete static_cast<Footer*>(h); }

}  // extern "C"
