// Native columnar COCO-annotation JSON extractor (clean-room).
//
// Capability parity with the reference's vendored gason JSON parser
// (coco/common/gason.{h,cpp} — a C++ in-situ parser shipped with cocoapi's
// native tooling, dead code there). Re-designed for this framework's actual
// hot path instead of a DOM: a single-pass SAX-style scan of a COCO
// annotation file that extracts only the columns the data stages consume
// (image ids/dims/file names, annotation ids/image_ids/captions, category
// ids/names) into contiguous buffers. Python gets numpy views + offset-sliced
// strings — no per-annotation dict objects, which is what makes it faster
// and ~10x smaller than json.load for vocab/split-style scans.
//
// Exposed via ctypes (adaptive_tpu/data/fast_json.py); built by
// adaptive_tpu/native/build.py alongside masklib.
//
// Grammar: full JSON (RFC 8259) — objects, arrays, strings with all escapes
// incl. \uXXXX surrogate pairs, numbers, true/false/null. Unknown keys and
// sections are skipped at scan speed. Any syntax error aborts the parse and
// surfaces a message; callers fall back to stdlib json.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Columns {
  // which COCO sections appeared: bit0 images, bit1 annotations, bit2
  // categories. Lets the caller distinguish an actual COCO file from any
  // other syntactically valid JSON object (which must fall back to stdlib).
  int seen = 0;
  // images
  std::vector<int64_t> img_id, img_h, img_w;
  std::string fn_buf;
  std::vector<int64_t> fn_off{0};
  // annotations
  std::vector<int64_t> ann_id, ann_img;
  std::string cap_buf;
  std::vector<int64_t> cap_off{0};
  // categories
  std::vector<int64_t> cat_id;
  std::string cat_buf;
  std::vector<int64_t> cat_off{0};
};

// Recursion guard: stdlib json raises RecursionError on pathological
// nesting; a native parser must bound its C stack the same way or a crafted
// file segfaults the whole process. 512 is far beyond any real COCO file.
constexpr int kMaxDepth = 512;

struct Parser {
  const char* p;
  const char* end;
  std::string err;
  int depth = 0;

  explicit Parser(const char* data, size_t n) : p(data), end(data + n) {}

  bool fail(const char* msg) {
    if (err.empty()) err = msg;
    return false;
  }

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }

  bool expect(char c) {
    ws();
    if (p < end && *p == c) { p++; return true; }
    return fail("unexpected character");
  }

  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }

  // --- string scanning -------------------------------------------------
  // Decode a JSON string (after the opening quote) appending UTF-8 to out.
  bool string_into(std::string& out) {
    while (p < end) {
      unsigned char c = (unsigned char)*p++;
      if (c == '"') return true;
      if (c != '\\') { out.push_back((char)c); continue; }
      if (p >= end) break;
      char e = *p++;
      switch (e) {
        case '"': out.push_back('"'); break;
        case '\\': out.push_back('\\'); break;
        case '/': out.push_back('/'); break;
        case 'b': out.push_back('\b'); break;
        case 'f': out.push_back('\f'); break;
        case 'n': out.push_back('\n'); break;
        case 'r': out.push_back('\r'); break;
        case 't': out.push_back('\t'); break;
        case 'u': {
          unsigned cp;
          if (!hex4(cp)) return fail("bad \\u escape");
          if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
            unsigned lo;
            if (p + 1 < end && p[0] == '\\' && p[1] == 'u') {
              p += 2;
              if (!hex4(lo)) return fail("bad \\u escape");
              if (lo >= 0xDC00 && lo <= 0xDFFF)
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              else
                return fail("unpaired surrogate");
            } else {
              return fail("unpaired surrogate");
            }
          }
          append_utf8(out, cp);
          break;
        }
        default: return fail("bad escape");
      }
    }
    return fail("unterminated string");
  }

  bool hex4(unsigned& v) {
    v = 0;
    for (int i = 0; i < 4; i++) {
      if (p >= end) return false;
      char c = *p++;
      v <<= 4;
      if (c >= '0' && c <= '9') v |= (unsigned)(c - '0');
      else if (c >= 'a' && c <= 'f') v |= (unsigned)(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') v |= (unsigned)(c - 'A' + 10);
      else return false;
    }
    return true;
  }

  static void append_utf8(std::string& out, unsigned cp) {
    if (cp < 0x80) {
      out.push_back((char)cp);
    } else if (cp < 0x800) {
      out.push_back((char)(0xC0 | (cp >> 6)));
      out.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out.push_back((char)(0xE0 | (cp >> 12)));
      out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
      out.push_back((char)(0xF0 | (cp >> 18)));
      out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
      out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back((char)(0x80 | (cp & 0x3F)));
    }
  }

  // Skip a string body (after opening quote) without decoding.
  bool skip_string() {
    while (p < end) {
      char c = *p++;
      if (c == '"') return true;
      if (c == '\\') { if (p < end) p++; else break; }
    }
    return fail("unterminated string");
  }

  // --- number ----------------------------------------------------------
  bool number(double& out) {
    ws();
    char* endp = nullptr;
    out = strtod(p, &endp);
    if (endp == p) return fail("bad number");
    p = endp;
    return true;
  }

  // --- generic value skipping -----------------------------------------
  bool skip_value() {
    ws();
    if (p >= end) return fail("truncated");
    char c = *p;
    if (c == '"') { p++; return skip_string(); }
    if (c == '{') {
      if (++depth > kMaxDepth) return fail("nesting too deep");
      p++;
      ws();
      if (peek('}')) { p++; depth--; return true; }
      while (true) {
        if (!expect('"') || !skip_string() || !expect(':') || !skip_value()) return false;
        ws();
        if (peek(',')) { p++; continue; }
        if (!expect('}')) return false;
        depth--;
        return true;
      }
    }
    if (c == '[') {
      if (++depth > kMaxDepth) return fail("nesting too deep");
      p++;
      ws();
      if (peek(']')) { p++; depth--; return true; }
      while (true) {
        if (!skip_value()) return false;
        ws();
        if (peek(',')) { p++; continue; }
        if (!expect(']')) return false;
        depth--;
        return true;
      }
    }
    if (c == 't') { if (end - p >= 4 && !memcmp(p, "true", 4)) { p += 4; return true; } return fail("bad literal"); }
    if (c == 'f') { if (end - p >= 5 && !memcmp(p, "false", 5)) { p += 5; return true; } return fail("bad literal"); }
    if (c == 'n') { if (end - p >= 4 && !memcmp(p, "null", 4)) { p += 4; return true; } return fail("bad literal"); }
    double d;
    return number(d);
  }

  // --- element parsers -------------------------------------------------
  // 0 = images, 1 = annotations, 2 = categories
  bool element(Columns& c, int section) {
    if (!expect('{')) return false;
    int64_t id = -1, image_id = -1, h = -1, w = -1;
    bool got_str = false;
    std::string* strbuf =
        section == 0 ? &c.fn_buf : section == 1 ? &c.cap_buf : &c.cat_buf;
    size_t str_start = strbuf->size();
    ws();
    if (peek('}')) {
      p++;
    } else {
      std::string key;
      while (true) {
        key.clear();
        if (!expect('"') || !string_into(key) || !expect(':')) return false;
        bool handled = false;
        if (key == "id") {
          double d; if (!number(d)) return false;
          id = (int64_t)d; handled = true;
        } else if (section == 1 && key == "image_id") {
          double d; if (!number(d)) return false;
          image_id = (int64_t)d; handled = true;
        } else if (section == 0 && key == "height") {
          double d; if (!number(d)) return false;
          h = (int64_t)d; handled = true;
        } else if (section == 0 && key == "width") {
          double d; if (!number(d)) return false;
          w = (int64_t)d; handled = true;
        } else if ((section == 0 && key == "file_name") ||
                   (section == 1 && key == "caption") ||
                   (section == 2 && key == "name")) {
          ws();
          if (p < end && *p == '"') {
            p++;
            strbuf->resize(str_start);  // last wins on duplicate keys
            if (!string_into(*strbuf)) return false;
            got_str = true;
            handled = true;
          }
        }
        if (!handled && !skip_value()) return false;
        ws();
        if (peek(',')) { p++; continue; }
        if (!expect('}')) return false;
        break;
      }
    }
    (void)got_str;
    if (section == 0) {
      c.img_id.push_back(id);
      c.img_h.push_back(h);
      c.img_w.push_back(w);
      c.fn_off.push_back((int64_t)c.fn_buf.size());
    } else if (section == 1) {
      c.ann_id.push_back(id);
      c.ann_img.push_back(image_id);
      c.cap_off.push_back((int64_t)c.cap_buf.size());
    } else {
      c.cat_id.push_back(id);
      c.cat_off.push_back((int64_t)c.cat_buf.size());
    }
    return true;
  }

  bool section_array(Columns& c, int section) {
    if (!expect('[')) return false;
    ws();
    if (peek(']')) { p++; return true; }
    while (true) {
      if (!element(c, section)) return false;
      ws();
      if (peek(',')) { p++; continue; }
      return expect(']');
    }
  }

  bool document(Columns& c) {
    if (!expect('{')) return false;
    ws();
    if (peek('}')) {
      p++;
      ws();
      return p == end ? true : fail("trailing content");
    }
    std::string key;
    while (true) {
      key.clear();
      if (!expect('"') || !string_into(key) || !expect(':')) return false;
      bool ok;
      if (key == "images") { c.seen |= 1; ok = section_array(c, 0); }
      else if (key == "annotations") { c.seen |= 2; ok = section_array(c, 1); }
      else if (key == "categories") { c.seen |= 4; ok = section_array(c, 2); }
      else ok = skip_value();
      if (!ok) return false;
      ws();
      if (peek(',')) { p++; continue; }
      if (!expect('}')) return false;
      ws();
      return p == end ? true : fail("trailing content");
    }
  }
};

struct Handle {
  Columns c;
};

}  // namespace

extern "C" {

// Parse an annotation file. Returns an opaque handle, or nullptr with a
// message in err (errcap bytes).
void* coco_json_parse(const char* path, char* err, int errcap) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(err, errcap, "cannot open %s", path);
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data;
  data.resize((size_t)n);
  if (n > 0 && fread(&data[0], 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    snprintf(err, errcap, "short read on %s", path);
    return nullptr;
  }
  fclose(f);

  Handle* h = new Handle();
  Parser ps(data.data(), data.size());
  if (!ps.document(h->c)) {
    snprintf(err, errcap, "parse error: %s",
             ps.err.empty() ? "unknown" : ps.err.c_str());
    delete h;
    return nullptr;
  }
  return h;
}

// bit0 images, bit1 annotations, bit2 categories keys present in the file
long long coco_json_seen(void* vh) { return ((Handle*)vh)->c.seen; }

// section: 0 images, 1 annotations, 2 categories
long long coco_json_count(void* vh, int section) {
  Columns& c = ((Handle*)vh)->c;
  return section == 0 ? (long long)c.img_id.size()
       : section == 1 ? (long long)c.ann_id.size()
                      : (long long)c.cat_id.size();
}

// field: 0 img_id, 1 img_h, 2 img_w, 3 fn_off, 4 ann_id, 5 ann_img,
//        6 cap_off, 7 cat_id, 8 cat_off
const long long* coco_json_i64(void* vh, int field) {
  Columns& c = ((Handle*)vh)->c;
  switch (field) {
    case 0: return (const long long*)c.img_id.data();
    case 1: return (const long long*)c.img_h.data();
    case 2: return (const long long*)c.img_w.data();
    case 3: return (const long long*)c.fn_off.data();
    case 4: return (const long long*)c.ann_id.data();
    case 5: return (const long long*)c.ann_img.data();
    case 6: return (const long long*)c.cap_off.data();
    case 7: return (const long long*)c.cat_id.data();
    case 8: return (const long long*)c.cat_off.data();
  }
  return nullptr;
}

// buf: 0 file_names, 1 captions, 2 category names
const char* coco_json_buf(void* vh, int which) {
  Columns& c = ((Handle*)vh)->c;
  switch (which) {
    case 0: return c.fn_buf.data();
    case 1: return c.cap_buf.data();
    case 2: return c.cat_buf.data();
  }
  return nullptr;
}

long long coco_json_buf_len(void* vh, int which) {
  Columns& c = ((Handle*)vh)->c;
  switch (which) {
    case 0: return (long long)c.fn_buf.size();
    case 1: return (long long)c.cap_buf.size();
    case 2: return (long long)c.cat_buf.size();
  }
  return 0;
}

void coco_json_free(void* vh) { delete (Handle*)vh; }

}  // extern "C"
