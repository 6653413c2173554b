// pdfio: PDF object model, lexer, and parser.
//
// The port's host-side PDF layer (a copy of pdf_table_tpu/pdfio/native).
// Replaces the role pdfminer / pypdf play in the reference (see reference
// src/pdftable/utils/pdf_utils.py) with an in-tree C++ implementation, so
// that no PDF library is needed.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace pdfio {

struct Obj;
using PObj = std::shared_ptr<Obj>;

struct Obj {
  enum class T { Null, Bool, Int, Real, Str, Name, Array, Dict, Stream, Ref };
  T t = T::Null;

  bool b = false;
  long long i = 0;
  double r = 0.0;
  std::string s;  // Str bytes (raw, unescaped) or Name text
  std::vector<PObj> arr;
  std::map<std::string, PObj> dict;  // also used by Stream
  std::vector<uint8_t> stream_raw;   // raw (encoded) stream bytes
  int ref_num = 0, ref_gen = 0;

  bool is_num() const { return t == T::Int || t == T::Real; }
  double num() const { return t == T::Int ? (double)i : r; }
  long long as_int() const { return t == T::Real ? (long long)r : i; }

  static PObj make(T t) {
    auto o = std::make_shared<Obj>();
    o->t = t;
    return o;
  }
  static PObj make_null() { return make(T::Null); }
  static PObj make_int(long long v) {
    auto o = make(T::Int);
    o->i = v;
    return o;
  }
  static PObj make_real(double v) {
    auto o = make(T::Real);
    o->r = v;
    return o;
  }
  static PObj make_name(std::string v) {
    auto o = make(T::Name);
    o->s = std::move(v);
    return o;
  }

  // dict helpers (no resolution; Document::get resolves refs)
  PObj at(const std::string& key) const {
    auto it = dict.find(key);
    return it == dict.end() ? nullptr : it->second;
  }
};

class Document;  // fwd

// Lexer/parser over a byte span. Document passes itself as resolver so
// stream /Length refs can be resolved during parsing.
class Parser {
 public:
  Parser(const uint8_t* data, size_t len, Document* doc = nullptr)
      : d_(data), n_(len), doc_(doc) {}

  size_t pos = 0;

  PObj parse_object();               // any object at pos
  PObj parse_indirect(int* num = nullptr, int* gen = nullptr);  // "N G obj ... endobj"
  bool skip_ws();                    // also skips comments; false at EOF
  std::string next_keyword();        // reads an alpha keyword token
  bool at_keyword(const char* kw);   // peek
  long long read_int();

  const uint8_t* data() const { return d_; }
  size_t size() const { return n_; }

 private:
  PObj parse_dict_or_stream();
  PObj parse_array();
  PObj parse_string();
  PObj parse_hex_string();
  PObj parse_name();
  PObj parse_number_or_ref();

  const uint8_t* d_;
  size_t n_;
  Document* doc_;
};

// --- filters -----------------------------------------------------------

// Decode a stream's bytes applying /Filter + /DecodeParms. Image-only
// filters (DCT/JPX/CCITT/JBIG2) stop the chain and set *passthrough to the
// remaining filter name (bytes returned as stored).
std::vector<uint8_t> decode_stream(Document* doc, const PObj& stream,
                                   std::string* passthrough);

std::vector<uint8_t> flate_decode(const uint8_t* data, size_t len);
std::vector<uint8_t> lzw_decode(const uint8_t* data, size_t len, int early);
std::vector<uint8_t> ascii_hex_decode(const uint8_t* data, size_t len);
std::vector<uint8_t> ascii85_decode(const uint8_t* data, size_t len);
std::vector<uint8_t> run_length_decode(const uint8_t* data, size_t len);
std::vector<uint8_t> apply_predictor(std::vector<uint8_t> in, int predictor,
                                     int colors, int bpc, int columns);

inline bool is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\f' || c == 0;
}
inline bool is_delim(uint8_t c) {
  return c == '(' || c == ')' || c == '<' || c == '>' || c == '[' || c == ']' ||
         c == '{' || c == '}' || c == '/' || c == '%';
}

}  // namespace pdfio
