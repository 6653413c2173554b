#include "obj.h"

#include <cstring>

#include "doc.h"

namespace pdfio {

bool Parser::skip_ws() {
  while (pos < n_) {
    uint8_t c = d_[pos];
    if (is_ws(c)) {
      pos++;
    } else if (c == '%') {  // comment to EOL
      while (pos < n_ && d_[pos] != '\n' && d_[pos] != '\r') pos++;
    } else {
      return true;
    }
  }
  return false;
}

std::string Parser::next_keyword() {
  skip_ws();
  std::string kw;
  while (pos < n_ && !is_ws(d_[pos]) && !is_delim(d_[pos])) kw.push_back((char)d_[pos++]);
  return kw;
}

bool Parser::at_keyword(const char* kw) {
  size_t save = pos;
  if (!skip_ws()) return false;
  size_t k = strlen(kw);
  bool ok = pos + k <= n_ && memcmp(d_ + pos, kw, k) == 0 &&
            (pos + k == n_ || is_ws(d_[pos + k]) || is_delim(d_[pos + k]));
  pos = save;
  return ok;
}

long long Parser::read_int() {
  skip_ws();
  bool neg = false;
  if (pos < n_ && (d_[pos] == '-' || d_[pos] == '+')) neg = d_[pos++] == '-';
  long long v = 0;
  while (pos < n_ && d_[pos] >= '0' && d_[pos] <= '9') v = v * 10 + (d_[pos++] - '0');
  return neg ? -v : v;
}

PObj Parser::parse_name() {
  // at '/'
  pos++;
  std::string name;
  while (pos < n_ && !is_ws(d_[pos]) && !is_delim(d_[pos])) {
    uint8_t c = d_[pos++];
    if (c == '#' && pos + 1 < n_) {
      auto hex = [](uint8_t h) -> int {
        if (h >= '0' && h <= '9') return h - '0';
        if (h >= 'a' && h <= 'f') return h - 'a' + 10;
        if (h >= 'A' && h <= 'F') return h - 'A' + 10;
        return -1;
      };
      int h1 = hex(d_[pos]), h2 = hex(d_[pos + 1]);
      if (h1 >= 0 && h2 >= 0) {
        c = (uint8_t)(h1 * 16 + h2);
        pos += 2;
      }
    }
    name.push_back((char)c);
  }
  return Obj::make_name(std::move(name));
}

PObj Parser::parse_string() {
  // at '('
  pos++;
  auto o = Obj::make(Obj::T::Str);
  int depth = 1;
  while (pos < n_) {
    uint8_t c = d_[pos++];
    if (c == '\\') {
      if (pos >= n_) break;
      uint8_t e = d_[pos++];
      switch (e) {
        case 'n': o->s.push_back('\n'); break;
        case 'r': o->s.push_back('\r'); break;
        case 't': o->s.push_back('\t'); break;
        case 'b': o->s.push_back('\b'); break;
        case 'f': o->s.push_back('\f'); break;
        case '(': o->s.push_back('('); break;
        case ')': o->s.push_back(')'); break;
        case '\\': o->s.push_back('\\'); break;
        case '\r':  // line continuation
          if (pos < n_ && d_[pos] == '\n') pos++;
          break;
        case '\n': break;
        default:
          if (e >= '0' && e <= '7') {  // octal, up to 3 digits
            int v = e - '0';
            for (int k = 0; k < 2 && pos < n_ && d_[pos] >= '0' && d_[pos] <= '7'; k++)
              v = v * 8 + (d_[pos++] - '0');
            o->s.push_back((char)(v & 0xFF));
          } else {
            o->s.push_back((char)e);
          }
      }
    } else if (c == '(') {
      depth++;
      o->s.push_back('(');
    } else if (c == ')') {
      if (--depth == 0) break;
      o->s.push_back(')');
    } else {
      o->s.push_back((char)c);
    }
  }
  return o;
}

PObj Parser::parse_hex_string() {
  // at '<' (single)
  pos++;
  auto o = Obj::make(Obj::T::Str);
  int hi = -1;
  while (pos < n_) {
    uint8_t c = d_[pos++];
    if (c == '>') break;
    int v;
    if (c >= '0' && c <= '9') v = c - '0';
    else if (c >= 'a' && c <= 'f') v = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') v = c - 'A' + 10;
    else continue;
    if (hi < 0) hi = v;
    else {
      o->s.push_back((char)(hi * 16 + v));
      hi = -1;
    }
  }
  if (hi >= 0) o->s.push_back((char)(hi * 16));
  return o;
}

PObj Parser::parse_number_or_ref() {
  size_t start = pos;
  bool real = false;
  if (pos < n_ && (d_[pos] == '+' || d_[pos] == '-')) pos++;
  while (pos < n_ && ((d_[pos] >= '0' && d_[pos] <= '9') || d_[pos] == '.')) {
    if (d_[pos] == '.') real = true;
    pos++;
  }
  std::string tok((const char*)d_ + start, pos - start);
  if (real) return Obj::make_real(atof(tok.c_str()));
  long long v = atoll(tok.c_str());
  // lookahead for "G R" (indirect reference)
  size_t save = pos;
  if (v >= 0) {
    skip_ws();
    size_t g0 = pos;
    while (pos < n_ && d_[pos] >= '0' && d_[pos] <= '9') pos++;
    if (pos > g0) {
      long long gen = atoll(std::string((const char*)d_ + g0, pos - g0).c_str());
      skip_ws();
      if (pos < n_ && d_[pos] == 'R' &&
          (pos + 1 >= n_ || is_ws(d_[pos + 1]) || is_delim(d_[pos + 1]))) {
        pos++;
        auto o = Obj::make(Obj::T::Ref);
        o->ref_num = (int)v;
        o->ref_gen = (int)gen;
        return o;
      }
    }
  }
  pos = save;
  return Obj::make_int(v);
}

PObj Parser::parse_array() {
  pos++;  // '['
  auto o = Obj::make(Obj::T::Array);
  while (skip_ws()) {
    if (d_[pos] == ']') {
      pos++;
      break;
    }
    PObj el = parse_object();
    if (!el) break;
    o->arr.push_back(el);
  }
  return o;
}

PObj Parser::parse_dict_or_stream() {
  pos += 2;  // '<<'
  auto o = Obj::make(Obj::T::Dict);
  while (skip_ws()) {
    if (d_[pos] == '>' && pos + 1 < n_ && d_[pos + 1] == '>') {
      pos += 2;
      break;
    }
    if (d_[pos] != '/') {  // malformed; bail
      pos++;
      continue;
    }
    PObj key = parse_name();
    skip_ws();
    PObj val = parse_object();
    if (!val) break;
    o->dict[key->s] = val;
  }
  // stream?
  size_t save = pos;
  if (at_keyword("stream")) {
    skip_ws();
    pos += 6;
    if (pos < n_ && d_[pos] == '\r') pos++;
    if (pos < n_ && d_[pos] == '\n') pos++;
    size_t data_start = pos;
    long long length = -1;
    PObj len_obj = o->at("Length");
    if (len_obj) {
      if (len_obj->t == Obj::T::Ref && doc_) len_obj = doc_->resolve(len_obj);
      if (len_obj && len_obj->is_num()) length = len_obj->as_int();
    }
    auto valid_end = [&](size_t end) {
      size_t p = end;
      while (p < n_ && is_ws(d_[p])) p++;
      return p + 9 <= n_ && memcmp(d_ + p, "endstream", 9) == 0;
    };
    if (length < 0 || data_start + (size_t)length > n_ ||
        !valid_end(data_start + (size_t)length)) {
      // scan for "endstream"
      size_t p = data_start;
      size_t found = std::string::npos;
      while (p + 9 <= n_) {
        if (d_[p] == 'e' && memcmp(d_ + p, "endstream", 9) == 0) {
          found = p;
          break;
        }
        p++;
      }
      if (found == std::string::npos) {
        pos = save;
        return o;  // treat as plain dict
      }
      size_t end = found;
      // strip one EOL before endstream
      if (end > data_start && d_[end - 1] == '\n') end--;
      if (end > data_start && d_[end - 1] == '\r') end--;
      length = (long long)(end - data_start);
    }
    o->t = Obj::T::Stream;
    o->stream_raw.assign(d_ + data_start, d_ + data_start + length);
    pos = data_start + length;
    skip_ws();
    if (pos + 9 <= n_ && memcmp(d_ + pos, "endstream", 9) == 0) pos += 9;
  } else {
    pos = save;
  }
  return o;
}

PObj Parser::parse_object() {
  if (!skip_ws()) return nullptr;
  uint8_t c = d_[pos];
  if (c == '<') {
    if (pos + 1 < n_ && d_[pos + 1] == '<') return parse_dict_or_stream();
    return parse_hex_string();
  }
  if (c == '(') return parse_string();
  if (c == '[') return parse_array();
  if (c == '/') return parse_name();
  if (c == ']' || c == '>' || c == ')' || c == '}' || c == '{') {
    pos++;  // stray delimiter: skip
    return Obj::make_null();
  }
  if ((c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.')
    return parse_number_or_ref();
  std::string kw = next_keyword();
  if (kw == "true") {
    auto o = Obj::make(Obj::T::Bool);
    o->b = true;
    return o;
  }
  if (kw == "false") {
    auto o = Obj::make(Obj::T::Bool);
    o->b = false;
    return o;
  }
  if (kw == "null") return Obj::make_null();
  if (kw.empty()) {
    pos++;
    return Obj::make_null();
  }
  return Obj::make_null();  // unknown keyword: treated as null
}

PObj Parser::parse_indirect(int* num, int* gen) {
  if (!skip_ws()) return nullptr;
  long long n = read_int();
  long long g = read_int();
  std::string kw = next_keyword();
  if (kw != "obj") return nullptr;
  if (num) *num = (int)n;
  if (gen) *gen = (int)g;
  PObj o = parse_object();
  // consume optional endobj
  size_t save = pos;
  if (at_keyword("endobj")) {
    skip_ws();
    pos += 6;
  } else {
    pos = save;
  }
  return o;
}

}  // namespace pdfio
