// Minimal JSON serializer (UTF-8 pass-through with control escaping).
#pragma once

#include <cmath>
#include <cstdio>
#include <string>

namespace pdfio {

class JsonWriter {
 public:
  std::string out;

  void raw(const char* s) { out += s; }
  void key(const char* k) {
    comma();
    out += '"';
    out += k;
    out += "\":";
    pending_comma_ = false;
  }
  void begin_obj() { maybe_comma(); out += '{'; pending_comma_ = false; }
  void end_obj() { out += '}'; pending_comma_ = true; }
  void begin_arr() { maybe_comma(); out += '['; pending_comma_ = false; }
  void end_arr() { out += ']'; pending_comma_ = true; }

  void num(double v) {
    maybe_comma();
    if (std::isfinite(v)) {
      char buf[32];
      // round to 3 decimals; drop trailing zeros
      snprintf(buf, sizeof(buf), "%.3f", v);
      char* dot = strchr_local(buf, '.');
      if (dot) {
        char* e = buf + strlen_local(buf) - 1;
        while (e > dot && *e == '0') *e-- = 0;
        if (e == dot) *e = 0;
      }
      out += buf;
    } else {
      out += "0";
    }
    pending_comma_ = true;
  }
  void integer(long long v) {
    maybe_comma();
    char buf[32];
    snprintf(buf, sizeof(buf), "%lld", v);
    out += buf;
    pending_comma_ = true;
  }
  void str(const std::string& s) {
    maybe_comma();
    out += '"';
    for (size_t i = 0; i < s.size(); i++) {
      unsigned char c = s[i];
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        case '\b': out += "\\b"; break;
        case '\f': out += "\\f"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            snprintf(buf, sizeof(buf), "\\u%04x", c);
            out += buf;
          } else {
            out += (char)c;
          }
      }
    }
    out += '"';
    pending_comma_ = true;
  }
  void boolean(bool v) {
    maybe_comma();
    out += v ? "true" : "false";
    pending_comma_ = true;
  }

 private:
  bool pending_comma_ = false;
  void comma() {
    if (pending_comma_) out += ',';
  }
  void maybe_comma() {
    if (pending_comma_) out += ',';
    pending_comma_ = false;
  }
  static char* strchr_local(char* s, char c) {
    while (*s && *s != c) s++;
    return *s ? s : nullptr;
  }
  static size_t strlen_local(const char* s) {
    size_t n = 0;
    while (s[n]) n++;
    return n;
  }
};

}  // namespace pdfio
