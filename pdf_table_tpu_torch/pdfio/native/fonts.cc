#include "fonts.h"

#include <cstring>

#include "doc.h"
#include "fonts_base14.h"

namespace pdfio {

void append_utf8(std::string* s, int cp) {
  if (cp <= 0) return;
  if (cp < 0x80) {
    s->push_back((char)cp);
  } else if (cp < 0x800) {
    s->push_back((char)(0xC0 | (cp >> 6)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    s->push_back((char)(0xE0 | (cp >> 12)));
    s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    s->push_back((char)(0xF0 | (cp >> 18)));
    s->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

double Font::width(int code) const {
  if (is_cid) {
    auto it = cid_widths.find(code);
    if (it != cid_widths.end()) return it->second;
    return default_width;
  }
  int idx = code - first_char;
  if (idx >= 0 && idx < (int)widths.size() && widths[idx] > 0) return widths[idx];
  if (code >= 0 && code < 256) {
    const short* table = use_win_encoding ? base14_win : base14_std;
    if (table && table[code] > 0) return (double)table[code];
  }
  if (!widths.empty()) return default_width;
  return default_width;
}

int Font::unicode(int code) const {
  auto it = to_unicode.find(code);
  if (it != to_unicode.end()) return it->second;
  auto ie = encoding_uni.find(code);
  if (ie != encoding_uni.end()) return ie->second;
  if (!is_cid && code >= 0 && code < 256) {
    int u = kWinAnsiUnicode[code];
    if (u) return u;
  }
  if (is_cid) return 0;  // no mapping: caller drops or emits replacement
  return code;
}

void Font::codes(const std::string& raw, std::vector<int>* out) const {
  if (is_cid) {
    for (size_t k = 0; k + 1 < raw.size(); k += 2)
      out->push_back(((uint8_t)raw[k] << 8) | (uint8_t)raw[k + 1]);
    if (raw.size() % 2) out->push_back((uint8_t)raw.back());
  } else {
    for (char c : raw) out->push_back((uint8_t)c);
  }
}

static int hexval(uint8_t c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

static long long parse_hex_token(const std::string& s) {
  long long v = 0;
  for (char c : s) {
    int h = hexval((uint8_t)c);
    if (h >= 0) v = (v << 4) | h;
  }
  return v;
}

// read UTF-16BE hex string -> first codepoint (surrogate-aware); extra
// codepoints (ligature expansions) appended to *extra
static int utf16_hex_to_cp(const std::string& hex, std::vector<int>* extra) {
  std::vector<int> units;
  for (size_t k = 0; k + 3 < hex.size(); k += 4)
    units.push_back((int)parse_hex_token(hex.substr(k, 4)));
  if (units.empty() && hex.size() >= 2)
    units.push_back((int)parse_hex_token(hex));
  std::vector<int> cps;
  for (size_t k = 0; k < units.size(); k++) {
    int u = units[k];
    if (u >= 0xD800 && u <= 0xDBFF && k + 1 < units.size()) {
      int lo = units[k + 1];
      if (lo >= 0xDC00 && lo <= 0xDFFF) {
        cps.push_back(0x10000 + ((u - 0xD800) << 10) + (lo - 0xDC00));
        k++;
        continue;
      }
    }
    cps.push_back(u);
  }
  if (cps.empty()) return 0;
  if (extra)
    for (size_t k = 1; k < cps.size(); k++) extra->push_back(cps[k]);
  return cps[0];
}

void parse_tounicode(const std::vector<uint8_t>& data, std::map<int, int>* out) {
  // Lightweight CMap scan: handle "beginbfchar...endbfchar" and
  // "beginbfrange...endbfrange" sections with hex tokens.
  const char* s = (const char*)data.data();
  size_t n = data.size();
  size_t p = 0;
  auto next_hex = [&](std::string* hex) -> bool {
    while (p < n && s[p] != '<' && s[p] != 'e' && s[p] != '[') p++;
    if (p >= n || s[p] != '<') return false;
    p++;
    hex->clear();
    while (p < n && s[p] != '>') hex->push_back(s[p++]);
    if (p < n) p++;
    return true;
  };
  while (p < n) {
    if (s[p] == 'b' && p + 11 <= n && memcmp(s + p, "beginbfchar", 11) == 0) {
      p += 11;
      std::string src, dst;
      while (p < n) {
        size_t save = p;
        while (p < n && (s[p] == ' ' || s[p] == '\n' || s[p] == '\r' || s[p] == '\t')) p++;
        if (p + 9 <= n && memcmp(s + p, "endbfchar", 9) == 0) {
          p += 9;
          break;
        }
        p = save;
        if (!next_hex(&src)) break;
        if (!next_hex(&dst)) break;
        (*out)[(int)parse_hex_token(src)] = utf16_hex_to_cp(dst, nullptr);
      }
    } else if (s[p] == 'b' && p + 12 <= n && memcmp(s + p, "beginbfrange", 12) == 0) {
      p += 12;
      std::string lo, hi, dst;
      while (p < n) {
        size_t save = p;
        while (p < n && (s[p] == ' ' || s[p] == '\n' || s[p] == '\r' || s[p] == '\t')) p++;
        if (p + 10 <= n && memcmp(s + p, "endbfrange", 10) == 0) {
          p += 10;
          break;
        }
        p = save;
        if (!next_hex(&lo)) break;
        if (!next_hex(&hi)) break;
        // dst may be a hex string or an array of hex strings
        while (p < n && s[p] != '<' && s[p] != '[' && s[p] != 'e') p++;
        if (p < n && s[p] == '[') {
          p++;
          int c = (int)parse_hex_token(lo);
          int chi = (int)parse_hex_token(hi);
          for (int code = c; code <= chi && p < n; code++) {
            if (!next_hex(&dst)) break;
            (*out)[code] = utf16_hex_to_cp(dst, nullptr);
          }
          while (p < n && s[p] != ']') p++;
          if (p < n) p++;
        } else {
          if (!next_hex(&dst)) break;
          int c0 = (int)parse_hex_token(lo);
          int c1 = (int)parse_hex_token(hi);
          int u0 = utf16_hex_to_cp(dst, nullptr);
          if (c1 - c0 > 65535) c1 = c0 + 65535;
          for (int code = c0; code <= c1; code++) (*out)[code] = u0 + (code - c0);
        }
      }
    } else {
      p++;
    }
  }
}

static const Base14Font* find_base14(const std::string& base_name) {
  // strip subset prefix "ABCDEF+"
  std::string name = base_name;
  if (name.size() > 7 && name[6] == '+') name = name.substr(7);
  for (int k = 0; k < kBase14Count; k++)
    if (name == kBase14[k].name) return &kBase14[k];
  // heuristics: map common aliases
  auto has = [&](const char* sub) { return name.find(sub) != std::string::npos; };
  bool bold = has("Bold") || has("bold");
  bool ital = has("Italic") || has("Oblique") || has("italic");
  const char* fam = "Helvetica";
  if (has("Times") || has("Serif") || has("Roman")) fam = "Times";
  else if (has("Courier") || has("Mono")) fam = "Courier";
  std::string pick;
  if (strcmp(fam, "Times") == 0)
    pick = bold && ital ? "Times-BoldItalic" : bold ? "Times-Bold"
           : ital ? "Times-Italic" : "Times-Roman";
  else if (strcmp(fam, "Courier") == 0)
    pick = bold && ital ? "Courier-BoldOblique" : bold ? "Courier-Bold"
           : ital ? "Courier-Oblique" : "Courier";
  else
    pick = bold && ital ? "Helvetica-BoldOblique" : bold ? "Helvetica-Bold"
           : ital ? "Helvetica-Oblique" : "Helvetica";
  for (int k = 0; k < kBase14Count; k++)
    if (pick == kBase14[k].name) return &kBase14[k];
  return &kBase14[0];
}

static int glyph_to_unicode(const std::string& name) {
  int lo = 0, hi = kGlyphUniCount - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    int c = strcmp(name.c_str(), kGlyphUni[mid].name);
    if (c == 0) return kGlyphUni[mid].uni;
    if (c < 0) hi = mid - 1;
    else lo = mid + 1;
  }
  if (name.size() > 3 && name.compare(0, 3, "uni") == 0)
    return (int)strtol(name.c_str() + 3, nullptr, 16);
  if (name.size() == 1) return (uint8_t)name[0];
  return 0;
}

static void load_simple_font(Document* doc, PObj fd, Font* f) {
  PObj fc = doc->dget(fd, "FirstChar");
  f->first_char = fc && fc->is_num() ? (int)fc->as_int() : 0;
  PObj w = doc->dget(fd, "Widths");
  if (w && w->t == Obj::T::Array) {
    for (auto& e : w->arr) {
      PObj v = doc->resolve(e);
      f->widths.push_back(v && v->is_num() ? v->num() : 0.0);
    }
  }
  PObj enc = doc->dget(fd, "Encoding");
  if (enc) {
    std::string base_enc;
    PObj diffs;
    if (enc->t == Obj::T::Name) {
      base_enc = enc->s;
    } else if (enc->t == Obj::T::Dict) {
      PObj be = doc->dget(enc, "BaseEncoding");
      if (be && be->t == Obj::T::Name) base_enc = be->s;
      diffs = doc->dget(enc, "Differences");
    }
    if (base_enc == "MacRomanEncoding") f->use_win_encoding = false;
    if (diffs && diffs->t == Obj::T::Array) {
      int code = 0;
      for (auto& e : diffs->arr) {
        PObj v = doc->resolve(e);
        if (!v) continue;
        if (v->is_num()) {
          code = (int)v->as_int();
        } else if (v->t == Obj::T::Name) {
          int u = glyph_to_unicode(v->s);
          if (u) f->encoding_uni[code] = u;
          code++;
        }
      }
    }
  }
  PObj desc = doc->dget(fd, "FontDescriptor");
  if (desc) {
    double mw = doc->dnum(desc, "MissingWidth", 0);
    if (mw > 0) f->default_width = mw;
    double asc = doc->dnum(desc, "Ascent", 0);
    double dsc = doc->dnum(desc, "Descent", 0);
    if (asc > 0) f->ascent = asc / 1000.0;
    if (dsc < 0) f->descent = dsc / 1000.0;
  }
}

static void load_cid_font(Document* doc, PObj fd, Font* f) {
  f->is_cid = true;
  PObj desc_fonts = doc->dget(fd, "DescendantFonts");
  PObj cidf;
  if (desc_fonts && desc_fonts->t == Obj::T::Array && !desc_fonts->arr.empty())
    cidf = doc->resolve(desc_fonts->arr[0]);
  PObj enc = doc->dget(fd, "Encoding");
  if (enc && enc->t == Obj::T::Name && enc->s == "Identity-V") f->vertical = true;
  if (!cidf) return;
  f->default_width = doc->dnum(cidf, "DW", 1000.0);
  PObj w = doc->dget(cidf, "W");
  if (w && w->t == Obj::T::Array) {
    size_t k = 0;
    while (k < w->arr.size()) {
      PObj a = doc->resolve(w->arr[k]);
      if (!a || !a->is_num()) break;
      int c0 = (int)a->as_int();
      if (k + 1 >= w->arr.size()) break;
      PObj b = doc->resolve(w->arr[k + 1]);
      if (b && b->t == Obj::T::Array) {
        for (size_t j = 0; j < b->arr.size(); j++) {
          PObj v = doc->resolve(b->arr[j]);
          if (v && v->is_num()) f->cid_widths[c0 + (int)j] = v->num();
        }
        k += 2;
      } else if (b && b->is_num()) {
        if (k + 2 >= w->arr.size()) break;
        PObj v = doc->resolve(w->arr[k + 2]);
        int c1 = (int)b->as_int();
        if (v && v->is_num() && c1 - c0 <= 65535)
          for (int c = c0; c <= c1; c++) f->cid_widths[c] = v->num();
        k += 3;
      } else {
        break;
      }
    }
  }
  PObj desc = doc->dget(cidf, "FontDescriptor");
  if (desc) {
    double asc = doc->dnum(desc, "Ascent", 0);
    double dsc = doc->dnum(desc, "Descent", 0);
    if (asc > 0) f->ascent = asc / 1000.0;
    if (dsc < 0) f->descent = dsc / 1000.0;
  }
}

Font load_font(Document* doc, PObj fd) {
  Font f;
  fd = doc->resolve(fd);
  if (!fd || fd->t != Obj::T::Dict) {
    const Base14Font* b = find_base14("Helvetica");
    f.base_name = "Helvetica";
    f.base14_win = b->win;
    f.base14_std = b->std;
    return f;
  }
  PObj bn = doc->dget(fd, "BaseFont");
  if (bn && bn->t == Obj::T::Name) f.base_name = bn->s;
  PObj st = doc->dget(fd, "Subtype");
  std::string subtype = st && st->t == Obj::T::Name ? st->s : "";
  const Base14Font* b = find_base14(f.base_name);
  f.base14_win = b->win;
  f.base14_std = b->std;
  f.ascent = b->ascent / 1000.0;
  f.descent = b->descent / 1000.0;
  if (f.base_name.find("Symbol") != std::string::npos ||
      f.base_name.find("Dingbat") != std::string::npos)
    f.use_win_encoding = false;

  if (subtype == "Type0") {
    load_cid_font(doc, fd, &f);
  } else {
    load_simple_font(doc, fd, &f);
  }
  PObj tu = doc->dget(fd, "ToUnicode");
  if (tu && tu->t == Obj::T::Stream) {
    std::vector<uint8_t> data = doc->decoded(tu);
    parse_tounicode(data, &f.to_unicode);
  }
  return f;
}

}  // namespace pdfio
