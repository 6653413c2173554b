// Font model: glyph widths and code->unicode mapping for simple and CID
// fonts, with metric-compatible base-14 fallbacks (fonts_base14.h).
#pragma once

#include <map>
#include <string>
#include <vector>

#include "obj.h"

namespace pdfio {

class Document;

struct Font {
  std::string base_name;    // /BaseFont
  bool is_cid = false;      // Type0 with 2-byte codes
  bool vertical = false;    // Identity-V (rare; treated as horizontal)
  double default_width = 500.0;
  int first_char = 0;
  std::vector<double> widths;          // simple fonts: indexed by code-first_char
  std::map<int, double> cid_widths;    // CID fonts: /W
  std::map<int, int> to_unicode;       // code -> unicode (from ToUnicode CMap)
  std::map<int, int> encoding_uni;     // code -> unicode (from encoding tables)
  const short* base14_win = nullptr;   // fallback width tables
  const short* base14_std = nullptr;
  bool use_win_encoding = true;
  double ascent = 0.88, descent = -0.22;  // fractions of em

  // glyph width in text-space units (1/1000 em)
  double width(int code) const;
  // decode one code to a unicode codepoint (0 if unknown -> caller fallback)
  int unicode(int code) const;
  // split raw string bytes into codes (1- or 2-byte)
  void codes(const std::string& raw, std::vector<int>* out) const;
};

// Build a Font from a /Font resource dict.
Font load_font(Document* doc, PObj font_dict);

// Parse a ToUnicode CMap stream's bfchar/bfrange sections.
void parse_tounicode(const std::vector<uint8_t>& data, std::map<int, int>* out);

// Append a unicode codepoint as UTF-8.
void append_utf8(std::string* s, int cp);

}  // namespace pdfio
