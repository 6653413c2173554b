// Stream filter implementations: Flate (zlib), LZW, ASCIIHex, ASCII85,
// RunLength, and PNG/TIFF predictors. Image codecs (DCT/JPX/CCITT/JBIG2)
// pass through undecoded: the renderer (pdfio/render.py) skips them.
#include <zlib.h>

#include <cstring>

#include "doc.h"
#include "obj.h"

namespace pdfio {

std::vector<uint8_t> flate_decode(const uint8_t* data, size_t len) {
  std::vector<uint8_t> out;
  if (len == 0) return out;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return out;
  zs.next_in = const_cast<Bytef*>(data);
  zs.avail_in = (uInt)len;
  uint8_t buf[1 << 16];
  int ret = Z_OK;
  do {
    zs.next_out = buf;
    zs.avail_out = sizeof(buf);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END && ret != Z_BUF_ERROR) break;
    out.insert(out.end(), buf, buf + (sizeof(buf) - zs.avail_out));
    if (ret == Z_BUF_ERROR && zs.avail_in == 0) break;
  } while (ret != Z_STREAM_END && zs.avail_in > 0);
  inflateEnd(&zs);
  return out;
}

std::vector<uint8_t> lzw_decode(const uint8_t* data, size_t len, int early) {
  std::vector<uint8_t> out;
  std::vector<std::vector<uint8_t>> table;
  auto reset = [&]() {
    table.clear();
    table.reserve(4096);
    for (int i = 0; i < 256; i++) table.push_back({(uint8_t)i});
    table.push_back({});  // 256 clear
    table.push_back({});  // 257 eod
  };
  reset();
  int code_len = 9;
  uint32_t bitbuf = 0;
  int bits = 0;
  std::vector<uint8_t> prev;
  for (size_t p = 0; p <= len; p++) {
    if (p < len) {
      bitbuf = (bitbuf << 8) | data[p];
      bits += 8;
    } else if (bits < code_len) {
      break;
    }
    while (bits >= code_len) {
      int code = (bitbuf >> (bits - code_len)) & ((1 << code_len) - 1);
      bits -= code_len;
      if (code == 256) {
        reset();
        code_len = 9;
        prev.clear();
        continue;
      }
      if (code == 257) return out;
      std::vector<uint8_t> entry;
      if (code < (int)table.size()) {
        entry = table[code];
      } else if (!prev.empty()) {
        entry = prev;
        entry.push_back(prev[0]);
      } else {
        return out;
      }
      out.insert(out.end(), entry.begin(), entry.end());
      if (!prev.empty() && table.size() < 4096) {
        auto ne = prev;
        ne.push_back(entry[0]);
        table.push_back(ne);
      }
      prev = entry;
      size_t limit = (size_t)(1 << code_len) - (early ? 1 : 0);
      if (table.size() >= limit && code_len < 12) code_len++;
    }
  }
  return out;
}

std::vector<uint8_t> ascii_hex_decode(const uint8_t* data, size_t len) {
  std::vector<uint8_t> out;
  int hi = -1;
  for (size_t p = 0; p < len; p++) {
    uint8_t c = data[p];
    if (c == '>') break;
    int v;
    if (c >= '0' && c <= '9') v = c - '0';
    else if (c >= 'a' && c <= 'f') v = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') v = c - 'A' + 10;
    else continue;
    if (hi < 0) hi = v;
    else {
      out.push_back((uint8_t)(hi * 16 + v));
      hi = -1;
    }
  }
  if (hi >= 0) out.push_back((uint8_t)(hi * 16));
  return out;
}

std::vector<uint8_t> ascii85_decode(const uint8_t* data, size_t len) {
  std::vector<uint8_t> out;
  uint32_t tuple = 0;
  int count = 0;
  size_t p = 0;
  if (len >= 2 && data[0] == '<' && data[1] == '~') p = 2;
  for (; p < len; p++) {
    uint8_t c = data[p];
    if (is_ws(c)) continue;
    if (c == '~') break;
    if (c == 'z' && count == 0) {
      out.insert(out.end(), {0, 0, 0, 0});
      continue;
    }
    if (c < '!' || c > 'u') continue;
    tuple = tuple * 85 + (c - '!');
    if (++count == 5) {
      for (int k = 3; k >= 0; k--) out.push_back((uint8_t)(tuple >> (8 * k)));
      tuple = 0;
      count = 0;
    }
  }
  if (count > 0) {
    for (int k = count; k < 5; k++) tuple = tuple * 85 + 84;
    for (int k = 3; k >= 5 - count; k--) out.push_back((uint8_t)(tuple >> (8 * k)));
  }
  return out;
}

std::vector<uint8_t> run_length_decode(const uint8_t* data, size_t len) {
  std::vector<uint8_t> out;
  size_t p = 0;
  while (p < len) {
    uint8_t l = data[p++];
    if (l == 128) break;
    if (l < 128) {
      size_t n = (size_t)l + 1;
      if (p + n > len) n = len - p;
      out.insert(out.end(), data + p, data + p + n);
      p += n;
    } else {
      if (p >= len) break;
      out.insert(out.end(), (size_t)(257 - l), data[p++]);
    }
  }
  return out;
}

std::vector<uint8_t> apply_predictor(std::vector<uint8_t> in, int predictor,
                                     int colors, int bpc, int columns) {
  if (predictor <= 1) return in;
  int bpp = std::max(1, colors * bpc / 8);
  int rowlen = (columns * colors * bpc + 7) / 8;
  if (predictor == 2) {  // TIFF horizontal differencing (8-bit path)
    if (bpc == 8) {
      for (size_t r = 0; r + rowlen <= in.size(); r += rowlen)
        for (int i = bpp; i < rowlen; i++) in[r + i] = (uint8_t)(in[r + i] + in[r + i - bpp]);
    }
    return in;
  }
  // PNG predictors: each row prefixed by a filter-type byte
  std::vector<uint8_t> out;
  size_t nrows = in.size() / (rowlen + 1);
  out.resize(nrows * rowlen, 0);
  const uint8_t* prev_row = nullptr;
  for (size_t r = 0; r < nrows; r++) {
    const uint8_t* src = in.data() + r * (rowlen + 1);
    uint8_t ft = src[0];
    src++;
    uint8_t* dst = out.data() + r * rowlen;
    for (int i = 0; i < rowlen; i++) {
      int a = i >= bpp ? dst[i - bpp] : 0;                    // left
      int b = prev_row ? prev_row[i] : 0;                      // up
      int c = (prev_row && i >= bpp) ? prev_row[i - bpp] : 0;  // up-left
      int x = src[i];
      switch (ft) {
        case 0: dst[i] = (uint8_t)x; break;
        case 1: dst[i] = (uint8_t)(x + a); break;
        case 2: dst[i] = (uint8_t)(x + b); break;
        case 3: dst[i] = (uint8_t)(x + (a + b) / 2); break;
        case 4: {
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(x + pred);
          break;
        }
        default: dst[i] = (uint8_t)x;
      }
    }
    prev_row = out.data() + r * rowlen;
  }
  return out;
}

static bool is_image_filter(const std::string& f) {
  return f == "DCTDecode" || f == "DCT" || f == "JPXDecode" ||
         f == "CCITTFaxDecode" || f == "CCF" || f == "JBIG2Decode";
}

std::vector<uint8_t> decode_stream(Document* doc, const PObj& stream,
                                   std::string* passthrough) {
  if (passthrough) passthrough->clear();
  std::vector<uint8_t> data = stream->stream_raw;
  PObj filter = stream->at("Filter");
  if (doc) filter = doc->resolve(filter);
  if (!filter || filter->t == Obj::T::Null) return data;
  PObj parms = stream->at("DecodeParms");
  if (!parms) parms = stream->at("DP");
  if (doc) parms = doc->resolve(parms);

  std::vector<PObj> filters, parm_list;
  if (filter->t == Obj::T::Name) {
    filters.push_back(filter);
    parm_list.push_back(parms);
  } else if (filter->t == Obj::T::Array) {
    filters = filter->arr;
    if (parms && parms->t == Obj::T::Array) parm_list = parms->arr;
    parm_list.resize(filters.size());
  }

  for (size_t fi = 0; fi < filters.size(); fi++) {
    PObj f = doc ? doc->resolve(filters[fi]) : filters[fi];
    if (!f || f->t != Obj::T::Name) break;
    const std::string& name = f->s;
    if (is_image_filter(name)) {
      if (passthrough) *passthrough = name;
      return data;
    }
    PObj pm = fi < parm_list.size() ? (doc ? doc->resolve(parm_list[fi]) : parm_list[fi])
                                    : nullptr;
    int predictor = 1, colors = 1, bpc = 8, columns = 1, early = 1;
    if (pm && pm->t == Obj::T::Dict) {
      auto geti = [&](const char* k, int dflt) {
        PObj v = doc ? doc->resolve(pm->at(k)) : pm->at(k);
        return (v && v->is_num()) ? (int)v->as_int() : dflt;
      };
      predictor = geti("Predictor", 1);
      colors = geti("Colors", 1);
      bpc = geti("BitsPerComponent", 8);
      columns = geti("Columns", 1);
      early = geti("EarlyChange", 1);
    }
    if (name == "FlateDecode" || name == "Fl") {
      data = flate_decode(data.data(), data.size());
    } else if (name == "LZWDecode" || name == "LZW") {
      data = lzw_decode(data.data(), data.size(), early);
    } else if (name == "ASCIIHexDecode" || name == "AHx") {
      data = ascii_hex_decode(data.data(), data.size());
    } else if (name == "ASCII85Decode" || name == "A85") {
      data = ascii85_decode(data.data(), data.size());
    } else if (name == "RunLengthDecode" || name == "RL") {
      data = run_length_decode(data.data(), data.size());
    } else if (name == "Crypt") {
      // /Identity only (encryption unsupported)
    } else {
      if (passthrough) *passthrough = name;
      return data;
    }
    if (predictor > 1) data = apply_predictor(std::move(data), predictor, colors, bpc, columns);
  }
  return data;
}

}  // namespace pdfio
