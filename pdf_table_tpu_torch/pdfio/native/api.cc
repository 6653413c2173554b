// C API for the pdfio library (consumed from Python via ctypes).
#include <cstdlib>
#include <cstring>
#include <string>

#include "content.h"
#include "doc.h"
#include "json.h"

using namespace pdfio;

namespace {

struct DocHandle {
  std::vector<uint8_t> bytes;  // own a copy: Python buffer may be freed
  Document doc;
};

char* dup_cstr(const std::string& s) {
  char* p = (char*)malloc(s.size() + 1);
  memcpy(p, s.data(), s.size());
  p[s.size()] = 0;
  return p;
}

}  // namespace

extern "C" {

const char* pdfio_version() { return "pdfio-0.1.0"; }

void* pdfio_open(const uint8_t* data, size_t len, char** err) {
  auto* h = new DocHandle();
  h->bytes.assign(data, data + len);
  std::string e;
  if (!h->doc.open(h->bytes.data(), h->bytes.size(), &e)) {
    if (err) *err = dup_cstr(e);
    delete h;
    return nullptr;
  }
  if (err) *err = nullptr;
  return h;
}

void pdfio_close(void* handle) { delete (DocHandle*)handle; }

int pdfio_page_count(void* handle) {
  return ((DocHandle*)handle)->doc.page_count();
}

// Returns malloc'd JSON describing the page: mediabox, rotate, text runs,
// segments, rects, curves, image placements.
char* pdfio_extract_page(void* handle, int page_idx, char** err) {
  auto* h = (DocHandle*)handle;
  if (page_idx < 0 || page_idx >= h->doc.page_count()) {
    if (err) *err = dup_cstr("page index out of range");
    return nullptr;
  }
  const Page& pg = h->doc.page(page_idx);
  PageContent pc = extract_page_content(&h->doc, pg);

  JsonWriter w;
  w.begin_obj();
  w.key("media_box");
  w.begin_arr();
  for (int k = 0; k < 4; k++) w.num(pg.media[k]);
  w.end_arr();
  w.key("rotate");
  w.integer(pg.rotate);

  w.key("texts");
  w.begin_arr();
  for (auto& t : pc.texts) {
    w.begin_obj();
    w.key("text");
    w.str(t.utf8);
    w.key("bbox");
    w.begin_arr();
    w.num(t.x0); w.num(t.y0); w.num(t.x1); w.num(t.y1);
    w.end_arr();
    w.key("origin");
    w.begin_arr();
    w.num(t.ox); w.num(t.oy);
    w.end_arr();
    w.key("dir");
    w.begin_arr();
    w.num(t.dx); w.num(t.dy);
    w.end_arr();
    w.key("size");
    w.num(t.size);
    w.key("font");
    w.str(t.font);
    w.key("adv");
    w.begin_arr();
    for (double a : t.adv) w.num(a);
    w.end_arr();
    if (t.rmode == 3) {
      w.key("invisible");
      w.boolean(true);
    }
    w.end_obj();
  }
  w.end_arr();

  w.key("segs");
  w.begin_arr();
  for (auto& s : pc.segs) {
    w.begin_obj();
    w.key("p");
    w.begin_arr();
    w.num(s.x0); w.num(s.y0); w.num(s.x1); w.num(s.y1);
    w.end_arr();
    w.key("lw");
    w.num(s.lw);
    if (s.is_fill) {
      w.key("fill");
      w.boolean(true);
    }
    w.end_obj();
  }
  w.end_arr();

  w.key("rects");
  w.begin_arr();
  for (auto& r : pc.rects) {
    w.begin_obj();
    w.key("bbox");
    w.begin_arr();
    w.num(r.x0); w.num(r.y0); w.num(r.x1); w.num(r.y1);
    w.end_arr();
    w.key("lw");
    w.num(r.lw);
    w.key("stroked");
    w.boolean(r.stroked != 0);
    w.key("filled");
    w.boolean(r.filled != 0);
    w.end_obj();
  }
  w.end_arr();

  w.key("curves");
  w.begin_arr();
  for (auto& c : pc.curves) {
    w.begin_arr();
    for (double v : c.pts) w.num(v);
    w.end_arr();
  }
  w.end_arr();

  w.key("images");
  w.begin_arr();
  for (auto& im : pc.images) {
    w.begin_obj();
    w.key("bbox");
    w.begin_arr();
    w.num(im.x0); w.num(im.y0); w.num(im.x1); w.num(im.y1);
    w.end_arr();
    w.key("obj");
    w.integer(im.obj_num);
    w.key("width");
    w.integer(im.width);
    w.key("height");
    w.integer(im.height);
    w.key("bpc");
    w.integer(im.bpc);
    w.key("colorspace");
    w.str(im.colorspace);
    w.key("filter");
    w.str(im.filter);
    w.end_obj();
  }
  w.end_arr();

  w.end_obj();
  if (err) *err = nullptr;
  return dup_cstr(w.out);
}

// Fetch an image XObject's bytes by object number. kind: 0=decoded raw
// samples, 1=passthrough-encoded (e.g. JPEG bytes for DCTDecode).
uint8_t* pdfio_get_image(void* handle, int obj_num, size_t* out_len, int* kind) {
  auto* h = (DocHandle*)handle;
  PObj o = h->doc.get(obj_num);
  if (!o || o->t != Obj::T::Stream) {
    *out_len = 0;
    return nullptr;
  }
  std::string passthrough;
  std::vector<uint8_t> data = h->doc.decoded(o, &passthrough);
  *kind = passthrough.empty() ? 0 : 1;
  *out_len = data.size();
  uint8_t* p = (uint8_t*)malloc(data.size());
  memcpy(p, data.data(), data.size());
  return p;
}

// Embedded font program for a page font, matched by /BaseFont name.
// fmt: 2 = FontFile2 (TrueType), 3 = FontFile3 (CFF/OpenType),
// 1 = FontFile (Type1). Returns malloc'd decoded bytes or nullptr when
// the font is not embedded. Walks /Resources /Font (and Type0
// descendants) of the page.
uint8_t* pdfio_get_font_program(void* handle, int page_idx,
                                const char* base_name, size_t* out_len,
                                int* fmt) {
  auto* h = (DocHandle*)handle;
  if (out_len) *out_len = 0;
  if (fmt) *fmt = 0;
  if (page_idx < 0 || page_idx >= h->doc.page_count()) return nullptr;
  Document* doc = &h->doc;
  const Page& pg = doc->page(page_idx);
  PObj fonts = doc->dget(pg.resources, "Font");
  if (!fonts || fonts->t != Obj::T::Dict) return nullptr;
  for (auto& kv : fonts->dict) {
    PObj fd = doc->resolve(kv.second);
    if (!fd || fd->t != Obj::T::Dict) continue;
    PObj bn = doc->dget(fd, "BaseFont");
    if (!bn || bn->t != Obj::T::Name || bn->s != base_name) continue;
    PObj desc = doc->dget(fd, "FontDescriptor");
    if (!desc) {
      PObj df = doc->dget(fd, "DescendantFonts");
      if (df && df->t == Obj::T::Array && !df->arr.empty()) {
        PObj cidf = doc->resolve(df->arr[0]);
        if (cidf) desc = doc->dget(cidf, "FontDescriptor");
      }
    }
    if (!desc || desc->t != Obj::T::Dict) continue;
    static const struct { const char* key; int code; } kKeys[] = {
        {"FontFile2", 2}, {"FontFile3", 3}, {"FontFile", 1}};
    for (auto& k : kKeys) {
      PObj ff = doc->dget(desc, k.key);
      if (ff && ff->t == Obj::T::Stream) {
        std::vector<uint8_t> data = doc->decoded(ff);
        if (data.empty()) continue;
        uint8_t* out = (uint8_t*)malloc(data.size());
        if (!out) return nullptr;
        memcpy(out, data.data(), data.size());
        if (out_len) *out_len = data.size();
        if (fmt) *fmt = k.code;
        return out;
      }
    }
  }
  return nullptr;
}

void pdfio_free(void* p) { free(p); }

}  // extern "C"
