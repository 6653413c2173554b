#include "doc.h"

#include <cstring>

namespace pdfio {

bool Document::open(const uint8_t* data, size_t len, std::string* err) {
  d_ = data;
  n_ = len;
  if (len < 8 || memcmp(data, "%PDF-", 5) != 0) {
    // some files have junk before header; search in first 1KB
    bool found = false;
    for (size_t p = 0; p + 5 < std::min(len, (size_t)1024); p++) {
      if (memcmp(data + p, "%PDF-", 5) == 0) {
        found = true;
        break;
      }
    }
    if (!found) {
      if (err) *err = "not a PDF (missing %PDF header)";
      return false;
    }
  }
  // find startxref near EOF
  size_t tail = std::min(n_, (size_t)2048);
  size_t sx = std::string::npos;
  for (size_t p = n_ - tail; p + 9 <= n_; p++) {
    if (d_[p] == 's' && memcmp(d_ + p, "startxref", 9) == 0) sx = p;
  }
  bool ok = false;
  if (sx != std::string::npos) {
    Parser p(d_, n_, this);
    p.pos = sx + 9;
    long long off = p.read_int();
    if (off > 0 && (size_t)off < n_) ok = parse_xref_at((size_t)off, 0);
  }
  if (!ok || !trailer_ || !trailer_->at("Root")) {
    reconstruct_xref();
  }
  if (trailer_ && dget(trailer_, "Encrypt")) {
    if (err) *err = "encrypted PDF not supported";
    return false;
  }
  PObj root = trailer_ ? dget(trailer_, "Root") : nullptr;
  PObj page_root = root ? dget(root, "Pages") : nullptr;
  if (!page_root) {
    // last resort: find any /Type /Pages object with no parent
    for (auto& [num, entry] : xref_) {
      PObj o = get(num);
      if (o && o->t == Obj::T::Dict) {
        PObj ty = o->at("Type");
        if (ty && ty->t == Obj::T::Name && ty->s == "Pages" && !o->at("Parent")) {
          page_root = o;
          break;
        }
      }
    }
  }
  if (!page_root) {
    if (err) *err = "no page tree found";
    return false;
  }
  double mb[4] = {0, 0, 612, 792};
  build_pages(page_root, nullptr, mb, 0, 0);
  if (pages_.empty()) {
    if (err) *err = "document has zero pages";
    return false;
  }
  return true;
}

bool Document::parse_xref_at(size_t offset, int depth) {
  if (depth > 32 || offset >= n_) return false;
  Parser p(d_, n_, this);
  p.pos = offset;
  if (p.at_keyword("xref")) {
    p.next_keyword();
    if (!parse_xref_table(p)) return false;
    // trailer
    if (p.at_keyword("trailer")) {
      p.next_keyword();
      PObj tr = p.parse_object();
      if (tr && tr->t == Obj::T::Dict) {
        if (!trailer_) trailer_ = tr;
        else {
          for (auto& [k, v] : tr->dict)
            if (!trailer_->at(k)) trailer_->dict[k] = v;
        }
        PObj xs = tr->at("XRefStm");
        if (xs && xs->is_num()) parse_xref_at((size_t)xs->as_int(), depth + 1);
        PObj prev = tr->at("Prev");
        if (prev && prev->is_num()) parse_xref_at((size_t)prev->as_int(), depth + 1);
      }
    }
    return true;
  }
  // xref stream: an indirect object
  PObj o = p.parse_indirect();
  if (o && o->t == Obj::T::Stream) {
    if (!trailer_) {
      trailer_ = Obj::make(Obj::T::Dict);
      trailer_->dict = o->dict;
    } else {
      for (auto& [k, v] : o->dict)
        if (!trailer_->at(k)) trailer_->dict[k] = v;
    }
    bool ok = parse_xref_stream(o);
    PObj prev = o->at("Prev");
    if (prev && prev->is_num()) parse_xref_at((size_t)prev->as_int(), depth + 1);
    return ok;
  }
  return false;
}

bool Document::parse_xref_table(Parser& p) {
  while (true) {
    if (!p.skip_ws()) return true;
    uint8_t c = p.data()[p.pos];
    if (c < '0' || c > '9') return true;  // next keyword (trailer)
    long long start = p.read_int();
    long long count = p.read_int();
    if (count < 0 || count > 10000000) return false;
    for (long long k = 0; k < count; k++) {
      p.skip_ws();
      long long f1 = p.read_int();
      long long f2 = p.read_int();
      p.skip_ws();
      char ty = (char)p.data()[p.pos];
      p.pos++;
      int num = (int)(start + k);
      if (ty == 'n' && xref_.find(num) == xref_.end()) {
        XrefEntry e;
        e.type = 1;
        e.offset = (size_t)f1;
        e.gen = (int)f2;
        xref_[num] = e;
      } else if (ty == 'f' && xref_.find(num) == xref_.end()) {
        XrefEntry e;
        e.type = 0;
        xref_[num] = e;
      }
    }
  }
}

bool Document::parse_xref_stream(PObj stream) {
  std::vector<uint8_t> data = decoded(stream);
  PObj w = dget(stream, "W");
  if (!w || w->t != Obj::T::Array || w->arr.size() < 3) return false;
  int w0 = (int)resolve(w->arr[0])->as_int();
  int w1 = (int)resolve(w->arr[1])->as_int();
  int w2 = (int)resolve(w->arr[2])->as_int();
  int rec = w0 + w1 + w2;
  if (rec <= 0) return false;
  std::vector<std::pair<int, int>> index;  // (start, count)
  PObj idx = dget(stream, "Index");
  if (idx && idx->t == Obj::T::Array) {
    for (size_t k = 0; k + 1 < idx->arr.size(); k += 2)
      index.push_back({(int)resolve(idx->arr[k])->as_int(),
                       (int)resolve(idx->arr[k + 1])->as_int()});
  } else {
    PObj size = dget(stream, "Size");
    index.push_back({0, size ? (int)size->as_int() : (int)(data.size() / rec)});
  }
  size_t p = 0;
  auto read_field = [&](int width, long long dflt) -> long long {
    if (width == 0) return dflt;
    long long v = 0;
    for (int k = 0; k < width && p < data.size(); k++) v = (v << 8) | data[p++];
    return v;
  };
  for (auto& [start, count] : index) {
    for (int k = 0; k < count && p < data.size(); k++) {
      long long type = read_field(w0, 1);
      long long f2 = read_field(w1, 0);
      long long f3 = read_field(w2, 0);
      int num = start + k;
      if (xref_.find(num) != xref_.end()) continue;
      XrefEntry e;
      if (type == 1) {
        e.type = 1;
        e.offset = (size_t)f2;
        e.gen = (int)f3;
      } else if (type == 2) {
        e.type = 2;
        e.offset = (size_t)f2;  // containing objstm number
        e.gen = (int)f3;        // index within
      } else {
        e.type = 0;
      }
      xref_[num] = e;
    }
  }
  return true;
}

void Document::reconstruct_xref() {
  // scan for "N G obj" headers across the whole file
  for (size_t p = 0; p + 4 < n_; p++) {
    if (d_[p] == 'o' && memcmp(d_ + p, "obj", 3) == 0 &&
        (p + 3 >= n_ || is_ws(d_[p + 3]) || is_delim(d_[p + 3]))) {
      // walk back: ws, gen digits, ws, num digits
      size_t q = p;
      auto back_ws = [&]() { while (q > 0 && is_ws(d_[q - 1])) q--; };
      auto back_digits = [&]() {
        size_t s = q;
        while (q > 0 && d_[q - 1] >= '0' && d_[q - 1] <= '9') q--;
        return s != q;
      };
      back_ws();
      if (!back_digits()) continue;
      size_t gen_end = q;
      (void)gen_end;
      back_ws();
      size_t num_end = q;
      if (!back_digits()) continue;
      int num = atoi(std::string((const char*)d_ + q, num_end - q).c_str());
      XrefEntry e;
      e.type = 1;
      e.offset = q;
      xref_[num] = e;  // later occurrences win (incremental updates)
    }
  }
  // find trailer dict
  if (!trailer_ || !trailer_->at("Root")) {
    for (size_t p = n_; p >= 8; p--) {
      if (d_[p - 1] == 'r' && p >= 7 && memcmp(d_ + p - 7, "trailer", 7) == 0) {
        Parser pr(d_, n_, this);
        pr.pos = p;
        PObj tr = pr.parse_object();
        if (tr && tr->t == Obj::T::Dict && tr->at("Root")) {
          trailer_ = tr;
          break;
        }
      }
    }
  }
  if (!trailer_ || !trailer_->at("Root")) {
    // look for a /Type /Catalog object
    for (auto& [num, entry] : xref_) {
      PObj o = get(num);
      if (o && (o->t == Obj::T::Dict || o->t == Obj::T::Stream)) {
        PObj ty = o->at("Type");
        if (ty && ty->t == Obj::T::Name && ty->s == "Catalog") {
          trailer_ = Obj::make(Obj::T::Dict);
          auto ref = Obj::make(Obj::T::Ref);
          ref->ref_num = num;
          trailer_->dict["Root"] = ref;
          break;
        }
      }
    }
  }
}

PObj Document::load_from_objstm(int stm_num, int idx) {
  PObj stm = get(stm_num);
  if (!stm || stm->t != Obj::T::Stream) return nullptr;
  std::vector<uint8_t> data = decoded(stm);
  int n = (int)dnum(stm, "N", 0);
  int first = (int)dnum(stm, "First", 0);
  if (idx >= n) return nullptr;
  Parser hp(data.data(), data.size(), this);
  long long obj_num = 0, obj_off = 0;
  for (int k = 0; k <= idx; k++) {
    obj_num = hp.read_int();
    obj_off = hp.read_int();
  }
  (void)obj_num;
  Parser op(data.data(), data.size(), this);
  op.pos = (size_t)(first + obj_off);
  if (op.pos >= data.size()) return nullptr;
  return op.parse_object();
}

PObj Document::get(int num) {
  auto it = cache_.find(num);
  if (it != cache_.end()) return it->second;
  auto xit = xref_.find(num);
  if (xit == xref_.end()) return nullptr;
  if (loading_.count(num)) return nullptr;  // cycle
  loading_.insert(num);
  PObj o;
  const XrefEntry& e = xit->second;
  if (e.type == 1 && e.offset < n_) {
    Parser p(d_, n_, this);
    p.pos = e.offset;
    int got_num = -1;
    o = p.parse_indirect(&got_num);
    if (o && got_num != num && got_num >= 0) {
      // stale xref; fall back to reconstruction semantics: ignore mismatch
    }
  } else if (e.type == 2) {
    o = load_from_objstm((int)e.offset, e.gen);
  }
  loading_.erase(num);
  cache_[num] = o;
  return o;
}

PObj Document::resolve(PObj o) {
  int depth = 0;
  while (o && o->t == Obj::T::Ref && depth++ < 32) o = get(o->ref_num);
  return o;
}

void Document::build_pages(PObj node, PObj inherited_res, const double* inherited_mb,
                           int inherited_rot, int depth) {
  node = resolve(node);
  if (!node || node->t != Obj::T::Dict || depth > 64 || pages_.size() > 50000) return;
  PObj res = dget(node, "Resources");
  if (!res) res = inherited_res;
  double mb[4] = {inherited_mb[0], inherited_mb[1], inherited_mb[2], inherited_mb[3]};
  PObj mbo = dget(node, "MediaBox");
  if (mbo && mbo->t == Obj::T::Array && mbo->arr.size() == 4) {
    for (int k = 0; k < 4; k++) {
      PObj v = resolve(mbo->arr[k]);
      if (v && v->is_num()) mb[k] = v->num();
    }
  }
  int rot = inherited_rot;
  PObj ro = dget(node, "Rotate");
  if (ro && ro->is_num()) rot = (int)ro->as_int();

  PObj ty = dget(node, "Type");
  bool is_page = ty && ty->t == Obj::T::Name && ty->s == "Page";
  PObj kids = dget(node, "Kids");
  if (!is_page && kids && kids->t == Obj::T::Array) {
    for (auto& kid : kids->arr) build_pages(kid, res, mb, rot, depth + 1);
    return;
  }
  if (is_page || node->at("Contents")) {
    Page pg;
    pg.node = node;
    pg.resources = res;
    for (int k = 0; k < 4; k++) pg.media[k] = mb[k];
    pg.rotate = ((rot % 360) + 360) % 360;
    pages_.push_back(pg);
  }
}

}  // namespace pdfio
