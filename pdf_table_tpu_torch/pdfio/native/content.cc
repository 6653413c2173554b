#include "content.h"

#include <cmath>
#include <cstring>

namespace pdfio {

namespace {

// 2x3 affine matrix [a b c d e f]: (x,y) -> (a*x+c*y+e, b*x+d*y+f)
struct Mat {
  double a = 1, b = 0, c = 0, d = 1, e = 0, f = 0;
  static Mat mul(const Mat& m, const Mat& n) {  // m then n  (m×n)
    Mat r;
    r.a = m.a * n.a + m.b * n.c;
    r.b = m.a * n.b + m.b * n.d;
    r.c = m.c * n.a + m.d * n.c;
    r.d = m.c * n.b + m.d * n.d;
    r.e = m.e * n.a + m.f * n.c + n.e;
    r.f = m.e * n.b + m.f * n.d + n.f;
    return r;
  }
  void apply(double x, double y, double* ox, double* oy) const {
    *ox = a * x + c * y + e;
    *oy = b * x + d * y + f;
  }
  double scale_mag() const { return std::sqrt(std::fabs(a * d - b * c)); }
};

struct GState {
  Mat ctm;
  double line_width = 1.0;
};

struct TState {
  Mat tm, tlm;
  double size = 0, char_sp = 0, word_sp = 0, hscale = 1.0, leading = 0, rise = 0;
  int rmode = 0;
  const Font* font = nullptr;
  std::string font_res_name;
};

struct PathPt {
  double x, y;
  bool move;
  bool curve_flag;  // produced by a curve op
};

class Interp {
 public:
  Interp(Document* doc, PageContent* out) : doc_(doc), out_(out) {}

  void run(const std::vector<uint8_t>& content, PObj resources, const Mat& base,
           int depth) {
    if (depth > 12) return;
    resources_stack_.push_back(resources);
    GState gs;
    gs.ctm = base;
    gstack_.push_back(gs);
    exec(content, depth);
    gstack_.pop_back();
    resources_stack_.pop_back();
  }

 private:
  Document* doc_;
  PageContent* out_;
  std::vector<PObj> resources_stack_;
  std::vector<GState> gstack_;
  TState ts_;
  std::vector<PathPt> path_;
  std::map<std::string, Font> font_cache_;

  GState& gs() { return gstack_.back(); }

  PObj find_resource(const char* category, const std::string& name) {
    for (auto it = resources_stack_.rbegin(); it != resources_stack_.rend(); ++it) {
      PObj res = doc_->resolve(*it);
      if (!res) continue;
      PObj cat = doc_->dget(res, category);
      if (!cat) continue;
      PObj o = doc_->dget(cat, name);
      if (o) return o;
    }
    return nullptr;
  }

  const Font* get_font(const std::string& res_name) {
    std::string key = res_name;
    auto it = font_cache_.find(key);
    if (it != font_cache_.end()) return &it->second;
    PObj fd = find_resource("Font", res_name);
    font_cache_[key] = load_font(doc_, fd);
    return &font_cache_[key];
  }

  // ---- path ----------------------------------------------------------

  void flush_path(bool stroke, bool fill) {
    if (path_.empty() || (!stroke && !fill)) {
      path_.clear();
      return;
    }
    double lw = gs().line_width * gs().ctm.scale_mag();
    // split into subpaths
    size_t s = 0;
    while (s < path_.size()) {
      size_t e = s + 1;
      while (e < path_.size() && !path_[e].move) e++;
      emit_subpath(s, e, stroke, fill, lw);
      s = e;
    }
    path_.clear();
  }

  void emit_subpath(size_t s, size_t e, bool stroke, bool fill, double lw) {
    size_t n = e - s;
    if (n < 2) return;
    bool any_curve = false;
    for (size_t k = s; k < e; k++)
      if (path_[k].curve_flag) any_curve = true;

    // axis-aligned closed rectangle detection (4 or 5 pts)
    if (!any_curve && (n == 4 || n == 5)) {
      double xs[5], ys[5];
      for (size_t k = 0; k < n; k++) {
        xs[k] = path_[s + k].x;
        ys[k] = path_[s + k].y;
      }
      size_t m = n == 5 ? 4 : 4;  // ignore closing pt if repeated
      double minx = xs[0], maxx = xs[0], miny = ys[0], maxy = ys[0];
      bool axis = true;
      for (size_t k = 0; k < m; k++) {
        size_t j = (k + 1) % m;
        if (std::fabs(xs[k] - xs[j]) > 1e-6 && std::fabs(ys[k] - ys[j]) > 1e-6)
          axis = false;
        minx = std::min(minx, xs[k]);
        maxx = std::max(maxx, xs[k]);
        miny = std::min(miny, ys[k]);
        maxy = std::max(maxy, ys[k]);
      }
      if (axis && maxx > minx - 1e-9 && maxy > miny - 1e-9) {
        RectItem r{minx, miny, maxx, maxy, lw, stroke ? 1 : 0, fill ? 1 : 0};
        out_->rects.push_back(r);
        // thin filled rects double as line segments for the lattice layer
        if (fill) {
          double w = maxx - minx, h = maxy - miny;
          if (h <= 4.0 && w > h * 2) {
            out_->segs.push_back({minx, (miny + maxy) / 2, maxx, (miny + maxy) / 2,
                                  std::max(h, lw), 1});
          } else if (w <= 4.0 && h > w * 2) {
            out_->segs.push_back({(minx + maxx) / 2, miny, (minx + maxx) / 2, maxy,
                                  std::max(w, lw), 1});
          }
        }
        if (stroke) {
          out_->segs.push_back({minx, miny, maxx, miny, lw, 0});
          out_->segs.push_back({minx, maxy, maxx, maxy, lw, 0});
          out_->segs.push_back({minx, miny, minx, maxy, lw, 0});
          out_->segs.push_back({maxx, miny, maxx, maxy, lw, 0});
        }
        return;
      }
    }

    if (any_curve) {
      CurveItem c;
      for (size_t k = s; k < e; k++) {
        c.pts.push_back(path_[k].x);
        c.pts.push_back(path_[k].y);
      }
      out_->curves.push_back(c);
      if (!stroke) return;
    }
    if (stroke) {
      for (size_t k = s; k + 1 < e; k++) {
        if (path_[k + 1].curve_flag || path_[k].curve_flag) continue;
        out_->segs.push_back({path_[k].x, path_[k].y, path_[k + 1].x, path_[k + 1].y,
                              lw, 0});
      }
    }
  }

  void path_add(double x, double y, bool move, bool curve = false) {
    double dx, dy;
    gs().ctm.apply(x, y, &dx, &dy);
    path_.push_back({dx, dy, move, curve});
  }

  // ---- text ----------------------------------------------------------

  void show_text(const std::string& raw) {
    if (!ts_.font) return;
    const Font& f = *ts_.font;
    std::vector<int> codes;
    f.codes(raw, &codes);
    if (codes.empty()) return;

    // Trm = [Tfs*Th 0 0 Tfs 0 Ts] × Tm × CTM at the run start
    Mat param;
    param.a = ts_.size * ts_.hscale;
    param.d = ts_.size;
    param.f = ts_.rise;
    Mat trm = Mat::mul(Mat::mul(param, ts_.tm), gs().ctm);

    TextRun run;
    run.font = f.base_name.empty() ? ts_.font_res_name : f.base_name;
    run.rmode = ts_.rmode;
    double ox, oy;
    trm.apply(0, 0, &ox, &oy);
    run.ox = ox;
    run.oy = oy;
    // baseline direction = image of (1,0) direction under trm
    double bx, by;
    trm.apply(1, 0, &bx, &by);
    double blen = std::hypot(bx - ox, by - oy);
    run.dx = blen > 0 ? (bx - ox) / blen : 1.0;
    run.dy = blen > 0 ? (by - oy) / blen : 0.0;
    // device font size: image of unit vertical vector
    double vx, vy;
    trm.apply(0, 1, &vx, &vy);
    run.size = std::hypot(vx - ox, vy - oy);

    // blen = |trm x-column| = Tfs*Th*|ctm x-scale|; a text-space advance of
    // `adv` moves adv/(Tfs*Th) in param-input space -> adv/(Tfs*Th)*blen in
    // device space.
    double sfac = ts_.size * ts_.hscale;
    double dev_per_text = sfac != 0 ? blen / sfac : blen;
    double tx_total = 0;  // text-space advance accumulator
    for (int code : codes) {
      double w0 = f.width(code) / 1000.0;
      double adv = (w0 * ts_.size + ts_.char_sp +
                    ((!f.is_cid && code == 32) ? ts_.word_sp : 0.0)) *
                   ts_.hscale;
      int uni = f.unicode(code);
      if (uni == 0) uni = 0xFFFD;
      append_utf8(&run.utf8, uni);
      run.adv.push_back(adv * dev_per_text);
      tx_total += adv;
    }

    // Quad corners: trm already contains size & hscale (param matrix), so
    // express the run extent in *unscaled* glyph space: x in [0, tx/sx],
    // y in [descent, ascent] em units.
    double sx = ts_.size * ts_.hscale;
    double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
    double cx[4] = {0, tx_total / (sx == 0 ? 1 : sx), tx_total / (sx == 0 ? 1 : sx), 0};
    double cy[4] = {f.descent, f.descent, f.ascent, f.ascent};
    for (int k = 0; k < 4; k++) {
      double px, py;
      trm.apply(cx[k], cy[k], &px, &py);
      minx = std::min(minx, px);
      maxx = std::max(maxx, px);
      miny = std::min(miny, py);
      maxy = std::max(maxy, py);
    }
    run.x0 = minx;
    run.y0 = miny;
    run.x1 = maxx;
    run.y1 = maxy;
    if (!run.utf8.empty()) out_->texts.push_back(std::move(run));

    // advance Tm
    Mat shift;
    shift.e = tx_total;
    ts_.tm = Mat::mul(shift, ts_.tm);
  }

  void tj_adjust(double amount) {
    double tx = -amount / 1000.0 * ts_.size * ts_.hscale;
    Mat shift;
    shift.e = tx;
    ts_.tm = Mat::mul(shift, ts_.tm);
  }

  void newline(double tx, double ty) {
    Mat shift;
    shift.e = tx;
    shift.f = ty;
    ts_.tlm = Mat::mul(shift, ts_.tlm);
    ts_.tm = ts_.tlm;
  }

  // ---- xobjects -------------------------------------------------------

  void do_xobject(const std::string& name, int depth) {
    PObj xo = find_resource("XObject", name);
    if (!xo) return;
    // resolve to get the object number for image fetch
    int obj_num = -1;
    PObj raw;
    for (auto it = resources_stack_.rbegin(); it != resources_stack_.rend(); ++it) {
      PObj res = doc_->resolve(*it);
      PObj cat = res ? doc_->dget(res, "XObject") : nullptr;
      if (cat) {
        raw = cat->at(name);
        if (raw) break;
      }
    }
    if (raw && raw->t == Obj::T::Ref) obj_num = raw->ref_num;
    PObj st = doc_->dget(xo, "Subtype");
    std::string sub = st && st->t == Obj::T::Name ? st->s : "";
    if (sub == "Image") {
      ImagePlacement im;
      im.obj_num = obj_num;
      im.name = name;
      im.width = (int)doc_->dnum(xo, "Width", 0);
      im.height = (int)doc_->dnum(xo, "Height", 0);
      im.bpc = (int)doc_->dnum(xo, "BitsPerComponent", 8);
      PObj cs = doc_->dget(xo, "ColorSpace");
      if (cs && cs->t == Obj::T::Name) im.colorspace = cs->s;
      else if (cs && cs->t == Obj::T::Array && !cs->arr.empty()) {
        PObj c0 = doc_->resolve(cs->arr[0]);
        if (c0 && c0->t == Obj::T::Name) im.colorspace = c0->s;
      }
      PObj flt = doc_->dget(xo, "Filter");
      if (flt && flt->t == Obj::T::Name) im.filter = flt->s;
      else if (flt && flt->t == Obj::T::Array && !flt->arr.empty()) {
        PObj f0 = doc_->resolve(flt->arr.back());
        if (f0 && f0->t == Obj::T::Name) im.filter = f0->s;
      }
      // unit square through CTM
      double xs[4], ys[4];
      gs().ctm.apply(0, 0, &xs[0], &ys[0]);
      gs().ctm.apply(1, 0, &xs[1], &ys[1]);
      gs().ctm.apply(1, 1, &xs[2], &ys[2]);
      gs().ctm.apply(0, 1, &xs[3], &ys[3]);
      im.x0 = std::min(std::min(xs[0], xs[1]), std::min(xs[2], xs[3]));
      im.x1 = std::max(std::max(xs[0], xs[1]), std::max(xs[2], xs[3]));
      im.y0 = std::min(std::min(ys[0], ys[1]), std::min(ys[2], ys[3]));
      im.y1 = std::max(std::max(ys[0], ys[1]), std::max(ys[2], ys[3]));
      out_->images.push_back(im);
    } else if (sub == "Form") {
      Mat m = gs().ctm;
      PObj mtx = doc_->dget(xo, "Matrix");
      if (mtx && mtx->t == Obj::T::Array && mtx->arr.size() == 6) {
        Mat fm;
        double v[6];
        for (int k = 0; k < 6; k++) {
          PObj e = doc_->resolve(mtx->arr[k]);
          v[k] = e && e->is_num() ? e->num() : (k == 0 || k == 3 ? 1.0 : 0.0);
        }
        fm.a = v[0]; fm.b = v[1]; fm.c = v[2]; fm.d = v[3]; fm.e = v[4]; fm.f = v[5];
        m = Mat::mul(fm, gs().ctm);
      }
      PObj res = doc_->dget(xo, "Resources");
      std::vector<uint8_t> data = doc_->decoded(xo);
      // preserve text state across form? PDF spec: forms inherit gs; run nested.
      Interp sub_interp(doc_, out_);
      sub_interp.run(data, res ? res : resources_stack_.back(), m, depth + 1);
    }
  }

  // ---- main loop ------------------------------------------------------

  void exec(const std::vector<uint8_t>& content, int depth) {
    Parser p(content.data(), content.size(), doc_);
    std::vector<PObj> stack;
    auto num = [&](int from_top) -> double {
      size_t n = stack.size();
      if (from_top >= (int)n) return 0.0;
      PObj o = stack[n - 1 - from_top];
      return o && o->is_num() ? o->num() : 0.0;
    };
    while (p.skip_ws()) {
      uint8_t c = p.data()[p.pos];
      if (c == '(' || c == '<' || c == '[' || c == '/' ||
          (c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.') {
        PObj o = p.parse_object();
        if (o) stack.push_back(o);
        continue;
      }
      std::string op = p.next_keyword();
      if (op.empty()) {
        p.pos++;
        continue;
      }
      // graphics state
      if (op == "q") {
        gstack_.push_back(gs());
      } else if (op == "Q") {
        if (gstack_.size() > 1) gstack_.pop_back();
      } else if (op == "cm" && stack.size() >= 6) {
        Mat m;
        m.a = num(5); m.b = num(4); m.c = num(3); m.d = num(2); m.e = num(1); m.f = num(0);
        gs().ctm = Mat::mul(m, gs().ctm);
      } else if (op == "w" && !stack.empty()) {
        gs().line_width = num(0);
      }
      // path construction
      else if (op == "m" && stack.size() >= 2) {
        path_add(num(1), num(0), true);
      } else if (op == "l" && stack.size() >= 2) {
        path_add(num(1), num(0), false);
      } else if (op == "c" && stack.size() >= 6) {
        path_add(num(5), num(4), false, true);
        path_add(num(3), num(2), false, true);
        path_add(num(1), num(0), false, true);
      } else if (op == "v" && stack.size() >= 4) {
        path_add(num(3), num(2), false, true);
        path_add(num(1), num(0), false, true);
      } else if (op == "y" && stack.size() >= 4) {
        path_add(num(3), num(2), false, true);
        path_add(num(1), num(0), false, true);
      } else if (op == "h") {
        // close: repeat subpath start
        for (auto it = path_.rbegin(); it != path_.rend(); ++it) {
          if (it->move) {
            path_.push_back({it->x, it->y, false, false});
            break;
          }
        }
      } else if (op == "re" && stack.size() >= 4) {
        double x = num(3), y = num(2), w = num(1), h = num(0);
        path_add(x, y, true);
        path_add(x + w, y, false);
        path_add(x + w, y + h, false);
        path_add(x, y + h, false);
        path_add(x, y, false);
      }
      // path painting
      else if (op == "S") flush_path(true, false);
      else if (op == "s") { flush_path(true, false); }
      else if (op == "f" || op == "F" || op == "f*") flush_path(false, true);
      else if (op == "B" || op == "B*" || op == "b" || op == "b*")
        flush_path(true, true);
      else if (op == "n") flush_path(false, false);
      else if (op == "W" || op == "W*") { /* clip: ignored */ }
      // text
      else if (op == "BT") {
        ts_.tm = Mat();
        ts_.tlm = Mat();
      } else if (op == "ET") {
      } else if (op == "Tf" && stack.size() >= 2) {
        PObj fo = stack[stack.size() - 2];
        if (fo && fo->t == Obj::T::Name) {
          ts_.font_res_name = fo->s;
          ts_.font = get_font(fo->s);
        }
        ts_.size = num(0);
      } else if (op == "Td" && stack.size() >= 2) {
        newline(num(1), num(0));
      } else if (op == "TD" && stack.size() >= 2) {
        ts_.leading = -num(0);
        newline(num(1), num(0));
      } else if (op == "Tm" && stack.size() >= 6) {
        Mat m;
        m.a = num(5); m.b = num(4); m.c = num(3); m.d = num(2); m.e = num(1); m.f = num(0);
        ts_.tm = m;
        ts_.tlm = m;
      } else if (op == "T*") {
        newline(0, -ts_.leading);
      } else if (op == "TL" && !stack.empty()) {
        ts_.leading = num(0);
      } else if (op == "Tc" && !stack.empty()) {
        ts_.char_sp = num(0);
      } else if (op == "Tw" && !stack.empty()) {
        ts_.word_sp = num(0);
      } else if (op == "Tz" && !stack.empty()) {
        ts_.hscale = num(0) / 100.0;
      } else if (op == "Ts" && !stack.empty()) {
        ts_.rise = num(0);
      } else if (op == "Tr" && !stack.empty()) {
        ts_.rmode = (int)num(0);
      } else if (op == "Tj" && !stack.empty()) {
        PObj s = stack.back();
        if (s && s->t == Obj::T::Str) show_text(s->s);
      } else if (op == "'" && !stack.empty()) {
        newline(0, -ts_.leading);
        PObj s = stack.back();
        if (s && s->t == Obj::T::Str) show_text(s->s);
      } else if (op == "\"" && stack.size() >= 3) {
        ts_.word_sp = num(2);
        ts_.char_sp = num(1);
        newline(0, -ts_.leading);
        PObj s = stack.back();
        if (s && s->t == Obj::T::Str) show_text(s->s);
      } else if (op == "TJ" && !stack.empty()) {
        PObj a = stack.back();
        if (a && a->t == Obj::T::Array) {
          for (auto& el : a->arr) {
            if (!el) continue;
            if (el->t == Obj::T::Str) show_text(el->s);
            else if (el->is_num()) tj_adjust(el->num());
          }
        }
      }
      // xobjects & inline images
      else if (op == "Do" && !stack.empty()) {
        PObj n = stack.back();
        if (n && n->t == Obj::T::Name) do_xobject(n->s, depth);
      } else if (op == "BI") {
        skip_inline_image(p);
      }
      // everything else (color, shading, marked content...) is a no-op
      stack.clear();
    }
  }

  void skip_inline_image(Parser& p) {
    // parse the inline dict (key/value pairs until ID), then record bbox and
    // scan past the binary data to EI.
    ImagePlacement im;
    im.obj_num = -1;
    while (p.skip_ws()) {
      if (p.at_keyword("ID")) {
        p.next_keyword();
        break;
      }
      PObj k = p.parse_object();
      if (!k) return;
      if (k->t == Obj::T::Name) {
        PObj v = p.parse_object();
        if (!v) return;
        if ((k->s == "W" || k->s == "Width") && v->is_num()) im.width = (int)v->as_int();
        if ((k->s == "H" || k->s == "Height") && v->is_num()) im.height = (int)v->as_int();
      }
    }
    if (p.pos < p.size() && is_ws(p.data()[p.pos])) p.pos++;
    // scan for whitespace + "EI" + delimiter
    const uint8_t* d = p.data();
    size_t n = p.size();
    while (p.pos + 2 < n) {
      if (is_ws(d[p.pos]) && d[p.pos + 1] == 'E' && d[p.pos + 2] == 'I' &&
          (p.pos + 3 >= n || is_ws(d[p.pos + 3]) || is_delim(d[p.pos + 3]))) {
        p.pos += 3;
        break;
      }
      p.pos++;
    }
    double xs[2], ys[2];
    gs().ctm.apply(0, 0, &xs[0], &ys[0]);
    gs().ctm.apply(1, 1, &xs[1], &ys[1]);
    im.x0 = std::min(xs[0], xs[1]);
    im.x1 = std::max(xs[0], xs[1]);
    im.y0 = std::min(ys[0], ys[1]);
    im.y1 = std::max(ys[0], ys[1]);
    out_->images.push_back(im);
  }
};

}  // namespace

PageContent extract_page_content(Document* doc, const Page& page) {
  PageContent out;
  PObj contents = doc->dget(page.node, "Contents");
  std::vector<uint8_t> data;
  if (contents && contents->t == Obj::T::Stream) {
    data = doc->decoded(contents);
  } else if (contents && contents->t == Obj::T::Array) {
    for (auto& el : contents->arr) {
      PObj s = doc->resolve(el);
      if (s && s->t == Obj::T::Stream) {
        auto part = doc->decoded(s);
        data.insert(data.end(), part.begin(), part.end());
        data.push_back('\n');
      }
    }
  }
  Mat base;  // identity: output stays in PDF user space
  Interp interp(doc, &out);
  interp.run(data, page.resources, base, 0);
  return out;
}

}  // namespace pdfio
