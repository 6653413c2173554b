// OpenCV 5.0.0's host geometry without OpenCV: contour following
// (findContours with RETR_LIST and CHAIN_APPROX_SIMPLE), convexHull,
// minAreaRect, warpAffine (INTER_LINEAR, constant border) and the f32
// INTER_LINEAR resize. The algorithms and their float and double
// arithmetic are OpenCV's, statement by statement, so that the results
// are the same bits; build without
// floating-point contraction (-ffp-contract=off): where OpenCV's kernels
// fuse a multiply-add, this file says so with std::fma. A plain C
// interface for ctypes (ops/cv_host.py), no allocation crosses it except
// through the contour handle.

#include <algorithm>
#include <limits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Pt { int x, y; };
struct Pt2f { float x, y; };

struct Contours {
  std::vector<int> counts;   // points per contour, in output order
  std::vector<int> points;   // x, y pairs, contour after contour
};

const int kCodeDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kCodeDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// Suzuki-Abe border following of one border (OpenCV's icvFetchContour for
// 8-bit images, CHAIN_APPROX_SIMPLE). ``i0`` is the start pixel in the
// padded image, ``pt`` its point in the caller's coordinates.
void fetch_contour(int8_t* ptr, long step, Pt pt, bool is_hole,
                   std::vector<int>& out) {
  const int8_t nbd = 2;
  long deltas[16];
  deltas[0] = 1; deltas[1] = -step + 1; deltas[2] = -step;
  deltas[3] = -step - 1; deltas[4] = -1; deltas[5] = step - 1;
  deltas[6] = step; deltas[7] = step + 1;
  for (int k = 0; k < 8; ++k) deltas[k + 8] = deltas[k];
  int8_t* i0 = ptr;
  int8_t *i1, *i3, *i4 = nullptr;
  int prev_s = -1, s, s_end;
  s_end = s = is_hole ? 0 : 4;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (*i1 == 0 && s != s_end);
  if (s == s_end) {  // a single-pixel component
    *i0 = static_cast<int8_t>(nbd | -128);
    out.push_back(pt.x);
    out.push_back(pt.y);
    return;
  }
  i3 = i0;
  prev_s = s ^ 4;
  for (;;) {
    s_end = s;
    s = std::min(s, 15);
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (*i4 != 0) break;
    }
    s &= 7;
    if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
      *i3 = static_cast<int8_t>(nbd | -128);
    } else if (*i3 == 1) {
      *i3 = nbd;
    }
    if (s != prev_s) {
      out.push_back(pt.x);
      out.push_back(pt.y);
      prev_s = s;
    }
    pt.x += kCodeDx[s];
    pt.y += kCodeDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

// Sklansky's scan of one quarter of the hull (OpenCV's Sklansky_ for float
// points, double dot products).
int sklansky(Pt2f** array, int start, int end, int* stack, int nsign,
             int sign2) {
  int incr = end > start ? 1 : -1;
  int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
  int stacksize = 3;
  if (start == end || (array[start]->x == array[end]->x &&
                       array[start]->y == array[end]->y)) {
    stack[0] = start;
    return 1;
  }
  stack[0] = pprev;
  stack[1] = pcur;
  stack[2] = pnext;
  end += incr;
  auto sign = [](double v) { return (v > 0) - (v < 0); };
  while (pnext != end) {
    float cury = array[pcur]->y;
    float nexty = array[pnext]->y;
    float by = nexty - cury;
    if (sign(by) != nsign) {
      float ax = array[pcur]->x - array[pprev]->x;
      float bx = array[pnext]->x - array[pcur]->x;
      float ay = cury - array[pprev]->y;
      double convexity = static_cast<double>(ay) * bx -
                         static_cast<double>(ax) * by;
      if (sign(convexity) == sign2 && (ax != 0 || ay != 0)) {
        pprev = pcur;
        pcur = pnext;
        pnext += incr;
        stack[stacksize] = pnext;
        stacksize++;
      } else if (pprev == start) {
        pcur = pnext;
        stack[1] = pcur;
        pnext += incr;
        stack[2] = pnext;
      } else {
        stack[stacksize - 2] = pnext;
        pcur = pprev;
        pprev = stack[stacksize - 4];
        stacksize--;
      }
    } else {
      pnext += incr;
      stack[stacksize - 1] = pnext;
    }
  }
  return --stacksize;
}

// OpenCV's convexHull(points, hull, clockwise=false, returnPoints=false):
// the hull's indices into ``data0``, in its output order.
std::vector<int> convex_hull(const Pt2f* data0, int total) {
  std::vector<int> hullbuf;
  if (total == 0) return hullbuf;
  std::vector<const Pt2f*> ptrs(total);
  for (int i = 0; i < total; ++i) ptrs[i] = &data0[i];
  std::sort(ptrs.begin(), ptrs.end(), [](const Pt2f* a, const Pt2f* b) {
    if (a->x != b->x) return a->x < b->x;
    if (a->y != b->y) return a->y < b->y;
    return a < b;
  });
  Pt2f** pointer = const_cast<Pt2f**>(ptrs.data());
  int miny_ind = 0, maxy_ind = 0;
  for (int i = 1; i < total; ++i) {
    float y = pointer[i]->y;
    if (pointer[miny_ind]->y > y) miny_ind = i;
    if (pointer[maxy_ind]->y < y) maxy_ind = i;
  }
  std::vector<int> stackbuf(total + 2);
  int* stack = stackbuf.data();
  hullbuf.reserve(total);
  auto idx = [&](int k) { return static_cast<int>(pointer[k] - data0); };
  if (pointer[0]->x == pointer[total - 1]->x &&
      pointer[0]->y == pointer[total - 1]->y) {
    hullbuf.push_back(0);
    return hullbuf;
  }
  int* tl_stack = stack;
  int tl_count = sklansky(pointer, 0, maxy_ind, tl_stack, -1, 1);
  int* tr_stack = stack + tl_count;
  int tr_count = sklansky(pointer, total - 1, maxy_ind, tr_stack, -1, -1);
  std::swap(tl_stack, tr_stack);
  std::swap(tl_count, tr_count);
  for (int i = 0; i < tl_count - 1; ++i) hullbuf.push_back(idx(tl_stack[i]));
  for (int i = tr_count - 1; i > 0; --i) hullbuf.push_back(idx(tr_stack[i]));
  int stop_idx = tr_count > 2 ? tr_stack[1]
                 : tl_count > 2 ? tl_stack[tl_count - 2] : -1;
  int* bl_stack = stack;
  int bl_count = sklansky(pointer, 0, miny_ind, bl_stack, 1, -1);
  int* br_stack = stack + bl_count;
  int br_count = sklansky(pointer, total - 1, miny_ind, br_stack, 1, 1);
  if (stop_idx >= 0) {
    int check_idx = bl_count > 2 ? bl_stack[1]
                    : bl_count + br_count > 2 ? br_stack[2 - bl_count] : -1;
    if (check_idx == stop_idx ||
        (check_idx >= 0 && pointer[check_idx]->x == pointer[stop_idx]->x &&
         pointer[check_idx]->y == pointer[stop_idx]->y)) {
      bl_count = std::min(bl_count, 2);
      br_count = std::min(br_count, 2);
    }
  }
  for (int i = 0; i < bl_count - 1; ++i) hullbuf.push_back(idx(bl_stack[i]));
  for (int i = br_count - 1; i > 0; --i) hullbuf.push_back(idx(br_stack[i]));
  // a cyclic shift that makes the indices ascending or descending
  int nout = static_cast<int>(hullbuf.size());
  if (nout >= 3) {
    int min_idx = 0, max_idx = 0, lt = 0;
    for (int i = 1; i < nout; ++i) {
      int id = hullbuf[i];
      lt += hullbuf[i - 1] < id;
      if (lt > 1 && lt <= i - 2) break;
      if (id < hullbuf[min_idx]) min_idx = i;
      if (id > hullbuf[max_idx]) max_idx = i;
    }
    int mmdist = std::abs(max_idx - min_idx);
    if ((mmdist == 1 || mmdist == nout - 1) && (lt <= 1 || lt >= nout - 2)) {
      int ascending = (max_idx + 1) % nout == min_idx;
      int i0 = ascending ? min_idx : max_idx, j = i0;
      if (i0 > 0) {
        int i;
        for (i = 0; i < nout; ++i) {
          int curr_idx = stack[i] = hullbuf[j];
          int next_j = j + 1 < nout ? j + 1 : 0;
          int next_idx = hullbuf[next_j];
          if (i < nout - 1 && (ascending != (curr_idx < next_idx))) break;
          j = next_j;
        }
        if (i == nout) std::memcpy(hullbuf.data(), stack, nout * sizeof(int));
      }
    }
  }
  return hullbuf;
}

// OpenCV 5.0.0's rotatingCalipers(points, n, CALIPERS_MINAREARECT, out)
// over a counter-clockwise hull, in its float arithmetic. The caliper that
// turns next is the one whose edge, turned into the first caliper's frame,
// lies furthest clockwise (a sign of a float cross product, not a
// comparison of cosines). out: the corner, then the two side vectors.
inline Pt2f rotate90_cw(Pt2f v) { return Pt2f{v.y, -v.x}; }
inline Pt2f rotate90_ccw(Pt2f v) { return Pt2f{-v.y, v.x}; }
inline Pt2f rotate180(Pt2f v) { return Pt2f{-v.x, -v.y}; }

// Whether v1 lies clockwise of v2.
inline bool first_vec_is_right(Pt2f v1, Pt2f v2) {
  Pt2f t = rotate90_cw(v1);
  return t.x * v2.x + t.y * v2.y < 0;
}

void rotating_calipers_min_area(const Pt2f* points, int n, float* out) {
  float minarea = std::numeric_limits<float>::max();
  std::vector<float> inv_vect_length(n);
  std::vector<Pt2f> vect(n);
  int left = 0, bottom = 0, right = 0, top = 0;
  int seq[4] = {-1, -1, -1, -1};
  float orientation = 0;
  float base_a;
  float base_b = 0;
  float left_x, right_x, top_y, bottom_y;
  Pt2f pt0 = points[0];
  left_x = right_x = pt0.x;
  top_y = bottom_y = pt0.y;
  for (int i = 0; i < n; ++i) {
    double dx, dy;
    if (pt0.x < left_x) left_x = pt0.x, left = i;
    if (pt0.x > right_x) right_x = pt0.x, right = i;
    if (pt0.y > top_y) top_y = pt0.y, top = i;
    if (pt0.y < bottom_y) bottom_y = pt0.y, bottom = i;
    Pt2f pt = points[(i + 1) & (i + 1 < n ? -1 : 0)];
    dx = pt.x - pt0.x;
    dy = pt.y - pt0.y;
    vect[i].x = static_cast<float>(dx);
    vect[i].y = static_cast<float>(dy);
    inv_vect_length[i] = static_cast<float>(1. / std::sqrt(dx * dx + dy * dy));
    pt0 = pt;
  }
  {
    double ax = vect[n - 1].x;
    double ay = vect[n - 1].y;
    for (int i = 0; i < n; ++i) {
      double bx = vect[i].x;
      double by = vect[i].y;
      double convexity = ax * by - ay * bx;
      if (convexity != 0) {
        orientation = (convexity > 0) ? 1.f : -1.f;
        break;
      }
      ax = bx;
      ay = by;
    }
  }
  base_a = orientation;
  seq[0] = bottom;
  seq[1] = right;
  seq[2] = top;
  seq[3] = left;
  int best_left = 0, best_bottom = 0;
  float best_a = 0, best_b = 0, best_w = 0, best_h = 0;
  for (int k = 0; k < n; ++k) {
    Pt2f rot[4] = {vect[seq[0]], rotate90_cw(vect[seq[1]]),
                   rotate180(vect[seq[2]]), rotate90_ccw(vect[seq[3]])};
    int main_element = 0;
    for (int i = 1; i < 4; ++i)
      if (first_vec_is_right(rot[i], rot[main_element])) main_element = i;
    {
      int pindex = seq[main_element];
      float lead_x = vect[pindex].x * inv_vect_length[pindex];
      float lead_y = vect[pindex].y * inv_vect_length[pindex];
      switch (main_element) {
        case 0: base_a = lead_x; base_b = lead_y; break;
        case 1: base_a = lead_y; base_b = -lead_x; break;
        case 2: base_a = -lead_x; base_b = -lead_y; break;
        default: base_a = -lead_y; base_b = lead_x; break;
      }
    }
    seq[main_element] += 1;
    seq[main_element] = (seq[main_element] == n) ? 0 : seq[main_element];
    float dx = points[seq[1]].x - points[seq[3]].x;
    float dy = points[seq[1]].y - points[seq[3]].y;
    float width = dx * base_a + dy * base_b;
    dx = points[seq[2]].x - points[seq[0]].x;
    dy = points[seq[2]].y - points[seq[0]].y;
    float height = -dx * base_b + dy * base_a;
    float area = width * height;
    if (area <= minarea) {
      minarea = area;
      best_left = seq[3];
      best_a = base_a;
      best_w = width;
      best_b = base_b;
      best_h = height;
      best_bottom = seq[0];
    }
  }
  float A1 = best_a;
  float B1 = best_b;
  float A2 = -best_b;
  float B2 = best_a;
  float C1 = A1 * points[best_left].x + points[best_left].y * B1;
  float C2 = A2 * points[best_bottom].x + points[best_bottom].y * B2;
  float idet = 1.f / (A1 * B2 - A2 * B1);
  out[0] = (C1 * B2 - C2 * B1) * idet;
  out[1] = (A1 * C2 - A2 * C1) * idet;
  out[2] = A1 * best_w;
  out[3] = B1 * best_w;
  out[4] = A2 * best_h;
  out[5] = B2 * best_h;
}

// OpenCV 5.0.0's warpAffine kernel, INTER_LINEAR, constant border, on an
// h x w image of cn channels: dst (oh, ow, cn). m is the inverse map's six
// f32 coefficients. A row takes the term m[1] * y + m[2] (two roundings);
// the columns of its whole blocks of 16 take x as one fused multiply-add
// on it, the columns after the last block fmaf(m[0], x, m[1] * y) + m[2].
// The four corners (border where outside) blend as two lerps along x and
// one along y, each fmaf(t, b - a, a); a uint8 result rounds to nearest,
// ties to even, and saturates.
inline float lerp(float t, float a, float b) { return std::fma(t, b - a, a); }

inline void store(float v, float* d) { *d = v; }
inline void store(float v, uint8_t* d) {
  float r = std::nearbyint(v);
  *d = static_cast<uint8_t>(r < 0 ? 0 : r > 255 ? 255 : r);
}

template <typename S, typename D>
void warp_affine(const S* src, int h, int w, int cn, const float* m,
                 float border, D* dst, int oh, int ow) {
  const int blocks = ow / 16 * 16;
  const float lim = 2147483520.f;  // the largest float below 2^31
  for (int y = 0; y < oh; ++y) {
    const float fy = static_cast<float>(y);
    const float row_x = m[1] * fy + m[2];
    const float row_y = m[4] * fy + m[5];
    const float prod_x = m[1] * fy, prod_y = m[4] * fy;
    D* out = dst + static_cast<size_t>(y) * ow * cn;
    for (int x = 0; x < ow; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < blocks) {
        sx = std::fma(m[0], fx, row_x);
        sy = std::fma(m[3], fx, row_y);
      } else {
        sx = std::fma(m[0], fx, prod_x) + m[2];
        sy = std::fma(m[3], fx, prod_y) + m[5];
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const bool far = !(std::fabs(flx) < lim && std::fabs(fly) < lim);
      const int ix = far ? 0 : static_cast<int>(flx);
      const int iy = far ? 0 : static_cast<int>(fly);
      const float ax = sx - flx, ay = sy - fly;
      const S* p[4] = {nullptr, nullptr, nullptr, nullptr};
      if (!far) {
        for (int k = 0; k < 4; ++k) {
          const int yy = iy + (k >> 1), xx = ix + (k & 1);
          if (yy >= 0 && yy < h && xx >= 0 && xx < w)
            p[k] = src + (static_cast<size_t>(yy) * w + xx) * cn;
        }
      }
      for (int c = 0; c < cn; ++c) {
        float v[4];
        for (int k = 0; k < 4; ++k)
          v[k] = p[k] ? static_cast<float>(p[k][c]) : border;
        const float top = lerp(ax, v[0], v[1]);
        const float bottom = lerp(ax, v[2], v[3]);
        store(lerp(ay, top, bottom), out + static_cast<size_t>(x) * cn + c);
      }
    }
  }
}

// The two passes of OpenCV 5.0.0's f32 INTER_LINEAR resize (IPP's on an
// AVX-512 host) over an h x w x cn image, from taps computed by the caller:
// each output column x reads source columns x0[x], x1[x] at weight a[x],
// each output row y source rows y0[y], y1[y] at weight b[y]. A row is
// fmaf(a, s1 - s0, s0) a float; the rows blend as fmaf(b, r1 - r0, r0),
// but for the first two channels of the columns where unfused[x] is set,
// which take r0 + (r1 - r0) * b.
void resize_linear_f32(const float* src, int w, int cn, const int* x0,
                       const int* x1, const float* a, const uint8_t* unfused,
                       int ow, const int* y0, const int* y1, const float* b,
                       int oh, float* dst) {
  const size_t row = static_cast<size_t>(ow) * cn;
  std::vector<float> rows(2 * row);
  int have[2] = {-1, -1};
  auto horizontal = [&](int sy, float* out) {
    const float* s = src + static_cast<size_t>(sy) * w * cn;
    for (int x = 0; x < ow; ++x)
      for (int c = 0; c < cn; ++c) {
        const float p = s[static_cast<size_t>(x0[x]) * cn + c];
        const float q = s[static_cast<size_t>(x1[x]) * cn + c];
        out[static_cast<size_t>(x) * cn + c] = std::fma(a[x], q - p, p);
      }
  };
  for (int y = 0; y < oh; ++y) {
    const float* r[2];
    for (int k = 0; k < 2; ++k) {
      const int sy = k ? y1[y] : y0[y];
      int slot = have[0] == sy ? 0 : have[1] == sy ? 1 : -1;
      if (slot < 0) {
        // keep the other row if the other tap still needs it
        slot = (have[0] == y0[y] || have[0] == y1[y]) ? 1 : 0;
        horizontal(sy, rows.data() + slot * row);
        have[slot] = sy;
      }
      r[k] = rows.data() + slot * row;
    }
    float* out = dst + static_cast<size_t>(y) * row;
    for (int x = 0; x < ow; ++x)
      for (int c = 0; c < cn; ++c) {
        const size_t i = static_cast<size_t>(x) * cn + c;
        const float r0 = r[0][i], r1 = r[1][i];
        out[i] = (unfused[x] && c < 2) ? r0 + (r1 - r0) * b[y]
                                       : std::fma(b[y], r1 - r0, r0);
      }
  }
}

}  // namespace

extern "C" {

void cvh_resize_linear_f32(const float* src, int w, int cn, const int* x0,
                           const int* x1, const float* a,
                           const uint8_t* unfused, int ow, const int* y0,
                           const int* y1, const float* b, int oh,
                           float* dst) {
  resize_linear_f32(src, w, cn, x0, x1, a, unfused, ow, y0, y1, b, oh, dst);
}

// warpAffine of an h x w x cn image (uint8 where src_u8, else f32) into
// an oh x ow x cn one (uint8 where dst_u8, else f32); m the inverse map.
void cvh_warp_affine(const void* src, int src_u8, int h, int w, int cn,
                     const float* m, float border, void* dst, int dst_u8,
                     int oh, int ow) {
  if (src_u8 && dst_u8)
    warp_affine(static_cast<const uint8_t*>(src), h, w, cn, m, border,
                static_cast<uint8_t*>(dst), oh, ow);
  else if (src_u8)
    warp_affine(static_cast<const uint8_t*>(src), h, w, cn, m, border,
                static_cast<float*>(dst), oh, ow);
  else if (dst_u8)
    warp_affine(static_cast<const float*>(src), h, w, cn, m, border,
                static_cast<uint8_t*>(dst), oh, ow);
  else
    warp_affine(static_cast<const float*>(src), h, w, cn, m, border,
                static_cast<float*>(dst), oh, ow);
}

// findContours(img != 0, RETR_LIST, CHAIN_APPROX_SIMPLE) of an h x w uint8
// image: a handle to the contours, in OpenCV's output order (the reverse of
// the raster order of their start points). Free it with cvh_free_contours.
void* cvh_find_contours(const uint8_t* img, int h, int w, int* n_contours,
                        long* n_points) {
  const int H = h + 2, W = w + 2;
  std::vector<int8_t> buf(static_cast<size_t>(H) * W, 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      buf[static_cast<size_t>(y + 1) * W + x + 1] = img[static_cast<size_t>(y) * w + x] != 0;
  std::vector<std::vector<int>> found;
  const long step = W;
  int8_t* img0 = buf.data();
  int x = 1, y = 1;
  int prev = img0[step * y + x - 1];
  for (; y < H - 1; ++y) {
    int8_t* row = img0 + step * y;
    int p = 0;
    for (; x < W - 1; ++x) {
      for (; x < W - 1 && (p = row[x]) == prev; ++x) {
      }
      if (x >= W - 1) break;
      int is_hole = 0;
      if (!(prev == 0 && p == 1)) {
        if (p != 0 || prev < 1) {
          prev = p;
          continue;
        }
        is_hole = 1;
      }
      std::vector<int> pts;
      fetch_contour(row + x - is_hole, step, Pt{x - is_hole - 1, y - 1},
                    is_hole != 0, pts);
      found.push_back(std::move(pts));
      // the scan resumes after the start pixel, from its value after the
      // trace
      prev = row[x];
    }
    x = 1;
    prev = 0;
  }
  Contours* c = new Contours();
  long total = 0;
  for (auto it = found.rbegin(); it != found.rend(); ++it) {
    c->counts.push_back(static_cast<int>(it->size() / 2));
    c->points.insert(c->points.end(), it->begin(), it->end());
    total += static_cast<long>(it->size() / 2);
  }
  *n_contours = static_cast<int>(c->counts.size());
  *n_points = total;
  return c;
}

void cvh_fetch_contours(void* handle, int* counts, int* points) {
  Contours* c = static_cast<Contours*>(handle);
  std::copy(c->counts.begin(), c->counts.end(), counts);
  std::copy(c->points.begin(), c->points.end(), points);
}

void cvh_free_contours(void* handle) { delete static_cast<Contours*>(handle); }

// minAreaRect of n float points: out = cx, cy, width, height, angle (deg).
void cvh_min_area_rect(const float* pts, int n, float* out) {
  const Pt2f* p = reinterpret_cast<const Pt2f*>(pts);
  std::vector<int> hidx = convex_hull(p, n);
  std::vector<Pt2f> hull(hidx.size());
  for (size_t i = 0; i < hidx.size(); ++i) hull[i] = p[hidx[i]];
  int hn = static_cast<int>(hull.size());
  float cx = 0, cy = 0, bw = 0, bh = 0;
  double angle = 0;
  if (hn > 2) {
    Pt2f o[3];
    rotating_calipers_min_area(hull.data(), hn, reinterpret_cast<float*>(o));
    cx = o[0].x + (o[1].x + o[2].x) * 0.5f;
    cy = o[0].y + (o[1].y + o[2].y) * 0.5f;
    bw = static_cast<float>(std::sqrt(static_cast<double>(o[1].x) * o[1].x +
                                      static_cast<double>(o[1].y) * o[1].y));
    bh = static_cast<float>(std::sqrt(static_cast<double>(o[2].x) * o[2].x +
                                      static_cast<double>(o[2].y) * o[2].y));
    angle = std::atan2(static_cast<double>(o[1].y),
                       static_cast<double>(o[1].x)) * 180 / M_PI;
  } else if (hn == 2) {
    cx = (hull[0].x + hull[1].x) * 0.5f;
    cy = (hull[0].y + hull[1].y) * 0.5f;
    double dx = hull[1].x - hull[0].x;
    double dy = hull[1].y - hull[0].y;
    bw = static_cast<float>(std::sqrt(dx * dx + dy * dy));
    angle = std::atan2(dy, dx) * 180 / M_PI;
  } else if (hn == 1) {
    cx = hull[0].x;
    cy = hull[0].y;
  }
  // OpenCV 5.0 reports the angle in [-90, 0): a half turn keeps the sides,
  // a quarter turn swaps them (in f64, rounded once)
  while (angle < -90) angle += 180;
  while (angle >= 90) angle -= 180;
  if (angle >= 0) {
    angle -= 90;
    std::swap(bw, bh);
  }
  out[0] = cx;
  out[1] = cy;
  out[2] = bw;
  out[3] = bh;
  out[4] = static_cast<float>(angle);
}

// The convex hull of n float points (OpenCV's convexHull with
// returnPoints=false): its indices into pts; returns their count.
int cvh_convex_hull(const float* pts, int n, int* out_idx) {
  std::vector<int> h = convex_hull(reinterpret_cast<const Pt2f*>(pts), n);
  std::copy(h.begin(), h.end(), out_idx);
  return static_cast<int>(h.size());
}

}  // extern "C"
