"""OpenCV 5.0.0's drawing arithmetic on uint8 RGB images, in numpy: the
pixels that ``cv2.line``, ``cv2.rectangle`` and ``cv2.polylines`` paint
(8-connected lines, integer points, ``shift=0``), so that the port's
renderer draws the JAX renderer's pages without cv2.

OpenCV draws a line of thickness 1 with its Bresenham iterator. A thicker
line is a convex polygon (the segment widened by ``thickness / 2`` in
16-bit fixed point) filled by its scan-line filler, whose edges are drawn
by its fixed-point line, plus a filled circle of radius
``(thickness + 1) // 2`` on each end that the caller asks for; OpenCV 5
first clips such a line to the image grown by ``thickness`` on every side.
A rectangle or polyline is a chain of such lines, each end capped once.
Held to ``cv2`` bit for bit by tests/test_torch_pdfio.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

Color = Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round_even(v: float) -> int:
    """``cvRound`` of a double: to the nearest, ties to even."""
    return int(round(v))


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on a ``w`` x ``h`` box: (inside, x1, y1, x2, y2)."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _put(img: np.ndarray, xs, ys, color: Color) -> None:
    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color: Color) -> None:
    """Pixels x1..x2 of row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def line_int(img: np.ndarray, p1, p2, color: Color) -> None:
    """OpenCV's 8-connected ``Line`` between integer points (its
    ``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # the iterator's error term, closed form: after k steps along the
    # major axis the minor one has moved m_k times
    k = np.arange(dx + 1, dtype=np.int64)
    m = (2 * dy * k + dx - 1) // (2 * dx) if dx else np.zeros_like(k)
    if vert:
        _put(img, x1 + m, y1 + sy * k, color)
    else:
        _put(img, x1 + k, y1 + sy * m, color)


def line_fixed(img: np.ndarray, p1, p2, color: Color) -> None:
    """OpenCV's ``Line2`` (the edges of ``FillConvexPoly``): an
    8-connected line between points in 16-bit fixed point."""
    h, w = img.shape[:2]
    ok, x1, y1, x2, y2 = clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                   int(p1[0]), int(p1[1]), int(p2[0]),
                                   int(p2[1]))
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, [(x2 + (XY_ONE >> 1)) >> XY_SHIFT],
         [(y2 + (XY_ONE >> 1)) >> XY_SHIFT], color)
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        _put(img, (x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT,
             color)
    else:
        _put(img, (x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k,
             color)


def fill_convex_poly(img: np.ndarray, pts: Sequence[Tuple[int, int]],
                     color: Color, shift: int) -> None:
    """OpenCV's ``FillConvexPoly`` (8-connected, not antialiased) of
    points in ``shift``-bit fixed point: the edges, then the scan lines."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in pts]
    n = len(v)
    delta = 1 << shift >> 1
    half = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    for x, y in v:
        p = (x << up, y << up)
        if shift == 0:
            line_int(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                     (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            line_fixed(img, p0, p, color)
        p0 = p
    xs = [x for x, _ in v]
    ys = [y for _, y in v]
    imin = int(np.argmin(ys))
    xmin = (min(xs) + delta) >> shift
    xmax = (max(xs) + delta) >> shift
    ymin = (min(ys) + delta) >> shift
    ymax = (max(ys) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= n:
                    idx -= n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs0 = v[idx0][0] << up
                        xe = v[idx][0] << up
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs0) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs0
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= n:
                        idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + half) >> XY_SHIFT
            xx2 = (edge[right]["x"] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, xx1, xx2, color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def circle_filled(img: np.ndarray, center: Tuple[int, int], radius: int,
                  color: Color) -> None:
    """OpenCV's filled ``Circle`` (midpoint rows) at an integer centre."""
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img: np.ndarray, p0, p1, color: Color, thickness: int,
               flags: int) -> None:
    """OpenCV's ``ThickLine`` between integer points (``shift=0``, line
    type 8); ``flags`` bit 0 caps ``p0``, bit 1 caps ``p1``."""
    if thickness <= 1:
        line_int(img, p0, p1, color)
        return
    # OpenCV 5 first clips a thick line to the image grown by
    # ``thickness`` on every side; the caps sit on the clipped ends
    h, w = img.shape[:2]
    t = thickness
    ok, x1, y1, x2, y2 = clip_line(w + 2 * t, h + 2 * t, int(p0[0]) + t,
                                   int(p0[1]) + t, int(p1[0]) + t,
                                   int(p1[1]) + t)
    if not ok:
        return
    p0, p1 = (x1 - t, y1 - t), (x2 - t, y2 - t)
    q0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    q1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = _round_even(dy * r), _round_even(dx * r)
        fill_convex_poly(img, [(q0[0] + ox, q0[1] + oy),
                               (q0[0] - ox, q0[1] - oy),
                               (q1[0] - ox, q1[1] - oy),
                               (q1[0] + ox, q1[1] + oy)], color, XY_SHIFT)
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    for i, q in enumerate((q0, q1)):
        if flags & (i + 1):
            circle_filled(img, ((q[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                                (q[1] + (XY_ONE >> 1)) >> XY_SHIFT),
                          radius, color)


def poly_line(img: np.ndarray, pts, closed: bool, color: Color,
              thickness: int) -> None:
    """OpenCV's ``PolyLine``: each end capped once."""
    pts = [(int(x), int(y)) for x, y in pts]
    if not pts:
        return
    i = len(pts) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = pts[i]
    for i in range(0 if closed else 1, len(pts)):
        thick_line(img, p0, pts[i], color, thickness, flags)
        p0 = pts[i]
        flags = 2


def line(img: np.ndarray, p0, p1, color: Color, thickness: int = 1) -> None:
    """``cv2.line(img, p0, p1, color, thickness)``."""
    thick_line(img, p0, p1, color, thickness, 3)


def rectangle(img: np.ndarray, p1, p2, color: Color,
              thickness: int = 1) -> None:
    """``cv2.rectangle(img, p1, p2, color, thickness)``; a negative
    thickness fills."""
    (x1, y1), (x2, y2) = p1, p2
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness >= 0:
        poly_line(img, pts, True, color, thickness)
    else:
        fill_convex_poly(img, pts, color, 0)


def polylines(img: np.ndarray, pts: np.ndarray, closed: bool, color: Color,
              thickness: int = 1) -> None:
    """``cv2.polylines(img, [pts], closed, color, thickness)``."""
    poly_line(img, np.asarray(pts).reshape(-1, 2), closed, color, thickness)
