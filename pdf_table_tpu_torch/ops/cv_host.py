"""OpenCV 5.0.0's host geometry without cv2: the calls that the per-image
detection, recognition, deskew and crop paths of the JAX package make
(``models/dbnet/processor.py``, ``tasks/preprocess.py``,
``ops/warp.py::crop_rotated_boxes`` there). The card's host has no cv2, so
the port reproduces each one's arithmetic, and
tests/test_torch_cv_host.py holds it to ``cv2`` 5.0.0.

Contour following, the convex hull, ``minAreaRect``, ``warpAffine`` and
the two passes of the f32 resize (``crop_resize.py::resize_linear_f32``)
are OpenCV's algorithms in C++ (``native/cv_host.cc``), built at first use
with ``g++`` into ``native/build/`` (listed in ``.gitignore``; the
library's name carries a hash of the source, so an edit rebuilds) and
called through ctypes: border following and a page's warp are loops over
every pixel, which Python runs many times slower. The rest is numpy.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage

from ..models.line_cell.algo import rgb_to_grey
from ..pdfio.draw import clip_line, line_int
from ..utils import native_build
from ..utils.native_build import NATIVE_DIR

SOURCE = NATIVE_DIR / "cv_host.cc"
_lib = None
_lib_lock = threading.Lock()

RotatedRect = Tuple[Tuple[float, float], Tuple[float, float], float]

__all__ = ["rgb_to_grey", "find_contours", "arc_length", "approx_poly_dp",
           "min_area_rect", "box_points",
           "convex_hull", "fill_poly", "mean_masked",
           "connected_components_with_stats",
           "threshold_otsu_inv", "find_nonzero", "rotation_matrix_2d",
           "perspective_transform", "warp_perspective_u8",
           "invert_affine", "warp_affine_linear", "warp_affine_u8"]


def library_path() -> Path:
    """``native/build/libcvhost-<hash>.so``."""
    return native_build.library_path(SOURCE)


def build_native() -> Path:
    """Build the library if it is missing."""
    return native_build.build_native(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        P = np.ctypeslib.ndpointer
        lib.cvh_find_contours.restype = ctypes.c_void_p
        lib.cvh_find_contours.argtypes = [
            P(np.uint8, flags="C"), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
        lib.cvh_fetch_contours.argtypes = [
            ctypes.c_void_p, P(np.int32, flags="C"), P(np.int32, flags="C")]
        lib.cvh_free_contours.argtypes = [ctypes.c_void_p]
        lib.cvh_min_area_rect.argtypes = [P(np.float32, flags="C"),
                                          ctypes.c_int,
                                          P(np.float32, flags="C")]
        lib.cvh_warp_affine.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, P(np.float32, flags="C"), ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cvh_resize_linear_f32.argtypes = [
            P(np.float32, flags="C"), ctypes.c_int, ctypes.c_int,
            P(np.int32, flags="C"), P(np.int32, flags="C"),
            P(np.float32, flags="C"), P(np.uint8, flags="C"), ctypes.c_int,
            P(np.int32, flags="C"), P(np.int32, flags="C"),
            P(np.float32, flags="C"), ctypes.c_int,
            P(np.float32, flags="C")]
        lib.cvh_convex_hull.restype = ctypes.c_int
        lib.cvh_convex_hull.argtypes = [P(np.float32, flags="C"),
                                        ctypes.c_int, P(np.int32, flags="C")]
        _lib = lib
        return lib


def _f32_points(points) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(points).reshape(-1, 2),
                                np.float32)


# -- contours and rectangles (C++) ---------------------------------------------

def find_contours(bitmap: np.ndarray, limit: Optional[int] = None
                  ) -> List[np.ndarray]:
    """``cv2.findContours(bitmap, cv2.RETR_LIST,
    cv2.CHAIN_APPROX_SIMPLE)[0][:limit]``: Suzuki-Abe border following of
    the nonzero pixels, outer and hole borders alike, each an (n, 1, 2)
    int32 array of the points where the chain turns, in OpenCV's order
    (the reverse of the raster order of the borders' start pixels). Every
    border is traced; ``limit`` bounds only the arrays built."""
    img = np.ascontiguousarray(bitmap, np.uint8)
    h, w = img.shape
    lib = _load()
    nc, npts = ctypes.c_int(0), ctypes.c_long(0)
    handle = lib.cvh_find_contours(img, h, w, ctypes.byref(nc),
                                   ctypes.byref(npts))
    try:
        counts = np.zeros(max(nc.value, 1), np.int32)
        pts = np.zeros((max(npts.value, 1), 2), np.int32)
        lib.cvh_fetch_contours(handle, counts, pts)
    finally:
        lib.cvh_free_contours(handle)
    k = nc.value if limit is None else min(nc.value, max(limit, 0))
    ends = np.cumsum(counts[:k])
    return [pts[e - n:e].reshape(-1, 1, 2)
            for n, e in zip(counts[:k], ends)]


def arc_length(curve, closed: bool) -> float:
    """``cv2.arcLength(curve, closed)``: each step's length in f32 (its
    differences, squares and root), the steps summed in f64, from the last
    point to the first as well for a closed curve."""
    p = np.asarray(curve).reshape(-1, 2).astype(np.float32)
    n = len(p)
    if n <= 1:
        return 0.0
    prev = np.concatenate([p[-1:] if closed else p[:1], p[:-1]])
    d = p - prev
    steps = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    total = 0.0
    for v in steps.astype(np.float64):
        total += v
    return total


def _segment_dist2(pts: np.ndarray, a: np.ndarray, b: np.ndarray
                   ) -> np.ndarray:
    """Squared f64 distances of integer points from the segment [a, b]:
    from the nearer end where the point projects outside it."""
    d = (b - a).astype(np.float64)
    r = (pts - a).astype(np.float64)
    chord = d[0] * d[0] + d[1] * d[1]
    t = r[:, 0] * d[0] + r[:, 1] * d[1]
    cross = r[:, 1] * d[0] - r[:, 0] * d[1]
    to_a = r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]
    rb = (pts - b).astype(np.float64)
    to_b = rb[:, 0] * rb[:, 0] + rb[:, 1] * rb[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        line = cross * cross / chord
    return np.where(t <= 0, to_a, np.where(t >= chord, to_b, line))


def approx_poly_dp(curve, epsilon: float, closed: bool) -> np.ndarray:
    """``cv2.approxPolyDP(curve, epsilon, closed)`` of integer points, as
    OpenCV 5.0.0 runs it: for a closed curve, three passes for two points
    far apart, each pass from the last one's farthest point (the first
    farthest in ring order); Douglas-Peucker over a stack of slices, the
    left half popped first, a slice kept whole while its farthest point
    lies within ``epsilon`` of the slice's end-to-end segment (not its
    line: a point that projects outside the segment is measured from the
    nearer end; squared distances in f64); then one pass that drops a
    point within ``epsilon / sqrt(2)`` of the line through its neighbours.
    Returns an (n, 1, 2) int32 array. Held to ``cv2`` point for point by
    tests/test_torch_dbnet_polygon.py."""
    src = np.asarray(curve).reshape(-1, 2).astype(np.int64)
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps = float(epsilon) ** 2
    dst: List[np.ndarray] = []
    stack: List[Tuple[int, int]] = []
    is_closed = closed
    init_iters = 3
    if not closed:
        if (src[0] != src[-1]).any():
            stack.append((0, count - 1))
        else:
            is_closed, init_iters = True, 1
    if is_closed:
        pos = right = 0
        le_eps = False
        for _ in range(init_iters):
            pos = (pos + right) % count
            start = src[pos]
            d = src[(pos + np.arange(1, count)) % count] - start
            dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float64)
            max_dist = 0.0
            if count > 1 and dist.max() > 0:
                j = int(np.argmax(dist))
                max_dist, right = float(dist[j]), j + 1
            le_eps = max_dist <= eps
        if le_eps:
            dst.append(start)
        else:
            far = (right + pos) % count
            stack += [(far, pos), (pos, far)]
    while stack:
        s_start, s_end = stack.pop()
        start, end = src[s_start], src[s_end]
        inner = (s_start + 1 + np.arange((s_end - s_start - 1) % count)) \
            % count
        le_eps, split = True, None
        if len(inner):
            dist = _segment_dist2(src[inner], start, end)
            j = int(np.argmax(dist))
            split = int(inner[j])
            le_eps = float(dist[j]) <= eps
        if le_eps:
            dst.append(start)
        else:
            stack += [(split, s_end), (s_start, split)]
    if not is_closed:
        dst.append(src[-1])
    return _approx_cleanup([(int(p[0]), int(p[1])) for p in dst], closed,
                           eps)


def _approx_cleanup(dst: List[Tuple[int, int]], closed: bool,
                    eps: float) -> np.ndarray:
    """The last pass of ``approxPolyDP_``, in place on the ring ``dst``: a
    point within ``sqrt(eps / 2)`` of the line through its neighbours, that
    line neither horizontal nor vertical and the point between them, is
    dropped, and the next point is not tested."""
    count = new_count = len(dst)
    dst = list(dst)
    pos = count - 1 if closed else 0
    start = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0 if closed else 1
    while i < count - (0 if closed else 1) and new_count > 2:
        end = dst[pos]
        pos = (pos + 1) % count
        dx, dy = float(end[0] - start[0]), float(end[1] - start[1])
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = (pt[0] - start[0]) * (end[0] - pt[0]) \
            + (pt[1] - start[1]) * (end[1] - pt[1])
        if dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0 \
                and dy != 0 and inner >= 0:
            new_count -= 1
            dst[wpos] = start = end
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end
        i += 1
    if not closed:
        dst[wpos] = pt
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 1, 2)

def convex_hull(points) -> np.ndarray:
    """Indices of ``cv2.convexHull(points)``'s points (counter-clockwise),
    in its order: the hull ``min_area_rect`` measures."""
    p = _f32_points(points)
    out = np.zeros(max(len(p), 1), np.int32)
    n = _load().cvh_convex_hull(p, len(p), out)
    return out[:n]


def min_area_rect(points) -> RotatedRect:
    """``cv2.minAreaRect(points)``: ((cx, cy), (w, h), angle in degrees),
    the convex hull's rotating calipers in OpenCV 5.0.0's float arithmetic
    (the next caliper by the sign of a float cross product), the angle
    folded into [-90, 0) in f64. Bit-equal to ``cv2.minAreaRect``
    (tests/test_torch_cv_host.py)."""
    p = _f32_points(points)
    out = np.zeros(5, np.float32)
    _load().cvh_min_area_rect(p, len(p), out)
    return ((float(out[0]), float(out[1])), (float(out[2]), float(out[3])),
            float(out[4]))


def box_points(rect: RotatedRect) -> np.ndarray:
    """``cv2.boxPoints(rect)``: the (4, 2) f32 corners, in OpenCV 5.0's
    float arithmetic (each corner from the centre, none mirrored)."""
    (cx, cy), (bw, bh), angle = rect
    f = np.float32
    cx, cy, bw, bh = f(cx), f(cy), f(bw), f(bh)
    rad = angle * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    return np.array([(cx - a * bh - b * bw, cy + b * bh - a * bw),
                     (cx + a * bh - b * bw, cy - b * bh - a * bw),
                     (cx + a * bh + b * bw, cy - b * bh + a * bw),
                     (cx - a * bh + b * bw, cy + b * bh + a * bw)],
                    np.float32)


# -- masks ---------------------------------------------------------------------

XY_SHIFT = 16               # fillPoly's fixed point: x in 16.16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(mask: np.ndarray, pts: np.ndarray, value: int = 1) -> None:
    """``cv2.fillPoly(mask, [pts], value)`` in place, integer points,
    ``shift=0``, 8-connected, as OpenCV 5.0.0's ``CollectPolyEdges`` and
    ``FillEdgeCollection`` fill: each edge drawn by the line iterator;
    its x in 16.16 fixed point stepping by a truncated ``dx`` a row; an
    edge that leaves the image takes the end points that ``cv::clipLine``
    gives it, whose x (and, where the clipped part is not flat, whose y) it
    then runs through over the edge's own rows; the active edges walked in
    OpenCV's order and bubble-sorted by x after each row; each pair filled
    from the ceiling of the left x to the floor of the right, clamped to
    the image. Bit-equal to ``cv2.fillPoly`` for polygons inside and
    outside the image (tests/test_torch_cv_host.py)."""
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    h, w = mask.shape[:2]
    edges = []   # [y0, y1, x, dx]: rows [y0, y1), x at y0
    for i in range(len(v)):
        x0, y0 = int(v[i - 1, 0]), int(v[i - 1, 1])
        x1, y1 = int(v[i, 0]), int(v[i, 1])
        line_int(mask, (x0, y0), (x1, y1), value)
        ax, ay, bx, by = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                and 0 <= y1 < h):
            _, cx0, cy0, cx1, cy1 = clip_line(w, h, x0, y0, x1, y1)
            ax, bx = cx0 << XY_SHIFT, cx1 << XY_SHIFT
            if cy0 != cy1:
                ay, by = cy0, cy1
        if y0 == y1:
            continue
        dx = _trunc_div(bx - ax, by - ay)
        if y0 < y1:
            edges.append([y0, y1, ax + (y0 - ay) * dx, dx])
        else:
            edges.append([y1, y0, bx + (y1 - by) * dx, dx])
    if len(edges) < 2:
        return
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_max = max(e[1] for e in edges)
    if y_max < 0 or min(e[0] for e in edges) >= h \
            or max(max(e[2] for e in edges), max(ends)) < 0 \
            or min(min(e[2] for e in edges), min(ends)) >= w << XY_SHIFT:
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    total, i = len(edges), 0
    active: List[list] = []
    for y in range(edges[0][0], min(y_max, h)):
        # the walk: drop the edges that end here, merge in those that
        # start here (before an active edge of no smaller x), fill pairs
        walked: List[list] = []
        k = 0
        while k < len(active) or (i < total and edges[i][0] == y):
            last = active[k] if k < len(active) else None
            if last is not None and last[1] == y:
                k += 1
                continue
            if last is not None and (i >= total or edges[i][0] > y
                                     or last[2] < edges[i][2]):
                walked.append(last)
                k += 1
            elif i < total:
                walked.append(edges[i])
                i += 1
            else:
                break
            if len(walked) % 2 == 0:
                a, b = walked[-2], walked[-1]
                if y >= 0:
                    lo, hi = (b, a) if a[2] > b[2] else (a, b)
                    xa = (lo[2] + XY_ONE - 1) >> XY_SHIFT
                    xb = hi[2] >> XY_SHIFT
                    if xa < w and xb >= 0:
                        mask[y, max(xa, 0):min(xb, w - 1) + 1] = value
                a[2] += a[3]
                b[2] += b[3]
        active = walked + active[k:]
        # OpenCV's bubble sort by x, its last exchange bounding each pass
        stop = None
        while True:
            m, exchanged = 0, None
            while m < len(active) - 1 and active[m] is not stop:
                if active[m][2] > active[m + 1][2]:
                    active[m], active[m + 1] = active[m + 1], active[m]
                    exchanged = active[m]
                m += 1
            if exchanged is None or exchanged is active[0]:
                break
            stop = exchanged


def mean_masked(img: np.ndarray, mask: np.ndarray) -> float:
    """``cv2.mean(img, mask)[0]`` of a single-channel image: the mean of the
    pixels where ``mask`` is nonzero, summed in f64; 0 for an empty
    mask."""
    sel = np.asarray(img)[np.asarray(mask) != 0]
    if not sel.size:
        return 0.0
    return float(sel.astype(np.float64).sum() / sel.size)


def connected_components_with_stats(bitmap: np.ndarray
                                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """``cv2.connectedComponentsWithStats(bitmap, 8)``'s (count, labels,
    stats): 8-connected components of the nonzero pixels (0 the
    background), stats (count, 5) int32 rows [x, y, width, height, area],
    row 0 the background's. OpenCV 5's 8-connected labeller scans 2x2
    blocks, so the labels run in the raster order of the blocks that hold
    each component's first pixel (a 2x2 block never holds two)."""
    fg = np.asarray(bitmap) != 0
    labels, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    if n:
        h, w = fg.shape
        ys, xs = np.nonzero(labels)
        key = (ys // 2) * ((w + 1) // 2) + xs // 2
        first = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first, labels[ys, xs], key)
        rank = np.zeros(n + 1, np.int64)
        rank[1 + np.argsort(first[1:], kind="stable")] = np.arange(1, n + 1)
        labels = rank[labels]
    labels = labels.astype(np.int32)
    stats = np.zeros((n + 1, 5), np.int32)
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    stats[:, 4] = areas
    objs = ndimage.find_objects(labels)
    for li, sl in enumerate(objs, start=1):
        if sl is None:
            continue
        stats[li, :4] = (sl[1].start, sl[0].start, sl[1].stop - sl[1].start,
                         sl[0].stop - sl[0].start)
    bg = ~fg
    if bg.any():
        ys, xs = np.nonzero(bg)
        stats[0, :4] = (xs.min(), ys.min(), xs.max() - xs.min() + 1,
                        ys.max() - ys.min() + 1)
    return n + 1, labels, stats


def threshold_otsu_inv(grey: np.ndarray) -> Tuple[float, np.ndarray]:
    """``cv2.threshold(grey, 0, 255, THRESH_BINARY_INV + THRESH_OTSU)``:
    Otsu's threshold from the 256-bin histogram (OpenCV's f64 recurrence),
    then 255 where a pixel is at or under it, else 0."""
    g = np.asarray(grey, np.uint8)
    hist = np.bincount(g.ravel(), minlength=256)
    scale = 1.0 / g.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = 0.0
    max_sigma = max_val = 0.0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = float(i)
    return max_val, np.where(g > max_val, 0, 255).astype(np.uint8)


def find_nonzero(img: np.ndarray) -> np.ndarray:
    """``cv2.findNonZero(img)``: (n, 2) int32 (x, y) points in raster
    order (an empty (0, 2) array where cv2 returns None)."""
    ys, xs = np.nonzero(np.asarray(img))
    return np.stack([xs, ys], 1).astype(np.int32).reshape(-1, 2)


# -- transforms ------------------------------------------------------------------

def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)`` (2, 3) f64; the
    centre is a float point, as OpenCV's ``Point2f``."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)`` of four f32 points: the
    8x8 system of OpenCV (its products of f32 coordinates rounded to f32)
    solved by OpenCV's LU with partial pivoting in f64; (3, 3) f64.

    Where the LU finds no pivot (a quad with two corners on one point, or
    all four on a line), OpenCV 5.0.0 takes the homogeneous system
    ``[A | -b]`` (8x9), forms its ``mulTransposed`` (AᵀA, each sum in row
    order), and returns the last left singular vector of OpenCV's Jacobi
    SVD of that 9x9 matrix, unit norm, with ``M[2, 2]`` not 1."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy, dx, dy = s[i, 0], s[i, 1], d[i, 0], d[i, 1]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6] = float(-sx * dx)
        a[i][7] = float(-sy * dx)
        a[i + 4][6] = float(-sx * dy)
        a[i + 4][7] = float(-sy * dy)
        b[i] = float(dx)
        b[i + 4] = float(dy)
    rows = [a[i] + [-b[i]] for i in range(8)]
    x = _lu_solve(a, b)
    if x is not None:
        return np.array(x + [1.0]).reshape(3, 3)
    ata = [[0.0] * 9 for _ in range(9)]
    for i in range(9):
        for j in range(i, 9):
            acc = 0.0
            for r in rows:
                acc += r[i] * r[j]
            ata[i][j] = ata[j][i] = acc
    return np.array(_jacobi_svd_u(ata)[8]).reshape(3, 3)


def _lu_solve(a: List[List[float]], b: List[float]
              ) -> Optional[List[float]]:
    """OpenCV's ``LUImpl`` on one right-hand side (Python floats: f64,
    no fused multiply-adds); None where a pivot is under OpenCV's
    ``100 * DBL_EPSILON``."""
    m = len(a)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 100:
            return None
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return b


def _cv_hypot(a: float, b: float) -> float:
    """OpenCV's own ``hypot`` in ``lapack.cpp`` (not libm's)."""
    a, b = abs(a), abs(b)
    if a > b:
        b /= a
        return a * math.sqrt(1 + b * b)
    if b > 0:
        a /= b
        return b * math.sqrt(1 + a * a)
    return 0.0


def _jacobi_svd_u(s: List[List[float]]) -> List[List[float]]:
    """The left singular vectors (as rows, by falling singular value) that
    ``cv::SVDecomp`` of a square f64 matrix gives: OpenCV 5.0.0's
    ``JacobiSVDImpl_`` line by line (one-sided Jacobi on the rows of the
    transposed matrix, its ``hypot``, sums in index order, no fused
    multiply-adds), including its fill of a zero singular value's vector
    from ``RNG(0x12345678)`` orthogonalised against the ones before it.
    Below 25 rows OpenCV never hands an SVD to LAPACK."""
    n = len(s)
    at = [[float(s[k][i]) for k in range(n)] for i in range(n)]
    w = [0.0] * n
    for i in range(n):
        sd = 0.0
        for t in at[i]:
            sd += t * t
        w[i] = sd
    eps = np.finfo(np.float64).eps * 10
    for _ in range(max(n, 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                ai, aj = at[i], at[j]
                a, b, p = w[i], w[j], 0.0
                for k in range(n):
                    p += ai[k] * aj[k]
                if abs(p) <= eps * math.sqrt(a * b):
                    continue
                p *= 2
                beta = a - b
                gamma = _cv_hypot(p, beta)
                if beta < 0:
                    sn = math.sqrt((gamma - beta) * 0.5 / gamma)
                    cs = p / (gamma * sn * 2)
                else:
                    cs = math.sqrt((gamma + beta) / (gamma * 2))
                    sn = p / (gamma * cs * 2)
                a = b = 0.0
                for k in range(n):
                    t0 = cs * ai[k] + sn * aj[k]
                    t1 = -sn * ai[k] + cs * aj[k]
                    ai[k], aj[k] = t0, t1
                    a += t0 * t0
                    b += t1 * t1
                w[i], w[j] = a, b
                changed = True
        if not changed:
            break
    for i in range(n):
        sd = 0.0
        for t in at[i]:
            sd += t * t
        w[i] = math.sqrt(sd)
    for i in range(n - 1):
        j = i
        for k in range(i + 1, n):
            if w[j] < w[k]:
                j = k
        if i != j:
            w[i], w[j] = w[j], w[i]
            at[i], at[j] = at[j], at[i]
    state = 0x12345678
    tiny = np.finfo(np.float64).tiny
    for i in range(n):
        sd = w[i]
        tries = 0
        while tries < 100 and sd <= tiny:
            # a zero singular value: a random +-1/n vector, projected off
            # the vectors before it (twice), then normalised
            row = at[i]
            for k in range(n):
                state = ((state & 0xFFFFFFFF) * 4164903690
                         + (state >> 32)) & 0xFFFFFFFFFFFFFFFF
                row[k] = 1.0 / n if state & 256 else -1.0 / n
            for _ in range(2):
                for j in range(i):
                    sd = 0.0
                    for k in range(n):
                        sd += row[k] * at[j][k]
                    asum = 0.0
                    for k in range(n):
                        t = row[k] - sd * at[j][k]
                        row[k] = t
                        asum += abs(t)
                    asum = 1 / asum if asum > eps * 100 else 0.0
                    for k in range(n):
                        row[k] *= asum
            sd = 0.0
            for t in row:
                sd += t * t
            sd = math.sqrt(sd)
            tries += 1
        scale = 1 / sd if sd > tiny else 0.0
        for k in range(n):
            at[i][k] *= scale
    return at


def _invert3(m: np.ndarray) -> np.ndarray:
    """OpenCV's closed-form f64 inverse of a 3x3 (``invert``, DECOMP_LU)."""
    S = [[float(v) for v in row] for row in np.asarray(m).reshape(3, 3)]
    d = (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
         - S[0][1] * (S[1][0] * S[2][2] - S[1][2] * S[2][0])
         + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    t = [(S[1][1] * S[2][2] - S[1][2] * S[2][1]) * d,
         (S[0][2] * S[2][1] - S[0][1] * S[2][2]) * d,
         (S[0][1] * S[1][2] - S[0][2] * S[1][1]) * d,
         (S[1][2] * S[2][0] - S[1][0] * S[2][2]) * d,
         (S[0][0] * S[2][2] - S[0][2] * S[2][0]) * d,
         (S[0][2] * S[1][0] - S[0][0] * S[1][2]) * d,
         (S[1][0] * S[2][1] - S[1][1] * S[2][0]) * d,
         (S[0][1] * S[2][0] - S[0][0] * S[2][1]) * d,
         (S[0][0] * S[1][1] - S[0][1] * S[1][0]) * d]
    return np.array(t).reshape(3, 3)


def _fma_f32(a, b, c) -> np.ndarray:
    """``fmaf(a, b, c)`` of f32 arrays, rounded once: the product is exact
    in f64, the sum's error comes from TwoSum, and the f64 sum is rounded
    to odd before it is rounded to f32."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & np.isfinite(s) & ((s.view(np.int64) & 1) == 0)
    s = np.where(inexact, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                 s)
    return s.astype(np.float32)


def warp_perspective_u8(image: np.ndarray, mat: np.ndarray,
                        size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(image, mat, size)`` of a uint8 (H, W, C)
    image, INTER_LINEAR, border constant 0, bit-equal to OpenCV 5.0.0 on
    an AVX2 host. The inverse is OpenCV's f64 closed form (all zeros where
    its determinant is 0), rounded to f32. OpenCV's kernel takes a row in
    blocks of 16 columns: there ``X = fmaf(m00, x, m01 * y + m02)`` (the
    row term in two roundings); the columns after the last whole block
    take ``fmaf(m00, x, m01 * y) + m02``. Then the division by w, and the
    blend at float source coordinates as two lerps along x and one along y,
    each ``fmaf(t, b - a, a)``, rounded to the nearest integer, ties to
    even. The column split matters where the matrix is near singular
    (``perspective_transform`` of a degenerate quad), whose coordinates
    cancel from some 1e16."""
    h, w = image.shape[:2]
    out_w, out_h = size
    inv = _invert3(mat).astype(np.float32)
    xs = np.broadcast_to(np.arange(out_w, dtype=np.float32)[None, :],
                         (out_h, out_w))
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    tail = xs >= out_w // 16 * 16

    def coord(r):
        block = _fma_f32(inv[r, 0], xs, inv[r, 1] * ys + inv[r, 2])
        rest = _fma_f32(inv[r, 0], xs, inv[r, 1] * ys) + inv[r, 2]
        return np.where(tail, rest, block)

    X, Y, W = coord(0), coord(1), coord(2)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = np.nan_to_num(X / W, nan=-10.0, posinf=-10.0, neginf=-10.0)
        sy = np.nan_to_num(Y / W, nan=-10.0, posinf=-10.0, neginf=-10.0)
    sx = np.clip(sx, -10.0, w + 10.0).astype(np.float32)
    sy = np.clip(sy, -10.0, h + 10.0).astype(np.float32)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    ax = (sx - x0)[..., None]
    ay = (sy - y0)[..., None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    src = np.asarray(image, np.float32)
    if src.ndim == 2:
        src = src[..., None]

    def corner(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)] \
            * ok[..., None]

    p00, p01 = corner(0, 0), corner(0, 1)
    top = _fma_f32(ax, p01 - p00, p00)
    p10, p11 = corner(1, 0), corner(1, 1)
    bottom = _fma_f32(ax, p11 - p10, p10)
    out = _fma_f32(ay, bottom - top, top)
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out if image.ndim == 3 else out[..., 0]


def invert_affine(mat: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine in f64, as ``cv2.invertAffineTransform``
    computes it."""
    m = np.asarray(mat, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine_linear(image: np.ndarray, mat: np.ndarray,
                       size: Tuple[int, int], border: float = 0.0,
                       out_dtype=np.float32) -> np.ndarray:
    """``cv2.warpAffine(image, mat, size, flags=cv2.INTER_LINEAR,
    borderValue=(border,) * 4)`` of a uint8 or f32 (H, W) or (H, W, C)
    image, as OpenCV 5.0.0's kernel computes it (``native/cv_host.cc``):
    destination pixel (x, y) samples the source at ``inv(mat) @ (x, y,
    1)``, the inverse in f64 rounded to f32; per row ``a01 * y + a02`` in
    two roundings, along the row one fused multiply-add ``a00 * x`` on it
    for the columns of whole blocks of 16 and ``fmaf(a00, x, a01 * y) +
    a02`` after them (the same for y); the corners, ``border`` outside the
    image, blended as two lerps along x and one along y, each ``fmaf(t, b
    - a, a)``. The result is f32, or uint8 (rounded to nearest, ties to
    even) where ``out_dtype`` says so. Bit-equal to ``cv2.warpAffine`` on
    both dtypes (tests/test_torch_cv_host.py, tests/test_torch_tsr_crops.py,
    tests/test_torch_lore_train.py)."""
    src = np.asarray(image)
    src = np.ascontiguousarray(src, np.uint8 if src.dtype == np.uint8
                               else np.float32)
    h, w = src.shape[:2]
    cn = src.shape[2] if src.ndim == 3 else 1
    out_w, out_h = size
    out = np.empty((out_h, out_w) + src.shape[2:], out_dtype)
    inv = np.ascontiguousarray(invert_affine(mat).astype(np.float32)
                               .ravel())
    if out.size:
        _load().cvh_warp_affine(
            src.ctypes.data, int(src.dtype == np.uint8), h, w, cn, inv,
            float(border), out.ctypes.data,
            int(out.dtype == np.uint8), out_h, out_w)
    return out


def warp_affine_u8(image: np.ndarray, mat: np.ndarray, size: Tuple[int, int],
                   border: float = 0.0) -> np.ndarray:
    """``cv2.warpAffine(image, mat, size, flags=INTER_LINEAR,
    borderValue=(border,) * 3)`` of a uint8 image:
    :func:`warp_affine_linear` with a uint8 result."""
    return warp_affine_linear(np.asarray(image, np.uint8), mat, size,
                              border=border, out_dtype=np.uint8)
