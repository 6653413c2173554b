"""Table crops cut from resident pages and resized to uint8 exactly as
``cv2.resize(crop, (nw, nh))`` (INTER_LINEAR) returns them: the device
counterpart of the JAX task's host crop
``pages[pi][int(y1):int(y2), int(x1):int(x2)]`` and the ``cv2.resize`` in
SLANet's and TableMaster's pre-processors. The port never imports cv2.

OpenCV resizes uint8 with 11-bit fixed-point coefficients: a source
coordinate ``f = (d + 0.5) * (src / dst) - 0.5`` in f32 per output pixel,
``w1 = round(frac(f) * 2048)``, ``w0 = round((1 - frac(f)) * 2048)``
(each rounded on its own). The horizontal pass is exact in integers; the
vertical one combines two rows as its vector code does:
``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``. Columns
left of or beyond the source take one source column at full weight;
rows outside are clamped with their weights kept. An exact 2x downscale,
where OpenCV switches to its area path, gives the same bytes. Held to
``cv2.resize`` bit for bit by tests/test_torch_crop_resize.py.

:func:`resize_u8_plain` is the numpy reference of one image;
:func:`crop_resize_u8` cuts and resizes a batch of windows of a page stack
with torch integer ops, on whatever device the stack is (the same bytes on
the CPU and the card). Output pixels beyond each crop's ``(nh, nw)`` are 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

COEF_SCALE = 2048          # 1 << INTER_RESIZE_COEF_BITS (11)

Window = Tuple[int, int, int, int, int]   # page, x1, y1, x2, y2


def linear_taps(src: int, dst: int, axis: str
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Source indices and fixed-point weights (i0, i1, w0, w1), int64 of
    length ``dst``, along ``axis`` "x" or "y" (they differ at the edges,
    as OpenCV's do)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if axis == "x":
        edge = (s < 0) | (s >= src - 1)
        f = np.where(edge, np.float32(0), f)
        s = np.clip(s, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE))
    w1 = np.rint(f * np.float32(COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def _combine(p00, p01, p10, p11, a0, a1, b0, b1):
    """The fixed-point blend of the four corner samples (any integer
    arrays or tensors that broadcast)."""
    s0 = p00 * a0 + p01 * a1
    s1 = p10 * a0 + p11 * a1
    return (((s0 >> 4) * b0 >> 16) + ((s1 >> 4) * b1 >> 16) + 2) >> 2


def resize_u8_plain(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh))`` of an (H, W, C) or (H, W) uint8
    image, in numpy: the two source rows of each output row, then their
    horizontal sums, in int32 (each term of the blend stays below 2^27)."""
    if img.ndim == 2:
        return resize_u8_plain(img[..., None], nh, nw)[..., 0]
    h, w = img.shape[:2]
    x0, x1, a0, a1 = linear_taps(w, nw, "x")
    y0, y1, b0, b1 = linear_taps(h, nh, "y")
    a0, a1 = (a.astype(np.int32)[None, :, None] for a in (a0, a1))

    def row_sums(rows):
        return rows[:, x0].astype(np.int32) * a0 \
            + rows[:, x1].astype(np.int32) * a1

    s0, s1 = row_sums(img[y0]), row_sums(img[y1])
    b0, b1 = (b.astype(np.int32)[:, None, None] for b in (b0, b1))
    out = (((s0 >> 4) * b0 >> 16) + ((s1 >> 4) * b1 >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def crop_taps(windows: Sequence[Window], sizes: Sequence[Tuple[int, int]],
              out_hw: Tuple[int, int]) -> np.ndarray:
    """Per crop the page index and the row and column taps in page
    coordinates, padded to ``out_hw`` with zero weights: (N, 1 + 4 * th +
    4 * tw) int32, one upload."""
    th, tw = out_hw
    out = np.zeros((len(windows), 1 + 4 * th + 4 * tw), np.int32)
    for n, ((pi, x1, y1, x2, y2), (nh, nw)) in enumerate(zip(windows,
                                                             sizes)):
        rows = np.zeros((4, th), np.int64)
        cols = np.zeros((4, tw), np.int64)
        rows[:, :nh] = linear_taps(y2 - y1, nh, "y")
        cols[:, :nw] = linear_taps(x2 - x1, nw, "x")
        rows[:2] += y1
        cols[:2] += x1
        out[n, 0] = pi
        out[n, 1:] = np.concatenate([rows.ravel(), cols.ravel()])
    return out


def crop_windows(pages_hw: Tuple[int, int], regions) -> list:
    """``regions`` [(page, (x1, y1, x2, y2))] -> integer windows, cut as
    ``page[int(y1):int(y2), int(x1):int(x2)]`` cuts them (ends clipped to
    the page)."""
    H, W = pages_hw
    out = []
    for pi, (x1, y1, x2, y2) in regions:
        x1, y1 = int(x1), int(y1)
        x2, y2 = min(int(x2), W), min(int(y2), H)
        if x1 < 0 or y1 < 0 or x2 <= x1 or y2 <= y1:
            raise ValueError(f"empty or negative crop window {(x1, y1, x2, y2)}")
        out.append((int(pi), x1, y1, x2, y2))
    return out


def crop_resize_u8(pages: torch.Tensor, taps: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crops of ``pages`` (P, H, W, C) uint8 resized as ``cv2.resize``:
    (N, th, tw, C) uint8, zero beyond each crop's size. ``taps`` is
    :func:`crop_taps`'s table on the pages' device."""
    th, tw = out_hw
    n = taps.shape[0]
    pidx = taps[:, 0].long().view(n, 1, 1)
    rows = taps[:, 1:1 + 4 * th].view(n, 4, th)
    cols = taps[:, 1 + 4 * th:].view(n, 4, tw)
    y0, y1 = rows[:, 0].long()[..., None], rows[:, 1].long()[..., None]
    x0, x1 = cols[:, 0].long()[:, None], cols[:, 1].long()[:, None]

    def at(y, x):
        return pages[pidx, y, x].int()            # (N, th, tw, C)

    out = _combine(at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1),
                   cols[:, 2, None, :, None], cols[:, 3, None, :, None],
                   rows[:, 2, :, None, None], rows[:, 3, :, None, None])
    return out.clamp_(0, 255).to(torch.uint8)


def _area_linear_taps(src: int, dst: int, axis: str
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """:func:`linear_taps` with OpenCV's INTER_AREA coefficients, which it
    takes when one axis enlarges: ``s = floor(d * src / dst)``, ``f = (d +
    1) - (s + 1) * dst / src`` (f64, then f32), its fraction, 0 where not
    positive."""
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    if axis == "x":
        edge = s >= src - 1
        f = np.where(edge, np.float32(0), f)
        s = np.minimum(s, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE))
    w1 = np.rint(f * np.float32(COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def _area_tab(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """OpenCV's ``computeResizeAreaTab``: (destination, source, weight f32)
    entries, in its order."""
    scale = src / dst
    di, si, al = [], [], []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            di.append(d), si.append(s1 - 1), al.append((s1 - f1) / cell)
        for s in range(s1, s2):
            di.append(d), si.append(s), al.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            di.append(d), si.append(s2)
            al.append(min(min(f2 - s2, 1.0), cell) / cell)
    return (np.asarray(di, np.int64), np.asarray(si, np.int64),
            np.asarray(al, np.float64).astype(np.float32))


def _area_sum_rows(img: np.ndarray, tab, dst: int) -> np.ndarray:
    """Weighted sums over axis 1 of ``img`` (f32 accumulation in the
    table's order): (rows, dst, C) f32."""
    di, si, al = tab
    out = np.zeros((img.shape[0], dst) + img.shape[2:], np.float32)
    # entries of one destination are consecutive: take them slot by slot
    start = np.searchsorted(di, np.arange(dst))
    slot = np.arange(len(di)) - start[di]
    for k in range(int(slot.max()) + 1 if len(slot) else 0):
        m = slot == k
        out[:, di[m]] += img[:, si[m]].astype(np.float32) * al[m][None, :,
                                                                  None]
    return out


def resize_area_u8_plain(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)`` of an
    (H, W, C) uint8 image, in numpy. OpenCV shrinks by an integer factor in
    both axes with plain box means (``sum * (1 / area)`` in f32, rounded to
    even; an exact 2x as ``(sum + 2) >> 2``), by any other factor in both
    axes with its f32 area tables, and emulates the rest with its
    fixed-point bilinear path on area coefficients."""
    h, w = img.shape[:2]
    if (h, w) == (nh, nw):              # OpenCV copies
        return img.copy()
    sx, sy = w / nw, h / nh
    if sx >= 1 and sy >= 1:
        ix, iy = int(round(sx)), int(round(sy))
        if abs(sx - ix) < np.finfo(np.float64).eps \
                and abs(sy - iy) < np.finfo(np.float64).eps:
            blocks = img[:nh * iy, :nw * ix].astype(np.int64).reshape(
                nh, iy, nw, ix, -1).sum((1, 3))
            if ix == 2 and iy == 2:
                out = (blocks + 2) >> 2
            else:
                out = np.rint(blocks.astype(np.float32)
                              * np.float32(1.0 / (ix * iy)))
            return out.reshape(nh, nw, *img.shape[2:]).astype(np.uint8)
        rows = _area_sum_rows(img, _area_tab(w, nw), nw)
        di, si, al = _area_tab(h, nh)
        acc = np.zeros((nh,) + rows.shape[1:], np.float32)
        for d, s, a in zip(di, si, al):
            acc[d] += a * rows[s]
        return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    x0, x1, a0, a1 = _area_linear_taps(w, nw, "x")
    y0, y1, b0, b1 = _area_linear_taps(h, nh, "y")
    im = img.astype(np.int64)
    out = _combine(im[y0][:, x0], im[y0][:, x1], im[y1][:, x0],
                   im[y1][:, x1], a0[None, :, None], a1[None, :, None],
                   b0[:, None, None], b1[:, None, None])
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear_f32(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of an f32 (H, W, C) or
    (H, W) image, as OpenCV 5.0.0 computes it on an AVX-512 host (its IPP
    resize): source coordinates ``(d + 0.5) * (src / dst) - 0.5`` in f64,
    their fractions as f32 weights; columns left of or beyond the source on
    the edge column at weight 0, rows clamped; the horizontal pass, then
    the vertical one, each ``fmaf(t, b - a, a)``. Where a 3-channel image's
    edge run (the columns left of the source, or those beyond it) is not a
    whole number of blocks of 16 pixels and its last block holds 5 or
    more, that block's first two channels blend vertically unfused, ``a +
    (b - a) * t``. The taps here, the two passes in C++
    (``native/cv_host.cc``). Bit-equal to ``cv2.resize``
    (tests/test_torch_cv_host.py)."""
    from .cv_host import _load

    src = np.ascontiguousarray(img, np.float32)
    H, W = src.shape[:2]
    cn = src.shape[2] if src.ndim == 3 else 1

    def taps(n_src, n_dst):
        f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
        s = np.floor(f)
        return s.astype(np.int64), (f - s).astype(np.float32)

    sx, a = taps(W, w)
    edge = (sx < 0) | (sx >= W - 1)
    a = np.where(edge, np.float32(0), a)
    x0 = np.clip(sx, 0, W - 1)
    x1 = np.where(edge, x0, np.clip(sx + 1, 0, W - 1))
    sy, b = taps(H, h)
    unfused = np.zeros(w, np.uint8)
    if cn == 3:
        left, right = int((sx < 0).sum()), int((sx >= W - 1).sum())
        for start, run in ((0, left), (w - right, right)):
            tail = run % 16
            if tail >= 5:
                unfused[start + run - tail:start + run] = 1
    out = np.empty((h, w) + src.shape[2:], np.float32)
    i32 = np.int32
    if out.size:
        _load().cvh_resize_linear_f32(
            src, W, cn, x0.astype(i32), x1.astype(i32), a, unfused, w,
            np.clip(sy, 0, H - 1).astype(i32),
            np.clip(sy + 1, 0, H - 1).astype(i32), b, h, out)
    return out
