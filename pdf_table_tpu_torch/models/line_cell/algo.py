"""LineCell: wired-table cells from a raster crop, without cv2
(counterpart of pdf_table_tpu/models/line_cell/algo.py, whose OpenCV 5.0
calls are reproduced here in numpy and scipy):

- ``cvtColor(RGB2GRAY)`` of uint8 is fixed-point with 15 fractional
  bits: ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``;
- ``adaptiveThreshold(255 - grey, 255, GAUSSIAN_C, BINARY, 15, -2)`` is
  255 where the pixel exceeds its rounded local mean by more than 2.
  OpenCV computes that mean in float, not with its fixed-point 8-bit
  blur: ``GaussianBlur`` of the f32 image (15 x 15, sigma 2.6, replicated
  border), then ``convertTo`` uint8 (round half to even). Here the f32
  kernel is summed in f64; a mean within an f32 rounding of k + 0.5 could
  round the other way, which no test image shows;
- ``morphologyEx(MORPH_OPEN)`` with a (k, 1) or (1, k) rectangle: erode
  then dilate over the window ``[x - k // 2, x - k // 2 + k - 1]`` (the
  anchor ``k // 2`` for both, OpenCV does not reflect the element); the
  border values are neutral (+inf for the erode, -inf for the dilate);
- ``findContours(RETR_EXTERNAL)`` + ``boundingRect``: the bounding boxes
  of the 8-connected components that no other component encloses (a
  component inside a hole of another one has no external contour).

Held against cv2 bit for bit by tests/test_torch_line_cell.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
from scipy import ndimage

from .grid import build_grid_cells

BLOCK = 15          # adaptiveThreshold block size
DELTA = 2           # pixel - mean > DELTA (the reference's C = -2)


def rgb_to_grey(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)`` of a uint8 image."""
    if image.ndim == 2:
        return image
    c = image.astype(np.int32)
    return ((c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


def gaussian_kernel(n: int = BLOCK) -> np.ndarray:
    """``cv2.getGaussianKernel(n, 0, CV_32F)``: sigma from ``n``,
    normalized in f64, rounded to f32."""
    sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    x = np.arange(n) - (n - 1) / 2.0
    g = np.exp(-x * x / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def adaptive_threshold(grey: np.ndarray) -> np.ndarray:
    """The reference's ``adaptiveThreshold`` of the inverted grey image:
    uint8 0/255."""
    inv = 255 - grey
    k = gaussian_kernel().astype(np.float64)
    r = BLOCK // 2
    h, w = inv.shape
    p = np.pad(inv.astype(np.float64), ((0, 0), (r, r)), mode="edge")
    rows = sum(k[i] * p[:, i:i + w] for i in range(BLOCK))
    p = np.pad(rows, ((r, r), (0, 0)), mode="edge")
    mean = np.clip(np.rint(sum(k[i] * p[i:i + h] for i in range(BLOCK))),
                   0, 255)
    return np.where(inv - mean > DELTA, 255, 0).astype(np.uint8)


def open_rect(mask: np.ndarray, kw: int, kh: int) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_OPEN, rect (kw, kh))`` of a uint8
    image. scipy's centred window of size k is OpenCV's anchor k // 2."""
    eroded = ndimage.minimum_filter(mask, size=(kh, kw), mode="constant",
                                    cval=255)
    return ndimage.maximum_filter(eroded, size=(kh, kw), mode="constant",
                                  cval=0)


_EIGHT = np.ones((3, 3), bool)


def external_boxes(mask: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """(x, y, w, h) of the 8-connected components of ``mask`` that lie in
    the outer background (4-connected, the frame around the image
    included), in raster order of their first pixel."""
    labels, n = ndimage.label(mask > 0, structure=_EIGHT)
    if not n:
        return []
    bg, _ = ndimage.label(np.pad(labels == 0, 1, constant_values=True))
    outer = bg[0, 0]
    boxes = []
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        ys, xs = sl
        top = np.flatnonzero(labels[ys.start, xs] == i)[0] + xs.start
        # the pixel above a component's first pixel is background; the
        # component is external iff that background is the outer one
        if bg[ys.start, top + 1] != outer:
            continue
        boxes.append((xs.start, ys.start, xs.stop - xs.start,
                      ys.stop - ys.start))
    return boxes


def find_table_lines(image: np.ndarray, scale: int = 15,
                     min_line_len: int = 20):
    """-> (h_lines [(y, x0, x1)], v_lines [(x, y0, y1)]) in image coords,
    sorted: the JAX function's lines, whose order is cv2's contour
    order."""
    thr = adaptive_threshold(rgb_to_grey(image))
    h, w = thr.shape
    h_mask = open_rect(thr, max(w // scale, 5), 1)
    v_mask = open_rect(thr, 1, max(h // scale, 5))
    h_lines = [(y + ch / 2.0, float(x), float(x + cw))
               for x, y, cw, ch in external_boxes(h_mask)
               if cw >= min_line_len]
    v_lines = [(x + cw / 2.0, float(y), float(y + ch))
               for x, y, cw, ch in external_boxes(v_mask)
               if ch >= min_line_len]
    return sorted(h_lines), sorted(v_lines)


def extract_cells_from_image(image: np.ndarray, scale: int = 15,
                             tol: float = 5.0) -> Dict[str, Any]:
    """Image crop of a wired table -> TSR result schema."""
    h_lines, v_lines = find_table_lines(image, scale=scale)
    cells = build_grid_cells(h_lines, v_lines, tol=tol)
    return {"cells": [c.to_dict() for c in cells], "type": "line_cell",
            "n_h_lines": len(h_lines), "n_v_lines": len(v_lines)}
