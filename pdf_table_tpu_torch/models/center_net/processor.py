"""Cycle-CenterNet pre- and post-processing (counterpart of
pdf_table_tpu/models/center_net/processor.py).

Pre, on the device from the resident pages: the JAX pre-processor takes
the crop ``page[y1:y2, x1:x2]`` and runs ``cv2.warpAffine`` of its BGR f32
copy with the centred scale matrix (INTER_LINEAR, border 0), then the
CenterNet normalization. OpenCV 5.0.0 samples f32 images at float source
coordinates: ``inv(M) @ (u, v, 1)`` with the inverse in f64, its f32
coefficients applied per row (``ay * v + by``, two roundings) and along
the row (``ax * u + bx``, one fused multiply-add in the columns of whole
blocks of 16, two roundings after them), no 1/32-px quantization, and
blends the corners as three fused lerps (ops/cv_host.py::
warp_affine_linear). :func:`warp_crops` samples the same points from the
page, corners outside the crop reading 0, and blends them the same way.

Post, on the host: :func:`group_bbox_by_gbox` (the vertex snap, in
vectorized numpy with the JAX loop's first-match rule),
:func:`assign_logical_coords` (vectorized, equal) and
:class:`CenterNetPostProcessor` (copied).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..line_cell.grid import merge_positions
from ...ops.cv_host import invert_affine, warp_affine_linear
from .config import CenterNetConfig

Window = Tuple[int, int, int, int, int]   # page, x1, y1, x2, y2


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """``fmaf(a, b, c)`` of f32 tensors, rounded once: the product is exact
    in f64, the sum's error comes from TwoSum, and the f64 sum is rounded
    to odd before it is rounded to f32 (on any device)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & torch.isfinite(s) & ((s.view(torch.int64) & 1)
                                                == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(inexact, torch.nextafter(s, toward), s).float()


class CenterNetPreProcessor:
    MEAN = np.array([0.408, 0.447, 0.470], np.float32)
    STD = np.array([0.289, 0.274, 0.278], np.float32)

    def __init__(self, config: CenterNetConfig):
        self.config = config

    def plan(self, h: int, w: int) -> Tuple[np.ndarray, Dict[str, Any]]:
        """The sampling coefficients ``(ax, bx, ay, by)`` (f32: source x =
        ax * u + bx) of an h x w crop, and its meta. The matrix is the JAX
        pre-processor's f32 one; its inverse is OpenCV's, in f64."""
        inp_h, inp_w = self.config.resolution
        s = max(h, w)
        scale = inp_w / s
        c = (w / 2.0, h / 2.0)
        inv = invert_affine(np.array(
            [[scale, 0, inp_w / 2 - scale * c[0]],
             [0, scale, inp_h / 2 - scale * c[1]]], np.float32))
        coef = inv[[0, 0, 1, 1], [0, 2, 1, 2]].astype(np.float32)
        return coef, {"c": c, "s": float(s), "org_shape": (h, w),
                      "out_w": inp_w // self.config.down_ratio}

    def warp_crops(self, pages: torch.Tensor, windows: Sequence[Window],
                   coefs: np.ndarray) -> torch.Tensor:
        """BGR f32 (N, inp_h, inp_w, 3) crops, 0..255: destination pixel
        (u, v) samples the crop at ``(ax * u + bx, ay * v + by)``
        bilinearly, each corner outside the crop 0, with the roundings and
        the blend of ``cv2.warpAffine`` (ops/cv_host.py::
        warp_affine_linear): bit-equal to it."""
        inp_h, inp_w = self.config.resolution
        dev = pages.device
        f32 = torch.float32
        n = len(windows)
        win = torch.as_tensor(np.asarray(windows, np.int64), device=dev)
        # OpenCV's rounding of the f32 coefficients: per row y it takes
        # ay * v + by (two roundings), then along the row one fused
        # multiply-add ax * u + bx (the exact f64 value, rounded once) in
        # its blocks of 16 columns, ax * u + bx in two roundings after them
        c = torch.as_tensor(coefs, device=dev)
        pi, x1, y1, x2, y2 = win.unbind(1)
        u = torch.arange(inp_w, dtype=f32, device=dev)[None]
        v = torch.arange(inp_h, dtype=f32, device=dev)
        sx = torch.where(u < inp_w // 16 * 16,
                         _fma_f32(c[:, 0:1], u, c[:, 1:2]),
                         c[:, 0:1] * u + c[:, 1:2])       # (N, inp_w)
        sy = c[:, 2:3] * v[None] + c[:, 3:4]               # (N, inp_h)
        x0f, y0f = torch.floor(sx), torch.floor(sy)
        ax = (sx - x0f)[:, None, :, None]
        ay = (sy - y0f)[:, :, None, None]
        x0, y0 = x0f.long(), y0f.long()
        w = (x2 - x1)[:, None]
        h = (y2 - y1)[:, None]
        pidx = pi.view(n, 1, 1)

        def corner(dy, dx):
            yy, xx = y0 + dy, x0 + dx
            ok = (((yy >= 0) & (yy < h))[:, :, None]
                  & ((xx >= 0) & (xx < w))[:, None, :])
            rows = y1[:, None] + torch.minimum(yy.clamp(min=0), h - 1)
            cols = x1[:, None] + torch.minimum(xx.clamp(min=0), w - 1)
            g = pages[pidx, rows[:, :, None], cols[:, None, :]].to(f32)
            return g.flip(-1) * ok[..., None]

        p00, p01 = corner(0, 0), corner(0, 1)
        top = _fma_f32(ax, p01 - p00, p00)
        p10, p11 = corner(1, 0), corner(1, 1)
        bottom = _fma_f32(ax, p11 - p10, p10)
        return _fma_f32(ay, bottom - top, top)

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """One uint8 RGB crop on the host, as the JAX pre-processor's
        ``cv2.warpAffine`` of its BGR f32 copy: {"image": (1, inp_h, inp_w,
        3) f32 normalized, "meta"} (the samples :meth:`warp_crops` takes on
        the device)."""
        h, w = image.shape[:2]
        inp_h, inp_w = self.config.resolution
        s = max(h, w)
        scale = inp_w / s
        c = (w / 2.0, h / 2.0)
        mat = np.array([[scale, 0, inp_w / 2 - scale * c[0]],
                        [0, scale, inp_h / 2 - scale * c[1]]], np.float32)
        warped = warp_affine_linear(image[:, :, ::-1], mat, (inp_w, inp_h))
        norm = (warped / 255.0 - self.MEAN) / self.STD
        return {"image": norm[None].astype(np.float32),
                "meta": self.plan(h, w)[1]}

    def normalize(self, bgr: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.MEAN, device=bgr.device)
        std = torch.as_tensor(self.STD, device=bgr.device)
        return (bgr / 255.0 - mean) / std


def _points_in_quads(quads: np.ndarray, pts: np.ndarray):
    """(K, 8) quads, (P, 2) points -> the (point, quad) index pairs, in
    row-major order, where the point is strictly inside the quad (all four
    edge cross products of one sign and non-zero, in f32 as the JAX loop
    computes them). Only pairs inside the quad's bounding box are tested:
    a point strictly inside lies within it."""
    xs, ys = quads[:, 0::2], quads[:, 1::2]
    px, py = pts[:, 0, None], pts[:, 1, None]
    pi, ki = np.nonzero((px >= xs.min(1)) & (px <= xs.max(1))
                        & (py >= ys.min(1)) & (py <= ys.max(1)))
    x1, y1 = xs[ki], ys[ki]
    x2, y2 = np.roll(x1, -1, axis=1), np.roll(y1, -1, axis=1)
    x, y = pts[pi, 0, None], pts[pi, 1, None]
    cr = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1)
    inside = np.abs(np.sign(cr).astype(np.int64).sum(-1)) == 4
    return pi[inside], ki[inside]


def group_bbox_by_gbox(bboxes: np.ndarray, gboxes: np.ndarray,
                       score_thresh: float = 0.3,
                       v2c_dist: float = 2.0,
                       c2v_dist: float = 0.5) -> np.ndarray:
    """Vertex snap (the JAX function's result, vectorized). bboxes (K, 9)
    quad + score, score-sorted; gboxes (MK, 11) vertex + 4 centres +
    score, score-sorted. For each cell above the threshold (in the leading
    run) and each corner, the first (vertex, centre) pair in the JAX
    loop's order that qualifies moves the corner onto the vertex: the
    vertex is above the threshold (leading run), the centre is at least
    ``v2c_dist`` from it and inside the cell's original quad, the corner
    is the quad's nearest to the vertex and nearer than ``c2v_dist``
    times the quad's larger extent. Snapping never changes which pairs
    qualify, so the loop's order is all that the result depends on."""
    sc = bboxes[:, 8] < score_thresh
    nk = int(np.argmax(sc)) if sc.any() else len(bboxes)
    sg = gboxes[:, 10] < score_thresh
    ng = int(np.argmax(sg)) if sg.any() else len(gboxes)
    if not nk or not ng:
        return bboxes
    q = bboxes[:nk, :8].copy()
    v = gboxes[:ng, :2]
    cen = gboxes[:ng, 2:10].reshape(ng * 4, 2)
    far = np.hypot(np.repeat(v[:, 0], 4) - cen[:, 0],
                   np.repeat(v[:, 1], 4) - cen[:, 1]) >= v2c_dist
    # candidate (vertex * 4 + centre, cell) pairs in the loop's order
    pc, k = _points_in_quads(q, cen)
    keep = far[pc]
    pc, k = pc[keep], k[keep]
    g = pc // 4
    d = np.hypot(v[g, 0, None] - q[k, 0::2], v[g, 1, None] - q[k, 1::2])
    j = np.argmin(d, axis=1)
    m = np.maximum(q[:, 0::2].max(1) - q[:, 0::2].min(1),
                   q[:, 1::2].max(1) - q[:, 1::2].min(1))
    ok = d[np.arange(len(j)), j] < c2v_dist * m[k]
    g, k, j = g[ok], k[ok], j[ok]
    # the first qualifying pair of each (cell, corner) snaps it
    _, first = np.unique(k * 4 + j, return_index=True)
    g, k, j = g[first], k[first], j[first]
    bboxes[k, 2 * j] = v[g, 0]
    bboxes[k, 2 * j + 1] = v[g, 1]
    return bboxes


def assign_logical_coords(cells: List[Dict[str, Any]],
                          tol: float = 8.0) -> None:
    """Cluster x/y boundaries -> row/col indices with spans (geometric
    logical assignment; reference modify_cell_info, table_common.py:1684).
    Each edge takes its nearest boundary (the first of equals), in f64 as
    the JAX function's per-cell loop, for all cells at once."""
    if not cells:
        return
    b = np.array([c["bbox"] for c in cells], np.float64)
    xs = np.array(merge_positions(list(b[:, 0]) + list(b[:, 2]), tol))
    ys = np.array(merge_positions(list(b[:, 1]) + list(b[:, 3]), tol))

    def idx_of(v, bounds):
        return np.argmin(np.abs(v[:, None] - bounds[None, :]), axis=1)

    cs = idx_of(b[:, 0], xs)
    ce = np.maximum(idx_of(b[:, 2], xs) - 1, cs)
    rs = idx_of(b[:, 1], ys)
    re = np.maximum(idx_of(b[:, 3], ys) - 1, rs)
    for c, *logic in zip(cells, rs, re, cs, ce):
        c["logic"] = [int(v) for v in logic]


class CenterNetPostProcessor:
    def __init__(self, config: CenterNetConfig):
        self.config = config

    def __call__(self, raw: Dict[str, Any], meta: Dict[str, Any]
                 ) -> Dict[str, Any]:
        cfg = self.config
        dets = np.asarray(raw["dets"][0], np.float32)       # (K, 8) fmap
        scores = np.asarray(raw["scores"][0], np.float32)
        gboxes = np.asarray(raw["gboxes"][0], np.float32)

        b9 = np.concatenate([dets, scores[:, None]], axis=1)
        b9 = group_bbox_by_gbox(b9, gboxes, cfg.score_thresh,
                                cfg.v2c_dist_thresh, cfg.c2v_dist_thresh)

        # fmap -> image coords (invert centered affine)
        s, out_w = meta["s"], meta["out_w"]
        scale_back = s / out_w
        cx, cy = meta["c"]
        h, w = meta["org_shape"]
        pts = b9[:, :8].reshape(-1, 4, 2) * scale_back
        pts[:, :, 0] += cx - s / 2
        pts[:, :, 1] += cy - s / 2
        pts[:, :, 0] = np.clip(pts[:, :, 0], 0, w)
        pts[:, :, 1] = np.clip(pts[:, :, 1], 0, h)

        cells = []
        for i in range(len(b9)):
            if b9[i, 8] < cfg.score_thresh:
                continue
            quad = pts[i]
            x1, y1 = quad[:, 0].min(), quad[:, 1].min()
            x2, y2 = quad[:, 0].max(), quad[:, 1].max()
            if x2 - x1 < 1 or y2 - y1 < 1:
                continue
            cells.append({"bbox": [float(x1), float(y1), float(x2),
                                   float(y2)],
                          "poly": quad.reshape(-1).tolist(),
                          "score": float(b9[i, 8])})
        assign_logical_coords(cells)
        return {"cells": cells, "type": "center_net"}
