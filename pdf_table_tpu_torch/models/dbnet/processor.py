"""DBNet pre- and post-processing of the per-image path (counterpart of
pdf_table_tpu/models/dbnet/processor.py), without cv2.

Pre: the short-side resize to multiples of 32 (ModelScope) or the
limit-side one (PaddleOCR) of the f32 BGR image, with OpenCV's bilinear
arithmetic (``ops/crop_resize.py::resize_linear_f32``), then the
normalization. Post: prob map -> quads, on the host with OpenCV 5.0.0's
geometry (``ops/cv_host.py``: contours, ``minAreaRect``, ``fillPoly``,
the masked mean), the analytic unclip; or axis-aligned boxes from the
connected components (``fast_host_boxes``, ``fast_device_boxes``). The
polygon mode (``return_polygon``) approximates each contour with
OpenCV's ``approxPolyDP`` (``cv_host.approx_poly_dp``) and offsets its
vertices outward.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops import cv_host
from ...ops.crop_resize import resize_linear_f32
from .config import DbNetConfig


def resize_short(img: np.ndarray, short_side: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh = short_side
        nw = int(math.ceil(nh / h * w / 32) * 32)
    else:
        nw = short_side
        nh = int(math.ceil(nw / w * h / 32) * 32)
    return resize_linear_f32(img, nh, nw)


def resize_limit(img: np.ndarray, limit_side_len: int,
                 limit_type: str) -> np.ndarray:
    h, w = img.shape[:2]
    if limit_type == "max":
        ratio = float(limit_side_len) / max(h, w) \
            if max(h, w) > limit_side_len else 1.0
    elif limit_type == "min":
        ratio = float(limit_side_len) / min(h, w) \
            if min(h, w) < limit_side_len else 1.0
    else:
        ratio = float(limit_side_len) / max(h, w)
    nh = max(int(round(h * ratio / 32) * 32), 32)
    nw = max(int(round(w * ratio / 32) * 32), 32)
    return resize_linear_f32(img, nh, nw)


class DbNetPreProcessor:
    def __init__(self, config: DbNetConfig):
        self.config = config

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """image: HWC uint8 RGB -> {'image': (1, H, W, 3) f32, 'org_shape'}"""
        cfg = self.config
        img = image[:, :, ::-1].astype(np.float32)      # RGB -> BGR
        h, w = img.shape[:2]
        if cfg.resize_mode == "short":
            img = resize_short(img, cfg.image_short_side)
        else:
            img = resize_limit(img, cfg.limit_side_len, cfg.limit_type)
        if cfg.norm_style == "modelscope":
            img = (img - np.array([123.68, 116.78, 103.94], np.float32)) \
                / 255.0
        else:
            img = img[:, :, ::-1] / 255.0                # back to RGB
            img = (img - np.array([0.485, 0.456, 0.406], np.float32)) \
                / np.array([0.229, 0.224, 0.225], np.float32)
        return {"image": img[None].astype(np.float32), "org_shape": (h, w)}


def box_score_fast(prob: np.ndarray, quad: np.ndarray) -> float:
    """The mean of ``prob`` inside the quad (``cv2.fillPoly`` of its
    truncated integer points, ``cv2.mean`` under that mask)."""
    h, w = prob.shape[:2]
    box = quad.copy()
    x0 = int(np.clip(np.floor(box[:, 0].min()), 0, w - 1))
    x1 = int(np.clip(np.ceil(box[:, 0].max()), 0, w - 1))
    y0 = int(np.clip(np.floor(box[:, 1].min()), 0, h - 1))
    y1 = int(np.clip(np.ceil(box[:, 1].max()), 0, h - 1))
    mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.uint8)
    box[:, 0] -= x0
    box[:, 1] -= y0
    cv_host.fill_poly(mask, box.reshape(-1, 2).astype(np.int32), 1)
    return cv_host.mean_masked(prob[y0:y1 + 1, x0:x1 + 1], mask)


def mini_box(contour) -> Tuple[np.ndarray, float]:
    """The min-area rectangle's corners ordered [tl, tr, br, bl] (by x,
    then y within each side) and its shorter side."""
    rect = cv_host.min_area_rect(contour)
    pts = sorted(cv_host.box_points(rect), key=lambda p: p[0])
    i1, i4 = (0, 1) if pts[0][1] <= pts[1][1] else (1, 0)
    i2, i3 = (2, 3) if pts[2][1] <= pts[3][1] else (3, 2)
    box = np.array([pts[i1], pts[i2], pts[i3], pts[i4]], np.float32)
    return box, min(rect[1])


def unclip_quad(quad: np.ndarray, ratio: float) -> np.ndarray:
    """Expand a quad outward by d = area * ratio / perimeter along each
    corner's bisector (for a rectangle: each side grows by d, what the
    reference's polygon offset computes)."""
    a = quad.astype(np.float64)
    x, y = a[:, 0], a[:, 1]
    area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    per = np.sum(np.linalg.norm(a - np.roll(a, -1, axis=0), axis=1))
    if per < 1e-6:
        return quad
    d = area * ratio / per
    c = a.mean(axis=0)
    out = np.empty_like(a)
    for i in range(4):
        p_prev, p, p_next = a[i - 1], a[i], a[(i + 1) % 4]
        e1 = p - p_prev
        e2 = p_next - p
        n1 = np.array([e1[1], -e1[0]])
        n2 = np.array([e2[1], -e2[0]])
        for n in (n1, n2):
            nn = np.linalg.norm(n)
            if nn > 1e-9:
                n /= nn
        bis = n1 + n2
        if np.dot(bis, p - c) < 0:       # outward: away from the centroid
            bis = -bis
        bn = np.linalg.norm(bis)
        if bn < 1e-9:
            out[i] = p
            continue
        bis /= bn
        cos_half = max(np.dot(bis, n1 if np.dot(n1, bis) > 0 else -n1), 0.2)
        out[i] = p + bis * (d / cos_half)
    return out.astype(np.float32)


class DbNetPostProcessor:
    """prob (H, W) f32 -> det quads in original-image coordinates:
    {'det_polygons': (N, 8), 'det_scores': (N,)}."""

    def __init__(self, config: DbNetConfig):
        self.config = config

    def __call__(self, prob: np.ndarray, org_shape: Tuple[int, int],
                 net_shape: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, Any]:
        cfg = self.config
        prob = np.asarray(prob, np.float32)
        if prob.ndim == 3:
            prob = prob[0]
        H, W = prob.shape
        oh, ow = org_shape
        if cfg.return_polygon:
            return self._polygons_from_contours(
                prob, cv_host.find_contours(prob > cfg.thresh, limit=100),
                (H, W), (oh, ow))
        contours = cv_host.find_contours(prob > cfg.thresh,
                                         limit=cfg.max_candidates)
        boxes: List[List[float]] = []
        scores: List[float] = []
        for contour in contours:
            quad, sside = mini_box(contour)
            if sside < cfg.min_size:
                continue
            score = box_score_fast(prob, quad)
            if score < cfg.box_thresh:
                continue
            expanded = unclip_quad(quad, cfg.unclip_ratio)
            quad2, sside2 = mini_box(expanded)
            if sside2 < cfg.min_size + 2:
                continue
            quad2[:, 0] = np.clip(np.round(quad2[:, 0] / W * ow), 0, ow)
            quad2[:, 1] = np.clip(np.round(quad2[:, 1] / H * oh), 0, oh)
            boxes.append(quad2.reshape(-1).tolist())
            scores.append(float(score))
        return {"det_polygons": np.array(boxes, np.float32).reshape(-1, 8),
                "det_scores": np.array(scores, np.float32)}

    def _polygons_from_contours(self, prob, contours, net_hw, org_hw
                                ) -> Dict[str, Any]:
        """Polygon mode: each of the first 100 contours approximated at 1 %
        of its perimeter, kept with at least 4 vertices and a mean prob of
        at least ``max(box_thresh, 0.7)``, its vertices offset outward
        (:meth:`_offset_polygon`) and scaled to the original image:
        {'det_polygons': [flat vertex lists], 'det_scores', 'is_polygon':
        True}."""
        cfg = self.config
        H, W = net_hw
        oh, ow = org_hw
        polys: List[List[float]] = []
        scores: List[float] = []
        for contour in contours:
            eps = 0.01 * cv_host.arc_length(contour, True)
            approx = cv_host.approx_poly_dp(contour, eps, True).reshape(-1, 2)
            if approx.shape[0] < 4:
                continue
            score = box_score_fast(prob, approx.astype(np.float32))
            if score < max(cfg.box_thresh, 0.7):
                continue
            poly = self._offset_polygon(approx.astype(np.float64), 2.0)
            poly[:, 0] = np.clip(np.round(poly[:, 0] / W * ow), 0, ow)
            poly[:, 1] = np.clip(np.round(poly[:, 1] / H * oh), 0, oh)
            polys.append(poly.reshape(-1).tolist())
            scores.append(float(score))
        return {"det_polygons": polys,
                "det_scores": np.array(scores, np.float32),
                "is_polygon": True}

    @staticmethod
    def _offset_polygon(poly: np.ndarray, ratio: float) -> np.ndarray:
        """Each vertex moved away from the vertices' mean by d = area *
        ratio / perimeter (the polygon unclip, without pyclipper)."""
        x, y = poly[:, 0], poly[:, 1]
        area = 0.5 * abs(np.dot(x, np.roll(y, -1))
                         - np.dot(y, np.roll(x, -1)))
        per = np.sum(np.linalg.norm(poly - np.roll(poly, -1, axis=0),
                                    axis=1))
        if per < 1e-6:
            return poly
        d = area * ratio / per
        c = poly.mean(axis=0)
        out = poly.copy()
        for i in range(len(poly)):
            v = poly[i] - c
            n = np.linalg.norm(v)
            if n > 1e-9:
                out[i] = poly[i] + v / n * d
        return out

    def fast_host_boxes(self, prob: np.ndarray,
                        org_shape: Tuple[int, int]) -> Dict[str, Any]:
        """Axis-aligned boxes of the 8-connected components
        (``cv2.connectedComponentsWithStats``), largest first."""
        cfg = self.config
        prob = np.asarray(prob, np.float32)
        if prob.ndim == 3:
            prob = prob[0]
        H, W = prob.shape
        oh, ow = org_shape
        _, labels, stats = cv_host.connected_components_with_stats(
            prob > cfg.thresh)
        boxes: List[List[float]] = []
        scores: List[float] = []
        order = np.argsort(-stats[1:, 4])[:cfg.max_candidates]
        for li in order + 1:
            x, y, w, h, _area = stats[li]
            if min(w, h) < cfg.min_size:
                continue
            region = prob[y:y + h, x:x + w]
            mask = labels[y:y + h, x:x + w] == li
            score = float(region[mask].mean()) if mask.any() else 0.0
            if score < cfg.box_thresh:
                continue
            d = (w * h * cfg.unclip_ratio) / max(2.0 * (w + h), 1e-6)
            x1 = np.clip((x - d) / W * ow, 0, ow)
            y1 = np.clip((y - d) / H * oh, 0, oh)
            x2 = np.clip((x + w + d) / W * ow, 0, ow)
            y2 = np.clip((y + h + d) / H * oh, 0, oh)
            boxes.append([x1, y1, x2, y1, x2, y2, x1, y2])
            scores.append(score)
        return {"det_polygons": np.array(boxes, np.float32).reshape(-1, 8),
                "det_scores": np.array(scores, np.float32)}

    def fast_device_boxes(self, prob: torch.Tensor, org_shape,
                          max_components: int = 256) -> Dict[str, Any]:
        """Axis-aligned boxes of the connected components computed on the
        prob map's device (``ops/connected_components.py``); only the
        component rows come back."""
        from ...ops.connected_components import (component_boxes,
                                                 connected_components_scan)

        cfg = self.config
        p = torch.as_tensor(prob)
        if p.dim() == 3:
            p = p[0]
        H, W = p.shape
        labels = connected_components_scan(p > cfg.thresh)
        boxes, means, areas, valid = component_boxes(
            labels[None], p[None], max_components)
        boxes, means, valid = (t[0].cpu().numpy()
                               for t in (boxes, means, valid))
        oh, ow = org_shape
        keep = valid & (means >= cfg.box_thresh) \
            & ((boxes[:, 2] - boxes[:, 0]) >= cfg.min_size) \
            & ((boxes[:, 3] - boxes[:, 1]) >= cfg.min_size)
        boxes = boxes[keep]
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        d = (w * h * cfg.unclip_ratio) / np.maximum(2 * (w + h), 1e-6)
        grown = np.stack([boxes[:, 0] - d, boxes[:, 1] - d,
                          boxes[:, 2] + d, boxes[:, 3] + d], axis=1)
        grown[:, 0::2] = np.clip(grown[:, 0::2] / W * ow, 0, ow)
        grown[:, 1::2] = np.clip(grown[:, 1::2] / H * oh, 0, oh)
        quads = np.stack([grown[:, 0], grown[:, 1], grown[:, 2], grown[:, 1],
                          grown[:, 2], grown[:, 3], grown[:, 0], grown[:, 3]],
                         axis=1)
        return {"det_polygons": quads.astype(np.float32),
                "det_scores": means[keep].astype(np.float32)}
