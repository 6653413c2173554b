"""Coordinate-scaling math helpers (counterpart of
pdf_table_tpu/utils/math_utils.py): boxes between PDF user space (origin
bottom-left, y up) and raster image space (origin top-left, y down),
IoU, overlap and polygon measures, vectorized over numpy arrays."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class MathUtils:

    @staticmethod
    def scale_pdf(k: Sequence[float], factors: Tuple[float, float, float]) -> tuple:
        """PDF-space bbox (x1, y1, x2, y2) -> image-space bbox.

        ``factors = (sx, sy, img_height)``: x scales by sx, y flips about the
        page and scales by sy.
        """
        x1, y1, x2, y2 = k
        sx, sy, h = factors
        return (x1 * sx, abs(y1 * sy - h), x2 * sx, abs(y2 * sy - h))

    @staticmethod
    def scale_image(k: Sequence[float], factors: Tuple[float, float, float]) -> tuple:
        """Image-space bbox -> PDF-space bbox. ``factors = (sx, sy, pdf_height)``."""
        x1, y1, x2, y2 = k
        sx, sy, h = factors
        return (x1 / sx, abs(h - y1 / sy), x2 / sx, abs(h - y2 / sy))

    @staticmethod
    def scale_boxes_pdf_to_image(boxes: np.ndarray, sx: float, sy: float,
                                 img_height: float) -> np.ndarray:
        """Vectorized pdf->image over an (N, 4) array of (x1, y1, x2, y2)."""
        boxes = np.asarray(boxes, dtype=np.float64)
        out = np.empty_like(boxes)
        out[:, 0] = boxes[:, 0] * sx
        out[:, 2] = boxes[:, 2] * sx
        # PDF y grows upward; image y grows downward. y1 (pdf top) maps to
        # image top, so swap is handled by taking abs after the flip.
        out[:, 1] = np.abs(boxes[:, 1] * sy - img_height)
        out[:, 3] = np.abs(boxes[:, 3] * sy - img_height)
        lo = np.minimum(out[:, 1], out[:, 3])
        hi = np.maximum(out[:, 1], out[:, 3])
        out[:, 1], out[:, 3] = lo, hi
        return out

    @staticmethod
    def scale_boxes_image_to_pdf(boxes: np.ndarray, sx: float, sy: float,
                                 pdf_height: float) -> np.ndarray:
        boxes = np.asarray(boxes, dtype=np.float64)
        out = np.empty_like(boxes)
        out[:, 0] = boxes[:, 0] / sx
        out[:, 2] = boxes[:, 2] / sx
        out[:, 1] = np.abs(pdf_height - boxes[:, 1] / sy)
        out[:, 3] = np.abs(pdf_height - boxes[:, 3] / sy)
        lo = np.minimum(out[:, 1], out[:, 3])
        hi = np.maximum(out[:, 1], out[:, 3])
        out[:, 1], out[:, 3] = lo, hi
        return out

    @staticmethod
    def iou(box_a: Sequence[float], box_b: Sequence[float]) -> float:
        """IoU of two (x1, y1, x2, y2) boxes."""
        ax1, ay1, ax2, ay2 = box_a
        bx1, by1, bx2, by2 = box_b
        ix1, iy1 = max(ax1, bx1), max(ay1, by1)
        ix2, iy2 = min(ax2, bx2), min(ay2, by2)
        iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
        inter = iw * ih
        if inter <= 0:
            return 0.0
        area_a = max(0.0, ax2 - ax1) * max(0.0, ay2 - ay1)
        area_b = max(0.0, bx2 - bx1) * max(0.0, by2 - by1)
        union = area_a + area_b - inter
        return inter / union if union > 0 else 0.0

    @staticmethod
    def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
        """Pairwise IoU: (N, 4) x (M, 4) -> (N, M). Vectorized."""
        a = np.asarray(boxes_a, dtype=np.float64)[:, None, :]   # (N,1,4)
        b = np.asarray(boxes_b, dtype=np.float64)[None, :, :]   # (1,M,4)
        ix1 = np.maximum(a[..., 0], b[..., 0])
        iy1 = np.maximum(a[..., 1], b[..., 1])
        ix2 = np.minimum(a[..., 2], b[..., 2])
        iy2 = np.minimum(a[..., 3], b[..., 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area_a = np.clip(a[..., 2] - a[..., 0], 0, None) * np.clip(a[..., 3] - a[..., 1], 0, None)
        area_b = np.clip(b[..., 2] - b[..., 0], 0, None) * np.clip(b[..., 3] - b[..., 1], 0, None)
        union = area_a + area_b - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, inter / union, 0.0)
        return iou

    @staticmethod
    def overlap_ratio(inner: Sequence[float], outer: Sequence[float]) -> float:
        """Fraction of ``inner``'s area covered by ``outer``."""
        ix1 = max(inner[0], outer[0])
        iy1 = max(inner[1], outer[1])
        ix2 = min(inner[2], outer[2])
        iy2 = min(inner[3], outer[3])
        inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
        area = max(0.0, inner[2] - inner[0]) * max(0.0, inner[3] - inner[1])
        return inter / area if area > 0 else 0.0

    @staticmethod
    def poly_area(points: np.ndarray) -> float:
        """Shoelace area of an (N, 2) polygon."""
        p = np.asarray(points, dtype=np.float64)
        x, y = p[:, 0], p[:, 1]
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    @staticmethod
    def poly_perimeter(points: np.ndarray) -> float:
        p = np.asarray(points, dtype=np.float64)
        d = p - np.roll(p, -1, axis=0)
        return float(np.sqrt((d ** 2).sum(axis=1)).sum())
