"""LORE pre/post processing (counterpart of
pdf_table_tpu/models/lore/processor.py).

Pre: the host preprocess without cv2, of the training data and of the
per-crop task surface (``OcrTableStructureTask.__call__`` and
``batch_infer``; the from-pages crops are warped on the device,
ops/warp.py): the upper-left (or centred) affine to the static resolution,
BGR flip and CenterNet normalization, or the uint8 warp alone.
Post: map K-slot device outputs back to image coords, round logical axes,
filter by validity, emit {"cells": [{"bbox", "poly", "logic", "score"}]},
then snap cell edges to shared grid lines.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .config import LoreConfig


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
                       size: Tuple[int, int], border: float = 0.0
                       ) -> np.ndarray:
    """``cv2.warpAffine(image, mat, size, flags=cv2.INTER_LINEAR)`` on an
    f32 (H, W, C) image, border constant ``border`` (0 by default), in
    numpy: destination pixel (x, y) (no half-pixel centres) samples the
    source at ``inv(mat) @ (x, y, 1)``, bilinearly, corners outside the
    image reading ``border``. OpenCV 5 samples
    f32 images at float source coordinates (the 1/32-px fixed point of
    older releases is gone) and rounds them as
    ``models/center_net/processor.py::warp_crops`` does: the inverse in f64,
    its f32 coefficients applied per row (``a01 * y + a02``, two roundings)
    and along the row (``a00 * x`` plus the row term, one fused
    multiply-add); the same for y. Held to ``cv2.warpAffine`` within 1e-4
    grey levels on 0..255 images (tests/test_torch_lore_train.py)."""
    h, w = image.shape[:2]
    out_w, out_h = size
    inv = invert_affine(mat).astype(np.float32)
    xs = np.arange(out_w, dtype=np.float64)[None, :]
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    row_x = inv[0, 1] * ys + inv[0, 2]
    row_y = inv[1, 1] * ys + inv[1, 2]
    sx = (np.float64(inv[0, 0]) * xs + row_x).astype(np.float32)
    sy = (np.float64(inv[1, 0]) * xs + row_y).astype(np.float32)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    ax = (sx - x0)[..., None]
    ay = (sy - y0)[..., None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    src = np.asarray(image, np.float32)

    def corner(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        if border:
            return np.where(ok[..., None], v, np.float32(border))
        return v * ok[..., None]

    one = np.float32(1)
    return (corner(0, 0) * ((one - ax) * (one - ay))
            + corner(0, 1) * (ax * (one - ay))) \
        + (corner(1, 0) * ((one - ax) * ay) + corner(1, 1) * (ax * ay))


class LorePreProcessor:
    """``__call__(image)``: uint8 RGB (H, W, 3) -> {"image": (1, inp_h,
    inp_w, 3) f32 normalized BGR, "meta": {c, s, org_shape, out_h,
    out_w}}, the JAX package's cv2 preprocess (``processor.py:30-53``);
    ``warp_u8(image)``: the warp alone, {"image_u8": (1, inp_h, inp_w, 3)
    uint8 RGB, "meta"} (``processor.py:55-79``)."""

    MEAN = np.array([0.408, 0.447, 0.470], np.float32)
    STD = np.array([0.289, 0.274, 0.278], np.float32)

    def __init__(self, config: LoreConfig):
        self.config = config

    def _affine(self, h: int, w: int):
        """The f32 warp matrix of an h x w image and its meta."""
        cfg = self.config
        inp_h, inp_w = cfg.resolution
        s = max(h, w) * 1.0
        scale = inp_w / s
        if cfg.upper_left:
            # [0, s] -> [0, inp], corner-anchored
            mat = np.array([[scale, 0, 0], [0, scale, 0]], np.float32)
            c = np.array([0.0, 0.0], np.float32)
        else:
            c = np.array([w / 2.0, h / 2.0], np.float32)
            mat = np.array([[scale, 0, inp_w / 2 - scale * c[0]],
                            [0, scale, inp_h / 2 - scale * c[1]]],
                           np.float32)
        return mat, {"c": c, "s": s, "org_shape": (h, w),
                     "out_h": inp_h // cfg.down_ratio,
                     "out_w": inp_w // cfg.down_ratio}

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        inp_h, inp_w = self.config.resolution
        mat, meta = self._affine(*image.shape[:2])
        warped = warp_affine_linear(image[:, :, ::-1].astype(np.float32),
                                    mat, (inp_w, inp_h))
        norm = (warped / 255.0 - self.MEAN) / self.STD
        return {"image": norm[None].astype(np.float32), "meta": meta}

    def warp_u8(self, image: np.ndarray) -> Dict[str, Any]:
        """``cv2.warpAffine`` of the uint8 image itself with
        ``INTER_LINEAR``: OpenCV 5 samples a uint8 image at the float
        source coordinates of its f32 path (:func:`warp_affine_linear`) and
        rounds the blend to the nearest integer, ties to even (bit-equal to
        ``cv2.warpAffine`` of OpenCV 5.0; releases before 4.11 used 1/32-px
        fixed-point coordinates and 15-bit weights instead)."""
        inp_h, inp_w = self.config.resolution
        mat, meta = self._affine(*image.shape[:2])
        warped = warp_affine_linear(image.astype(np.float32), mat,
                                    (inp_w, inp_h))
        u8 = np.clip(np.rint(warped), 0, 255).astype(np.uint8)
        return {"image_u8": u8[None], "meta": meta}


def merge_positions(vals: Sequence[float], tol: float = 5.0) -> List[float]:
    """Cluster 1-D positions within tol -> representative (mean) positions
    (copy of pdf_table_tpu/models/line_cell/grid.py::merge_positions)."""
    if not len(vals):
        return []
    vals = sorted(vals)
    groups: List[List[float]] = [[vals[0]]]
    for v in vals[1:]:
        if v - groups[-1][-1] <= tol:
            groups[-1].append(v)
        else:
            groups.append([v])
    return [float(np.mean(g)) for g in groups]


def round_logits(logi: np.ndarray) -> np.ndarray:
    """floor + (frac >= 0.5)."""
    fl = np.floor(logi)
    return (fl + (logi - fl >= 0.5)).astype(np.int64)


class LorePostProcessor:
    def __init__(self, config: LoreConfig):
        self.config = config

    def __call__(self, raw: Dict[str, Any], meta: Dict[str, Any]
                 ) -> Dict[str, Any]:
        cfg = self.config
        dets = np.asarray(raw["dets"][0], np.float32)        # (K, 8) fmap
        scores = np.asarray(raw["scores"][0], np.float32)
        valid = np.asarray(raw["valid"][0], bool)
        logi = np.asarray(raw["stacked_logi"][0], np.float32)

        h, w = meta["org_shape"]
        s = meta["s"]
        # inverse of the upper-left affine: fmap px -> image px
        pts = dets.reshape(-1, 4, 2) * (s / meta["out_w"])
        if not cfg.upper_left:
            pts[:, :, 0] += meta["c"][0] - s / 2
            pts[:, :, 1] += meta["c"][1] - s / 2
        pts[:, :, 0] = np.clip(pts[:, :, 0], 0, w)
        pts[:, :, 1] = np.clip(pts[:, :, 1], 0, h)

        axes = round_logits(logi)
        cells: List[Dict[str, Any]] = []
        for i in np.where(valid)[0]:
            quad = pts[i]
            x1, y1 = quad[:, 0].min(), quad[:, 1].min()
            x2, y2 = quad[:, 0].max(), quad[:, 1].max()
            if x2 - x1 < 1 or y2 - y1 < 1:
                continue
            cells.append({
                "bbox": [float(x1), float(y1), float(x2), float(y2)],
                "poly": quad.reshape(-1).tolist(),
                "logic": axes[i].tolist(),
                "score": float(scores[i]),
            })
        if cells:
            self.snap_to_grid(cells)
        return {"cells": cells, "type": "lore"}

    @staticmethod
    def snap_to_grid(cells: List[Dict[str, Any]], tol: float = 6.0) -> None:
        """Cluster cell edges into shared row/col lines and snap each bbox
        to them, so neighbouring cells meet exactly."""
        xs = merge_positions([c["bbox"][0] for c in cells]
                             + [c["bbox"][2] for c in cells], tol)
        ys = merge_positions([c["bbox"][1] for c in cells]
                             + [c["bbox"][3] for c in cells], tol)

        def snap(v, bounds):
            j = int(np.argmin([abs(v - b) for b in bounds]))
            return bounds[j] if abs(v - bounds[j]) <= tol else v

        for c in cells:
            x1, y1, x2, y2 = c["bbox"]
            c["bbox"] = [snap(x1, xs), snap(y1, ys),
                         snap(x2, xs), snap(y2, ys)]
