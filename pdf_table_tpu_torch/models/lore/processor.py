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

from typing import Any, Dict, List, Sequence

import numpy as np

from ...ops.cv_host import warp_affine_linear
from .config import LoreConfig


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
        warped = warp_affine_linear(image[:, :, ::-1], mat, (inp_w, inp_h))
        norm = (warped / 255.0 - self.MEAN) / self.STD
        return {"image": norm[None].astype(np.float32), "meta": meta}

    def warp_u8(self, image: np.ndarray) -> Dict[str, Any]:
        """``cv2.warpAffine`` of the uint8 image itself with
        ``INTER_LINEAR``: OpenCV 5.0.0 samples a uint8 image with the f32
        kernel of :func:`warp_affine_linear` and rounds the blend to the
        nearest integer, ties to even (releases before 4.11 used 1/32-px
        fixed-point coordinates and 15-bit weights instead). Held to
        ``cv2.warpAffine`` bit for bit by tests/test_torch_tsr_crops.py."""
        inp_h, inp_w = self.config.resolution
        mat, meta = self._affine(*image.shape[:2])
        u8 = warp_affine_linear(np.asarray(image, np.uint8), mat,
                                (inp_w, inp_h), out_dtype=np.uint8)
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
