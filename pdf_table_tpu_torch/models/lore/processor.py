"""LORE pre/post processing (counterpart of
pdf_table_tpu/models/lore/processor.py).

Pre: CenterNet normalization constants (the crop warp itself runs on the
device, ops/warp.py). Post: map K-slot device outputs back to image coords,
round logical axes, filter by validity, emit {"cells": [{"bbox", "poly",
"logic", "score"}]}, then snap cell edges to shared grid lines.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .config import LoreConfig


class LorePreProcessor:
    MEAN = np.array([0.408, 0.447, 0.470], np.float32)
    STD = np.array([0.289, 0.274, 0.278], np.float32)


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
