"""DB detection target generation (a copy of
pdf_table_tpu/data/det_targets.py: numpy only).

Reference semantics (model/db_net/seg_detector_loss.py + the DB paper's
MakeShrinkMap/MakeBorderMap pipeline): the probability target is each text
box shrunk by ratio r (area*(1-r^2)/perimeter inset), the threshold target
ramps from border_low to border_high inside a border band around each box.
Axis-aligned implementation (synthetic/financial documents; rotated-box
targets can reuse unclip_quad when needed).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def make_db_targets(boxes: Sequence[Sequence[float]], hw: Tuple[int, int],
                    shrink_ratio: float = 0.4,
                    thresh_low: float = 0.3,
                    thresh_high: float = 0.7) -> Dict[str, np.ndarray]:
    """boxes: (N, 4) xyxy in target-map coords; hw: (H, W).

    Returns gt / gt_mask / thresh_map / thresh_mask (H, W) float32 — the
    batch schema train.losses.db_loss consumes."""
    H, W = hw
    gt = np.zeros((H, W), np.float32)
    thresh_map = np.zeros((H, W), np.float32)
    thresh_mask = np.zeros((H, W), np.float32)
    for b in boxes:
        x1, y1, x2, y2 = [float(v) for v in b]
        w, h = x2 - x1, y2 - y1
        if w < 2 or h < 2:
            continue
        # polygon inset distance d = A(1 - r^2) / P  (DB paper eq. 6)
        d = (w * h) * (1 - shrink_ratio ** 2) / max(2 * (w + h), 1e-6)
        sx1 = int(np.clip(round(x1 + d), 0, W))
        sy1 = int(np.clip(round(y1 + d), 0, H))
        sx2 = int(np.clip(round(x2 - d), sx1 + 1, W))
        sy2 = int(np.clip(round(y2 - d), sy1 + 1, H))
        gt[sy1:sy2, sx1:sx2] = 1.0

        # border band: distance-ramped threshold target
        bx1 = int(np.clip(round(x1 - d), 0, W))
        by1 = int(np.clip(round(y1 - d), 0, H))
        bx2 = int(np.clip(round(x2 + d), 0, W))
        by2 = int(np.clip(round(y2 + d), 0, H))
        ys, xs = np.mgrid[by1:by2, bx1:bx2]
        if ys.size == 0:
            continue
        # normalized distance to the (unshrunk) box edge, 0 on edge
        dist_x = np.maximum(x1 - xs, np.maximum(0, xs - x2))
        dist_y = np.maximum(y1 - ys, np.maximum(0, ys - y2))
        outside = np.sqrt(dist_x.clip(0) ** 2 + dist_y.clip(0) ** 2)
        inside = np.minimum(np.minimum(xs - x1, x2 - xs),
                            np.minimum(ys - y1, y2 - ys)).clip(0)
        dist = np.where(outside > 0, outside, inside)
        ramp = (1.0 - np.clip(dist / max(d, 1e-6), 0, 1))
        val = thresh_low + ramp * (thresh_high - thresh_low)
        region = thresh_map[by1:by2, bx1:bx2]
        np.maximum(region, val, out=region)
        thresh_mask[by1:by2, bx1:bx2] = 1.0
    return {"gt": gt, "gt_mask": np.ones((H, W), np.float32),
            "thresh_map": thresh_map, "thresh_mask": thresh_mask}
