"""WTW table-structure metrics (counterpart of
pdf_table_tpu/eval/table_metric.py): cells matched one to one by IoU >=
0.5, logical-axis accuracy, detection precision, recall and F1."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def bbox_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N, 4), b (M, 4) xyxy -> IoU (N, M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def pair_match(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
               iou_threshold: float = 0.5) -> List[Tuple[int, int]]:
    """Greedy one-to-one matching by descending IoU (PairTable behavior,
    eval_utils.py:23-114)."""
    iou = bbox_iou_matrix(np.asarray(pred_boxes, np.float64).reshape(-1, 4),
                          np.asarray(gt_boxes, np.float64).reshape(-1, 4))
    pairs: List[Tuple[int, int]] = []
    if iou.size == 0:
        return pairs
    used_p: set = set()
    used_g: set = set()
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                       iou.shape))[0]
    for pi, gi in order:
        if iou[pi, gi] < iou_threshold:
            break
        if pi in used_p or gi in used_g:
            continue
        pairs.append((int(pi), int(gi)))
        used_p.add(int(pi))
        used_g.add(int(gi))
    return pairs


@dataclass
class TableWtwMetric:
    """Accumulates per-image results; compute() yields the reference's
    metric dict (eval/table_metric.py:30-40)."""

    iou_threshold: float = 0.5
    total_pred: int = 0
    total_gt: int = 0
    total_matched: int = 0
    total_axis_correct: int = 0

    def update(self, pred_boxes: Sequence, pred_axes: Sequence,
               gt_boxes: Sequence, gt_axes: Sequence) -> None:
        pred_boxes = np.asarray(pred_boxes, np.float64).reshape(-1, 4)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        pred_axes = np.asarray(pred_axes, np.int64).reshape(-1, 4)
        gt_axes = np.asarray(gt_axes, np.int64).reshape(-1, 4)
        pairs = pair_match(pred_boxes, gt_boxes, self.iou_threshold)
        self.total_pred += len(pred_boxes)
        self.total_gt += len(gt_boxes)
        self.total_matched += len(pairs)
        for pi, gi in pairs:
            if (pred_axes[pi] == gt_axes[gi]).all():
                self.total_axis_correct += 1

    def compute(self) -> Dict[str, float]:
        p = self.total_matched / self.total_pred if self.total_pred else 0.0
        r = self.total_matched / self.total_gt if self.total_gt else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        acc = (self.total_axis_correct / self.total_matched
               if self.total_matched else 0.0)
        return {"precision": p, "recall": r, "f1": f1,
                "axis_accuracy": acc,
                "n_pred": self.total_pred, "n_gt": self.total_gt,
                "n_matched": self.total_matched}

    def reset(self) -> None:
        self.total_pred = self.total_gt = 0
        self.total_matched = self.total_axis_correct = 0
