"""Box NMS pieces (counterpart of pdf_table_tpu/ops/nms.py): the pairwise
IoU matrix in torch, which the layout lane's device NMS builds on, the
greedy keep-mask ``nms_mask`` on the boxes' device, and the host greedy
``hard_nms`` in numpy, which the host route of
``PicoDetPostProcessor.from_candidates`` runs."""

from __future__ import annotations

import numpy as np
import torch


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU; 0 where the union is empty."""
    a = boxes[..., :, None, :]
    b = boxes[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) \
        * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


# steps between the host's looks at a device loop's state
CHECK_EVERY = 16


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, score_threshold: float = 0.0
             ) -> torch.Tensor:
    """Greedy NMS keep-mask over (N, 4) / (N,) on their device.

    Each step keeps the best unsuppressed box (the lower index on a tie)
    and suppresses its overlaps, as the JAX op's N-step loop does. The
    steps run without a host sync; every ``CHECK_EVERY`` steps the loop
    ends once no box is left alive, which changes no result."""
    n = boxes.shape[0]
    iou = _iou_matrix(boxes)
    alive = scores > score_threshold
    keep = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    ninf = torch.tensor(float("-inf"), dtype=scores.dtype,
                        device=scores.device)
    rows = torch.arange(n, device=boxes.device)
    for step in range(n):
        if step % CHECK_EVERY == 0 and not bool(alive.any()):
            break
        s = torch.where(alive, scores, ninf)
        best = torch.argmax(s)
        has = s[best] > ninf
        sel = (rows == best) & has
        keep = keep | sel
        alive = alive & ~((iou[best] >= iou_threshold) & has) & ~sel
    return keep


def hard_nms(boxes, scores, iou_threshold: float = 0.5,
             score_threshold: float = 0.0, top_k: int = -1):
    """Host greedy NMS: kept (boxes, scores, indices), score-sorted with
    ties in index order."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if boxes.shape[0] == 0:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))
    valid = scores > score_threshold
    order = np.argsort(-scores, kind="stable")
    order = order[valid[order]]
    area = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) \
        * np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        union = area[i] + area - inter
        # guard before dividing: zero-area pairs give 0, not NaN
        iou = np.divide(inter, union, out=np.zeros_like(inter),
                        where=union > 0)
        suppressed |= iou >= iou_threshold
    idx = np.asarray(keep, np.int64)
    if top_k > 0:
        idx = idx[:top_k]
    return boxes[idx], scores[idx], idx
