"""LGPMA pre- and post-processing (counterpart of
pdf_table_tpu/models/lgpma/processor.py).

Pre: the JAX pre-processor's keep-ratio size rule (max side ``max_side``,
both sides rounded to multiples of 32); the task cuts the integer window
from the resident pages and resizes it as ``cv2.resize`` does
(ops/crop_resize.py), then :meth:`LgpmaPreProcessor.normalize`.

Post: the JAX post-processor, copied: per-class score filter and exact
greedy NMS (the port's ``hard_nms``), the pyramid-mask boundary refine,
inter-class NMS, adjacency cliques to rows and columns, and empty-cell
completion. The refine's ``cv2.resize`` of the f32 masks is
``ops/crop_resize.py::resize_linear_f32``. No cv2 is imported.
"""

from __future__ import annotations

from math import ceil
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...ops.crop_resize import resize_linear_f32, resize_u8_plain
from ...ops.nms import hard_nms
from .config import LgpmaConfig

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class LgpmaPreProcessor:
    def __init__(self, config: LgpmaConfig):
        self.config = config

    def plan(self, h: int, w: int) -> Tuple[int, int, Dict[str, Any]]:
        """(nh, nw, meta) of an h x w crop: the keep-ratio size, each side
        ``round(side * scale / 32) * 32`` (Python's round), at least 32."""
        m = self.config.max_side
        scale = min(m / max(h, w), 1.0) if max(h, w) > m else 1.0
        nh = max(int(round(h * scale / 32) * 32), 32)
        nw = max(int(round(w * scale / 32) * 32), 32)
        return nh, nw, {"org_shape": (h, w), "scale": (nh / h, nw / w)}

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """One uint8 RGB crop on the host, as the JAX pre-processor's
        ``cv2.resize`` (bilinear, uint8) and normalize: {"image": (1, nh,
        nw, 3) f32, "meta"}."""
        nh, nw, meta = self.plan(*image.shape[:2])
        resized = resize_u8_plain(image, nh, nw).astype(np.float32)
        norm = (resized / 255.0 - np.asarray(MEAN, np.float32)) \
            / np.asarray(STD, np.float32)
        return {"image": norm[None].astype(np.float32), "meta": meta}

    @staticmethod
    def normalize(u8: torch.Tensor) -> torch.Tensor:
        """uint8 RGB NHWC -> ``(x / 255 - mean) / std`` in f32."""
        mean = torch.tensor(MEAN, dtype=torch.float32, device=u8.device)
        std = torch.tensor(STD, dtype=torch.float32, device=u8.device)
        return (u8.float() / 255.0 - mean) / std


# -- host geometry helpers (post_lgpma.py re-expression) --------------------

def greedy_nms(boxes: np.ndarray, scores: np.ndarray,
               thresh: float) -> np.ndarray:
    """Exact greedy NMS; returns kept indices in score order (delegates to
    the shared host hard_nms)."""
    _, _, idx = hard_nms(boxes, scores, iou_threshold=thresh,
                         score_threshold=-np.inf)
    return idx


def rect_max_iou(b1: Sequence[float], b2: Sequence[float]) -> float:
    """intersection / min(area) (post_lgpma.py:32)."""
    x1, y1 = max(b1[0], b2[0]), max(b1[1], b2[1])
    x2, y2 = min(b1[2], b2[2]), min(b1[3], b2[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    return inter / max(min(a1, a2), 1e-6)


def nms_inter_classes(cls_boxes: List[np.ndarray], thresh: float = 0.3
                      ) -> Tuple[np.ndarray, List[int]]:
    """Cross-class suppression on intersection/min-area
    (nms_inter_classes:57). cls_boxes entries are (n, 5) [x1,y1,x2,y2,s]."""
    boxes = np.concatenate(cls_boxes, 0) if cls_boxes else np.zeros((0, 5))
    labels = [c for c, b in enumerate(cls_boxes) for _ in range(len(b))]
    mark = np.ones(len(boxes), bool)
    order = boxes[:, -1].argsort()[::-1] if len(boxes) else []
    for i, cur in enumerate(order):
        if not mark[cur]:
            continue
        for ind in order[i + 1:]:
            if mark[ind] and rect_max_iou(boxes[cur], boxes[ind]) >= thresh:
                mark[ind] = False
    return boxes[mark, :4], [labels[i] for i in np.where(mark)[0]]


def refine_box_by_pyramid(box: Sequence[float], text_mask: np.ndarray,
                          soft_h: np.ndarray, soft_v: np.ndarray
                          ) -> List[float]:
    """Pyramid-mask boundary refinement for one aligned cell
    (softmasks_refine_bboxes:183-345). The horizontal ramp soft_h rises
    from the left border to the text midline and falls to the right; each
    boundary is where the least-squares plane a*x+b*y+c fitted over the
    corresponding half-box crosses the row/column mean. All arrays are
    image-space canvases."""
    height, width = text_mask.shape
    X1, Y1 = ceil(box[0]), ceil(box[1])
    X2, Y2 = ceil(box[2]) - 1, ceil(box[3] - 1)
    ys, xs = np.where(text_mask == 1)
    if len(xs) == 0:
        return list(box)
    xm, ym = xs.mean(), ys.mean()

    def fit_plane(x0, x1, y0, y1, f):
        """least-squares a*x+b*y+c over the integer grid region."""
        x0, x1 = int(x0), int(x1)
        y0, y1 = int(y0), int(y1)
        if x1 < x0 or y1 < y0:
            return None
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1),
                             np.arange(y0, y1 + 1))
        a = np.stack([gx.ravel(), gy.ravel(),
                      np.ones(gx.size)], axis=1).astype(np.float64)
        z = f[y0:y1 + 1, x0:x1 + 1].ravel().astype(np.float64)
        try:
            coef, *_ = np.linalg.lstsq(a, z, rcond=None)
        except np.linalg.LinAlgError:
            return None
        return coef

    def refine_x(x0, x1, y0, y1):
        c = fit_plane(x0, x1, y0, y1, soft_h)
        if c is None or abs(c[0]) < 1e-9:
            return -1
        y_mean = (y0 + y1) / 2
        return int(-(c[2] + y_mean * c[1]) / c[0] + 0.5)

    def refine_y(x0, x1, y0, y1):
        c = fit_plane(x0, x1, y0, y1, soft_v)
        if c is None or abs(c[1]) < 1e-9:
            return -1
        x_mean = (x0 + x1) / 2
        return int(-(c[2] + x_mean * c[0]) / c[1] + 0.5)

    x1r = refine_x(X1, int(xm), Y1, Y2)
    x2r = refine_x(ceil(xm), X2, Y1, Y2)
    y1r = refine_y(X1, X2, Y1, int(ym))
    y2r = refine_y(X1, X2, ceil(ym), Y2)
    x1r = x1r if 0 <= x1r <= width else box[0]
    x2r = x2r if 0 <= x2r <= width else box[2]
    y1r = y1r if 0 <= y1r <= height else box[1]
    y2r = y2r if 0 <= y2r <= height else box[3]
    return [float(x1r), float(y1r), float(x2r), float(y2r)]


def bbox2adj(boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col adjacency by midpoint containment + shared-band transitivity
    (bbox2adj:145-182)."""
    n = len(boxes)
    adjr = np.zeros((n, n), int)
    adjc = np.zeros((n, n), int)
    xm = boxes[:, ::2].mean(1)
    ym = boxes[:, 1::2].mean(1)
    for i, b in enumerate(boxes):
        ir = np.where((boxes[:, 1] < ym[i]) & (boxes[:, 3] > ym[i]))[0]
        ic = np.where((boxes[:, 0] < xm[i]) & (boxes[:, 2] > xm[i]))[0]
        adjr[ir, i] = adjr[i, ir] = 1
        adjc[ic, i] = adjc[i, ic] = 1
        for j, b2 in enumerate(boxes):
            if not (b2[1] + 4 >= b[3] or b[1] + 4 >= b2[3]):
                band = np.where((np.maximum(b[1], b2[1]) < ym)
                                & (ym < np.minimum(b[3], b2[3])))[0]
                if len(band):
                    adjr[j, i] = adjr[i, j] = 1
            if not (b2[0] >= b[2] or b[0] >= b2[2]):
                band = np.where((np.maximum(b[0], b2[0]) < xm)
                                & (xm < np.minimum(b[2], b2[2])))[0]
                if len(band):
                    adjc[j, i] = adjc[i, j] = 1
    return adjr, adjc


def _max_cliques(adj: np.ndarray) -> List[List[int]]:
    """Bron-Kerbosch with pivoting (replaces networkx find_cliques)."""
    n = len(adj)
    neigh = [set(np.where(adj[i])[0]) - {i} for i in range(n)]
    out: List[List[int]] = []

    def bk(r: set, p: set, x: set):
        if not p and not x:
            out.append(sorted(r))
            return
        pivot = max(p | x, key=lambda u: len(neigh[u] & p))
        for v in list(p - neigh[pivot]):
            bk(r | {v}, p & neigh[v], x & neigh[v])
            p.remove(v)
            x.add(v)

    bk(set(), set(range(n)), set())
    return out


def adj_to_cell(adj: np.ndarray, boxes: np.ndarray, mod: str
                ) -> List[np.ndarray]:
    """Maximal cliques (= rows/cols) ordered by the mean coordinate of
    their clique-exclusive members (adj_to_cell:95-144)."""
    assert mod in ("row", "col")
    n = len(adj)
    cliques = _max_cliques(adj | np.eye(n, dtype=int))
    times = np.zeros(n)
    for cl in cliques:
        for node in cl:
            times[node] += 1
    coord = []
    for ind, cl in enumerate(cliques):
        solo = [node for node in cl if times[node] == 1]
        sel = solo if solo else cl
        if mod == "row":
            coord.append((ind, (boxes[sel, 1] + boxes[sel, 3]).mean()))
        else:
            coord.append((ind, (boxes[sel, 0] + boxes[sel, 2]).mean()))
    coord.sort(key=lambda t: t[1])
    listcell: List[np.ndarray] = [np.array([]) for _ in range(n)]
    for ind, (ci, _) in enumerate(coord):
        for node in cliques[ci]:
            listcell[node] = np.append(listcell[node], ind)
    return listcell


class LgpmaPostProcessor:
    def __init__(self, config: LgpmaConfig):
        self.config = config

    # -- stage 1: per-class detections --------------------------------------

    def _detections(self, raw: Dict[str, Any]) -> List[np.ndarray]:
        cfg = self.config
        probs = np.asarray(raw["cls_probs"][0], np.float32)   # (P, C+1)
        det_boxes = np.asarray(raw["det_boxes"][0], np.float32)
        cls_dets = []
        for c in range(cfg.num_classes):
            s = probs[:, c]
            sel = np.where(s >= cfg.score_thresh)[0]
            if not len(sel):
                cls_dets.append(np.zeros((0, 6), np.float32))
                continue
            boxes = det_boxes[sel, c]
            keep = greedy_nms(boxes, s[sel], cfg.nms_thresh)
            det = np.concatenate(
                [boxes[keep], s[sel][keep, None],
                 sel[keep, None].astype(np.float32)], axis=1)  # + prop idx
            cls_dets.append(det)
        return cls_dets

    # -- stage 2: pyramid-mask refinement ------------------------------------

    def _refine(self, cls_dets: List[np.ndarray], raw: Dict[str, Any],
                canvas_hw: Tuple[int, int]) -> List[np.ndarray]:
        cfg = self.config
        mask_idx = np.asarray(raw["mask_idx"][0])             # (D,)
        masks = np.asarray(raw["lpma_masks"][0], np.float32)  # (D,S,S,C+2)
        slot_of = {int(p): d for d, p in enumerate(mask_idx)}
        H, W = canvas_hw
        out = []
        for c, dets in enumerate(cls_dets):
            refined = []
            for det in dets:
                box, score, pidx = det[:4], det[4], int(det[5])
                d = slot_of.get(pidx)
                res = list(box)
                if d is not None:
                    x1, y1 = int(max(box[0], 0)), int(max(box[1], 0))
                    x2 = int(min(ceil(box[2]), W))
                    y2 = int(min(ceil(box[3]), H))
                    if x2 - x1 >= 2 and y2 - y1 >= 2:
                        m = resize_linear_f32(masks[d], y2 - y1, x2 - x1)
                        text = np.zeros((H, W), np.float32)
                        soft_h = np.zeros((H, W), np.float32)
                        soft_v = np.zeros((H, W), np.float32)
                        text[y1:y2, x1:x2] = \
                            m[..., c] >= cfg.mask_thresh
                        soft_h[y1:y2, x1:x2] = m[..., cfg.num_classes]
                        soft_v[y1:y2, x1:x2] = m[..., cfg.num_classes + 1]
                        if text.sum() > 5:
                            res = refine_box_by_pyramid(box, text,
                                                        soft_h, soft_v)
                refined.append(res + [float(score)])
            out.append(np.asarray(refined, np.float32).reshape(-1, 5))
        return out

    # -- entry ----------------------------------------------------------------

    def __call__(self, raw: Dict[str, Any],
                 meta: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        sy, sx = meta["scale"]
        h, w = meta["org_shape"]
        canvas_hw = (int(round(h * sy)), int(round(w * sx)))

        cls_dets = self._detections(raw)
        if cfg.refine_bboxes:
            cls_dets5 = self._refine(cls_dets, raw, canvas_hw)
        else:
            cls_dets5 = [d[:, :5] for d in cls_dets]
        boxes, labels = nms_inter_classes(cls_dets5)
        if not len(boxes):
            return {"cells": [], "type": "lgpma"}

        # back to original-image coords
        boxes = boxes.copy()
        boxes[:, 0::2] = np.clip(boxes[:, 0::2] / sx, 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2] / sy, 0, h)
        ok = (boxes[:, 2] - boxes[:, 0] >= 1) & \
             (boxes[:, 3] - boxes[:, 1] >= 1)
        boxes = boxes[ok]
        labels = [l for l, k in zip(labels, ok) if k]
        if not len(boxes):
            return {"cells": [], "type": "lgpma"}

        # logical coordinates via adjacency cliques
        adjr, adjc = bbox2adj(boxes)
        colspan = adj_to_cell(adjc, boxes, "col")
        rowspan = adj_to_cell(adjr, boxes, "row")
        cells: List[Dict[str, Any]] = []
        for b, lab, rows, cols in zip(boxes, labels, rowspan, colspan):
            if not len(rows) or not len(cols):
                continue
            cells.append({
                "bbox": [float(v) for v in b],
                "logic": [int(rows.min()), int(rows.max()),
                          int(cols.min()), int(cols.max())],
                "label": int(lab), "score": 1.0})

        # empty-cell completion (post_processing:476-490): grid holes
        # become single-unit empty cells with a synthesized bbox
        if cells:
            nr = max(c["logic"][1] for c in cells) + 1
            nc = max(c["logic"][3] for c in cells) + 1
            area = np.zeros((nr, nc), bool)
            row_y = [[] for _ in range(nr)]
            col_x = [[] for _ in range(nc)]
            for c in cells:
                rs, re, cs, ce = c["logic"]
                area[rs:re + 1, cs:ce + 1] = True
                row_y[rs].append(c["bbox"][1])
                row_y[re].append(c["bbox"][3])
                col_x[cs].append(c["bbox"][0])
                col_x[ce].append(c["bbox"][2])
            ry = [float(np.mean(v)) if v else 0.0 for v in row_y]
            cx = [float(np.mean(v)) if v else 0.0 for v in col_x]
            for r in range(nr):
                for cc in range(nc):
                    if not area[r, cc]:
                        cells.append({"bbox": [cx[cc], ry[r],
                                               cx[cc], ry[r]],
                                      "logic": [r, r, cc, cc],
                                      "label": -1, "score": 0.0,
                                      "empty": True})
        return {"cells": cells, "type": "lgpma"}
