"""DocXLayout pre- and post-processing (counterpart of
pdf_table_tpu/models/docx_layout/processor.py).

Pre, on the device from the resident canvases: the JAX pre-processor runs
``cv2.warpAffine`` of the page's BGR f32 copy with the centred matrix
(``s = max(h, w)``, ``scale = 768 / s``, border 0), then
``(x / 255 - MEAN) / STD``; Cycle-CenterNet's pre-processor
(models/center_net/processor.py) samples the same points with the same
normalization, the page as its window, and tasks/layout.py uses it.
:class:`DocXLayoutPreProcessor` is the JAX pre-processor itself on the host
(``ops/cv_host.py::warp_affine_linear``, OpenCV 5.0.0's f32
``warpAffine`` bit for bit), the yardstick of the device warp.

Post, on the host from one page's decode: scale back to page
coordinates, clip, threshold, :func:`pnms` (the JAX loop's result, its
IoUs computed for all pairs at once) and the layout cells (copied).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ...entity.enums import HtmlContentType
from ...entity.ocr_cell import OcrCell
from ...ops.cv_host import warp_affine_linear
from .config import DocXLayoutConfig


class DocXLayoutPreProcessor:
    MEAN = np.array([0.408, 0.447, 0.470], np.float32)
    STD = np.array([0.289, 0.274, 0.278], np.float32)

    def __init__(self, config: DocXLayoutConfig):
        self.config = config

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """(H, W, 3) uint8 RGB -> {"image": (1, inp_h, inp_w, 3) f32, the
        BGR copy warped by the centred matrix and normalized, "meta": {c,
        s, org_shape, out_w, out_h}}."""
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
                "meta": {"c": c, "s": float(s), "org_shape": (h, w),
                         "out_w": inp_w // self.config.down_ratio,
                         "out_h": inp_h // self.config.down_ratio}}


def poly_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Axis-aligned IoU of the hulls of two (8,) quads: the JAX package's
    approximation of the reference's polygon IoU (shapely polygons), one
    pair of :func:`pairwise_poly_iou`."""
    return pairwise_poly_iou(np.stack([a, b]))[0, 1]


def pairwise_poly_iou(quads: np.ndarray) -> np.ndarray:
    """(n, 8) quads -> (n, n) axis-aligned IoU of their hulls (the JAX
    package's ``poly_iou``, its approximation of the reference's polygon
    IoU) for every pair: each entry the JAX function's operations in the
    quads' dtype, in its order."""
    x1, y1 = quads[:, 0::2].min(1), quads[:, 1::2].min(1)
    x2, y2 = quads[:, 0::2].max(1), quads[:, 1::2].max(1)
    zero = np.zeros((), quads.dtype)
    iw = np.maximum(zero, np.minimum(x2[:, None], x2[None])
                    - np.maximum(x1[:, None], x1[None]))
    ih = np.maximum(zero, np.minimum(y2[:, None], y2[None])
                    - np.maximum(y1[:, None], y1[None]))
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    ua = area[:, None] + area[None] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ua > 0, inter / ua, zero)


def pnms(dets: np.ndarray, thresh: float = 0.3) -> List[int]:
    """Polygon NMS keep-indices over (n, 9) [quad 8, score] rows: the JAX
    function's greedy loop in ``np.argsort(-scores)`` order, each kept
    row suppressing the rows it overlaps by ``thresh`` at once from the
    pairwise IoU matrix."""
    if len(dets) == 0:
        return []
    order = np.argsort(-dets[:, 8])
    over = pairwise_poly_iou(dets[:, :8]) >= thresh
    keep: List[int] = []
    suppressed = np.zeros(len(dets), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= over[i]
    return keep


class DocXLayoutPostProcessor:
    def __init__(self, config: DocXLayoutConfig):
        self.config = config

    def __call__(self, raw: Dict[str, Any], meta: Dict[str, Any]
                 ) -> Dict[str, Any]:
        """``raw``: one page's decode (models/docx_layout/model.py's
        ``unpack_docx``) -> {"bboxs", "subfield_dets"} in page
        coordinates."""
        cfg = self.config
        dets = np.asarray(raw["dets"], np.float32)
        scores = np.asarray(raw["scores"], np.float32)
        clses = np.asarray(raw["clses"])

        # fmap -> original image coords (invert centered affine)
        s = meta["s"]
        out_w = meta["out_w"]
        scale_back = s / out_w
        cx, cy = meta["c"]
        pts = dets.reshape(-1, 4, 2) * scale_back
        pts[:, :, 0] += cx - s / 2
        pts[:, :, 1] += cy - s / 2
        h, w = meta["org_shape"]
        pts[:, :, 0] = np.clip(pts[:, :, 0], 0, w)
        pts[:, :, 1] = np.clip(pts[:, :, 1], 0, h)

        keep_mask = scores >= cfg.scores_thresh
        dets9 = np.concatenate([pts.reshape(-1, 8), scores[:, None]], axis=1)
        idx = pnms(dets9[keep_mask])
        valid = np.where(keep_mask)[0][idx] if idx else np.array([], int)

        results = []
        for i in valid:
            quad = pts[i]
            label = cfg.id2label.get(int(clses[i]), str(int(clses[i])))
            results.append({"bbox": [float(quad[:, 0].min()),
                                     float(quad[:, 1].min()),
                                     float(quad[:, 0].max()),
                                     float(quad[:, 1].max())],
                            "poly": quad.reshape(-1).tolist(),
                            "label": label, "score": float(scores[i]),
                            "category_id": int(clses[i])})

        # full / sub column detections from hm_sub
        sdets = np.asarray(raw["sub_dets"], np.float32)
        sscores = np.asarray(raw["sub_scores"], np.float32)
        sclses = np.asarray(raw["sub_clses"])
        spts = sdets.reshape(-1, 4, 2) * scale_back
        spts[:, :, 0] += cx - s / 2
        spts[:, :, 1] += cy - s / 2
        sub_labels = {0: "full_column", 1: "sub_column"}
        subfields = []
        for i in np.where(sscores >= cfg.scores_thresh)[0]:
            q = spts[i]
            subfields.append({
                "bbox": [float(np.clip(q[:, 0].min(), 0, w)),
                         float(np.clip(q[:, 1].min(), 0, h)),
                         float(np.clip(q[:, 0].max(), 0, w)),
                         float(np.clip(q[:, 1].max(), 0, h))],
                "label": sub_labels.get(int(sclses[i]), "sub"),
                "score": float(sscores[i])})
        return {"bboxs": results, "subfield_dets": subfields}

    def to_layout_cells(self, result: Dict[str, Any]) -> List[OcrCell]:
        cells = []
        for r in result["bboxs"]:
            cell = OcrCell.from_bbox(r["bbox"], text=r["label"],
                                     score=r["score"])
            cell.cell_type = (HtmlContentType.TABLE if r["label"] == "table"
                              else HtmlContentType.TXT)
            cell.label = r["label"]
            cells.append(cell)
        return cells
