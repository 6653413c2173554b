"""PicoDet post-processing (counterpart of
pdf_table_tpu/models/picodet/processor.py).

On the device: the GFL decode (softmax over the reg_max + 1 bins, expected
distance x stride from the cell centres) and a global top-k
(:func:`device_decode_topk`), then the per-class greedy NMS as a fixed-point
iteration (:func:`device_nms_pack`), so that only the survivors (B, C,
keep_top_k, 5) are downloaded. On the host: clip, rescale to the page and a
global score sort (``PicoDetPostProcessor.from_device_nms``), or the host
route that runs ``hard_nms`` over the downloaded candidates
(``from_candidates``). Ties in a top-k or a sort go to the lower index, as
``jax.lax.top_k`` and a stable ``argsort`` put them.

The per-image path: ``PicoDetPreProcessor`` resizes on the host with
OpenCV's bilinear arithmetic (``ops/crop_resize.py``: the f32 BGR image,
or the uint8 one for ``resize_u8``), and ``PicoDetPostProcessor.__call__``
decodes each level's head maps on the host, takes its ``nms_top_k`` and
runs ``from_candidates``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...entity.enums import HtmlContentType
from ...entity.ocr_cell import OcrCell
from ...ops.crop_resize import resize_linear_f32, resize_u8_plain
from ...ops.nms import _iou_matrix, hard_nms
from .config import PicoDetConfig

# NMS rounds run between two checks for the fixed point: each check is a
# device-to-host sync, and a suppression chain settles in a few rounds
NMS_ROUNDS_PER_CHECK = 4


class PicoDetPreProcessor:
    def __init__(self, config: PicoDetConfig):
        self.config = config

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """(H, W, 3) uint8 RGB -> {"image": (1, img_height, img_width, 3)
        f32 normalized, "org_shape", "scale_factor"}: the BGR copy resized,
        flipped back to RGB, / 255, imagenet mean and std."""
        cfg = self.config
        img = image[:, :, ::-1].astype(np.float32)
        h, w = img.shape[:2]
        resized = resize_linear_f32(img, cfg.img_height, cfg.img_width)
        resized = resized[:, :, ::-1] / 255.0
        resized = (resized - np.array(cfg.norm_mean, np.float32)) \
            / np.array(cfg.norm_std, np.float32)
        return {"image": resized[None].astype(np.float32),
                "org_shape": (h, w),
                "scale_factor": (cfg.img_height / h, cfg.img_width / w)}

    def resize_u8(self, image: np.ndarray) -> Dict[str, Any]:
        """The uint8 RGB image resized alone (the batched path normalizes
        on the device): {"image_u8": (1, img_height, img_width, 3) uint8,
        "org_shape", "scale_factor"}."""
        cfg = self.config
        h, w = image.shape[:2]
        resized = resize_u8_plain(np.ascontiguousarray(image),
                                  cfg.img_height, cfg.img_width)
        return {"image_u8": resized[None], "org_shape": (h, w),
                "scale_factor": (cfg.img_height / h, cfg.img_width / w)}


@functools.lru_cache(maxsize=32)
def _level_centers(fh: int, fw: int, stride: int) -> np.ndarray:
    hh, ww = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    ct_row = (hh.reshape(-1) + 0.5) * stride
    ct_col = (ww.reshape(-1) + 0.5) * stride
    return np.stack([ct_col, ct_row, ct_col, ct_row],
                    axis=1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _level_centers_on(fh: int, fw: int, stride: int, device: torch.device
                      ) -> torch.Tensor:
    """:func:`_level_centers` on ``device``, uploaded once."""
    return torch.from_numpy(_level_centers(fh, fw, stride)).to(device)


def gfl_expected_distance(box_dist: np.ndarray, reg_max: int) -> np.ndarray:
    """(HW, 4*(reg_max+1)) -> (HW, 4) expected distances (stride units):
    the host form of the decode's bin expectation."""
    d = box_dist.reshape(-1, reg_max + 1)
    d = d - d.max(axis=1, keepdims=True)
    e = np.exp(d)
    p = e / e.sum(axis=1, keepdims=True)
    exp = (p * np.arange(reg_max + 1)).sum(axis=1)
    return exp.reshape(-1, 4)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last dim, ties
    toward the lower index (``torch.topk`` does not promise an order among
    ties on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _decode_topk(raw: Dict[str, Any], cfg: PicoDetConfig, k: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GFL decode + global top-k on the device. raw: {'scores': [(B, HW,
    C)], 'boxes': [(B, HW, 4*(reg_max+1))]} -> (boxes (B, k, 4) in input
    coordinates, scores (B, k, C))."""
    all_boxes, all_scores = [], []
    for stride, score, bd in zip(cfg.strides, raw["scores"], raw["boxes"]):
        fh = -(-cfg.img_height // stride)
        fw = -(-cfg.img_width // stride)
        dev = score.device
        centers = _level_centers_on(fh, fw, stride, dev)
        B, HW, _ = score.shape
        d = bd.reshape(B, HW, 4, cfg.reg_max + 1).float()
        p = torch.softmax(d, dim=-1)
        bins = torch.arange(cfg.reg_max + 1, dtype=torch.float32, device=dev)
        dist = (p * bins).sum(-1) * stride
        # centers + [-1, -1, 1, 1] * dist (a sign flip is exact)
        all_boxes.append(centers[None] + torch.cat([-dist[..., :2],
                                                    dist[..., 2:]], dim=-1))
        all_scores.append(score.float())
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    # the default budget is the host route's per-level nms_top_k, so real
    # candidates do not fall off the global top-k on dense pages
    k = min(k if k > 0 else cfg.nms_top_k, scores.shape[1])
    _, top = topk_stable(scores.max(-1).values, k)            # (B, k)
    b = torch.take_along_dim(boxes, top[..., None], dim=1)
    s = torch.take_along_dim(scores, top[..., None], dim=1)
    return b, s


def device_decode_topk(raw: Dict[str, Any], cfg: PicoDetConfig,
                       k: int = 0) -> torch.Tensor:
    """Decode + top-k packed as one (B, k, 4 + C) array [boxes | scores]."""
    b, s = _decode_topk(raw, cfg, k)
    return torch.cat([b, s], dim=-1)


def nms_dominance(b: torch.Tensor, s: torch.Tensor, cfg: PicoDetConfig):
    """(alive (B, C, k), dominates (B, C, k, k), scores (B, C, k)):
    ``dominates[b, c, j, i]`` says that j would suppress i if j is kept
    (IoU at or over the threshold, j earlier in the stable
    score-descending order)."""
    iou = _iou_matrix(b)                                 # (B, k, k)
    m = iou >= float(cfg.nms_threshold)
    sc = s.permute(0, 2, 1)                              # (B, C, k)
    alive = sc > float(cfg.score_threshold)
    # rank = the inverse of the stable descending order
    order = torch.sort(sc, dim=-1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=sc.device)
        .expand_as(order).contiguous())
    dom = m[:, None] & (rank[..., :, None] < rank[..., None, :])
    return alive, dom, sc


def nms_fixed_point(alive: torch.Tensor, dom: torch.Tensor
                    ) -> Tuple[torch.Tensor, int]:
    """The greedy keep set as the fixed point of ``keep <- alive & ~any_j
    (keep_j & dominates[j, i])`` from ``keep = alive``, at most k rounds
    (``jax.lax.while_loop`` at processor.py:162-172 of the JAX package).
    Rounds run ``NMS_ROUNDS_PER_CHECK`` at a time between two host checks
    of the fixed point; rounds past it change nothing. Returns (keep,
    rounds run)."""
    k = alive.shape[-1]
    keep, prev, it = alive, ~alive, 0
    while it < k:
        for _ in range(min(NMS_ROUNDS_PER_CHECK, k - it)):
            sup = (keep[..., :, None] & dom).any(dim=-2)
            keep, prev = alive & ~sup, keep
            it += 1
        if not bool((keep != prev).any()):
            break
    return keep, it


def device_nms_pack(b: torch.Tensor, s: torch.Tensor, cfg: PicoDetConfig
                    ) -> torch.Tensor:
    """Per-class greedy NMS over decoded candidates b (B, k, 4) / s (B, k,
    C) on their device. Returns survivor rows (B, C, keep_top_k, 5) =
    [x1, y1, x2, y2, score] in keep (= score) order; tail rows are 0."""
    kk = int(min(cfg.keep_top_k, b.shape[1]))
    alive, dom, sc = nms_dominance(b, s, cfg)
    keep, _ = nms_fixed_point(alive, dom)
    return pack_survivors(b, sc, keep, kk)


def device_decode_nms(raw: Dict[str, Any], cfg: PicoDetConfig
                      ) -> torch.Tensor:
    """GFL decode + top-k + per-class greedy NMS on the head maps' device:
    :func:`device_nms_pack` of :func:`device_decode_topk`'s candidates,
    survivor rows (B, C, keep_top_k, 5)."""
    b, s = _decode_topk(raw, cfg)
    return device_nms_pack(b, s, cfg)


def pack_survivors(b: torch.Tensor, sc: torch.Tensor, keep: torch.Tensor,
                   kk: int) -> torch.Tensor:
    """The ``kk`` best kept rows per class; -inf marks the others, so the
    padding never collides with a real score of 0."""
    masked = torch.where(keep, sc, torch.full_like(sc, -float("inf")))
    top_s, top_i = topk_stable(masked, kk)                    # (B, C, kk)
    bb = torch.take_along_dim(b[:, None], top_i[..., None], dim=2)
    has = top_s > -float("inf")
    rows = torch.cat([bb, torch.where(has, top_s,
                                      torch.zeros_like(top_s))[..., None]],
                     dim=-1)
    return torch.where(has[..., None], rows, torch.zeros_like(rows))


class PicoDetPostProcessor:
    def __init__(self, config: PicoDetConfig):
        self.config = config

    def _result(self, b, score: float, ci: int, sx: float, sy: float
                ) -> Dict[str, Any]:
        cfg = self.config
        ih, iw = cfg.img_height, cfg.img_width
        return {"bbox": [float(np.clip(b[0], 0, iw)) / sx,
                         float(np.clip(b[1], 0, ih)) / sy,
                         float(np.clip(b[2], 0, iw)) / sx,
                         float(np.clip(b[3], 0, ih)) / sy],
                "label": cfg.id2label[ci], "score": float(score),
                "category_id": ci}

    def __call__(self, scores, boxes, org_shape: Tuple[int, int]
                 ) -> Dict[str, Any]:
        """Host decode of one image's head maps: per level (HW, C) scores
        and (HW, 4 * (reg_max + 1)) bins; each level's ``nms_top_k`` best
        cells by their top class score (numpy's ascending ``argsort``
        reversed, as the JAX post-processor takes them), then
        :meth:`from_candidates`."""
        cfg = self.config
        ih, iw = cfg.img_height, cfg.img_width
        all_boxes, all_scores = [], []
        for stride, score, bd in zip(cfg.strides, scores, boxes):
            # ceil grid: the SAME-padded stride-2 convs emit ceil-sized maps
            fh, fw = -(-ih // stride), -(-iw // stride)
            centers = _level_centers(fh, fw, stride)
            score = np.asarray(score)
            dist = gfl_expected_distance(np.asarray(bd), cfg.reg_max) * stride
            k = min(cfg.nms_top_k, score.shape[0])
            top = np.argsort(score.max(axis=1))[::-1][:k]
            all_boxes.append(centers[top] + np.array([-1, -1, 1, 1],
                                                     np.float32) * dist[top])
            all_scores.append(score[top])
        return self.from_candidates(np.concatenate(all_boxes),
                                    np.concatenate(all_scores), org_shape)

    def from_candidates(self, bboxes: np.ndarray, confid: np.ndarray,
                        org_shape: Tuple[int, int]) -> Dict[str, Any]:
        """Threshold + per-class ``hard_nms`` + rescale over decoded
        candidates (bboxes (N, 4) in input coords, confid (N, C))."""
        cfg = self.config
        oh, ow = org_shape
        sy, sx = cfg.img_height / oh, cfg.img_width / ow
        results: List[Dict[str, Any]] = []
        for ci in range(confid.shape[1]):
            probs = confid[:, ci]
            mask = probs > cfg.score_threshold
            if not mask.any():
                continue
            kept_boxes, kept_scores, _ = hard_nms(
                bboxes[mask], probs[mask],
                iou_threshold=cfg.nms_threshold, top_k=cfg.keep_top_k)
            for b, s in zip(kept_boxes, kept_scores):
                results.append(self._result(b, s, ci, sx, sy))
        results.sort(key=lambda r: -r["score"])
        return {"bboxs": results}

    def from_device_nms(self, packed: np.ndarray,
                        org_shape: Tuple[int, int]) -> Dict[str, Any]:
        """Host tail of the device NMS: packed (C, keep_top_k, 5) survivor
        rows -> the same result dict as :meth:`from_candidates`."""
        cfg = self.config
        oh, ow = org_shape
        sy, sx = cfg.img_height / oh, cfg.img_width / ow
        results: List[Dict[str, Any]] = []
        for ci in range(packed.shape[0]):
            rows = packed[ci]
            for b in rows[rows[:, 4] > cfg.score_threshold]:
                results.append(self._result(b, b[4], ci, sx, sy))
        results.sort(key=lambda r: -r["score"])
        return {"bboxs": results}

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
