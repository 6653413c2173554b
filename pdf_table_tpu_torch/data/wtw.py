"""WTW table dataset + LORE CenterNet targets (counterpart of
pdf_table_tpu/data/wtw.py). COCO-format JSON with per-annotation
``segmentation`` 8-coordinate quads and ``logic_axis`` [rs, re, cs, ce].
Targets are fixed-size arrays (``max_objs`` slots + masks), so every batch
has one shape; batches collate by stacking.

The port carries no image decoder (the card's machine has neither cv2 nor
PIL): :class:`WtwDataset` takes ``reader(path) -> uint8 RGB (H, W, 3)``
from its caller, e.g. ``lambda p: cv2.cvtColor(cv2.imread(p),
cv2.COLOR_BGR2RGB)`` where cv2 is installed.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.lore.config import LoreConfig
from ..models.lore.processor import LorePreProcessor

Reader = Callable[[str], np.ndarray]


def gaussian_radius(det_size: Tuple[float, float],
                    min_overlap: float = 0.7) -> float:
    """Least radius that keeps IoU >= min_overlap (the CornerNet
    derivation)."""
    height, width = det_size
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = math.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0))
    r1 = (b1 + sq1) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = math.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0))
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = math.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))
    r3 = (b3 + sq3) / 2
    return max(0, min(r1, r2, r3))


def draw_gaussian(heatmap: np.ndarray, center: Tuple[float, float],
                  radius: int) -> None:
    """In-place max-blend of a 2D gaussian of ``radius`` at ``center``."""
    radius = max(int(radius), 0)
    diameter = 2 * radius + 1
    sigma = diameter / 6.0
    x = np.arange(diameter) - radius
    g = np.exp(-(x[None, :] ** 2 + x[:, None] ** 2) / (2 * sigma * sigma))
    cx, cy = int(center[0]), int(center[1])
    h, w = heatmap.shape
    if cx < 0 or cy < 0 or cx >= w or cy >= h:
        return
    l, r = min(cx, radius), min(w - cx, radius + 1)
    t, b = min(cy, radius), min(h - cy, radius + 1)
    heatmap[cy - t:cy + b, cx - l:cx + r] = np.maximum(
        heatmap[cy - t:cy + b, cx - l:cx + r],
        g[radius - t:radius + b, radius - l:radius + r])


def quad_center(quad: np.ndarray) -> Tuple[float, float]:
    return float(quad[0::2].mean()), float(quad[1::2].mean())


def make_lore_targets(quads: np.ndarray, logic: np.ndarray,
                      fmap_hw: Tuple[int, int], max_objs: int = 300,
                      with_corners: bool = False) -> Dict[str, np.ndarray]:
    """quads (N, 8) in feature-map coords; logic (N, 4).

    Returns fixed-size targets: hm (H, W, 2), hm_ind / hm_mask (M,), wh (M,
    8), reg (M, 2), logic (M, 4), gt_dets (M, 8). With ``with_corners`` also
    the cycle-pairing targets, one corner slot per distinct integer vertex
    shared by touching cells: mk_ind / mk_mask (4M,); st (4M, 8), the slot's
    corner -> centre vectors at column pair i for each cell that owns it as
    vertex i; ctr_cro_ind (4M,), cell corner 4k+i -> slot*4+i; cc_match (M,
    4), each cell's corner positions (flat feature-map index); corner_reg /
    corner_reg_ind / corner_reg_mask (4M, ...), the corners' sub-pixel
    offsets."""
    H, W = fmap_hw
    M = max_objs
    hm = np.zeros((H, W, 2), np.float32)
    hm_ind = np.zeros((M,), np.int64)
    hm_mask = np.zeros((M,), np.float32)
    wh = np.zeros((M, 8), np.float32)
    reg = np.zeros((M, 2), np.float32)
    logic_t = np.zeros((M, 4), np.float32)
    gt_dets = np.zeros((M, 8), np.float32)

    mk_ind = np.zeros((4 * M,), np.int64)
    mk_mask = np.zeros((4 * M,), np.float32)
    st = np.zeros((4 * M, 8), np.float32)
    ctr_cro_ind = np.zeros((4 * M,), np.int64)
    cc_match = np.zeros((M, 4), np.int64)
    corner_reg = np.zeros((4 * M, 2), np.float32)
    corner_reg_ind = np.zeros((4 * M,), np.int64)
    corner_reg_mask = np.zeros((4 * M,), np.float32)
    cor_slots: Dict[Tuple[int, int], int] = {}

    n = min(len(quads), M)
    for i in range(n):
        q = np.asarray(quads[i], np.float32)
        q[0::2] = np.clip(q[0::2], 0, W - 1)
        q[1::2] = np.clip(q[1::2], 0, H - 1)
        cx, cy = quad_center(q)
        w_box = float(q[0::2].max() - q[0::2].min())
        h_box = float(q[1::2].max() - q[1::2].min())
        if w_box < 1 or h_box < 1:
            continue
        radius = max(0, int(gaussian_radius((math.ceil(h_box),
                                             math.ceil(w_box)))))
        draw_gaussian(hm[:, :, 0], (cx, cy), radius)
        ci, cj = int(cx), int(cy)
        hm_ind[i] = cj * W + ci
        hm_mask[i] = 1.0
        # centre-to-corner offsets; decode takes corner = c - wh
        wh[i, 0::2] = ci - q[0::2]
        wh[i, 1::2] = cj - q[1::2]
        reg[i] = (cx - ci, cy - cj)
        logic_t[i] = logic[i]
        gt_dets[i] = q
        if with_corners:
            for j in range(4):
                qx, qy = float(q[2 * j]), float(q[2 * j + 1])
                key = (int(qx), int(qy))
                flat = key[1] * W + key[0]
                slot = cor_slots.get(key)
                if slot is None and len(cor_slots) < 4 * M:
                    slot = len(cor_slots)
                    cor_slots[key] = slot
                    mk_ind[slot] = flat
                    mk_mask[slot] = 1.0
                    corner_reg[slot] = (abs(qx - key[0]), abs(qy - key[1]))
                    corner_reg_ind[slot] = flat
                    corner_reg_mask[slot] = 1.0
                    # the corner channel's gaussian only for a new corner,
                    # radius 2
                    draw_gaussian(hm[:, :, 1], key, 2)
                if slot is None:
                    continue
                cc_match[i, j] = flat
                st[slot, 2 * j:2 * j + 2] = (qx - cx, qy - cy)
                ctr_cro_ind[4 * i + j] = slot * 4 + j
    out = {"hm": hm, "hm_ind": hm_ind, "hm_mask": hm_mask, "wh": wh,
           "reg": reg, "logic": logic_t, "gt_dets": gt_dets}
    if with_corners:
        out.update(mk_ind=mk_ind, mk_mask=mk_mask, st=st,
                   ctr_cro_ind=ctr_cro_ind, cc_match=cc_match,
                   corner_reg=corner_reg, corner_reg_ind=corner_reg_ind,
                   corner_reg_mask=corner_reg_mask)
    return out


def stack_items(items: Sequence[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
    """Collate fixed-size items by stacking each key."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class WtwDataset:
    """COCO-format WTW loader (plain JSON, no pycocotools). Each item: the
    preprocessed image (H, W, 3) and its LORE targets, host numpy.
    ``reader(path)`` decodes an image to uint8 RGB; without one, items
    cannot be read (the port has no decoder)."""

    def __init__(self, image_dir: str, label_path: Optional[str] = None,
                 config: Optional[LoreConfig] = None, split: str = "train",
                 file_filter: Optional[Sequence[str]] = None,
                 reader: Optional[Reader] = None):
        self.image_dir = image_dir
        self.config = config or LoreConfig.wtw()
        self.split = split
        self.reader = reader
        self.pre = LorePreProcessor(self.config)
        self.items: List[Dict[str, Any]] = []
        if label_path:
            self._load_coco(label_path, file_filter)
        else:
            for fn in sorted(os.listdir(image_dir)):
                if fn.lower().endswith((".jpg", ".png", ".jpeg")):
                    self.items.append({"file_name": fn, "annotations": []})

    def _load_coco(self, label_path: str,
                   file_filter: Optional[Sequence[str]]) -> None:
        with open(label_path, encoding="utf-8") as f:
            coco = json.load(f)
        anns_by_img: Dict[int, List[Dict]] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        allow = set(file_filter) if file_filter else None
        for img in coco.get("images", []):
            fn = img["file_name"]
            if allow is not None and fn not in allow:
                continue
            if not os.path.exists(os.path.join(self.image_dir, fn)):
                continue
            self.items.append({"file_name": fn,
                               "annotations": anns_by_img.get(img["id"], [])})

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.reader is None:
            raise ValueError("WtwDataset needs reader(path) -> uint8 RGB: "
                             "the port decodes no image format itself")
        item = self.items[idx]
        img = self.reader(os.path.join(self.image_dir, item["file_name"]))
        pre = self.pre(img)
        meta = pre["meta"]
        fh, fw = meta["out_h"], meta["out_w"]
        # image -> feature map, the preprocess affine (upper-left)
        scale = fw / meta["s"]

        quads, logic = [], []
        for a in item["annotations"]:
            seg = a.get("segmentation")
            if not seg:
                continue
            q = np.asarray(seg[0] if isinstance(seg[0], (list, tuple))
                           else seg, np.float32).reshape(-1)[:8]
            if q.size < 8:
                continue
            quads.append(q * scale)
            la = a.get("logic_axis", a.get("logic", [0, 0, 0, 0]))
            if la and isinstance(la[0], (list, tuple)):  # [[rs, re, cs, ce]]
                la = la[0]
            logic.append(list(la)[:4])
        quads = np.asarray(quads, np.float32).reshape(-1, 8)
        logic = np.asarray(logic, np.float32).reshape(-1, 4)
        targets = make_lore_targets(quads, logic, (fh, fw),
                                    self.config.max_objs)
        targets["image"] = pre["image"][0]
        return targets

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        return stack_items([self[i] for i in indices])
