"""Recognition pre/post processing (counterpart of
pdf_table_tpu/models/rec_ctc/processor.py).

Pre: a fixed set of width buckets; a crop resized to the model's height
pads to the smallest bucket that holds its scaled width. The per-crop path
resizes uint8 crops on the host with OpenCV's fixed-point INTER_LINEAR
(``ops/crop_resize.py::resize_u8_plain``) and OpenCV's 15-bit
``RGB2GRAY`` (``resize_norm_crop``, ``chunked_convnext``); the
normalization runs on the device. Post: the CTC greedy decode runs on the
device, the host maps ids to characters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...ops.crop_resize import resize_u8_plain
from ..line_cell.algo import rgb_to_grey
from .charset import Charset, resolve_charset
from .config import RecConfig


def resize_norm_crop(img: np.ndarray, out_h: int, bucket_w: int,
                     channels: int) -> Tuple[np.ndarray, int]:
    """Resize keeping the aspect to height ``out_h`` (the width capped at
    ``bucket_w``), grey after the resize for a one-channel model, padded
    right with zeros to ``bucket_w``: (out_h, bucket_w, channels) uint8 and
    the valid width."""
    h, w = img.shape[:2]
    scale = out_h / float(h)
    new_w = min(max(int(round(w * scale)), 1), bucket_w)
    resized = resize_u8_plain(img, out_h, new_w)
    if channels == 1:
        if resized.ndim == 3:
            resized = rgb_to_grey(resized)
        resized = resized[:, :, None]
    elif resized.ndim == 2:
        resized = np.repeat(resized[:, :, None], 3, axis=2)
    out = np.zeros((out_h, bucket_w, channels), np.uint8)
    out[:, :new_w] = resized
    return out, new_w


class RecPreProcessor:
    def __init__(self, config: RecConfig):
        self.config = config

    def pick_bucket(self, w: int, h: int) -> int:
        """The smallest width bucket that holds a ``w`` x ``h`` crop scaled
        to the model's height (the largest if none does)."""
        cfg = self.config
        scaled = int(round(w * cfg.img_height / max(h, 1)))
        for b in cfg.width_buckets:
            if scaled <= b:
                return b
        return cfg.width_buckets[-1]

    def chunked_convnext(self, crops: Sequence[np.ndarray]
                         ) -> Dict[str, Any]:
        """ConvNextViT: each crop grey, resized keeping its aspect into a
        32 x 804 zero canvas, cut into three 300 px windows (stride 252)
        stacked as a sub-batch; the decode joins the three chunks' logits
        along time."""
        cfg = self.config
        cw, ov = cfg.chunk_width, cfg.chunk_overlap
        full_w = 3 * cw - 2 * ov
        imgs = []
        for c in crops:
            g = rgb_to_grey(c)
            h, w = g.shape
            tw = min(int(cfg.img_height * (w / float(h))), full_w)
            g = resize_u8_plain(g, cfg.img_height, max(tw, 1))
            canvas = np.zeros((cfg.img_height, full_w), np.uint8)
            canvas[:, :g.shape[1]] = g
            for i in range(3):
                left = (cw - ov) * i
                imgs.append(canvas[:, left:left + cw, None])
        group = {"bucket": cw, "images": np.stack(imgs),
                 "indices": np.arange(len(crops), dtype=np.int64),
                 "widths": np.full(len(crops), full_w, np.int64),
                 "chunked": 3}
        return {"groups": [group], "n": len(crops)}

    def __call__(self, crops: Sequence[np.ndarray]) -> Dict[str, Any]:
        """(H, W, 3) uint8 RGB crops -> {"groups": [{"bucket", "images" (N,
        H, Wb, C) uint8, "indices", "widths"}], "n"}, one group per width
        bucket in bucket order; ``indices`` map rows back to crops."""
        cfg = self.config
        if cfg.backbone == "convnext_vit" and len(crops):
            return self.chunked_convnext(crops)
        groups: Dict[int, List[int]] = {}
        for i, c in enumerate(crops):
            groups.setdefault(self.pick_bucket(c.shape[1], c.shape[0]),
                              []).append(i)
        out = []
        for b, idxs in sorted(groups.items()):
            imgs, widths = [], []
            for i in idxs:
                img, vw = resize_norm_crop(crops[i], cfg.img_height, b,
                                           cfg.img_channels)
                imgs.append(img)
                widths.append(vw)
            out.append({"bucket": b, "images": np.stack(imgs),
                        "indices": np.array(idxs, np.int64),
                        "widths": np.array(widths, np.int64)})
        return {"groups": out, "n": len(crops)}


class RecPostProcessor:
    def __init__(self, config: RecConfig, charset: Optional[Charset] = None):
        self.config = config
        self.charset = charset or resolve_charset(config.charset_name,
                                                  config.use_space_char)

    def __call__(self, decoded, indices, texts: List[str],
                 scores: List[float]) -> None:
        """Map one group's decode ``(ids, keep, conf)`` to text and write
        it into the (pre-sized) output lists at ``indices``."""
        ids, keep, conf = (np.asarray(a) for a in decoded)
        for row, gi in enumerate(np.asarray(indices)):
            texts[gi] = self.charset.decode_ids(ids[row][keep[row]].tolist())
            scores[gi] = float(conf[row])
