"""SLANet pre/post processing (counterpart of
pdf_table_tpu/models/slanet/processor.py).

Pre: resize the longest side to ``table_max_len`` (uint8, as
``cv2.resize`` returns it: ops/crop_resize.py), imagenet normalize, then
pad to the square with 0. :meth:`SLANetPreProcessor.plan` gives a crop's
size and shape list, :meth:`SLANetPreProcessor.normalize` the device half
for crops cut by ``crop_resize_u8``; ``__call__`` does one image in numpy.

Post: greedy tokens up to eos (not at step 0), sos and eos left out, each
td's 4-point box scaled by (w, h) and turned to xyxy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.crop_resize import resize_u8_plain
from .config import SLANetConfig
from .vocab import StructureVocab

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_u8(u8: torch.Tensor) -> torch.Tensor:
    """``(x / 255 - MEAN) / STD`` in f32 with a true division on every
    device, as numpy computes it: CUDA divides by a Python scalar as a
    product with its reciprocal (an ulp off), not by a tensor."""
    dev = u8.device
    x = u8.float() / torch.full((), 255.0, device=dev)
    return (x - torch.from_numpy(MEAN).to(dev)) / torch.from_numpy(STD).to(dev)


class SLANetPreProcessor:
    def __init__(self, config: SLANetConfig):
        self.config = config

    def plan(self, h: int, w: int) -> Tuple[int, int, tuple]:
        """(nh, nw, shape_list) of an h x w crop."""
        L = self.config.table_max_len
        ratio = L / max(h, w)
        nh, nw = int(round(h * ratio)), int(round(w * ratio))
        return nh, nw, (h, w, ratio, ratio, L - nh, L - nw)

    @staticmethod
    def normalize(u8: torch.Tensor, sizes: Sequence[Tuple[int, int]]
                  ) -> torch.Tensor:
        """(N, L, L, 3) uint8 resized crops -> f32 normalized, 0 beyond
        each crop's (nh, nw)."""
        dev = u8.device
        x = normalize_u8(u8)
        hw = torch.as_tensor(sizes, device=dev).view(-1, 2, 1)
        L = u8.shape[1]
        r = torch.arange(L, device=dev)
        keep = (r[None, :, None] < hw[:, 0, :, None]) \
            & (r[None, None, :] < hw[:, 1, :, None])
        return torch.where(keep[..., None], x, 0.0)

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        L = self.config.table_max_len
        h, w = image.shape[:2]
        nh, nw, shape_list = self.plan(h, w)
        resized = resize_u8_plain(image, nh, nw).astype(np.float32)
        norm = (resized / 255.0 - MEAN) / STD
        padded = np.zeros((L, L, 3), np.float32)
        padded[:nh, :nw] = norm
        return {"image": padded[None], "shape_list": shape_list}


class SLANetPostProcessor:
    def __init__(self, config: SLANetConfig,
                 vocab: Optional[StructureVocab] = None):
        self.config = config
        if vocab is None and config.dict_path:
            vocab = StructureVocab.from_dict_file(
                config.dict_path, config.merge_no_span_structure)
        self.vocab = vocab or StructureVocab()

    def __call__(self, raw: Dict[str, Any],
                 shape_list: Tuple) -> Dict[str, Any]:
        probs = np.asarray(raw["structure_probs"][0])     # (T, V)
        locs = np.asarray(raw["loc_preds"][0])            # (T, loc_reg)
        h, w = shape_list[0], shape_list[1]
        ids = probs.argmax(axis=1)
        confs = probs.max(axis=1)

        tokens: List[str] = []
        boxes: List[List[float]] = []
        scores: List[float] = []
        for t, tid in enumerate(ids):
            if t > 0 and tid == self.vocab.eos_id:
                break
            if tid in (self.vocab.sos_id, self.vocab.eos_id):
                continue
            tok = self.vocab.tokens[tid]
            if self.vocab.is_td(tok):
                b = locs[t].copy()
                b[0::2] *= w
                b[1::2] *= h
                boxes.append(b.tolist())
            tokens.append(tok)
            scores.append(float(confs[t]))
        cells = []
        for b in boxes:
            if len(b) >= 8:
                xs, ys = b[0::2], b[1::2]
                bbox = [min(xs), min(ys), max(xs), max(ys)]
            else:
                bbox = b[:4]
            cells.append({"bbox": bbox, "poly": b})
        return {"structure_tokens": tokens,
                "cells": cells,
                "score": float(np.mean(scores)) if scores else 0.0,
                "type": "slanet"}
