"""TableMaster pre/post processing (counterpart of
pdf_table_tpu/models/table_master/processor.py).

Pre: keep-ratio resize to fit ``img_size`` (uint8, as ``cv2.resize``
returns it: ops/crop_resize.py), pad bottom/right with 0, then normalize
the whole canvas — not SLANet's order: the pad becomes -mean/std.
:meth:`TableMasterPreProcessor.plan` gives a crop's size and shape list
(h, w, nh/h, nw/w, th, tw), :meth:`TableMasterPreProcessor.normalize` the
device half for crops cut by ``crop_resize_u8``; ``__call__`` does one
image in numpy.

Post: master-convention token decode up to eos, each td's xywh
denormalized against the padded canvas and mapped back through the resize
ratio to crop xyxy (integer-halved extents); ``"type": "master"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops.crop_resize import resize_u8_plain
from ..slanet.processor import MEAN, STD, normalize_u8
from .config import TableMasterConfig
from .vocab import MasterStructureVocab


class TableMasterPreProcessor:
    def __init__(self, config: TableMasterConfig):
        self.config = config

    def plan(self, h: int, w: int) -> Tuple[int, int, tuple]:
        """(nh, nw, shape_list) of an h x w crop."""
        th, tw = self.config.img_size
        ratio = min(th / h, tw / w)
        nh, nw = max(1, int(round(h * ratio))), max(1, int(round(w * ratio)))
        return nh, nw, (h, w, nh / h, nw / w, th, tw)

    @staticmethod
    def normalize(u8: torch.Tensor) -> torch.Tensor:
        """(N, th, tw, 3) uint8 canvases (0 beyond each crop) -> f32
        normalized, the pad included."""
        return normalize_u8(u8)

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        h, w = image.shape[:2]
        th, tw = self.config.img_size
        nh, nw, shape_list = self.plan(h, w)
        canvas = np.zeros((th, tw, 3), np.float32)
        canvas[:nh, :nw] = resize_u8_plain(image, nh, nw)
        norm = (canvas / 255.0 - MEAN) / STD
        return {"image": norm[None].astype(np.float32),
                "meta": {"shape_list": shape_list}}


class TableMasterPostProcessor:
    def __init__(self, config: TableMasterConfig,
                 vocab: Optional[MasterStructureVocab] = None,
                 cell_charset: Optional[List[str]] = None):
        self.config = config
        if vocab is None:
            if config.dict_path:
                with open(config.dict_path, encoding="utf-8") as f:
                    toks = [ln.rstrip("\r\n") for ln in f if ln.strip()]
                vocab = MasterStructureVocab(toks)
            else:
                vocab = MasterStructureVocab()
        self.vocab = vocab
        self.cell_charset = cell_charset  # MtlTabNet textline alphabet

    def __call__(self, raw: Dict[str, Any], meta: Dict[str, Any]
                 ) -> Dict[str, Any]:
        probs = np.asarray(raw["structure_probs"][0])
        locs = np.asarray(raw["loc_preds"][0])
        shape = meta["shape_list"]
        ratio_h, ratio_w = shape[2], shape[3]
        pad_h, pad_w = (shape[4], shape[5]) if len(shape) > 5 and shape[4] \
            else self.config.img_size
        ids = probs.argmax(axis=1)
        confs = probs.max(axis=1)
        v = self.vocab
        ignored = getattr(v, "ignored_ids", {v.sos_id, v.eos_id})
        tokens: List[str] = []
        cells: List[Dict[str, Any]] = []
        scores: List[float] = []
        for t, tid in enumerate(ids):
            if t > 0 and tid == v.eos_id:
                break
            if tid in ignored:
                continue
            tok = v.tokens[tid]
            if v.is_td(tok):
                # normalized xywh on the padded canvas -> xyxy crop coords
                b = locs[t].copy()
                b[0::2] *= pad_w
                b[1::2] *= pad_h
                b[0::2] /= max(ratio_w, 1e-9)
                b[1::2] /= max(ratio_h, 1e-9)
                x, y, bw, bh = b[:4]
                cells.append({"bbox": [float(x - bw // 2), float(y - bh // 2),
                                       float(x + bw // 2),
                                       float(y + bh // 2)]})
            tokens.append(tok)
            scores.append(float(confs[t]))
        result = {"structure_tokens": tokens, "cells": cells,
                  "score": float(np.mean(scores)) if scores else 0.0,
                  "type": "master"}
        # MtlTabNet cell-content branch output (decode_cells=True): greedy
        # ids per td slot -> text
        if "cell_ids" in raw:
            eos_c = int(raw.get("cell_eos_id", 0))
            cids = np.asarray(raw["cell_ids"][0])
            cvalid = np.asarray(raw["cell_valid"][0])
            texts: List[str] = []
            for k in range(len(cids)):
                if not cvalid[k]:
                    break
                chars = []
                for cid in cids[k]:
                    if cid == eos_c:
                        break
                    if self.cell_charset and cid < len(self.cell_charset):
                        chars.append(self.cell_charset[cid])
                texts.append("".join(chars))
            result["cell_texts"] = texts
            for cell, text in zip(result["cells"], texts):
                cell["text"] = text
        return result
