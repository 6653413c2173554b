"""PULC pre- and post-processing (counterpart of
pdf_table_tpu/models/cls/processor.py), without cv2: resize-short plus a
centre crop, or a direct resize, of the f32 image with OpenCV's bilinear
arithmetic (``ops/crop_resize.py::resize_linear_f32``), then the imagenet
normalization; post: top-k labels, or the labels over a threshold for a
multilabel task."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ...ops.crop_resize import resize_linear_f32
from .config import ClsPulcConfig

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


class PulcPreProcessor:
    def __init__(self, config: ClsPulcConfig):
        self.config = config

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """(H, W, 3) uint8 RGB -> {"image": (1, th, tw, 3) f32}."""
        cfg = self.config
        img = image.astype(np.float32)
        th, tw = cfg.img_size
        if cfg.resize_short:
            h, w = img.shape[:2]
            scale = cfg.resize_short / min(h, w)
            img = resize_linear_f32(img, max(int(round(h * scale)), th),
                                    max(int(round(w * scale)), tw))
            h, w = img.shape[:2]
            y0 = (h - th) // 2
            x0 = (w - tw) // 2
            img = img[y0:y0 + th, x0:x0 + tw]
        else:
            img = resize_linear_f32(img, th, tw)
        img = (img / 255.0 - MEAN) / STD
        return {"image": img[None].astype(np.float32)}


class PulcPostProcessor:
    def __init__(self, config: ClsPulcConfig, threshold: float = 0.5):
        self.config = config
        self.threshold = threshold

    def __call__(self, probs: np.ndarray) -> Dict[str, Any]:
        cfg = self.config
        probs = np.asarray(probs).reshape(-1)
        if cfg.multilabel:
            idx = np.where(probs >= self.threshold)[0]
            return {"labels": [cfg.labels[i] for i in idx],
                    "scores": probs[idx].tolist()}
        order = np.argsort(-probs)[:cfg.topk]
        return {"labels": [cfg.labels[i] for i in order],
                "scores": probs[order].tolist(),
                "label": cfg.labels[order[0]],
                "score": float(probs[order[0]])}
