"""Recognition pre/post processing (counterpart of
pdf_table_tpu/models/rec_ctc/processor.py).

Pre: a fixed set of width buckets; a crop resized to the model's height
pads to the smallest bucket that holds its scaled width. Post: the CTC
greedy decode runs on the device, the host maps ids to characters. The
cv2 crop path (``resize_norm_crop``, ``chunked_convnext``) is not ported.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .charset import Charset, resolve_charset
from .config import RecConfig


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
