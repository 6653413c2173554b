"""Cycle-CenterNet (wired-table cell detection) config (a copy of
pdf_table_tpu/models/center_net/config.py).

Reference: model/center_net/ — DLA-34 with heads {hm:2, v2c:8, c2v:8, reg:2}
(modeling_centernet.py:619), K=1000/MK=4000 decode (table_process.py
OCRTableCenterNetPostProcessor), vertex-center cyclic pairing grouping
(group_bbox_by_gbox:278)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class CenterNetConfig:
    resolution: Tuple[int, int] = (1024, 1024)
    down_ratio: int = 4
    heads: Tuple[Tuple[str, int], ...] = (
        ("hm", 2), ("v2c", 8), ("c2v", 8), ("reg", 2))
    head_conv: int = 256
    K: int = 300            # cell slots (reference 1000; static here)
    MK: int = 600           # vertex slots (reference 4000)
    score_thresh: float = 0.3
    v2c_dist_thresh: float = 2.0
    c2v_dist_thresh: float = 0.5
    dtype: str = "float32"
