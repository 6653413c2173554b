"""DocXLayout config (a copy of pdf_table_tpu/models/docx_layout/config.py):
heads {cls:4, ftype:3, hm:11, hm_sub:2, reg:2, wh:8}, the 13-entry label
map, the DLA-34 trunk, input 768."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

LABEL2ID: Dict[str, int] = {
    "title": 0, "figure": 1, "text": 2, "header": 3, "page_number": 4,
    "footnote": 5, "footer": 6, "table": 7, "table_caption": 8,
    "figure_caption": 9, "equation": 10, "full_column": 11, "sub_column": 12,
}


@dataclass
class DocXLayoutConfig:
    resolution: Tuple[int, int] = (768, 768)
    down_ratio: int = 4
    num_classes: int = 11
    heads: Tuple[Tuple[str, int], ...] = (
        ("cls", 4), ("ftype", 3), ("hm", 11), ("hm_sub", 2), ("reg", 2),
        ("wh", 8))
    head_conv: int = 256
    top_k: int = 100
    scores_thresh: float = 0.3
    dtype: str = "float32"

    @property
    def label2id(self) -> Dict[str, int]:
        return LABEL2ID

    @property
    def id2label(self) -> Dict[int, str]:
        return {v: k for k, v in LABEL2ID.items()}
