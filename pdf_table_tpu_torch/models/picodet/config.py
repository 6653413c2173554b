"""PicoDet layout-analysis config (copy of
pdf_table_tpu/models/picodet/config.py): input 800x608, strides 8/16/32/64,
label sets per task_type (ch = CDLA-10, en = publaynet-5, table = 1)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

LABEL_CONFIG: Dict[str, Dict[str, int]] = {
    "ch": {"text": 0, "title": 1, "figure": 2, "figure_caption": 3,
           "table": 4, "table_caption": 5, "header": 6, "footer": 7,
           "reference": 8, "equation": 9},
    "en": {"text": 0, "title": 1, "list": 2, "table": 3, "figure": 4},
    "table": {"table": 0},
}


@dataclass
class PicoDetConfig:
    task_type: str = "en"
    img_height: int = 800
    img_width: int = 608
    strides: Tuple[int, ...] = (8, 16, 32, 64)
    reg_max: int = 7
    # picodet_lcnet_x1_0 layout family: LCNet 1.0, CSP-PAN 128, 4 shared
    # head convs per level
    lcnet_scale: float = 1.0
    neck_channels: int = 128
    head_convs: int = 4
    score_threshold: float = 0.5
    nms_threshold: float = 0.5
    nms_top_k: int = 1000
    keep_top_k: int = 100
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    dtype: str = "float32"

    @property
    def label2id(self) -> Dict[str, int]:
        return LABEL_CONFIG.get(self.task_type, LABEL_CONFIG["ch"])

    @property
    def id2label(self) -> Dict[int, str]:
        return {v: k for k, v in self.label2id.items()}

    @property
    def num_classes(self) -> int:
        return len(self.label2id)
