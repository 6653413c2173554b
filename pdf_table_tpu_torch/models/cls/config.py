"""PULC image-classifier configs (copy of
pdf_table_tpu/models/cls/config.py): text_image_orientation
(0/90/180/270), textline_orientation (0/180), language_classification,
table_attribute; the port runs every one (tasks/cls_pulc.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

PULC_LABELS: Dict[str, List[str]] = {
    "text_image_orientation": ["0", "90", "180", "270"],
    "textline_orientation": ["0_degree", "180_degree"],
    "language_classification": ["arabic", "chinese_cht", "cyrillic",
                                "devanagari", "japan", "ka", "korean",
                                "latin", "ta", "te"],
    "table_attribute": ["source_photo", "source_scan", "source_digital",
                        "style_wired", "style_wireless", "cell_normal",
                        "cell_merged", "layout_horizontal",
                        "layout_vertical"],
}


@dataclass
class ClsPulcConfig:
    task_type: str = "text_image_orientation"
    scale: float = 1.0
    class_expand: int = 1280
    use_last_conv: bool = True
    # text_image_orientation resizes to 256 then center-crops 224;
    # textline_orientation uses 3x48x192
    img_size: Tuple[int, int] = (224, 224)
    resize_short: int = 256
    topk: int = 2
    multilabel: bool = False
    dtype: str = "float32"

    @property
    def labels(self) -> List[str]:
        return PULC_LABELS.get(self.task_type,
                               PULC_LABELS["text_image_orientation"])

    @property
    def class_num(self) -> int:
        return len(self.labels)

    @classmethod
    def for_task(cls, task_type: str, **kw) -> "ClsPulcConfig":
        base: Dict = {"task_type": task_type}
        if task_type == "textline_orientation":
            base.update(img_size=(48, 192), resize_short=0, scale=0.25,
                        topk=1)
        elif task_type == "table_attribute":
            base.update(img_size=(224, 224), resize_short=0, multilabel=True)
        base.update(kw)
        return cls(**base)
