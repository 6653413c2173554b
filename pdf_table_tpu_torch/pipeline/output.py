"""Typed accumulator of one page's results (counterpart of
pdf_table_tpu/pipeline/output.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..entity.ocr_cell import OcrCell


@dataclass
class OcrSystemModelOutput:
    src_id: str = ""
    page: int = 0
    is_pdf: bool = False
    image: Optional[np.ndarray] = None          # working raster (RGB uint8)
    image_shape: tuple = ()                     # (h, w)
    pdf_page: Any = None                        # the PDF page of a digital page
    pdf_scale: float = 1.0                      # image px per PDF unit
    rotate_angle: float = 0.0

    layout_cells: List[OcrCell] = field(default_factory=list)
    table_cells: List[OcrCell] = field(default_factory=list)
    table_structures: List[Dict[str, Any]] = field(default_factory=list)
    text_cells: List[OcrCell] = field(default_factory=list)
    table_html: List[str] = field(default_factory=list)
    page_html: str = ""
    metric: Dict[str, float] = field(default_factory=dict)
    debug: Dict[str, Any] = field(default_factory=dict)

    def to_metric_dict(self) -> Dict[str, Any]:
        d = dict(self.metric)
        d.update(page=self.page, src_id=self.src_id,
                 n_text=len(self.text_cells), n_tables=len(self.table_html))
        return d
