"""The standalone table task: table structure on a table image, its HTML
with the text of the image, xlsx export and TEDS (counterpart of
pdf_table_tpu/tasks/table_task.py). The models run on ``device``
(``cuda`` unless ``"cpu"`` is asked for)."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


class OcrTableTask:
    def __init__(self, table_structure_model: str = "Lore",
                 task_type: str = "wtw", ocr_task=None, device=None,
                 mesh=None, **kw):
        from ..engine.device import resolve_device
        from .table_structure import OcrTableStructureTask

        self.device = resolve_device(device)
        self.tsr = OcrTableStructureTask(model=table_structure_model,
                                         task_type=task_type,
                                         device=self.device, mesh=mesh,
                                         **kw)
        self._ocr = ocr_task

    @property
    def ocr(self):
        if self._ocr is None:
            from .text_task import OcrTextTask
            self._ocr = OcrTextTask(device=self.device)
        return self._ocr

    def __call__(self, image: np.ndarray,
                 run_ocr: bool = True) -> Dict[str, Any]:
        from .table_to_html import OcrTableToHtmlTask

        tsr_result = self.tsr(image)
        tsr_result.setdefault("offset", (0, 0))
        text_cells = self.ocr(image)["cells"] if run_ocr else []
        html = OcrTableToHtmlTask()(tsr_result, text_cells)
        return {"tsr": tsr_result, "html": html, "text_cells": text_cells}

    @staticmethod
    def to_excel(html: str, path: str) -> str:
        from ..utils.xlsx_writer import html_table_to_xlsx

        html_table_to_xlsx(html, path)
        return path

    @staticmethod
    def eval_table(pred_htmls: Sequence[str], gt_htmls: Sequence[str],
                   structure_only: bool = False,
                   n_jobs: int = 1) -> Dict[str, Any]:
        from ..eval.teds import TEDS

        teds = TEDS(structure_only=structure_only, n_jobs=n_jobs)
        scores = teds.batch_evaluate(list(pred_htmls), list(gt_htmls))
        return {"teds": float(np.mean(scores)) if scores else 0.0,
                "scores": scores}
