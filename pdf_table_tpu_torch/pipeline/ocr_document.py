"""The legacy detection + recognition orchestrator (counterpart of
pdf_table_tpu/pipeline/ocr_document.py): one image in, (det boxes, ocr
records, metrics) out. Reading-order-sorted (N, 8) polygons (mean y, then
0.01 of mean x), records of {index, text, bbox}, per-stage ``use_time``,
a DataFrame view (``show_ocr_result``; pandas imported there only) and
the saved overlay PNG, tsv and json. The compute is ``OcrTextTask``'s on
``device`` (``cuda`` unless ``"cpu"`` is asked for); images are read and
written without OpenCV (``utils/image_io.py``)."""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np


class OcrDocument:
    def __init__(self, detect_model: str = "PP-OCRv4_det",
                 recognizer_model: str = "PP-OCRv4_rec",
                 output_dir: Optional[str] = None, debug: bool = False,
                 **kw):
        from ..tasks.text_task import OcrTextTask

        self.output_dir = output_dir
        self.debug = debug
        self.task = OcrTextTask(detect_model=detect_model,
                                recognizer_model=recognizer_model, **kw)

    @staticmethod
    def _read_image(inputs: Union[str, np.ndarray]) -> np.ndarray:
        if isinstance(inputs, np.ndarray):
            return inputs
        from ..utils.image_io import read_image

        image = read_image(str(inputs))
        if image is None:
            raise FileNotFoundError(str(inputs))
        return image

    def __call__(self, inputs: Union[str, np.ndarray],
                 save_result: bool = True
                 ) -> Tuple[np.ndarray, List[Dict[str, Any]],
                            Dict[str, Any]]:
        """(det_result, ocr_result, metric) — the reference's return
        triple (modeling_ocr_pdf.py:313-360)."""
        image = self._read_image(inputs)
        t0 = time.time()
        out = self.task(image)
        use_time = time.time() - t0

        cells = [c for c in out["cells"] if c.poly is not None]
        # reading-order sort: mean y dominates, mean x tie-breaks
        def order_key(c):
            p = np.asarray(c.poly, np.float32).reshape(-1, 2)
            return float(p[:, 1].mean() + 0.01 * p[:, 0].mean())

        cells.sort(key=order_key)
        det_result = np.asarray(
            [np.asarray(c.poly, np.float32).reshape(-1) for c in cells],
            np.float32).reshape(-1, 8)
        ocr_result = [{"index": i + 1, "text": c.text or "",
                       "bbox": np.asarray(c.poly, np.float32).reshape(4, 2)}
                      for i, c in enumerate(cells)]
        tm = out.get("metric", {})
        metric = {
            "detection": {"use_time": tm.get("detection", use_time)},
            "recognition": {"use_time": tm.get("recognition", 0.0),
                            "total": len(cells)},
            "use_time": use_time,
        }
        if self.output_dir is not None and save_result:
            self._save_debug(inputs, image, det_result, ocr_result, metric)
        return det_result, ocr_result, metric

    def show_ocr_result(self, ocr_result: List[Dict[str, Any]]):
        """DataFrame view (reference show_ocr_result:304)."""
        import pandas as pd

        rows = [[r["index"], r["text"],
                 ",".join(str(v) for v in
                          np.asarray(r["bbox"]).reshape(-1).tolist())]
                for r in ocr_result]
        return pd.DataFrame(rows, columns=["box_index", "text", "bbox"])

    def _save_debug(self, inputs, image, det_result, ocr_result, metric):
        """Overlay PNG + tsv + json next to output_dir (reference
        __call__:324-358)."""
        import json

        from ..entity.ocr_cell import OcrCell
        from ..utils.debug_render import render_debug_overlay
        from ..utils.image_io import write_png

        os.makedirs(self.output_dir, exist_ok=True)
        name = (os.path.splitext(os.path.basename(str(inputs)))[0]
                if isinstance(inputs, str) else "image")
        base = os.path.join(self.output_dir, f"ocr_{name}")
        overlay = render_debug_overlay(
            image, text_cells=[OcrCell.from_poly(p, text=r["text"])
                               for p, r in zip(
                                   det_result.reshape(-1, 4, 2),
                                   ocr_result)])
        write_png(base + ".png", overlay)
        self.show_ocr_result(ocr_result).to_csv(
            base + ".txt", header=True, index=False, sep="\t")
        payload = dict(metric)
        payload["result"] = [
            {"index": r["index"], "text": r["text"],
             "bbox": np.asarray(r["bbox"]).reshape(-1).tolist()}
            for r in ocr_result]
        with open(base + ".json", "w") as f:
            json.dump(payload, f, ensure_ascii=False, indent=1)
