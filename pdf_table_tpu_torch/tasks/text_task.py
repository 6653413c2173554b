"""The standalone text task: detection and recognition (and the 0/180
line orientation), no tables (counterpart of
pdf_table_tpu/tasks/text_task.py).

A digital page's text comes from its vector text (``tasks/pdf_text.py``);
an image (an array or a file, read without OpenCV) is deskewed where
asked, detected (``OcrDetectionTask.__call__``: the host contours), cut
into natural-size crops, turned where the 0/180 classifier reads them as
upside down, and recognized in width-bucketed sub-batches; each stage's
seconds go into the metric dict. ``show_ocr_result`` is a pandas
DataFrame of the cells (pandas is imported there only). The models run on
``device`` (``cuda`` unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..entity.ocr_cell import OcrCell


class OcrTextTask:
    """The detector and recognizer choice, lang, line orientation, deskew
    and debug output of the JAX task."""

    def __init__(self, detect_model: str = "PP-OCRv4_det",
                 recognizer_model: str = "PP-OCRv4_rec",
                 lang: str = "en",
                 use_orientation: bool = False,
                 deskew: bool = False,
                 debug: bool = False,
                 output_dir: Optional[str] = None,
                 device=None, mesh=None, **kw):
        from ..engine.device import resolve_device
        from .detection import OcrDetectionTask
        from .recognition import OcrRecognitionTask

        self.device = resolve_device(device)
        rec_kw = {} if lang in ("en", "") else {"lang": lang}
        self.det = OcrDetectionTask(model=detect_model, device=self.device,
                                    mesh=mesh)
        self.rec = OcrRecognitionTask(model=recognizer_model,
                                      device=self.device, mesh=mesh,
                                      **rec_kw)
        self.use_orientation = use_orientation
        self.deskew = deskew
        self.debug = debug
        self.output_dir = output_dir
        self._line_cls = None
        self._pdf_text = None

    def set_output_dir(self, output_dir: str) -> None:
        self.output_dir = output_dir

    @property
    def line_cls(self):
        if self._line_cls is None and self.use_orientation:
            from .cls_pulc import ClsImagePulcTask
            self._line_cls = ClsImagePulcTask(
                task_type="textline_orientation", device=self.device,
                scale=0.25)
        return self._line_cls

    @property
    def pdf_text_task(self):
        if self._pdf_text is None:
            from .pdf_text import OcrPdfTextTask
            self._pdf_text = OcrPdfTextTask()
        return self._pdf_text

    # -- stages ---------------------------------------------------------------

    def pre_process_image(self, image: np.ndarray) -> np.ndarray:
        """The small-angle deskew, where asked."""
        if not self.deskew:
            return image
        from .preprocess import estimate_skew_angle, rotate_image

        angle = estimate_skew_angle(image)
        if abs(angle) > 0.2:
            image = rotate_image(image, angle)
        return image

    def text_detection(self, image: np.ndarray) -> Dict[str, Any]:
        return self.det(image)

    def text_recognition(self, image: np.ndarray,
                         quads: np.ndarray) -> Dict[str, Any]:
        from ..ops.warp import crop_rotated_boxes

        crops = [np.asarray(c) for c in crop_rotated_boxes(image, quads)]
        if self.use_orientation and self.line_cls is not None and crops:
            fixed = []
            for c, r in zip(crops, self.line_cls.batch_infer(crops)):
                if r.get("label") == "180_degree" \
                        and r.get("score", 0) > 0.75:
                    c = np.ascontiguousarray(c[::-1, ::-1])
                fixed.append(c)
            crops = fixed
        return self.rec(crops)

    def pdf_text_extract(self, pdf_page, scale: float = 1.0
                         ) -> List[OcrCell]:
        return self.pdf_text_task(pdf_page, scale=scale)

    def show_ocr_result(self, cells: List[OcrCell]):
        """A DataFrame of index, text and box."""
        import pandas as pd

        rows = [[i, c.text,
                 ",".join(str(v) for v in np.asarray(
                     c.poly if c.poly is not None else c.bbox).reshape(-1))]
                for i, c in enumerate(cells)]
        return pd.DataFrame(rows, columns=["index", "text", "bbox"])

    # -- entry ----------------------------------------------------------------

    def __call__(self, inputs: Union[np.ndarray, str], pdf_page=None,
                 page: int = 0, **kw) -> Dict[str, Any]:
        """``inputs``: an image array, an image file path, or (with
        ``pdf_page``) a digital page whose text comes from vector data.
        Returns the cells, texts, detection output and metric dict."""
        t0 = time.time()
        metric: Dict[str, Any] = {"page": page}

        if pdf_page is not None and getattr(pdf_page, "texts", None):
            t = time.time()
            cells = self.pdf_text_extract(pdf_page, scale=kw.get(
                "scale", 1.0))
            metric["pdf_text"] = time.time() - t
            metric["use_time"] = time.time() - t0
            return {"cells": cells, "texts": [c.text for c in cells],
                    "det": None, "metric": metric}

        image = inputs
        if isinstance(inputs, str):
            from ..utils.image_io import read_image

            image = read_image(inputs)
            if image is None:
                raise FileNotFoundError(inputs)

        t = time.time()
        image = self.pre_process_image(image)
        metric["preprocess"] = time.time() - t

        t = time.time()
        det_out = self.text_detection(image)
        metric["detection"] = time.time() - t
        quads = det_out["det_polygons"].reshape(-1, 4, 2)
        if not len(quads):
            metric["use_time"] = time.time() - t0
            return {"cells": [], "texts": [], "det": det_out,
                    "metric": metric}

        t = time.time()
        rec_out = self.text_recognition(image, quads)
        metric["recognition"] = time.time() - t

        cells = [OcrCell.from_poly(q, text=tx, score=s)
                 for q, tx, s in zip(quads, rec_out["texts"],
                                     rec_out["scores"])]
        metric["n_boxes"] = len(cells)
        metric["use_time"] = time.time() - t0
        result = {"cells": cells, "texts": rec_out["texts"],
                  "det": det_out, "metric": metric}
        if self.debug and self.output_dir:
            import json
            import os
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir,
                                   f"text_task_{page}.json"), "w",
                      encoding="utf-8") as f:
                json.dump({"texts": rec_out["texts"],
                           "metric": metric}, f, ensure_ascii=False,
                          default=str)
        return result
