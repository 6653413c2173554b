"""The per-page system (counterpart of pdf_table_tpu/pipeline/system.py):
``OcrSystemConfig``, ``widen_table_regions``, ``filter_figure_tables`` and
``OcrSystemTask``, its lazy tasks and its serial per-page ``__call__``.

A page runs: rendering (a digital page without an image), the turn of a
digital page authored rotated by 90 degrees, the pre-process task (deskew
and page orientation of an image), the per-box 0/180 majority vote, layout,
table structure (a digital page's vector-line cells, else all table crops
of the page through the TSR task's ``batch_infer``), text (the PDF's
vector text, else detection and recognition of the page's quads), table
HTML and page HTML, with the seconds of each stage in ``metric`` under the
JAX package's keys; with ``debug``, the annotated overlay
(``utils/debug_render.py``) in ``debug["render"]`` and the metrics logged.
Every task is built on the system's ``device``
(``cuda`` unless ``"cpu"`` is asked for); with a ``mesh``
(parallel/mesh.py) the model tasks replicate the mesh's first rank's
weights as they are built.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..entity.enums import HtmlContentType
from ..entity.ocr_cell import OcrCell
from ..ops.warp import crop_rotated_boxes
from ..utils.logging_utils import logger
from .output import OcrSystemModelOutput


@dataclass
class OcrSystemConfig:
    """Routing flags."""

    # PP-OCRv4_det | db_resnet18 | db_resnet50 | db_proxylessnas
    detect_model: str = "PP-OCRv4_det"
    # PP-OCRv4_rec | CRNN | ConvNextViT | LightweightEdge
    recognizer_model: str = "PP-OCRv4_rec"
    layout_model: str = "picodet"           # picodet | DocXLayout | none
    # Lore | LoreAndLineCell | CenterNet | Lgpma | LineCell | LineCellPdf |
    # SLANet | TableMaster | MtlTabNet, and the TSR task's keyword arguments (its
    # config fields, batch_size, variables)
    table_structure_model: str = "Lore"
    table_structure_kwargs: Dict[str, Any] = field(default_factory=dict)
    lang: str = "en"
    task_type: str = "general"
    use_layout: bool = True
    use_table: bool = True
    pdf_text_prefer: bool = True            # digital PDFs: extract text
    use_orientation_cls: bool = True        # PULC 0/90/180/270 page fix
    use_textline_cls: bool = True           # per-box 0/180 check
    render_dpi: int = 144
    debug: bool = False
    output_dir: str = ""


def widen_table_regions(layout_cells, table_bboxes, image_width: int,
                        diff: int = 5):
    """Widen tight layout table boxes to the page's text-column extents
    (min/max x of confident text blocks), + ``diff`` padding."""
    xs_min, xs_max = [], []
    for c in layout_cells:
        if c.cell_type == HtmlContentType.TXT and c.score >= 0.7:
            xs_min.append(min(c.x1, c.x2))
            xs_max.append(max(c.x1, c.x2))
    min_x = min(xs_min) if xs_min else diff
    max_x = max(xs_max) if xs_max else image_width - diff
    out = []
    for x1, y1, x2, y2 in table_bboxes:
        out.append((min(x1, min_x) - diff, y1 - diff,
                    max(x2, max_x) + diff, y2 + diff))
    return out


def filter_figure_tables(layout_cells, table_bboxes,
                         score_threshold: float = 0.8):
    """Drop table regions that sit inside a confident 'figure' layout
    detection (pictures misdetected as tables)."""
    figures = [c for c in layout_cells
               if getattr(c, "label", "") == "figure"
               and c.score >= score_threshold]
    if not figures:
        return list(table_bboxes)

    def inside(tb, fb, diff=2.0):
        return (fb[0] - diff <= tb[0] and fb[1] - diff <= tb[1]
                and tb[2] <= fb[2] + diff and tb[3] <= fb[3] + diff)

    return [tb for tb in table_bboxes
            if not any(inside(tb, f.bbox) for f in figures)]


class OcrSystemTask:
    """The per-page engine and the tasks of the page pipeline, built on
    first use on ``device``. ``_det``, ``_rec``, ``_layout``, ``_tsr``,
    ``_line_cls`` and ``_preprocess`` may be assigned directly (bench.py
    builds its tasks that way). Call it with a raster image (HWC uint8
    RGB) and/or a pdfio ``PdfPage``; it returns an
    ``OcrSystemModelOutput``."""

    def __init__(self, config: Optional[OcrSystemConfig] = None,
                 mesh=None, device=None):
        from ..engine.device import resolve_device

        self.config = config or OcrSystemConfig()
        self.mesh = mesh
        self.device = resolve_device(device)
        self._det = None
        self._rec = None
        self._layout = None
        self._tsr = None
        self._line_cls = None
        self._preprocess = None
        self._pdf_text = None
        self._table_html = None
        self._to_html = None
        # the model tasks are built on first use, once, also where several
        # threads reach them first together
        self._build_lock = threading.RLock()

    @property
    def det_task(self):
        with self._build_lock:
            if self._det is None:
                from ..tasks.detection import OcrDetectionTask
                self._det = OcrDetectionTask(model=self.config.detect_model,
                                             device=self.device,
                                             mesh=self.mesh)
        return self._det

    @property
    def rec_task(self):
        with self._build_lock:
            if self._rec is None:
                from ..tasks.recognition import OcrRecognitionTask
                self._rec = OcrRecognitionTask(
                    model=self.config.recognizer_model, lang=self.config.lang,
                    device=self.device, cls_task=self.textline_cls_task,
                    mesh=self.mesh)
        return self._rec

    @property
    def layout_task(self):
        with self._build_lock:
            if self._layout is None and self.config.use_layout \
                    and self.config.layout_model != "none":
                from ..tasks.layout import OcrLayoutTask
                self._layout = OcrLayoutTask(model=self.config.layout_model,
                                             task_type=self.config.lang,
                                             device=self.device,
                                             mesh=self.mesh)
        return self._layout

    @property
    def tsr_task(self):
        with self._build_lock:
            if self._tsr is None and self.config.use_table:
                from ..tasks.table_structure import OcrTableStructureTask
                self._tsr = OcrTableStructureTask(
                    model=self.config.table_structure_model,
                    device=self.device, mesh=self.mesh,
                    **self.config.table_structure_kwargs)
        return self._tsr

    @property
    def preprocess_task(self):
        with self._build_lock:
            if self._preprocess is None:
                from ..tasks.preprocess import OcrTablePreprocessTask
                self._preprocess = OcrTablePreprocessTask(
                    use_orientation_cls=self.config.use_orientation_cls,
                    device=self.device)
        return self._preprocess

    @property
    def textline_cls_task(self):
        with self._build_lock:
            if self._line_cls is None and self.config.use_textline_cls:
                from ..tasks.cls_pulc import ClsImagePulcTask
                self._line_cls = ClsImagePulcTask(
                    task_type="textline_orientation", device=self.device,
                    mesh=self.mesh)
        return self._line_cls

    def build_tasks(self) -> None:
        """Build every model task the batched runner calls, in one order
        (on a mesh building a task is a collective, so every process must
        build the same tasks, also where its own pages would not reach
        them)."""
        for name in ("det_task", "textline_cls_task", "rec_task",
                     "layout_task", "tsr_task"):
            getattr(self, name)

    @property
    def pdf_text_task(self):
        if self._pdf_text is None:
            from ..tasks.pdf_text import OcrPdfTextTask
            self._pdf_text = OcrPdfTextTask()
        return self._pdf_text

    @property
    def table_html_task(self):
        if self._table_html is None:
            from ..tasks.table_to_html import OcrTableToHtmlTask
            self._table_html = OcrTableToHtmlTask()
        return self._table_html

    @property
    def to_html_task(self):
        if self._to_html is None:
            from ..tasks.to_html import OcrToHtmlTask
            self._to_html = OcrToHtmlTask()
        return self._to_html

    # -- stages -----------------------------------------------------------------

    def text_detection(self, image: np.ndarray) -> List[np.ndarray]:
        out = self.det_task(image)
        return list(out["det_polygons"].reshape(-1, 4, 2))

    def image_orientation_fix(self, image: np.ndarray,
                              score_threshold: float = 0.9):
        """Images: the aspect check of the detected boxes (most boxes
        taller than wide: the page is turned by 90 degrees and detected
        again), then the 0/180 classifier over every box's crop in one
        forward; a majority of confident 180 votes turns the whole page.
        Returns (image, quads or None when stale, degrees turned)."""
        quads = self.text_detection(image)
        rotated = 0
        if len(quads):
            q = np.asarray(quads)
            widths = np.abs(q[:, 0, 0] - q[:, 2, 0])
            heights = np.abs(q[:, 0, 1] - q[:, 2, 1])
            if heights.sum() > 0 and widths.sum() / heights.sum() < 1.0:
                image = np.ascontiguousarray(np.rot90(image, k=1))
                rotated = 90
                quads = self.text_detection(image)
        cls_task = self.textline_cls_task
        if cls_task is not None and len(quads):
            crops = crop_rotated_boxes(image, np.asarray(quads))
            res = cls_task.batch_infer(crops)
            v0 = sum(1 for r in res if r["score"] > score_threshold
                     and r["label"] == "0_degree")
            v180 = sum(1 for r in res if r["score"] > score_threshold
                       and r["label"] == "180_degree")
            if v180 > v0:
                image = np.ascontiguousarray(np.rot90(image, k=2))
                rotated += 180
                quads = None
        return image, quads, rotated

    def text_recognition(self, image: np.ndarray,
                         quads: Sequence[np.ndarray]) -> List[OcrCell]:
        if not len(quads):
            return []
        crops = crop_rotated_boxes(image, np.asarray(quads))
        res = self.rec_task(crops)
        return [OcrCell.from_poly(np.asarray(q), text=t, score=s)
                for q, t, s in zip(quads, res["texts"], res["scores"])]

    def layout_analysis(self, image: np.ndarray) -> List[OcrCell]:
        task = self.layout_task
        if task is None:
            return []
        return task(image).get("layout_cells", [])

    def table_structure(self, image: np.ndarray,
                        table_bbox: Tuple[float, float, float, float]):
        """The TSR task on one region's crop, with its offset."""
        task = self.tsr_task
        if task is None:
            return None
        x1, y1, x2, y2 = [int(round(v)) for v in table_bbox]
        x1, y1 = max(0, x1), max(0, y1)
        crop = image[y1:y2, x1:x2]
        if crop.size == 0:
            return None
        result = task(crop)
        result["offset"] = (x1, y1)
        return result

    def _tables(self, image, pdf_page, pdf_text_ok, pdf_scale,
                table_bboxes) -> List[Tuple[Any, Dict[str, Any]]]:
        """(bbox, TSR result) per table of the page."""
        table_results: List[Tuple[Any, Dict[str, Any]]] = []
        if pdf_text_ok and pdf_page.segs is not None \
                and (pdf_page.segs or pdf_page.rects):
            # a digital page: its vector lines give the cells, in the layout
            # regions or, where none holds lines, in the lines' own clusters
            from ..models.line_cell import (detect_table_regions,
                                            extract_cells_from_pdf_page)
            from ..tasks.pdf_text import table_bbox_is_pdf_image
            for tb in table_bboxes:
                if table_bbox_is_pdf_image(tb, pdf_page, pdf_scale):
                    continue   # a figure detected as a table
                r = extract_cells_from_pdf_page(pdf_page, pdf_scale, bbox=tb)
                if r["cells"]:
                    r["offset"] = (0, 0)
                    table_results.append((tb, r))
            if not table_results:
                for region in detect_table_regions(pdf_page, pdf_scale):
                    r = {"cells": region["cells"], "type": "line_cell_pdf",
                         "offset": (0, 0)}
                    table_results.append((region["bbox"], r))
        elif table_bboxes and self.tsr_task is not None \
                and hasattr(self.tsr_task, "batch_infer"):
            # all table crops of the page in one call
            crops, kept = [], []
            for tb in table_bboxes:
                x1, y1, x2, y2 = [int(round(v)) for v in tb]
                crop = image[max(0, y1):y2, max(0, x1):x2]
                if crop.size:
                    crops.append(crop)
                    kept.append((tb, (max(0, x1), max(0, y1))))
            for (tb, offset), r in zip(kept,
                                       self.tsr_task.batch_infer(crops)):
                r["offset"] = offset
                table_results.append((tb, r))
        else:
            for tb in table_bboxes:
                r = self.table_structure(image, tb)
                if r is not None:
                    table_results.append((tb, r))
        return table_results

    # -- main -------------------------------------------------------------------

    def __call__(self, image: Optional[np.ndarray] = None, pdf_page=None,
                 pdf_doc=None, page: int = 0,
                 src_id: str = "") -> OcrSystemModelOutput:
        cfg = self.config
        out = OcrSystemModelOutput(src_id=src_id, page=page,
                                   is_pdf=pdf_page is not None)
        metric: Dict[str, float] = {}

        t0 = time.perf_counter()
        if image is None and pdf_page is not None:
            from ..pdfio.render import render_page
            image = render_page(pdf_doc, pdf_page, dpi=cfg.render_dpi)
        if image is None:
            raise ValueError("need image and/or pdf_page")
        pdf_text_ok = pdf_page is not None
        if pdf_page is not None:
            from ..tasks.pdf_text import check_pdf_text_need_rotate90
            if check_pdf_text_need_rotate90(pdf_page):
                # authored rotated: turn the raster, read its text by OCR
                image = np.ascontiguousarray(np.rot90(image, k=3))
                out.rotate_angle = 90.0
                pdf_text_ok = False
        pre = self.preprocess_task(image, is_pdf=pdf_page is not None)
        image = pre["image"]
        out.rotate_angle = pre["rotate_angle"]
        cached_quads = None
        if pdf_page is None and cfg.use_textline_cls:
            t_cls = time.perf_counter()
            image, cached_quads, deg = self.image_orientation_fix(image)
            if deg:
                out.rotate_angle = (out.rotate_angle or 0.0) + deg
            metric["textline_orientation"] = time.perf_counter() - t_cls
        out.image = image
        out.image_shape = image.shape[:2]
        if pdf_page is not None and pdf_page.height > 0:
            out.pdf_scale = image.shape[0] / pdf_page.height
        metric["image_pre_process"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        layout_cells = self.layout_analysis(image) if cfg.use_layout else []
        out.layout_cells = layout_cells
        metric["layout"] = time.perf_counter() - t0

        table_bboxes = filter_figure_tables(
            layout_cells, [c.bbox for c in layout_cells
                           if c.cell_type == HtmlContentType.TABLE])
        if table_bboxes and cfg.table_structure_model in ("LineCell",
                                                          "LineCellPdf"):
            # the line-based extractors need the whole table frame
            table_bboxes = widen_table_regions(layout_cells, table_bboxes,
                                               image.shape[1])

        t0 = time.perf_counter()
        table_results = []
        if cfg.use_table:
            table_results = self._tables(image, pdf_page, pdf_text_ok,
                                         out.pdf_scale, table_bboxes)
        out.table_structures = [r for _, r in table_results]
        metric["table_structure"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if pdf_text_ok and cfg.pdf_text_prefer and pdf_page.texts:
            out.text_cells = self.pdf_text_task(pdf_page, out.pdf_scale)
            metric["pdf_text_extract"] = time.perf_counter() - t0
        else:
            quads = cached_quads if cached_quads is not None \
                else self.text_detection(image)
            metric["detection"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cells = self.text_recognition(image, quads)
            from ..tasks.to_html import merge_overlapping_cells
            out.text_cells = merge_overlapping_cells(cells)
            metric["recognition"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        table_regions = []
        for tb, r in table_results:
            html = self.table_html_task(r, out.text_cells)
            out.table_html.append(html)
            table_regions.append((tb, html))
        metric["table_html"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out.page_html = self.to_html_task(out.text_cells, table_regions,
                                          page_width=float(image.shape[1]))
        metric["ocr_html"] = time.perf_counter() - t0
        out.metric = metric
        if cfg.debug:
            from ..utils.debug_render import render_debug_overlay
            out.debug["render"] = render_debug_overlay(
                image, out.text_cells, out.layout_cells, table_results)
            logger.info("page %s metrics: %s", page,
                        {k: round(v, 3) for k, v in metric.items()})
        return out

    def ocr(self, pages: Sequence[Dict[str, Any]]
            ) -> List[OcrSystemModelOutput]:
        """``pages``: [{"image"} | {"pdf_page", "pdf_doc"}, with optional
        "page" and "src_id"] -> one output per page, in order."""
        return [self(image=p.get("image"), pdf_page=p.get("pdf_page"),
                     pdf_doc=p.get("pdf_doc"), page=p.get("page", i),
                     src_id=p.get("src_id", ""))
                for i, p in enumerate(pages)]

    @staticmethod
    def timing_summary(results: Sequence[OcrSystemModelOutput]
                       ) -> Dict[str, Dict[str, float]]:
        """Per-stage latency statistics (ms) over a batch of pages."""
        from ..utils.benchmark_utils import timing_stats

        stages: Dict[str, List[float]] = {}
        for r in results:
            for k, v in r.metric.items():
                stages.setdefault(k, []).append(v * 1000.0)
        return {k: timing_stats(v) for k, v in stages.items()}
