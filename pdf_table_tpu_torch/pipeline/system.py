"""The system's configuration and its tasks (counterpart of the parts of
pdf_table_tpu/pipeline/system.py that the batched runner uses:
``OcrSystemConfig``, ``widen_table_regions``, ``filter_figure_tables`` and
the lazy task properties of ``OcrSystemTask``, the vector text of digital
PDF pages among them).

Every task is built on the system's ``device`` (``cuda`` unless ``"cpu"`` is
asked for). The serial per-page ``OcrSystemTask.__call__`` is not ported
(ROADMAP.md Queue 1 item 17).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..entity.enums import HtmlContentType


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
    """The tasks of the page pipeline, built on first use on ``device``.
    ``_det``, ``_rec``, ``_layout``, ``_tsr`` and ``_line_cls`` may be
    assigned directly (bench.py builds its tasks that way)."""

    def __init__(self, config: Optional[OcrSystemConfig] = None,
                 device=None):
        from ..engine.device import resolve_device

        self.config = config or OcrSystemConfig()
        self.device = resolve_device(device)
        self._det = None
        self._rec = None
        self._layout = None
        self._tsr = None
        self._line_cls = None
        self._pdf_text = None
        self._table_html = None
        self._to_html = None

    @property
    def det_task(self):
        if self._det is None:
            from ..tasks.detection import OcrDetectionTask
            self._det = OcrDetectionTask(model=self.config.detect_model,
                                         device=self.device)
        return self._det

    @property
    def rec_task(self):
        if self._rec is None:
            from ..tasks.recognition import OcrRecognitionTask
            self._rec = OcrRecognitionTask(
                model=self.config.recognizer_model, lang=self.config.lang,
                device=self.device, cls_task=self.textline_cls_task)
        return self._rec

    @property
    def layout_task(self):
        if self._layout is None and self.config.use_layout \
                and self.config.layout_model != "none":
            from ..tasks.layout import OcrLayoutTask
            self._layout = OcrLayoutTask(model=self.config.layout_model,
                                         task_type=self.config.lang,
                                         device=self.device)
        return self._layout

    @property
    def tsr_task(self):
        if self._tsr is None and self.config.use_table:
            from ..tasks.table_structure import OcrTableStructureTask
            self._tsr = OcrTableStructureTask(
                model=self.config.table_structure_model, device=self.device,
                **self.config.table_structure_kwargs)
        return self._tsr

    @property
    def textline_cls_task(self):
        if self._line_cls is None and self.config.use_textline_cls:
            from ..tasks.cls_pulc import ClsImagePulcTask
            self._line_cls = ClsImagePulcTask(
                task_type="textline_orientation", device=self.device)
        return self._line_cls

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
