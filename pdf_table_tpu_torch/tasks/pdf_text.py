"""Digital-PDF text extraction task, no OCR (a copy of
pdf_table_tpu/tasks/pdf_text.py, host code).

Reference: OcrPdfTextTask (model/ocr_pdf/ocr_pdf_text_task.py:29) built on
pdfminer. Here the native pdfio reader supplies positioned text runs; this
task converts them to image-space OcrCells, splitting runs that straddle
table-cell boundaries (reference text_box_split_to_cell,
table_common.py:1029).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..entity.ocr_cell import OcrCell
from ..entity.enums import HtmlContentType


def pdf_to_image_bbox(bbox: Tuple[float, float, float, float],
                      page_height: float, scale: float) -> Tuple[float, ...]:
    """PDF user space (origin bottom-left) -> image space (origin top-left)."""
    x0, y0, x1, y1 = bbox
    return (x0 * scale, (page_height - y1) * scale,
            x1 * scale, (page_height - y0) * scale)


def table_bbox_is_pdf_image(bbox, pdf_page, scale: float,
                            diff: float = 2.0) -> bool:
    """A detected 'table' whose bbox sits inside an embedded PDF image is
    a misdetection — it's a figure (reference check_table_match_images,
    table_common.py:1220, applied in ocr_pdf_text_task.py:109: the table
    gets is_image=True and is skipped). ``bbox`` is image coords (y
    down); PdfImage bboxes are pdf space (y up)."""
    if not getattr(pdf_page, "images", None) or scale <= 0:
        return False
    x1, y1, x2, y2 = bbox
    px1, px2 = x1 / scale, x2 / scale
    py1 = pdf_page.height - y2 / scale
    py2 = pdf_page.height - y1 / scale
    for im in pdf_page.images:
        ix1, iy1, ix2, iy2 = im.bbox
        if px1 >= ix1 - diff and px2 <= ix2 + diff \
                and py1 >= iy1 - diff and py2 <= iy2 + diff:
            return True
    return False


def check_pdf_text_need_rotate90(pdf_page, min_runs: int = 6,
                                 ratio: float = 0.7) -> bool:
    """True when most text runs flow vertically — the page was authored
    rotated (reference check_pdf_text_need_rotate90,
    model/pdf_table/table_common.py:1617)."""
    runs = [t for t in pdf_page.texts if t.text.strip()]
    if len(runs) < min_runs:
        return False
    vertical = sum(1 for t in runs if not t.is_horizontal)
    return vertical / len(runs) >= ratio


class OcrPdfTextTask:
    """Callable: (pdf_page, scale) -> list[OcrCell] in image coordinates."""

    def __init__(self, min_chars: int = 1):
        self.min_chars = min_chars

    def __call__(self, pdf_page, scale: float = 1.0) -> List[OcrCell]:
        cells: List[OcrCell] = []
        page_h = pdf_page.height
        for t in pdf_page.texts:
            txt = t.text
            if t.invisible or len(txt.strip()) < self.min_chars:
                continue
            bbox = pdf_to_image_bbox(t.bbox, page_h, scale)
            cell = OcrCell.from_bbox(bbox, text=txt)
            cell.cell_type = HtmlContentType.TXT
            # stash per-char advances scaled to image px for later splitting
            cell.char_advances = [a * scale for a in t.adv]
            cells.append(cell)
        cells.sort(key=lambda c: (round(c.y1), c.x1))
        return cells

    @staticmethod
    def split_cell_at(cell: OcrCell, x_cuts: Sequence[float]) -> List[OcrCell]:
        """Split a text cell at x positions (table column borders crossing
        it). Uses per-char advances to place the cut inside the string."""
        adv = getattr(cell, "char_advances", None)
        text = cell.text or ""
        if not adv or len(adv) != len(text) or not x_cuts:
            return [cell]
        # char start positions
        xs = [cell.x1]
        for a in adv:
            xs.append(xs[-1] + a)
        pieces: List[OcrCell] = []
        start = 0
        cuts = sorted(c for c in x_cuts if cell.x1 < c < cell.x2)
        for cut in cuts:
            # first char whose center is right of the cut
            idx = start
            while idx < len(text) and (xs[idx] + xs[idx + 1]) / 2 < cut:
                idx += 1
            if idx > start:
                piece = OcrCell.from_bbox(
                    (xs[start], cell.y1, xs[idx], cell.y2),
                    text=text[start:idx])
                piece.cell_type = HtmlContentType.TXT
                piece.char_advances = adv[start:idx]
                pieces.append(piece)
                start = idx
        if start < len(text):
            piece = OcrCell.from_bbox((xs[start], cell.y1, xs[len(text)], cell.y2),
                                      text=text[start:])
            piece.cell_type = HtmlContentType.TXT
            piece.char_advances = adv[start:]
            pieces.append(piece)
        return pieces or [cell]
