"""Page -> HTML assembly (copy of pdf_table_tpu/tasks/to_html.py): cells are
grouped into visual lines, classified by alignment, merged into <p> blocks,
with tables and images interleaved in reading order.
"""

from __future__ import annotations

import html as html_mod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..entity.enums import PdfLineType
from ..entity.ocr_cell import OcrCell

HTML_HEADER = ("<!DOCTYPE html>\n<html>\n<head>\n<meta charset=\"UTF-8\">\n"
               "<style>table{border-collapse:collapse}"
               "td,th{border:1px solid #999;padding:2px 6px}</style>\n"
               "</head>\n<body>\n")
HTML_FOOTER = "</body>\n</html>\n"


def merge_overlapping_cells(cells: Sequence[OcrCell],
                            overlap_thresh: float = 0.7) -> List[OcrCell]:
    """Merge detections that substantially overlap (containment ratio of
    the smaller box >= threshold) into one cell, concatenating text in
    x-order (reference ocr_post_process, table_common.py:1328)."""
    items = list(cells)
    merged = True
    while merged:
        merged = False
        out: List[OcrCell] = []
        used = [False] * len(items)
        for i, a in enumerate(items):
            if used[i]:
                continue
            for j in range(i + 1, len(items)):
                if used[j]:
                    continue
                b = items[j]
                ix = max(0.0, min(a.x2, b.x2) - max(a.x1, b.x1))
                iy = max(0.0, min(a.y2, b.y2) - max(a.y1, b.y1))
                inter = ix * iy
                smaller = max(min(a.area, b.area), 1e-9)
                if inter / smaller >= overlap_thresh:
                    left, right = (a, b) if a.x1 <= b.x1 else (b, a)
                    text = " ".join(t for t in
                                    ((left.text or "").strip(),
                                     (right.text or "").strip()) if t)
                    c = OcrCell.from_bbox(
                        (min(a.x1, b.x1), min(a.y1, b.y1),
                         max(a.x2, b.x2), max(a.y2, b.y2)),
                        text=text, score=max(a.score, b.score))
                    used[i] = used[j] = True
                    out.append(c)
                    merged = True
                    break
            if not used[i]:
                out.append(a)
                used[i] = True
        items = out
    return items


def group_lines(cells: Sequence[OcrCell],
                y_overlap_ratio: float = 0.5) -> List[List[OcrCell]]:
    """Group cells into visual lines by vertical overlap, sort each line by x."""
    items = sorted(cells, key=lambda c: (c.y1, c.x1))
    lines: List[List[OcrCell]] = []
    for c in items:
        placed = False
        for line in lines:
            ref = line[-1]
            inter = min(c.y2, ref.y2) - max(c.y1, ref.y1)
            min_h = max(1e-6, min(c.height, ref.height))
            if inter / min_h >= y_overlap_ratio:
                line.append(c)
                placed = True
                break
        if not placed:
            lines.append([c])
    for line in lines:
        line.sort(key=lambda c: c.x1)
    lines.sort(key=lambda l: min(c.y1 for c in l))
    return lines


def classify_line_alignment(lines: List[List[OcrCell]],
                            page_width: float) -> List[PdfLineType]:
    """Per-line alignment for paragraph merging (parse_text_line_align:95)."""
    if not lines:
        return []
    x_starts = [min(c.x1 for c in l) for l in lines]
    x_ends = [max(c.x2 for c in l) for l in lines]
    left_margin = float(np.median(x_starts))
    right_margin = float(np.median(x_ends))
    out: List[PdfLineType] = []
    for xs, xe in zip(x_starts, x_ends):
        w = xe - xs
        center_off = abs((xs + xe) / 2 - (left_margin + right_margin) / 2)
        tol = max(8.0, 0.02 * page_width)
        if abs(xs - left_margin) <= tol:
            out.append(PdfLineType.ALIGN_LEFT)
        elif center_off <= tol and w < 0.8 * (right_margin - left_margin):
            out.append(PdfLineType.ALIGN_CENTER)
        elif abs(xe - right_margin) <= tol:
            out.append(PdfLineType.ALIGN_RIGHT)
        else:
            out.append(PdfLineType.NONE)
    return out


def merge_paragraphs(lines: List[List[OcrCell]], aligns: List[PdfLineType],
                     page_width: float) -> List[Dict[str, Any]]:
    """Merge consecutive lines into paragraphs (merge_ocr_text_paragraph
    behavior): a line continues the paragraph when the previous line reaches
    near the right margin and vertical gap is within ~1.6 line heights."""
    blocks: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    right_margin = max((max(c.x2 for c in l) for l in lines), default=0.0)
    for line, align in zip(lines, aligns):
        text = " ".join((c.text or "") for c in line).strip()
        y1 = min(c.y1 for c in line)
        y2 = max(c.y2 for c in line)
        x2 = max(c.x2 for c in line)
        h = max(1.0, y2 - y1)
        if cur is not None:
            gap = y1 - cur["y2"]
            prev_reaches_right = cur["x2"] >= right_margin - 0.05 * page_width
            if gap <= 1.6 * h and prev_reaches_right and \
                    align in (PdfLineType.ALIGN_LEFT, PdfLineType.NONE):
                cur["text"] += " " + text
                cur["y2"] = y2
                cur["x2"] = x2
                continue
            blocks.append(cur)
        cur = {"type": "p", "text": text, "align": align,
               "y1": y1, "y2": y2, "x2": x2}
    if cur is not None:
        blocks.append(cur)
    return blocks


class OcrToHtmlTask:
    """Assemble final page HTML from text cells + table/image regions."""

    def __init__(self, add_header: bool = False):
        self.add_header = add_header

    def __call__(self, text_cells: Sequence[OcrCell],
                 table_regions: Optional[Sequence[Tuple[Tuple[float, float, float, float], str]]] = None,
                 image_regions: Optional[Sequence[Tuple[float, float, float, float]]] = None,
                 page_width: float = 1000.0) -> str:
        table_regions = list(table_regions or [])
        image_regions = list(image_regions or [])

        def in_any_table(c: OcrCell) -> bool:
            cx, cy = (c.x1 + c.x2) / 2, (c.y1 + c.y2) / 2
            for (x1, y1, x2, y2), _ in table_regions:
                if x1 <= cx <= x2 and y1 <= cy <= y2:
                    return True
            return False

        free_cells = [c for c in text_cells if not in_any_table(c)]
        lines = group_lines(free_cells)
        aligns = classify_line_alignment(lines, page_width)
        blocks = merge_paragraphs(lines, aligns, page_width)

        for (x1, y1, x2, y2), tbl_html in table_regions:
            blocks.append({"type": "table", "html": tbl_html,
                           "y1": y1, "y2": y2})
        for (x1, y1, x2, y2) in image_regions:
            blocks.append({"type": "image", "y1": y1, "y2": y2,
                           "bbox": (x1, y1, x2, y2)})
        blocks.sort(key=lambda b: b["y1"])

        parts: List[str] = []
        if self.add_header:
            parts.append(HTML_HEADER)
        for b in blocks:
            if b["type"] == "p":
                style = ""
                if b["align"] == PdfLineType.ALIGN_CENTER:
                    style = " style=\"text-align:center\""
                elif b["align"] == PdfLineType.ALIGN_RIGHT:
                    style = " style=\"text-align:right\""
                parts.append(f"<p{style}>{html_mod.escape(b['text'])}</p>")
            elif b["type"] == "table":
                parts.append(b["html"])
            else:
                x1, y1, x2, y2 = b["bbox"]
                parts.append(f"<div class=\"image\" data-bbox=\""
                             f"{x1:.0f},{y1:.0f},{x2:.0f},{y2:.0f}\"></div>")
        if self.add_header:
            parts.append(HTML_FOOTER)
        return "\n".join(parts)
