"""LineCellPdf: wired-table cells from digital-PDF vector lines (a copy of
pdf_table_tpu/models/line_cell/from_pdf.py, host code, over the port's
grid builder).

Reference: TableCellExtractFromPdf
(model/table/line_cell/table_cell_extract_from_pdf.py:41) built on pdfminer
rects. Here the native pdfio reader supplies segments/rects in PDF space;
they convert to image space (y-down, scaled) and feed the shared grid
builder.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def pdf_page_lines(pdf_page, scale: float = 1.0, min_len: float = 4.0,
                   max_rect_thickness: float = 4.0):
    """-> (h_lines [(y, x0, x1)], v_lines [(x, y0, y1)]) in image coords."""
    ph = pdf_page.height
    h_lines: List[Tuple[float, float, float]] = []
    v_lines: List[Tuple[float, float, float]] = []

    def add_seg(x0, y0, x1, y1):
        # pdf y-up -> image y-down
        ix0, iy0 = x0 * scale, (ph - y0) * scale
        ix1, iy1 = x1 * scale, (ph - y1) * scale
        if abs(iy1 - iy0) <= abs(ix1 - ix0):
            if abs(ix1 - ix0) >= min_len * scale:
                h_lines.append(((iy0 + iy1) / 2.0, min(ix0, ix1),
                                max(ix0, ix1)))
        else:
            if abs(iy1 - iy0) >= min_len * scale:
                v_lines.append(((ix0 + ix1) / 2.0, min(iy0, iy1),
                                max(iy0, iy1)))

    for s in pdf_page.segs:
        add_seg(s.x0, s.y0, s.x1, s.y1)

    for r in pdf_page.rects:
        x0, y0, x1, y1 = r.bbox
        w, h = abs(x1 - x0), abs(y1 - y0)
        if min(w, h) <= max_rect_thickness:
            # thin filled rect = drawn line (common PDF idiom)
            if w >= h:
                add_seg(x0, (y0 + y1) / 2, x1, (y0 + y1) / 2)
            else:
                add_seg((x0 + x1) / 2, y0, (x0 + x1) / 2, y1)
        else:
            # cell border rectangle: contribute all 4 edges
            add_seg(x0, y0, x1, y0)
            add_seg(x0, y1, x1, y1)
            add_seg(x0, y0, x0, y1)
            add_seg(x1, y0, x1, y1)
    return h_lines, v_lines


def extract_cells_from_pdf_page(pdf_page, scale: float = 1.0,
                                bbox: Optional[Tuple[float, float, float, float]] = None,
                                tol: float = 3.0) -> Dict[str, Any]:
    """Digital PDF page (+optional image-space region) -> TSR result schema."""
    from .grid import build_grid_cells

    h_lines, v_lines = pdf_page_lines(pdf_page, scale=scale)
    if bbox is not None:
        x1, y1, x2, y2 = bbox
        pad = tol * 2
        h_lines = [l for l in h_lines
                   if y1 - pad <= l[0] <= y2 + pad
                   and l[2] > x1 - pad and l[1] < x2 + pad]
        v_lines = [l for l in v_lines
                   if x1 - pad <= l[0] <= x2 + pad
                   and l[2] > y1 - pad and l[1] < y2 + pad]
    cells = build_grid_cells(h_lines, v_lines, tol=tol * scale)
    return {"cells": [c.to_dict() for c in cells], "type": "line_cell_pdf",
            "n_h_lines": len(h_lines), "n_v_lines": len(v_lines)}


def detect_table_regions(pdf_page, scale: float = 1.0,
                         min_cells: int = 2):
    """Group line clusters into candidate table bounding boxes (used when
    no learned layout model routes tables; reference
    TableExtractorPdf._generate_table_bbox:127 analog)."""
    h_lines, v_lines = pdf_page_lines(pdf_page, scale=scale)
    if len(h_lines) < 2 or len(v_lines) < 2:
        return []
    # cluster by overlap: greedy box grow over line extents
    boxes = []
    for y, x0, x1 in h_lines:
        boxes.append([x0, y, x1, y])
    for x, y0, y1 in v_lines:
        boxes.append([x, y0, x, y1])
    boxes = np.array(boxes, np.float64)
    # iterative merge of overlapping/nearby boxes
    changed = True
    pad = 5.0 * scale
    while changed and len(boxes) > 1:
        changed = False
        out = []
        used = np.zeros(len(boxes), bool)
        for i in range(len(boxes)):
            if used[i]:
                continue
            cur = boxes[i].copy()
            for j in range(i + 1, len(boxes)):
                if used[j]:
                    continue
                b = boxes[j]
                if not (cur[2] + pad < b[0] or b[2] + pad < cur[0]
                        or cur[3] + pad < b[1] or b[3] + pad < cur[1]):
                    cur[0] = min(cur[0], b[0])
                    cur[1] = min(cur[1], b[1])
                    cur[2] = max(cur[2], b[2])
                    cur[3] = max(cur[3], b[3])
                    used[j] = True
                    changed = True
            out.append(cur)
        boxes = np.array(out)
    regions = []
    for b in boxes:
        if b[2] - b[0] > 20 * scale and b[3] - b[1] > 10 * scale:
            sub = extract_cells_from_pdf_page(
                pdf_page, scale, bbox=tuple(b))
            if len(sub["cells"]) >= min_cells:
                regions.append({"bbox": tuple(float(v) for v in b),
                                "cells": sub["cells"]})
    return regions
