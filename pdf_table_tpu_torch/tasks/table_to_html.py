"""Table -> HTML (counterpart of pdf_table_tpu/tasks/table_to_html.py).

Cell path (LORE): match text boxes to structure cells and walk the
logical grid with rowspan/colspan; TSR result {"cells": [{"bbox": [x1, y1,
x2, y2], "logic": [row_s, row_e, col_s, col_e]}], "offset": (x, y)}, bbox
in crop coords, offset mapping back to page coords.

Token path (SLANet, TableMaster / MtlTabNet): {"structure_tokens",
"cells": [{"bbox"}], "type", "offset"} goes through ``TableMatch``
(tasks/table_matcher.py); master results through its master route.
"""

from __future__ import annotations

import html as html_mod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..entity.ocr_cell import OcrCell
from . import ocr_fixes
from .table_matcher import TableMatch


def bbox_iou(a: Sequence[float], b: Sequence[float]) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    if inter <= 0:
        return 0.0
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


def overlap_ratio(text_bbox: Sequence[float],
                  cell_bbox: Sequence[float]) -> float:
    """Fraction of the text box inside the cell."""
    ix1, iy1 = max(text_bbox[0], cell_bbox[0]), max(text_bbox[1],
                                                    cell_bbox[1])
    ix2, iy2 = min(text_bbox[2], cell_bbox[2]), min(text_bbox[3],
                                                    cell_bbox[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    area = max((text_bbox[2] - text_bbox[0])
               * (text_bbox[3] - text_bbox[1]), 1e-9)
    return inter / area


def find_top1_match(text_cell: OcrCell,
                    cell_bboxes: Sequence[Sequence[float]]) -> Optional[int]:
    """Best structure cell for one text box (see
    :func:`assign_texts_to_cells`)."""
    return assign_texts_to_cells([text_cell], cell_bboxes)[0]


def assign_texts_to_cells(text_cells: Sequence[OcrCell],
                          cell_bboxes: Sequence[Sequence[float]]
                          ) -> List[Optional[int]]:
    """Best structure cell per text box: overlap ratio >= 0.5 first, else
    the nearest center among overlapping cells, else None."""
    if not len(cell_bboxes) or not len(text_cells):
        return [None] * len(text_cells)
    tb = np.asarray([t.bbox for t in text_cells], np.float32)     # (T, 4)
    cb = np.asarray(cell_bboxes, np.float32)                      # (C, 4)
    ix1 = np.maximum(tb[:, None, 0], cb[None, :, 0])
    iy1 = np.maximum(tb[:, None, 1], cb[None, :, 1])
    ix2 = np.minimum(tb[:, None, 2], cb[None, :, 2])
    iy2 = np.minimum(tb[:, None, 3], cb[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_t = np.maximum((tb[:, 2] - tb[:, 0]) * (tb[:, 3] - tb[:, 1]),
                        1e-9)
    ov = inter / area_t[:, None]                                  # (T, C)
    best = np.argmax(ov, axis=1)
    best_ov = ov[np.arange(len(tb)), best]
    tc = (tb[:, :2] + tb[:, 2:]) / 2
    cc = (cb[:, :2] + cb[:, 2:]) / 2
    d = np.abs(tc[:, None, 0] - cc[None, :, 0]) \
        + np.abs(tc[:, None, 1] - cc[None, :, 1])
    d = np.where(ov > 0, d, np.inf)
    near = np.argmin(d, axis=1)
    near_ok = np.isfinite(d[np.arange(len(tb)), near])
    out: List[Optional[int]] = []
    for i in range(len(tb)):
        if best_ov[i] >= 0.5:
            out.append(int(best[i]))
        elif near_ok[i]:
            out.append(int(near[i]))
        else:
            out.append(None)
    return out


def sort_reading_order(cells: List[OcrCell]) -> List[OcrCell]:
    """Top-to-bottom lines, left-to-right within a line."""
    if not cells:
        return []
    out = sorted(cells, key=lambda c: (c.y1, c.x1))
    lines: List[List[OcrCell]] = []
    for c in out:
        for line in lines:
            ref = line[-1]
            inter = min(c.y2, ref.y2) - max(c.y1, ref.y1)
            if inter / max(1e-6, min(c.height, ref.height)) >= 0.5:
                line.append(c)
                break
        else:
            lines.append([c])
    result = []
    for line in sorted(lines, key=lambda l: min(c.y1 for c in l)):
        result.extend(sorted(line, key=lambda c: c.x1))
    return result


def cells_to_html(cells: List[Dict[str, Any]],
                  texts: Optional[List[str]] = None,
                  border: int = 1) -> str:
    """Grid walk with rowspan/colspan. ``cells`` need 'logic'
    [rs, re, cs, ce]."""
    if not cells:
        return "<table></table>"
    n_rows = max(int(c["logic"][1]) for c in cells) + 1
    n_cols = max(int(c["logic"][3]) for c in cells) + 1
    occupied = np.zeros((n_rows, n_cols), bool)
    start_map: Dict[Tuple[int, int], int] = {}
    for i, c in enumerate(cells):
        rs, re, cs, ce = [int(v) for v in c["logic"]]
        start_map.setdefault((rs, cs), i)
    rows_html: List[str] = []
    for r in range(n_rows):
        tds: List[str] = []
        for col in range(n_cols):
            if occupied[r, col]:
                continue
            i = start_map.get((r, col))
            if i is None:
                tds.append("<td></td>")
                occupied[r, col] = True
                continue
            rs, re, cs, ce = [int(v) for v in cells[i]["logic"]]
            rowspan = re - rs + 1
            colspan = ce - cs + 1
            occupied[rs:re + 1, cs:ce + 1] = True
            attrs = ""
            if rowspan > 1:
                attrs += f" rowspan=\"{rowspan}\""
            if colspan > 1:
                attrs += f" colspan=\"{colspan}\""
            content = texts[i] if texts is not None \
                else cells[i].get("text", "")
            tds.append(f"<td{attrs}>{content}</td>")
        rows_html.append("<tr>" + "".join(tds) + "</tr>")
    battr = f" border=\"{border}\"" if border else ""
    return f"<table{battr}><tbody>" + "".join(rows_html) + "</tbody></table>"


class OcrTableToHtmlTask:
    """(tsr_result, page text cells) -> HTML table string: cell-path
    results through the logical grid, token-path results through
    ``TableMatch``. ``ocr_post_process`` applies the per-cell OCR text
    fixes of :mod:`.ocr_fixes` on the cell path."""

    def __init__(self, ocr_post_process: bool = False):
        self.ocr_post_process = ocr_post_process

    def _fix(self, text: str) -> str:
        return ocr_fixes.ocr_post_process(text) if self.ocr_post_process \
            else text

    def __call__(self, tsr_result: Dict[str, Any],
                 text_cells: Sequence[OcrCell] = ()) -> str:
        if tsr_result.get("structure_tokens"):
            return self._token_path(tsr_result, text_cells)
        cells = tsr_result.get("cells", [])
        if not cells or not any("logic" in c for c in cells):
            return "<table></table>"
        ox, oy = tsr_result.get("offset", (0, 0))
        page_bboxes = [[c["bbox"][0] + ox, c["bbox"][1] + oy,
                        c["bbox"][2] + ox, c["bbox"][3] + oy] for c in cells]
        assigned: Dict[int, List[OcrCell]] = {}
        for t, i in zip(text_cells,
                        assign_texts_to_cells(text_cells, page_bboxes)):
            if i is not None:
                assigned.setdefault(i, []).append(t)
        texts: List[str] = []
        for i in range(len(cells)):
            inside = sort_reading_order(assigned.get(i, []))
            texts.append(html_mod.escape(
                " ".join(self._fix((t.text or "").strip())
                         for t in inside).strip()))
        return cells_to_html(cells, texts)

    @staticmethod
    def _token_path(tsr_result: Dict[str, Any],
                    text_cells: Sequence[OcrCell]) -> str:
        ox, oy = tsr_result.get("offset", (0, 0))
        pred_bboxes = [[c["bbox"][0] + ox, c["bbox"][1] + oy,
                        c["bbox"][2] + ox, c["bbox"][3] + oy]
                       for c in tsr_result.get("cells", [])]
        dt_boxes = [list(t.bbox) for t in text_cells]
        use_master = tsr_result.get("type") == "master"
        if use_master:
            # master text flows through <b>-folding and deal_bb, which
            # work on raw inline tags: it goes in unescaped
            texts = [(t.text or "").strip() for t in text_cells]
        else:
            texts = [html_mod.escape((t.text or "").strip())
                     for t in text_cells]
        return TableMatch(use_master=use_master)(
            tsr_result["structure_tokens"], pred_bboxes, dt_boxes, texts)
