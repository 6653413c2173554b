"""Text assignment into table cells (shared by all flavors).

Behavior-parity rewrite of the reference chain
(model/pdf_table/table_extractor_pdf.py / table_common.py):

- ``split_texts_to_cells`` — text_box_split_to_cell (table_common.py:1029):
  a text line straddling a vertical cell border splits at the border, each
  character routed to the cell containing its center
  (split_text_cell_horizontal:862, find_char_belong_cell); characters over
  a separator stick with the previous cell. Uses the native reader's
  per-char advances (pdfio PdfText.adv) instead of pdfminer LTChar boxes.
- ``find_top1_match_box`` — find_top1_mach_box (table_extractor_pdf.py:1182):
  containment first (box_in_other_box, table_common.py:138), else sort by
  (1 - IoU, corner-distance) (compute_iou_v2:473, distance:435).
- ``assign_text`` — match_table_cell_and_text_cell (:1046) +
  get_one_cell_text (:1146): texts match against the MERGED logical cells
  (so spanned regions collect text at their anchor), reading-order sorted
  inside a cell by merged-y lines then x, lines joined with newline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..models.line_cell.grid import merge_positions
from .core import Table


@dataclass
class TextItem:
    text: str
    bbox: Tuple[float, float, float, float]   # pdf space (x0, y0, x1, y1)


def _as_item(t) -> TextItem:
    return TextItem(text=getattr(t, "text", ""), bbox=tuple(t.bbox))


def _char_spans(t) -> Optional[List[Tuple[float, float]]]:
    """Per-char [x_start, x_end] along the baseline from the reader's
    advance widths; None when advances are unavailable/mismatched."""
    adv = getattr(t, "adv", None)
    text = getattr(t, "text", "")
    if not adv or len(adv) != len(text):
        return None
    x = float(getattr(t, "origin", (t.bbox[0], 0))[0])
    spans = []
    for a in adv:
        spans.append((x, x + a))
        x += a
    return spans


def split_texts_to_cells(texts: Sequence, cell_boxes: Sequence[Tuple],
                         diff: float = 2.0) -> List[TextItem]:
    """Split horizontal text items that straddle cell borders
    (text_box_split_to_cell, table_common.py:1029). ``cell_boxes`` are
    merged logical cell bboxes in pdf space."""
    out: List[TextItem] = []
    for t in texts:
        x0, y0, x1, y1 = t.bbox
        # find cells on this text's row band
        row_cells = [cb for cb in cell_boxes
                     if cb[1] - diff < y0 and y1 < cb[3] + diff]
        inside = [cb for cb in row_cells
                  if cb[0] - diff < x0 and x1 < cb[2] + diff]
        if inside or not row_cells:
            out.append(_as_item(t))
            continue
        crossed = [cb for cb in row_cells
                   if not (x1 <= cb[0] + diff or x0 >= cb[2] - diff)]
        crossed.sort(key=lambda cb: cb[0])
        if len(crossed) < 2:
            out.append(_as_item(t))
            continue
        spans = _char_spans(t)
        if spans is None:
            out.append(_as_item(t))
            continue
        parts: List[List[int]] = [[] for _ in crossed]
        prev = -1
        for k, (cx0, cx1) in enumerate(spans):
            cx = (cx0 + cx1) / 2
            ci = next((j for j, cb in enumerate(crossed)
                       if cb[0] - diff <= cx <= cb[2] + diff), -1)
            if ci < 0:
                ci = prev if prev >= 0 else 0
            parts[ci].append(k)
            prev = ci
        for j, idxs in enumerate(parts):
            if not idxs:
                continue
            seg = "".join(t.text[k] for k in idxs)
            if not seg.strip():
                continue
            sx0 = min(spans[k][0] for k in idxs)
            sx1 = max(spans[k][1] for k in idxs)
            out.append(TextItem(text=seg, bbox=(sx0, y0, sx1, y1)))
    return out


def _iou(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    ua = abs((a[2] - a[0]) * (a[3] - a[1])) \
        + abs((b[2] - b[0]) * (b[3] - b[1])) - inter
    return inter / (ua + 1e-6)


def _corner_distance(a, b) -> float:
    d_tl = abs(b[0] - a[0]) + abs(b[1] - a[1])
    d_br = abs(b[2] - a[2]) + abs(b[3] - a[3])
    return d_tl + d_br + min(d_tl, d_br)


def find_top1_match_box(text_box, cell_boxes: Sequence,
                        diff: float = 2.0) -> Optional[int]:
    """Containment -> (1-IoU, corner-distance) chain
    (find_top1_mach_box, table_extractor_pdf.py:1182)."""
    if not cell_boxes:
        return None
    keys = []
    for i, cb in enumerate(cell_boxes):
        if (text_box[0] >= cb[0] - diff and text_box[2] <= cb[2] + diff
                and cb[1] - diff <= text_box[1] <= text_box[3]
                <= cb[3] + diff):
            return i
        keys.append((1.0 - _iou(text_box, cb),
                     _corner_distance(text_box, cb)))
    return min(range(len(keys)), key=lambda i: keys[i])


def order_cell_text(items: List[TextItem]) -> str:
    """Reading order inside one cell (get_one_cell_text,
    table_extractor_pdf.py:1146): merge item tops into lines
    (merge_close_lines with tol = mean height / 3), sort lines top-down and
    items left-right; newline between lines, space between same-line
    items (the native reader's items are finer-grained than pdfminer's
    whole-line boxes, so same-line fragments join with a space)."""
    if not items:
        return ""
    heights = [it.bbox[3] - it.bbox[1] for it in items]
    tol = max(sum(heights) / len(heights) / 3.0, 0.1)
    tops = merge_positions([it.bbox[3] for it in items], tol=tol)

    def norm_top(v: float) -> float:
        return min(tops, key=lambda g: abs(g - v))

    lines: Dict[float, List[TextItem]] = {}
    for it in items:
        lines.setdefault(norm_top(it.bbox[3]), []).append(it)
    parts = []
    for y in sorted(lines, reverse=True):
        seg = sorted(lines[y], key=lambda it: it.bbox[0])
        parts.append(" ".join(s.text.strip() for s in seg).strip())
    return "\n".join(p for p in parts if p)


def assign_text(table: Table, texts: Sequence, tol: float = 2.0) -> Table:
    """texts: pdfio.PdfText-like objects with .bbox (pdf space), .text and
    optional per-char .adv. Splits straddling boxes at cell borders, then
    routes every item through the containment->IoU+distance chain against
    the MERGED logical cells, and writes reading-ordered text at each
    span's anchor cell."""
    regions = table.logical_cells()
    cell_boxes = [r[4] for r in regions]
    items = split_texts_to_cells(texts, cell_boxes, diff=tol)

    per_region: Dict[int, List[TextItem]] = {}
    for it in items:
        if not it.text.strip():
            continue
        ri = find_top1_match_box(it.bbox, cell_boxes, diff=tol)
        if ri is not None:
            per_region.setdefault(ri, []).append(it)

    for ri, its in per_region.items():
        i, j = regions[ri][0], regions[ri][1]
        table.cells[i][j].text = order_cell_text(its)
    table.compute_stats()
    return table
