"""Line grid -> spanned table cells (a copy of
pdf_table_tpu/models/line_cell/grid.py, where it is shared by LineCell and
LineCellPdf). :func:`build_grid_cells` sorts its lines first, so that its
result does not depend on their order (it did only through the order of a
float sum in ``_covers``).

Reference behavior: TableCellExtract (model/table/line_cell/
table_cell_extract_algo.py) and TableCellExtractFromPdf
(table_cell_extract_from_pdf.py:41) both reduce to: merged horizontal +
vertical separator segments -> grid boundaries -> per-unit separator
presence -> union of units lacking separators -> cells with logical spans
(the schema OcrTableToHtmlTask consumes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class GridCell:
    bbox: Tuple[float, float, float, float]
    logic: Tuple[int, int, int, int]        # row_s, row_e, col_s, col_e

    def to_dict(self) -> Dict[str, Any]:
        return {"bbox": list(self.bbox), "logic": list(self.logic)}


def merge_positions(vals: Sequence[float], tol: float = 5.0) -> List[float]:
    """Cluster 1-D positions within tol -> representative (mean) positions
    (reference merge_close_lines, utils/pdf_utils.py:804)."""
    if not len(vals):
        return []
    vals = sorted(vals)
    groups: List[List[float]] = [[vals[0]]]
    for v in vals[1:]:
        if v - groups[-1][-1] <= tol:
            groups[-1].append(v)
        else:
            groups.append([v])
    return [float(np.mean(g)) for g in groups]


def _covers(segments: List[Tuple[float, float]], lo: float, hi: float,
            min_cover: float = 0.5) -> bool:
    """True if segments cover >= min_cover of [lo, hi]."""
    span = hi - lo
    if span <= 0:
        return True
    covered = 0.0
    for s0, s1 in segments:
        covered += max(0.0, min(s1, hi) - max(s0, lo))
    return covered >= min_cover * span


def build_grid_cells(h_lines: Sequence[Tuple[float, float, float]],
                     v_lines: Sequence[Tuple[float, float, float]],
                     tol: float = 5.0,
                     min_cover: float = 0.5) -> List[GridCell]:
    """h_lines: (y, x0, x1) horizontal segments; v_lines: (x, y0, y1).

    Returns cells with bbox + logical spans. Units whose shared border has
    no separator segment are merged (rowspan/colspan inference, reference
    merge_row_cell/merge_column_cell behavior in table_extractor_pdf.py).
    """
    h_lines, v_lines = sorted(h_lines), sorted(v_lines)
    ys = merge_positions([h[0] for h in h_lines], tol)
    xs = merge_positions([v[0] for v in v_lines], tol)
    if len(ys) < 2 or len(xs) < 2:
        return []
    n_rows, n_cols = len(ys) - 1, len(xs) - 1

    # bucket segments by their snapped boundary position
    h_by_y: Dict[int, List[Tuple[float, float]]] = {}
    for y, x0, x1 in h_lines:
        yi = int(np.argmin([abs(y - yy) for yy in ys]))
        if abs(y - ys[yi]) <= tol:
            h_by_y.setdefault(yi, []).append((min(x0, x1), max(x0, x1)))
    v_by_x: Dict[int, List[Tuple[float, float]]] = {}
    for x, y0, y1 in v_lines:
        xi = int(np.argmin([abs(x - xx) for xx in xs]))
        if abs(x - xs[xi]) <= tol:
            v_by_x.setdefault(xi, []).append((min(y0, y1), max(y0, y1)))

    # separator presence between units
    # h_sep[i, j]: separator between row i-1 and row i across column j
    h_sep = np.zeros((n_rows + 1, n_cols), bool)
    for i in range(n_rows + 1):
        segs = h_by_y.get(i, [])
        for j in range(n_cols):
            h_sep[i, j] = _covers(segs, xs[j], xs[j + 1], min_cover)
    v_sep = np.zeros((n_rows, n_cols + 1), bool)
    for j in range(n_cols + 1):
        segs = v_by_x.get(j, [])
        for i in range(n_rows):
            v_sep[i, j] = _covers(segs, ys[i], ys[i + 1], min_cover)

    # union-find over grid units; merge across missing separators
    parent = list(range(n_rows * n_cols))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for i in range(n_rows):
        for j in range(n_cols):
            u = i * n_cols + j
            if i + 1 < n_rows and not h_sep[i + 1, j]:
                union(u, (i + 1) * n_cols + j)
            if j + 1 < n_cols and not v_sep[i, j + 1]:
                union(u, i * n_cols + j + 1)

    groups: Dict[int, List[Tuple[int, int]]] = {}
    for i in range(n_rows):
        for j in range(n_cols):
            groups.setdefault(find(i * n_cols + j), []).append((i, j))

    cells: List[GridCell] = []
    for units in groups.values():
        ri = [u[0] for u in units]
        ci = [u[1] for u in units]
        rs, re, cs, ce = min(ri), max(ri), min(ci), max(ci)
        cells.append(GridCell(
            bbox=(xs[cs], ys[rs], xs[ce + 1], ys[re + 1]),
            logic=(rs, re, cs, ce)))
    cells.sort(key=lambda c: (c.logic[0], c.logic[2]))
    return cells
