"""Pdf flavor: enhanced lattice from vector lines with multi-table region
generation, cell merging, and HTML output (reference TableExtractorPdf,
table_extractor_pdf.py:54 — _generate_table_bbox:127 clusters joints into
per-table regions, generate_table_cell:564, merge_row_cell:769,
merge_column_cell:841, match_table_cell_and_text_cell:1046,
cell_to_html:1214).

Uses the native pdfio vector segments (no rasterization). Line clusters
split into one region per table (two wired tables on a page yield two
Table objects); each region's separator grid becomes a spanned Table via
the shared union-find grid builder, and text is matched per region.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from ..models.line_cell.from_pdf import detect_table_regions
from .assign import assign_text
from .core import Table, TableList


def table_from_grid_cells(grid_cells: Sequence[Dict[str, Any]],
                          page_height: float) -> Table:
    """Grid cells (image space, y-down, with logical spans) -> pdf-space
    Table with hspan/vspan marked from the merged-cell logic."""
    ys = sorted({c["bbox"][1] for c in grid_cells} |
                {c["bbox"][3] for c in grid_cells})
    xs = sorted({c["bbox"][0] for c in grid_cells} |
                {c["bbox"][2] for c in grid_cells})
    rows_pdf = sorted([page_height - y for y in ys], reverse=True)
    t = Table(xs, rows_pdf)
    t.set_all_edges()
    # clear inner borders inside merged cells -> spans
    n_rows, n_cols = len(t.cells), len(t.cells[0])
    for gc in grid_cells:
        rs, re, cs, ce = gc["logic"]
        for ri in range(rs, min(re, n_rows - 1) + 1):
            for ci in range(cs, min(ce, n_cols - 1) + 1):
                if ri < re and ri + 1 < n_rows:
                    t.cells[ri][ci].bottom = False
                    t.cells[ri + 1][ci].top = False
                if ci < ce and ci + 1 < n_cols:
                    t.cells[ri][ci].right = False
                    t.cells[ri][ci + 1].left = False
    t.set_span()
    return t


class TableExtractorPdf:
    flavor = "pdf"

    def __init__(self, line_tol: float = 3.0, min_cells: int = 2):
        self.line_tol = line_tol
        self.min_cells = min_cells

    def extract_tables(self, doc, page) -> TableList:
        tables = TableList()
        ph = page.height
        # image-space line clusters -> one region per table (reference
        # _generate_table_bbox joint clustering + table_bbox_merge)
        regions = detect_table_regions(page, scale=1.0,
                                       min_cells=self.min_cells)
        # top-of-page first (image space is y-down)
        regions.sort(key=lambda r: r["bbox"][1])
        for order, region in enumerate(regions):
            grid_cells = region["cells"]
            if len(grid_cells) < self.min_cells:
                continue
            t = table_from_grid_cells(grid_cells, ph)
            t.flavor = self.flavor
            t.page = page.index + 1
            t.order = order + 1
            x1, y1, x2, y2 = region["bbox"]
            # region bbox to pdf space for text matching
            px1, px2 = x1, x2
            py1, py2 = ph - y2, ph - y1
            texts = [tx for tx in page.texts
                     if px1 - 2 <= (tx.bbox[0] + tx.bbox[2]) / 2 <= px2 + 2
                     and py1 - 2 <= (tx.bbox[1] + tx.bbox[3]) / 2 <= py2 + 2]
            assign_text(t, texts)
            t.bbox = (px1, py1, px2, py2)
            tables.append(t)
        return tables
