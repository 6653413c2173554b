"""Lattice flavor: ruling lines from the rasterized page.

Reference: TableExtractorLattice (model/pdf_table/table_extractor_lattice.py:32)
— rasterize, adaptive-threshold + morphological line kernels, joints ->
table regions -> grid -> text fill. The raster line detection reuses
models/line_cell/algo (the cv2 formulation of the reference's
PdfImageProcessor.find_lines, image_processing.py:79, reproduced without
cv2); the page is rendered by the port's pdfio (its text layer needs
PIL).
"""

from __future__ import annotations



from ..models.line_cell.algo import find_table_lines
from ..models.line_cell.grid import merge_positions
from .assign import assign_text
from .core import Table, TableList


class TableExtractorLattice:
    flavor = "lattice"

    def __init__(self, line_scale: int = 15, dpi: int = 144,
                 line_tol: float = 4.0):
        self.line_scale = line_scale
        self.dpi = dpi
        self.line_tol = line_tol

    def extract_tables(self, doc, page) -> TableList:
        from ..pdfio.render import render_page

        image = render_page(doc, page, dpi=self.dpi)
        scale = self.dpi / 72.0
        h_img, v_img = find_table_lines(image, scale=self.line_scale)
        ph = page.height
        # image space (y down, px) -> pdf space (y up, units)
        h_pdf = [((ph - y / scale), x0 / scale, x1 / scale)
                 for y, x0, x1 in h_img]
        v_pdf = [(x / scale, ph - y1 / scale, ph - y0 / scale)
                 for x, y0, y1 in v_img]
        return build_tables_from_segments(h_pdf, v_pdf, page,
                                          tol=self.line_tol,
                                          flavor=self.flavor)


def cluster_segments(h_segments, v_segments, pad: float = 5.0):
    """Group line segments into connected table regions (reference
    _generate_table_bbox contour clustering + table_bbox_merge diff=10,
    table_extractor_pdf.py:127,206). Segments are pdf-space
    h: (y, x0, x1), v: (x, y0, y1). Returns a list of
    (bbox, h_subset, v_subset), top of page first."""
    boxes = [[x0, y, x1, y] for y, x0, x1 in h_segments] \
        + [[x, y0, x, y1] for x, y0, y1 in v_segments]
    owners = list(range(len(boxes)))
    merged = [list(b) for b in boxes]
    changed = True
    while changed:
        changed = False
        out, omap = [], {}
        used = [False] * len(merged)
        for i in range(len(merged)):
            if used[i]:
                continue
            cur = list(merged[i])
            omap[i] = len(out)
            for j in range(i + 1, len(merged)):
                if used[j]:
                    continue
                b = merged[j]
                if not (cur[2] + pad < b[0] or b[2] + pad < cur[0]
                        or cur[3] + pad < b[1] or b[3] + pad < cur[1]):
                    cur[0] = min(cur[0], b[0])
                    cur[1] = min(cur[1], b[1])
                    cur[2] = max(cur[2], b[2])
                    cur[3] = max(cur[3], b[3])
                    used[j] = True
                    omap[j] = omap[i]
                    changed = True
            out.append(cur)
        owners = [omap[o] for o in owners]
        merged = out
    nh = len(h_segments)
    regions = []
    for ri, bbox in enumerate(merged):
        hs = [s for k, s in enumerate(h_segments) if owners[k] == ri]
        vs = [s for k, s in enumerate(v_segments) if owners[nh + k] == ri]
        regions.append((tuple(bbox), hs, vs))
    regions.sort(key=lambda r: -r[0][3])    # pdf space: top first
    return regions


def build_tables_from_segments(h_segments, v_segments, page,
                               tol: float = 4.0,
                               flavor: str = "lattice") -> TableList:
    """Cluster segments into table regions, build grids, mark edges/spans,
    fill text — one Table per connected line cluster."""
    tables = TableList()
    if len(h_segments) < 2 or len(v_segments) < 2:
        return tables
    for order, (bbox, hs, vs) in enumerate(
            cluster_segments(h_segments, v_segments)):
        ys = merge_positions([s[0] for s in hs], tol)
        xs = merge_positions([s[0] for s in vs], tol)
        if len(ys) < 2 or len(xs) < 2:
            continue
        rows = sorted(ys, reverse=True)   # pdf space: top first
        cols = sorted(xs)
        t = Table(cols, rows)
        t.flavor = flavor
        t.page = page.index + 1
        t.order = order + 1
        t.mark_edges(hs, vs, tol=tol)
        t.set_border()
        t.set_span()
        texts = [
            tx for tx in page.texts
            if cols[0] - tol <= (tx.bbox[0] + tx.bbox[2]) / 2 <= cols[-1] + tol
            and rows[-1] - tol <= (tx.bbox[1] + tx.bbox[3]) / 2 <= rows[0] + tol]
        assign_text(t, texts)
        t.bbox = (cols[0], rows[-1], cols[-1], rows[0])
        tables.append(t)
    return tables
