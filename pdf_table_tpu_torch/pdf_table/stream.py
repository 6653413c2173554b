"""Stream flavor: whitespace/text-alignment clustering for borderless tables.

Re-expression of the reference's camelot-lineage stream parser
(model/pdf_table/table_extractor_stream.py:26) with the TextEdges alignment
network (table_core.py:85-239): every text line votes for left / right /
middle vertical alignment edges; edges crossed by > TEXTEDGE_REQUIRED_ELEMENTS
lines are "valid"; the dominant alignment's valid edges seed table areas
(Nurminen's detection, table_extractor_stream.py:292-316), which are extended
by vertically-overlapping text lines and padded. Inside each area, rows come
from y-clustering and columns from the modal row element count, refined by
the text that falls between/outside the column extents.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .assign import assign_text
from .core import Table, TableList

# a vertical alignment edge is load-bearing once it crosses this many rows
# (reference table_core.py:17)
TEXTEDGE_REQUIRED_ELEMENTS = 4
# padding added around detected table areas (reference table_core.py:19)
TABLE_AREA_PADDING = 10.0

BBox = Tuple[float, float, float, float]


class TextEdge:
    """A vertical alignment edge: x position, y extent, and how many text
    rows share it (reference TextEdge, table_core.py:26-83)."""

    __slots__ = ("x", "y0", "y1", "align", "intersections", "is_valid")

    def __init__(self, x: float, y0: float, y1: float, align: str = "left"):
        self.x = x
        self.y0 = y0      # bottom (pdf space)
        self.y1 = y1      # top
        self.align = align
        self.intersections = 0
        self.is_valid = False

    def update_coords(self, x: float, y0: float, edge_tol: float = 50.0
                      ) -> None:
        """Extend the edge down to a new row if the gap is within edge_tol;
        x becomes the running average so jitter cancels out."""
        if abs(self.y0 - y0) <= edge_tol:
            self.x = ((self.intersections * self.x + x)
                      / float(self.intersections + 1))
            self.y0 = y0
            self.intersections += 1
            if self.intersections > TEXTEDGE_REQUIRED_ELEMENTS:
                self.is_valid = True


class TextEdges:
    """Left/right/middle alignment-edge network over a page's text lines
    (reference TextEdges, table_core.py:85-239)."""

    ALIGNS = ("left", "right", "middle")

    def __init__(self, edge_tol: float = 50.0):
        self.edge_tol = edge_tol
        self.edges: Dict[str, List[TextEdge]] = {a: [] for a in self.ALIGNS}

    @staticmethod
    def coord(bbox: BBox, align: str) -> float:
        if align == "left":
            return bbox[0]
        if align == "right":
            return bbox[2]
        return (bbox[0] + bbox[2]) / 2.0

    def update(self, bbox: BBox) -> None:
        for align in self.ALIGNS:
            x = self.coord(bbox, align)
            for te in self.edges[align]:
                if abs(te.x - x) <= 0.5:
                    te.update_coords(x, bbox[1], edge_tol=self.edge_tol)
                    break
            else:
                self.edges[align].append(TextEdge(x, bbox[1], bbox[3],
                                                  align=align))

    def generate(self, bboxes: Sequence[BBox], texts: Sequence[str]) -> None:
        for bbox, s in zip(bboxes, texts):
            if len(s.strip()) > 1:
                self.update(bbox)

    def get_relevant(self) -> List[TextEdge]:
        """The alignment whose valid edges cross the most rows wins."""
        def weight(align: str) -> int:
            return sum(te.intersections for te in self.edges[align]
                       if te.is_valid)

        best = max(self.ALIGNS, key=weight)
        return self.edges[best]

    def get_table_areas(self, bboxes: Sequence[BBox],
                        relevant: Sequence[TextEdge]) -> List[BBox]:
        """Seed areas from valid edges (merging on vertical overlap), extend
        with vertically-overlapping text lines, then pad
        (reference get_table_areas, table_core.py:166-239)."""
        areas: List[List[float]] = []
        for te in sorted(relevant, key=lambda e: (-e.y0, e.x)):
            if not te.is_valid:
                continue
            for a in areas:
                if te.y1 >= a[1] and te.y0 <= a[3]:   # vertical overlap
                    a[1] = min(a[1], te.y0)
                    a[2] = max(a[2], te.x)
                    a[3] = max(a[3], te.y1)
                    break
            else:
                areas.append([te.x, te.y0, te.x, te.y1])

        # widen with any text line that sits inside an area's y band (the
        # edge votes only carried lines sharing the alignment)
        heights = []
        for bbox in bboxes:
            heights.append(bbox[3] - bbox[1])
            for a in areas:
                if bbox[1] >= a[1] and bbox[3] <= a[3]:
                    a[0] = min(a[0], bbox[0])
                    a[1] = min(a[1], bbox[1])
                    a[2] = max(a[2], bbox[2])
                    a[3] = max(a[3], bbox[3])
                    break
        avg_h = (sum(heights) / len(heights)) if heights else 10.0
        return [(a[0] - TABLE_AREA_PADDING, a[1] - TABLE_AREA_PADDING,
                 a[2] + TABLE_AREA_PADDING, a[3] + avg_h * 5)
                for a in areas]


# -- row / column inference inside an area (reference :110-260) -------------

def group_rows(texts: Sequence, row_tol: float = 2.0) -> List[List]:
    """Cluster text objects into rows by bottom-y within row_tol (reference
    _group_rows, table_extractor_stream.py:105); items must be pre-sorted
    top-down."""
    rows: List[List] = []
    row_y: Optional[float] = None
    for t in texts:
        if not t.text.strip():
            continue
        if row_y is None or abs(t.bbox[1] - row_y) > row_tol:
            rows.append([])
            row_y = t.bbox[1]      # anchor = first element of the row
        rows[-1].append(t)
    for r in rows:
        r.sort(key=lambda t: t.bbox[0])
    return rows


def merge_columns(intervals: List[Tuple[float, float]],
                  column_tol: float = 0.0) -> List[Tuple[float, float]]:
    """Merge x-extents that overlap or sit within column_tol (reference
    _merge_columns, table_extractor_stream.py:140)."""
    merged: List[Tuple[float, float]] = []
    for hi in sorted(intervals):
        if merged and (hi[0] <= merged[-1][1]
                       or abs(hi[0] - merged[-1][1]) <= column_tol):
            merged[-1] = (min(merged[-1][0], hi[0]),
                          max(merged[-1][1], hi[1]))
        else:
            merged.append(hi)
    return merged


def join_to_boundaries(extents: List[Tuple[float, float]],
                       lo: float, hi: float) -> List[float]:
    """Continuous boundaries: midpoints between extents plus the outer
    limits (reference _join_columns/_join_rows)."""
    extents = sorted(extents)
    bounds = [lo]
    bounds += [(a[1] + b[0]) / 2.0 for a, b in zip(extents, extents[1:])]
    bounds.append(hi)
    return bounds


class TableExtractorStream:
    """Borderless-table parser. With no ``table_areas`` the TextEdges
    network infers them (Nurminen detection)."""

    flavor = "stream"

    def __init__(self, table_areas: Optional[Sequence[BBox]] = None,
                 table_regions: Optional[Sequence[BBox]] = None,
                 columns: Optional[Sequence[Sequence[float]]] = None,
                 edge_tol: float = 50.0, row_tol: float = 2.0,
                 column_tol: float = 0.0):
        self.table_areas = table_areas
        self.table_regions = table_regions
        self.columns = columns
        if table_areas is not None and columns is not None \
                and len(table_areas) != len(columns):
            raise ValueError("table_areas and columns must align")
        self.edge_tol = edge_tol
        self.row_tol = row_tol
        self.column_tol = column_tol
        self.textedges: List[TextEdge] = []

    # -- area detection ------------------------------------------------------

    def _detect_areas(self, texts, page) -> List[BBox]:
        if self.table_areas is not None:
            return list(self.table_areas)
        if self.table_regions is not None:
            texts = [t for t in texts
                     if any(_bbox_inside(t.bbox, r)
                            for r in self.table_regions)]
        net = TextEdges(edge_tol=self.edge_tol)
        items = sorted(texts, key=lambda t: (-t.bbox[1], t.bbox[0]))
        net.generate([t.bbox for t in items], [t.text for t in items])
        relevant = net.get_relevant()
        self.textedges = list(relevant)
        areas = net.get_table_areas([t.bbox for t in items], relevant)
        if not areas:
            areas = [(0.0, 0.0, page.width, page.height)]
        return areas

    # -- per-area grid ---------------------------------------------------------

    def _columns_and_rows(self, idx: int, area_texts
                          ) -> Tuple[List[float], List[float]]:
        xs0 = min(t.bbox[0] for t in area_texts)
        xs1 = max(t.bbox[2] for t in area_texts)
        ys0 = min(t.bbox[1] for t in area_texts)
        ys1 = max(t.bbox[3] for t in area_texts)

        items = sorted(area_texts, key=lambda t: (-t.bbox[1], t.bbox[0]))
        rows_grouped = group_rows(items, row_tol=self.row_tol)

        # row boundaries from mid-lines between row centers
        mids = [sum((t.bbox[1] + t.bbox[3]) / 2 for t in r) / len(r)
                for r in rows_grouped if r]
        bounds_y = [ys1] + [(a + b) / 2 for a, b in zip(mids, mids[1:])] \
            + [ys0]
        rows = sorted(set(bounds_y), reverse=True)

        if self.columns is not None and idx < len(self.columns) \
                and self.columns[idx]:
            cols = [xs0] + sorted(self.columns[idx]) + [xs1]
            return cols, rows

        counts = [len(r) for r in rows_grouped]
        if not counts:
            return [xs0, xs1], rows
        ncols = max(set(counts), key=counts.count)
        if ncols == 1:
            # a skewed page may still hold a table; retry without the
            # single-run rows (reference :355-366)
            rest = [c for c in counts if c != 1]
            ncols = max(set(rest), key=rest.count) if rest else 1
        exts = [(t.bbox[0], t.bbox[2])
                for r in rows_grouped if len(r) == ncols for t in r]
        exts = merge_columns(sorted(exts), column_tol=self.column_tol)
        if not exts:
            return [xs0, xs1], rows
        # texts straddling the gaps or outside the extents carve extra
        # columns (reference _add_columns flow, :368-392)
        inner = [t for t in area_texts
                 if any(t.bbox[0] > a[1] and t.bbox[2] < b[0]
                        for a, b in zip(exts, exts[1:]))]
        outer = [t for t in area_texts
                 if t.bbox[0] > exts[-1][1] or t.bbox[2] < exts[0][0]]
        extra = inner + outer
        if extra:
            er = group_rows(sorted(extra, key=lambda t: (-t.bbox[1],
                                                         t.bbox[0])),
                            row_tol=self.row_tol)
            ecount = max(len(r) for r in er)
            exts.extend(merge_columns(sorted(
                (t.bbox[0], t.bbox[2])
                for r in er if len(r) == ecount for t in r)))
            exts = merge_columns(sorted(exts),
                                 column_tol=self.column_tol)
        cols = join_to_boundaries(exts, xs0, xs1)
        return cols, rows

    # -- entry ----------------------------------------------------------------

    def extract_tables(self, doc, page) -> TableList:
        tables = TableList()
        texts = [t for t in page.texts if t.text.strip()]
        if not texts:
            return tables
        areas = self._detect_areas(texts, page)
        for idx, area in enumerate(sorted(areas, key=lambda a: -a[3])):
            area_texts = [t for t in texts if _center_in(t.bbox, area)]
            if len(area_texts) < 2:
                continue
            cols, rows = self._columns_and_rows(idx, area_texts)
            if len(cols) < 2 or len(rows) < 2:
                continue
            t = Table(cols, rows)
            t.flavor = self.flavor
            t.page = page.index + 1
            t.order = idx + 1
            t.set_all_edges()
            assign_text(t, area_texts)
            t.bbox = area
            tables.append(t)
        return tables


def _center_in(bbox: BBox, area: BBox) -> bool:
    cx = (bbox[0] + bbox[2]) / 2.0
    cy = (bbox[1] + bbox[3]) / 2.0
    return area[0] <= cx <= area[2] and area[1] <= cy <= area[3]


def _bbox_inside(bbox: BBox, region: BBox) -> bool:
    return (bbox[0] >= region[0] and bbox[2] <= region[2]
            and bbox[1] >= region[1] and bbox[3] <= region[3])
