"""Cell / Table / TableList core (reference model/pdf_table/table_core.py:
Cell:240, Table:465, TableList:828).

Coordinates are PDF space (origin bottom-left, y up) like the reference;
``Table.df`` gives the pandas DataFrame, ``parsing_report`` the
accuracy/whitespace summary (table_core.py:529-560).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple



class Cell:
    """A table cell spanning [x1, x2] x [y1, y2] with border flags and
    accumulated text (reference Cell, table_core.py:240)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float):
        self.x1, self.y1, self.x2, self.y2 = x1, y1, x2, y2
        self.lb = (x1, y1)
        self.lt = (x1, y2)
        self.rb = (x2, y1)
        self.rt = (x2, y2)
        self.left = False
        self.right = False
        self.top = False
        self.bottom = False
        self.hspan = False
        self.vspan = False
        self.row_index: int = 0
        self.col_index: int = 0
        self.row_span: int = 1
        self.col_span: int = 1
        self._text: str = ""

    def __repr__(self) -> str:
        return (f"<Cell x1={self.x1:.2f} y1={self.y1:.2f} "
                f"x2={self.x2:.2f} y2={self.y2:.2f}>")

    @property
    def text(self) -> str:
        return self._text

    @text.setter
    def text(self, t: str) -> None:
        self._text = "".join([self._text, t])

    @property
    def bound(self) -> int:
        """Number of sides with detected borders."""
        return sum((self.left, self.right, self.top, self.bottom))

    @property
    def bbox(self) -> Tuple[float, float, float, float]:
        return (self.x1, self.y1, self.x2, self.y2)

    @property
    def width(self) -> float:
        return self.x2 - self.x1

    @property
    def height(self) -> float:
        return self.y2 - self.y1


class Table:
    """Grid of Cells built from sorted column/row boundaries
    (reference Table, table_core.py:465)."""

    def __init__(self, cols: Sequence[float], rows: Sequence[float]):
        # cols ascending x; rows descending y (pdf space top row first)
        self.cols = list(cols)
        self.rows = list(rows)
        self.cells: List[List[Cell]] = [
            [Cell(self.cols[j], self.rows[i + 1],
                  self.cols[j + 1], self.rows[i])
             for j in range(len(self.cols) - 1)]
            for i in range(len(self.rows) - 1)]
        for i, row in enumerate(self.cells):
            for j, c in enumerate(row):
                c.row_index, c.col_index = i, j
        self.shape = (len(self.cells),
                      len(self.cells[0]) if self.cells else 0)
        self.accuracy: float = 0.0
        self.whitespace: float = 0.0
        self.order: int = 0
        self.page: int = 0
        self.flavor: str = ""
        self._bbox: Optional[Tuple[float, float, float, float]] = None

    def __repr__(self) -> str:
        return f"<Table shape={self.shape}>"

    @property
    def bbox(self) -> Tuple[float, float, float, float]:
        if self._bbox is not None:
            return self._bbox
        return (min(self.cols), min(self.rows),
                max(self.cols), max(self.rows))

    @bbox.setter
    def bbox(self, v) -> None:
        self._bbox = v

    # -- edge marking (reference set_edges, table_core.py) ------------------

    def mark_edges(self, h_segments: Sequence[Tuple[float, float, float]],
                   v_segments: Sequence[Tuple[float, float, float]],
                   tol: float = 2.0) -> "Table":
        """h_segments (y, x0, x1); v_segments (x, y0, y1) in pdf space."""
        for row in self.cells:
            for c in row:
                for y, x0, x1 in h_segments:
                    if abs(y - c.y2) <= tol and x0 <= c.x1 + tol \
                            and x1 >= c.x2 - tol:
                        c.top = True
                    if abs(y - c.y1) <= tol and x0 <= c.x1 + tol \
                            and x1 >= c.x2 - tol:
                        c.bottom = True
                for x, y0, y1 in v_segments:
                    if abs(x - c.x1) <= tol and y0 <= c.y1 + tol \
                            and y1 >= c.y2 - tol:
                        c.left = True
                    if abs(x - c.x2) <= tol and y0 <= c.y1 + tol \
                            and y1 >= c.y2 - tol:
                        c.right = True
        return self

    def set_all_edges(self) -> "Table":
        for row in self.cells:
            for c in row:
                c.left = c.right = c.top = c.bottom = True
        return self

    def set_border(self) -> "Table":
        for row in self.cells:
            row[0].left = True
            row[-1].right = True
        for c in self.cells[0]:
            c.top = True
        for c in self.cells[-1]:
            c.bottom = True
        return self

    def set_span(self) -> "Table":
        """Mark hspan/vspan where inner borders are missing
        (reference set_span)."""
        for row in self.cells:
            for c in row:
                if not c.left and c.col_index > 0:
                    c.hspan = True
                if not c.right and c.col_index < self.shape[1] - 1:
                    c.hspan = True
                if not c.top and c.row_index > 0:
                    c.vspan = True
                if not c.bottom and c.row_index < self.shape[0] - 1:
                    c.vspan = True
        return self

    # -- data ---------------------------------------------------------------

    @property
    def data(self) -> List[List[str]]:
        return [[c.text.strip() for c in row] for row in self.cells]

    @property
    def df(self):
        import pandas as pd

        return pd.DataFrame(self.data)

    @property
    def parsing_report(self) -> Dict[str, Any]:
        return {"accuracy": round(self.accuracy, 2),
                "whitespace": round(self.whitespace, 2),
                "order": self.order, "page": self.page}

    def compute_stats(self) -> None:
        """whitespace = % empty cells (table_core.py:529-560)."""
        data = self.data
        n = sum(len(r) for r in data)
        empty = sum(1 for r in data for t in r if not t)
        self.whitespace = 100.0 * empty / max(n, 1)

    def logical_cells(self) -> List[Tuple[int, int, int, int,
                                          Tuple[float, float, float, float]]]:
        """Merged span regions: (row, col, rowspan, colspan, merged bbox)
        per anchor cell — the analog of the reference's merged
        all_cell_results (merge_row_cell/merge_column_cell,
        table_extractor_pdf.py:769,841 + modify_cell_info:707): a grid cell
        swallowed by a span (missing inner separator) belongs to its
        anchor's region."""
        regions = []
        skip = set()
        for i, row in enumerate(self.cells):
            for j, c in enumerate(row):
                if (i, j) in skip:
                    continue
                cs = 1
                while j + cs < self.shape[1] and row[j + cs].hspan \
                        and not row[j + cs].left:
                    skip.add((i, j + cs))
                    cs += 1
                rs = 1
                while i + rs < self.shape[0] \
                        and self.cells[i + rs][j].vspan \
                        and not self.cells[i + rs][j].top:
                    for jj in range(j, j + cs):
                        skip.add((i + rs, jj))
                    rs += 1
                bbox = (c.x1, self.cells[i + rs - 1][j].y1,
                        row[j + cs - 1].x2, c.y2)
                regions.append((i, j, rs, cs, bbox))
        return regions

    def to_html(self) -> str:
        """Span-aware HTML (merges via hspan/vspan flags)."""
        rows_html: List[str] = []
        by_row: Dict[int, List[Tuple[int, int, int, str]]] = {}
        for i, j, rs, cs, _bbox in self.logical_cells():
            by_row.setdefault(i, []).append((j, rs, cs,
                                             self.cells[i][j].text.strip()))
        for i in range(self.shape[0]):
            tds = []
            for j, rs, cs, text in sorted(by_row.get(i, [])):
                attrs = ""
                if cs > 1:
                    attrs += f' colspan="{cs}"'
                if rs > 1:
                    attrs += f' rowspan="{rs}"'
                tds.append(f"<td{attrs}>{text}</td>")
            rows_html.append("<tr>" + "".join(tds) + "</tr>")
        return "<table>" + "".join(rows_html) + "</table>"


class TableList:
    """Ordered list of Tables (reference TableList, table_core.py:828)."""

    def __init__(self, tables: Optional[List[Table]] = None):
        self._tables = tables or []

    def __repr__(self) -> str:
        return f"<TableList n={len(self._tables)}>"

    def __len__(self) -> int:
        return len(self._tables)

    def __getitem__(self, i: int) -> Table:
        return self._tables[i]

    def __iter__(self):
        return iter(self._tables)

    def append(self, t: Table) -> None:
        self._tables.append(t)

    @property
    def n(self) -> int:
        return len(self._tables)

    def export(self, path: str, f: str = "csv") -> None:
        import os

        base, _ = os.path.splitext(path)
        for i, t in enumerate(self._tables):
            if f == "csv":
                t.df.to_csv(f"{base}-{i}.csv", index=False, header=False)
            elif f == "json":
                t.df.to_json(f"{base}-{i}.json", orient="values")
            elif f == "html":
                with open(f"{base}-{i}.html", "w", encoding="utf-8") as fh:
                    fh.write(t.to_html())
            else:
                raise ValueError(f"unsupported export format {f!r}")
