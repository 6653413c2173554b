"""Minimal xlsx writer and HTML table -> xlsx (counterpart of
pdf_table_tpu/utils/xlsx_writer.py): an xlsx file is a zip of XML parts,
so the worksheet, the workbook plumbing and the merged cells of
rowspan / colspan are written directly, as in JAX. The table HTML is
parsed by the port's own parser (``utils/html_tree.py``), which builds
lxml's tree, not by lxml."""

from __future__ import annotations

import zipfile
from typing import List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def col_letter(idx: int) -> str:
    """0-based column index -> A1 letters."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(65 + rem) + out
    return out


def write_xlsx(path: str, rows: Sequence[Sequence[str]],
               merges: Optional[Sequence[Tuple[int, int, int, int]]] = None) -> None:
    """rows: grid of cell strings; merges: (r1, c1, r2, c2) 0-based
    inclusive ranges."""
    cells_xml: List[str] = []
    for ri, row in enumerate(rows):
        tds = []
        for ci, val in enumerate(row):
            ref = f"{col_letter(ci)}{ri + 1}"
            if val is None or val == "":
                continue
            tds.append(f'<c r="{ref}" t="inlineStr"><is><t xml:space='
                       f'"preserve">{escape(str(val))}</t></is></c>')
        cells_xml.append(f'<row r="{ri + 1}">' + "".join(tds) + "</row>")
    merge_xml = ""
    if merges:
        refs = [f'<mergeCell ref="{col_letter(c1)}{r1 + 1}:'
                f'{col_letter(c2)}{r2 + 1}"/>'
                for r1, c1, r2, c2 in merges if (r1, c1) != (r2, c2)]
        if refs:
            merge_xml = (f'<mergeCells count="{len(refs)}">'
                         + "".join(refs) + "</mergeCells>")
    sheet = ("""<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<sheetData>""" + "".join(cells_xml) + "</sheetData>" + merge_xml
             + "</worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def html_table_to_xlsx(html: str, path: str) -> None:
    """Parse the first <table> and write it as xlsx with merges
    (tablepyxl.document_to_xl behavior)."""
    from .html_tree import fromstring

    doc = fromstring(html)
    tables = list(doc.iter_tags("table"))
    root = tables[0] if tables else doc
    grid: List[List[str]] = []
    merges: List[Tuple[int, int, int, int]] = []
    occupied: set = set()
    for ri, tr in enumerate(root.iter_tags("tr")):
        while len(grid) <= ri:
            grid.append([])
        ci = 0
        for td in tr.child_tags("td", "th"):
            while (ri, ci) in occupied:
                ci += 1
            rs = int(td.get("rowspan", 1) or 1)
            cs = int(td.get("colspan", 1) or 1)
            text = "".join(td.itertext()).strip()
            for r in range(ri, ri + rs):
                while len(grid) <= r:
                    grid.append([])
                for c in range(ci, ci + cs):
                    occupied.add((r, c))
                    while len(grid[r]) <= c:
                        grid[r].append("")
            grid[ri][ci] = text
            if rs > 1 or cs > 1:
                merges.append((ri, ci, ri + rs - 1, ci + cs - 1))
            ci += cs
    width = max((len(r) for r in grid), default=0)
    for r in grid:
        r.extend([""] * (width - len(r)))
    write_xlsx(path, grid, merges)
