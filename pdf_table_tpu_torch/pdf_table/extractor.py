"""read_pdf API + page dispatch.

Reference: TableExtractor.read_pdf (model/pdf_table/table_extractor.py:84)
and PDFHandler.parse (pdf_handlers.py:86, parser_class map :120).
"""

from __future__ import annotations

from typing import List, Union

from .core import TableList
from .lattice import TableExtractorLattice
from .pdf_flavor import TableExtractorPdf
from .stream import TableExtractorStream

PARSER_CLASSES = {
    "lattice": TableExtractorLattice,
    "stream": TableExtractorStream,
    "pdf": TableExtractorPdf,
}


class TableExtractor:
    """Flavor validation + per-page parse (reference PDFHandler)."""

    def __init__(self, flavor: str = "pdf", pages: str = "1", **kwargs):
        if flavor not in PARSER_CLASSES:
            raise ValueError(
                f"unknown flavor {flavor!r}; expected one of "
                f"{sorted(PARSER_CLASSES)}")
        self.flavor = flavor
        self.pages = pages
        self.parser = PARSER_CLASSES[flavor](**kwargs)

    def parse(self, filepath: Union[str, bytes]) -> TableList:
        from ..pdfio.reader import PdfDocument

        tables = TableList()
        with PdfDocument.open(filepath) as doc:
            idxs = parse_pages(self.pages, doc.page_count)
            for i in idxs:
                page = doc.load_page(i)
                for t in self.parser.extract_tables(doc, page):
                    t.order = len(tables) + 1
                    tables.append(t)
        return tables


def parse_pages(spec, n_pages: int) -> List[int]:
    """'1,3,4', '2-5', '1,4-end', 'all' -> 0-based page indices (a copy of
    pdf_table_tpu/cli/main.py::parse_pages)."""
    if not spec or spec == "all":
        return list(range(n_pages))
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            a, b = part.split("-", 1)
            start = int(a)
            end = n_pages if b in ("end", "") else int(b)
            out.extend(range(start - 1, min(end, n_pages)))
        elif part:
            out.append(int(part) - 1)
    return sorted({i for i in out if 0 <= i < n_pages})


def read_pdf(filepath: Union[str, bytes], pages: str = "1",
             flavor: str = "pdf", **kwargs) -> TableList:
    """Extract tables from a PDF (reference read_pdf,
    table_extractor.py:84). flavor: lattice | stream | pdf."""
    return TableExtractor(flavor=flavor, pages=pages, **kwargs).parse(filepath)
