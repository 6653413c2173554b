"""Classical (model-free) PDF table extraction — camelot lineage (a copy
of pdf_table_tpu/pdf_table, host code, over the port's pdfio and LineCell:
the lattice flavor renders the page without cv2 and finds its lines with
``models/line_cell/algo.py``).

Reference: src/pdftable/model/pdf_table/ (SURVEY.md §2.6): read_pdf API
with flavors lattice | stream | pdf, Cell/Table/TableList core, OpenCV
line/joint detection, text-edge clustering.
"""

from .core import Cell, Table, TableList
from .extractor import TableExtractor, read_pdf

__all__ = ["Cell", "Table", "TableList", "TableExtractor", "read_pdf"]
