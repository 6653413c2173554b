"""pdfio — the port's PDF layer (counterpart of pdf_table_tpu/pdfio).

A C++ PDF reader (tokenizer, xref/objstm resolution, stream filters,
content-stream interpretation) exposed through ctypes and built at first
use, a pure-Python PDF writer, and a rasterizer that draws without cv2
(its text layer through PIL).
"""

from .reader import PdfDocument, PdfPage, PdfText, PdfSeg, PdfRect, PdfImage
from .writer import PdfWriter
from .render import render_page, render_page_vector

__all__ = [
    "PdfDocument",
    "PdfPage",
    "PdfText",
    "PdfSeg",
    "PdfRect",
    "PdfImage",
    "PdfWriter",
    "render_page",
    "render_page_vector",
]
