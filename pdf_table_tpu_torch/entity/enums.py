"""Enumerations of the data model that the port's pipeline reads
(counterpart of pdf_table_tpu/entity/enums.py: ``HtmlContentType`` and
``PdfLineType``)."""

from __future__ import annotations

from enum import Enum, unique


@unique
class HtmlContentType(Enum):
    TXT = "text"
    TABLE = "table"
    IMAGE = "image"
    HYPERLINK = "hyperlink"
    NONE = "unknown"


@unique
class PdfLineType(Enum):
    PARAGRAPH_START = "paragraph start"
    PARAGRAPH_END = "paragraph end"
    PARAGRAPH_MIDDLE = "paragraph middle"
    ALIGN_LEFT = "align left"
    ALIGN_RIGHT = "align right"
    ALIGN_CENTER = "align center"
    NONE = "unknown"
