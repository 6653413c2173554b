"""Enumerations of the data model that the port's pipeline reads
(counterpart of pdf_table_tpu/entity/enums.py: ``HtmlContentType``,
``HtmlTableCompareType`` and ``PdfLineType``)."""

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
class HtmlTableCompareType(Enum):
    DIFF = "diff"
    SAME = "same"
    REMOVE_WIDTH_SAME = "same after removing width attrs"
    SAME_LABEL_MISSING_ONE_CHARACTER = "same, label missing one character"
    SAME_LABEL_GARBLED_ONE_CHARACTER = "same, label has one garbled character"
    DIFF_TEXT_ORDER = "diff: text order"
    DIFF_TEXT_INCONSISTENT = "diff: text content"
    DIFF_TEXT_PREDICT_LESS_WORDS = "diff: prediction missing words"
    DIFF_TEXT_LABEL_LESS_WORDS = "diff: label missing words"
    DIFF_CELL_SPAN_SAME = "same cells"
    DIFF_CELL_ROW_SPAN = "diff: cell rowspan"
    DIFF_CELL_COL_SPAN = "diff: cell colspan"
    DIFF_CELL_ROW_COL_SPAN = "diff: cell row+col span"
    DIFF_CELL_DIFF_ROW = "diff: cell row index"
    NONE = "unknown"

    @property
    def desc(self) -> str:
        return self.value

    @staticmethod
    def parse(raw) -> "HtmlTableCompareType":
        s = str(raw).lower()
        for member in HtmlTableCompareType:
            if s == member.name.lower():
                return member
        return HtmlTableCompareType.NONE


@unique
class PdfLineType(Enum):
    PARAGRAPH_START = "paragraph start"
    PARAGRAPH_END = "paragraph end"
    PARAGRAPH_MIDDLE = "paragraph middle"
    ALIGN_LEFT = "align left"
    ALIGN_RIGHT = "align right"
    ALIGN_CENTER = "align center"
    NONE = "unknown"
