"""Enumerations of the data model (counterpart of
pdf_table_tpu/entity/enums.py, the same members, values and ``desc`` /
``parse``): the reference's ``entity/enum_entity.py`` surface with English
descriptors."""

from __future__ import annotations

from enum import Enum, unique


@unique
class HtmlContentType(Enum):
    TXT = "text"
    TABLE = "table"
    IMAGE = "image"
    HYPERLINK = "hyperlink"
    NONE = "unknown"

    @property
    def desc(self) -> str:
        return self.value

    @staticmethod
    def parse(raw) -> "HtmlContentType":
        s = str(raw).lower()
        for member in HtmlContentType:
            if s in (member.value.lower(), member.name.lower()):
                return member
        return HtmlContentType.NONE


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
class LineDirectionType(Enum):
    HORIZONTAL = "horizontal"
    VERTICAL = "vertical"
    NONE = "unknown"

    @property
    def desc(self) -> str:
        return self.value


@unique
class PdfLineType(Enum):
    PARAGRAPH_START = "paragraph start"
    PARAGRAPH_END = "paragraph end"
    PARAGRAPH_MIDDLE = "paragraph middle"
    ALIGN_LEFT = "align left"
    ALIGN_RIGHT = "align right"
    ALIGN_CENTER = "align center"
    NONE = "unknown"

    @property
    def desc(self) -> str:
        return self.value


class LayoutLabelEnum(Enum):
    TEXT = "text"
    TITLE = "title"
    FIGURE = "figure"
    FIGURE_CAPTION = "figure_caption"
    TABLE = "table"
    TABLE_CAPTION = "table_caption"
    HEADER = "header"
    FOOTER = "footer"
    REFERENCE = "reference"
    EQUATION = "equation"
    LIST = "list"
    PAGE_NUMBER = "page_number"
    FOOTNOTE = "footnote"
    FULL_COLUMN = "full_column"
    SUB_COLUMN = "sub_column"

    @property
    def desc(self) -> str:
        return self.value

    @staticmethod
    def parse(raw) -> "LayoutLabelEnum | None":
        s = str(raw).lower()
        for member in LayoutLabelEnum:
            if s == member.value.lower():
                return member
        return None


@unique
class ModelType(Enum):
    LAYOUT_DOCX_LAYOUT = "DocXLayout"
    LAYOUT_PICODET = "picodet"

    TSR_CENTER_NET = "CenterNet"
    TSR_SLANET = "SLANet"
    TSR_LORE = "Lore"
    TSR_LGPMA = "Lgpma"
    TSR_MTL_TAB_NET = "MtlTabNet"
    TSR_TABLE_MASTER = "TableMaster"
    TSR_LINE_CELL = "LineCell"
    TSR_LINE_CELL_PDF = "LineCellPdf"

    DET_PP_OCRV4 = "PP-OCRv4-det"
    DET_PP_OCRV3 = "PP-OCRv3-det"
    DET_DBNET_RESNET18 = "resnet18"
    DET_DBNET_RESNET50 = "resnet50"
    DET_PROXYLESSNAS = "proxylessnas"

    REC_PP_OCRV4 = "PP-OCRv4-rec"
    REC_PP_OCRV3 = "PP-OCRv3-rec"
    REC_PP_TABLE = "PP-Table"
    REC_CONVNEXT_VIT = "ConvNextViT"
    REC_CRNN = "CRNN"
    REC_LIGHTWEIGHT_EDGE = "LightweightEdge"
