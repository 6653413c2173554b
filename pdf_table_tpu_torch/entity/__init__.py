"""The data model (counterpart of pdf_table_tpu/entity): enums, geometry,
recognized cells and the CLI argument dataclasses. Host code only: numpy
and the standard library."""

from .enums import (
    HtmlContentType,
    HtmlTableCompareType,
    LineDirectionType,
    PdfLineType,
    LayoutLabelEnum,
    ModelType,
)
from .geometry import Point, LineInterval, Line
from .ocr_cell import OcrCell, TableUnit, TableEval
from .args import PdfTableCliArguments, ModelArguments, DataTrainingArguments

__all__ = [
    "HtmlContentType",
    "HtmlTableCompareType",
    "LineDirectionType",
    "PdfLineType",
    "LayoutLabelEnum",
    "ModelType",
    "Point",
    "LineInterval",
    "Line",
    "OcrCell",
    "TableUnit",
    "TableEval",
    "PdfTableCliArguments",
    "ModelArguments",
    "DataTrainingArguments",
]
