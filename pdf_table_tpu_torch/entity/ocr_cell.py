"""Recognized-content cells and evaluation-side table units (counterpart
of pdf_table_tpu/entity/ocr_cell.py): ``OcrCell``, a text line, image or
table region with its bbox, text and score, and ``TableUnit`` /
``TableEval``, cells with logical coordinates for the table metrics."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .enums import HtmlContentType, PdfLineType
from .geometry import Point


class OcrCell:
    """A recognized region: text line, image, or embedded table.

    ``bbox`` is (x1, y1, x2, y2) in image coordinates (y down). ``poly`` is
    an optional (4, 2) quadrilateral for rotated text boxes.
    """

    def __init__(self,
                 left_top: Optional[Point] = None,
                 right_bottom: Optional[Point] = None,
                 text: Optional[str] = None,
                 raw_data: Optional[Dict[str, Any]] = None,
                 db_text: Optional[str] = None,
                 cell_type: HtmlContentType = HtmlContentType.NONE,
                 inner_cells: Optional[List["OcrCell"]] = None,
                 poly: Optional[np.ndarray] = None,
                 score: float = 1.0):
        self.left_top = left_top
        self.right_bottom = right_bottom
        self.index: Optional[int] = None
        self.text = text
        self.db_text = db_text
        self.cell_type = cell_type
        self.is_image = False
        self.image_info: Optional[Dict[str, Any]] = None
        self.poly = None if poly is None else np.asarray(poly, dtype=np.float32)
        self.score = float(score)
        self.text_number = 0
        self.text_width = 0.0
        self.line_type: PdfLineType = PdfLineType.NONE
        self.inner_cells: List[OcrCell] = inner_cells if inner_cells is not None else []
        self.raw_data = raw_data
        if raw_data is not None:
            self._parse(raw_data)
        self._parse_width()

    # -- construction --------------------------------------------------------

    def _parse(self, raw: Dict[str, Any]) -> None:
        self.index = raw.get("index")
        if raw.get("text") is not None:
            self.text = raw.get("text")
        bbox = raw.get("bbox")
        if bbox is not None:
            self.set_bbox(bbox)
        if raw.get("is_image", False):
            self.is_image = True
            self.cell_type = HtmlContentType.IMAGE
            self.image_info = raw.get("image_info")
        if raw.get("poly") is not None:
            self.poly = np.asarray(raw["poly"], dtype=np.float32)
        if raw.get("score") is not None:
            self.score = float(raw["score"])

    def _parse_width(self) -> None:
        if self.text:
            self.text_number = len(self.text)
            if self.left_top is not None and self.right_bottom is not None and self.text_number:
                self.text_width = self.width / self.text_number

    @classmethod
    def from_bbox(cls, bbox: Sequence[float], text: Optional[str] = None,
                  cell_type: HtmlContentType = HtmlContentType.TXT,
                  score: float = 1.0) -> "OcrCell":
        cell = cls(left_top=Point(float(bbox[0]), float(bbox[1])),
                   right_bottom=Point(float(bbox[2]), float(bbox[3])),
                   text=text, cell_type=cell_type, score=score)
        return cell

    @classmethod
    def from_poly(cls, poly: np.ndarray, text: Optional[str] = None,
                  cell_type: HtmlContentType = HtmlContentType.TXT,
                  score: float = 1.0) -> "OcrCell":
        p = np.asarray(poly, dtype=np.float32).reshape(-1, 2)
        cell = cls(left_top=Point(float(p[:, 0].min()), float(p[:, 1].min())),
                   right_bottom=Point(float(p[:, 0].max()), float(p[:, 1].max())),
                   text=text, cell_type=cell_type, poly=p, score=score)
        return cell

    # -- geometry -------------------------------------------------------------

    def set_bbox(self, bbox: Sequence[float]) -> None:
        self.left_top = Point(float(bbox[0]), float(bbox[1]))
        self.right_bottom = Point(float(bbox[2]), float(bbox[3]))

    @property
    def bbox(self) -> tuple:
        if self.left_top is None or self.right_bottom is None:
            return (0.0, 0.0, 0.0, 0.0)
        return (self.left_top.x, self.left_top.y, self.right_bottom.x, self.right_bottom.y)

    @property
    def x1(self) -> float:
        return self.left_top.x if self.left_top else 0.0

    @property
    def y1(self) -> float:
        return self.left_top.y if self.left_top else 0.0

    @property
    def x2(self) -> float:
        return self.right_bottom.x if self.right_bottom else 0.0

    @property
    def y2(self) -> float:
        return self.right_bottom.y if self.right_bottom else 0.0

    @property
    def width(self) -> float:
        return max(0.0, self.x2 - self.x1)

    @property
    def height(self) -> float:
        return max(0.0, self.y2 - self.y1)

    @property
    def area(self) -> float:
        return self.width * self.height

    @property
    def center(self) -> Point:
        return Point((self.x1 + self.x2) / 2.0, (self.y1 + self.y2) / 2.0)

    def contains(self, other: "OcrCell", tol: float = 0.0) -> bool:
        return (self.x1 - tol <= other.x1 and self.y1 - tol <= other.y1
                and self.x2 + tol >= other.x2 and self.y2 + tol >= other.y2)

    def contains_point(self, x: float, y: float, tol: float = 0.0) -> bool:
        return (self.x1 - tol <= x <= self.x2 + tol
                and self.y1 - tol <= y <= self.y2 + tol)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "bbox": list(self.bbox),
            "text": self.text,
            "cell_type": self.cell_type.name,
            "score": self.score,
        }
        if self.index is not None:
            d["index"] = self.index
        if self.poly is not None:
            d["poly"] = self.poly.tolist()
        if self.is_image:
            d["is_image"] = True
            d["image_info"] = self.image_info
        return d

    def __repr__(self) -> str:
        t = (self.text[:20] + "…") if self.text and len(self.text) > 20 else self.text
        return (f"<OcrCell bbox=({self.x1:.0f},{self.y1:.0f},{self.x2:.0f},{self.y2:.0f}) "
                f"type={self.cell_type.name} text={t!r}>")


@dataclass
class TableUnit:
    """Eval-side cell: physical bbox + logical axis (row/col start/end)."""
    bbox: List[float] = field(default_factory=list)       # (x1, y1, x2, y2)
    logit_axis: List[int] = field(default_factory=list)    # (row_s, row_e, col_s, col_e)
    text: str = ""
    score: float = 1.0

    @property
    def start_row(self) -> int:
        return int(self.logit_axis[0]) if self.logit_axis else 0

    @property
    def end_row(self) -> int:
        return int(self.logit_axis[1]) if self.logit_axis else 0

    @property
    def start_col(self) -> int:
        return int(self.logit_axis[2]) if self.logit_axis else 0

    @property
    def end_col(self) -> int:
        return int(self.logit_axis[3]) if self.logit_axis else 0


@dataclass
class TableEval:
    """A table's worth of eval cells, prediction or ground truth."""
    image_name: str = ""
    units: List[TableUnit] = field(default_factory=list)

    def bboxes(self) -> np.ndarray:
        if not self.units:
            return np.zeros((0, 4), dtype=np.float64)
        return np.asarray([u.bbox for u in self.units], dtype=np.float64)

    def axes(self) -> np.ndarray:
        if not self.units:
            return np.zeros((0, 4), dtype=np.int64)
        return np.asarray([u.logit_axis for u in self.units], dtype=np.int64)
