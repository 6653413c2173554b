"""Recognized-content cells (counterpart of ``OcrCell`` in
pdf_table_tpu/entity/ocr_cell.py): a text line, image or table region
with its bbox, text and score, and the geometry the HTML assembly reads."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .enums import HtmlContentType
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
                 cell_type: HtmlContentType = HtmlContentType.NONE,
                 poly: Optional[np.ndarray] = None,
                 score: float = 1.0):
        self.left_top = left_top
        self.right_bottom = right_bottom
        self.text = text
        self.cell_type = cell_type
        self.poly = None if poly is None else np.asarray(poly, dtype=np.float32)
        self.score = float(score)

    @classmethod
    def from_bbox(cls, bbox: Sequence[float], text: Optional[str] = None,
                  cell_type: HtmlContentType = HtmlContentType.TXT,
                  score: float = 1.0) -> "OcrCell":
        return cls(left_top=Point(float(bbox[0]), float(bbox[1])),
                   right_bottom=Point(float(bbox[2]), float(bbox[3])),
                   text=text, cell_type=cell_type, score=score)

    @classmethod
    def from_poly(cls, poly: np.ndarray, text: Optional[str] = None,
                  cell_type: HtmlContentType = HtmlContentType.TXT,
                  score: float = 1.0) -> "OcrCell":
        p = np.asarray(poly, dtype=np.float32).reshape(-1, 2)
        return cls(left_top=Point(float(p[:, 0].min()), float(p[:, 1].min())),
                   right_bottom=Point(float(p[:, 0].max()),
                                      float(p[:, 1].max())),
                   text=text, cell_type=cell_type, poly=p, score=score)

    # -- geometry -------------------------------------------------------------

    @property
    def bbox(self) -> tuple:
        if self.left_top is None or self.right_bottom is None:
            return (0.0, 0.0, 0.0, 0.0)
        return (self.left_top.x, self.left_top.y, self.right_bottom.x,
                self.right_bottom.y)

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

    def __repr__(self) -> str:
        t = (self.text[:20] + "…") if self.text and len(self.text) > 20 \
            else self.text
        return (f"<OcrCell bbox=({self.x1:.0f},{self.y1:.0f},{self.x2:.0f},"
                f"{self.y2:.0f}) type={self.cell_type.name} text={t!r}>")
