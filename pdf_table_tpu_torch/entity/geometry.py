"""Geometric primitives (counterpart of pdf_table_tpu/entity/geometry.py):
``Point``, ``LineInterval`` and ``Line`` with the tolerance-based merge
algebra of the reference's ``entity/table_entity.py:41-261``, and the
vectorised numpy union ``Line.merge_segments_1d``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .enums import LineDirectionType


@dataclass
class Point:
    x: float
    y: float
    is_joint: bool = False

    def __repr__(self) -> str:  # concise, rounded
        return f"<Point x={round(self.x)} y={round(self.y)} joint={self.is_joint}>"

    def to_tuple(self) -> Tuple[float, float]:
        return (self.x, self.y)

    def key(self) -> str:
        return f"{round(self.x)}_{round(self.y)}"

    def scaled(self, factors: Tuple[float, float, float]) -> "Point":
        """PDF->image scale: factors = (sx, sy, img_height)."""
        sx, _sy, img_h = factors
        return Point(x=self.x * sx, y=abs(self.y - img_h) * sx, is_joint=self.is_joint)


@dataclass
class LineInterval:
    start: float
    end: float

    def __post_init__(self):
        if self.start > self.end:
            self.start, self.end = self.end, self.start

    def __repr__(self) -> str:
        return f"<LineInterval [{self.start}, {self.end}]>"

    @staticmethod
    def merge_two(a: "LineInterval", b: "LineInterval") -> "LineInterval":
        return LineInterval(min(a.start, b.start), max(a.end, b.end))

    @staticmethod
    def intersects(a: "LineInterval", b: "LineInterval") -> bool:
        return max(a.start, b.start) <= min(a.end, b.end)

    @staticmethod
    def merge_all(intervals: Sequence["LineInterval"]) -> List["LineInterval"]:
        """Union of overlapping intervals (classic sweep)."""
        if not intervals:
            return []
        out: List[LineInterval] = []
        for iv in sorted(intervals, key=lambda v: v.start):
            if not out or out[-1].end < iv.start:
                out.append(LineInterval(iv.start, iv.end))
            else:
                out[-1].end = max(out[-1].end, iv.end)
        return out


@dataclass
class Line:
    left: Point
    right: Point
    direction: LineDirectionType = LineDirectionType.NONE
    width: float = 0.0
    height: float = 0.0

    def __repr__(self) -> str:
        return (f"<Line left={self.left.to_tuple()} right={self.right.to_tuple()} "
                f"direction={self.direction}>")

    @property
    def min_x(self) -> float:
        return min(self.left.x, self.right.x)

    @property
    def max_x(self) -> float:
        return max(self.left.x, self.right.x)

    @property
    def min_y(self) -> float:
        return min(self.left.y, self.right.y)

    @property
    def max_y(self) -> float:
        return max(self.left.y, self.right.y)

    @property
    def line_width(self) -> float:
        return self.max_x - self.min_x

    @property
    def line_height(self) -> float:
        return self.max_y - self.min_y

    def scaled(self, factors: Tuple[float, float, float]) -> "Line":
        return Line(left=self.left.scaled(factors), right=self.right.scaled(factors),
                    direction=self.direction, width=self.width, height=self.height)

    # --- merge algebra -----------------------------------------------------

    @staticmethod
    def merge_two(line1: "Line", line2: "Line",
                  direction: LineDirectionType = LineDirectionType.HORIZONTAL) -> "Line":
        if direction == LineDirectionType.HORIZONTAL:
            y = line1.min_y
            left = Point(min(line1.min_x, line2.min_x), y)
            right = Point(max(line1.max_x, line2.max_x), y)
            return Line(left, right, LineDirectionType.HORIZONTAL,
                        width=right.x - left.x, height=line1.height)
        x = line1.min_x
        left = Point(x, min(line1.min_y, line2.min_y))
        right = Point(x, max(line1.max_y, line2.max_y))
        return Line(left, right, LineDirectionType.VERTICAL,
                    width=line1.width, height=right.y - left.y)

    @staticmethod
    def can_merge(line1: "Line", line2: "Line", diff: float = 2.0,
                  direction: LineDirectionType = LineDirectionType.HORIZONTAL) -> bool:
        """True when the spans along the merge axis touch within tolerance."""
        if direction == LineDirectionType.HORIZONTAL:
            a0, a1, b0, b1 = line1.min_x, line1.max_x, line2.min_x, line2.max_x
        else:
            a0, a1, b0, b1 = line1.min_y, line1.max_y, line2.min_y, line2.max_y
        return not (b1 < a0 - diff or b0 > a1 + diff)

    @staticmethod
    def merge_lines(lines: List["Line"], diff: float = 2.0,
                    direction: LineDirectionType = LineDirectionType.HORIZONTAL) -> List["Line"]:
        """Sweep-merge collinear segments that overlap within ``diff``.

        Caller is responsible for grouping lines by their fixed coordinate
        (same row for horizontal, same column for vertical) before calling.
        """
        if not lines:
            return []
        key = (lambda l: l.min_x) if direction == LineDirectionType.HORIZONTAL \
            else (lambda l: l.min_y)
        ordered = sorted(lines, key=key)
        out: List[Line] = []
        last = ordered[0]
        for nxt in ordered[1:]:
            if Line.can_merge(last, nxt, diff=diff, direction=direction):
                last = Line.merge_two(last, nxt, direction=direction)
            else:
                out.append(last)
                last = nxt
        out.append(last)
        return out

    # --- vectorized batch helpers ------------------------------------------

    @staticmethod
    def merge_segments_1d(segments: np.ndarray, diff: float = 2.0) -> np.ndarray:
        """Vectorized union of (N, 2) [start, end] segments with tolerance.

        Returns an (M, 2) array of merged segments. Used by the classical
        table layer where thousands of morphological segments are merged.
        """
        seg = np.asarray(segments, dtype=np.float64)
        if seg.size == 0:
            return seg.reshape(0, 2)
        seg = np.sort(seg, axis=1)
        order = np.argsort(seg[:, 0], kind="stable")
        seg = seg[order]
        # new group starts where start > running max end + diff
        ends = np.maximum.accumulate(seg[:, 1])
        breaks = np.empty(len(seg), dtype=bool)
        breaks[0] = True
        breaks[1:] = seg[1:, 0] > ends[:-1] + diff
        group = np.cumsum(breaks) - 1
        n_groups = group[-1] + 1
        starts = np.full(n_groups, np.inf)
        stops = np.full(n_groups, -np.inf)
        np.minimum.at(starts, group, seg[:, 0])
        np.maximum.at(stops, group, seg[:, 1])
        return np.stack([starts, stops], axis=1)
