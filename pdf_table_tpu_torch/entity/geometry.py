"""Geometric primitives (counterpart of ``Point`` in
pdf_table_tpu/entity/geometry.py; the line algebra there serves the
classical extraction layer, which is not ported)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Point:
    x: float
    y: float
    is_joint: bool = False
