"""Geometric primitives (counterpart of ``Point`` in
pdf_table_tpu/entity/geometry.py). The line algebra there is not copied:
nothing the port runs uses it, the classical extraction (``pdf_table/``,
``read_pdf``) included."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Point:
    x: float
    y: float
    is_joint: bool = False
