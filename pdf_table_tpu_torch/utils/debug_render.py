"""Annotated debug overlays (counterpart of
pdf_table_tpu/utils/debug_render.py): the detected text boxes, the
layout regions with their labels and the table-structure cells with
their logical coordinates, drawn onto a copy of the page raster.

The lines and rectangles are OpenCV 5.0.0's (``pdfio/draw.py``: the
8-connected line of thickness 1, the thick line's polygon and end
circles), so every pixel outside the labels equals JAX's overlay. The
labels are drawn in PIL's default font where JAX draws OpenCV's Hershey
simplex font, whose glyph tables the port does not carry: a label's
pixels differ from JAX's inside its box (:func:`text_box`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..pdfio import draw

COLORS = {"text": (60, 170, 60), "layout": (220, 120, 40),
          "table": (40, 90, 220), "cell": (200, 40, 40)}
# font px per unit of OpenCV's font scale (Hershey simplex is some 22 px
# high at scale 1, capitals and descenders)
FONT_PX_PER_SCALE = 28.0


@functools.lru_cache(maxsize=8)
def _font(px: int):
    from PIL import ImageFont

    try:
        return ImageFont.load_default(size=px)
    except (TypeError, OSError, ImportError):   # no FreeType: bitmap font
        return ImageFont.load_default()


def _px(scale: float) -> int:
    return max(6, int(round(FONT_PX_PER_SCALE * scale)))


def text_box(text: str, org: Tuple[int, int], scale: float
             ) -> Tuple[int, int, int, int]:
    """(x1, y1, x2, y2), inclusive, of the pixels a label drawn at
    ``org`` (its baseline's left end, as ``cv2.putText`` takes it) may
    paint."""
    from PIL import Image, ImageDraw

    d = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    x1, y1, x2, y2 = d.textbbox(org, text, font=_font(_px(scale)),
                                anchor="ls")
    return int(x1), int(y1), int(x2), int(y2)


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], scale: float,
             color) -> None:
    """Draw ``text`` with its baseline's left end at ``org``, in place."""
    from PIL import Image, ImageDraw

    x1, y1, x2, y2 = text_box(text, org, scale)
    h, w = img.shape[:2]
    cx1, cy1 = max(x1, 0), max(y1, 0)
    cx2, cy2 = min(x2 + 1, w), min(y2 + 1, h)
    if cx1 >= cx2 or cy1 >= cy2:
        return
    patch = Image.fromarray(np.ascontiguousarray(img[cy1:cy2, cx1:cx2]))
    ImageDraw.Draw(patch).text((org[0] - cx1, org[1] - cy1), text,
                               fill=tuple(int(c) for c in color),
                               font=_font(_px(scale)), anchor="ls")
    img[cy1:cy2, cx1:cx2] = np.asarray(patch)


def render_debug_overlay(image: np.ndarray, text_cells=(),
                         layout_cells=(), table_results=()) -> np.ndarray:
    img = np.ascontiguousarray(image.copy())

    for c in text_cells:
        if getattr(c, "poly", None) is not None:
            pts = np.asarray(c.poly, np.int32).reshape(-1, 2)
            draw.polylines(img, pts, True, COLORS["text"], 1)
        else:
            x1, y1, x2, y2 = [int(v) for v in c.bbox]
            draw.rectangle(img, (x1, y1), (x2, y2), COLORS["text"], 1)

    for c in layout_cells:
        x1, y1, x2, y2 = [int(v) for v in c.bbox]
        label = getattr(c, "label", None) or (c.text or "")
        color = COLORS["table"] if label == "table" else COLORS["layout"]
        draw.rectangle(img, (x1, y1), (x2, y2), color, 2)
        if label:
            put_text(img, f"{label} {c.score:.2f}", (x1, max(y1 - 4, 10)),
                     0.45, color)

    for tb, result in table_results:
        ox, oy = result.get("offset", (0, 0))
        for cell in result.get("cells", []):
            x1, y1, x2, y2 = [int(v) for v in cell["bbox"]]
            draw.rectangle(img, (x1 + int(ox), y1 + int(oy)),
                           (x2 + int(ox), y2 + int(oy)), COLORS["cell"], 1)
            logic = cell.get("logic")
            if logic:
                put_text(img, f"{logic[0]},{logic[2]}",
                         (x1 + int(ox) + 2, y1 + int(oy) + 12), 0.35,
                         COLORS["cell"])
    return img
