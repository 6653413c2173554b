"""Rasterize a parsed PDF page to an RGB numpy image (counterpart of
pdf_table_tpu/pdfio/render.py, without cv2).

The page is drawn in the JAX renderer's three layers:

1. embedded images, each resized to its placement box with OpenCV's
   ``INTER_AREA`` arithmetic (``ops/crop_resize.py::resize_area_u8_plain``).
   Raw samples (8-bit RGB or grey, 1-bit) are decoded in numpy; an encoded
   stream (``/DCTDecode`` JPEG, ``/JPXDecode`` JPEG 2000: a scanned page)
   through ``utils/image_io.py::decode_image`` (PIL), which decodes as
   ``cv2.imdecode`` does, and in the codestream's own colours. A stream
   that does not decode (CCITT, JBIG2, broken bytes) is skipped, as the
   JAX renderer skips ``cv2.imdecode``'s None;
2. rects, lines and polylines, with OpenCV's drawing arithmetic
   (``draw.py``);
3. text, through PIL's FreeType (the page's embedded font programs, else
   DejaVu).

:func:`render_page_vector` is layers 1 and 2 and needs PIL only for an
encoded image; :func:`render_page` adds layer 3. On a host without PIL, a
page with an encoded image or visible text raises an ``ImportError``
naming PIL: the renderer never returns a page without its scan or its
glyphs. Both are bit-equal to the JAX renderer (and its drawing before
the text step) on OpenCV 5.0.0 and PIL's FreeType
(tests/test_torch_pdfio.py, tests/test_torch_scanned_pdf.py).
:func:`render_pdf` renders a document's pages with :func:`render_page`, or
through an external Ghostscript binary, as the JAX package's does.
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple

import numpy as np

from ..ops.crop_resize import resize_area_u8_plain
from ..utils.image_io import decode_image, read_image
from . import draw
from .reader import PdfDocument, PdfPage

_FONT_CANDIDATES = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
]
_font_cache = {}


def _import_pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError(
            "render_page draws the text layer with PIL (Pillow), which this "
            "host lacks; render_page_vector draws the vector content and "
            "raw-sample images without it") from e
    return Image, ImageDraw, ImageFont


def _decode_encoded(data: bytes, page: PdfPage, im) -> Optional[np.ndarray]:
    """An encoded image stream -> (h, w, 3) uint8, or None where it does
    not decode; an ``ImportError`` naming PIL where PIL is missing."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"page {page.index} carries an encoded image (object "
            f"{im.obj_num}, {im.filter}): the renderer decodes it with PIL "
            f"(Pillow), which this host lacks") from e
    return decode_image(data)


def _get_font(px_size: int):
    _, _, ImageFont = _import_pil()
    px_size = max(4, min(256, int(round(px_size))))
    if px_size in _font_cache:
        return _font_cache[px_size]
    font = None
    for path in _FONT_CANDIDATES:
        if os.path.exists(path):
            try:
                font = ImageFont.truetype(path, px_size)
                break
            except OSError:
                continue
    if font is None:
        font = ImageFont.load_default()
    _font_cache[px_size] = font
    return font


class _PageFonts:
    """One page's fonts: the embedded FontFile/FontFile2/FontFile3
    programs (``PdfDocument.get_font_program``) loaded with FreeType, else
    the DejaVu substitute."""

    def __init__(self, doc, page_index: int):
        self._doc = doc
        self._page_index = page_index
        self._programs = {}   # base name -> bytes | None
        self._fonts = {}      # (name, px) -> ImageFont

    def get(self, name: str, px_size: float):
        px = max(4, min(256, int(round(px_size))))
        key = (name, px)
        if key in self._fonts:
            return self._fonts[key]
        font = None
        if self._doc is not None and name:
            if name not in self._programs:
                try:
                    data, _fmt = self._doc.get_font_program(
                        self._page_index, name)
                except Exception:
                    data = b""
                self._programs[name] = data or None
            data = self._programs[name]
            if data:
                _, _, ImageFont = _import_pil()
                try:
                    font = ImageFont.truetype(io.BytesIO(data), px)
                except (OSError, ValueError):
                    self._programs[name] = None   # unloadable: stop retrying
        if font is None:
            font = _get_font(px)
        self._fonts[key] = font
        return font


def _decode_raw(data: bytes, im) -> np.ndarray:
    """Raw samples -> (h, w, 3) uint8, or None (the JAX renderer's
    rules)."""
    if im.width <= 0 or im.height <= 0:
        return None
    if im.bpc == 8:
        n = im.width * im.height
        if len(data) >= 3 * n:
            return np.frombuffer(data[:3 * n], dtype=np.uint8).reshape(
                im.height, im.width, 3)
        if len(data) >= n:
            g = np.frombuffer(data[:n], dtype=np.uint8).reshape(
                im.height, im.width)
            return np.stack([g] * 3, axis=-1)
    elif im.bpc == 1:
        bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        row_bits = ((im.width + 7) // 8) * 8
        if len(bits) >= row_bits * im.height:
            g = bits[:row_bits * im.height].reshape(im.height, row_bits)
            g = (g[:, :im.width] * 255).astype(np.uint8)
            return np.stack([g] * 3, axis=-1)
    return None


def _page_transform(page: PdfPage, dpi: int):
    scale = dpi / 72.0
    w_px = max(1, int(round(page.width * scale)))
    h_px = max(1, int(round(page.height * scale)))

    def to_px(x, y):
        # pdf y-up -> image y-down
        return ((x - page.media_box[0]) * scale,
                h_px - (y - page.media_box[1]) * scale)

    return scale, w_px, h_px, to_px


def render_page_vector(doc: PdfDocument, page: PdfPage, dpi: int = 144,
                       background: int = 255) -> np.ndarray:
    """Layers 1 and 2: -> uint8 RGB image (H, W, 3), y axis down."""
    scale, w_px, h_px, to_px = _page_transform(page, dpi)
    img = np.full((h_px, w_px, 3), background, dtype=np.uint8)

    # 1. embedded images (bottom layer); needs the doc for stream access
    for im in (page.images if doc is not None else []):
        if im.obj_num < 0:
            continue
        data, kind = doc.get_image_bytes(im.obj_num)
        if not data:
            continue
        decoded = _decode_encoded(data, page, im) if kind == 1 \
            else _decode_raw(data, im)
        if decoded is None:
            continue
        x0, y1 = to_px(im.bbox[0], im.bbox[1])
        x1, y0 = to_px(im.bbox[2], im.bbox[3])
        xi0, yi0 = max(0, int(round(x0))), max(0, int(round(y0)))
        xi1, yi1 = min(w_px, int(round(x1))), min(h_px, int(round(y1)))
        if xi1 - xi0 < 1 or yi1 - yi0 < 1:
            continue
        img[yi0:yi1, xi0:xi1] = resize_area_u8_plain(decoded, yi1 - yi0,
                                                     xi1 - xi0)

    # 2. vector content
    for r in page.rects:
        x0, yb = to_px(r.bbox[0], r.bbox[1])
        x1, yt = to_px(r.bbox[2], r.bbox[3])
        p0 = (int(round(x0)), int(round(yt)))
        p1 = (int(round(x1)), int(round(yb)))
        if r.filled and not r.stroked:
            # filled rects: thin ones are rules; large ones shade — draw gray
            area_frac = abs((x1 - x0) * (yb - yt)) / float(w_px * h_px)
            color = (0, 0, 0) if min(abs(x1 - x0), abs(yb - yt)) <= 4 * scale \
                else (200, 200, 200) if area_frac < 0.9 else (255, 255, 255)
            draw.rectangle(img, p0, p1, color, thickness=-1)
        if r.stroked:
            lw = max(1, int(round(r.lw * scale)))
            draw.rectangle(img, p0, p1, (0, 0, 0), thickness=lw)
    for s in page.segs:
        x0, y0 = to_px(s.x0, s.y0)
        x1, y1 = to_px(s.x1, s.y1)
        lw = max(1, int(round(s.lw * scale)))
        draw.line(img, (int(round(x0)), int(round(y0))),
                  (int(round(x1)), int(round(y1))), (0, 0, 0), thickness=lw)
    for c in page.curves:
        if len(c) >= 2:
            pts = np.stack([to_px(x, y) for x, y in c]).round().astype(
                np.int32)
            draw.polylines(img, pts, False, (0, 0, 0),
                           thickness=max(1, int(scale)))
    return img


def draw_text_layer(img: np.ndarray, doc: PdfDocument, page: PdfPage,
                    dpi: int = 144) -> np.ndarray:
    """Layer 3 over ``img`` (layers 1 and 2 of the same page and dpi):
    the page's visible text through PIL."""
    Image, ImageDraw, _ = _import_pil()
    scale, _, _, to_px = _page_transform(page, dpi)
    pil = Image.fromarray(img)
    canvas = ImageDraw.Draw(pil)
    page_fonts = _PageFonts(doc, page.index)
    for t in page.texts:
        if t.invisible or not t.text.strip():
            continue
        px_size = t.size * scale
        font = page_fonts.get(t.font, px_size)
        # draw anchored at the baseline origin
        x, y = to_px(t.origin[0], t.origin[1])
        if t.is_horizontal:
            try:
                canvas.text((x, y), t.text, fill=(0, 0, 0), font=font,
                            anchor="ls")
            except (ValueError, OSError):
                canvas.text((x, y - px_size), t.text, fill=(0, 0, 0),
                            font=font)
        else:
            # vertical/rotated text: rasterize horizontally then rotate
            try:
                tw = int(canvas.textlength(t.text, font=font)) + 4
            except (ValueError, OSError):
                tw = int(px_size * len(t.text)) + 4
            th = int(px_size * 1.4) + 4
            tile = Image.new("RGB", (max(tw, 1), max(th, 1)),
                             (255, 255, 255))
            ImageDraw.Draw(tile).text((0, 0), t.text, fill=(0, 0, 0),
                                      font=font)
            angle = np.degrees(np.arctan2(t.direction[1], t.direction[0]))
            tile = tile.rotate(angle, expand=True, fillcolor=(255, 255, 255))
            pil.paste(tile, (int(x), int(y - tile.height)),
                      mask=tile.convert("L").point(lambda v: 255 - v))
    return np.asarray(pil)


def render_page(doc: PdfDocument, page: PdfPage, dpi: int = 144,
                background: int = 255) -> np.ndarray:
    """-> uint8 RGB image (H, W, 3), y axis down: the three layers. A page
    with visible text needs PIL (an ``ImportError`` naming it otherwise)."""
    img = render_page_vector(doc, page, dpi=dpi, background=background)
    if not any(not t.invisible and t.text.strip() for t in page.texts):
        return img
    return draw_text_layer(img, doc, page, dpi=dpi)


def _ghostscript_binary() -> Optional[str]:
    """An external rasterizer binary, or None: ``PDFTABLE_GS_BINARY``
    where it is set (None if that file does not exist), else ``gs`` on
    PATH."""
    import shutil

    override = os.environ.get("PDFTABLE_GS_BINARY")
    if override:
        return override if os.path.exists(override) else None
    return shutil.which("gs")


def _render_pdf_ghostscript(path_or_bytes, dpi: int,
                            pages: Optional[List[int]], gs_bin: str
                            ) -> List[Tuple[int, np.ndarray]]:
    """Rasterize through a Ghostscript subprocess (``png16m`` at
    ``-r<dpi>``); its PNGs read through ``utils/image_io.py``. Raises on
    a failure: ``render_pdf``'s ``"auto"`` falls back to the native
    renderer."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pdfio_gs_") as td:
        if isinstance(path_or_bytes, (bytes, bytearray)):
            src = os.path.join(td, "in.pdf")
            with open(src, "wb") as f:
                f.write(path_or_bytes)
        else:
            src = os.fspath(path_or_bytes)
        out_pat = os.path.join(td, "page-%04d.png")
        cmd = [gs_bin, "-q", "-dNOPAUSE", "-dBATCH", "-dSAFER",
               "-sDEVICE=png16m", f"-r{int(dpi)}",
               f"-sOutputFile={out_pat}", src]
        subprocess.run(cmd, check=True, timeout=600,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        rendered = sorted(f for f in os.listdir(td) if f.startswith("page-"))
        if not rendered:
            raise RuntimeError("ghostscript produced no pages")
        idxs = pages if pages is not None else range(len(rendered))
        out = []
        for i in idxs:
            if i >= len(rendered):
                continue
            rgb = read_image(os.path.join(td, rendered[i]))
            if rgb is None:
                raise RuntimeError(f"unreadable gs output page {i}")
            out.append((i, rgb))
        return out


def render_pdf(path_or_bytes, dpi: int = 144,
               pages: Optional[List[int]] = None, backend: str = "auto"
               ) -> List[Tuple[int, np.ndarray]]:
    """A document's pages as ``(page_index, RGB image)``. ``backend``:
    ``"ghostscript"`` renders through the external binary
    (:func:`_ghostscript_binary`; a ``RuntimeError`` without one, its
    failure raised); ``"auto"`` does so only under
    ``PDFTABLE_RENDER_BACKEND=ghostscript`` with a binary, and falls back
    to the native renderer (:func:`render_page`) where it fails; any
    other name renders natively."""
    want_gs = backend == "ghostscript" or (
        backend == "auto"
        and os.environ.get("PDFTABLE_RENDER_BACKEND") == "ghostscript")
    if want_gs:
        gs_bin = _ghostscript_binary()
        if gs_bin:
            try:
                return _render_pdf_ghostscript(path_or_bytes, dpi, pages,
                                               gs_bin)
            except Exception:
                if backend == "ghostscript":
                    raise
        elif backend == "ghostscript":
            raise RuntimeError("no ghostscript binary found "
                               "(set PDFTABLE_GS_BINARY or install gs)")
    out = []
    with PdfDocument.open(path_or_bytes) as doc:
        idxs = pages if pages is not None else range(doc.page_count)
        for i in idxs:
            out.append((i, render_page(doc, doc.load_page(i), dpi=dpi)))
    return out
