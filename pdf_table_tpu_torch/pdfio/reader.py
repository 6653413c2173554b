"""ctypes bindings over the native libpdfio reader (counterpart of
pdf_table_tpu/pdfio/reader.py; the C++ sources in ``native/`` are the
port's own copy).

The shared library builds at first use with ``make`` and ``g++`` into
``native/build/`` (listed in ``.gitignore``), never beside the sources. Its
name carries a hash of the sources and the Makefile, so an edited source
rebuilds. All coordinates returned are PDF user space (origin bottom-left,
y up); helpers convert to image space.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = NATIVE_DIR / "build"
_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """``native/build/libpdfio-<hash>.so``, the hash over the sources and
    the Makefile."""
    h = hashlib.sha256()
    for f in sorted(NATIVE_DIR.iterdir()):
        if f.suffix in (".cc", ".h") or f.name == "Makefile":
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libpdfio-{h.hexdigest()[:12]}.so"


def build_native() -> Path:
    """Build the reader if its library is missing (objects in a directory
    of this process's own, so that concurrent builds do not collide)."""
    lib = library_path()
    if lib.exists():
        return lib
    obj_dir = BUILD_DIR / f"obj-{os.getpid()}"
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["make", "-C", str(NATIVE_DIR), "-j", f"BUILD={obj_dir}",
         f"TARGET={tmp}"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"pdfio: building the native reader failed:\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        lib.pdfio_open.restype = ctypes.c_void_p
        lib.pdfio_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_char_p)]
        lib.pdfio_close.argtypes = [ctypes.c_void_p]
        lib.pdfio_page_count.restype = ctypes.c_int
        lib.pdfio_page_count.argtypes = [ctypes.c_void_p]
        lib.pdfio_extract_page.restype = ctypes.c_void_p
        lib.pdfio_extract_page.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_char_p)]
        lib.pdfio_get_image.restype = ctypes.c_void_p
        lib.pdfio_get_image.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.pdfio_get_font_program.restype = ctypes.c_void_p
        lib.pdfio_get_font_program.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)]
        lib.pdfio_free.argtypes = [ctypes.c_void_p]
        lib.pdfio_version.restype = ctypes.c_char_p
        _lib = lib
        return _lib


@dataclass
class PdfText:
    text: str
    bbox: tuple            # (x0, y0, x1, y1) pdf space
    origin: tuple          # baseline start
    direction: tuple       # unit baseline direction
    size: float
    font: str
    adv: List[float]       # per-char advances (device units)
    invisible: bool = False

    @property
    def is_horizontal(self) -> bool:
        return abs(self.direction[0]) >= abs(self.direction[1])


@dataclass
class PdfSeg:
    x0: float
    y0: float
    x1: float
    y1: float
    lw: float = 1.0
    from_fill: bool = False

    @property
    def is_horizontal(self) -> bool:
        return abs(self.y1 - self.y0) <= abs(self.x1 - self.x0)


@dataclass
class PdfRect:
    bbox: tuple
    lw: float = 1.0
    stroked: bool = False
    filled: bool = False


@dataclass
class PdfImage:
    bbox: tuple
    obj_num: int
    width: int
    height: int
    bpc: int
    colorspace: str
    filter: str


@dataclass
class PdfPage:
    index: int
    media_box: tuple       # (x0, y0, x1, y1)
    rotate: int
    texts: List[PdfText] = field(default_factory=list)
    segs: List[PdfSeg] = field(default_factory=list)
    rects: List[PdfRect] = field(default_factory=list)
    curves: List[np.ndarray] = field(default_factory=list)
    images: List[PdfImage] = field(default_factory=list)

    @property
    def width(self) -> float:
        return self.media_box[2] - self.media_box[0]

    @property
    def height(self) -> float:
        return self.media_box[3] - self.media_box[1]

    def text_content(self) -> str:
        """Reading-order-ish plain text (top-to-bottom, left-to-right)."""
        items = [t for t in self.texts if t.text.strip()]
        items.sort(key=lambda t: (-round(t.bbox[1] / 2), t.bbox[0]))
        return " ".join(t.text for t in items)


class PdfDocument:
    """Parsed PDF. Usage::

        with PdfDocument.open("f.pdf") as doc:
            page = doc.load_page(0)
    """

    def __init__(self, handle, data: bytes):
        self._handle = handle
        self._data = data
        self._lib = _load_lib()
        self._page_count = self._lib.pdfio_page_count(handle)

    @classmethod
    def open(cls, path_or_bytes) -> "PdfDocument":
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        lib = _load_lib()
        err = ctypes.c_char_p()
        handle = lib.pdfio_open(data, len(data), ctypes.byref(err))
        if not handle:
            msg = err.value.decode() if err.value else "unknown error"
            if err.value:
                lib.pdfio_free(err)
            raise ValueError(f"pdfio: cannot open PDF: {msg}")
        return cls(handle, data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._handle:
            self._lib.pdfio_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def page_count(self) -> int:
        return self._page_count

    def load_page(self, index: int) -> PdfPage:
        err = ctypes.c_char_p()
        ptr = self._lib.pdfio_extract_page(self._handle, index, ctypes.byref(err))
        if not ptr:
            msg = err.value.decode() if err.value else "unknown"
            if err.value:
                self._lib.pdfio_free(err)
            raise ValueError(f"pdfio: extract page {index}: {msg}")
        raw = ctypes.string_at(ptr).decode("utf-8", errors="replace")
        self._lib.pdfio_free(ptr)
        d = json.loads(raw)
        page = PdfPage(index=index, media_box=tuple(d["media_box"]),
                       rotate=int(d["rotate"]))
        for t in d["texts"]:
            page.texts.append(PdfText(
                text=t["text"], bbox=tuple(t["bbox"]), origin=tuple(t["origin"]),
                direction=tuple(t["dir"]), size=t["size"], font=t["font"],
                adv=t["adv"], invisible=t.get("invisible", False)))
        for s in d["segs"]:
            p = s["p"]
            page.segs.append(PdfSeg(p[0], p[1], p[2], p[3], s.get("lw", 1.0),
                                    s.get("fill", False)))
        for r in d["rects"]:
            page.rects.append(PdfRect(tuple(r["bbox"]), r.get("lw", 1.0),
                                      r.get("stroked", False), r.get("filled", False)))
        for c in d["curves"]:
            page.curves.append(np.asarray(c, dtype=np.float64).reshape(-1, 2))
        for im in d["images"]:
            page.images.append(PdfImage(
                bbox=tuple(im["bbox"]), obj_num=int(im["obj"]),
                width=int(im["width"]), height=int(im["height"]),
                bpc=int(im["bpc"]), colorspace=im["colorspace"],
                filter=im["filter"]))
        return page

    def get_image_bytes(self, obj_num: int):
        """-> (bytes, kind) where kind 0 = raw decoded samples, 1 = encoded
        (e.g. JPEG for DCTDecode, which the port's renderer skips)."""
        n = ctypes.c_size_t()
        kind = ctypes.c_int()
        ptr = self._lib.pdfio_get_image(self._handle, obj_num,
                                        ctypes.byref(n), ctypes.byref(kind))
        if not ptr:
            return b"", 0
        data = ctypes.string_at(ptr, n.value)
        self._lib.pdfio_free(ptr)
        return data, kind.value

    def get_font_program(self, page_index: int, base_name: str):
        """-> (bytes, fmt) of a page font's EMBEDDED program, matched by
        its /BaseFont name (as carried on PdfText.font). fmt 2 =
        FontFile2 (TrueType), 3 = FontFile3 (CFF/OpenType), 1 = FontFile
        (Type1); (b'', 0) when the font is not embedded. Used by
        render.py's text layer."""
        n = ctypes.c_size_t()
        fmt = ctypes.c_int()
        ptr = self._lib.pdfio_get_font_program(
            self._handle, page_index, base_name.encode("utf-8"),
            ctypes.byref(n), ctypes.byref(fmt))
        if not ptr:
            return b"", 0
        data = ctypes.string_at(ptr, n.value)
        self._lib.pdfio_free(ptr)
        return data, fmt.value

    def is_imaged_pdf(self, sample_pages: int = 3, min_text_items: int = 5) -> bool:
        """True when the document is a scan: pages are dominated by one big
        image with little extracted text (reference behavior:
        PdfUtils.check_is_imaged_pdf_v2, utils/pdf_utils.py:1687)."""
        n = min(self.page_count, sample_pages)
        imaged = 0
        for i in range(n):
            page = self.load_page(i)
            big_image = any(
                (im.bbox[2] - im.bbox[0]) * (im.bbox[3] - im.bbox[1])
                > 0.5 * page.width * page.height
                for im in page.images)
            if big_image and len([t for t in page.texts if not t.invisible]) < min_text_items:
                imaged += 1
        return n > 0 and imaged == n


def parse_pages_spec(spec: Optional[str], page_count: int) -> List[int]:
    """'all' | '1,3,4' | '1,4-end' | '2-5' -> zero-based page indices."""
    if not spec or spec.strip().lower() == "all":
        return list(range(page_count))
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-", 1)
            start = int(a)
            end = page_count if b.strip().lower() == "end" else int(b)
            out.extend(range(start - 1, min(end, page_count)))
        else:
            idx = int(part) - 1
            if 0 <= idx < page_count:
                out.append(idx)
    seen = set()
    uniq = []
    for i in out:
        if i not in seen and 0 <= i < page_count:
            seen.add(i)
            uniq.append(i)
    return uniq
