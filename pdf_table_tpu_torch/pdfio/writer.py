"""Minimal PDF writer (a copy of pdf_table_tpu/pdfio/writer.py; the two
write the same bytes).

Generates real PDFs (text with base-14 fonts, stroked/filled paths, tables,
embedded JPEG images, optional Flate compression) for the test suite and
the synthetic benchmark corpus. Coordinates are PDF user space (y up).
"""

from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple

# Helvetica width table (WinAnsi codes 32..126), thousandths of em — used to
# position/measure text without a reader round-trip.
_HELV_W = {
    " ": 278, "!": 278, '"': 355, "#": 556, "$": 556, "%": 889, "&": 667,
    "'": 191, "(": 333, ")": 333, "*": 389, "+": 584, ",": 278, "-": 333,
    ".": 278, "/": 278, "0": 556, "1": 556, "2": 556, "3": 556, "4": 556,
    "5": 556, "6": 556, "7": 556, "8": 556, "9": 556, ":": 278, ";": 278,
    "<": 584, "=": 584, ">": 584, "?": 556, "@": 1015, "A": 667, "B": 667,
    "C": 722, "D": 722, "E": 667, "F": 611, "G": 778, "H": 722, "I": 278,
    "J": 500, "K": 667, "L": 556, "M": 833, "N": 722, "O": 778, "P": 667,
    "Q": 778, "R": 722, "S": 667, "T": 611, "U": 722, "V": 667, "W": 944,
    "X": 667, "Y": 667, "Z": 611, "[": 278, "\\": 278, "]": 278, "^": 469,
    "_": 556, "`": 333, "a": 556, "b": 556, "c": 500, "d": 556, "e": 556,
    "f": 278, "g": 556, "h": 556, "i": 222, "j": 222, "k": 500, "l": 222,
    "m": 833, "n": 556, "o": 556, "p": 556, "q": 556, "r": 333, "s": 500,
    "t": 278, "u": 556, "v": 500, "w": 722, "x": 500, "y": 500, "z": 500,
    "{": 334, "|": 260, "}": 334, "~": 584,
}


def text_width(text: str, size: float) -> float:
    return sum(1000 if ord(ch) > 0xFF else _HELV_W.get(ch, 556)
               for ch in text) * size / 1000.0


def _esc(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def _ttf_metrics(ttf: bytes):
    """(ascent, descent, widths[32..255]) in 1000-unit glyph space,
    measured by rendering the font at 1000 px with PIL/FreeType —
    accurate enough for the reader's advance-width text metrics."""
    import io as _io

    try:
        from PIL import ImageFont

        f = ImageFont.truetype(_io.BytesIO(ttf), 1000)
        ascent, descent = f.getmetrics()
        widths = []
        for code in range(32, 256):
            try:
                widths.append(int(round(f.getlength(chr(code)))))
            except (ValueError, OSError, UnicodeDecodeError):
                widths.append(500)
        return int(ascent), int(descent), widths
    except Exception:
        return 800, 200, [500] * 224


def _is_latin1(s: str) -> bool:
    try:
        s.encode("latin-1")
        return True
    except UnicodeEncodeError:
        return False


class _PageBuf:
    def __init__(self, width: float, height: float):
        self.width = width
        self.height = height
        self.ops: List[str] = []
        self.images: List[Tuple[str, bytes, int, int]] = []  # name, jpeg, w, h
        self.cid_chars: set = set()   # non-latin-1 chars (ToUnicode bfchars)

    def text(self, x: float, y: float, s: str, size: float = 12.0,
             font: str = "F1") -> None:
        """Draw text. Latin-1 strings use the simple Helvetica fonts;
        anything else (CJK etc.) routes through the document's Type0
        Identity-H font /FC as a UTF-16BE hex string — CID == BMP
        codepoint, with a ToUnicode CMap so extraction (pdfio/native
        fonts.cc parse_tounicode) round-trips the exact text."""
        if _is_latin1(s):
            self.ops.append(
                f"BT /{font} {size:g} Tf {x:g} {y:g} Td ({_esc(s)}) Tj ET")
            return
        # EVERY char of a CID-routed string needs a ToUnicode entry —
        # including its ASCII part (a mixed "混合 mixed" string routes
        # whole)
        self.cid_chars.update(s)
        hexstr = s.encode("utf-16-be").hex().upper()
        self.ops.append(
            f"BT /FC {size:g} Tf {x:g} {y:g} Td <{hexstr}> Tj ET")

    def line(self, x0: float, y0: float, x1: float, y1: float,
             lw: float = 1.0) -> None:
        self.ops.append(f"{lw:g} w {x0:g} {y0:g} m {x1:g} {y1:g} l S")

    def rect(self, x: float, y: float, w: float, h: float, lw: float = 1.0,
             fill: bool = False) -> None:
        op = "f" if fill else "S"
        self.ops.append(f"{lw:g} w {x:g} {y:g} {w:g} {h:g} re {op}")

    def image(self, jpeg_bytes: bytes, x: float, y: float, w: float, h: float,
              px_w: int, px_h: int) -> None:
        name = f"Im{len(self.images)}"
        self.images.append((name, jpeg_bytes, px_w, px_h))
        self.ops.append(f"q {w:g} 0 0 {h:g} {x:g} {y:g} cm /{name} Do Q")

    def table(self, x: float, y_top: float, col_widths: Sequence[float],
              row_height: float, cells: Sequence[Sequence[str]],
              size: float = 10.0, lw: float = 0.8) -> Tuple[float, float, float, float]:
        """Draw a ruled (wired) table; cells[r][c] text. Returns bbox."""
        n_rows = len(cells)
        n_cols = len(col_widths)
        total_w = float(sum(col_widths))
        total_h = n_rows * row_height
        y0 = y_top - total_h
        # grid
        for r in range(n_rows + 1):
            self.line(x, y_top - r * row_height, x + total_w, y_top - r * row_height, lw)
        cx = x
        for c in range(n_cols + 1):
            self.line(cx, y0, cx, y_top, lw)
            if c < n_cols:
                cx += col_widths[c]
        # text (left-aligned with padding, vertically centered-ish)
        for r, row in enumerate(cells):
            cx = x
            for c in range(n_cols):
                if c < len(row) and row[c]:
                    ty = y_top - (r + 1) * row_height + (row_height - size) * 0.5 + 2
                    self.text(cx + 3, ty, str(row[c]), size=size)
                cx += col_widths[c]
        return (x, y0, x + total_w, y_top)

    def content(self) -> bytes:
        return ("\n".join(self.ops) + "\n").encode("latin-1", errors="replace")


class PdfWriter:
    """Build a multi-page PDF. ``compress=True`` Flate-encodes content."""

    def __init__(self, compress: bool = True):
        self.pages: List[_PageBuf] = []
        self.compress = compress
        # name -> raw TrueType bytes, embedded as FontFile2 (simple
        # /TrueType fonts with WinAnsi /Widths so the native reader's
        # metric path, fonts.cc /FirstChar+/Widths, works unchanged).
        self.embedded_fonts: dict = {}

    def embed_font(self, name: str, source) -> str:
        """Embed a TrueType font program under resource name ``name``.

        ``source`` is a .ttf path or raw bytes. Pages select it with
        ``page.text(..., font=name)`` (latin-1 text only). Its metrics
        are measured with PIL where PIL imports (fixed defaults
        otherwise); render.py's text layer draws with the program itself.
        """
        data = source if isinstance(source, (bytes, bytearray)) else \
            open(source, "rb").read()
        self.embedded_fonts[name] = bytes(data)
        return name

    def add_page(self, width: float = 612.0, height: float = 792.0) -> _PageBuf:
        p = _PageBuf(width, height)
        self.pages.append(p)
        return p

    def tobytes(self) -> bytes:
        objs: List[bytes] = []  # 1-indexed

        def add(obj: bytes) -> int:
            objs.append(obj)
            return len(objs)

        font_id = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
        font_bold_id = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold >>")

        # embedded TrueType fonts (FontFile2 + descriptor + /Widths)
        emb_font_ids = {}
        for name, ttf in self.embedded_fonts.items():
            ff_id = add(
                (f"<< /Length {len(ttf)} /Length1 {len(ttf)} >>\n"
                 "stream\n").encode() + ttf + b"\nendstream")
            ascent, descent, widths = _ttf_metrics(ttf)
            desc_id = add(
                (f"<< /Type /FontDescriptor /FontName /{name} /Flags 32 "
                 f"/FontBBox [-200 {-descent} 1200 {ascent}] "
                 f"/ItalicAngle 0 /Ascent {ascent} /Descent {-descent} "
                 f"/CapHeight {ascent} /StemV 80 "
                 f"/FontFile2 {ff_id} 0 R >>").encode())
            w_str = " ".join(str(w) for w in widths)
            emb_font_ids[name] = add(
                (f"<< /Type /Font /Subtype /TrueType /BaseFont /{name} "
                 f"/FirstChar 32 /LastChar 255 /Widths [{w_str}] "
                 f"/Encoding /WinAnsiEncoding "
                 f"/FontDescriptor {desc_id} 0 R >>").encode())

        # Type0 Identity-H font for non-latin-1 text (CID == BMP
        # codepoint); emitted only when a page used it. ToUnicode bfchar
        # blocks cover exactly the chars written (<=100 entries per block
        # per the CMap spec).
        cid_chars = sorted({c for pg in self.pages for c in pg.cid_chars})
        cid_font_id = 0
        if cid_chars:
            cidf_id = add(
                b"<< /Type /Font /Subtype /CIDFontType2 /BaseFont /DejaVuSans"
                b" /CIDSystemInfo << /Registry (Adobe) /Ordering (Identity)"
                b" /Supplement 0 >> /DW 1000 /CIDToGIDMap /Identity >>")
            blocks = []
            for s in range(0, len(cid_chars), 100):
                chunk = cid_chars[s:s + 100]
                rows = "\n".join(f"<{ord(c):04X}> <{ord(c):04X}>"
                                 for c in chunk)
                blocks.append(f"{len(chunk)} beginbfchar\n{rows}\n"
                              f"endbfchar")
            cmap = ("/CIDInit /ProcSet findresource begin\n"
                    "12 dict begin\nbegincmap\n"
                    "/CMapName /Adobe-Identity-UCS def /CMapType 2 def\n"
                    "1 begincodespacerange\n<0000> <FFFF>\n"
                    "endcodespacerange\n"
                    + "\n".join(blocks)
                    + "\nendcmap\nCMapName currentdict /CMap defineresource"
                    " pop\nend\nend\n").encode()
            tounicode_id = add(
                (f"<< /Length {len(cmap)} >>\nstream\n").encode()
                + cmap + b"\nendstream")
            cid_font_id = add(
                (f"<< /Type /Font /Subtype /Type0 /BaseFont /DejaVuSans"
                 f" /Encoding /Identity-H /DescendantFonts [{cidf_id} 0 R]"
                 f" /ToUnicode {tounicode_id} 0 R >>").encode())

        page_ids = []
        kids_placeholder = add(b"")  # pages root; patched later
        for pg in self.pages:
            img_refs = []
            for name, jpeg, pw, ph in pg.images:
                img_obj = (f"<< /Type /XObject /Subtype /Image /Width {pw} "
                           f"/Height {ph} /ColorSpace /DeviceRGB "
                           f"/BitsPerComponent 8 /Filter /DCTDecode "
                           f"/Length {len(jpeg)} >>\nstream\n").encode() + jpeg + b"\nendstream"
                img_refs.append((name, add(img_obj)))
            data = pg.content()
            if self.compress:
                comp = zlib.compress(data)
                cont = (f"<< /Length {len(comp)} /Filter /FlateDecode >>\nstream\n"
                        ).encode() + comp + b"\nendstream"
            else:
                cont = (f"<< /Length {len(data)} >>\nstream\n").encode() + data + b"\nendstream"
            cont_id = add(cont)
            xobj = ""
            if img_refs:
                xobj = "/XObject << " + " ".join(
                    f"/{n} {i} 0 R" for n, i in img_refs) + " >>"
            fonts = f"/F1 {font_id} 0 R /F2 {font_bold_id} 0 R"
            if cid_font_id:
                fonts += f" /FC {cid_font_id} 0 R"
            for name, fid in emb_font_ids.items():
                fonts += f" /{name} {fid} 0 R"
            page_obj = (f"<< /Type /Page /Parent {kids_placeholder} 0 R "
                        f"/MediaBox [0 0 {pg.width:g} {pg.height:g}] "
                        f"/Resources << /Font << {fonts} >> {xobj} >> "
                        f"/Contents {cont_id} 0 R >>").encode()
            page_ids.append(add(page_obj))

        kids = " ".join(f"{i} 0 R" for i in page_ids)
        objs[kids_placeholder - 1] = (
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>").encode()
        catalog_id = add(f"<< /Type /Catalog /Pages {kids_placeholder} 0 R >>".encode())

        out = bytearray(b"%PDF-1.5\n%\xc3\xa4\xc3\xbc\xc3\xb6\n")
        offsets = [0]
        for i, obj in enumerate(objs, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
        xref_off = len(out)
        out += f"xref\n0 {len(objs) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += f"{off:010d} 00000 n \n".encode()
        out += (f"trailer\n<< /Size {len(objs) + 1} /Root {catalog_id} 0 R >>\n"
                f"startxref\n{xref_off}\n%%EOF\n").encode()
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.tobytes())
