"""The port's pdfio against the JAX package's: the reader field for field
(texts, segs, rects, curves, images, image bytes and font programs) on the
PDFs of tests/test_pdfio.py and on hand-built PDFs with raw-sample images
and curves; the writer byte for byte; ``render_page`` bit for bit on pages
with stroked and filled rects, thin and thick lines, polylines, raw RGB,
grey and 1-bit images and text (PIL with the DejaVu fonts); the
vector-and-image half (``render_page_vector``) bit for bit against the JAX
renderer's drawing before its text step (the same page with its text
removed; the embedded page's JPEG drawn on both sides). Also:
``render_page`` raises naming PIL when PIL cannot be imported, and the
port's OpenCV arithmetic (``pdfio/draw.py``,
``ops/crop_resize.py::resize_area_u8_plain``) equals ``cv2.line``,
``cv2.rectangle``, ``cv2.polylines`` and ``cv2.resize(INTER_AREA)`` on
seeded random cases, out-of-image points included."""

import os
import sys
import zlib

import cv2
import numpy as np
import pytest

from pdf_table_tpu.pdfio import PdfDocument as JDoc
from pdf_table_tpu.pdfio import PdfWriter as JWriter
from pdf_table_tpu.pdfio import render_page as jrender
from pdf_table_tpu_torch.ops.crop_resize import resize_area_u8_plain
from pdf_table_tpu_torch.pdfio import PdfDocument, PdfWriter, draw
from pdf_table_tpu_torch.pdfio import render_page, render_page_vector
from pdf_table_tpu_torch.pdfio.reader import library_path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

_SERIF_TTF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"


def _simple(writer_cls, compress=True):
    """tests/test_pdfio.py::make_simple_pdf, with either writer."""
    w = writer_cls(compress=compress)
    p = w.add_page(612, 792)
    p.text(72, 720, "Hello World", size=14)
    p.text(72, 700, "Second line with numbers 12345", size=10)
    p.line(72, 680, 540, 680, lw=1.5)
    p.rect(100, 500, 200, 100, lw=1.0)
    p2 = w.add_page(612, 792)
    p2.text(72, 720, "Page two", size=12)
    return w


def _vector(writer_cls):
    """Rects stroked and filled (a rule, a shade, a page-size fill), thin
    (one device pixel at 144 dpi) and thick lines, a diagonal, lines and a
    Bezier running off the page, CJK text, a wired table."""
    w = writer_cls()
    p = w.add_page(400, 300)
    p.rect(20, 20, 360, 260, lw=2.2)
    p.rect(40, 200, 120, 1.5, fill=True)
    p.rect(200, 40, 150, 90, fill=True)
    p.line(30, 280, 370, 150, lw=0.3)
    p.line(-20, 150, 420, 160, lw=0.8)
    p.line(60, -10, 70, 320, lw=1.7)
    p.ops.append("1.2 w 50 60 m 120 140 200 20 300 100 c S")
    p.ops.append("0.5 w 380 250 m 450 300 420 -40 360 40 c S")
    p.text(50, 250, "Mixed 中文 text", size=11)
    p.table(210, 270, [50, 60], 18, [["a", "b"], ["c", "d"]], size=9)
    q = w.add_page(300, 200)
    q.rect(-10, -10, 320, 220, fill=True)
    q.text(30, 100, "on a filled page", size=12)
    return w


def _jpeg(rgb):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _embedded(writer_cls):
    w = writer_cls()
    w.embed_font("EmbSerif", _SERIF_TTF)
    p = w.add_page(612, 792)
    p.text(72, 700, "Wlliam glyph fidelity", size=24, font="EmbSerif")
    p.text(72, 650, "substitute font", size=12)
    rng = np.random.default_rng(0)
    p.image(_jpeg(rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)),
            100, 400, 180, 120, 60, 40)
    return w


WRITERS = {"simple": _simple, "simple_raw": lambda c: _simple(c, False),
           "vector": _vector, "embedded": _embedded}


def raw_image_pdf(images, texts=(), flate=True) -> bytes:
    """A one-page 400x300 PDF with raw-sample image XObjects: ``images``
    [(samples bytes, width, height, bpc, colorspace, (x, y, w, h))]."""
    objs = [b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"]
    names, ops = [], []
    for k, (data, w, h, bpc, cs, (x, y, bw, bh)) in enumerate(images):
        body = zlib.compress(data) if flate else data
        filt = " /Filter /FlateDecode" if flate else ""
        objs.append((f"<< /Type /XObject /Subtype /Image /Width {w} "
                     f"/Height {h} /ColorSpace /{cs} /BitsPerComponent {bpc}"
                     f"{filt} /Length {len(body)} >>\nstream\n").encode()
                    + body + b"\nendstream")
        names.append((f"Im{k}", len(objs)))
        ops.append(f"q {bw:g} 0 0 {bh:g} {x:g} {y:g} cm /Im{k} Do Q")
    for x, y, s in texts:
        ops.append(f"BT /F1 10 Tf {x:g} {y:g} Td ({s}) Tj ET")
    content = ("\n".join(ops) + "\n").encode()
    objs.append(f"<< /Length {len(content)} >>\nstream\n".encode()
                + content + b"\nendstream")
    cont = len(objs)
    xobj = " ".join(f"/{n} {i} 0 R" for n, i in names)
    objs.append(f"<< /Type /Page /Parent {len(objs) + 2} 0 R /MediaBox "
                f"[0 0 400 300] /Resources << /Font << /F1 1 0 R >> "
                f"/XObject << {xobj} >> >> /Contents {cont} 0 R >>".encode())
    page = len(objs)
    objs.append(f"<< /Type /Pages /Kids [{page} 0 R] /Count 1 >>".encode())
    objs.append(f"<< /Type /Catalog /Pages {len(objs)} 0 R >>".encode())
    out = bytearray(b"%PDF-1.5\n")
    offs = []
    for i, o in enumerate(objs, start=1):
        offs.append(len(out))
        out += f"{i} 0 obj\n".encode() + o + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    for off in offs:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root {len(objs)} 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    return bytes(out)


def _raw_images_pdf(flate=True):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (64, 48), dtype=np.uint8)
    bits = np.packbits(rng.integers(0, 2, (21, 30), dtype=np.uint8), axis=1)
    return raw_image_pdf([
        (rgb.tobytes(), 53, 37, 8, "DeviceRGB", (10, 180, 150.3, 100)),
        (grey.tobytes(), 48, 64, 8, "DeviceGray", (200, 200, 24, 32)),
        (bits.tobytes(), 30, 21, 1, "DeviceGray", (220, 20, 120, 84)),
        (rgb.tobytes(), 53, 37, 8, "DeviceRGB", (300, 120, 53, 37))],
        texts=[(20, 20, "raw image page")], flate=flate)


def _doc_pairs():
    out = {name: fn(JWriter).tobytes() for name, fn in WRITERS.items()}
    out["raw_images"] = _raw_images_pdf()
    out["raw_images_plain"] = _raw_images_pdf(flate=False)
    return out


@pytest.fixture(scope="module")
def docs():
    if not os.path.exists(_SERIF_TTF):
        pytest.skip("the DejaVu serif font is not installed")
    return _doc_pairs()


def test_reader_builds_outside_the_sources():
    lib = library_path()
    PdfDocument.open(_simple(PdfWriter).tobytes()).close()
    assert lib.exists() and lib.parent.name == "build"
    assert not any(f.suffix in (".o", ".so")
                   for f in lib.parent.parent.iterdir())


@pytest.mark.parametrize("name", ["simple", "simple_raw", "vector",
                                  "embedded", "raw_images",
                                  "raw_images_plain"])
def test_reader_matches_jax_field_for_field(docs, name):
    data = docs[name]
    with JDoc.open(data) as jd, PdfDocument.open(data) as td:
        assert td.page_count == jd.page_count
        for i in range(jd.page_count):
            jp, tp = jd.load_page(i), td.load_page(i)
            assert (tp.index, tp.media_box, tp.rotate) == \
                (jp.index, jp.media_box, jp.rotate)
            assert [vars(t) for t in tp.texts] == [vars(t) for t in jp.texts]
            assert [vars(s) for s in tp.segs] == [vars(s) for s in jp.segs]
            assert [vars(r) for r in tp.rects] == [vars(r) for r in jp.rects]
            assert len(tp.curves) == len(jp.curves)
            for a, b in zip(tp.curves, jp.curves):
                np.testing.assert_array_equal(a, b)
            assert [vars(m) for m in tp.images] == \
                [vars(m) for m in jp.images]
            for m in jp.images:
                assert td.get_image_bytes(m.obj_num) == \
                    jd.get_image_bytes(m.obj_num)
            for font in {t.font for t in jp.texts}:
                assert td.get_font_program(i, font) == \
                    jd.get_font_program(i, font)
            assert tp.text_content() == jp.text_content()
        assert td.is_imaged_pdf() == jd.is_imaged_pdf()
    with PdfDocument.open(data) as td:
        page = td.load_page(0)
        if name == "vector":
            assert len(page.curves) == 2
        if name.startswith("raw_images"):
            assert [m.bpc for m in page.images] == [8, 8, 1, 8]
            drawn = render_page_vector(td, page)
            page.images = []
            assert (drawn != render_page_vector(td, page)).any(-1).sum() \
                > 50_000


def test_not_a_pdf_raises():
    with pytest.raises(ValueError, match="cannot open PDF"):
        PdfDocument.open(b"this is not a pdf at all")


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writer_bytes_equal_jax(docs, name):
    assert WRITERS[name](PdfWriter).tobytes() == docs[name]


def test_writer_bytes_equal_jax_on_the_golden_digital_cases(tmp_path,
                                                            monkeypatch):
    """The golden builders, once with JAX's writer and once with the
    port's."""
    import pdf_table_tpu.pdfio.writer as jw

    for name, build in cases.DIGITAL_CASES.items():
        want = open(build(str(tmp_path)), "rb").read()
        with monkeypatch.context() as m:
            m.setattr(jw, "PdfWriter", PdfWriter)
            got = open(build(str(tmp_path)), "rb").read()
        assert got == want, name


def _renders(data):
    with JDoc.open(data) as jd, PdfDocument.open(data) as td:
        for i in range(jd.page_count):
            jp, tp = jd.load_page(i), td.load_page(i)
            yield jd, jp, td, tp


@pytest.mark.parametrize("dpi", [144, 100])
@pytest.mark.parametrize("name", ["simple", "vector", "raw_images"])
def test_render_page_bit_equal_to_jax(docs, name, dpi):
    for jd, jp, td, tp in _renders(docs[name]):
        want = jrender(jd, jp, dpi=dpi)
        got = render_page(td, tp, dpi=dpi)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert (got < 128).any()


@pytest.mark.parametrize("name", ["vector", "raw_images", "embedded"])
def test_vector_half_equals_jax_before_its_text_step(docs, name):
    """JAX's drawing before its text step: the JAX renderer on the page
    with its texts removed (the embedded page's JPEG drawn by both)."""
    for jd, jp, td, tp in _renders(docs[name]):
        jp.texts = []
        got = render_page_vector(td, tp)
        np.testing.assert_array_equal(got, jrender(jd, jp))
        if name == "embedded":
            tp.images = []
            assert (got != render_page_vector(td, tp)).any(-1).sum() > 40_000


def test_golden_digital_pages_render_bit_equal(tmp_path):
    for name, build in cases.DIGITAL_CASES.items():
        for jd, jp, td, tp in _renders(open(build(str(tmp_path)),
                                            "rb").read()):
            np.testing.assert_array_equal(render_page(td, tp),
                                          jrender(jd, jp))


def test_render_page_raises_naming_pil_without_it(docs, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with PdfDocument.open(docs["vector"]) as td:
        page = td.load_page(0)
        with pytest.raises(ImportError, match="PIL"):
            render_page(td, page)
        # the vector half needs no PIL; a page without text neither
        assert render_page_vector(td, page).shape == (600, 800, 3)
        page.texts = []
        np.testing.assert_array_equal(render_page(td, page),
                                      render_page_vector(td, page))


@pytest.mark.parametrize("seed", range(3))
def test_drawing_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(150):
        H, W = (int(v) for v in rng.integers(5, 60, 2))
        lo, hi = (-20, 80) if rng.random() < 0.4 else (0, 60)
        p0 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        p1 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        t = int(rng.integers(1, 7))
        pts = rng.integers(lo, hi, (int(rng.integers(2, 6)), 2)).astype(
            np.int32)
        for want_fn, got_fn in [
                (lambda im: cv2.line(im, p0, p1, (0, 0, 0), t),
                 lambda im: draw.line(im, p0, p1, (0, 0, 0), t)),
                (lambda im: cv2.rectangle(im, p0, p1, (0, 0, 0), t),
                 lambda im: draw.rectangle(im, p0, p1, (0, 0, 0), t)),
                (lambda im: cv2.rectangle(im, p0, p1, (200, 200, 200), -1),
                 lambda im: draw.rectangle(im, p0, p1, (200, 200, 200), -1)),
                (lambda im: cv2.polylines(im, [pts], False, (0, 0, 0),
                                          thickness=min(t, 3)),
                 lambda im: draw.polylines(im, pts, False, (0, 0, 0),
                                           min(t, 3)))]:
            want = np.full((H, W, 3), 255, np.uint8)
            got = want.copy()
            want_fn(want)
            got_fn(got)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(2))
def test_inter_area_matches_cv2(seed):
    """Integer and fractional shrinks, enlargements, mixed axes."""
    rng = np.random.default_rng(seed)
    shapes = [(40, 60, 20, 30), (41, 63, 20, 21), (30, 90, 10, 30),
              (50, 70, 33, 41), (12, 20, 48, 80), (10, 10, 25, 17),
              (64, 48, 32, 24), (9, 53, 18, 26), (100, 80, 50, 40)]
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        shapes.append((h, w, int(rng.integers(1, 2 * h + 2)),
                       int(rng.integers(1, 2 * w + 2))))
    for h, w, nh, nw in shapes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resize_area_u8_plain(img, nh, nw),
            cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA))
