"""Scanned PDF pages: pages whose content is an embedded JPEG
(``/DCTDecode``) or JPEG 2000 (``/JPXDecode``) image, in the port against
the JAX package, on the CPU.

- ``utils/image_io.py::decode_image`` is bit-equal to ``cv2.imdecode``
  (``IMREAD_COLOR``) + BGR -> RGB on RGB, grey, progressive, CMYK (with
  and without the Adobe marker) and EXIF-oriented JPEGs, a JP2 file and a
  raw J2K codestream; both give None on bytes that are no image and on a
  truncated JPEG. ``read_image`` of a CMYK JPEG or TIFF file is bit-equal
  to ``cv2.imread``, where PIL's own CMYK conversion is not.
- ``render_page`` is bit-equal to JAX's on pages carrying those streams,
  each placed 1:1, downscaled, upscaled and partly off the page, at 144
  and 100 dpi; on streams whose ``/ColorSpace`` disagrees with the
  codestream; on tests/test_torch_pdfio.py's ``embedded`` document; a
  ``/DCTDecode`` or ``/CCITTFaxDecode`` stream that does not decode is
  skipped by both. Without PIL an encoded image raises an ``ImportError``
  naming PIL.
- ``render_pdf`` with a stand-in ``gs`` script (tests/test_pdfio.py's
  pattern): the ``"ghostscript"`` and ``"auto"`` backends under each
  environment give JAX's pages, arguments and errors.
- ``BatchPipeline.run`` on three scanned pages (RGB, grey and CMYK JPEGs)
  mixed with a digital page and a scan carrying an invisible OCR text
  layer equals JAX's runner page for page (the trees and tasks of
  tests/test_torch_system.py, the runner configuration of
  tests/test_torch_pipeline.py); the scanned pages equal the port's run
  on their decoded images. ``OcrSystemTask`` on a scanned page,
  ``read_pdf(flavor="lattice")`` on a scanned ruled table (with and
  without its invisible text) and the CLI on a one-page scan (per-page and
  batched routes) equal JAX's."""

import io
import os
import re
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import pdf_table_tpu.pipeline.batch_runner as jbr
from pdf_table_tpu.pdf_table import read_pdf as jread_pdf
from pdf_table_tpu.pdfio import PdfDocument as JDoc
from pdf_table_tpu.pdfio import PdfWriter
from pdf_table_tpu.pdfio import render_page as jrender
from pdf_table_tpu.pdfio.render import render_pdf as jrender_pdf
from pdf_table_tpu_torch.pdf_table import read_pdf
from pdf_table_tpu_torch.pdfio import (PdfDocument, render_page,
                                       render_page_vector)
from pdf_table_tpu_torch.pdfio.render import render_pdf
from pdf_table_tpu_torch.utils.image_io import decode_image, read_image
from test_torch_cli import RgbRunner, clis, run_both
from test_torch_pdfio import WRITERS
from test_torch_pipeline import PAGES, jax_pipeline, port_pipeline
from test_torch_system import (jtasks, same_output, systems,  # noqa
                               trees)

torch.set_num_threads(1)


# -- streams ---------------------------------------------------------------

def _encode(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _without_app14(jpeg: bytes) -> bytes:
    """The JPEG with its Adobe APP14 segment taken out."""
    out, i = bytearray(jpeg[:2]), 2
    while i < len(jpeg):
        marker = jpeg[i + 1]
        if marker == 0xDA:                  # start of scan: the rest
            return bytes(out + jpeg[i:])
        n = int.from_bytes(jpeg[i + 2:i + 4], "big")
        if marker != 0xEE:
            out += jpeg[i:i + 2 + n]
        i += 2 + n
    return bytes(out)


def _oriented(im, orientation: int, **kw) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    return _encode(im, "JPEG", exif=exif, **kw)


def _picture(seed: int, h: int = 90, w: int = 120) -> np.ndarray:
    """A scan-like image: a colour gradient, dark strokes and a rule."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (h + w)
                    + 64], -1).astype(np.uint8)
    for _ in range(12):
        r, c = rng.integers(0, h - 4), rng.integers(0, w - 20)
        img[r:r + 3, c:c + int(rng.integers(5, 20))] = rng.integers(0, 80, 3)
    img[h // 2] = 0
    return img


def _streams():
    """name -> (encoded bytes, PDF filter)."""
    rgb = Image.fromarray(_picture(0))
    cmyk = Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (90, 120, 4), dtype=np.uint8), "CMYK")
    return {
        "rgb": (_encode(rgb, "JPEG", quality=90), "DCTDecode"),
        "grey": (_encode(rgb.convert("L"), "JPEG"), "DCTDecode"),
        "progressive": (_encode(rgb, "JPEG", progressive=True),
                        "DCTDecode"),
        "cmyk_adobe": (_encode(cmyk, "JPEG"), "DCTDecode"),
        "cmyk_plain": (_without_app14(_encode(cmyk, "JPEG")), "DCTDecode"),
        "cmyk_of_rgb": (_encode(rgb.convert("CMYK"), "JPEG"), "DCTDecode"),
        "exif_rotated": (_oriented(rgb, 6), "DCTDecode"),
        "exif_cmyk": (_oriented(cmyk, 8), "DCTDecode"),
        "jp2": (_encode(rgb, "JPEG2000"), "JPXDecode"),
        "j2k": (_encode(rgb, "JPEG2000", no_jp2=True), "JPXDecode"),
        "jp2_grey": (_encode(rgb.convert("L"), "JPEG2000"), "JPXDecode"),
    }


STREAMS = _streams()


def cv2_rgb(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_image_bit_equal_to_cv2(name):
    data, _ = STREAMS[name]
    want = cv2_rgb(data)
    got = decode_image(data)
    assert want is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if name.startswith("exif"):
        assert got.shape == (120, 90, 3)     # turned by a quarter


def test_undecodable_bytes_give_none_on_both_sides():
    rng = np.random.default_rng(2)
    rgb = STREAMS["rgb"][0]
    for data in (rng.integers(0, 256, 400, dtype=np.uint8).tobytes(),
                 rgb[:len(rgb) // 2], rgb[:-2]):
        assert decode_image(data) is None and cv2_rgb(data) is None


@pytest.mark.parametrize("fmt", ["JPEG", "TIFF"])
def test_read_image_cmyk_file_bit_equal_to_cv2_imread(fmt, tmp_path):
    """The CMYK repair of ``utils/image_io.py``: PIL's own conversion is
    a grey level or more off on most pixels."""
    path = str(tmp_path / f"cmyk.{fmt.lower()}")
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (64, 48, 4), dtype=np.uint8),
                    "CMYK").save(path, format=fmt)
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_image(path), want)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert (pil != want).any(-1).mean() > 0.5


# -- render_page -------------------------------------------------------------

def image_pdf(images, size=(400, 300), texts=(), invisible=()) -> bytes:
    """A one-page PDF with encoded image XObjects: ``images`` [(stream
    bytes, filter, width, height, colorspace, (x, y, w, h))]; ``texts``
    [(x, y, str)] visible, ``invisible`` [(x, y, str)] in render mode 3
    (an OCR layer)."""
    objs = [b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"]
    names, ops = [], []
    for k, (data, filt, w, h, cs, (x, y, bw, bh)) in enumerate(images):
        objs.append((f"<< /Type /XObject /Subtype /Image /Width {w} "
                     f"/Height {h} /ColorSpace /{cs} /BitsPerComponent 8 "
                     f"/Filter /{filt} /Length {len(data)} >>\nstream\n"
                     ).encode() + data + b"\nendstream")
        names.append((f"Im{k}", len(objs)))
        ops.append(f"q {bw:g} 0 0 {bh:g} {x:g} {y:g} cm /Im{k} Do Q")
    for mode, items in ((0, texts), (3, invisible)):
        for x, y, s in items:
            ops.append(f"BT {mode} Tr /F1 10 Tf {x:g} {y:g} Td ({s}) Tj ET")
    content = ("\n".join(ops) + "\n").encode()
    objs.append(f"<< /Length {len(content)} >>\nstream\n".encode()
                + content + b"\nendstream")
    cont = len(objs)
    xobj = " ".join(f"/{n} {i} 0 R" for n, i in names)
    objs.append(f"<< /Type /Page /Parent {len(objs) + 2} 0 R /MediaBox "
                f"[0 0 {size[0]:g} {size[1]:g}] /Resources << /Font << /F1 "
                f"1 0 R >> /XObject << {xobj} >> >> /Contents {cont} 0 R >>"
                .encode())
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


# placement boxes in points for a 120x90 px image: 1:1 at 144 dpi,
# downscaled by 2, upscaled by 1.3, partly off the page (left and top)
PLACEMENTS = ((20, 200, 60, 45), (120, 220, 30, 22.5), (180, 120, 78, 58.5),
              (-20, 262, 70, 50))


def _pages(data):
    with JDoc.open(data) as jd, PdfDocument.open(data) as td:
        yield jd, jd.load_page(0), td, td.load_page(0)


def _render_both(data, dpi=144):
    for jd, jp, td, tp in _pages(data):
        return render_page(td, tp, dpi=dpi), jrender(jd, jp, dpi=dpi)


@pytest.mark.parametrize("dpi", [144, 100])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_render_page_bit_equal_to_jax(name, dpi):
    data, filt = STREAMS[name]
    data_pdf = image_pdf([(data, filt, 120, 90, "DeviceRGB", box)
                          for box in PLACEMENTS],
                         texts=[(20, 20, "a scanned page")])
    got, want = _render_both(data_pdf, dpi)
    np.testing.assert_array_equal(got, want)
    # the scan is drawn: at 144 dpi the 1:1 box holds the decoded image
    if dpi == 144 and not name.startswith("exif"):
        x, y = 40, 600 - 2 * (200 + 45)
        np.testing.assert_array_equal(got[y:y + 90, x:x + 120],
                                      decode_image(data))
    assert (got[:, :, 0] < 250).mean() > 0.05


def test_colorspace_that_disagrees_follows_the_codestream():
    """``/ColorSpace`` names another space than the stream's components:
    both renderers draw what the codestream holds."""
    images = [(STREAMS["grey"][0], "DCTDecode", 120, 90, "DeviceRGB",
               PLACEMENTS[0]),
              (STREAMS["rgb"][0], "DCTDecode", 120, 90, "DeviceGray",
               PLACEMENTS[1]),
              (STREAMS["cmyk_adobe"][0], "DCTDecode", 120, 90, "DeviceRGB",
               PLACEMENTS[2]),
              (STREAMS["jp2"][0], "JPXDecode", 120, 90, "DeviceCMYK",
               PLACEMENTS[3])]
    got, want = _render_both(image_pdf(images))
    np.testing.assert_array_equal(got, want)
    x, y = 240, 600 - 2 * (220 + 22.5)
    assert (got[int(y):int(y) + 45, x:x + 60].std(-1) > 0).any()


def test_embedded_document_renders_bit_equal():
    for name in ("embedded",):
        data = WRITERS[name](PdfWriter).tobytes()
        for jd, jp, td, tp in _pages(data):
            got = render_page(td, tp)
            np.testing.assert_array_equal(got, jrender(jd, jp))
            assert [m.filter for m in tp.images] == ["DCTDecode"]
            tp.images = []
            assert (got != render_page(td, tp)).any(-1).sum() > 40_000


@pytest.mark.parametrize("filt", ["DCTDecode", "CCITTFaxDecode",
                                  "JBIG2Decode"])
def test_a_stream_that_does_not_decode_is_skipped_by_both(filt):
    junk = np.random.default_rng(4).integers(0, 256, 500,
                                             dtype=np.uint8).tobytes()
    data = image_pdf([(junk, filt, 120, 90, "DeviceGray", PLACEMENTS[0]),
                      (STREAMS["rgb"][0], "DCTDecode", 120, 90, "DeviceRGB",
                       PLACEMENTS[2])])
    got, want = _render_both(data)
    np.testing.assert_array_equal(got, want)
    x, y = 40, 600 - 2 * (200 + 45)
    assert (got[y:y + 90, x:x + 120] == 255).all()


def test_an_encoded_image_without_pil_raises_naming_it(monkeypatch):
    data = image_pdf([(STREAMS["rgb"][0], "DCTDecode", 120, 90,
                       "DeviceRGB", PLACEMENTS[0])])
    with PdfDocument.open(data) as td:
        page = td.load_page(0)
        monkeypatch.setitem(sys.modules, "PIL", None)
        with pytest.raises(ImportError, match="PIL"):
            render_page_vector(td, page)
        with pytest.raises(ImportError, match="PIL"):
            render_page(td, page)
        page.images = []
        assert (render_page_vector(td, page) == 255).all()


# -- render_pdf ----------------------------------------------------------------

def _gs_pages(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (30 + 7 * k, 20 + 5 * k, 3),
                         dtype=np.uint8) for k in range(2)]


def fake_gs(tmp_path, kind="ok", name="fake_gs"):
    """A stand-in Ghostscript: writes two PNG pages where its
    ``-sOutputFile`` pattern says ("ok"), exits 1 ("fails"), writes
    nothing ("empty") or a page that is no PNG ("junk"); it records its
    arguments beside itself."""
    pngs = []
    for k, rgb in enumerate(_gs_pages(5)):
        png = tmp_path / f"golden{k}.png"
        cv2.imwrite(str(png), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        pngs.append(png)
    body = {"ok": "".join(f"cp {p} \"$(printf \"$out\" {k + 1})\"\n"
                          for k, p in enumerate(pngs)),
            "fails": "exit 1\n", "empty": "",
            "junk": "echo junk > \"$(printf \"$out\" 1)\"\n"}[kind]
    gs = tmp_path / name
    gs.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {tmp_path}/args.txt\n"
        "for a in \"$@\"; do case \"$a\" in -sOutputFile=*) "
        "out=${a#-sOutputFile=};; esac; done\n" + body)
    gs.chmod(0o755)
    return gs


def two_page_pdf() -> bytes:
    w = PdfWriter()
    for k in range(2):
        w.add_page(300, 200).text(30, 150, f"page {k}", size=12)
    return w.tobytes()


def _outcome(fn):
    try:
        return [(i, img.shape, img.tobytes()) for i, img in fn()]
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return type(e)


# name -> (gs kind or "missing" or "path", env backend, backend, pages,
#          expected outcome: "gs", "native" or an exception type)
GS_CASES = {
    "ghostscript": ("ok", None, "ghostscript", None, "gs"),
    "ghostscript_page_1": ("ok", None, "ghostscript", [1], "gs"),
    "ghostscript_page_out_of_range": ("ok", None, "ghostscript", [0, 4],
                                      "gs"),
    "auto_under_the_env": ("ok", "ghostscript", "auto", None, "gs"),
    "auto_without_the_env": ("ok", None, "auto", None, "native"),
    "auto_other_env": ("ok", "native", "auto", [1], "native"),
    "gs_on_path": ("path", None, "ghostscript", None, "gs"),
    "missing_binary": ("missing", None, "ghostscript", None, RuntimeError),
    "missing_binary_auto": ("missing", "ghostscript", "auto", None,
                            "native"),
    "failing_binary": ("fails", None, "ghostscript", None,
                       "CalledProcessError"),
    "failing_binary_auto": ("fails", "ghostscript", "auto", [0], "native"),
    "no_pages": ("empty", None, "ghostscript", None, RuntimeError),
    "no_pages_auto": ("empty", "ghostscript", "auto", None, "native"),
    "unreadable_page": ("junk", None, "ghostscript", None, RuntimeError),
    "unknown_backend": ("ok", "ghostscript", "poppler", None, "native"),
}


@pytest.mark.parametrize("case", sorted(GS_CASES))
def test_render_pdf_backends_match_jax(case, tmp_path, monkeypatch):
    import subprocess

    kind, env, backend, pages, expected = GS_CASES[case]
    monkeypatch.delenv("PDFTABLE_RENDER_BACKEND", raising=False)
    monkeypatch.delenv("PDFTABLE_GS_BINARY", raising=False)
    if env:
        monkeypatch.setenv("PDFTABLE_RENDER_BACKEND", env)
    if kind == "missing":
        monkeypatch.setenv("PDFTABLE_GS_BINARY", str(tmp_path / "no_gs"))
    elif kind == "path":
        fake_gs(tmp_path, name="gs")
        monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    else:
        monkeypatch.setenv("PDFTABLE_GS_BINARY", str(fake_gs(tmp_path, kind)))
    data = two_page_pdf()
    want = _outcome(lambda: jrender_pdf(data, dpi=72, pages=pages,
                                        backend=backend))
    jax_args = (tmp_path / "args.txt").read_text() \
        if (tmp_path / "args.txt").exists() else ""
    (tmp_path / "args.txt").unlink(missing_ok=True)
    got = _outcome(lambda: render_pdf(data, dpi=72, pages=pages,
                                      backend=backend))
    port_args = (tmp_path / "args.txt").read_text() \
        if (tmp_path / "args.txt").exists() else ""
    assert got == want
    # the same command line, up to the temporary directory's name
    tmp = re.compile(r"\S*pdfio_gs_[^/\s]*")
    assert tmp.sub("TMP", port_args) == tmp.sub("TMP", jax_args)
    if expected == "gs":
        idx = [0, 1] if pages is None else [i for i in pages if i < 2]
        assert [i for i, _, _ in got] == idx
        assert [img for _, _, img in got] == \
            [_gs_pages(5)[i].tobytes() for i in idx]
        args = port_args.split()
        assert args[:6] == ["-q", "-dNOPAUSE", "-dBATCH", "-dSAFER",
                            "-sDEVICE=png16m", "-r72"]
        assert args[6].startswith("-sOutputFile=") and \
            args[6].endswith("page-%04d.png")
    elif expected == "native":
        assert isinstance(got, list) and got[0][1] == (200, 300, 3)
    elif expected == "CalledProcessError":
        assert got is subprocess.CalledProcessError
    else:
        assert got is expected


def test_render_pdf_ghostscript_reads_a_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PDFTABLE_GS_BINARY", str(fake_gs(tmp_path)))
    pdf = tmp_path / "doc.pdf"
    pdf.write_bytes(two_page_pdf())
    got = render_pdf(str(pdf), backend="ghostscript")
    want = jrender_pdf(str(pdf), backend="ghostscript")
    assert [(i, g.tobytes()) for i, g in got] == \
        [(i, w.tobytes()) for i, w in want]
    assert str(pdf) in (tmp_path / "args.txt").read_text().split()


# -- the entry points on scans -------------------------------------------------

def scan_page(writer, img, mode="RGB"):
    """A page holding ``img`` as one JPEG scan (``mode`` RGB, L or CMYK),
    placed 1:1 at 144 dpi."""
    h, w = img.shape[:2]
    p = writer.add_page(w / 2, h / 2)
    p.image(_encode(Image.fromarray(img).convert(mode), "JPEG"), 0, 0,
            w / 2, h / 2, w, h)
    return p


def invisible(ops):
    """Text operators turned into an OCR layer (render mode 3)."""
    return [op.replace("BT ", "BT 3 Tr ", 1) for op in ops
            if op.startswith("BT ")]


def mixed_pdf() -> bytes:
    """Scans of the three runner pages (an RGB, a grey and a CMYK JPEG), a
    digital page with a wired table, and a scan with an invisible text
    layer."""
    w = PdfWriter()
    for img, mode in zip(PAGES, ("RGB", "L", "CMYK")):
        scan_page(w, img, mode)
    p = w.add_page(612, 792)
    for k in range(4):
        p.text(60, 740 - 20 * k, f"Digital line {k} beside the scans.")
    p.table(60, 600, [150, 100, 100], 24,
            [["name", "qty", "price"], ["bolts", "40", "0.10"]])
    p = scan_page(w, PAGES[2])
    p.ops += invisible([f"BT /F1 10 Tf 40 {520 - 18 * k} Td (ocr line {k}) "
                        f"Tj ET" for k in range(6)])
    return w.tobytes()


def _pdf_pages(data, reader, order):
    doc = reader.open(data)
    return [{"pdf_page": doc.load_page(i), "pdf_doc": doc, "page": k}
            for k, i in enumerate(order)]


MIXED_ORDER = (0, 3, 1, 4, 2)     # scans of two buckets, digital, OCR'd


@pytest.fixture(scope="module")
def mixed_runs(trees, jtasks):
    data = mixed_pdf()
    want = jax_pipeline(jtasks, False).run(
        _pdf_pages(data, JDoc, MIXED_ORDER))
    bp = port_pipeline(trees, False)
    return bp, data, bp.run(_pdf_pages(data, PdfDocument, MIXED_ORDER)), want


def _same_runner_pages(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.metric == w.metric == {}
        same_output(g, w)


def test_runner_on_scans_matches_jax(mixed_runs):
    bp, _, got, want = mixed_runs
    _same_runner_pages(got, want)
    # ``is_pdf`` marks the pages read from vector text, as in JAX's runner
    assert [g.is_pdf for g in got] == [False, True, False, True, False]
    scans = [got[k] for k, i in enumerate(MIXED_ORDER) if i in (0, 1, 2)]
    assert all(len(g.text_cells) >= 8 for g in scans)
    assert sum(len(g.table_html) for g in scans) >= 1, "no scanned table"
    digital, ocr = got[1], got[3]
    assert digital.table_html and ">bolts</td>" in digital.table_html[0]
    # the invisible layer routes the page as digital; its text is dropped
    assert ocr.text_cells == [] and ocr.metric == {}
    assert bp.last_stats["rasterize"] > 0.0


def test_scans_equal_their_decoded_images(mixed_runs, trees):
    """A scan placed 1:1 is its decoded JPEG: the runner gives the same
    page outputs with each scan replaced by its decoded image (the chunks
    unchanged)."""
    _, data, got, _ = mixed_runs
    pages = _pdf_pages(data, PdfDocument, MIXED_ORDER)
    for p in pages:
        page = p["pdf_page"]
        if page.index < 3:
            stream, kind = p["pdf_doc"].get_image_bytes(
                page.images[0].obj_num)
            assert kind == 1
            p.clear()
            p.update(image=decode_image(stream), page=MIXED_ORDER.index(
                page.index))
    ref = port_pipeline(trees, False).run(pages)
    for k, (g, r) in enumerate(zip(got, ref)):
        if MIXED_ORDER[k] < 3:
            np.testing.assert_array_equal(g.image, pages[k]["image"])
        same_output(g, r)
        assert [c.score for c in g.text_cells] == \
            [c.score for c in r.text_cells]
        assert [(c.bbox, c.score) for c in g.layout_cells] == \
            [(c.bbox, c.score) for c in r.layout_cells]


def test_system_on_a_scanned_page_matches_jax(trees, jtasks):
    from test_torch_system import TABLE_PAGE

    w = PdfWriter()
    scan_page(w, TABLE_PAGE, "CMYK")
    data = w.tobytes()
    port, jsys = systems(trees, jtasks)
    (jp,), (tp,) = (_pdf_pages(data, r, (0,)) for r in (JDoc, PdfDocument))
    want = jsys(pdf_page=jp["pdf_page"], pdf_doc=jp["pdf_doc"], page=1)
    got = port(pdf_page=tp["pdf_page"], pdf_doc=tp["pdf_doc"], page=1)
    same_output(got, want)
    assert got.is_pdf and got.text_cells and got.table_html
    assert "detection" in got.metric


def _ruled_scan(tmp_path, with_text: bool) -> str:
    """tests/test_torch_read_pdf.py's ruled table, rendered at 144 dpi and
    saved as a JPEG scan; ``with_text`` adds its cells' text as an
    invisible OCR layer."""
    vec = PdfWriter()
    grid = vec.add_page(300, 200)
    grid.table(20, 180, [80, 80, 80], 30,
               [["h1", "h2", "h3"], ["a", "b", "c"], ["d", "e", "f"]])
    with PdfDocument.open(vec.tobytes()) as doc:
        img = render_page(doc, doc.load_page(0))
    w = PdfWriter()
    p = scan_page(w, img, "L")
    if with_text:
        p.ops += invisible(grid.ops)
    path = str(tmp_path / f"scan_{with_text}.pdf")
    w.save(path)
    return path


@pytest.mark.parametrize("with_text", [True, False],
                         ids=["ocr_layer", "image_only"])
def test_lattice_on_a_scanned_table_matches_jax(tmp_path, with_text):
    path = _ruled_scan(tmp_path, with_text)
    want = jread_pdf(path, flavor="lattice")
    got = read_pdf(path, flavor="lattice")
    assert got.n == want.n >= 1
    for g, w in zip(got, want):
        assert g.df.equals(w.df)
        assert g.parsing_report == w.parsing_report
        assert g.shape == w.shape == (3, 3) and g.data == w.data
        np.testing.assert_array_equal(g.bbox, w.bbox)
        assert g.to_html() == w.to_html()
    if with_text:
        assert got[0].data[0] == ["h1", "h2", "h3"]


@pytest.mark.parametrize("route", ["per_page", "batched"])
def test_cli_on_a_scan_matches_jax(route, trees, jtasks, tmp_path,
                                   monkeypatch):
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
    from test_torch_pipeline import DET, DET_BENCH
    from test_torch_system import TABLE_PAGE

    w = PdfWriter()
    scan_page(w, TABLE_PAGE)
    pdf = str(tmp_path / "scan.pdf")
    w.save(pdf)
    flags = {}
    if route == "batched":
        monkeypatch.setattr(jbr, "BatchPipeline", RgbRunner)
        flags["batch_pages"] = 2
    port, jax_ = clis(trees, jtasks, tmp_path, file_path_or_url=pdf,
                      **flags)
    if route == "batched":
        port.system._det = OcrDetectionTask(
            model="PP-OCRv4_det", device="cpu", variables=trees["det"],
            **DET, **DET_BENCH)
        jax_.system._det = jtasks["_det"]
    got, _, pm = run_both(port, jax_)
    assert got["n_pages"] == 1 and pm[0]["n_text"] and pm[0]["n_tables"]


# -- a 16-bit colour JPEG 2000 scan (ROADMAP.md Queue 3, F10) -----------------

def jpx16(img: np.ndarray, seed: int = 16) -> bytes:
    """``img`` (RGB uint8) as a 16-bit colour JP2 written by cv2: each
    sample ``v * 256`` plus seeded noise in the low byte, which PIL's
    rounding carries into the high byte where OpenCV's shift drops it."""
    low = np.random.default_rng(seed).integers(0, 256, img.shape)
    ok, enc = cv2.imencode(".jp2", (img[..., ::-1].astype(np.uint16) << 8)
                           | low.astype(np.uint16))
    assert ok
    return enc.tobytes()


def jpx16_page(img: np.ndarray) -> bytes:
    """A one-page PDF holding ``img`` as a 16-bit colour ``/JPXDecode``
    scan, placed 1:1 at 144 dpi."""
    h, w = img.shape[:2]
    return image_pdf([(jpx16(img), "JPXDecode", w, h, "DeviceRGB",
                       (0, 0, w / 2, h / 2))], size=(w / 2, h / 2))


def test_16bit_colour_jpx_renders_as_jax():
    """The page image decodes as OpenCV's shift gives it, where PIL's
    rounding parts from it on most samples; the renders are equal."""
    stream = jpx16(_picture(0))
    pil_rgb = np.asarray(Image.open(io.BytesIO(stream)).convert("RGB"))
    assert (pil_rgb != cv2_rgb(stream)).mean() > 0.2
    np.testing.assert_array_equal(decode_image(stream), cv2_rgb(stream))
    data = image_pdf([(stream, "JPXDecode", 120, 90, "DeviceRGB", box)
                      for box in PLACEMENTS])
    for dpi in (144, 100):
        got, want = _render_both(data, dpi)
        np.testing.assert_array_equal(got, want)


def test_runner_on_a_16bit_colour_jpx_scan_matches_jax(trees, jtasks):
    data = jpx16_page(PAGES[0])
    want = jax_pipeline(jtasks, False).run(_pdf_pages(data, JDoc, (0,)))
    got = port_pipeline(trees, False).run(_pdf_pages(data, PdfDocument,
                                                     (0,)))
    _same_runner_pages(got, want)
    assert len(got[0].text_cells) >= 8


def test_lattice_on_a_16bit_colour_jpx_scan_matches_jax(tmp_path):
    vec = PdfWriter()
    vec.add_page(300, 200).table(
        20, 180, [80, 80, 80], 30,
        [["h1", "h2", "h3"], ["a", "b", "c"], ["d", "e", "f"]])
    with PdfDocument.open(vec.tobytes()) as doc:
        img = render_page(doc, doc.load_page(0))
    path = str(tmp_path / "jpx16.pdf")
    with open(path, "wb") as f:
        f.write(jpx16_page(img))
    want = jread_pdf(path, flavor="lattice")
    got = read_pdf(path, flavor="lattice")
    assert got.n == want.n >= 1
    for g, w in zip(got, want):
        assert g.df.equals(w.df) and g.data == w.data
        assert g.parsing_report == w.parsing_report
        np.testing.assert_array_equal(g.bbox, w.bbox)
