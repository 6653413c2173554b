"""The port's image decode (``pdf_table_tpu_torch/utils/image_io.py``)
held to ``cv2.imdecode`` / ``cv2.imread`` (OpenCV 5.0.0, ``IMREAD_COLOR``
then BGR -> RGB) on this box, and the entry points that decode held to the
JAX package's on the files where the two used to part.

- Formats: every format and mode that PIL writes here (a 50 x 40 random
  image), files that cv2 writes (8- and 16-bit, grey, alpha, float) and
  hand-built Sun rasters give None exactly where cv2 does and bit-equal
  pixels everywhere else (a grey PFM as OpenCV's unscaled
  ``saturate_cast`` of its floats, 16-bit samples both as ``v * 257`` and
  over their full range). tests/test_torch_image_formats.py holds the
  formats the port reads with its own readers case by case.
- Corrupt JPEG data: tests/data/image_decode/make_fixtures.py's recipe (a
  blurred 400 x 300 JPEG, seed 0, three random bytes set per copy), 400
  corruptions after byte 600 and 400 after byte 100, give cv2's None or
  cv2's pixels on every one; truncated JPEG, PNG, GIF, TIFF, BMP and WebP
  files, cut at 17 points, give ``cv2.imdecode``'s None through
  ``decode_image`` and ``cv2.imread``'s outcome through ``read_image``
  (a truncated JPEG file decodes there).
- Size: a real 13,400 x 13,400 grey JPEG (over PIL's bomb limit) decodes
  bit-equal; header-patched files at and above OpenCV's limits (2^30
  pixels, 2^20 on a side) give None, an image or an
  :class:`ImageDecodeError` where cv2 gives None, an image or ``cv2.error``,
  without loading a pixel above the limit. ``Image.MAX_IMAGE_PIXELS`` and
  ``ImageFile.LOAD_TRUNCATED_IMAGES`` are never written, and neither
  changes what the port decodes.
- Entry points, against JAX: the renderer and the runner's page
  containment, ``read_pdf``, the service (HTTP), the CLI on an image file,
  ``OcrTextTask`` and ``OcrDocument`` on an image path, on an ICO, a TGA,
  each kind of corrupt JPEG, a truncated one and an over-limit header.
- The committed fixtures decode to the digests beside them (what
  ``chip_smoke.py``'s ``decode`` phase holds the card's host to); each
  entry point is held to JAX's on every one of them, the F10-F15 files of
  make_fixtures.py too."""

import hashlib
import http.client
import importlib.util
import io
import json
import os
import struct
import threading
import types
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.serve as jserve
from pdf_table_tpu.cli import main as jmain
from pdf_table_tpu.entity.args import PdfTableCliArguments as JArgs
from pdf_table_tpu.pdf_table import read_pdf as jread_pdf
from pdf_table_tpu.pdfio import PdfDocument as JDoc
from pdf_table_tpu.pdfio import render_page as jrender
from pdf_table_tpu.pipeline.ocr_document import OcrDocument as JOcrDocument
from pdf_table_tpu.pipeline.system import OcrSystemConfig as JConfig
from pdf_table_tpu.tasks.text_task import OcrTextTask as JOcrTextTask
from pdf_table_tpu_torch import serve
from pdf_table_tpu_torch.cli import main as tmain
from pdf_table_tpu_torch.entity.args import PdfTableCliArguments
from pdf_table_tpu_torch.pdf_table import read_pdf
from pdf_table_tpu_torch.pdfio import PdfDocument, render_page
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.ocr_document import OcrDocument
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.tasks.text_task import OcrTextTask
from pdf_table_tpu_torch.utils.image_io import (CV_MAX_PIXELS, CV_MAX_SIDE,
                                                ImageDecodeError,
                                                decode_image, read_image)
from test_torch_scanned_pdf import PLACEMENTS, image_pdf

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "image_decode")
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

RAISES = "raises"


def _committed():
    """The fixtures as committed: name -> bytes."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        names = sorted(json.load(f)["files"])
    out = {}
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            out[name] = f.read()
    return out


FILES = _committed()


def cv_outcome(data: bytes):
    """cv2's RGB decode, None, or RAISES where it raises ``cv2.error``
    (decode or BGR -> RGB)."""
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    except cv2.error:
        return RAISES


def port_outcome(data: bytes):
    try:
        return decode_image(data)
    except ImageDecodeError:
        return RAISES


def assert_same(got, want):
    if isinstance(want, str) or want is None:
        assert (got if isinstance(got, str) or got is None else "image") \
            == want
    else:
        assert got is not None and not isinstance(got, str)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def encode(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


# -- formats -----------------------------------------------------------------

# "I;16full": 16-bit grey over the full range, beside "I;16"'s v * 257
MODES = ("RGB", "L", "RGBA", "P", "1", "I;16", "I;16full", "I", "F", "CMYK",
         "LA")


def _sample(mode):
    rgb = np.random.default_rng(0).integers(0, 256, (50, 40, 3),
                                            dtype=np.uint8)
    if mode == "I;16":
        return Image.fromarray(rgb[..., 0].astype(np.uint16) * 257)
    if mode == "I;16full":
        return Image.fromarray(np.random.default_rng(0).integers(
            0, 65536, (50, 40)).astype(np.uint16))
    if mode == "I":
        return Image.fromarray(rgb[..., 0].astype(np.int32) * 1000)
    if mode == "F":
        return Image.fromarray(rgb[..., 0].astype(np.float32) / 255)
    return Image.fromarray(rgb).convert(mode)


def _writable():
    Image.init()
    out = {}
    for fmt in sorted(Image.SAVE):
        for mode in MODES:
            try:
                out[f"{fmt}-{mode}"] = encode(_sample(mode), fmt)
            except (OSError, ValueError, KeyError, TypeError):
                pass
    return out


WRITTEN = _writable()


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_every_format_pil_writes_decodes_as_cv2(case):
    data = WRITTEN[case]
    assert_same(port_outcome(data), cv_outcome(data))


def test_the_formats_cv2_refuses_give_none():
    refused = {c.split("-")[0] for c, d in WRITTEN.items()
               if cv_outcome(d) is None}
    assert {"DDS", "DIB", "ICNS", "ICO", "IM", "PCX", "QOI", "SGI", "SPIDER",
            "TGA", "XBM"} <= refused
    for case, data in WRITTEN.items():
        if case.split("-")[0] in ("ICO", "TGA", "DIB", "ICNS"):
            with Image.open(io.BytesIO(data)) as im:
                im.load()                  # PIL reads them
            assert decode_image(data) is None


def _full16(a):
    """Full-range 16-bit samples of ``a``'s shape, seeded by it."""
    return np.random.default_rng(int(a.sum())).integers(
        0, 65536, a.shape).astype(np.uint16)


CV_ARRAYS = {
    "u8": lambda a: a, "u16": lambda a: a.astype(np.uint16) * 257,
    "u16full": _full16, "grey16full": lambda a: _full16(a[..., 0]),
    "rgba": lambda a: np.dstack([a, a[..., :1]]), "grey": lambda a: a[..., 0],
    "grey16": lambda a: a[..., 0].astype(np.uint16) * 257,
    "f32": lambda a: a.astype(np.float32) / 255}


def _cv_written():
    """"ext-kind" -> what ``cv2.imencode`` writes, for the pairs it
    writes."""
    a = np.random.default_rng(1).integers(0, 256, (50, 41, 3),
                                          dtype=np.uint8)
    out = {}
    for ext in (".png", ".tiff", ".ppm", ".pgm", ".pbm", ".bmp", ".webp",
                ".jp2", ".sr", ".ras"):
        for kind, fn in CV_ARRAYS.items():
            try:
                ok, enc = cv2.imencode(ext, fn(a))
            except cv2.error:
                continue
            if ok:
                out[f"{ext[1:]}-{kind}"] = enc.tobytes()
    return out


CV_WRITTEN = _cv_written()


@pytest.mark.parametrize("case", sorted(CV_WRITTEN))
def test_files_cv2_writes_decode_as_cv2(case):
    data = CV_WRITTEN[case]
    assert_same(port_outcome(data), cv_outcome(data))


def sun_raster(depth, rgb, kind=1, map_type=0, cmap=b"", pad=True) -> bytes:
    """A Sun raster of ``rgb`` (H, W, 3): ``depth`` 1 (the first channel
    over 127), 8 (the first channel), 24 (BGR) or 32 (a pad byte, then
    BGR); ``kind`` 1 standard, 0 old, 2 byte-encoded, 3 RGB."""
    h, w = rgb.shape[:2]
    if depth == 1:
        rows = np.packbits(rgb[..., 0] > 127, axis=1)
    elif depth == 8:
        rows = rgb[..., 0]
    elif depth == 24:
        rows = rgb[..., ::-1].reshape(h, w * 3)
    else:
        rows = np.concatenate([np.full((h, w, 1), 77, np.uint8),
                               rgb[..., ::-1]], -1).reshape(h, w * 4)
    if pad:
        rows = np.pad(rows, ((0, 0), (0, rows.shape[1] % 2)))
    data = rows.tobytes()
    if kind == 2:                             # runs of 3+ as 0x80 n v
        out, i = bytearray(), 0
        while i < len(data):
            j = i
            while j < len(data) and data[j] == data[i] and j - i < 255:
                j += 1
            if data[i] == 0x80:
                out += bytes([0x80, j - i - 1, 0x80]) if j - i > 1 \
                    else b"\x80\x00"
            elif j - i >= 3:
                out += bytes([0x80, j - i - 1, data[i]])
            else:
                out += data[i:j]
            i = j
        data = bytes(out)
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind,
                       map_type, len(cmap)) + cmap + data


SUN_CASES = {
    "depth1": dict(depth=1), "depth8": dict(depth=8),
    "depth8_cmap": dict(depth=8, map_type=1, cmap=bytes(range(256)) * 3),
    "depth8_short_cmap": dict(depth=8, map_type=1, cmap=bytes(range(30))),
    "depth24": dict(depth=24), "depth24_old": dict(depth=24, kind=0),
    "depth32": dict(depth=32), "rle8": dict(depth=8, kind=2, pad=False),
    "rle24": dict(depth=24, kind=2, pad=False),
    "rgb_kind": dict(depth=24, kind=3),
    "map_without_colours": dict(depth=8, map_type=1),
    "depth24_cmap": dict(depth=24, map_type=1, cmap=bytes(range(30)))}


@pytest.mark.parametrize("case", sorted(SUN_CASES))
def test_sun_rasters_decode_as_cv2(case):
    """Sun raster is the read-only format of PIL's that OpenCV also
    reads: a standard or old file of 1, 8, 24 or 32 bits decodes (1 bit
    inverted, 32 bits with the pad byte first, as OpenCV reads them);
    byte-encoded, RGB-ordered and mismatched colour-map files give None,
    as cv2 gives."""
    rgb = np.random.default_rng(3).integers(0, 256, (7, 13, 3),
                                            dtype=np.uint8)
    data = sun_raster(rgb=rgb, **SUN_CASES[case])
    want = cv_outcome(data)
    assert_same(port_outcome(data), want)
    if case in ("depth1", "depth8", "depth24", "depth32"):
        assert want is not None


# -- corrupt and truncated JPEGs ---------------------------------------------

CLEAN = tool.blurred_jpeg()


@pytest.mark.parametrize("lo", [600, 100])
def test_corrupt_jpegs_give_cv2s_outcome(lo):
    kinds = {"image": 0, "none": 0, "pil_breaks": 0}
    for data in tool.corruptions(CLEAN, 400, lo):
        want = cv_outcome(data)
        assert_same(port_outcome(data), want)
        kinds["none" if want is None else "image"] += 1
        kinds["pil_breaks"] += tool._pil_breaks(data)
    # the corruptions reach both of libjpeg's stops (after byte 100 some
    # fall in the tables and the scan header)
    assert kinds["pil_breaks"] >= 3 and kinds["image"] >= 300
    if lo == 100:
        assert kinds["none"] >= 5


def cv_read(path):
    """``cv2.imread`` turned to RGB, or None."""
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


TRUNCATED = {"jpeg": ("JPEG", {"quality": 90}),
             "progressive": ("JPEG", {"quality": 90, "progressive": True}),
             "png": ("PNG", {}), "gif": ("GIF", {}), "tiff": ("TIFF", {}),
             "bmp": ("BMP", {}), "webp": ("WEBP", {})}


@pytest.mark.parametrize("kind", sorted(TRUNCATED))
def test_truncated_files_decode_as_cv2(kind, tmp_path):
    """Cut at 17 points, from the last byte to inside the header:
    ``decode_image`` gives ``cv2.imdecode``'s outcome (None on every
    truncated JPEG, PNG and GIF) and ``read_image`` gives ``cv2.imread``'s,
    which differs for a JPEG: libjpeg's file source hands it a false end
    of image, so a truncated JPEG file decodes, its missing data as
    zeros."""
    fmt, kw = TRUNCATED[kind]
    data = encode(Image.open(io.BytesIO(CLEAN)), fmt, **kw)
    path = str(tmp_path / f"cut.{kind}")
    images = 0
    for cut in (1, 2, 3, 5, 10, 20, 50, 100, 300, 1000, len(data) // 2,
                len(data) - 650, len(data) - 620, len(data) - 300,
                len(data) - 200, len(data) - 100, len(data) - 20):
        cut_data = data[:-cut]
        want = cv_outcome(cut_data)
        assert_same(decode_image(cut_data), want)
        if fmt in ("JPEG", "PNG", "GIF"):
            assert want is None
        with open(path, "wb") as f:
            f.write(cut_data)
        want = cv_read(path)
        assert_same(read_image(path), want)
        images += want is not None
    if fmt == "JPEG":
        assert images >= 10


@pytest.fixture
def pil_globals_at_sentinels(monkeypatch):
    """PIL's two process globals set to values no one else would choose:
    a bomb limit of 1000 pixels, and a false value that is not False."""
    class Falsy:
        def __bool__(self):
            return False

    sentinels = (900, Falsy())
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", sentinels[0])
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", sentinels[1])
    yield sentinels
    assert Image.MAX_IMAGE_PIXELS is sentinels[0]
    assert ImageFile.LOAD_TRUNCATED_IMAGES is sentinels[1]


@pytest.mark.parametrize("case", ["JPEG-RGB", "PNG-RGB", "TIFF-RGB",
                                  "GIF-P", "BMP-RGB", "WEBP-RGB"])
def test_pil_globals_are_never_written_or_applied(case,
                                                  pil_globals_at_sentinels):
    """Each 50 x 40 file is over twice the sentinel limit, where
    ``Image.open`` raises ``DecompressionBombError``: the port decodes it
    as cv2 does, and leaves both globals as they were."""
    data = WRITTEN[case]
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    assert_same(decode_image(data), cv_outcome(data))
    for data in (CLEAN[:-10], FILES["corrupt_refused.jpg"]):
        assert decode_image(data) is None


def test_truncated_mode_set_by_another_caller_changes_no_jpeg(monkeypatch):
    """With ``LOAD_TRUNCATED_IMAGES`` on, PIL feeds libjpeg a false end of
    image and raises on nothing; the port still gives cv2's outcome."""
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    for name in ("clean.jpg", "corrupt_decodes.jpg", "corrupt_refused.jpg",
                 "truncated.jpg"):
        assert_same(decode_image(FILES[name]), cv_outcome(FILES[name]))


def test_fixtures_decode_to_their_digests():
    """The committed fixtures are what the tool makes, and both decoders
    give the digests beside them."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)["files"]
    assert tool.fixtures(cv_outcome) == FILES
    for name, want in digests.items():
        assert tool.rgb_digest(decode_image(FILES[name])) == want
        assert tool.rgb_digest(cv_outcome(FILES[name])) == want
    assert [n for n, d in digests.items() if d is not None] == [
        "bad_iend_crc.png", "bad_text_crc.png", "cielab.tiff", "clean.jpg",
        "colour.pfm", "corrupt_decodes.jpg", "grey.pfm", "image.hdr",
        "image.pam", "mapped_1bit.ras", "maxval100.pgm", "maxval1000.ppm",
        "rgb16.jp2", "rgb16.ppm", "rgb16.tiff", "ycbcr.tiff"]


# -- size limits -------------------------------------------------------------

def test_a_jpeg_over_pils_limit_decodes_bit_equal():
    """13,400 x 13,400 grey (179,560,000 pixels, over twice PIL's
    ``MAX_IMAGE_PIXELS``): bands of grey levels with a ramp."""
    side = 13400
    grey = np.empty((side, side), np.uint8)
    grey[:] = (np.arange(side, dtype=np.uint32) * 7 // 97 % 256).astype(
        np.uint8)
    grey[::64] = 17
    data = encode(Image.fromarray(grey), "JPEG", quality=85)
    del grey
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    want = cv_outcome(data)
    got = decode_image(data)
    assert got.shape == want.shape == (side, side, 3)
    assert np.array_equal(got, want)
    del got, want


def jpeg_sized(w, h, ended=True) -> bytes:
    """A small JPEG whose frame header says ``w`` x ``h``; without its
    last 40 bytes (no end of image) where ``ended`` is false."""
    data = encode(Image.new("RGB", (64, 48), (90, 120, 200)), "JPEG")
    i = data.index(b"\xff\xc0")
    data = data[:i + 5] + struct.pack(">HH", h, w) + data[i + 9:]
    return data if ended else data[:-40]


def png_sized(w, h) -> bytes:
    data = bytearray(encode(Image.new("L", (40, 30), 90), "PNG"))
    data[16:24] = struct.pack(">II", w, h)
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    return bytes(data)


def bmp_sized(w, h) -> bytes:
    data = bytearray(encode(Image.new("RGB", (40, 30), (9, 8, 7)), "BMP"))
    data[18:26] = struct.pack("<ii", w, h)
    return bytes(data)


def ppm_sized(w, h) -> bytes:
    return b"P6\n%d %d\n255\n" % (w, h) + b"\x10" * 3600


def tiff_sized(w, h) -> bytes:
    data = bytearray(encode(Image.new("RGB", (40, 30), (9, 8, 7)), "TIFF"))
    off = struct.unpack("<I", data[4:8])[0]
    for k in range(struct.unpack("<H", data[off:off + 2])[0]):
        e = off + 2 + 12 * k
        tag = struct.unpack("<H", data[e:e + 2])[0]
        if tag in (256, 257, 278):       # width, height, rows per strip
            data[e + 2:e + 4] = struct.pack("<H", 4)
            data[e + 8:e + 12] = struct.pack("<I", w if tag == 256 else h)
    return bytes(data)


def sun_sized(w, h) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, 24, 3600, 1, 0, 0) \
        + b"\x10" * 3600


SIDE = CV_MAX_SIDE
SIZED = {
    # at the pixel limit (no end of image: both stop before a pixel)
    "jpeg_at_pixels": (jpeg_sized, (32768, 32768), {"ended": False}),
    "jpeg_over_pixels": (jpeg_sized, (32768, 32769), {}),
    "jpeg_far_over": (jpeg_sized, (40000, 30000), {}),
    # libjpeg refuses a side over 65,500 before OpenCV counts pixels
    "jpeg_side_65501": (jpeg_sized, (65501, 16400), {}),
    "png_over_pixels": (png_sized, (40000, 30000), {}),
    # libpng's user limit: a side over 1,000,000 gives None
    "png_side_1000001": (png_sized, (1000001, 1), {}),
    "png_side_over": (png_sized, (SIDE + 1, 1), {}),
}
for _name, _fn in (("bmp", bmp_sized), ("ppm", ppm_sized),
                   ("tiff", tiff_sized), ("sun", sun_sized)):
    SIZED[f"{_name}_at_side"] = (_fn, (SIDE, 1), {})
    SIZED[f"{_name}_width_over"] = (_fn, (SIDE + 1, 1), {})
    SIZED[f"{_name}_height_over"] = (_fn, (1, SIDE + 1), {})
    SIZED[f"{_name}_over_pixels"] = (_fn, (40000, 30000), {})


@pytest.mark.parametrize("case", sorted(SIZED))
def test_size_limits_as_cv2(case, monkeypatch):
    fn, (w, h), kw = SIZED[case]
    data = fn(w, h, **kw)
    want = cv_outcome(data)
    over = w > CV_MAX_SIDE or h > CV_MAX_SIDE or w * h > CV_MAX_PIXELS
    loads = []
    real_load = ImageFile.ImageFile.load
    monkeypatch.setattr(ImageFile.ImageFile, "load",
                        lambda im: loads.append(im.size) or real_load(im))
    if isinstance(want, str):
        with pytest.raises(ImageDecodeError, match="exceeds OpenCV's decode "
                           "limit of 1073741824 pixels and 1048576 on a "
                           "side"):
            decode_image(data)
        assert loads == []                # raised before any pixel
    else:
        assert_same(decode_image(data), want)
    assert isinstance(want, str) == (over and not case.startswith(
        ("jpeg_side", "png_side_1", "png_side_over")))


def test_read_image_raises_where_imread_raises(tmp_path):
    path = str(tmp_path / "big.jpg")
    with open(path, "wb") as f:
        f.write(jpeg_sized(40000, 30000))
    with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
        cv2.imread(path)
    with pytest.raises(ImageDecodeError, match="decode limit"):
        read_image(path)


# -- entry points against JAX -------------------------------------------------

ENTRY = dict(FILES, **{"over_limit.jpg": jpeg_sized(40000, 30000)})
JPEGS = ("clean.jpg", "corrupt_decodes.jpg", "corrupt_refused.jpg",
         "truncated.jpg", "over_limit.jpg")


def _outcome(fn):
    """("ok", value) or ("raises", exception type name)."""
    try:
        return "ok", fn()
    except Exception as e:                       # noqa: BLE001
        return "raises", type(e).__name__


@pytest.mark.parametrize("name", JPEGS + ("icon.ico",))
def test_renderer_on_each_stream_matches_jax(name):
    data = image_pdf([(ENTRY[name], "DCTDecode", 400, 300, "DeviceRGB",
                       PLACEMENTS[0])])
    with JDoc.open(data) as jd, PdfDocument.open(data) as td:
        got = _outcome(lambda: render_page(td, td.load_page(0)))
        want = _outcome(lambda: jrender(jd, jd.load_page(0)))
    if name == "over_limit.jpg":
        assert want == ("raises", "error") and got == ("raises",
                                                       "ImageDecodeError")
        return
    assert got[0] == want[0] == "ok"
    np.testing.assert_array_equal(got[1], want[1])
    drawn = (got[1] != 255).any()
    assert drawn == (name in ("clean.jpg", "corrupt_decodes.jpg"))


def test_runner_contains_an_over_limit_scan_as_jax_does():
    data = image_pdf([(ENTRY["over_limit.jpg"], "DCTDecode", 400, 300,
                       "DeviceRGB", PLACEMENTS[0])])
    jdoc, doc = JDoc.open(data), PdfDocument.open(data)
    want = jbr.BatchPipeline(JConfig(use_layout=False, use_table=False)).run(
        [{"pdf_page": jdoc.load_page(0), "pdf_doc": jdoc, "page": 0}])
    got = BatchPipeline(OcrSystemConfig(use_layout=False, use_table=False),
                        device="cpu").run(
        [{"pdf_page": doc.load_page(0), "pdf_doc": doc, "page": 0}])
    assert want[0].metric["error"].startswith("error: OpenCV(5.0.0)")
    assert "CV_IO_MAX_IMAGE_PIXELS" in want[0].metric["error"]
    assert got[0].metric["error"].startswith("ImageDecodeError: ")
    assert "decode limit of 1073741824 pixels" in got[0].metric["error"]
    assert (got[0].page, got[0].is_pdf) == (want[0].page, want[0].is_pdf)


def test_read_pdf_on_an_over_limit_scan_raises_as_jax(tmp_path):
    path = str(tmp_path / "scan.pdf")
    with open(path, "wb") as f:
        f.write(image_pdf([(ENTRY["over_limit.jpg"], "DCTDecode", 400, 300,
                            "DeviceRGB", PLACEMENTS[0])]))
    assert _outcome(lambda: jread_pdf(path, flavor="lattice")) == \
        ("raises", "error")
    assert _outcome(lambda: read_pdf(path, flavor="lattice")) == \
        ("raises", "ImageDecodeError")


def _digest(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


class StubRunner:
    """A runner that answers each page with its image's digest."""

    def run(self, pages):
        return [types.SimpleNamespace(page=p["page"], table_html=[],
                                      page_html=_digest(p["image"]),
                                      metric={}) for p in pages]


def _post(port, body, ctype):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/extract", body, {"Content-Type": ctype})
    r = conn.getresponse()
    out = r.status, json.loads(r.read())
    conn.close()
    return out


@pytest.fixture(scope="module")
def services():
    svc = serve.ExtractionService(OcrSystemConfig(), batch_pages=2,
                                  max_wait_ms=5.0, device="cpu")
    jsvc = jserve.ExtractionService(JConfig(), batch_pages=2,
                                    max_wait_ms=5.0, warm=False)
    svc.pipeline = jsvc.pipeline = StubRunner()
    srvs = [mod.make_server(s, "127.0.0.1", 0)
            for mod, s in ((serve, svc), (jserve, jsvc))]
    for s in srvs:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield [s.server_address[1] for s in srvs]
    for s in srvs:
        s.shutdown()
    svc.close()
    jsvc.close()


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_service_answers_each_payload_as_jax(name, services):
    port, jport = services
    body = ENTRY[name]
    (status, got), (jstatus, want) = (_post(p, body, "image/x-scan")
                                      for p in (port, jport))
    assert status == jstatus
    if name == "over_limit.jpg":
        assert status == 500
        assert want["error"].startswith("RuntimeError: error: OpenCV(5.0.0)")
        assert got["error"].startswith("RuntimeError: ImageDecodeError: ")
        assert "decode limit" in got["error"]
        return
    assert got == want
    if cv_outcome(body) is None:             # the service decodes in memory
        assert (status, got) == (500, {"error": "RuntimeError: ValueError: "
                                                "undecodable image payload"})
    else:
        assert got["pages"][0]["html"] == _digest(cv_outcome(body))


def _stub_system(image=None, page=0, src_id=None, **_):
    return types.SimpleNamespace(page_html=_digest(image), debug={},
                                 to_metric_dict=lambda: {"page": page})


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_cli_on_each_image_file_matches_jax(name, tmp_path):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(ENTRY[name])
    runs = []
    for cls, args in ((tmain.PdfTableCli, PdfTableCliArguments),
                      (jmain.PdfTableCli, JArgs)):
        cli = cls.__new__(cls)
        cli.args = args(file_path_or_url=path,
                        output_dir=str(tmp_path / cls.__module__))
        cli.system = _stub_system

        def run(cli=cli):
            with open(cli.run_extract_pdf_table()["html"]) as f:
                return f.read()
        runs.append(_outcome(run))
    got, want = runs
    if name == "over_limit.jpg":
        assert (got, want) == (("raises", "ImageDecodeError"),
                               ("raises", "error"))
    else:
        assert got == want
        assert (got[0] == "ok") == (cv_read(path) is not None)


class _Captured(Exception):
    pass


def _capture(image):
    raise _Captured(image)


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_text_task_and_document_read_paths_as_jax(name, tmp_path):
    """``OcrTextTask`` and ``OcrDocument`` on an image path: the image
    that reaches the models is cv2's; where cv2 gives None both raise
    (JAX's ``cvtColor`` of None, the port's ``FileNotFoundError``), and
    over the limit both raise."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(ENTRY[name])
    want_img = cv_read(path) if name != "over_limit.jpg" else None
    for task_cls in (OcrTextTask, JOcrTextTask):
        task = task_cls.__new__(task_cls)
        task.pre_process_image = _capture
        try:
            task(path)
            outcome = None
        except _Captured as e:
            outcome = e.args[0]
        except Exception as e:                   # noqa: BLE001
            outcome = type(e).__name__
        if isinstance(want_img, np.ndarray):
            np.testing.assert_array_equal(outcome, want_img)
        else:
            assert isinstance(outcome, str)
    got = _outcome(lambda: OcrDocument._read_image(path))
    want = _outcome(lambda: JOcrDocument._read_image(path))
    if isinstance(want_img, np.ndarray):
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[0] == want[0] == "raises"
        assert want[1] == "error"
        assert got[1] == ("ImageDecodeError" if name == "over_limit.jpg"
                          else "FileNotFoundError")
