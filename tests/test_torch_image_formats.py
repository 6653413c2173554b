"""The port's own image readers (``pdf_table_tpu_torch/utils/cv_readers.py``
through ``utils/image_io.py::decode_image``) held to ``cv2.imdecode``
(OpenCV 5.0.0, ``IMREAD_COLOR`` then BGR -> RGB) on this box, case by case,
on the decodes where PIL alone parts from OpenCV (ROADMAP.md Queue 3,
F10-F15): the same array bit for bit, None where cv2 gives None, an
:class:`ImageDecodeError` where cv2 raises.

- PNM P1-P6 at maxval 1, 15, 100, 255, 256, 1000, 4095 and 65535, ASCII
  and binary, with comments and a sample above the maxval, and the header
  and data faults OpenCV's ``ReadNumber`` and ``getBytes`` stop on;
- 16-bit colour TIFF and PPM on full-range samples, beside the 16-bit
  grey TIFF / PGM / PNG and colour PNG that PIL already gave;
- YCbCr and CIELAB TIFF, raw and compressed; the TIFF orientations, a
  BigTIFF, and the codecs OpenCV's libtiff lacks;
- a wrong CRC on each chunk of a PNG, and unknown chunks;
- 450 seeded 3-byte corruptions of a 400 x 300 GIF and of a TIFF (LZW and
  deflate); hand-built GIFs for the first frame's placement, canvas,
  transparency, colour tables, interlace, code sizes and a full LZW table;
  a header-patched GIF over PIL's 178,956,970-pixel check;
- every depth and channel count that cv2 writes as HDR, PAM and PFM, and
  hand-built PAM headers;
- colour-mapped 1-bit Sun rasters;
- cv2-written 8- and 16-bit, grey and colour JPEG 2000, PIL-written J2K
  codestreams, and codestreams whose precision or sign OpenCV refuses."""

import importlib.util
import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, PngImagePlugin

from pdf_table_tpu_torch.utils.image_io import ImageDecodeError, decode_image

torch.set_num_threads(1)

RAISES = "raises"
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(os.path.dirname(__file__), "data",
                                  "image_decode", "make_fixtures.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


def cv_outcome(data: bytes):
    """cv2's RGB decode, None, or RAISES where it raises ``cv2.error``."""
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


def same(got, want) -> bool:
    if isinstance(want, str) or want is None:
        return (got if isinstance(got, str) or got is None
                else "image") == want
    return (isinstance(got, np.ndarray) and got.dtype == np.uint8
            and got.shape == want.shape and np.array_equal(got, want))


def assert_as_cv2(data: bytes):
    """The port's outcome is cv2's; returns cv2's."""
    want = cv_outcome(data)
    got = port_outcome(data)
    assert same(got, want), (
        f"port {None if got is None else getattr(got, 'shape', got)}, cv2 "
        f"{None if want is None else getattr(want, 'shape', want)}")
    return want


def pil(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


RNG = np.random.default_rng(22)
RGB = RNG.integers(0, 256, (30, 41, 3), dtype=np.uint8)
FULL16 = RNG.integers(0, 65536, (30, 41, 3)).astype(np.uint16)


# -- PNM (F11, F12) ----------------------------------------------------------

def pnm(kind, samples, maxval, comment=False) -> bytes:
    """P``kind`` of (h, w, c) ``samples``: ASCII for P1-P3, binary (16-bit
    big-endian over maxval 255) for P4-P6."""
    h, w = samples.shape[:2]
    head = b"P%d\n" % kind + (b"# a comment\n" if comment else b"") \
        + b"%d %d\n" % (w, h)
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    if kind in (1, 2, 3):
        body = b" \n".join(b" ".join(b"%d" % v for v in row)
                           for row in samples.reshape(h, -1)) + b"\n"
    elif kind == 4:
        body = np.packbits(samples.reshape(h, w), axis=1).tobytes()
    else:
        body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + body


PNM_CASES = [(k, 1) for k in (1, 4)] + [
    (k, m) for k in (2, 3, 5, 6)
    for m in (1, 15, 100, 255, 256, 1000, 4095, 65535)]


@pytest.mark.parametrize("kind,maxval", PNM_CASES,
                         ids=[f"P{k}-{m}" for k, m in PNM_CASES])
def test_pnm_as_cv2(kind, maxval):
    """ASCII samples are clamped to the maxval and scaled, binary ones
    taken as they are (also above the maxval), 16-bit ones by their high
    byte; with and without a comment."""
    nch = 3 if kind in (3, 6) else 1
    top = 1 if kind in (1, 4) else maxval
    rng = np.random.default_rng(kind * 100000 + maxval)
    samples = rng.integers(0, top + 1, (9, 13, nch))
    if kind in (2, 3):
        samples.flat[5] = maxval + 7                 # clamped
    elif kind in (5, 6) and maxval < 255:
        samples.flat[5] = 200 if maxval == 100 else maxval + 3
    for comment in (False, True):
        want = assert_as_cv2(pnm(kind, samples, maxval, comment))
        assert isinstance(want, np.ndarray)


def test_pnm_probes_of_the_issue_part_from_pil():
    """Where PIL scales (maxval 15, 100, 1000, 4095) or clamps a sample
    above the maxval, cv2 does not; the port gives cv2's."""
    parted = 0
    for kind, maxval in ((5, 15), (6, 100), (2, 100), (5, 1000), (3, 4095)):
        nch = 3 if kind in (3, 6) else 1
        samples = np.random.default_rng(maxval).integers(
            0, maxval + 1, (9, 13, nch))
        data = pnm(kind, samples, maxval)
        want = assert_as_cv2(data)
        theirs = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        parted += not np.array_equal(theirs, want)
    assert parted == 5


PNM_FAULTS = {
    "ascii_without_last_separator": b"P2\n2 1\n255\n1 2",
    "hash_ends_a_number": b"P2\n2 1\n255#c\n1 2\n",
    "comment_after_space": b"P2\n2 1 #c\n255\n1 2\n",
    "comment_ended_by_cr": b"P2\n#x\r2 1\n255\n1 2\n",
    "letter_in_samples": b"P2\n2 1\n255\n1 x\n",
    "binary_short": b"P5\n2 2\n255\n\x01\x02\x03",
    "binary_exact": b"P5\n2 2\n255\n\x01\x02\x03\x04",
    "p4_short": b"P4\n9 2\n\xff\x80\xff",
    "p1_digits_run_together": b"P1\n3 2\n010110",
    "maxval_0": b"P5\n1 1\n0\n\x00",
    "maxval_65536": b"P5\n1 1\n65536\n\x00\x00",
    "p6_16bit_short": b"P6\n1 1\n1000\n\x01\x02\x03\x04\x05",
    "tabs": b"P5\t1 1\t255\t\x07",
    "no_space_after_magic": b"P5#\n1 1 255 \x07",
    "width_0": b"P5\n0 1\n255\n\x07",
    "huge_number": b"P5\n99999999999 1\n255\n\x07",
}


@pytest.mark.parametrize("case", sorted(PNM_FAULTS))
def test_pnm_header_and_data_faults_as_cv2(case):
    assert_as_cv2(PNM_FAULTS[case])


def test_pnm_over_the_size_limit_raises_as_cv2():
    assert assert_as_cv2(b"P5\n40000 30000\n255\n\x07") == RAISES


# -- 16-bit colour TIFF and PPM (F12) ----------------------------------------

SIXTEEN = {
    "tiff_colour": (".tiff", FULL16),
    "tiff_colour_lzw": (".tiff", FULL16, [cv2.IMWRITE_TIFF_COMPRESSION, 5]),
    "tiff_colour_deflate": (".tiff", FULL16,
                            [cv2.IMWRITE_TIFF_COMPRESSION, 8]),
    "tiff_rgba": (".tiff", np.dstack([FULL16, FULL16[..., :1]])),
    "ppm_colour": (".ppm", FULL16),
    "tiff_grey": (".tiff", FULL16[..., 0]),
    "pgm_grey": (".pgm", FULL16[..., 0]),
    "png_grey": (".png", FULL16[..., 0]),
    "png_colour": (".png", FULL16),
}


@pytest.mark.parametrize("case", sorted(SIXTEEN))
def test_full_range_16bit_as_cv2(case):
    """cv2 rounds a 16-bit colour TIFF sample (libtiff's RGBA table) and
    takes the high byte of a PPM's; the port gives each."""
    ext, arr, *params = SIXTEEN[case]
    ok, enc = cv2.imencode(ext, arr, *params)
    assert ok
    want = assert_as_cv2(enc.tobytes())
    rgb = FULL16[..., ::-1] if arr.ndim == 3 else \
        np.repeat(FULL16[..., :1], 3, axis=2)
    high = (rgb >> 8).astype(np.uint8)
    rounded = ((rgb.astype(np.uint32) * 255 + 32767) // 65535).astype(
        np.uint8)
    colour_tiff = case.startswith("tiff") and arr.ndim == 3
    np.testing.assert_array_equal(want, rounded if colour_tiff else high)


def test_ascii_16bit_ppm_as_cv2():
    assert_as_cv2(pnm(3, FULL16[:6, :7].astype(np.int64), 65535))


# -- TIFF (F12, F13, F10) ----------------------------------------------------

def _lab():
    return Image.frombytes("LAB", (41, 30), RGB.tobytes())


TIFFS = {}
for _comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits", "jpeg"):
    TIFFS[f"ycbcr-{_comp}"] = (lambda: Image.fromarray(RGB).convert("YCbCr"),
                               _comp)
    if _comp != "jpeg":
        TIFFS[f"cielab-{_comp}"] = (_lab, _comp)
for _comp in ("zstd", "lzma", "tiff_deflate"):
    TIFFS[f"rgb-{_comp}"] = (lambda: Image.fromarray(RGB), _comp)
for _mode in ("RGB", "L", "P", "1", "CMYK", "RGBA", "LA", "I", "F"):
    TIFFS[f"{_mode}-raw"] = (lambda m=_mode: Image.fromarray(RGB).convert(m),
                             None)


@pytest.mark.parametrize("case", sorted(TIFFS))
def test_tiff_as_cv2(case):
    """YCbCr and CIELAB through libtiff's RGBA conversions; ZSTD and LZMA,
    which OpenCV's libtiff is built without, give None."""
    make, comp = TIFFS[case]
    want = assert_as_cv2(pil(make(), "TIFF",
                             **({"compression": comp} if comp else {})))
    assert (want is None) == (case.split("-")[1] in ("zstd", "lzma")
                              or case.startswith(("I-", "F-")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientations_as_cv2(orientation):
    im = Image.fromarray(RGB)
    for kw in ({}, {"tiffinfo": {274: orientation, 278: 7}}):
        if not kw:
            kw = {"tiffinfo": {274: orientation}}
        want = assert_as_cv2(pil(im, "TIFF", **kw))
        assert want.shape[:2] == ((41, 30) if orientation >= 5 else (30, 41))


def test_bigtiff_and_an_unknown_codec_as_cv2():
    assert isinstance(assert_as_cv2(pil(Image.fromarray(RGB), "TIFF",
                                        big_tiff=True)), np.ndarray)
    data = bytearray(pil(Image.fromarray(RGB), "TIFF",
                         compression="tiff_lzw"))
    off = struct.unpack("<I", data[4:8])[0]
    for k in range(struct.unpack("<H", data[off:off + 2])[0]):
        e = off + 2 + 12 * k
        if struct.unpack("<H", data[e:e + 2])[0] == 259:
            data[e + 8:e + 10] = struct.pack("<H", 64)   # no such scheme
    assert isinstance(assert_as_cv2(bytes(data)), np.ndarray)


@pytest.fixture(scope="module")
def grey_strips():
    """make_fixtures.py's deflate strips of grey: 16,400² (4 W H bytes as
    RGBA over 2^30) and 16,000² (in [0.95, 1) x 2^30)."""
    return {side: tool.grey_strip(side) for side in (16400, 16000)}


LARGE_TIFFS = {
    "grey_16400": (16400, {"photometric": 1}),
    "palette_16400": (16400, {"photometric": 3, "colormap": list(range(
        0, 65536, 257)) * 3}),
    "tiled_16400": (16400, {"photometric": 1, "tiled": True}),
    "white_bottom_right_16000": (16000, {"photometric": 0,
                                         "orientation": 3}),
}


@pytest.mark.parametrize("case", sorted(LARGE_TIFFS))
def test_large_tiff_strips_as_cv2(grey_strips, case):
    """Where a strip as RGBA reaches 0.95 x 2^30 bytes, OpenCV reads a
    stripped grey or RGB TIFF a scanline at a time, its samples as they
    stand: a single strip of 16,400² decodes where its RGBA buffer would
    pass 1 GiB, white-is-zero is not inverted and a bottom-up orientation
    not flipped. A palette or tiled one gives None there."""
    side, kw = LARGE_TIFFS[case]
    want = assert_as_cv2(tool.strip_tiff(grey_strips[side], side, side,
                                         **kw))
    if case.startswith(("palette", "tiled")):
        assert want is None
    else:
        x, y = np.arange(side), np.arange(3)[:, None]
        np.testing.assert_array_equal(want[:3, :, 1], (x + 7 * y) % 251)


# -- PNG CRCs (F14) ----------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body \
        + struct.pack(">I", zlib.crc32(kind + body))


def _png_chunks(data: bytes):
    pos, out = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((kind, pos, pos + 12 + n))
        pos += 12 + n
    return out


def _png_sample() -> bytes:
    """A palette PNG with text before the palette, tRNS, gAMA, pHYs, two
    IDATs and text after them."""
    info = PngImagePlugin.PngInfo()
    info.add_text("before", "a")
    data = pil(Image.fromarray(RGB).convert("P"), "PNG", pnginfo=info,
               transparency=3, dpi=(72, 72))
    chunks = _png_chunks(data)
    idat = [c for c in chunks if c[0] == b"IDAT"][0]
    body = data[idat[1] + 8:idat[2] - 4]
    half = len(body) // 2
    gama = [c for c in chunks if c[0] == b"PLTE"][0][1]
    return (data[:gama] + _chunk(b"gAMA", struct.pack(">I", 45455))
            + data[gama:idat[1]] + _chunk(b"IDAT", body[:half])
            + _chunk(b"IDAT", body[half:]) + _chunk(b"tEXt", b"after\0b")
            + data[idat[2]:])


PNG = _png_sample()
PNG_CHUNKS = [f"{k.decode()}{i}" for i, (k, _, _) in
              enumerate(_png_chunks(PNG))]


@pytest.mark.parametrize("chunk", PNG_CHUNKS)
def test_png_crc_of_each_chunk_as_cv2(chunk):
    """libpng: a wrong CRC on a critical chunk before IEND gives None, on
    an ancillary chunk drops the chunk, on IEND is let pass."""
    i = PNG_CHUNKS.index(chunk)
    _, _, end = _png_chunks(PNG)[i]
    data = PNG[:end - 1] + bytes([PNG[end - 1] ^ 0x5A]) + PNG[end:]
    want = assert_as_cv2(data)
    assert (want is None) == (chunk[:4] in ("IHDR", "PLTE", "IDAT"))


def test_png_unknown_chunks_as_cv2():
    idat = PNG.index(b"IDAT") - 4
    for kind in (b"ABCD", b"abCD"):
        want = assert_as_cv2(PNG[:idat] + _chunk(kind, b"xyz") + PNG[idat:])
        assert (want is None) == (kind == b"ABCD")


# -- GIF (F10) ---------------------------------------------------------------

def lzw_literals(indices, min_size=8, full=False, after_end=()) -> bytes:
    """An LZW stream of literal codes only: a clear code before the code
    size would grow, or (``full``) none, so that the table fills; codes
    ``after_end`` follow the end-of-information code."""
    clear = 1 << min_size
    size, table = min_size + 1, clear + 1
    codes = [(clear, size)]
    for v in indices:
        if not full and table + 1 == 1 << size:
            codes.append((clear, size))
            table = clear + 1
        codes.append((int(v), size))
        table = min(table + 1, 4096)
        if table == 1 << size and size < 12:
            size += 1
    codes.append((clear + 1, size))
    codes += [(v, min_size + 1) for v in after_end]
    out, acc, nbits = bytearray(), 0, 0
    for code, n in codes:
        acc |= code << nbits
        nbits += n
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    return bytes(out)


def gif(screen, frame, left=0, top=0, gct=None, lct=None, bg=0,
        transparent=None, disposal=0, interlace=False, min_size=8,
        full=False, gce_len=4, extra=b"", lzw=None) -> bytes:
    """A one-frame GIF89a of (h, w) colour indices ``frame``."""
    h, w = frame.shape

    def table_flags(table):
        k = int(np.log2(len(table))) - 1
        return 0x80 | k

    out = b"GIF89a" + struct.pack("<HH", *screen)
    flags = table_flags(gct) | (7 << 4) if gct is not None else 0
    out += bytes([flags, bg, 0]) + (gct.tobytes() if gct is not None
                                    else b"")
    if transparent is not None or disposal:
        out += b"\x21\xf9" + bytes([gce_len, disposal << 2
                                    | (transparent is not None), 0, 0,
                                    transparent or 0]) \
            + b"\0" * (gce_len - 4) + b"\0"
    out += extra + b"\x2c" + struct.pack("<HHHH", left, top, w, h)
    flags = (0x40 if interlace else 0) | (table_flags(lct) if lct is not None
                                          else 0)
    out += bytes([flags]) + (lct.tobytes() if lct is not None else b"")
    rows = np.arange(h)
    if interlace:
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                               rows[1::2]])
    data = lzw if lzw is not None else lzw_literals(
        frame[rows].ravel(), min_size, full)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return out + bytes([min_size]) + blocks + b"\0\x3b"


PAL = np.random.default_rng(7).integers(0, 256, (256, 3), dtype=np.uint8)
FRAME = np.random.default_rng(8).integers(0, 256, (20, 30), dtype=np.uint8)
F16 = (FRAME % 16).astype(np.uint8)
F8 = (np.arange(256).reshape(16, 16) % 8).astype(np.uint8)
GIFS = {
    "plain": dict(screen=(30, 20), frame=FRAME, gct=PAL),
    "interlaced": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                       interlace=True),
    "placed": dict(screen=(50, 40), frame=FRAME, left=7, top=9, gct=PAL,
                   bg=5),
    "placed_disposal1": dict(screen=(50, 40), frame=FRAME, left=7, top=9,
                             gct=PAL, bg=5, disposal=1),
    "placed_disposal2": dict(screen=(50, 40), frame=FRAME, left=7, top=9,
                             gct=PAL, bg=5, disposal=2),
    "placed_disposal3": dict(screen=(50, 40), frame=FRAME, left=7, top=9,
                             gct=PAL, bg=5, disposal=3),
    "placed_without_global_table": dict(screen=(50, 40), frame=F16, left=3,
                                        top=3, lct=PAL[:16], bg=7,
                                        min_size=4),
    "spills_right": dict(screen=(30, 20), frame=FRAME, left=1, gct=PAL),
    "spills_down": dict(screen=(30, 20), frame=FRAME, top=1, gct=PAL),
    "transparent": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                        transparent=int(FRAME[0, 0])),
    "transparent_is_background": dict(
        screen=(50, 40), frame=FRAME, left=3, top=4, gct=PAL,
        bg=int(FRAME[0, 0]), transparent=int(FRAME[0, 0]), disposal=2),
    "transparent_past_table": dict(screen=(16, 16), frame=F8 % 4, gct=PAL[:4],
                                   transparent=7, min_size=3),
    "local_table": dict(screen=(30, 20), frame=F16, lct=PAL[:16],
                        min_size=4),
    "local_and_global": dict(screen=(30, 20), frame=F16, gct=PAL,
                             lct=PAL[16:32], min_size=4),
    "index_past_local_into_global": dict(screen=(16, 16), frame=F8,
                                         gct=PAL, lct=PAL[:4], min_size=3),
    "index_past_both_tables": dict(screen=(16, 16), frame=F8, gct=PAL[4:8],
                                   lct=PAL[:4], min_size=3),
    "index_past_global": dict(screen=(30, 20), frame=FRAME, gct=PAL[:16]),
    "no_table": dict(screen=(30, 20), frame=FRAME),
    "background_past_table": dict(screen=(30, 20), frame=F16, gct=PAL[:16],
                                  bg=200, min_size=4),
    "full_table": dict(screen=(100, 80), frame=np.random.default_rng(9)
                       .integers(0, 256, (80, 100), dtype=np.uint8),
                       gct=PAL, full=True),
    "codes_after_end": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                            lzw=lzw_literals(FRAME.ravel(),
                                             after_end=(5, 6, 7))),
    "short_data": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                       lzw=lzw_literals(FRAME.ravel()[:-5])),
    "long_data": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                      lzw=lzw_literals(np.append(FRAME.ravel(), [1, 2]))),
    "control_block_of_5": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                               transparent=3, gce_len=5),
    "comment_extension": dict(screen=(30, 20), frame=FRAME, gct=PAL,
                              extra=b"\x21\xfe\x05hello\x00"),
    "application_extension": dict(
        screen=(30, 20), frame=FRAME, gct=PAL,
        extra=b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"),
    "empty_screen": dict(screen=(0, 20), frame=FRAME, gct=PAL),
}
for _m in (1, 2, 3, 4, 5, 6, 7):
    GIFS[f"min_code_size_{_m}"] = dict(
        screen=(30, 20), frame=(FRAME % (1 << _m)).astype(np.uint8),
        gct=PAL[:max(2, 1 << _m)], min_size=_m)


@pytest.mark.parametrize("case", sorted(GIFS))
def test_hand_built_gifs_as_cv2(case):
    want = assert_as_cv2(gif(**GIFS[case]))
    refused = ("spills_right", "spills_down", "index_past_both_tables",
               "index_past_global", "background_past_table",
               "codes_after_end", "short_data", "long_data",
               "control_block_of_5", "empty_screen", "min_code_size_1")
    assert (want is None) == (case in refused)


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1", "LA", "RGBA"])
def test_pil_written_gifs_as_cv2(mode):
    im = Image.fromarray(RGB).convert(mode)
    for kw in ({}, {"interlace": False}, {"transparency": 0, "disposal": 2}):
        if mode in ("RGB", "L", "1", "LA") and "transparency" in kw:
            continue
        assert isinstance(assert_as_cv2(pil(im, "GIF", **kw)), np.ndarray)


@pytest.fixture(scope="module")
def big_gif():
    """tests/data/image_decode/make_fixtures.py's blurred 400 x 300 image
    as PIL writes it as GIF (interlaced)."""
    return pil(Image.open(io.BytesIO(tool.blurred_jpeg())), "GIF")


@pytest.mark.parametrize("lo", [100, 800])
def test_corrupt_gifs_as_cv2(big_gif, lo):
    """450 copies with three bytes set at random after byte ``lo``: cv2's
    decoder fails on a bad code, on data past the frame's pixels and on
    data that stops short of them, where PIL reads on."""
    kinds = {"image": 0, "none": 0, "pil_reads": 0}
    for data in tool.corruptions(big_gif, 450, lo):
        want = assert_as_cv2(data)
        kinds["none" if want is None else "image"] += 1
        if want is None:
            try:
                Image.open(io.BytesIO(data)).load()
                kinds["pil_reads"] += 1
            except (OSError, SyntaxError):
                pass
    assert kinds["image"] >= 20 and kinds["none"] >= 400
    assert kinds["pil_reads"] >= 100


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
def test_corrupt_tiffs_as_cv2(compression):
    data = pil(Image.open(io.BytesIO(tool.blurred_jpeg())), "TIFF",
               compression=compression)
    for bad in tool.corruptions(data, 450, 100):
        assert_as_cv2(bad)


def test_gif_over_pils_bomb_check_decodes_as_cv2():
    """A screen of 16,384 x 10,923 (178,962,432 pixels, over PIL's
    178,956,970) holding a 30 x 20 frame at (100, 200) with disposal 2:
    cv2 decodes it, its canvas the background colour."""
    data = gif(screen=(16384, 10923), frame=FRAME, left=100, top=200,
               gct=PAL, bg=9, disposal=2)
    got = decode_image(data)
    want = cv_outcome(data)
    assert got.shape == want.shape == (10923, 16384, 3)
    assert np.array_equal(got, want)
    del want
    np.testing.assert_array_equal(got[0, 0], PAL[9])
    np.testing.assert_array_equal(got[200:220, 100:130], PAL[FRAME])


# -- HDR, PAM, PFM (F10, F15) ------------------------------------------------

def _cv_arrays():
    a = RGB
    return {"u8": a, "u16": FULL16, "grey": a[..., 0],
            "grey16": FULL16[..., 0], "rgba": np.dstack([a, a[..., :1]]),
            "two": a[..., :2], "i8": a.astype(np.int8),
            "f32": a.astype(np.float32) / 255,
            "f32_wide": (np.random.default_rng(4).standard_normal(
                a.shape) * 300).astype(np.float32),
            "f32_grey": a[..., 0].astype(np.float32) / 255,
            "f32_specials": np.array(
                [np.nan, np.inf, -np.inf, 3e9, -3e9, 0.5, 1.5, 2.5, 254.5,
                 255.5, -0.5, -0.6], np.float32)[None, :, None].repeat(
                    3, 0).repeat(3, 2) / 255,
            "f64": a.astype(np.float64) / 255}


def _cv_written():
    out = {}
    for ext in (".hdr", ".pam", ".pfm"):
        for kind, arr in _cv_arrays().items():
            params = [[]]
            if ext == ".hdr":
                params.append([cv2.IMWRITE_HDR_COMPRESSION,
                               cv2.IMWRITE_HDR_COMPRESSION_NONE])
            for k, p in enumerate(params):
                try:
                    ok, enc = cv2.imencode(ext, arr, p)
                except cv2.error:
                    continue
                if ok:
                    out[f"{ext[1:]}-{kind}{'-flat' if k else ''}"] = \
                        enc.tobytes()
    return out


CV_WRITTEN = _cv_written()


@pytest.mark.parametrize("case", sorted(CV_WRITTEN))
def test_hdr_pam_pfm_cv2_writes_as_cv2(case):
    """Every depth and channel count that cv2 writes: HDR's RGBE scaled by
    255, PAM's samples as they stand, PFM's floats rounded half to even (a
    grey PFM comes out grey in three channels, as OpenCV's BGR -> RGB makes
    its one channel)."""
    assert_as_cv2(CV_WRITTEN[case])


def test_formats_cv2_writes_include_hdr_pam_pfm():
    kinds = {c.split("-")[0] for c in CV_WRITTEN
             if isinstance(cv_outcome(CV_WRITTEN[c]), np.ndarray)}
    assert kinds == {"hdr", "pam", "pfm"}
    assert len(CV_WRITTEN) >= 30


def pam(w, h, depth, maxval, tuple_type, body) -> bytes:
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tuple_type is not None:
        head += b"TUPLTYPE " + tuple_type + b"\n"
    return head + b"ENDHDR\n" + body


PAM_CASES = [(t, d, m) for t in (b"BLACKANDWHITE", b"GRAYSCALE", b"RGB",
                                 b"GRAYSCALE_ALPHA", b"RGB_ALPHA", b"FOO",
                                 None)
             for d in (1, 2, 3, 4) for m in (1, 255, 1000)]


@pytest.mark.parametrize(
    "tuple_type,depth,maxval", PAM_CASES,
    ids=[f"{t}-{d}-{m}" for t, d, m in PAM_CASES])
def test_hand_built_pams_as_cv2(tuple_type, depth, maxval):
    """The tuple type must fit the depth; RGB is copied as it stands (so
    reversed after BGR -> RGB); a maxval of 1 reads packed bits. Grey +
    alpha and RGB + alpha over a maxval of 1 are held only where OpenCV
    writes: it converts only the first
    W / 2 resp. W / 4 pixels of each row and leaves the rest of the row as
    its allocation found it (ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(depth * 10000 + maxval)
    s = rng.integers(0, maxval + 1, (3, 8, depth))
    data = pam(8, 3, depth, maxval, tuple_type,
               s.astype(">u2" if maxval > 255 else np.uint8).tobytes())
    want = cv_outcome(data)
    if tuple_type in (b"GRAYSCALE_ALPHA", b"RGB_ALPHA") and maxval > 1 \
            and isinstance(want, np.ndarray):
        got = decode_image(data)
        n = 8 // depth                         # the converted pixels
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
        assert (got[:, n:] == 0).all()
        return
    assert same(port_outcome(data), want)


def test_pam_and_pfm_headers_as_cv2():
    body = bytes(range(24))
    for data in (pam(8, 3, 1, 255, b"", body), pam(0, 3, 1, 255, None, body),
                 pam(8, 3, 1, 65536, None, body),
                 b"P7\nWIDTH 8\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
                 b"P7\n# c\nWIDTH 8\nHEIGHT 3\nDEPTH 1\nMAXVAL 0x10\nENDHDR"
                 b"\n" + body,
                 pam(8, 3, 1, -16, None, body), pam(8, 3, 1, 16, b"", body),
                 b"P7\nWIDTH 010\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\nENDHDR"
                 b"\n" + body,
                 b"P7\nWIDTH +8\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\nENDHDR"
                 b"\n" + body,
                 b"PF\n2 1\n-1.0\n" + np.float32([1, 2, 3, 4, 5, 6]).tobytes(),
                 b"PF\n2 1\n2.0\n" + np.float32([1, 2, 3, 4, 5, 6]).astype(
                     ">f4").tobytes(),
                 b"Pf\n2 1\n-1.0\n" + np.float32([1, 2]).tobytes()[:-1],
                 b"PF 2 1\n-1.0\n" + bytes(24), b"Pf\n0 1\n-1\n"):
        assert_as_cv2(data)


def test_hdr_headers_as_cv2():
    ok, enc = cv2.imencode(".hdr", RGB.astype(np.float32) / 255)
    data = enc.tobytes()
    i = data.index(b"\n\n")
    assert_as_cv2(data.replace(b"#?RADIANCE", b"#?RGBE", 1))
    assert_as_cv2(data[:i] + b"\nEXPOSURE=1.0" + data[i:])
    for bad in (data.replace(b"FORMAT=32-bit_rle_rgbe", b"FORMAT=xyz", 1),
                data.replace(b"-Y 30 +X 41", b"-Y 0 +X 41", 1)):
        assert assert_as_cv2(bad) is None


# -- Sun rasters of 1 bit with a colour map (F10) ----------------------------

SUN_MAPS = {"two_entries": bytes([10, 200, 30, 40, 50, 250]),
            "one_entry": bytes([10, 200, 30]), "four_bytes": bytes(range(4)),
            "five_bytes": bytes(range(5)), "too_long": bytes(range(9)),
            "black_white": bytes([0, 255, 0, 255, 0, 255])}


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("cmap", sorted(SUN_MAPS))
def test_mapped_1bit_sun_rasters_as_cv2(cmap, kind):
    """The map holds length / 3 entries as R, G and B planes; a missing
    entry is black; a map longer than two entries refuses, and so does a
    byte-encoded raster."""
    bits = np.packbits(RGB[:7, :13, 0] > 127, axis=1)
    rows = np.pad(bits, ((0, 0), (0, bits.shape[1] % 2))).tobytes()
    m = SUN_MAPS[cmap]
    data = struct.pack(">8I", 0x59A66A95, 13, 7, 1, len(rows), kind, 1,
                       len(m)) + m + rows
    want = assert_as_cv2(data)
    assert (want is None) == (cmap == "too_long" or kind == 2)


# -- JPEG 2000 (F10) ---------------------------------------------------------

# OpenJPEG's encoder wants 32 pixels a side at cv2's resolution levels
RGB48 = np.random.default_rng(48).integers(0, 256, (48, 64, 3),
                                           dtype=np.uint8)
FULL48 = np.random.default_rng(49).integers(0, 65536, (48, 64, 3)).astype(
    np.uint16)
JP2_ARRAYS = {"u8": RGB48, "u16": FULL48, "grey": RGB48[..., 0],
              "grey16": FULL48[..., 0],
              "rgba": np.dstack([RGB48, RGB48[..., :1]]),
              "rgba16": np.dstack([FULL48, FULL48[..., :1]]),
              "u16_x257": RGB48.astype(np.uint16) * 257}


@pytest.mark.parametrize("kind", sorted(JP2_ARRAYS))
def test_jpeg2000_cv2_writes_as_cv2(kind):
    """16-bit samples shifted right by 8 (PIL rounds them, and wraps
    65,535 to 0). cv2's own 16-bit JP2 is lossy, so the samples are read
    back, not compared with the array written."""
    ok, enc = cv2.imencode(".jp2", JP2_ARRAYS[kind])
    assert ok
    want = assert_as_cv2(enc.tobytes())
    if kind in ("u16", "rgba16"):
        theirs = np.asarray(Image.open(io.BytesIO(enc.tobytes())).convert(
            "RGB"))
        assert (theirs != want).mean() > 0.3            # PIL rounds


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "I;16"])
@pytest.mark.parametrize("container", ["jp2", "j2k"])
def test_jpeg2000_pil_writes_as_cv2(mode, container):
    """A codestream of one or two components gives None (OpenCV takes it
    for sRGB); in a JP2 that says grey it decodes."""
    im = Image.fromarray(FULL16[..., 0]) if mode == "I;16" else \
        Image.fromarray(RGB).convert(mode)
    want = assert_as_cv2(pil(im, "JPEG2000", no_jp2=container == "j2k"))
    assert (want is None) == (container == "j2k"
                              and mode in ("L", "LA", "I;16"))


@pytest.mark.parametrize("ssiz", [0x03, 0x06, 0x07, 0x0B, 0x0F, 0x87])
def test_jpeg2000_precision_and_sign_as_cv2(ssiz):
    """Each component's precision patched in the SIZ marker: under 8 bits
    or signed refuses; 12 and 16 bits shift by 4 and 8."""
    data = bytearray(pil(Image.fromarray(RGB), "JPEG2000", no_jp2=True))
    at = data.index(b"\xff\x51") + 40
    for c in range(3):
        data[at + 3 * c] = ssiz
    want = assert_as_cv2(bytes(data))
    assert (want is None) == (ssiz in (0x03, 0x06, 0x87))


def test_jpeg2000_truncated_and_corrupt_as_cv2():
    ok, enc = cv2.imencode(".jp2", FULL48)
    data = enc.tobytes()
    for cut in (10, 100, len(data) // 2, len(data) - 10):
        assert_as_cv2(data[:-cut])
    for bad in tool.corruptions(data, 40, 100):
        assert_as_cv2(bad)


@pytest.mark.parametrize("enumcs", [16, 17, 18, 12, 24],
                         ids=["srgb", "grey", "sycc", "cmyk", "e-ycc"])
@pytest.mark.parametrize("kind", ["u8", "u16"])
def test_jpeg2000_colour_spaces_as_cv2(kind, enumcs):
    """The JP2 ``colr`` box's enumerated colour space patched: sYCC goes
    through OpenCV's fixed-point YUV -> BGR, CMYK and e-YCC refuse."""
    ok, enc = cv2.imencode(".jp2", JP2_ARRAYS[kind])
    data = bytearray(enc.tobytes())
    at = data.index(b"colr") + 7
    data[at:at + 4] = struct.pack(">I", enumcs)
    want = assert_as_cv2(bytes(data))
    assert (want is None) == (enumcs in (12, 24))


# -- short data ----------------------------------------------------------------

def _own_format_files():
    """The committed fixtures that the port's own readers take, and
    hand-built files of the variants they lack."""
    root = os.path.join(os.path.dirname(__file__), "data", "image_decode")
    files = {}
    for name in ("maxval100.pgm", "maxval1000.ppm", "rgb16.ppm",
                 "image.pam", "grey.pfm", "colour.pfm", "image.hdr",
                 "mapped_1bit.ras", "rgb16.tiff", "ycbcr.tiff",
                 "cielab.tiff", "rgb16.jp2", "corrupt_lzw.gif"):
        with open(os.path.join(root, name), "rb") as f:
            files[name] = f.read()
    grey = RGB[:9, :13, :1]
    files["p1"] = pnm(1, grey > 127, 1, comment=True)
    files["p2"] = pnm(2, grey, 255, comment=True)
    files["p3"] = pnm(3, RGB[:9, :13], 255)
    files["p4"] = pnm(4, grey > 127, 1)
    files["pam_bits"] = pam(13, 9, 1, 1, b"BLACKANDWHITE", grey.tobytes())
    files["hdr_flat"] = cv2.imencode(
        ".hdr", RGB.astype(np.float32) / 255,
        [cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE]
    )[1].tobytes()
    files["gif"] = gif(screen=(40, 30), frame=FRAME, left=3, top=4,
                       gct=PAL, bg=9)
    return files


OWN_FORMAT_FILES = _own_format_files()


@pytest.mark.parametrize("name", sorted(OWN_FORMAT_FILES))
def test_short_data_of_own_formats_as_cv2(name):
    """Every prefix of the file's first 160 bytes and 96 seeded cuts after
    them: the port gives cv2's outcome, its readers raising nothing but
    their refusal (None) or :class:`ImageDecodeError`."""
    data = OWN_FORMAT_FILES[name]
    assert isinstance(cv_outcome(data), np.ndarray) \
        or name == "corrupt_lzw.gif"
    rng = np.random.default_rng(len(data))
    cuts = set(range(1, min(len(data), 160)))
    if len(data) > 160:
        cuts |= set(rng.integers(160, len(data), 96).tolist())
    for cut in sorted(cuts):
        assert_as_cv2(data[:cut])
