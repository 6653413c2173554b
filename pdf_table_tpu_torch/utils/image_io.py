"""Image files and payloads without OpenCV: what ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_COLOR`` followed by BGR -> RGB give, and
what ``cv2.imwrite`` of an RGB image (turned to BGR) writes.

The file's first bytes pick the reader, as OpenCV 5.0.0's ``findDecoder``
does (``loadsave.cpp``: each decoder's signature, in the order OpenCV
registers them), so that a file never reaches another format's reader.
Two routes:

- PIL, for the formats where PIL's plugin and libraries give OpenCV's
  pixels: BMP, JPEG (and MPO), WebP, AVIF, PNG and the Sun rasters PIL
  reads. Each opens through its own plugin, never ``Image.open``.
  ``IMREAD_COLOR`` decodes to 8-bit, 3 channels: a grey image is repeated
  into three channels, an alpha channel is dropped (not composited), a
  16-bit sample keeps its high byte, a palette image takes its palette's
  colours, and the EXIF orientation is applied; a CMYK JPEG takes
  OpenCV's ``icvCvt_CMYK2BGR`` on libjpeg's samples, not PIL's conversion.
- the port's own readers (``utils/cv_readers.py``), for the formats where
  PIL cannot give OpenCV's answer: PNM P1-P6, PAM and PFM (PIL scales
  samples OpenCV leaves as they are, and reads neither PAM nor OpenCV's
  one-channel PFM), Radiance HDR and 1-bit Sun rasters with a colour map
  (PIL reads neither), GIF (OpenCV's own decoder refuses LZW data that PIL
  reads on, and composes the first frame on its own canvas), TIFF (OpenCV
  reads it through libtiff's RGBA interface, whose 16-bit, YCbCr and
  CIELAB arithmetic PIL does not use) and JPEG 2000 (PIL rounds 16-bit
  colour samples to 8 bits, OpenCV shifts them). TIFF and JPEG 2000 are
  read by the libtiff and OpenJPEG that PIL's build links
  (``utils/codec_libs.py``, through ctypes); where either is missing the
  decode raises :class:`~.codec_libs.CodecLibraryMissing` rather than
  fall back on PIL.

Every format decodes bit-equal to OpenCV 5.0.0 on the files of
tests/test_torch_image_decode.py, tests/test_torch_image_formats.py and
tests/test_torch_scanned_pdf.py. What OpenCV refuses, the port refuses:

- formats: only :data:`CV_FORMATS` open, and within them the files
  OpenCV's readers refuse give None;
- size: OpenCV raises ``cv2.error`` outside 1 to :data:`CV_MAX_SIDE` on a
  side or above :data:`CV_MAX_PIXELS` pixels (``validateInputImageSize``),
  after its format's own header reader, which refuses a JPEG side over
  65,500 (libjpeg) and a PNG side over 1,000,000 (libpng's user limit)
  with None. The port reads the size from the header, before any pixel is
  allocated, and raises :class:`ImageDecodeError` where OpenCV raises.
  PIL's ``MAX_IMAGE_PIXELS`` never applies, and no global of PIL is read
  or written for it;
- corrupt JPEG data: libjpeg stops at a fatal error. OpenCV's decoder
  returns the image only when the error comes after the last scanline, in
  ``jpeg_finish_decompress``; PIL raises on any. So the port keeps PIL's
  pixels where the last row was written before the error (a sentinel
  painted on that row tells) and gives None otherwise, as it does for
  bytes that run out (``ImageFile.LOAD_TRUNCATED_IMAGES`` is neither read
  nor written for it). A JPEG file that runs out decodes, as
  ``cv2.imread`` decodes it (:func:`read_image`);
- PNG chunks: libpng checks each chunk's CRC. A critical chunk before the
  image end with a wrong one gives None; an ancillary one is dropped and
  the image decodes, as it does with a wrong CRC on IEND. The port hands
  PIL the stream libpng would have read.

``cv2.imdecode(..., IMREAD_COLOR)`` on a grey PFM gives one channel
(OpenCV converts its floats' depth only), which OpenCV 5.0.0's
``cvtColor(..., COLOR_BGR2RGB)`` repeats into three: the JAX package's
callers get a grey (H, W, 3) image, and so does :func:`decode_image`.
``cv2.imread`` refuses that decode (its type is not the one asked for) and
gives None, and so does :func:`read_image`.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

# the formats that OpenCV 5.0.0 reads (an MPO opens through the JPEG
# plugin; PPM is P1-P6)
CV_FORMATS = ("AVIF", "BMP", "GIF", "HDR", "JPEG", "JPEG2000", "PAM", "PFM",
              "PNG", "PPM", "SUN", "TIFF", "WEBP")
# the formats PIL's plugins read as OpenCV does
PIL_FORMATS = ("AVIF", "BMP", "JPEG", "PNG", "SUN", "WEBP")
# OpenCV's CV_IO_MAX_IMAGE_PIXELS and CV_IO_MAX_IMAGE_WIDTH / _HEIGHT
CV_MAX_PIXELS = 1 << 30
CV_MAX_SIDE = 1 << 20
# what jpeg_stdio_src reads after the end of a file: FF D9 at every refill,
# enough of them to fill the longest marker segment
_EOI_AT_EOF = b"\xff\xd9" * 32768
# the sides that a format's own reader refuses before OpenCV's size check
_HEADER_MAX_SIDE = {"JPEG": 65500, "MPO": 65500, "PNG": 1000000}


class ImageDecodeError(Exception):
    """An image that OpenCV 5.0.0 raises ``cv2.error`` on: larger than
    :data:`CV_MAX_PIXELS` pixels or :data:`CV_MAX_SIDE` on a side, or
    empty. Not an ``OSError`` or ``ValueError``: the JAX package's callers
    catch neither for ``cv2.error``."""


def _rawmode(im) -> Optional[str]:
    """The raw mode of a JPEG's tile: read it before ``load()``, which
    clears the tiles."""
    args = im.tile[0][3] if im.tile else None
    return args[0] if isinstance(args, tuple) and args else None


def _cmyk_to_rgb8(im, rawmode: Optional[str]) -> np.ndarray:
    """A CMYK JPEG as OpenCV converts it: libjpeg's samples (PIL inverts
    them where its raw mode is ``"CMYK;I"``) through ``icvCvt_CMYK2BGR``,
    ``k - ((255 - c) * k >> 8)`` per channel."""
    a = np.asarray(im)
    if rawmode == "CMYK;I":
        a = 255 - a
    k = a[..., 3:].astype(np.uint16)
    return (k - ((255 - a[..., :3]).astype(np.uint16) * k >> 8)).astype(
        np.uint8)


def _to_rgb8(im, rawmode: Optional[str]) -> np.ndarray:
    """A PIL image as IMREAD_COLOR + BGR -> RGB gives it: (H, W, 3) uint8.
    ``rawmode`` is its tile's (:func:`_rawmode`), read before it was
    loaded."""
    from PIL import ImageOps

    im = ImageOps.exif_transpose(im)
    if im.mode.startswith("I"):       # 16-bit grey
        a = np.asarray(im).astype(np.int64)
        grey = np.clip(a >> 8, 0, 255).astype(np.uint8)
    elif im.mode in ("L", "LA", "1"):
        grey = np.asarray(im.convert("L") if im.mode == "1"
                          else im.getchannel("L"))
    else:
        grey = None
    if grey is not None:
        return np.ascontiguousarray(np.repeat(grey[:, :, None], 3, axis=2))
    if im.mode in ("RGBA", "RGBX", "RGBa"):
        return np.ascontiguousarray(np.asarray(im)[:, :, :3])
    if im.mode == "CMYK":             # a JPEG's
        return np.ascontiguousarray(_cmyk_to_rgb8(im, rawmode))
    return np.ascontiguousarray(np.asarray(im.convert("RGB")))


def _open(data: bytes):
    """``data`` opened by the first plugin of :data:`PIL_FORMATS` (in PIL's
    own order) that accepts it, as ``Image.open`` would, but without its
    decompression-bomb check; None where none does."""
    from PIL import Image

    Image.init()
    fp = io.BytesIO(data)
    for fmt in Image.ID:
        if fmt not in PIL_FORMATS or fmt not in Image.OPEN:
            continue
        factory, accept = Image.OPEN[fmt]
        ok = accept(data[:16]) if accept else True
        if not ok or isinstance(ok, str):
            continue
        fp.seek(0)
        try:
            return factory(fp, "")
        except (SyntaxError, IndexError, TypeError, struct.error):
            continue
    return None


def _refused(im, data: bytes) -> bool:
    """Whether OpenCV's reader for ``im``'s format refuses the file before
    it decodes a pixel (its decode gives None)."""
    fmt, mode = im.format, im.mode
    if max(im.size) > _HEADER_MAX_SIDE.get(fmt, CV_MAX_SIDE + 1):
        return True
    if fmt == "SUN":
        _, _, _, depth, _, kind, map_type, map_len = struct.unpack(
            ">8I", data[:32])
        return (kind not in (0, 1) or depth not in (1, 8, 24, 32)
                or map_type not in (0, 1) or (map_type == 0) != (map_len == 0)
                or (map_len > 0 and depth > 8)
                or map_len > 3 << min(depth, 8))
    return False


def _png_as_libpng_reads(data: bytes) -> Optional[bytes]:
    """The PNG as libpng reads it, or None where libpng fails: every chunk
    whole up to and with IEND; a wrong CRC on a critical chunk before IEND
    (or an unknown critical chunk) fails, a wrong CRC drops an ancillary
    chunk, and IEND's CRC is not held (PIL reads on without IEND, checks
    no IDAT CRC, and refuses an ancillary chunk's wrong CRC)."""
    pos, out = 8, [data[:8]]
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            return None
        if kind == b"IEND":
            body = data[pos:pos + 8]
            out.append(body + struct.pack(">I", zlib.crc32(body[4:])))
            return b"".join(out)
        crc = struct.unpack(">I", data[end - 4:end])[0]
        critical = 65 <= kind[0] <= 90
        if zlib.crc32(data[pos + 4:end - 4]) == crc:
            if critical and kind not in (b"IHDR", b"PLTE", b"IDAT"):
                return None
            out.append(data[pos:end])
        elif critical:
            return None
        pos = end
    return None


def _check_size(w: int, h: int) -> None:
    """OpenCV's ``validateInputImageSize``."""
    if w <= 0 or h <= 0:
        raise ImageDecodeError(f"image of {w} x {h} pixels is empty")
    if w > CV_MAX_SIDE or h > CV_MAX_SIDE or w * h > CV_MAX_PIXELS:
        raise ImageDecodeError(
            f"image of {w} x {h} pixels exceeds OpenCV's decode limit of "
            f"{CV_MAX_PIXELS} pixels and {CV_MAX_SIDE} on a side")


def _last_row_written(im, ink) -> bool:
    """Whether the decoder overwrote the sentinel ``ink`` on ``im``'s last
    row."""
    w, h = im.size
    row = np.asarray(im.crop((0, h - 1, w, h))).reshape(w, -1)
    return bool((row != np.asarray(ink).reshape(1, -1)).any())


def _load_jpeg(data: bytes, im):
    """Decode a JPEG as OpenCV's decoder does with libjpeg: the image
    where every scanline came out, None where libjpeg stopped before the
    last one or the data ran out. A decoded last row that happens to equal
    the first sentinel is told apart by a second decode with another."""
    from PIL import Image

    w, h = im.size
    bands = len(im.getbands())
    for value in (1, 254):
        ink = value if bands == 1 else (value,) * bands
        core = Image.core.new(im.mode, im.size)
        core.paste(ink, (0, h - 1, w, h))
        im.im = core
        try:
            im.load()
        except OSError:
            im.tile = []
        if hasattr(im, "_ended"):             # PIL fed libjpeg a false EOI
            return None
        if _last_row_written(im, ink):
            return im
        if value == 1:
            im = _open(data)
    return None


def _own_format(data: bytes) -> Optional[str]:
    """The format of the port's own readers whose OpenCV signature
    ``data`` carries, in ``findDecoder``'s order; None for the others."""
    head = data[:12]
    if head[:3] == b"GIF":
        return "GIF"
    if head[:6] == b"#?RGBE" or data[:10] == b"#?RADIANCE":
        return "HDR"
    if head[:4] == b"\x59\xa6\x6a\x95" and len(data) >= 32:
        depth, _, _, map_type, map_len = struct.unpack(">5I", data[12:32])
        if depth == 1 and map_type == 1 and 0 < map_len <= 6:
            return "SUN1"
        return None
    if len(head) >= 3 and head[0] == ord("P") and head[2] in b" \t\n\v\f\r":
        if head[1] in b"123456":
            return "PPM"
        if head[1] == ord("7"):
            return "PAM"
        if head[1] in b"fF":
            return "PFM"
    if head[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):  # and BigTIFF
        return "TIFF"
    if head[:4] == b"\xff\x4f\xff\x51" or \
            head == b"\0\0\0\x0cjP  \r\n\x87\n":
        return "JPEG2000"
    return None


def _read_own(fmt: str, data: bytes) -> np.ndarray:
    """The port's reader of ``fmt``: RGB as OpenCV's ``IMREAD_COLOR``
    and BGR -> RGB give it (a grey PFM (H, W)),
    :class:`~.cv_readers.Refused` where OpenCV gives None."""
    from . import cv_readers as cvr

    if fmt == "GIF":
        w, h, *_ = header = cvr.gif_header(data)
        if w <= 0 or h <= 0:
            raise cvr.Refused("GIF: empty screen")
        _check_size(w, h)
        return cvr.read_gif(data, header)
    if fmt == "HDR":
        w, h, pos = cvr.hdr_header(data)
        if w <= 0 or h <= 0:
            raise cvr.Refused("HDR: no image size")
        _check_size(w, h)
        return cvr.read_hdr(data, (w, h, pos))
    if fmt == "SUN1":
        w, h = struct.unpack(">II", data[4:12])
        if w <= 0 or h <= 0 or struct.unpack(">I", data[20:24])[0] not in (
                0, 1):
            raise cvr.Refused("SunRaster: bad header")
        _check_size(w, h)
        return cvr.read_sun_1bit_mapped(data)
    if fmt == "PPM":
        header = cvr.pnm_header(data)
        _check_size(header[1], header[2])
        return cvr.read_pnm(data, header)
    if fmt == "PAM":
        header = cvr.pam_header(data)
        _check_size(header[0], header[1])
        return cvr.read_pam(data, header)
    if fmt == "PFM":
        header = cvr.pfm_header(data)
        _check_size(header[1], header[2])
        return cvr.read_pfm(data, header)
    if fmt == "TIFF":
        from .codec_libs import TiffFile

        with TiffFile(data) as tif:
            w, h = cvr.tiff_header(tif)
            _check_size(w, h)
            return cvr.read_tiff(tif, w, h)
    return cvr.read_jpeg2000(data, _check_size)


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, or None where
    ``cv2.imdecode`` gives None: a format or file that OpenCV 5.0.0 does not
    read, a JPEG that libjpeg stops on before its last scanline, data that
    its reader cannot decode. Raises :class:`ImageDecodeError` where OpenCV
    raises (its size limits), before allocating the image."""
    rgb, _ = _decode(data)
    return rgb


def _decode(data: bytes) -> Tuple[Optional[np.ndarray], bool]:
    """:func:`decode_image`, and whether OpenCV's decode gave one channel
    where ``IMREAD_COLOR`` asks for three (a grey PFM)."""
    from .cv_readers import Refused

    fmt = _own_format(data)
    if fmt is not None:
        try:
            rgb = _read_own(fmt, data)
        except Refused:
            return None, False
        if rgb.ndim == 2:                 # what BGR -> RGB makes of it
            return np.repeat(rgb[:, :, None], 3, axis=2), True
        return rgb, False
    try:
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            data = _png_as_libpng_reads(data)
            if data is None:
                return None, False
        im = _open(data)
        if im is None or _refused(im, data):
            return None, False
        _check_size(*im.size)
        rawmode = _rawmode(im)
        if im.format in ("JPEG", "MPO"):
            im = _load_jpeg(data, im)
            if im is None:
                return None, False
        else:
            if im.format == "SUN" and im.tile[0].args[0] == "BGRX":
                # OpenCV reads a 32-bit Sun raster's pad byte first
                im.tile = [im.tile[0]._replace(
                    args=("XBGR",) + tuple(im.tile[0].args[1:]))]
            im.load()
        rgb = _to_rgb8(im, rawmode)
        return (255 - rgb if im.format == "SUN" and im.mode == "1"
                else rgb), False
    except (OSError, ValueError, SyntaxError):
        return None, False


def read_image(path: str) -> Optional[np.ndarray]:
    """An image file -> (H, W, 3) uint8 RGB, or None where it cannot be
    read (``cv2.imread`` returns None there). ``cv2.imread`` runs the same
    readers and size check as ``cv2.imdecode`` (:func:`decode_image`), but
    gives None where the decode has one channel, not the three that
    ``IMREAD_COLOR`` asks for (a grey PFM), where ``imdecode`` returns
    it."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:3] == b"\xff\xd8\xff":
        # OpenCV reads a JPEG file through libjpeg's stdio source, which at
        # the end of the file hands libjpeg a false end-of-image marker at
        # every refill (a truncated file decodes, its missing data as
        # zeros), where imdecode's memory source stops
        data += _EOI_AT_EOF
    rgb, one_channel = _decode(data)
    return None if one_channel else rgb


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as PNG."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, dtype=np.uint8)).save(
        path, format="PNG")
