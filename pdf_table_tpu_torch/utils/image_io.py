"""Image files and payloads without OpenCV: what ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_COLOR`` followed by BGR -> RGB give, and
what ``cv2.imwrite`` of an RGB image (turned to BGR) writes, through PIL.

``IMREAD_COLOR`` decodes to 8-bit, 3 channels: a grey image is repeated
into three channels, an alpha channel is dropped (not composited), a
16-bit sample keeps its high byte (OpenCV strips the low byte, it does not
round), a palette image takes its palette's colours, and the EXIF
orientation is applied. A CMYK image takes OpenCV 5.0.0's conversion, not
PIL's: a JPEG ``icvCvt_CMYK2BGR`` on libjpeg's samples, a TIFF libtiff's
RGBA arithmetic. Every format that OpenCV 5.0.0 and PIL both read decodes
bit-equal to OpenCV (tests/test_torch_image_decode.py,
tests/test_torch_scanned_pdf.py).

What OpenCV 5.0.0 refuses, the port refuses too:

- formats: only :data:`CV_FORMATS` open, each through its own PIL plugin
  (never ``Image.open``), and within them the files OpenCV's readers
  refuse give None (a float or 32-bit integer TIFF, a 4-component JPEG
  2000 in CMYK, a Sun raster other than a standard or old one of 1, 8, 24
  or 32 bits, a PNG or GIF that does not run whole to its end);
- size: OpenCV raises ``cv2.error`` above :data:`CV_MAX_PIXELS` pixels or
  :data:`CV_MAX_SIDE` on a side (``validateInputImageSize``), after its
  format's own header reader, which refuses a JPEG side over 65,500
  (libjpeg) and a PNG side over 1,000,000 (libpng's user limit) with None.
  The port reads the size from the header, before any pixel is allocated,
  and raises :class:`ImageDecodeError` where OpenCV raises. PIL's
  ``MAX_IMAGE_PIXELS`` never applies, and no global of PIL is read or
  written for it;
- corrupt JPEG data: libjpeg stops at a fatal error. OpenCV's decoder
  returns the image only when the error comes after the last scanline, in
  ``jpeg_finish_decompress``; PIL raises on any. So the port keeps PIL's
  pixels where the last row was written before the error (a sentinel
  painted on that row tells) and gives None otherwise, as it does for
  bytes that run out (``ImageFile.LOAD_TRUNCATED_IMAGES`` is neither read
  nor written for it). A JPEG file that runs out decodes, as
  ``cv2.imread`` decodes it (:func:`read_image`).
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Optional

import numpy as np

# the formats that OpenCV 5.0.0 reads, by PIL's name for them (an MPO opens
# through the JPEG plugin)
CV_FORMATS = ("AVIF", "BMP", "GIF", "JPEG", "JPEG2000", "PNG", "PPM", "SUN",
              "TIFF", "WEBP")
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
    :data:`CV_MAX_PIXELS` pixels or :data:`CV_MAX_SIDE` on a side. Not an
    ``OSError`` or ``ValueError``: the JAX package's callers catch neither
    for ``cv2.error``."""


def _rawmode(im) -> Optional[str]:
    """The raw mode of a JPEG's tile: read it before ``load()``, which
    clears the tiles."""
    args = im.tile[0][3] if im.tile else None
    return args[0] if isinstance(args, tuple) and args else None


def _cmyk_to_rgb8(im, fmt: Optional[str],
                  rawmode: Optional[str]) -> np.ndarray:
    """A CMYK image as OpenCV converts it. For a JPEG, libjpeg's samples
    (PIL inverts them where its raw mode is ``"CMYK;I"``) through
    ``icvCvt_CMYK2BGR``: ``k - ((255 - c) * k >> 8)`` per channel; for a
    TIFF, libtiff's ``(255 - k) * (255 - c) / 255``."""
    a = np.asarray(im)
    if fmt in ("JPEG", "MPO"):
        if rawmode == "CMYK;I":
            a = 255 - a
        k = a[..., 3:].astype(np.uint16)
        rgb = k - ((255 - a[..., :3]).astype(np.uint16) * k >> 8)
    elif fmt == "TIFF":
        rgb = (255 - a[..., 3:]).astype(np.uint16) \
            * (255 - a[..., :3]) // 255
    else:
        return np.asarray(im.convert("RGB"))
    return rgb.astype(np.uint8)


def _to_rgb8(im, rawmode: Optional[str]) -> np.ndarray:
    """A PIL image as IMREAD_COLOR + BGR -> RGB gives it: (H, W, 3) uint8.
    ``rawmode`` is its tile's (:func:`_rawmode`), read before it was
    loaded."""
    from PIL import ImageOps

    fmt = im.format                   # the transposed copy has none
    im = ImageOps.exif_transpose(im)
    if im.mode.startswith("I"):       # 16-bit (and 32-bit integer) grey
        a = np.asarray(im).astype(np.int64)
        grey = np.clip(a >> 8, 0, 255).astype(np.uint8)
    elif im.mode in ("L", "LA", "1"):
        grey = np.asarray(im.convert("L") if im.mode == "1"
                          else im.getchannel("L"))
    elif im.mode == "F":              # a grey PFM: saturate_cast, unscaled
        grey = np.clip(np.rint(np.nan_to_num(np.asarray(im))), 0,
                       255).astype(np.uint8)
    else:
        grey = None
    if grey is not None:
        return np.ascontiguousarray(np.repeat(grey[:, :, None], 3, axis=2))
    if im.mode in ("RGBA", "RGBX", "RGBa"):
        return np.ascontiguousarray(np.asarray(im)[:, :, :3])
    if im.mode == "CMYK":
        return np.ascontiguousarray(_cmyk_to_rgb8(im, fmt, rawmode))
    return np.ascontiguousarray(np.asarray(im.convert("RGB")))


def _open(data: bytes):
    """``data`` opened by the first plugin of :data:`CV_FORMATS` (in PIL's
    own order) that accepts it, as ``Image.open`` would, but without its
    decompression-bomb check; None where none does."""
    from PIL import Image

    Image.init()
    fp = io.BytesIO(data)
    for fmt in Image.ID:
        if fmt not in CV_FORMATS or fmt not in Image.OPEN:
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
    if fmt == "PNG":
        return not _png_complete(data)
    if fmt == "GIF":
        return not _gif_complete(data)
    if fmt == "TIFF":
        return mode in ("F", "I")             # 32-bit samples
    if fmt == "JPEG2000":
        return mode == "CMYK"
    if fmt == "SUN":
        _, _, _, depth, _, kind, map_type, map_len = struct.unpack(
            ">8I", data[:32])
        return (kind not in (0, 1) or depth not in (1, 8, 24, 32)
                or map_type not in (0, 1) or (map_type == 0) != (map_len == 0)
                or (map_len > 0 and depth > 8))
    return False


def _png_complete(data: bytes) -> bool:
    """Whether libpng reads the file to its end: every chunk whole up to
    and with IEND, each critical chunk's CRC right (PIL reads on without
    IEND and without checking IDAT's CRC)."""
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            return False
        crc = struct.unpack(">I", data[end - 4:end])[0]
        if kind in (b"IHDR", b"PLTE", b"IDAT", b"IEND") \
                and zlib.crc32(data[pos + 4:end - 4]) != crc:
            return False
        if kind == b"IEND":
            return True
        pos = end
    return False


def _gif_complete(data: bytes) -> bool:
    """Whether the GIF's blocks run whole to its trailer (PIL reads the
    first frame without them; OpenCV's reader walks to the trailer)."""
    pos = 13
    if data[10] & 0x80:
        pos += 3 << ((data[10] & 7) + 1)
    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            return True
        if kind == 0x21:
            pos += 2
        elif kind == 0x2C:
            if pos + 10 > len(data):
                return False
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1
        else:
            return False
        while pos < len(data) and data[pos]:         # sub-blocks
            pos += data[pos] + 1
        pos += 1
    return False


def _check_size(size) -> None:
    """OpenCV's ``validateInputImageSize``."""
    w, h = size
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


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, or None where
    ``cv2.imdecode`` gives None: a format or file that OpenCV 5.0.0 does not
    read, a JPEG that libjpeg stops on before its last scanline, data that
    PIL cannot decode. Raises :class:`ImageDecodeError` where OpenCV raises
    (its size limit), before allocating the image."""
    try:
        im = _open(data)
        if im is None or _refused(im, data):
            return None
        _check_size(im.size)
        rawmode = _rawmode(im)
        if im.format in ("JPEG", "MPO"):
            im = _load_jpeg(data, im)
            if im is None:
                return None
        else:
            if im.format == "SUN" and im.tile[0].args[0] == "BGRX":
                # OpenCV reads a 32-bit Sun raster's pad byte first
                im.tile = [im.tile[0]._replace(
                    args=("XBGR",) + tuple(im.tile[0].args[1:]))]
            elif im.format == "TIFF":
                from PIL import Image

                # TIFF's load_prepare applies PIL's bomb check to a missing
                # buffer
                im.im = Image.core.new(im.mode, im._tile_size)
            im.load()
        rgb = _to_rgb8(im, rawmode)
        return 255 - rgb if im.format == "SUN" and im.mode == "1" else rgb
    except (OSError, ValueError, SyntaxError):
        return None


def read_image(path: str) -> Optional[np.ndarray]:
    """An image file -> (H, W, 3) uint8 RGB, or None where it cannot be
    read (``cv2.imread`` returns None there). ``cv2.imread`` runs the same
    readers and size check as ``cv2.imdecode``: :func:`decode_image`."""
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
    return decode_image(data)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as PNG."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, dtype=np.uint8)).save(
        path, format="PNG")
