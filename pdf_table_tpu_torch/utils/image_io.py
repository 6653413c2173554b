"""Image files and payloads without OpenCV: what ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_COLOR`` followed by BGR -> RGB give, and
what ``cv2.imwrite`` of an RGB image (turned to BGR) writes, through PIL.

``IMREAD_COLOR`` decodes to 8-bit, 3 channels: a grey image is repeated
into three channels, an alpha channel is dropped (not composited), a
16-bit sample keeps its high byte (OpenCV strips the low byte, it does not
round), a palette image takes its palette's colours, and the EXIF
orientation is applied. A CMYK image takes OpenCV 5.0.0's conversion, not
PIL's: a JPEG ``icvCvt_CMYK2BGR`` on libjpeg's samples, a TIFF libtiff's
RGBA arithmetic. PNGs, baseline and progressive JPEGs (RGB, grey, CMYK)
and JPEG 2000 (a JP2 file or a raw codestream) decode bit-equal to OpenCV
5.0.0's (tests/test_torch_scanned_pdf.py).
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np


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
    else:
        grey = None
    if grey is not None:
        return np.ascontiguousarray(np.repeat(grey[:, :, None], 3, axis=2))
    if im.mode in ("RGBA", "RGBX", "RGBa"):
        return np.ascontiguousarray(np.asarray(im)[:, :, :3])
    if im.mode == "CMYK":
        return np.ascontiguousarray(_cmyk_to_rgb8(im, fmt, rawmode))
    return np.ascontiguousarray(np.asarray(im.convert("RGB")))


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, or None where they are
    no image PIL can read (``cv2.imdecode`` returns None there)."""
    from PIL import Image

    try:
        im = Image.open(io.BytesIO(data))
        rawmode = _rawmode(im)
        im.load()
        return _to_rgb8(im, rawmode)
    except (OSError, ValueError, SyntaxError):
        return None


def read_image(path: str) -> Optional[np.ndarray]:
    """An image file -> (H, W, 3) uint8 RGB, or None where it cannot be
    read (``cv2.imread`` returns None there)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_image(data)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as PNG."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, dtype=np.uint8)).save(
        path, format="PNG")
