"""The image-decode fixtures: small files on which OpenCV 5.0.0 and PIL
part unless the decoder is careful, and what ``cv2.imdecode`` gives on
each. ``chip_smoke.py``'s ``decode`` phase holds the port's
``utils/image_io.py::decode_image`` to the digests on a host without cv2;
tests/test_torch_image_decode.py holds them to cv2 and builds its
corruptions with :func:`corruptions`.

    python tests/data/image_decode/make_fixtures.py

writes, beside this file:

- ``clean.jpg``: a blurred 400 x 300 RGB JPEG at quality 90;
- ``corrupt_decodes.jpg``: three bytes of it changed so that libjpeg stops
  on a fatal error after the last scanline (PIL raises "broken data
  stream", cv2 returns the image);
- ``corrupt_refused.jpg``: three bytes changed so that libjpeg stops
  before the first scanline (PIL raises, cv2 returns None);
- ``truncated.jpg``: ``clean.jpg`` without its last 100 bytes;
- ``icon.ico`` and ``image.tga``: a 50 x 40 RGB image in two formats that
  PIL reads and OpenCV does not;
- one file per decode that PIL alone does not give as OpenCV 5.0.0 does
  (a 64 x 48 image of seeded noise, full-range 16-bit samples where the
  format has them; ROADMAP.md Queue 3, F10-F15): ``rgb16.jp2`` (cv2
  writes it), ``corrupt_lzw.gif`` (a GIF with three bytes of its LZW data
  changed, which PIL reads on and OpenCV refuses), ``image.hdr``,
  ``image.pam``, ``colour.pfm`` and ``grey.pfm`` (cv2 writes them),
  ``mapped_1bit.ras`` (a 1-bit Sun raster with a two-entry colour map),
  ``maxval100.pgm`` (binary, maxval 100, one sample above it),
  ``maxval1000.ppm`` (ASCII, maxval 1000), ``rgb16.ppm`` and
  ``rgb16.tiff`` (cv2 writes them), ``ycbcr.tiff`` and ``cielab.tiff``
  (PIL writes them), ``bad_text_crc.png`` and ``bad_iend_crc.png`` (a wrong
  CRC on a ``tEXt`` chunk, on ``IEND``);
- ``digests.json``: per file, the SHA-256 of ``cv2.imdecode(data,
  IMREAD_COLOR)`` turned to RGB (C order, uint8), its shape, or null where
  cv2 gives None. Needs cv2 (OpenCV 5.0.0).

Files too large to commit are made in memory from the same seed, for
tests/test_torch_image_formats.py, ``chip_smoke.py`` and
tools/time_image_decode.py: :func:`page_ascii_pnm` (a 300 dpi A4 page as
ASCII P2 / P3) and :func:`strip_tiff` of a :func:`grey_strip` (16,000²
and 16,400² grey TIFFs in one deflate strip)."""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
from PIL import Image, ImageFilter

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def blurred_jpeg(seed: int = SEED) -> bytes:
    """Seeded noise blurred by a Gaussian of radius 3, as a 400 x 300 RGB
    JPEG at quality 90."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    im = Image.fromarray(px).filter(ImageFilter.GaussianBlur(3))
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def corruptions(data: bytes, n: int, lo: int, seed: int = SEED):
    """``n`` copies of ``data``, each with three bytes set at random: per
    copy three ``(position in [lo, len - 2), byte)`` draws of
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b = bytearray(data)
        for _ in range(3):
            b[int(rng.integers(lo, len(b) - 2))] = int(rng.integers(0, 256))
        yield bytes(b)


def grey_strip(side: int) -> bytes:
    """A deflate strip of ``side``² 8-bit grey, ``(x + 7 y) % 251``."""
    rows = ((np.arange(side)[None] + 7 * np.arange(251)[:, None])
            % 251).astype(np.uint8)
    return zlib.compress(rows[np.arange(side) % 251], 1)


def strip_tiff(strip: bytes, w: int, h: int, photometric: int,
               orientation: int = 1, tiled: bool = False,
               colormap=None) -> bytes:
    """A little-endian TIFF of 8-bit, one-sample pixels in one deflate
    strip (or one tile) ``strip``."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [8]),
            262: (3, [photometric]), 274: (3, [orientation]),
            277: (3, [1]), 284: (3, [1])}
    where = [8]
    if tiled:
        tags.update({322: (4, [w]), 323: (4, [h]), 324: (4, where),
                     325: (4, [len(strip)])})
    else:
        tags.update({273: (4, where), 278: (4, [h]),
                     279: (4, [len(strip)])})
    if colormap is not None:
        tags[320] = (3, list(colormap))
    strip += b"\0" * (len(strip) % 2)
    extra, ifd = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(raw) > 4:
            raw = struct.pack("<I", 8 + len(strip) + len(extra))
            extra += struct.pack(f"<{len(vals)}H", *vals)
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
    return (b"II*\0" + struct.pack("<I", 8 + len(strip) + len(extra))
            + strip + extra + struct.pack("<H", len(tags)) + ifd
            + b"\0" * 4)


def page_ascii_pnm(kind: int = 3, w: int = 2480, h: int = 3508,
                   seed: int = SEED):
    """A scan-sized ASCII PNM (P2 grey or P3 colour, maxval 255; 300 dpi
    A4 by default) of seeded noise as netpbm writes it, each sample in
    decimal with a space after it, a newline ending each row: ``(data,
    (h, w, channels) uint8 samples)``."""
    nch = 3 if kind == 3 else 1
    words = [b"%d " % v for v in range(256)]
    table = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(t) for t in words])
    offs = np.cumsum(lens) - lens
    samples = np.random.default_rng(seed).integers(0, 256, (h, w * nch),
                                                   dtype=np.uint8)
    chunks = [b"P%d\n%d %d\n255\n" % (kind, w, h)]
    for y in range(0, h, 256):
        s = samples[y:y + 256]
        n = lens[s].ravel()
        ends = np.cumsum(n)
        text = table[np.arange(ends[-1]) - np.repeat(
            ends - n - offs[s.ravel()], n)]
        text[ends.reshape(s.shape)[:, -1] - 1] = ord("\n")
        chunks.append(text.tobytes())
    return b"".join(chunks), samples.reshape(h, w, nch)


def rgb_digest(rgb):
    """{"sha256", "shape"} of an (H, W, 3) uint8 array, or None."""
    if rgb is None:
        return None
    a = np.ascontiguousarray(rgb, dtype=np.uint8)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "shape": list(a.shape)}


def _pil_breaks(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data)).load()
    except OSError as e:
        return "broken data stream" in str(e)
    return False


def fixtures(cv_decode):
    """name -> bytes; ``cv_decode(bytes)`` is cv2's RGB or None, used to
    pick the corruption of each kind."""
    clean = blurred_jpeg()
    out = {"clean.jpg": clean, "truncated.jpg": clean[:-100]}
    for lo in (600, 100):
        for b in corruptions(clean, 400, lo):
            if not _pil_breaks(b):
                continue
            name = ("corrupt_decodes.jpg" if cv_decode(b) is not None
                    else "corrupt_refused.jpg")
            out.setdefault(name, b)
    rng = np.random.default_rng(SEED)
    im = Image.fromarray(rng.integers(0, 256, (50, 40, 3), dtype=np.uint8))
    for name, fmt in (("icon.ico", "ICO"), ("image.tga", "TGA")):
        buf = io.BytesIO()
        im.save(buf, format=fmt)
        out[name] = buf.getvalue()
    out.update(format_fixtures(cv_decode))
    return out


def _pil(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _png_with_bad_crc(data: bytes, kind: bytes) -> bytes:
    """``data`` with the CRC of its first ``kind`` chunk flipped."""
    pos = 8
    while True:
        n, k = struct.unpack(">I4s", data[pos:pos + 8])
        if k == kind:
            end = pos + 12 + n
            return data[:end - 1] + bytes([data[end - 1] ^ 0xFF]) \
                + data[end:]
        pos += 12 + n


def format_fixtures(cv_decode):
    """The fixtures of F10-F15 (module docstring): name -> bytes. The
    files cv2 writes need cv2 (OpenCV 5.0.0)."""
    import cv2
    from PIL import PngImagePlugin

    rng = np.random.default_rng(SEED + 1)
    h, w = 48, 64
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb16 = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
    out = {}
    for name, arr in (("rgb16.jp2", rgb16), ("image.hdr", rgb),
                      ("image.pam", rgb), ("rgb16.ppm", rgb16),
                      ("rgb16.tiff", rgb16),
                      ("colour.pfm", rgb.astype(np.float32)),
                      ("grey.pfm", rgb[..., 0].astype(np.float32))):
        ok, enc = cv2.imencode("." + name.split(".")[1], arr)
        assert ok, name
        out[name] = enc.tobytes()
    # the first corruption of a GIF's LZW data that PIL reads and cv2
    # refuses
    gif = _pil(Image.fromarray(rgb).resize((160, 120)), "GIF")
    for data in corruptions(gif, 200, 800):
        try:
            Image.open(io.BytesIO(data)).load()
        except (OSError, SyntaxError):
            continue
        if cv_decode(data) is None:
            out["corrupt_lzw.gif"] = data
            break
    bits = np.packbits(rgb[..., 0] > 127, axis=1)
    bits = np.pad(bits, ((0, 0), (0, bits.shape[1] % 2))).tobytes()
    cmap = bytes([200, 10, 40, 230, 90, 20])    # R, G, B planes
    out["mapped_1bit.ras"] = struct.pack(
        ">8I", 0x59A66A95, w, h, 1, len(bits), 1, 1, len(cmap)) \
        + cmap + bits
    grey = np.minimum(rgb[..., 0] * 100 // 255, 100).astype(np.uint8)
    grey[0, 0] = 200
    out["maxval100.pgm"] = b"P5\n# maxval 100\n%d %d\n100\n" % (w, h) \
        + grey.tobytes()
    samples = (rgb16 >> 6).ravel() % 1001
    out["maxval1000.ppm"] = b"P3\n%d %d\n1000\n" % (w, h) + b"\n".join(
        b" ".join(b"%d" % v for v in samples[i:i + 12])
        for i in range(0, len(samples), 12)) + b"\n"
    out["ycbcr.tiff"] = _pil(Image.fromarray(rgb).convert("YCbCr"), "TIFF")
    out["cielab.tiff"] = _pil(Image.frombytes("LAB", (w, h), rgb.tobytes()),
                              "TIFF")
    info = PngImagePlugin.PngInfo()
    info.add_text("note", "a text chunk")
    png = _pil(Image.fromarray(rgb), "PNG", pnginfo=info)
    out["bad_text_crc.png"] = _png_with_bad_crc(png, b"tEXt")
    out["bad_iend_crc.png"] = _png_with_bad_crc(png, b"IEND")
    return out


def main() -> None:
    import cv2

    def cv_decode(data):
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

    files = fixtures(cv_decode)
    assert {"corrupt_decodes.jpg", "corrupt_refused.jpg"} <= set(files)
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        digests[name] = rgb_digest(cv_decode(data))
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump({"opencv": cv2.__version__, "files": digests}, f,
                  indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
