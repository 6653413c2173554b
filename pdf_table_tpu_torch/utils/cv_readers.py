"""The port's own readers of the formats where PIL cannot give OpenCV
5.0.0's answer, each following OpenCV's reader for that format
(``modules/imgcodecs/src/grfmt_*.cpp``) as ``cv2.imdecode(...,
IMREAD_COLOR)`` runs it: what the reader decodes, as the BGR -> RGB of
OpenCV's result gives it (RGB; a grey PFM (H, W)), or :class:`Refused`
where OpenCV's reader fails (``imdecode`` gives None). tests/test_torch_image_formats.py
holds each one to cv2 5.0.0.

- PNM, P1-P6 (``grfmt_pxm.cpp``): binary 8-bit samples are taken as they
  are, whatever the maxval (a sample above it too); ASCII ones are clamped
  to the maxval and scaled by ``v * 255 / maxval`` (integer division); a
  maxval over 255 makes 16-bit samples, of which the high byte is kept,
  unscaled. 1 is black in P1 and P4.
- PAM (``grfmt_pam.cpp``): the tuple type must fit the depth; 8-bit
  samples unscaled; an RGB tuple is copied into OpenCV's BGR order as it
  stands, so its channels come out reversed after BGR -> RGB; a maxval of
  1 reads each row as packed bits. Grey + alpha and RGB + alpha convert only the first
  ``W / 2`` resp. ``W / 4`` pixels of a row (OpenCV's ``basic_conversion``
  stops at ``W`` bytes): OpenCV leaves the rest of the row unwritten, the
  port leaves it 0.
- PFM (``grfmt_pfm.cpp``): floats divided by the scale's magnitude, then
  OpenCV's ``convertTo`` to 8 bits (round half to even; NaN, infinities
  and values past 2^31 to 0). A grey PFM keeps one channel
  (``convertTo`` changes only the depth): (H, W).
- Radiance HDR (``grfmt_hdr.cpp``, ``rgbe.cpp``): RGBE pixels, run-length
  or flat, each channel ``m * 2^(e - 136)`` in float, then ``convertTo``
  with a scale of 255.
- GIF (``grfmt_gif.cpp``, not giflib): see :func:`read_gif`.
- TIFF (``grfmt_tiff.cpp``): libtiff's RGBA interface, strip by strip or
  tile by tile (``utils/codec_libs.py``): a 16-bit colour sample rounds to
  ``(v * 255 + 32767) / 65535`` where a grey one keeps its high byte,
  YCbCr and CIELAB take libtiff's conversions. Where a strip as RGBA
  would reach 0.95 GiB, a plain strip of 1 or 3 samples (see
  :func:`read_tiff`) is read a scanline at a time, as it stands. The
  codecs OpenCV's own libtiff is built without refuse.
- JPEG 2000 (``grfmt_jpeg2000_openjpeg.cpp``): OpenJPEG's component
  samples shifted right by the precision over 8, unsigned, 1-4 components
  of 8 bits or more; one or two components decode only in a JP2 file that
  says grey; sYCC through OpenCV's fixed-point YUV -> BGR.
- Sun raster of 1 bit with a colour map (``grfmt_sunras.cpp``): the map
  holds ``length / 3`` entries (R plane, G plane, B plane), at most 2; the
  others are black. Every other Sun raster goes through PIL
  (``utils/image_io.py``).

PNM's ``ReadNumber`` loop and GIF's LZW loop are C++
(``ops/native/cv_readers.cc``, built at first use), so that a scan-sized
ASCII PNM or GIF decodes in about the time OpenCV takes.
"""

from __future__ import annotations

import re
import struct
from typing import Optional, Tuple

import numpy as np

INT_MAX = (1 << 31) - 1
_SPACE = frozenset(b" \t\n\v\f\r")


class Refused(Exception):
    """OpenCV's reader fails on the file: ``cv2.imdecode`` gives None."""


def _isspace(c: int) -> bool:
    return c in _SPACE


# -- the native loops --------------------------------------------------------

_LIB = None


def _native():
    """``ops/native/cv_readers.cc`` (PNM's ``ReadNumber``, GIF's LZW),
    built at first use."""
    global _LIB
    if _LIB is None:
        import ctypes

        from . import native_build

        lib = ctypes.CDLL(str(native_build.build_native(
            native_build.NATIVE_DIR / "cv_readers.cc")))
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.cvr_pxm_numbers.argtypes = [ctypes.c_char_p, i64, i64, i64,
                                        ctypes.c_int32, vp,
                                        ctypes.POINTER(i64)]
        lib.cvg_lzw_decode.argtypes = [ctypes.c_char_p, i64, i64, i64, vp,
                                       ctypes.POINTER(i64)]
        for fn in (lib.cvr_pxm_numbers, lib.cvg_lzw_decode):
            fn.restype = ctypes.c_int32
        _LIB = lib
    return _LIB


# -- PNM ---------------------------------------------------------------------

def _read_numbers(data: bytes, pos: int, n: int, one_digit: bool = False
                  ) -> Tuple[np.ndarray, int]:
    """OpenCV's ``ReadNumber(strm, maxdigits)`` ``n`` times (maxdigits 1
    where ``one_digit``): ``(n int32 values, position after them)``, or
    :class:`Refused` (see ``ops/native/cv_readers.cc``)."""
    import ctypes

    # a number takes a byte, and one more after it unless it is one digit
    if n * (1 if one_digit else 2) > len(data) - pos:
        raise Refused("PXM: end of stream")
    out = np.empty(n, np.int32)
    end = ctypes.c_int64(0)
    status = _native().cvr_pxm_numbers(data, len(data), pos, n,
                                       int(one_digit),
                                       out.ctypes.data_as(ctypes.c_void_p),
                                       ctypes.byref(end))
    if status != 0:
        raise Refused(f"PXM: ReadNumber failed ({status})")
    return out, end.value


def _read_number(data: bytes, pos: int) -> Tuple[int, int]:
    values, pos = _read_numbers(data, pos, 1)
    return int(values[0]), pos


def _bits(rows: np.ndarray, width: int) -> np.ndarray:
    """``FillColorRow1`` / ``FillGrayRow1``'s bits: (h, width) of 0/1, MSB
    first, from the first ``ceil(width / 8)`` bytes of each row."""
    return np.unpackbits(rows[:, :(width + 7) // 8], axis=1)[:, :width]


def pnm_header(data: bytes):
    """``PxMDecoder::readHeader``: ``(kind, width, height, maxval,
    offset)`` (``kind`` the digit after ``P``)."""
    if len(data) < 2 or data[0] != ord("P") or data[1] not in b"123456":
        raise Refused("PXM: bad header")
    kind = data[1] - ord("0")
    w, pos = _read_number(data, 2)
    h, pos = _read_number(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _read_number(data, pos)
        if maxval > 65535:
            raise Refused("PXM: maxval over 65535")
    if not (w > 0 and h > 0 and maxval > 0):
        raise Refused("PXM: bad size or maxval")
    return kind, w, h, maxval, pos


def read_pnm(data: bytes, header) -> np.ndarray:
    """``PxMDecoder::readData`` into an 8-bit, 3-channel image (RGB)."""
    kind, w, h, maxval, pos = header
    binary = kind >= 4
    nch = 3 if kind in (3, 6) else 1
    wide = maxval > 255                          # 16-bit samples
    if kind in (1, 4):
        if binary:
            pitch = (w + 7) // 8
            if pos + pitch * h > len(data):
                raise Refused("PXM: end of stream")
            rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(
                h, pitch)
            bits = _bits(rows, w)
        else:
            bits = _read_numbers(data, pos, w * h, one_digit=True)[0]
            bits = (bits != 0).reshape(h, w)
        grey = np.where(bits == 1, 0, 255).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    n = w * nch
    if binary:
        size = n * h * (2 if wide else 1)
        if pos + size > len(data):
            raise Refused("PXM: end of stream")
        if wide:
            samples = (np.frombuffer(data, ">u2", n * h, pos) >> 8).astype(
                np.uint8)
        else:
            samples = np.frombuffer(data, np.uint8, n * h, pos)
    else:
        codes = np.minimum(_read_numbers(data, pos, n * h)[0], maxval)
        if wide:
            samples = (codes >> 8).astype(np.uint8)
        elif maxval == 255:
            samples = codes.astype(np.uint8)
        else:                             # int32: at most 255 * 255
            samples = (codes * 255 // maxval).astype(np.uint8)
    samples = samples.reshape(h, w, nch)
    if nch == 1:
        return np.repeat(samples, 3, axis=2)
    return np.ascontiguousarray(samples)


# -- PAM ---------------------------------------------------------------------

_PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
# tuple type -> the depth it must have
_PAM_TUPLES = {"": None, "BLACKANDWHITE": 1, "GRAYSCALE": 1,
               "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}


def _pam_line(data: bytes, pos: int):
    """``ReadPAMHeaderLine``: ``(field or None, value, position)``."""
    def get(p):
        if p >= len(data):
            raise Refused("PAM: end of stream")
        return data[p]

    c = get(pos)
    pos += 1
    while _isspace(c):
        c = get(pos)
        pos += 1
    if c == ord("#"):
        while c not in (10, 13):
            c = get(pos)
            pos += 1
        return None, "", pos
    ident = bytearray()
    while len(ident) < 8 and not _isspace(c):
        ident.append(c)
        c = get(pos)
        pos += 1
    if not _isspace(c):
        raise Refused("PAM: identifier too long")
    field = ident.decode("latin-1")
    if field not in _PAM_FIELDS:
        raise Refused("PAM: unknown header field")
    if c in (10, 13):
        return field, "", pos
    c = get(pos)
    pos += 1
    while _isspace(c):
        c = get(pos)
        pos += 1
    value = bytearray()
    while len(value) < 255 and c not in (10, 13):
        value.append(c)
        c = get(pos)
        pos += 1
    if c not in (10, 13):
        raise Refused("PAM: header value too long")
    return field, value.decode("latin-1").rstrip(" \t\n\v\f\r"), pos


def _parse_int(value: str) -> int:
    """``ParseInt``: an optional ``-`` before at least one digit, decimal
    digits to the end of the value, under ``INT_MAX``; an empty value is
    0."""
    m = re.fullmatch(r"(-?)([0-9]*)", value)
    if m is None or (m.group(1) and not m.group(2)):
        raise Refused("PAM: not a number")
    v = int(m.group(2) or 0)
    if v >= INT_MAX:
        raise Refused("PAM: number too large")
    return -v if m.group(1) else v


def pam_header(data: bytes):
    """``PAMDecoder::readHeader``: ``(width, height, depth, maxval,
    tuple type, offset)``."""
    if len(data) < 3 or data[:2] != b"P7" or data[2] not in (10, 13):
        raise Refused("PAM: bad header")
    pos, seen = 3, {}
    while True:
        field, value, pos = _pam_line(data, pos)
        if field is None:
            continue
        if field == "ENDHDR":
            break
        if field == "TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise Refused("PAM: unknown tuple type")
            seen[field] = value
            continue
        if field in seen:
            raise Refused("PAM: field repeated")
        seen[field] = _parse_int(value)
        if field == "MAXVAL" and seen[field] > 65535:
            raise Refused("PAM: maxval over 65535")
    if not {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL"} <= set(seen):
        raise Refused("PAM: field missing")
    w, h, depth, maxval = (seen[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                             "MAXVAL"))
    tuple_type = seen.get("TUPLTYPE", "")
    if tuple_type == "":
        if depth == 1 and maxval == 1:
            tuple_type = "BLACKANDWHITE"
        elif depth == 1 and maxval < 256:
            tuple_type = "GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tuple_type = "RGB"
        else:
            raise Refused("PAM: can't determine the tuple type")
    if _PAM_TUPLES[tuple_type] != depth or not 1 <= depth <= 4:
        raise Refused("PAM: depth does not fit the tuple type")
    return w, h, depth, maxval, tuple_type, pos


def read_pam(data: bytes, header) -> np.ndarray:
    """``PAMDecoder::readData`` into an 8-bit, 3-channel image (RGB)."""
    w, h, depth, maxval, tuple_type, pos = header
    wide = maxval > 255
    row_bytes = w * depth * (2 if wide else 1)
    if w <= 0 or h <= 0 or pos + row_bytes * h > len(data):
        raise Refused("PAM: end of stream")
    if maxval == 1:                              # bit mode
        rows = np.frombuffer(data, np.uint8, row_bytes * h, pos).reshape(
            h, row_bytes)
        grey = (_bits(rows, w) * 255).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    if wide:
        s = (np.frombuffer(data, ">u2", w * depth * h, pos) >> 8).astype(
            np.uint8)
    else:
        s = np.frombuffer(data, np.uint8, w * depth * h, pos)
    s = s.reshape(h, w, depth)
    if depth == 3:                               # copied into BGR as it is
        return np.ascontiguousarray(s[:, :, ::-1])
    out = np.zeros((h, w, 3), np.uint8)
    n = w // depth                               # basic_conversion's end
    if depth == 1:
        out[:] = s
    elif depth == 2:
        out[:, :n] = s[:, :n, :1]
    else:
        out[:, :n] = s[:, :n, :3]
    return out


# -- PFM ---------------------------------------------------------------------

def _read_token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """``read_number``'s text: bytes up to the first white space (which
    is consumed), at most 2048, each a signed char."""
    out = bytearray()
    for _ in range(2048):
        if pos >= len(data):
            raise Refused("PFM: end of stream")
        c = data[pos]
        pos += 1
        if c >= 128:
            raise Refused("PFM: byte out of range")
        if _isspace(c):
            break
        out.append(c)
    return bytes(out), pos


def _atoi(text: bytes) -> int:
    m = re.match(rb"[ \t\n\v\f\r]*[+-]?[0-9]+", text)
    return 0 if m is None else int(m.group(0))


def _atof(text: bytes) -> float:
    m = re.match(rb"[ \t\n\v\f\r]*([+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)"
                 rb"(?:[eE][+-]?[0-9]+)?|[+-]?(?:inf(?:inity)?|nan))",
                 text, re.IGNORECASE)
    return 0.0 if m is None else float(m.group(1))


def pfm_header(data: bytes):
    """``PFMDecoder::readHeader``: ``(channels, width, height, scale,
    offset)``."""
    if len(data) < 3 or data[0] != ord("P") or data[1] not in b"fF" \
            or data[2] != ord("\n"):
        raise Refused("PFM: bad header")
    nch = 3 if data[1] == ord("F") else 1
    text, pos = _read_token(data, 3)
    w = _atoi(text)
    text, pos = _read_token(data, pos)
    h = _atoi(text)
    text, pos = _read_token(data, pos)
    return nch, w, h, _atof(text), pos


def saturate_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV's float -> uint8 ``convertTo``: round half to even, then
    saturate; NaN, infinities and values that do not fit an int32 give
    0 (``cvRound``'s integer indefinite)."""
    r = np.rint(v.astype(np.float32))
    with np.errstate(invalid="ignore"):
        ok = np.abs(r) < np.float32(2 ** 31)
    return np.where(ok, np.clip(np.where(ok, r, 0), 0, 255),
                    0).astype(np.uint8)


def read_pfm(data: bytes, header) -> np.ndarray:
    """``PFMDecoder::readData``: (H, W, 3) RGB, or (H, W) for a grey
    PFM."""
    nch, w, h, scale, pos = header
    n = w * h * nch
    if w <= 0 or h <= 0 or pos + 4 * n > len(data):
        raise Refused("PFM: end of stream")
    if scale == 0:
        raise Refused("PFM: scale factor 0")
    f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, pos)
    f = f.astype(np.float32).reshape(h, w, nch)[::-1]   # rows bottom up
    f = f * np.float32(np.float32(1.0) / np.float32(abs(scale)))
    out = saturate_u8(f)
    return np.ascontiguousarray(out if nch == 3 else out[:, :, 0])


# -- Radiance HDR ------------------------------------------------------------

def _fgets(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """C's ``fgets`` with a 128-byte buffer: a line with its newline, at
    most 127 bytes, or None at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def hdr_header(data: bytes):
    """``RGBE_ReadHeader`` as OpenCV has it: header lines up to a blank
    one, one of them ``FORMAT=32-bit_rle_rgbe``, then ``-Y h +X w``:
    ``(width, height, offset)``; the width and height stay -1 where the
    header does not give them."""
    pos, found = 0, False
    while True:
        line, pos = _fgets(data, pos)
        if line is None:
            return -1, -1, pos
        if line == b"\n":
            break
        found |= line == b"FORMAT=32-bit_rle_rgbe\n"
    if not found:
        return -1, -1, pos
    line, pos = _fgets(data, pos)
    m = None if line is None else re.match(
        rb"-Y[ \t\n\v\f\r]*([+-]?[0-9]+)[ \t\n\v\f\r]*\+X"
        rb"[ \t\n\v\f\r]*([+-]?[0-9]+)", line)
    if m is None:
        return -1, -1, pos
    return int(m.group(2)), int(m.group(1)), pos


def _rgbe_flat(data: bytes, pos: int, npixels: int, out: np.ndarray,
               start: int) -> int:
    """``RGBE_ReadPixels``: ``npixels`` raw RGBE quads into ``out`` (a
    flat (N, 4) uint8 array) from pixel ``start``."""
    n = min(npixels, max(0, (len(data) - pos) // 4))
    out[start:start + n] = np.frombuffer(data, np.uint8, 4 * n,
                                         pos).reshape(n, 4)
    if n < npixels:
        raise Refused("HDR: end of data")
    return pos + 4 * n


def read_hdr(data: bytes, header) -> np.ndarray:
    """``RGBE_ReadPixels_RLE`` into floats, then ``convertTo`` with a
    scale of 255: (H, W, 3) uint8 RGB."""
    w, h, pos = header
    quads = np.zeros((w * h, 4), np.uint8)
    if w < 8 or w > 0x7FFF:
        _rgbe_flat(data, pos, w * h, quads, 0)
    else:
        for y in range(h):
            head = data[pos:pos + 4]
            if len(head) < 4:
                raise Refused("HDR: end of data")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                # not run-length encoded: the rest of the file is flat
                _rgbe_flat(data, pos, w * (h - y), quads, w * y)
                break
            if (head[2] << 8 | head[3]) != w:
                raise Refused("HDR: wrong scanline width")
            pos += 4
            line = np.empty((4, w), np.uint8)
            for ch in range(4):
                x = 0
                while x < w:
                    if pos >= len(data):
                        raise Refused("HDR: end of data")
                    count = data[pos]
                    pos += 1
                    if count > 128:
                        count -= 128
                        if count == 0 or count > w - x or pos >= len(data):
                            raise Refused("HDR: bad scanline data")
                        line[ch, x:x + count] = data[pos]
                        pos += 1
                    else:
                        if count == 0 or count > w - x \
                                or pos + count > len(data):
                            raise Refused("HDR: bad scanline data")
                        line[ch, x:x + count] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                    x += count
            quads[y * w:(y + 1) * w] = line.T
    e = quads[:, 3].astype(np.int32)
    f = np.ldexp(np.float64(1.0), e - 136).astype(np.float32)
    rgb = quads[:, :3].astype(np.float32) * f[:, None]
    rgb[e == 0] = 0
    return saturate_u8(rgb.reshape(h, w, 3) * np.float32(255))


# -- TIFF --------------------------------------------------------------------

_TAG = dict(width=256, height=257, bits=258, photometric=262,
            orientation=274, spp=277, rows_per_strip=278, sample_format=339,
            tile_width=322, tile_height=323, compression=259, planar=284)
# the codecs libtiff knows that OpenCV 5.0.0's own libtiff is built
# without (old JPEG, PixarLog, JBIG, LERC, LZMA, ZSTD, WebP): its
# TIFFRGBAImageOK refuses them, where PIL's libtiff may decode them. A
# scheme libtiff does not know passes that check in both, and its strips
# fail to decode without stopping the read.
_CV_TIFF_UNCONFIGURED = (6, 32909, 34661, 34887, 34925, 50000, 50001)
_PHOTOMETRIC_PALETTE, _PHOTOMETRIC_LOGLUV = 3, 32845
_SAMPLEFORMAT_UINT, _SAMPLEFORMAT_INT, _SAMPLEFORMAT_IEEEFP = 1, 2, 3
# ORIENTATION_BOTRIGHT, _BOTLEFT, _RIGHTBOT, _LEFTBOT
_FLIPPED = (3, 4, 7, 8)
_MAX_TILE_SIZE = 1 << 30
_PLANARCONFIG_CONTIG = 1


def tiff_header(tif) -> Tuple[int, int]:
    """``TiffDecoder::readHeader`` on an open :class:`TiffFile`: the
    size, or :class:`Refused` where OpenCV's header check fails."""
    import ctypes

    if not tif.handle:
        raise Refused("TIFF: TIFFClientOpenExt failed")
    w = tif.get(_TAG["width"], ctypes.c_uint32)
    h = tif.get(_TAG["height"], ctypes.c_uint32)
    photometric = tif.get(_TAG["photometric"])
    if w is None or h is None or photometric is None:
        raise Refused("TIFF: a required field is missing")
    grey = photometric in (0, 1)
    bpp = tif.get(_TAG["bits"])
    bpp = 1 if bpp is None else bpp
    ncn = tif.get(_TAG["spp"])
    ncn = (1 if grey else 3) if ncn is None else ncn
    fmt = tif.get(_TAG["sample_format"])
    fmt = _SAMPLEFORMAT_UINT if fmt is None else fmt
    if ncn == 3 and photometric == _PHOTOMETRIC_LOGLUV:
        return w, h
    if bpp > 8 and (photometric > 2 or ncn not in (1, 3, 4)):
        bpp = 8
    if not 1 <= ncn <= 4:
        raise Refused("TIFF: unsupported number of channels")
    if bpp == 4 and photometric != _PHOTOMETRIC_PALETTE:
        raise Refused("TIFF: bitsperpixel value is 4 should be palette")
    if bpp == 32 and fmt not in (_SAMPLEFORMAT_IEEEFP, _SAMPLEFORMAT_UINT,
                                 _SAMPLEFORMAT_INT):
        raise Refused("TIFF: sample format")
    if bpp == 64 and fmt != _SAMPLEFORMAT_IEEEFP:
        raise Refused("TIFF: sample format")
    if bpp not in (1, 4, 8, 10, 12, 14, 16, 32, 64):
        raise Refused("TIFF: invalid bitsperpixel value")
    return w, h


def _scanline_route(tif, tiled: bool) -> bool:
    """Whether OpenCV reads the strips scanline by scanline once they are
    too large as RGBA: a stripped TIFF of 1 or 3 samples of 8 or 16 bits,
    contiguous, grey (either way) or RGB; its sample format is not asked
    (measured against cv2 on 16,400² single-strip files)."""
    photometric = tif.get(_TAG["photometric"])
    nch = tif.get(_TAG["spp"]) or (1 if photometric in (0, 1) else 3)
    return (not tiled and tif.get(_TAG["bits"]) in (8, 16) and nch in (1, 3)
            and tif.get(_TAG["planar"]) in (None, _PLANARCONFIG_CONTIG)
            and photometric in (0, 1, 2))


def _read_scanlines(tif, w: int, h: int) -> np.ndarray:
    """The scanline route: each row's samples as they stand (a 16-bit one
    by its high byte; no inversion of a white-is-zero grey), one sample
    repeated into three, three taken as RGB, the rows in the file's order
    (no orientation flips them; 5-8 still transpose, as measured against
    cv2 on every orientation tag)."""
    import ctypes

    lib = tif.lib
    t = ctypes.c_void_p(tif.handle)
    nbytes = tif.get(_TAG["bits"]) // 8
    nch = tif.get(_TAG["spp"]) or (1 if tif.get(_TAG["photometric"]) in (
        0, 1) else 3)
    size = lib.TIFFScanlineSize(t)
    if size < w * nch * nbytes:
        raise Refused("TIFF: scanline too short")
    line = np.empty(size, np.uint8)
    ptr = line.ctypes.data_as(ctypes.c_void_p)
    # a 16-bit sample's high byte: libtiff hands them over little-endian
    samples = line[nbytes - 1:w * nch * nbytes:nbytes].reshape(w, nch)
    out = np.empty((h, w, 3), np.uint8)
    for y in range(h):
        if lib.TIFFReadScanline(t, ptr, y, 0) < 0:
            raise Refused("TIFF: failed TIFFReadScanline")
        out[y] = samples
    return out


def read_tiff(tif, w: int, h: int) -> np.ndarray:
    """``TiffDecoder::readData`` into 8 bits, 3 channels: libtiff's RGBA
    strips or tiles (``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), each
    read bottom up into OpenCV's rows, as RGB; the scanline route where a
    strip as RGBA reaches 0.95 GiB and :func:`_scanline_route` holds."""
    import ctypes

    lib = tif.lib
    t = ctypes.c_void_p(tif.handle)
    if tif.get(_TAG["photometric"]) is None:
        raise Refused("TIFF: photometric")
    orientation = tif.get(_TAG["orientation"])
    vert_flip = orientation in _FLIPPED
    tiled = lib.TIFFIsTiled(t) != 0
    tw, th = w, 0
    if tiled:
        tw = tif.get(_TAG["tile_width"], ctypes.c_uint32)
        th = tif.get(_TAG["tile_height"], ctypes.c_uint32)
        if tw is None or th is None:
            raise Refused("TIFF: tile size")
    else:
        rows = tif.get(_TAG["rows_per_strip"], ctypes.c_uint32)
        th = 0 if rows is None else rows
    if tw == 0:
        tw = w
    if th == 0 or (not tiled and th == 0xFFFFFFFF):
        th = h
    as_int = lambda v: (v + (1 << 31)) % (1 << 32) - (1 << 31)  # noqa: E731
    if not (0 < as_int(tw) <= 1 << 24 and 0 < as_int(th) <= 1 << 24):
        raise Refused("TIFF: tile size out of range")
    spp = tif.get(_TAG["spp"])
    bits = tif.get(_TAG["bits"])
    if (spp or 0) > 4 or (bits or 0) > 64:
        raise Refused("TIFF: channels or bits out of range")
    if tif.get(_TAG["compression"]) in _CV_TIFF_UNCONFIGURED:
        raise Refused("TIFF: compression scheme not configured")
    msg = ctypes.create_string_buffer(1024)
    if not lib.TIFFRGBAImageOK(t, msg):
        raise Refused("TIFF: TIFFRGBAImageOK: " + msg.value.decode(
            "latin-1"))
    if th * tw * 4 >= _MAX_TILE_SIZE * 0.95 and _scanline_route(tif, tiled):
        out = _read_scanlines(tif, w, h)
    else:
        out = _read_rgba(tif, w, h, tw, th, tiled, vert_flip)
    # the orientations that swap rows and columns: OpenCV turns libtiff's
    # raster so (measured against cv2 on every orientation tag)
    if orientation in (5, 7):
        out = out.transpose(1, 0, 2)
    elif orientation in (6, 8):
        out = out.transpose(1, 0, 2)[::-1, ::-1]
    return np.ascontiguousarray(out)


def _read_rgba(tif, w: int, h: int, tw: int, th: int, tiled: bool,
               vert_flip: bool) -> np.ndarray:
    """The RGBA route: ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile`` into a
    buffer of ``th * tw`` RGBA pixels, which must stay under 1 GiB."""
    import ctypes

    lib = tif.lib
    t = ctypes.c_void_p(tif.handle)
    if th * tw * 4 >= _MAX_TILE_SIZE:
        raise Refused("TIFF: buffer_size is too large: >= 1Gb")
    raster = np.empty(th * tw * 4, np.uint8)
    ptr = raster.ctypes.data_as(ctypes.c_void_p)
    out = np.empty((h, w, 3), np.uint8)
    for y in range(0, h, th):
        tile_h = min(th, h - y)
        img_y = h - y - tile_h if vert_flip else y
        for x in range(0, w, tw):
            tile_w = min(tw, w - x)
            if tiled:
                ok = lib.TIFFReadRGBATile(t, x, y, ptr)
                start = (th - tile_h) * tw
            else:
                ok = lib.TIFFReadRGBAStrip(t, y, ptr)
                start = 0
            if not ok:
                raise Refused("TIFF: failed TIFFReadRGBA")
            px = raster.reshape(-1, 4)[start:start + tile_h * tw].reshape(
                tile_h, tw, 4)
            out[img_y:img_y + tile_h, x:x + tile_w] = \
                px[::-1, :tile_w, :3]
    return out


# -- GIF ---------------------------------------------------------------------

def gif_lzw(data: bytes, pos: int, npix: int) -> np.ndarray:
    """OpenCV's ``lzwDecode`` from ``pos`` (the minimum code size): the
    ``npix`` colour indices; :class:`Refused` where it fails or leaves
    pixels of the frame unwritten."""
    import ctypes

    out = np.zeros(npix, np.uint8)
    written = ctypes.c_int64(0)
    status = _native().cvg_lzw_decode(data, len(data), pos, npix,
                                      out.ctypes.data_as(ctypes.c_void_p),
                                      ctypes.byref(written))
    if status != 0 or written.value != npix:
        raise Refused(f"GIF: LZW decode failed ({status}, "
                      f"{written.value} of {npix} pixels)")
    return out


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise Refused("GIF: end of stream")
    return data[pos] | data[pos + 1] << 8


def _byte(data: bytes, pos: int) -> int:
    if pos >= len(data):
        raise Refused("GIF: end of stream")
    return data[pos]


def _sub_blocks(data: bytes, pos: int) -> int:
    """The position after a run of data sub-blocks and its terminator."""
    while True:
        n = _byte(data, pos)
        pos += 1
        if n == 0:
            return pos
        pos += n


def _gif_blocks(data: bytes, pos: int) -> list:
    """The walk of ``GifDecoder::readHeader``, which counts the frames:
    ``(kind, position)`` of each extension (0x21) and image (0x2C) block
    from ``pos`` to the trailer; :class:`Refused` where a block runs past
    the data or another byte stands before the trailer."""
    blocks = []
    while True:
        kind = _byte(data, pos)
        if kind == 0x3B:
            return blocks
        blocks.append((kind, pos))
        if kind == 0x21:
            pos += 2
        elif kind == 0x2C:
            flags = _byte(data, pos + 9)
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1
        else:
            raise Refused("GIF: unknown block")
        pos = _sub_blocks(data, pos)


def gif_header(data: bytes):
    """``GifDecoder::readHeader``: ``(width, height, background index,
    global table or None, blocks)``, the blocks as :func:`_gif_blocks`
    gives them."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise Refused("GIF: bad signature")
    w, h = _u16(data, 6), _u16(data, 8)
    flags, bg = _byte(data, 10), _byte(data, 11)
    pos = 13
    table = None
    if flags & 0x80:
        n = 1 << ((flags & 7) + 1)
        if pos + 3 * n > len(data):
            raise Refused("GIF: end of stream")
        table = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        pos += 3 * n
        if bg >= n:
            raise Refused("GIF: bgColor should be < globalColorTableSize")
    return w, h, bg, table, _gif_blocks(data, pos)


def read_gif(data: bytes, header) -> np.ndarray:
    """``GifDecoder::readData`` of the first frame, as ``IMREAD_COLOR``
    gives it: (H, W, 3) RGB.

    The canvas is the global table's background colour (black without a
    global table), whatever the frame's disposal. The frame's pixels are
    painted at its place on the screen (a frame that spills over the
    screen refuses): an index below the local table's size takes its
    colour there, else one below the global table's size takes the global
    colour, else the decode fails; a file with neither table reads each
    index as its own grey, 1 as white. The transparent index (of the last
    graphic control extension before the frame) leaves the canvas
    showing. The LZW data follows ``ops/native/cv_readers.cc``."""
    w, h, bg, global_table, blocks = header
    transparent = None
    for kind, pos in blocks:
        if kind == 0x2C:
            break
        if data[pos + 1] == 0xF9:                # graphic control
            if data[pos + 2] != 4:
                raise Refused("GIF: len == 4")
            transparent = data[pos + 6] if data[pos + 3] & 1 else None
    else:
        raise Refused("GIF: no image separator")
    left, top = _u16(data, pos + 1), _u16(data, pos + 3)
    fw, fh = _u16(data, pos + 5), _u16(data, pos + 7)
    flags = data[pos + 9]
    pos += 10
    if not (fw > 0 and fh > 0 and left + fw <= w and top + fh <= h):
        raise Refused("GIF: frame outside the screen")
    local_table = None
    if flags & 0x80:
        n = 1 << ((flags & 7) + 1)
        local_table = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n,
                                                                        3)
        pos += 3 * n
    codes = gif_lzw(data, pos, fw * fh)
    canvas = np.zeros((h, w, 3), np.uint8)
    if global_table is not None:              # filled a row at a time
        canvas.reshape(h, 3 * w)[:] = np.tile(global_table[bg], w)
    rows = np.arange(fh)
    if flags & 0x40:                     # interlaced: four passes
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                               rows[1::2]])
    idx = np.empty((fh, fw), np.uint8)
    idx[rows] = codes.reshape(fh, fw)
    # index -> RGB, and how many indices have a colour
    lut = np.zeros((256, 3), np.uint8)
    if local_table is None and global_table is None:
        lut[:] = np.arange(256, dtype=np.uint8)[:, None]
        lut[1] = 255
        known = 256
    else:
        known = 0
        for table in (global_table, local_table):
            if table is not None:
                lut[:len(table)] = table
                known = max(known, len(table))
    show = np.ones((fh, fw), bool) if transparent is None \
        else idx != transparent
    if show.any() and int(idx[show].max()) >= known:
        raise Refused("GIF: colour index past the colour tables")
    frame = canvas[top:top + fh, left:left + fw]
    frame[show] = lut[idx[show]]
    return canvas


# -- JPEG 2000 ---------------------------------------------------------------

OPJ_CLRSPC_UNSPECIFIED, OPJ_CLRSPC_SRGB, OPJ_CLRSPC_GRAY = 0, 1, 2
OPJ_CLRSPC_SYCC = 3


def yuv_to_rgb_u8(y: np.ndarray, u: np.ndarray, v: np.ndarray
                  ) -> np.ndarray:
    """OpenCV's 8-bit ``cvtColor(..., COLOR_YUV2BGR)`` (then BGR -> RGB):
    14-bit fixed point, ``R = Y + 1.140 V``, ``G = Y - 0.395 U - 0.581
    V``, ``B = Y + 2.032 U`` with U, V centred on 128, rounded, saturated."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    r = y + descale(v * 18678)
    g = y + descale(u * -6472 + v * -9519)
    b = y + descale(u * 33292)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def read_jpeg2000(data: bytes, check_size) -> np.ndarray:
    """``Jpeg2KOpjDecoderBase::readHeader`` / ``readData`` into 8 bits, 3
    channels (RGB); ``check_size(w, h)`` runs between the header and the
    samples, where OpenCV checks the size."""
    from .codec_libs import OPJ_CODEC_J2K, OPJ_CODEC_JP2, opj_decode

    def header(img):
        comps = img.components
        if not 1 <= len(comps) <= 4:
            raise Refused("OpenJPEG2000: unsupported number of components")
        if any(c.sgnd for c in comps):
            raise Refused("OpenJPEG2000: component is signed")
        if sum(1 for c in comps if c.alpha) > 1:
            raise Refused("OpenJPEG2000: duplicate alpha channel")
        if max(c.prec for c in comps) < 8:
            raise Refused("OpenJPEG2000: Precision < 8 not supported")
        if max(c.prec for c in comps) > 64:
            raise Refused("OpenJPEG2000: precision > 64 is not supported")
        check_size(img.width, img.height)

    codec = OPJ_CODEC_J2K if data[:4] == b"\xff\x4f\xff\x51" \
        else OPJ_CODEC_JP2
    img = opj_decode(data, codec, header)
    if img is None:
        raise Refused("OpenJPEG2000: decoding failed")
    comps = img.components
    shift = max(max(c.prec for c in comps) - 8, 0)
    if any(c.samples is None or c.samples.shape != (img.height, img.width)
           for c in comps):
        raise Refused("OpenJPEG2000: a component does not cover the image")
    planes = [(c.samples >> shift).astype(np.uint8) for c in comps]
    if img.color_space == OPJ_CLRSPC_GRAY:
        rgb = [planes[0]] * 3
    elif img.color_space in (OPJ_CLRSPC_UNSPECIFIED, OPJ_CLRSPC_SRGB, -1):
        if len(planes) < 3:
            raise Refused("OpenJPEG2000: unsupported conversion to 3 "
                          "channels for SRGB image decoding")
        rgb = planes[:3]
    elif img.color_space == OPJ_CLRSPC_SYCC and len(planes) >= 3:
        return yuv_to_rgb_u8(*planes[:3])
    else:                          # e-YCC, CMYK
        raise Refused("OpenJPEG2000: unsupported color space conversion")
    return np.ascontiguousarray(np.stack(rgb, axis=-1))


# -- Sun raster of 1 bit with a colour map -----------------------------------

def read_sun_1bit_mapped(data: bytes) -> np.ndarray:
    """``SunRasterDecoder`` on a standard or old 1-bit raster with a colour
    map of 1 to 6 bytes: (H, W, 3) RGB."""
    w, h, _, _, _, _, map_len = struct.unpack(">7I", data[4:32])
    n = map_len // 3
    if 32 + map_len > len(data):
        raise Refused("SunRaster: end of stream")
    cmap = np.frombuffer(data, np.uint8, map_len, 32)
    rgb = np.zeros((2, 3), np.uint8)
    for i in range(n):
        rgb[i] = cmap[i], cmap[i + n], cmap[i + 2 * n]
    pitch = ((w + 7) // 8 + 1) & ~1
    pos = 32 + map_len
    if pos + pitch * h > len(data):
        raise Refused("SunRaster: end of stream")
    rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
    return rgb[_bits(rows, w)]
