"""OpenJPEG and libtiff, as PIL's own build links them, called through
ctypes: the two libraries that OpenCV 5.0.0 reads JPEG 2000 and TIFF
with. PIL's plugins hand back samples that are already converted (a
16-bit colour JPEG 2000 rounded to 8 bits, a TIFF through PIL's own
unpackers), so the port asks the libraries for what OpenCV asks them
for: OpenJPEG's component samples (``grfmt_jpeg2000_openjpeg.cpp``) and
libtiff's RGBA strips and tiles (``grfmt_tiff.cpp`` reads a TIFF
through ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile`` when it decodes to
8 bits, and through ``TIFFReadScanline`` where a strip as RGBA would
reach 0.95 GiB).

Both libraries are mapped into the process once ``PIL._imaging`` is
imported (it links them); their paths are read from ``/proc/self/maps``.
Where either is missing, :func:`openjpeg` / :func:`libtiff` raise
:class:`CodecLibraryMissing`: there is no fallback to PIL's conversions,
which differ from OpenCV's."""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_libs: dict = {}


class CodecLibraryMissing(RuntimeError):
    """PIL's build does not link the library that the port's reader of a
    format needs."""


def mapped_library(stem: str) -> Optional[str]:
    """The path of the first shared object mapped into this process whose
    file name starts with ``stem`` (after ``import PIL._imaging``), or
    None."""
    import os

    import PIL._imaging  # noqa: F401  (maps the libraries it links)

    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            name = os.path.basename(path)
            if path.startswith("/") and name.startswith(
                    (stem + "-", stem + ".so")):
                return path
    return None


def _load(stem: str, bind) -> ctypes.CDLL:
    with _lock:
        if stem in _libs:
            return _libs[stem]
        path = mapped_library(stem)
        if path is None:
            raise CodecLibraryMissing(
                f"{stem} is not linked by this PIL build: the port reads "
                f"this format with it, as OpenCV 5.0.0 does")
        lib = ctypes.CDLL(path)
        try:
            bind(lib)
        except AttributeError as e:        # a build without a call we need
            raise CodecLibraryMissing(f"{path}: {e}") from None
        lib.path = path
        _libs[stem] = lib
        return lib


# -- OpenJPEG ----------------------------------------------------------------

class _OpjComp(ctypes.Structure):
    _fields_ = [("dx", ctypes.c_uint32), ("dy", ctypes.c_uint32),
                ("w", ctypes.c_uint32), ("h", ctypes.c_uint32),
                ("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("prec", ctypes.c_uint32), ("bpp", ctypes.c_uint32),
                ("sgnd", ctypes.c_uint32), ("resno_decoded", ctypes.c_uint32),
                ("factor", ctypes.c_uint32),
                ("data", ctypes.POINTER(ctypes.c_int32)),
                ("alpha", ctypes.c_uint16)]


class _OpjImage(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_OpjComp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_OPJ_READ = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_void_p,
                             ctypes.c_size_t, ctypes.c_void_p)
_OPJ_SKIP = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)
_OPJ_SEEK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)
_OPJ_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)
_opj_quiet = _OPJ_MSG(lambda msg, user: None)
# opj_dparameters_t is some 17 KB in OpenJPEG 2.5; a larger buffer is safe
_OPJ_PARAMS_BYTES = 1 << 16
OPJ_CODEC_J2K, OPJ_CODEC_JP2 = 0, 2


def _bind_openjpeg(lib) -> None:
    vp, b = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "opj_create_decompress": (vp, [ctypes.c_int]),
        "opj_set_default_decoder_parameters": (None, [vp]),
        "opj_setup_decoder": (b, [vp, vp]),
        "opj_stream_create": (vp, [ctypes.c_size_t, b]),
        "opj_stream_set_read_function": (None, [vp, _OPJ_READ]),
        "opj_stream_set_skip_function": (None, [vp, _OPJ_SKIP]),
        "opj_stream_set_seek_function": (None, [vp, _OPJ_SEEK]),
        "opj_stream_set_user_data": (None, [vp, vp, vp]),
        "opj_stream_set_user_data_length": (None, [vp, ctypes.c_uint64]),
        "opj_read_header": (b, [vp, vp, ctypes.POINTER(
            ctypes.POINTER(_OpjImage))]),
        "opj_decode": (b, [vp, vp, ctypes.POINTER(_OpjImage)]),
        "opj_destroy_codec": (None, [vp]),
        "opj_stream_destroy": (None, [vp]),
        "opj_image_destroy": (None, [ctypes.POINTER(_OpjImage)]),
        "opj_set_error_handler": (b, [vp, _OPJ_MSG, vp]),
        "opj_set_warning_handler": (b, [vp, _OPJ_MSG, vp]),
        "opj_set_info_handler": (b, [vp, _OPJ_MSG, vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def openjpeg() -> ctypes.CDLL:
    """PIL's libopenjp2, bound; raises :class:`CodecLibraryMissing`."""
    return _load("libopenjp2", _bind_openjpeg)


class OpjComponent:
    """One component: its precision, sign and alpha flags, and its (h, w)
    int32 samples once decoded."""

    def __init__(self, c: _OpjComp, samples: Optional[np.ndarray]):
        self.prec, self.sgnd, self.alpha = c.prec, c.sgnd, c.alpha
        self.samples = samples


class OpjImage:
    """A JPEG 2000 image as OpenJPEG gives it: the canvas bounds, the
    colour space (OpenJPEG's ``OPJ_COLOR_SPACE`` number) and the
    components."""

    def __init__(self, im: _OpjImage, decoded: bool):
        self.width, self.height = im.x1 - im.x0, im.y1 - im.y0
        self.color_space = im.color_space
        self.components = []
        for i in range(im.numcomps):
            c = im.comps[i]
            samples = None
            if decoded and c.data:
                n = c.w * c.h
                samples = np.ctypeslib.as_array(c.data, (n,)).reshape(
                    c.h, c.w).copy()
            self.components.append(OpjComponent(c, samples))


def opj_decode(data: bytes, codec: int, header_check=None
               ) -> Optional[OpjImage]:
    """Decode ``data`` as OpenCV's ``Jpeg2KOpjDecoderBase`` does
    (``opj_read_header``, then ``opj_decode``, default decoder parameters,
    a memory stream): the image, or None where OpenJPEG fails.
    ``header_check(OpjImage)`` runs between the two and may raise to stop
    before the samples are decoded (OpenCV's ``readHeader`` checks)."""
    lib = openjpeg()
    buf = ctypes.create_string_buffer(data, len(data))
    pos = [0]

    def read(dst, n, _user):
        left = len(data) - pos[0]
        if left <= 0:
            return ctypes.c_size_t(-1).value
        n = min(n, left)
        ctypes.memmove(dst, ctypes.addressof(buf) + pos[0], n)
        pos[0] += n
        return n

    def skip(n, _user):
        if pos[0] + n > len(data):
            n = len(data) - pos[0]
        if pos[0] + n < 0:
            n = -pos[0]
        pos[0] += n
        return n

    def seek(n, _user):
        if n < 0 or n > len(data):
            return 0
        pos[0] = n
        return 1

    callbacks = (_OPJ_READ(read), _OPJ_SKIP(skip), _OPJ_SEEK(seek))
    codec_p = lib.opj_create_decompress(codec)
    stream = lib.opj_stream_create(1 << 20, 1)
    image = ctypes.POINTER(_OpjImage)()
    try:
        for set_handler in (lib.opj_set_error_handler,
                            lib.opj_set_warning_handler,
                            lib.opj_set_info_handler):
            set_handler(codec_p, _opj_quiet, None)
        params = ctypes.create_string_buffer(_OPJ_PARAMS_BYTES)
        lib.opj_set_default_decoder_parameters(params)
        if not lib.opj_setup_decoder(codec_p, params):
            return None
        lib.opj_stream_set_read_function(stream, callbacks[0])
        lib.opj_stream_set_skip_function(stream, callbacks[1])
        lib.opj_stream_set_seek_function(stream, callbacks[2])
        lib.opj_stream_set_user_data(stream, None, None)
        lib.opj_stream_set_user_data_length(stream, len(data))
        if not lib.opj_read_header(stream, codec_p, ctypes.byref(image)):
            return None
        if header_check is not None:
            header_check(OpjImage(image.contents, False))
        if not lib.opj_decode(codec_p, stream, image):
            return None
        return OpjImage(image.contents, True)
    finally:
        if image:
            lib.opj_image_destroy(image)
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec_p)


# -- libtiff -----------------------------------------------------------------

_TIFF_READ = ctypes.CFUNCTYPE(ctypes.c_ssize_t, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_ssize_t)
_TIFF_SEEK = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.c_void_p,
                              ctypes.c_uint64, ctypes.c_int)
_TIFF_CLOSE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
_TIFF_SIZE = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.c_void_p)
_TIFF_MAP = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_uint64))
_TIFF_UNMAP = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_uint64)
# TIFFErrorHandlerExtR: (TIFF*, user data, module, fmt, va_list) -> handled
_TIFF_MSG = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_void_p)
_tiff_quiet = _TIFF_MSG(lambda *args: 1)
_tiff_close = _TIFF_CLOSE(lambda handle: 0)
_tiff_unmap = _TIFF_UNMAP(lambda handle, base, size: None)


def _bind_libtiff(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "TIFFClientOpenExt": (vp, [ctypes.c_char_p, ctypes.c_char_p, vp,
                                   _TIFF_READ, _TIFF_READ, _TIFF_SEEK,
                                   _TIFF_CLOSE, _TIFF_SIZE, _TIFF_MAP,
                                   _TIFF_UNMAP, vp]),
        "TIFFOpenOptionsAlloc": (vp, []),
        "TIFFOpenOptionsFree": (None, [vp]),
        "TIFFOpenOptionsSetErrorHandlerExtR": (None, [vp, _TIFF_MSG, vp]),
        "TIFFOpenOptionsSetWarningHandlerExtR": (None, [vp, _TIFF_MSG, vp]),
        "TIFFClose": (None, [vp]),
        "TIFFIsTiled": (i, [vp]),
        "TIFFRGBAImageOK": (i, [vp, ctypes.c_char_p]),
        "TIFFReadRGBAStrip": (i, [vp, ctypes.c_uint32, vp]),
        "TIFFReadRGBATile": (i, [vp, ctypes.c_uint32, ctypes.c_uint32, vp]),
        "TIFFScanlineSize": (ctypes.c_ssize_t, [vp]),
        "TIFFReadScanline": (i, [vp, vp, ctypes.c_uint32, ctypes.c_uint16]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    # TIFFGetField is variadic: its one pointer argument is passed as is
    lib.TIFFGetField.restype = ctypes.c_int


def libtiff() -> ctypes.CDLL:
    """PIL's libtiff (4.5 or later: ``TIFFClientOpenExt``), bound; raises
    :class:`CodecLibraryMissing`."""
    return _load("libtiff", _bind_libtiff)


class TiffFile:
    """A TIFF held in memory and opened by libtiff as OpenCV's
    ``TiffDecoderBufHelper`` opens it (read, seek clamped to the end, the
    buffer mapped); libtiff's messages are dropped. A context manager;
    ``handle`` is the ``TIFF*``, or None where the open failed."""

    def __init__(self, data: bytes):
        self.lib = lib = libtiff()
        self.buf = ctypes.create_string_buffer(data, len(data))
        self.size = len(data)
        self.pos = 0

        def read(_h, dst, n):
            n = max(0, min(n, self.size - self.pos))
            ctypes.memmove(dst, ctypes.addressof(self.buf) + self.pos, n)
            self.pos += n
            return n

        def seek(_h, off, whence):
            new = {0: off, 1: self.pos + off, 2: self.size + off}.get(
                whence, self.pos) % (1 << 64)
            self.pos = min(new, self.size)
            return self.pos

        def map_(_h, base, size):
            base[0] = ctypes.addressof(self.buf)
            size[0] = self.size
            return 1

        self._procs = (_TIFF_READ(read), _TIFF_READ(lambda h, b, n: 0),
                       _TIFF_SEEK(seek), _tiff_close,
                       _TIFF_SIZE(lambda h: self.size), _TIFF_MAP(map_),
                       _tiff_unmap)
        opts = lib.TIFFOpenOptionsAlloc()
        lib.TIFFOpenOptionsSetErrorHandlerExtR(opts, _tiff_quiet, None)
        lib.TIFFOpenOptionsSetWarningHandlerExtR(opts, _tiff_quiet, None)
        self.handle = lib.TIFFClientOpenExt(b"", b"r", None, *self._procs,
                                            opts)
        lib.TIFFOpenOptionsFree(opts)

    def get(self, tag: int, ctype=ctypes.c_uint16) -> Optional[int]:
        """``TIFFGetField`` of one scalar tag, or None where it fails."""
        v = ctype(0)
        ok = self.lib.TIFFGetField(ctypes.c_void_p(self.handle),
                                   ctypes.c_uint32(tag), ctypes.byref(v))
        return v.value if ok else None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.handle:
            self.lib.TIFFClose(self.handle)
            self.handle = None
