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
- ``digests.json``: per file, the SHA-256 of ``cv2.imdecode(data,
  IMREAD_COLOR)`` turned to RGB (C order, uint8), its shape, or null where
  cv2 gives None. Needs cv2 (OpenCV 5.0.0)."""

import hashlib
import io
import json
import os

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
