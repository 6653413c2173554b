"""Seeded inputs for the port's OpenCV 5.0.0 host geometry, and SHA-256
digests of what ``cv2`` 5.0.0 gives on them: ``minAreaRect`` of a page's
dark pixels and of float quads, ``warpAffine`` (the deskew's uint8 turn
with a white border, f32 scale-and-translate and rotate warps, LORE's
uint8 warp at 768² and 1024²), ``fillPoly`` of quads that leave the image,
and the f32 ``resize`` (1 and 3 channels, up and down, edge runs).

    python tests/data/image_decode/host_geometry.py   # needs cv2

rewrites ``host_geometry_digests.json`` beside this file.
``chip_smoke.py``'s ``decode`` phase holds the port's outputs on a host
without cv2 to those digests (:func:`port_outputs`), and
tests/test_torch_cv_host.py holds both cv2's and the port's to them here.
The inputs come from numpy's seeded generator and integer or exact float
arithmetic only, so that every host builds the same bytes."""

import hashlib
import json
import os
from typing import Callable, Dict, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "host_geometry_digests.json")

# a turn by about 3.2 degrees, as exact binary fractions
COS, SIN = 0.9984375, 0.0556640625


def bar_points(seed: int) -> np.ndarray:
    """The dark pixels of a page of word bars (some 900 x 700 px), turned
    by (COS, SIN) and rounded: (n, 2) int32, tens of thousands of points."""
    rng = np.random.default_rng(seed)
    h, w = 900, 700
    img = np.zeros((h, w), bool)
    y = 20
    while y < h - 30:
        x, lh = 20, int(rng.integers(6, 14))
        while x < w - 40:
            ww = int(rng.integers(8, 60))
            img[y:y + lh, x:min(x + ww, w - 20)] = True
            x += ww + int(rng.integers(4, 14))
        y += lh + int(rng.integers(8, 24))
    ys, xs = np.nonzero(img)
    px = np.rint(COS * xs - SIN * ys + 80).astype(np.int32)
    py = np.rint(SIN * xs + COS * ys + 20).astype(np.int32)
    pts = np.unique(np.stack([px, py], 1), axis=0)
    return pts[np.lexsort((pts[:, 0], pts[:, 1]))]


def float_quads(seed: int, n: int = 200) -> List[np.ndarray]:
    """Quads of float corners, near-rectangles of every size."""
    rng = np.random.default_rng(seed)
    return [(rng.random((4, 2)) * 300).astype(np.float32) for _ in range(n)]


def page(seed: int, h: int, w: int) -> np.ndarray:
    """A uint8 (h, w, 3) page: noise under white stripes."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[::7] = 255
    return img


def turn(w: int, h: int, cos: float, sin: float) -> Tuple[np.ndarray,
                                                         Tuple[int, int]]:
    """``getRotationMatrix2D`` about the centre with the canvas grown to
    hold the page, as the deskew turns it (exact inputs)."""
    cx, cy = w / 2, h / 2
    m = np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                  [-sin, cos, sin * cx + (1 - cos) * cy]])
    nw, nh = int(h * sin + w * cos), int(h * cos + w * sin)
    m[0, 2] += nw / 2 - w / 2
    m[1, 2] += nh / 2 - h / 2
    return m, (nw, nh)


def quads_leaving(seed: int, n: int = 300):
    """(h, w, int32 quad) triples: rectangles turned by a rational slope,
    corners up to 10 px outside images of 3-80 px."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(3, 81, 2))
        c = rng.integers(-10, max(h, w) + 10, 2)
        a, b = (int(v) for v in rng.integers(1, 40, 2))
        dx, dy = int(rng.integers(-8, 9)), int(rng.integers(1, 9))
        u, v = np.array([dy, dx]), np.array([-dx, dy])
        quad = np.array([c, c + u * a // 8, c + u * a // 8 + v * b // 8,
                         c + v * b // 8], np.int32)
        out.append((h, w, quad))
    return out


def resizes() -> List[Tuple[np.ndarray, int, int]]:
    """(f32 image, h, w): values 0-255, 1 and 3 channels, up and down, and
    narrow sources whose edge runs are of every length."""
    rng = np.random.default_rng(19)
    out = []
    for H, W, h, w, c in ((512, 700, 736, 544, 3), (640, 480, 160, 96, 3),
                          (37, 53, 64, 96, 1), (120, 90, 48, 30, 3),
                          (60, 2, 90, 100, 3), (50, 7, 60, 64, 3),
                          (50, 11, 60, 300, 3), (43, 5, 47, 150, 1)):
        shape = (H, W) if c == 1 else (H, W, c)
        out.append(((rng.random(shape) * 255).astype(np.float32), h, w))
    return out


def digest(arr) -> str:
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256(str((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _rects(rects) -> np.ndarray:
    return np.array([[r[0][0], r[0][1], r[1][0], r[1][1], r[2]]
                     for r in rects], np.float32)


def _calls(lib) -> Dict[str, Callable[[], np.ndarray]]:
    """Each case's output from ``lib``: a namespace with min_area_rect,
    warp_affine(img, m, size, border), lore_warp_u8(img, side), fill_poly
    and resize_f32, cv2's or the port's."""
    calls = {
        "min_area_rect_page_dark_pixels": lambda: _rects(
            [lib.min_area_rect(bar_points(s)) for s in range(3)]),
        "min_area_rect_float_quads": lambda: _rects(
            [lib.min_area_rect(q) for q in float_quads(4)]),
    }
    for side in (768, 1024):
        calls[f"lore_warp_u8_{side}"] = (lambda side=side: np.stack(
            [lib.lore_warp_u8(page(5 + i, h, w), side) for i, (h, w) in
             enumerate(((1002, 1316), (333, 97), (1400, 880)))]))
    pg = page(8, 1100, 900)
    m, size = turn(900, 1100, COS, SIN)
    calls["deskew_turn_u8"] = lambda: lib.warp_affine(pg, m, size, 255.0)
    f = page(9, 300, 410).astype(np.float32) + 0.25
    calls["warp_affine_f32_scale"] = lambda: lib.warp_affine(
        f, np.array([[0.73, 0, 3.5], [0, 0.73, -2.25]]), (301, 222), 0.0)
    m2, size2 = turn(410, 300, COS, -SIN)
    calls["warp_affine_f32_turn"] = lambda: lib.warp_affine(
        f[..., 1], m2, size2, 255.0)

    def fills():
        out = []
        for h, w, quad in quads_leaving(10):
            mask = np.zeros((h, w), np.uint8)
            lib.fill_poly(mask, quad)
            out.append(mask.ravel())
        return np.concatenate(out)

    calls["fill_poly_leaving"] = fills
    calls["resize_f32"] = lambda: np.concatenate(
        [lib.resize_f32(img, h, w).ravel() for img, h, w in resizes()])
    return calls


class _Cv2:
    def __init__(self):
        import cv2
        self.cv2 = cv2

    def min_area_rect(self, pts):
        return self.cv2.minAreaRect(pts)

    def warp_affine(self, img, m, size, border):
        return self.cv2.warpAffine(img, m, size, flags=self.cv2.INTER_LINEAR,
                                   borderValue=(border,) * 4)

    def lore_warp_u8(self, img, side):
        # the centred matrix as LORE's pre-processor builds it
        h, w = img.shape[:2]
        s = side / (max(h, w) * 1.0)
        c = np.array([w / 2.0, h / 2.0], np.float32)
        m = np.array([[s, 0, side / 2 - s * c[0]],
                      [0, s, side / 2 - s * c[1]]], np.float32)
        return self.warp_affine(img, m, (side, side), 0.0)

    def fill_poly(self, mask, quad):
        self.cv2.fillPoly(mask, quad.reshape(1, -1, 2), 1)

    def resize_f32(self, img, h, w):
        return self.cv2.resize(img, (w, h))


class _Port:
    def __init__(self):
        from pdf_table_tpu_torch.models.lore.config import LoreConfig
        from pdf_table_tpu_torch.models.lore.processor import \
            LorePreProcessor
        from pdf_table_tpu_torch.ops import cv_host
        from pdf_table_tpu_torch.ops.crop_resize import resize_linear_f32
        self.ch, self.resize = cv_host, resize_linear_f32
        self.lore = lambda side: LorePreProcessor(
            LoreConfig.wireless(resolution=(side, side), upper_left=False))

    def min_area_rect(self, pts):
        return self.ch.min_area_rect(pts)

    def warp_affine(self, img, m, size, border):
        return self.ch.warp_affine_linear(
            img, m, size, border=border, out_dtype=img.dtype)

    def lore_warp_u8(self, img, side):
        return self.lore(side).warp_u8(img)["image_u8"][0]

    def fill_poly(self, mask, quad):
        self.ch.fill_poly(mask, quad, 1)

    def resize_f32(self, img, h, w):
        return self.resize(img, h, w)


def outputs(lib) -> Dict[str, str]:
    return {name: digest(call()) for name, call in _calls(lib).items()}


def cv2_outputs() -> Dict[str, str]:
    """Each case's digest of cv2's output (needs cv2)."""
    return outputs(_Cv2())


def port_outputs() -> Dict[str, str]:
    """Each case's digest of the port's output (no cv2)."""
    return outputs(_Port())


def load_digests() -> Dict[str, str]:
    with open(DIGESTS) as f:
        return json.load(f)["cases"]


if __name__ == "__main__":
    with open(DIGESTS, "w") as f:
        json.dump({"opencv": "5.0.0", "cases": cv2_outputs()}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
