"""Time the port's OpenCV host geometry of the per-page pre-process: the
deskew of a 2480 x 3508 page (300 dpi A4) as its angle
(``estimate_skew_angle``: grey, Otsu, ``findNonZero``, ``minAreaRect``)
and its turn (``rotate_image``: the uint8 ``warpAffine``), the per-page
pre-process (``OcrTablePreprocessTask``: the deskew, then the
page-orientation classifier, whose input is the f32 resize, on
``--device``, with its random weights) and its host part alone (no
classifier) on 1224 x 950 pages (the smoke's page size), and LORE
wireless's 768² ``warp_u8`` of a 1002 x 1316 crop.

    python tools/time_host_geometry.py [--root DIR] [--repeat N] [--device cpu]

``--root`` is the checkout whose ``pdf_table_tpu_torch`` is timed (by
default this one): an unpacked older commit gives the comparison on the
same host. The pages are word bars on white turned by a few degrees
(nearest-neighbour, in numpy), the same bytes for every checkout. Prints
one JSON object: per item the fastest of ``--repeat`` runs in
milliseconds, the skew angles, and a SHA-256 of the outputs (equal
digests: equal outputs)."""

import argparse
import hashlib
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def bar_page(seed: int, h: int, w: int, angle: float) -> np.ndarray:
    """Word bars of dark greys on white, turned by ``angle`` degrees about
    the centre (nearest neighbour, white outside)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    y = 40
    while y < h - 60:
        x, lh = 60, int(rng.integers(12, 28))
        while x < w - 90:
            ww = int(rng.integers(20, 160))
            img[y:y + lh, x:min(x + ww, w - 60)] = int(rng.integers(0, 90))
            x += ww + int(rng.integers(10, 30))
        y += lh + int(rng.integers(20, 50))
    a = math.radians(angle)
    ys, xs = np.mgrid[0:h, 0:w]
    cx, cy = w / 2, h / 2
    sx = np.rint(math.cos(a) * (xs - cx) - math.sin(a) * (ys - cy) + cx)
    sy = np.rint(math.sin(a) * (xs - cx) + math.cos(a) * (ys - cy) + cy)
    ok = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.full_like(img, 255)
    out[ok] = img[sy[ok].astype(int), sx[ok].astype(int)]
    return out


def best_ms(fn, repeat):
    best, out = float("inf"), None
    for _ in range(repeat):
        t = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t)
    return best * 1e3, out


def sha(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="the classifier's device (default: the card)")
    args = ap.parse_args()
    os.environ.setdefault("PDF_TABLE_TPU_ALLOW_RANDOM_INIT", "quiet")
    sys.path.insert(0, os.path.abspath(args.root))
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.models.lore.processor import LorePreProcessor
    from pdf_table_tpu_torch.ops import cv_host
    from pdf_table_tpu_torch.tasks import preprocess

    cv_host.build_native()
    a4 = bar_page(0, 3508, 2480, 2.4)
    out = {"root": os.path.abspath(args.root)}
    ms, angle = best_ms(lambda: preprocess.estimate_skew_angle(a4),
                        args.repeat)
    out["a4_skew_angle"] = {"ms": ms, "angle": angle}
    ms, turned = best_ms(lambda: preprocess.rotate_image(a4, angle),
                         args.repeat)
    out["a4_turn"] = {"ms": ms, "shape": list(turned.shape),
                      "sha256": sha([turned])}
    del turned
    pages = [bar_page(s, 1224, 950, (-1) ** s * (0.6 + 0.5 * s))
             for s in range(1, 5)]
    for name, cls in (("page_pre_process", True),
                      ("page_pre_process_host", False)):
        task = preprocess.OcrTablePreprocessTask(use_orientation_cls=cls,
                                                 device=args.device)
        task(pages[0])                       # builds the classifier
        ms, res = best_ms(lambda: [task(p) for p in pages], args.repeat)
        out[name] = {"ms_per_page": ms / len(pages),
                     "angles": [r["rotate_angle"] for r in res],
                     "quarter_turns": [r["quarter_turns"] for r in res],
                     "sha256": sha([r["image"] for r in res])}
    lore = LorePreProcessor(LoreConfig.wireless(resolution=(768, 768)))
    crop = np.random.default_rng(7).integers(0, 256, (1002, 1316, 3),
                                             dtype=np.uint8)
    ms, res = best_ms(lambda: lore.warp_u8(crop), args.repeat)
    out["lore_warp_u8_768"] = {"ms": ms, "sha256": sha([res["image_u8"]])}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
