"""Page canvases for the batched detection lane (counterpart of the
module-level pieces of pdf_table_tpu/pipeline/batch_runner.py).

Pages are padded with white into the smallest fitting canvas bucket, and
each bucket has one detector input size (limit-side rule, multiples of
32), so a chunk of pages is one fixed-shape device program.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# page canvas buckets (H, W): most A4-ish rasters at 144 dpi land in the
# first two
PAGE_BUCKETS = ((1280, 960), (1600, 1280), (2048, 1536))


def pick_page_bucket(h: int, w: int) -> Tuple[int, int]:
    for bh, bw in PAGE_BUCKETS:
        if h <= bh and w <= bw:
            return (bh, bw)
    return PAGE_BUCKETS[-1]


def det_input_size(bucket: Tuple[int, int], limit_side_len: int
                   ) -> Tuple[int, int]:
    """Detector input size for a canvas bucket (limit-side rule, /32)."""
    H, W = bucket
    ratio = min(limit_side_len / max(H, W), 1.0) \
        if max(H, W) > limit_side_len else 1.0
    nh = max(int(round(H * ratio / 32) * 32), 32)
    nw = max(int(round(W * ratio / 32) * 32), 32)
    return nh, nw


def pack_pages(images: Sequence[np.ndarray]
               ) -> Dict[Tuple[int, int], Dict]:
    """Group uint8 HWC pages by canvas bucket, padded with white:
    {bucket: {"indices": [...], "images": (n, H, W, 3) uint8, "shapes":
    [(h, w), ...]}}. A page larger than the largest bucket raises: the JAX
    package scales it down with cv2 first, which the port does not carry
    yet."""
    groups: Dict[Tuple[int, int], Dict] = {}
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        b = pick_page_bucket(h, w)
        if h > b[0] or w > b[1]:
            raise ValueError(
                f"page {i} ({h}x{w}) exceeds the largest canvas bucket {b}; "
                f"scale it to fit first")
        g = groups.setdefault(b, {"indices": [], "images": [], "shapes": []})
        canvas = np.full((b[0], b[1], 3), 255, np.uint8)
        canvas[:h, :w] = img
        g["indices"].append(i)
        g["images"].append(canvas)
        g["shapes"].append((h, w))
    for g in groups.values():
        g["images"] = np.stack(g["images"])
    return groups
