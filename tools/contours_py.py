"""Suzuki-Abe border following in pure Python: the same algorithm as
``pdf_table_tpu_torch/ops/native/cv_host.cc`` (OpenCV's ``findContours``
with ``RETR_LIST`` and ``CHAIN_APPROX_SIMPLE``), line for line.

It is not part of the port. ``chip_smoke.py``'s ``system_per_page`` phase
times it beside the C++ library on the detection maps of its pages, on the
card's host, and checks that the two give the same contours: the numbers
behind keeping the border following in C++.

    python tools/contours_py.py      # a 736 x 960 map: both, ms each
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def _fetch(img: List[int], i0: int, step: int, x: int, y: int,
           is_hole: bool, out: List[int]) -> None:
    deltas = [1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1]
    deltas = deltas + deltas
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:
        img[i0] = -126
        out += (x, y)
        return
    i3 = i0
    prev_s = s ^ 4
    while True:
        s_end = s
        s = min(s, 15)
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if (s - 1) & 0xFFFFFFFF < s_end:
            img[i3] = -126
        elif img[i3] == 1:
            img[i3] = 2
        if s != prev_s:
            out += (x, y)
            prev_s = s
        x += _DX[s]
        y += _DY[s]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7


def find_contours(bitmap: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(bitmap, RETR_LIST, CHAIN_APPROX_SIMPLE)[0]``."""
    h, w = bitmap.shape
    H, W = h + 2, w + 2
    pad = np.zeros((H, W), np.int8)
    pad[1:-1, 1:-1] = np.asarray(bitmap) != 0
    img = pad.ravel().tolist()
    found = []
    for y in range(1, H - 1):
        base = y * W
        prev = 0
        x = 1
        while x < W - 1:
            p = img[base + x]
            if p != prev:
                is_hole = 0
                if not (prev == 0 and p == 1):
                    if p != 0 or prev < 1:
                        prev = p
                        x += 1
                        continue
                    is_hole = 1
                pts: List[int] = []
                _fetch(img, base + x - is_hole, W, x - is_hole - 1, y - 1,
                       bool(is_hole), pts)
                found.append(np.asarray(pts, np.int32).reshape(-1, 1, 2))
                prev = img[base + x]
            x += 1
    return found[::-1]


if __name__ == "__main__":
    from pdf_table_tpu_torch.ops import cv_host

    rng = np.random.default_rng(0)
    m = np.zeros((736, 960), np.uint8)
    for _ in range(300):
        x, y = rng.integers(0, 900), rng.integers(0, 720)
        m[y:y + rng.integers(5, 15), x:x + rng.integers(20, 60)] = 1
    t0 = time.perf_counter()
    want = cv_host.find_contours(m)
    t1 = time.perf_counter()
    got = find_contours(m)
    t2 = time.perf_counter()
    assert len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    print(f"{len(want)} contours: C++ {1e3 * (t1 - t0):.2f} ms, Python "
          f"{1e3 * (t2 - t1):.2f} ms")
