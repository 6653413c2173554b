"""Image pre-process task: small-angle deskew and the page-orientation fix
(counterpart of pdf_table_tpu/tasks/preprocess.py), without cv2.

``estimate_skew_angle`` is the min-area rectangle of the dark pixels
(OpenCV 5.0.0's ``RGB2GRAY``, Otsu threshold, ``findNonZero`` and
``minAreaRect``, ops/cv_host.py); ``rotate_image`` turns the page about its
centre onto a canvas that holds it, white outside (OpenCV's
``getRotationMatrix2D`` and uint8 ``warpAffine``); the PULC
``text_image_orientation`` classifier turns it by quarter turns.
``estimate_skew_angle_fft`` is the FFT-magnitude radial projection, one
torch program on the task's device.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..ops import cv_host


def estimate_skew_angle(image: np.ndarray, max_angle: float = 15.0) -> float:
    """Small-angle skew from the min-area rectangle of the dark pixels:
    its angle folded into (-45, 45], 0 beyond ``max_angle`` or with fewer
    than 32 dark pixels."""
    gray = cv_host.rgb_to_grey(image) if image.ndim == 3 else image
    _, thr = cv_host.threshold_otsu_inv(gray)
    coords = cv_host.find_nonzero(thr)
    if len(coords) < 32:
        return 0.0
    angle = cv_host.min_area_rect(coords)[-1]
    if angle > 45:
        angle -= 90
    elif angle < -45:
        angle += 90
    if abs(angle) > max_angle:
        return 0.0
    return float(angle)


def _resize_aa(g: torch.Tensor, out_hw) -> torch.Tensor:
    """``jax.image.resize(g, out_hw, "bilinear")`` of a 2-D map: the
    separable antialiased triangle weights as two matmuls."""
    from .layout import resize_weights

    wy = torch.from_numpy(resize_weights(g.shape[0], out_hw[0])).to(g.device)
    wx = torch.from_numpy(resize_weights(g.shape[1], out_hw[1])).to(g.device)
    return wy.T @ g @ wx


def estimate_skew_angle_fft(image: np.ndarray, max_angle: float = 15.0,
                            num: int = 20, size: int = 512,
                            device=None) -> float:
    """Skew from the FFT magnitude's strongest radial ray within
    ``max_angle`` (text lines make a ridge through the spectrum's origin
    across their direction): the grey page scaled to at most ``size``,
    padded square with white, the inverted page thresholded against its
    15-tap gaussian mean (+10), ``fft2``, and the magnitude summed along
    ``max_angle * num * 2`` rays; 0 where the first ray wins. One torch
    program on ``device`` (``cuda`` unless ``"cpu"``)."""
    from ..engine.device import resolve_device

    dev = resolve_device(device)
    gray = image.mean(axis=-1) if image.ndim == 3 else image
    h, w = gray.shape
    s = min(1.0, size / max(h, w))
    with torch.inference_mode():
        g = torch.as_tensor(np.asarray(gray, np.float32), device=dev)
        if s < 1.0:
            nh, nw = int(round(h * s)), int(round(w * s))
            g = _resize_aa(g, (nh, nw))
        else:
            nh, nw = h, w
        n = max(nh, nw)
        g = torch.nn.functional.pad(g, (0, n - nw, 0, n - nh), value=255.0)
        inv = 255.0 - g
        k = torch.exp(-0.5 * (torch.arange(-7, 8, device=dev,
                                           dtype=torch.float32) / 3.0) ** 2)
        k = k / k.sum()
        m = torch.nn.functional.conv2d(inv[None, None], k.view(1, 1, 1, 15),
                                       padding=(0, 7))
        m = torch.nn.functional.conv2d(m, k.view(1, 1, 15, 1),
                                       padding=(7, 0))[0, 0]
        binar = (inv > m + 10.0).float() * 255.0
        mag = torch.fft.fftshift(torch.fft.fft2(binar)).abs()
        c = n // 2
        t = torch.linspace(-max_angle, max_angle, int(max_angle * num * 2),
                           device=dev) * math.pi / 180.0
        x = torch.arange(c, device=dev, dtype=torch.float32)
        yy = (c + x[None, :] * torch.cos(t)[:, None]).int().clamp(0, n - 1)
        xx = (c - x[None, :] * torch.sin(t)[:, None]).int().clamp(0, n - 1)
        prof = mag[yy.long(), xx.long()].sum(dim=1)
        a = float(t[int(torch.argmax(prof))]) * 180.0 / math.pi
    return 0.0 if math.isclose(a, -max_angle, rel_tol=1e-5,
                               abs_tol=1e-8) else a


def rotate_image(image: np.ndarray, angle: float,
                 border_value: int = 255) -> np.ndarray:
    """The uint8 image turned by ``angle`` degrees about its centre onto a
    canvas that holds it, ``border_value`` outside."""
    if abs(angle) < 1e-3:
        return image
    h, w = image.shape[:2]
    m = cv_host.rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    m[0, 2] += nw / 2 - w / 2
    m[1, 2] += nh / 2 - h / 2
    return cv_host.warp_affine_u8(image, m, (nw, nh), border=border_value)


def rotate_90s(image: np.ndarray, quarter_turns: int) -> np.ndarray:
    return np.ascontiguousarray(np.rot90(image, k=quarter_turns % 4))


class OcrTablePreprocessTask:
    """(image, is_pdf) -> {"image", "rotate_angle", "quarter_turns"}. A
    rasterized digital page is trusted as it is; an image is deskewed, then
    turned by the page-orientation classifier where it is confident (a
    :class:`ClsImagePulcTask` ``text_image_orientation`` on ``device``,
    built on first use unless ``orientation_task`` is given)."""

    def __init__(self, use_orientation_cls: bool = True,
                 orientation_task=None, device=None):
        from ..engine.device import resolve_device

        self.use_orientation_cls = use_orientation_cls
        self.device = resolve_device(device)
        self._orientation = orientation_task

    @property
    def orientation_task(self):
        if self._orientation is None and self.use_orientation_cls:
            from .cls_pulc import ClsImagePulcTask
            self._orientation = ClsImagePulcTask(
                task_type="text_image_orientation", device=self.device)
        return self._orientation

    def __call__(self, image: np.ndarray,
                 is_pdf: bool = False) -> Dict[str, Any]:
        info: Dict[str, Any] = {"rotate_angle": 0.0, "quarter_turns": 0}
        if is_pdf:
            return {"image": image, **info}
        angle = estimate_skew_angle(image)
        if abs(angle) > 0.3:
            image = rotate_image(image, angle)
            info["rotate_angle"] = angle
        task = self.orientation_task
        if task is not None:
            result = task(image)
            label = result.get("label", "0")
            turns = {"0": 0, "90": 1, "180": 2, "270": 3}.get(label, 0)
            if turns and result.get("score", 0.0) >= 0.75:
                image = rotate_90s(image, turns)
                info["quarter_turns"] = turns
        return {"image": image, **info}
