"""Image preprocessing ops on the tensor's device (counterpart of
pdf_table_tpu/ops/image.py).

Bilinear resizes with half-pixel centers and clamped edges, and the
per-channel normalize, as plain PyTorch: the JAX package computes them in
XLA, outside any Pallas kernel. :func:`batch_resize_pad_normalize` takes a
padded batch with a source size per image and keeps each image's aspect
ratio, padding the rest of the output with zeros; that is work the page
kernel (``ops/resize_norm.py``, one source size for the whole batch, no
pad) does not do. :func:`pack_images` is the host side: variable-size
uint8 images into one padded buffer.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as a fused multiply-add
    gives it and as XLA compiles the JAX function's jitted expression (the
    product of two f32 values is exact in f64)."""
    return (a.double() * b.double() + c).float()


def _bilinear_weights(out_size: int, in_size: torch.Tensor):
    """Sample indices and weights for resizing ``in_size`` to
    ``out_size`` (half-pixel centers, clamped to the source)."""
    f32 = torch.float32
    i = torch.arange(out_size, dtype=f32, device=in_size.device)
    scale = in_size.to(f32) / out_size
    src = (i + 0.5) * scale - 0.5
    src = torch.clamp(src, torch.zeros((), dtype=f32, device=src.device),
                      in_size.to(f32) - 1.0)
    i0 = torch.floor(src).long()
    i1 = torch.minimum(i0 + 1, in_size.long() - 1)
    w1 = src - i0.to(f32)
    return i0, i1, 1.0 - w1, w1


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int],
                    src_hw=None) -> torch.Tensor:
    """Bilinear-resize an (H, W, C) image to ``out_hw``; f32 out.

    ``src_hw`` (h, w) optionally limits the valid region of ``img`` (the
    rest is padding); the default is the whole array."""
    H, W = img.shape[0], img.shape[1]
    dev = img.device
    sh = torch.as_tensor(src_hw[0] if src_hw is not None else H,
                         dtype=torch.int32, device=dev)
    sw = torch.as_tensor(src_hw[1] if src_hw is not None else W,
                         dtype=torch.int32, device=dev)
    oh, ow = out_hw
    y0, y1, wy0, wy1 = _bilinear_weights(oh, sh)
    x0, x1, wx0, wx1 = _bilinear_weights(ow, sw)
    f = img.to(torch.float32)
    rows = f[y0] * wy0[:, None, None] + f[y1] * wy1[:, None, None]
    return rows[:, x0] * wx0[None, :, None] + rows[:, x1] * wx1[None, :, None]


def normalize_image(img: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float], scale: float = 1.0 / 255.0,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(img * scale - mean) / std``, channels last."""
    m = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return ((img.to(torch.float32) * scale - m) / s).to(dtype)


def batch_resize_pad_normalize(imgs: torch.Tensor, src_hws: torch.Tensor,
                               out_hw: Tuple[int, int],
                               mean=(0.485, 0.456, 0.406),
                               std=(0.229, 0.224, 0.225),
                               keep_ratio: bool = True,
                               dtype: torch.dtype = torch.float32):
    """Resize (keeping the aspect ratio) + pad + normalize a padded batch.

    imgs (B, Hmax, Wmax, C) uint8, each image in its top-left ``src_hws``
    (B, 2) corner. Returns ``(out, valid)``: out (B, out_h, out_w, C) with
    zeros beyond each image's resized content, valid (B, 2) int32 the
    content's size."""
    dev = imgs.device
    f32 = torch.float32
    oh, ow = out_hw
    hw = torch.as_tensor(src_hws, device=dev).to(torch.int32)
    sh, sw = hw[:, 0].to(f32), hw[:, 1].to(f32)
    if keep_ratio:
        r = torch.minimum(oh / sh, ow / sw)
        vh = torch.round(sh * r).to(torch.int32)
        vw = torch.round(sw * r).to(torch.int32)
    else:
        vh = torch.full_like(hw[:, 0], oh)
        vw = torch.full_like(hw[:, 1], ow)
    # a full (oh, ow) grid sampled from the source scaled to (vh, vw);
    # pixels beyond (vh, vw) are zeroed after the normalize
    i = torch.arange(oh, dtype=f32, device=dev) + 0.5
    j = torch.arange(ow, dtype=f32, device=dev) + 0.5
    if keep_ratio:
        ky, kx = sh / vh.to(f32), sw / vw.to(f32)
    else:
        # a constant divisor is a multiplication by its f32 reciprocal,
        # which is what XLA makes of it
        ky = sh * torch.tensor(1.0 / oh, dtype=f32)
        kx = sw * torch.tensor(1.0 / ow, dtype=f32)
    sy = _fma(i[None, :], ky[:, None], -0.5)
    sx = _fma(j[None, :], kx[:, None], -0.5)
    sy = torch.minimum(sy.clamp_min(0.0), (sh - 1.0)[:, None])
    sx = torch.minimum(sx.clamp_min(0.0), (sw - 1.0)[:, None])
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy = (sy - y0)[:, :, None, None]
    wx = (sx - x0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()
    y1 = torch.minimum(y0 + 1, hw[:, :1].long() - 1)
    x1 = torch.minimum(x0 + 1, hw[:, 1:].long() - 1)
    b = torch.arange(imgs.shape[0], device=dev)[:, None, None]
    f = imgs.to(f32)

    def at(yy, xx):
        return f[b, yy[:, :, None], xx[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    out = normalize_image(top * (1 - wy) + bot * wy, mean, std)
    mask = (torch.arange(oh, device=dev)[None, :, None] < vh[:, None, None]) \
        & (torch.arange(ow, device=dev)[None, None, :] < vw[:, None, None])
    out = torch.where(mask[..., None], out, torch.zeros((), device=dev))
    return out.to(dtype), torch.stack([vh, vw], dim=1)


def resize_pad_normalize(img: torch.Tensor, src_hw, out_hw: Tuple[int, int],
                         mean=(0.485, 0.456, 0.406),
                         std=(0.229, 0.224, 0.225),
                         keep_ratio: bool = True,
                         dtype: torch.dtype = torch.float32):
    """:func:`batch_resize_pad_normalize` of one (H, W, C) image whose
    content is its top-left ``src_hw``. Returns ``(out, valid_hw)``."""
    hw = torch.as_tensor(src_hw, device=img.device).reshape(1, 2)
    out, valid = batch_resize_pad_normalize(img[None], hw, out_hw, mean, std,
                                            keep_ratio, dtype)
    return out[0], valid[0]


def pack_images(images, max_hw=None, pad_multiple: int = 32):
    """Host side: variable-size uint8 HWC numpy images packed into one
    zero-padded (N, H, W, C) buffer (H and W multiples of
    ``pad_multiple``) and their (N, 2) int32 sizes."""
    n = len(images)
    hs = [im.shape[0] for im in images]
    ws = [im.shape[1] for im in images]
    if max_hw is None:
        mh, mw = max(hs), max(ws)
    else:
        mh, mw = max_hw
    mh = ((mh + pad_multiple - 1) // pad_multiple) * pad_multiple
    mw = ((mw + pad_multiple - 1) // pad_multiple) * pad_multiple
    c = images[0].shape[2] if images[0].ndim == 3 else 1
    buf = np.zeros((n, mh, mw, c), dtype=np.uint8)
    hw = np.zeros((n, 2), dtype=np.int32)
    for k, im in enumerate(images):
        if im.ndim == 2:
            im = im[:, :, None]
        h = min(im.shape[0], mh)
        w = min(im.shape[1], mw)
        buf[k, :h, :w] = im[:h, :w]
        hw[k] = (h, w)
    return buf, hw
