"""Axis-aligned crop resampling on the device (counterpart of
pdf_table_tpu/ops/warp.py::resample_axis_aligned_crops, without
``also_flipped``): the vertical bilinear resample as two row gathers, the
horizontal one as a batched matmul with hat-function weights. f32."""

from __future__ import annotations

from typing import Tuple

import torch


def resample_axis_aligned_crops(pages: torch.Tensor, page_idx: torch.Tensor,
                                boxes: torch.Tensor,
                                out_hw: Tuple[int, int],
                                valid_w: torch.Tensor,
                                valid_h: torch.Tensor) -> torch.Tensor:
    """pages (P, H, W, C); page_idx (N,); boxes (N, 4) [x1, y1, x2, y2] in
    page coords; out_hw (oh, ow). ``valid_w``/``valid_h`` (N,) zero the
    output right/bottom of the content. Returns (N, oh, ow, C) float32."""
    P, H, W, C = pages.shape
    oh, ow = out_hw
    n = boxes.shape[0]
    dev = pages.device
    f32 = torch.float32
    x1, y1, x2, y2 = boxes.to(f32).unbind(1)

    r = torch.arange(oh, dtype=f32, device=dev) + 0.5
    sy = y1[:, None] + r[None, :] * ((y2 - y1) / oh)[:, None] - 0.5
    y0 = torch.floor(sy).long()
    wy = sy - y0
    in_y0 = (y0 >= 0) & (y0 < H)
    in_y1 = (y0 + 1 >= 0) & (y0 + 1 < H)
    rows_tbl = pages.reshape(P * H, W * C).to(f32)
    base = (page_idx.long() * H)[:, None]
    g0 = rows_tbl[base + y0.clamp(0, H - 1)]                 # (N, oh, W*C)
    g1 = rows_tbl[base + (y0 + 1).clamp(0, H - 1)]
    w0 = ((1.0 - wy) * in_y0)[..., None]
    w1 = (wy * in_y1)[..., None]
    rows = (g0 * w0 + g1 * w1).reshape(n, oh, W, C)

    j = torch.arange(ow, dtype=f32, device=dev) + 0.5
    sx = x1[:, None] + j[None, :] * ((x2 - x1) / ow)[:, None] - 0.5
    s = torch.arange(W, dtype=f32, device=dev)
    wx = torch.clamp(1.0 - torch.abs(sx[:, None, :] - s[None, :, None]),
                     min=0.0)                                # (N, W, ow)
    out = torch.einsum("nrwc,nwj->nrjc", rows, wx)           # (N, oh, ow, C)

    mask = (torch.arange(ow, device=dev)[None, :]
            < valid_w[:, None])[:, None, :, None] \
        & (torch.arange(oh, device=dev)[None, :]
           < valid_h[:, None])[:, :, None, None]
    vy = ((sy >= -1) & (sy <= H))[:, :, None, None]
    vx = ((sx >= -1) & (sx <= W))[:, None, :, None]
    return torch.where(mask & vy & vx, out, torch.zeros_like(out))
