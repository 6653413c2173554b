"""RoIAlign as bilinear sampling at one centre point per bin
(counterpart of pdf_table_tpu/ops/roi_align.py, which is XLA gathers and
blends, no Pallas kernel): ``out_size`` x ``out_size`` bins over each box,
each bin the bilinear sample at its centre, corner indices clamped to the
map. Not mmcv's average of four samples per bin: the JAX function is the
reference."""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (through f64), as the fused
    multiply-add that XLA emits for it."""
    return (a.double() * b.double() + c.double()).float()


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              out_size: int = 7) -> torch.Tensor:
    """feat (H, W, C); boxes (N, 4) xyxy in feature coordinates ->
    (N, S, S, C) in ``feat``'s dtype. The sample weights are f32 and a bf16
    map's corners blend with them in f32, as JAX's promotion does; the
    sum is rounded to the map's dtype once (JAX rounds it where the next
    bf16 layer takes it in). Bin centres are ``x1 + (i + 0.5) * (1 / S) * w`` with a
    fused multiply-add and the reciprocal of the constant ``S``, as XLA
    compiles the JAX expression (an unfused f32 sum moves samples by an
    ulp, 1e-5 of the output)."""
    H, W, C = feat.shape
    N = boxes.shape[0]
    S = out_size
    f32 = torch.float32
    x1, y1, x2, y2 = boxes.to(f32).unbind(1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    g = (torch.arange(S, dtype=f32, device=feat.device) + 0.5) * (1.0 / S)
    sx = fma(g[None, :], bw[:, None], x1[:, None])            # (N, S)
    sy = fma(g[None, :], bh[:, None], y1[:, None])
    yy = sy[:, :, None].expand(N, S, S) - 0.5
    xx = sx[:, None, :].expand(N, S, S) - 0.5
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = (yy - y0)[..., None]
    wx = (xx - x0)[..., None]
    flat = feat.reshape(H * W, C)

    def gather(yi, xi):
        yi = yi.long().clamp(0, H - 1)
        xi = xi.long().clamp(0, W - 1)
        return flat[(yi * W + xi).reshape(-1)].reshape(N, S, S, C)

    return (gather(y0, x0) * ((1 - wy) * (1 - wx))
            + gather(y0, x0 + 1) * ((1 - wy) * wx)
            + gather(y0 + 1, x0) * (wy * (1 - wx))
            + gather(y0 + 1, x0 + 1) * (wy * wx)).to(feat.dtype)
