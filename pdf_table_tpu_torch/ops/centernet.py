"""CenterNet decode primitives on static shapes (counterpart of
pdf_table_tpu/ops/centernet.py). Layout is NHWC, as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def heatmap_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep local maxima only: heat (B, H, W, C) -> same shape."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad) \
        .permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def topk_scores(heat: torch.Tensor, k: int):
    """heat (B, H, W, C) -> (scores, inds, clses, ys, xs), each (B, k).
    ``inds`` index the flattened H*W plane. Ties keep the lower index first
    (a stable sort), as ``jax.lax.top_k`` does."""
    b, h, w, c = heat.shape
    flat = heat.permute(0, 3, 1, 2).reshape(b, c * h * w)
    n = flat.shape[1]
    scores, inds_all = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, inds_all = scores[:, :k], inds_all[:, :k]
    if k > n:
        # tiny feature maps: take all cells, pad with -inf so score
        # thresholds drop the padding
        scores = F.pad(scores, (0, k - n), value=float("-inf"))
        inds_all = F.pad(inds_all, (0, k - n))
    clses = inds_all // (h * w)
    inds = inds_all % (h * w)
    ys = (inds // w).float()
    xs = (inds % w).float()
    return scores, inds, clses, ys, xs


def gather_feat(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """feat (B, H*W, D), inds (B, K) -> (B, K, D)."""
    return torch.gather(feat, 1,
                        inds[:, :, None].expand(-1, -1, feat.shape[-1]))


def decode_boxes_4ps(heat: torch.Tensor, wh: torch.Tensor,
                     reg: torch.Tensor, k: int):
    """4-point box decode. heat (B, H, W, C) post-sigmoid; wh (B, H, W, 8)
    center->corner offsets; reg (B, H, W, 2). Returns (bboxes (B, K, 8),
    scores (B, K), clses (B, K), centers (B, K, 2), inds (B, K)) in
    feature-map coordinates."""
    b, h, w, _ = heat.shape
    heat = heatmap_nms(heat)
    scores, inds, clses, ys, xs = topk_scores(heat, k)
    r = gather_feat(reg.reshape(b, h * w, 2), inds)
    cx = xs + r[:, :, 0]
    cy = ys + r[:, :, 1]
    o = gather_feat(wh.reshape(b, h * w, 8), inds)
    xs4 = cx[:, :, None] - o[:, :, 0::2]
    ys4 = cy[:, :, None] - o[:, :, 1::2]
    bboxes = torch.stack([xs4[..., 0], ys4[..., 0], xs4[..., 1], ys4[..., 1],
                          xs4[..., 2], ys4[..., 2], xs4[..., 3], ys4[..., 3]],
                         dim=-1)
    centers = torch.stack([cx, cy], dim=-1)
    return bboxes, scores, clses, centers, inds


def decode_centernet_bbox(heat: torch.Tensor, wh: torch.Tensor,
                          reg: torch.Tensor, k: int):
    """Axis-aligned CenterNet decode: heat (B, H, W, C) post-sigmoid, wh
    (B, H, W, 2) box sizes, reg (B, H, W, 2). Returns (bboxes (B, K, 4)
    xyxy, scores, clses, inds) in feature-map coordinates."""
    b, h, w, _ = heat.shape
    heat = heatmap_nms(heat)
    scores, inds, clses, ys, xs = topk_scores(heat, k)
    r = gather_feat(reg.reshape(b, h * w, 2), inds)
    cx = xs + r[:, :, 0]
    cy = ys + r[:, :, 1]
    sz = gather_feat(wh.reshape(b, h * w, 2), inds)
    bboxes = torch.stack([cx - sz[:, :, 0] / 2, cy - sz[:, :, 1] / 2,
                          cx + sz[:, :, 0] / 2, cy + sz[:, :, 1] / 2], dim=-1)
    return bboxes, scores, clses, inds
