"""LGPMA: the mmdet-structure two-stage cell detector with pyramid mask
heads (counterpart of pdf_table_tpu/models/lgpma/model.py, which is XLA
throughout: no Pallas kernel stands behind it).

ResNet -> FPN (5 levels, P6 a stride-2 subsample of P5) -> a shared RPN
head -> static per-level top-k proposals and a dense fast NMS -> the
top ``num_proposals`` -> RoIAlign at 7 (level by the finest-scale rule,
as masks over four RoIAligns) -> Shared2FCBBoxHead; the ``mask_top``
best refined boxes -> RoIAlign at 14 -> LPMAMaskHead; GPMAMaskHead on P2.
One image a forward, as the JAX program. Every top-k is a stable
descending sort (ties to the lower index, as ``jax.lax.top_k``).
Modules run NCHW; the RoI tensors are NHWC as in JAX. Every module computes
in ``config.dtype`` (layers.py::cast_model); the heads cast their logits
and deltas to f32 where the JAX heads do, and the boxes, anchors and
top-k are f32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ...ops.roi_align import fma, roi_align
from ...engine.device import compute_dtype
from ..layers import ResNet, cast_model
from ..lore.detector import conv_transpose_same
from .config import LgpmaConfig


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of a 1-D tensor, ties to the lower index."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


class FPN(nn.Module):
    """mmdet FPN: lateral 1x1 + output 3x3 per level, P6 = the stride-2
    subsample of P5 (flax's 1x1 max pool)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"fpn{i}",
                    nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats):
        lats = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            h, w = lats[i - 1].shape[2:]
            up = lats[i].repeat_interleave(2, 2).repeat_interleave(2, 3)
            lats[i - 1] = lats[i - 1] + up[:, :, :h, :w]
        outs = [getattr(self, f"fpn{i}")(x) for i, x in enumerate(lats)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class RPNHead(nn.Module):
    """Shared 3x3 conv (256) -> objectness logits and 4 deltas per anchor,
    NHWC f32."""

    def __init__(self, in_ch: int, num_anchors: int):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_ch, 256, 3, padding=1)
        self.rpn_cls = nn.Conv2d(256, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(256, num_anchors * 4, 1)

    def forward(self, x):
        h = torch.relu(self.rpn_conv(x))
        return (self.rpn_cls(h).float().permute(0, 2, 3, 1),
                self.rpn_reg(h).float().permute(0, 2, 3, 1))


class Shared2FCBBoxHead(nn.Module):
    """2 shared fc -> softmax over (num_classes + 1) and per-class deltas;
    the RoIs flatten in NCHW order, as torch's mmdet does."""

    def __init__(self, in_features: int, num_classes: int = 2,
                 fc_dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(in_features, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.fc_cls = nn.Linear(fc_dim, num_classes + 1)
        self.fc_reg = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, rois):                    # (N, S, S, C)
        n = rois.shape[0]
        x = rois.permute(0, 3, 1, 2).reshape(n, -1)
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        logits = self.fc_cls(x).float()
        deltas = self.fc_reg(x).float()
        return (torch.softmax(logits, -1),
                deltas.reshape(n, self.num_classes, 4))


class LPMAMaskHead(nn.Module):
    """FCN mask head: 4 convs (256) + a 2x2/2 transposed conv, then
    num_classes text masks + the horizontal and vertical pyramid ramps,
    sigmoid, NHWC."""

    def __init__(self, in_ch: int, num_classes: int = 2):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i}",
                    nn.Conv2d(in_ch if i == 0 else 256, 256, 3, padding=1))
        self.upsample = conv_transpose_same(256, 256, 2, 2)
        self.conv_logits = nn.Conv2d(256, num_classes + 2, 1)

    def forward(self, rois):
        x = rois.permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        x = torch.relu(self.upsample(x))
        return torch.sigmoid(self.conv_logits(x).float()).permute(0, 2, 3, 1)


class GPMAMaskHead(nn.Module):
    """Global branch on P2: 3x3 + two 1x7 context convs summed, 3x3, then
    a 1-channel segmentation and a 2-channel global pyramid, sigmoid,
    NHWC."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.P4_conv = nn.Conv2d(in_ch, 256, 3, padding=1)
        self.channel4_1x7_conv = nn.Conv2d(in_ch, 256, (1, 7),
                                           padding=(0, 3))
        self.P4_1x7_conv = nn.Conv2d(256, 256, (1, 7), padding=(0, 3))
        self.rpn4 = nn.Conv2d(256, 256, 3, padding=1)
        self.conv_logits_seg = nn.Conv2d(256, 1, 1)
        self.conv_logits_reg = nn.Conv2d(256, 2, 1)

    def forward(self, p2):
        x_p4 = torch.relu(self.P4_conv(p2))
        x_1x7 = torch.relu(self.channel4_1x7_conv(p2))
        x = torch.relu(self.P4_1x7_conv(x_p4)) + x_p4 + x_1x7
        x = torch.relu(self.rpn4(x))

        def head(conv):
            return torch.sigmoid(conv(x).float()).permute(0, 2, 3, 1)

        return head(self.conv_logits_seg), head(self.conv_logits_reg)


def mmdet_anchors(H: int, W: int, stride: int, scales: Sequence[float],
                  ratios: Sequence[float], device=None) -> torch.Tensor:
    """mmdet AnchorGenerator, centre offset 0: per ratio r and scale s the
    anchor (w, h) = stride * s * (1 / sqrt(r), sqrt(r)), ratio-major,
    centred at (x, y) * stride; (H * W * A, 4) in (y, x, anchor) order."""
    f32 = torch.float32
    scales = torch.tensor(scales, dtype=f32, device=device)
    ratios = torch.tensor(ratios, dtype=f32, device=device)
    h_r = torch.sqrt(ratios)
    w_r = 1.0 / h_r
    ws = (w_r[:, None] * scales[None, :]).reshape(-1) * stride
    hs = (h_r[:, None] * scales[None, :]).reshape(-1) * stride
    base = torch.stack([-ws / 2, -hs / 2, ws / 2, hs / 2], dim=1)
    sy = torch.arange(H, dtype=f32, device=device) * stride
    sx = torch.arange(W, dtype=f32, device=device) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([gx, gy, gx, gy], dim=-1)
    return (shift[:, :, None, :] + base[None, None]).reshape(-1, 4)


def decode_deltas(boxes: torch.Tensor, deltas: torch.Tensor,
                  stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                  ) -> torch.Tensor:
    """mmdet DeltaXYWHBBoxCoder.decode (means 0); the centre shifts are
    fused multiply-adds, as XLA compiles them."""
    d = deltas * torch.tensor(stds, dtype=torch.float32,
                              device=deltas.device)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    ncx = fma(d[:, 0], w, cx)
    ncy = fma(d[:, 1], h, cy)
    nw = w * torch.exp(torch.clamp(d[:, 2], -4.0, 4.0))
    nh = h * torch.exp(torch.clamp(d[:, 3], -4.0, 4.0))
    return torch.stack([ncx - nw / 2, ncy - nh / 2,
                        ncx + nw / 2, ncy + nh / 2], dim=1)


def clip_boxes(b: torch.Tensor, img_w: float, img_h: float) -> torch.Tensor:
    return torch.stack([b[:, 0].clamp(0, img_w), b[:, 1].clamp(0, img_h),
                        b[:, 2].clamp(0, img_w), b[:, 3].clamp(0, img_h)],
                       dim=1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])).clamp_min(0.0)
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).clamp_min(0.0)
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(
        1e-6)


def fast_nms_keep(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thresh: float) -> torch.Tensor:
    """Suppress any box overlapped above ``iou_thresh`` by a higher-scored
    one (equal scores: the lower index is higher)."""
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(scores.shape[0], device=scores.device)
    higher = (scores[None, :] > scores[:, None]) | (
        (scores[None, :] == scores[:, None]) & (idx[None, :] < idx[:, None]))
    return ~torch.any((iou > iou_thresh) & higher, dim=1)


class LGPMA(nn.Module):
    def __init__(self, config: LgpmaConfig):
        super().__init__()
        cfg = self.config = config
        c = cfg.fpn_channels
        self.backbone = ResNet(cfg.backbone_depth)
        self.neck = FPN(self.backbone.out_channels, c)
        n_anchors = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
        self.rpn_head = RPNHead(c, n_anchors)
        self.bbox_head = Shared2FCBBoxHead(c * cfg.roi_size ** 2,
                                           cfg.num_classes, cfg.fc_dim)
        self.mask_head = LPMAMaskHead(c, cfg.num_classes)
        self.global_seg_head = GPMAMaskHead(c)
        self.dtype = compute_dtype(cfg.dtype)
        cast_model(self, self.dtype)

    def levels(self, x: torch.Tensor):
        """x (1, H, W, 3) normalized -> the 5 FPN levels, NCHW."""
        x = x.permute(0, 3, 1, 2).to(
            dtype=self.dtype, memory_format=torch.channels_last)
        return self.neck(self.backbone(x))

    def rpn(self, levels, img_hw: Tuple[float, float]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``num_proposals`` best proposals (P, 4) and their
        objectness (-1 where the fast NMS dropped them)."""
        cfg = self.config
        img_h, img_w = img_hw
        boxes, scores = [], []
        for lvl, stride in enumerate(cfg.anchor_strides):
            cls, reg = self.rpn_head(levels[lvl])
            B, H, W, _ = cls.shape
            if B != 1:
                raise ValueError("LGPMA runs one image a forward")
            anchors = mmdet_anchors(H, W, stride, cfg.anchor_scales,
                                    cfg.anchor_ratios, cls.device)
            obj = torch.sigmoid(cls.reshape(-1))
            deltas = reg.reshape(-1, 4)
            top_s, top_i = top_k(obj, min(cfg.rpn_pre_topk, obj.shape[0]))
            boxes.append(clip_boxes(decode_deltas(anchors[top_i],
                                                  deltas[top_i]),
                                    img_w, img_h))
            scores.append(top_s)
        boxes = torch.cat(boxes, 0)
        scores = torch.cat(scores, 0)
        keep = fast_nms_keep(boxes, scores, cfg.rpn_nms_thresh)
        scores = torch.where(keep, scores, torch.full_like(scores, -1.0))
        top_s, top_i = top_k(scores, cfg.num_proposals)
        return boxes[top_i], top_s

    def extract(self, levels, rois: torch.Tensor, out_size: int
                ) -> torch.Tensor:
        """RoI features at ``out_size`` from the level of the finest-scale
        rule (SingleRoIExtractor), NHWC."""
        cfg = self.config
        w = torch.clamp(rois[:, 2] - rois[:, 0], min=1e-3)
        h = torch.clamp(rois[:, 3] - rois[:, 1], min=1e-3)
        lvl = torch.floor(torch.log2(torch.sqrt(w * h) / cfg.finest_scale
                                     + 1e-6)).clamp(0, 3).long()
        out = 0.0
        for li, stride in enumerate(cfg.anchor_strides[:4]):
            r = roi_align(levels[li][0].permute(1, 2, 0), rois / stride,
                          out_size)
            out = out + torch.where((lvl == li)[:, None, None, None], r,
                                    torch.zeros_like(r))
        return out

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (1, H, W, 3) normalized NHWC -> the JAX program's outputs
        (batch dim 1 on each)."""
        cfg = self.config
        img_h, img_w = float(x.shape[1]), float(x.shape[2])
        levels = self.levels(x)
        props, _ = self.rpn(levels, (img_h, img_w))
        cls_probs, bdeltas = self.bbox_head(
            self.extract(levels, props, cfg.roi_size))
        det_boxes = torch.stack(
            [clip_boxes(decode_deltas(props, bdeltas[:, c], cfg.bbox_stds),
                        img_w, img_h) for c in range(cfg.num_classes)], 1)
        fg = cls_probs[:, :cfg.num_classes]
        best_score, best_cls = torch.max(fg, dim=1)
        m_s, m_i = top_k(best_score, min(cfg.mask_top, cfg.num_proposals))
        m_boxes = torch.gather(det_boxes, 1, best_cls[:, None, None]
                               .expand(-1, 1, 4))[:, 0][m_i]
        lpma = self.mask_head(self.extract(levels, m_boxes,
                                           cfg.mask_roi_size))
        seg, reg = self.global_seg_head(levels[0])
        return {"proposals": props[None], "cls_probs": cls_probs[None],
                "det_boxes": det_boxes[None], "mask_boxes": m_boxes[None],
                "mask_scores": m_s[None], "mask_cls": best_cls[m_i][None],
                "mask_idx": m_i[None], "lpma_masks": lpma[None],
                "gpma_seg": seg, "gpma_reg": reg}
