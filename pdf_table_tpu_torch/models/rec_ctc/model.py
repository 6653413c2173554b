"""PP-OCRv4 CTC recognizer (counterpart of
pdf_table_tpu/models/rec_ctc/model.py, the ``svtr_lcnet`` backbone).

MobileNetV1Enhance conv stages (strides (2,1) collapse the height and keep
the width) -> 2x2 average pool -> EncoderWithSVTR (two global-mixer
transformer blocks over the H x W tokens) -> mean over H -> linear CTC
head. Logits (B, T, V), one time step per 8 px of input width.

The public input is NHWC like the JAX model's; modules run NCHW. Submodule
names are the flax module names, so the weight bridge maps paths one to
one. The ``crnn``, ``convnext_vit`` and ``lightweight_edge`` backbones are
not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import ConvBNAct, DepthwiseSeparable
from .config import RecConfig

# MobileNetV1Enhance block list: (filters1, filters2, stride_hw, dw_k, se).
# Channels scale by int(c * scale).
MV1_ENHANCE_CFG = [
    (32, 64, (1, 1), 3, False),
    (64, 128, (1, 1), 3, False),
    (128, 128, (1, 1), 3, False),
    (128, 256, (2, 1), 3, False),
    (256, 256, (1, 1), 3, False),
    (256, 512, (2, 1), 3, False),
    (512, 512, (1, 1), 3, False),
    (512, 512, (1, 1), 3, False),
    (512, 512, (1, 1), 3, False),
    (512, 512, (1, 1), 3, False),
    (512, 512, (1, 1), 3, False),
    (512, 1024, (2, 1), 5, False),
    (1024, 1024, (1, 2), 5, True),
]


class SVTRBlock(nn.Module):
    """SVTR global-mixer block on (B, T, D) tokens: pre-LN attention (one
    biased ``qkv`` projection, split ``[q | k | v]`` on the last axis and
    then into heads; softmax in f32) + pre-LN 2x MLP with silu; LN eps
    1e-5."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, 2 * dim)
        self.fc2 = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        dh = D // self.heads
        q, k, v = (t.reshape(B, T, self.heads, dh)
                   for t in self.qkv(self.norm1(x)).split(D, dim=-1))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        att = torch.softmax(att.float(), dim=-1).to(att.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, D)
        x = x + self.proj(ctx)
        y = torch.nn.functional.silu(self.fc1(self.norm2(x)))
        return x + self.fc2(y)


class SVTRLCNetBackbone(nn.Module):
    """MobileNetV1Enhance then EncoderWithSVTR (conv1 3x3 -> conv2 1x1 ->
    ``depth`` SVTR blocks -> LN eps 1e-6 -> conv3 1x1, concat with the
    shortcut, conv4 3x3 -> conv1x1 to ``dims``; the encoder's convs are
    bn + swish). NCHW in, (B, W', dims) out."""

    def __init__(self, scale: float = 0.5, dims: int = 64, hidden: int = 120,
                 depth: int = 2, heads: int = 8, in_ch: int = 3):
        super().__init__()
        c = int(32 * scale)
        self.conv1 = ConvBNAct(in_ch, c, (3, 3), (2, 2), act="hardswish")
        for i, (_, f2, st, k, se) in enumerate(MV1_ENHANCE_CFG):
            f = int(f2 * scale)
            setattr(self, f"block{i}", DepthwiseSeparable(
                c, f, (k, k), st, use_se=se, act="hardswish"))
            c = f
        self.pool = nn.AvgPool2d(2, 2)
        self.svtr_conv1 = ConvBNAct(c, c // 8, (3, 3), act="swish")
        self.svtr_conv2 = ConvBNAct(c // 8, hidden, (1, 1), act="swish")
        self.depth = depth
        for i in range(depth):
            setattr(self, f"svtr_block{i}", SVTRBlock(hidden, heads))
        self.svtr_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.svtr_conv3 = ConvBNAct(hidden, c, (1, 1), act="swish")
        self.svtr_conv4 = ConvBNAct(2 * c, c // 8, (3, 3), act="swish")
        self.svtr_conv1x1 = ConvBNAct(c // 8, dims, (1, 1), act="swish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        for i in range(len(MV1_ENHANCE_CFG)):
            x = getattr(self, f"block{i}")(x)
        h = self.pool(x)
        z = self.svtr_conv2(self.svtr_conv1(h))
        B, C, H, W = z.shape
        # tokens in (H, W) row-major order with channels last, as the NHWC
        # model's reshape(B, H * W, C) gives them
        z = z.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for i in range(self.depth):
            z = getattr(self, f"svtr_block{i}")(z)
        z = self.svtr_norm(z).reshape(B, H, W, C).permute(0, 3, 1, 2)
        z = self.svtr_conv3(z)
        z = self.svtr_conv4(torch.cat([h, z], dim=1))
        z = self.svtr_conv1x1(z)
        # H is 1 at the 48 px geometry; the mean keeps other heights usable
        return z.mean(dim=2).transpose(1, 2)


class CTCRecModel(nn.Module):
    """``forward`` takes NHWC images (B, H, W, C) already normalized and
    returns f32 logits (B, T, V)."""

    def __init__(self, config: RecConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.backbone != "svtr_lcnet":
            raise NotImplementedError(
                f"rec backbone {cfg.backbone!r} is not ported yet")
        self.backbone = SVTRLCNetBackbone(
            scale=cfg.svtr_scale, dims=cfg.svtr_dims, hidden=cfg.svtr_hidden,
            depth=cfg.svtr_depth, heads=cfg.svtr_heads,
            in_ch=cfg.img_channels)
        self.ctc_head = nn.Linear(cfg.svtr_dims, cfg.vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x.permute(0, 3, 1, 2))
        return self.ctc_head(feat).float()
