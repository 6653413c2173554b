"""LORE logical-location regressor: transformer + stacking regressor
(counterpart of pdf_table_tpu/models/lore/processor_model.py).

Pre-norm encoder layers with the reference's std-based Norm (unbiased std,
eps added to the std), q/k/v/out linear attention written as explicit
matmul + softmax, ReLU FeedForward, 2-layer ReLU decoder, Stacker, and x/y
position embeddings over the truncated det corners.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .config import LoreConfig


class RefNorm(nn.Module):
    """alpha * (x - mean) / (std + eps) + bias with the UNBIASED std."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.alpha = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).sum(-1, keepdim=True) / (self.dim - 1)
        return self.alpha * (x - mu) / (torch.sqrt(var) + self.eps) \
            + self.bias


class RefMHA(nn.Module):
    def __init__(self, heads: int, d_model: int):
        super().__init__()
        self.heads = heads
        self.q_linear = nn.Linear(d_model, d_model)
        self.k_linear = nn.Linear(d_model, d_model)
        self.v_linear = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B, L, D = x.shape
        H = self.heads
        Dk = D // H
        q = self.q_linear(x).reshape(B, L, H, Dk).transpose(1, 2)
        k = self.k_linear(x).reshape(B, L, H, Dk).transpose(1, 2)
        v = self.v_linear(x).reshape(B, L, H, Dk).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) / math.sqrt(Dk)   # (B, H, L, L)
        if mask is not None:
            m2 = mask[:, None, :, None] * mask[:, None, None, :]
            scores = torch.where(m2 > 0, scores,
                                 torch.full_like(scores, -6.55e4))
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, L, D)
        return self.out(out)


class RefEncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, d_ff: int = 2048):
        super().__init__()
        self.norm_1 = RefNorm(d_model)
        self.attn = RefMHA(heads, d_model)
        self.norm_2 = RefNorm(d_model)
        self.ff_linear_1 = nn.Linear(d_model, d_ff)
        self.ff_linear_2 = nn.Linear(d_ff, d_model)

    def forward(self, x, mask=None):
        x = x + self.attn(self.norm_1(x), mask)
        h = torch.relu(self.ff_linear_1(self.norm_2(x)))
        return x + self.ff_linear_2(h)


class AxisDecoder(nn.Module):
    def __init__(self, hidden: int, out: int = 4):
        super().__init__()
        self.linear_0 = nn.Linear(hidden, hidden)
        self.linear_2 = nn.Linear(hidden, out)

    def forward(self, x):
        return torch.relu(self.linear_2(torch.relu(self.linear_0(x))))


class AxisTransformer(nn.Module):
    def __init__(self, in_dim: int, hidden: int, layers: int, heads: int,
                 d_ff: int = 2048):
        super().__init__()
        self.linear = nn.Linear(in_dim, hidden)
        self.layers = layers
        for i in range(layers):
            setattr(self, f"layer_{i}",
                    RefEncoderLayer(hidden, heads, d_ff))
        self.decoder = AxisDecoder(hidden)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = self.linear(x)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.decoder(x)


class Stacker(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int,
                 d_ff: int = 2048):
        super().__init__()
        self.logi_encoder_0 = nn.Linear(4, hidden)
        self.logi_encoder_2 = nn.Linear(hidden, hidden)
        self.tsfm = AxisTransformer(2 * hidden, hidden, layers, heads, d_ff)

    def forward(self, vis_feat, logi, mask=None):
        y = torch.relu(self.logi_encoder_2(
            torch.relu(self.logi_encoder_0(logi))))
        return self.tsfm(torch.cat([vis_feat, y], dim=-1), mask)


class LoreProcessor(nn.Module):
    """(features (B,K,H), dets (B,K,8) fmap coords, mask)
    -> (logi, stacked_logi)."""

    def __init__(self, config: LoreConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        if cfg.wiz_2dpe:
            self.x_position_embeddings = nn.Embedding(cfg.max_fmp_size,
                                                      cfg.hidden_size)
            self.y_position_embeddings = nn.Embedding(cfg.max_fmp_size,
                                                      cfg.hidden_size)
        self.tsfm_axis = AxisTransformer(cfg.hidden_size, cfg.hidden_size,
                                         cfg.tsfm_layers, cfg.num_heads,
                                         cfg.d_ff)
        if cfg.wiz_stacking:
            self.stacker = Stacker(cfg.hidden_size, cfg.stacking_layers,
                                   cfg.num_heads, cfg.d_ff)

    def forward(self, feat, dets=None, mask=None):
        cfg = self.config
        if cfg.wiz_2dpe and dets is not None:
            # truncation toward zero, then clip (dets.astype(int32))
            ps = dets.to(torch.int32).clamp(0, cfg.max_fmp_size - 1).long()
            x_emb = self.x_position_embeddings
            y_emb = self.y_position_embeddings
            # left/upper/right/lower (dets: x1,y1,x2,y2,x3,y3,x4,y4)
            feat = feat + x_emb(ps[..., 0]) + y_emb(ps[..., 1]) \
                + x_emb(ps[..., 2]) + y_emb(ps[..., 5])
        logi = self.tsfm_axis(feat, mask)
        stacked = None
        if cfg.wiz_stacking:
            stacked = self.stacker(feat, logi, mask)
        return logi, stacked
