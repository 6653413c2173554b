"""PP-LCNet classifier (counterpart of pdf_table_tpu/models/cls/model.py):
stem s2 -> five depthwise-separable stages -> global average pool -> 1x1
expand conv (``class_expand``, hardswish, no bias) -> fc -> softmax (or
sigmoid for multilabel) in f32.

The public input is NHWC like the JAX model's; modules run NCHW. Submodule
names are the flax module names.
"""

from __future__ import annotations

import torch
from torch import nn

from ...engine.device import compute_dtype
from ..layers import (ConvBNAct, DepthwiseSeparable, cast_model, hardswish,
                      make_divisible)
from .config import ClsPulcConfig

# (kernel, out_c, stride, use_se) per block, grouped by stage
NET_CONFIG = [
    [(3, 32, 1, False)],
    [(3, 64, 2, False), (3, 64, 1, False)],
    [(3, 128, 2, False), (3, 128, 1, False)],
    [(3, 256, 2, False), (5, 256, 1, False), (5, 256, 1, False),
     (5, 256, 1, False), (5, 256, 1, False), (5, 256, 1, False)],
    [(5, 512, 2, True), (5, 512, 1, True)],
]


class PPLCNetClassifier(nn.Module):
    """``forward`` takes NHWC images (B, H, W, 3) already normalized and
    returns f32 class probabilities (B, class_num); the network computes
    in ``config.dtype``, the logits are cast to f32."""

    def __init__(self, config: ClsPulcConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = compute_dtype(cfg.dtype)
        s = cfg.scale
        c = make_divisible(16 * s)
        self.stem = ConvBNAct(3, c, (3, 3), (2, 2), act="hardswish")
        self.block_names = []
        for bi, stage in enumerate(NET_CONFIG):
            for li, (k, f, st, se) in enumerate(stage):
                f = make_divisible(f * s)
                name = f"blocks{bi + 2}_{li}"
                setattr(self, name, DepthwiseSeparable(
                    c, f, (k, k), (st, st), use_se=se, act="hardswish"))
                self.block_names.append(name)
                c = f
        self.last_conv = nn.Conv2d(c, cfg.class_expand, 1, bias=False) \
            if cfg.use_last_conv else None
        self.fc = nn.Linear(cfg.class_expand if cfg.use_last_conv else c,
                            cfg.class_num)
        cast_model(self, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2).to(self.dtype))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean((2, 3), keepdim=True)
        if self.last_conv is not None:
            x = hardswish(self.last_conv(x))
        logits = self.fc(x[:, :, 0, 0]).float()
        if self.config.multilabel:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)
