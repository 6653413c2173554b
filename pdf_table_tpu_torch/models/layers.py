"""Shared building blocks (counterpart of pdf_table_tpu/models/layers.py).

Only what the LORE slice uses: ``ConvBNAct`` with the torch/paddle
symmetric ``k//2`` padding and BatchNorm eps 1e-5, an inference-mode
``BatchNorm`` whose parameter names the weight bridge maps one to one, and
the activation table. Modules run NCHW (the model keeps activations in
``channels_last`` memory format).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    None: None,
}


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 (flax ``nn.BatchNorm`` with
    ``use_running_average=True``): scale/bias + running mean/var. They stay
    f32 whatever the activations' dtype; a bf16 input is normalized in f32
    and returned in bf16, as flax does with its f32 params."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 act: Optional[str] = "relu"):
        super().__init__()
        kh, kw = kernel
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=((kh - 1) // 2, (kw - 1) // 2),
                              bias=False)
        self.bn = BatchNorm(features)
        self.act = ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x
