"""LORE cell detector: DLA-34 + DCN (DLASeg) with CenterNet heads
{hm:2, st:8, wh:8, ax:256, cr:256, reg:2} at stride 4
(counterpart of pdf_table_tpu/models/lore/detector.py; the ResNet-18
detector is not ported yet)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .config import LoreConfig
from .dla import DLA34, DLA34_CHANNELS, DLAUp, IDAUp


def head_channels(hidden_size: int = 256) -> Dict[str, int]:
    return {"hm": 2, "st": 8, "wh": 8, "ax": hidden_size, "cr": hidden_size,
            "reg": 2}


class CenterHeads(nn.Module):
    """Per-head conv3x3(head_conv) + relu -> conv1x1(out). Outputs are
    NCHW f32 (the flax heads cast to f32)."""

    def __init__(self, in_ch: int, head_conv: int = 256,
                 hidden_size: int = 256):
        super().__init__()
        self.head_map = head_channels(hidden_size)
        for head, ch in self.head_map.items():
            setattr(self, f"{head}_conv",
                    nn.Conv2d(in_ch, head_conv, 3, padding=1))
            setattr(self, f"{head}_out", nn.Conv2d(head_conv, ch, 1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        out = {}
        for head in self.head_map:
            y = torch.relu(getattr(self, f"{head}_conv")(x))
            out[head] = getattr(self, f"{head}_out")(y).float()
        return out


class DLASegDetector(nn.Module):
    """DLA-34 -> DLAUp -> final IDAUp -> heads at stride 4."""

    first_level = 2   # down_ratio 4
    last_level = 5

    def __init__(self, config: LoreConfig):
        super().__init__()
        ch = DLA34_CHANNELS[self.first_level:]
        self.base = DLA34()
        self.dla_up = DLAUp(ch)
        n = self.last_level - self.first_level
        self.ida_up = IDAUp(ch[0], ch[:n], (1, 2, 4))
        self.heads = CenterHeads(ch[0], config.head_conv, config.hidden_size)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        levels = self.base(x)
        outs = self.dla_up(levels[self.first_level:])
        y = list(outs[:self.last_level - self.first_level])
        y = self.ida_up(y, 0, len(y))
        return self.heads(y[-1])
