"""LORE cell detector: DLA-34 + DCN (DLASeg) or the ResNet-18 variant,
with CenterNet heads {hm:2, st:8, wh:8, ax:256, cr:256, reg:2} at stride 4
(counterpart of pdf_table_tpu/models/lore/detector.py)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.deform_conv import deform_conv2d_plain
from ...parallel import spatial
from ...parallel.collectives import gather_rows_replicated
from ..layers import BasicBlock, BatchNorm, ConvBNAct
from .config import LoreConfig
from .dla import (DLA34, DLA34_CHANNELS, DeformConvBlock, DepthwiseUpsample,
                  DLAUp, IDAUp)


def head_channels(hidden_size: int = 256) -> Dict[str, int]:
    return {"hm": 2, "st": 8, "wh": 8, "ax": hidden_size, "cr": hidden_size,
            "reg": 2}


class CenterHeads(nn.Module):
    """Per-head conv3x3(head_conv) + relu -> conv1x1(out). Outputs are
    NCHW f32 (the flax heads cast to f32). ``heads`` ((name, channels),
    ...) overrides LORE's head set, as Cycle-CenterNet's does. In the sp
    region (``rows``) the maps leave it whole: every rank's rows gathered
    in one call, for the replicated downstream."""

    rows = None

    def __init__(self, in_ch: int, head_conv: int = 256,
                 hidden_size: int = 256,
                 heads: Optional[Sequence[Tuple[str, int]]] = None):
        super().__init__()
        self.head_map = dict(heads) if heads is not None \
            else head_channels(hidden_size)
        for head, ch in self.head_map.items():
            setattr(self, f"{head}_conv",
                    nn.Conv2d(in_ch, head_conv, 3, padding=1))
            setattr(self, f"{head}_out", nn.Conv2d(head_conv, ch, 1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        out = {}
        for head in self.head_map:
            y = torch.relu(getattr(self, f"{head}_conv")(x))
            out[head] = getattr(self, f"{head}_out")(y).float()
        if spatial.active(self.rows):
            whole = gather_rows_replicated(
                torch.cat(list(out.values()), 1), 2, self.rows.layout(x),
                self.rows.axis)
            out = dict(zip(out, whole.split([v.shape[1]
                                             for v in out.values()], 1)))
        return out


class DLACenterNet(nn.Module):
    """DLA-34 -> DLAUp -> final IDAUp -> heads at stride 4: LORE's DLASeg
    detector and the trunk of Cycle-CenterNet (counterpart of
    pdf_table_tpu/models/centernet_base.py)."""

    first_level = 2   # down_ratio 4
    last_level = 5

    def __init__(self, head_conv: int = 256, hidden_size: int = 256,
                 heads: Optional[Sequence[Tuple[str, int]]] = None):
        super().__init__()
        ch = DLA34_CHANNELS[self.first_level:]
        self.base = DLA34()
        self.dla_up = DLAUp(ch)
        n = self.last_level - self.first_level
        self.ida_up = IDAUp(ch[0], ch[:n], (1, 2, 4))
        self.heads = CenterHeads(ch[0], head_conv, hidden_size, heads)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        levels = self.base(x)
        outs = self.dla_up(levels[self.first_level:])
        y = list(outs[:self.last_level - self.first_level])
        y = self.ida_up(y, 0, len(y))
        return self.heads(y[-1])


def conv_transpose_same(in_ch: int, out_ch: int, k: int, s: int,
                        bias: bool = True) -> nn.ConvTranspose2d:
    """The ``nn.ConvTranspose2d`` that computes flax's ``nn.ConvTranspose``
    with ``padding="SAME"`` (output ``s`` times the input): flax pads the
    dilated input by (pad_a, pad_b) from ``lax``'s transpose-padding rule,
    torch by ``k - 1 - padding`` on each side plus ``output_padding``
    after. The kernel flip is the weight bridge's."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    pad_b = pad_len - pad_a
    if not 0 <= pad_b - pad_a < s or pad_a > k - 1:
        raise ValueError(f"no torch padding for a SAME transpose, k={k}, "
                         f"s={s}")
    return nn.ConvTranspose2d(in_ch, out_ch, k, stride=s,
                              padding=k - 1 - pad_a,
                              output_padding=pad_b - pad_a, bias=bias)


class ResNetDetector(nn.Module):
    """ResNet-18 (every stage strided, widths 64, 128, 256, 256) + 1x1
    adaptions + four 4x4/2 transposed-conv upsamples with skip sums, heads
    with head_conv 64 (the reference's LoreDetectModel)."""

    widths = (64, 128, 256, 256)
    rows = None   # the sp region (parallel/spatial.py)

    def __init__(self, config: LoreConfig):
        super().__init__()
        self.stem = ConvBNAct(3, 64, (7, 7), (2, 2))
        in_ch = 64
        for i, w in enumerate(self.widths):
            for j in range(2):
                setattr(self, f"layer{i + 1}_{j}",
                        BasicBlock(in_ch, w, (2, 2) if j == 0 else (1, 1)))
                in_ch = w
        for n, c in enumerate((64,) + self.widths[:3]):
            setattr(self, f"adaption{n}", nn.Conv2d(c, 256, 1, bias=False))
        for n in range(1, 5):
            setattr(self, f"deconv{n}_up",
                    conv_transpose_same(self.widths[-1] if n == 1 else 256,
                                        256, 4, 2, bias=False))
            setattr(self, f"deconv{n}_bn", BatchNorm(256))
        self.adaptionU1 = nn.Conv2d(256, 256, 1, bias=False)
        self.heads = CenterHeads(256, 64, config.hidden_size)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        # 3x3/2 max pool padded with -inf (layers.max_pool_3x3_s2)
        x = spatial.max_pool2d(self.stem(x), 3, 2, 1, self.rows)
        feats = [x]                                      # stride 4
        for i in range(len(self.widths)):
            for j in range(2):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            feats.append(x)                              # strides 8 .. 64
        u = feats[-1]
        for n in range(1, 5):
            u = getattr(self, f"deconv{n}_up")(u)
            u = torch.relu(getattr(self, f"deconv{n}_bn")(u))
            u = u + getattr(self, f"adaption{4 - n}")(feats[4 - n])
        return self.heads(self.adaptionU1(u))


def build_detector(config: LoreConfig) -> nn.Module:
    if config.backbone == "dla34":
        return DLACenterNet(config.head_conv, config.hidden_size)
    if config.backbone == "resnet18":
        return ResNetDetector(config)
    raise ValueError(f"unknown LORE backbone {config.backbone!r}")


def cast_detector(detector: nn.Module, dtype: torch.dtype,
                  plain_dcn: bool = False) -> None:
    """Give ``detector`` the flax modules' dtypes: conv, transposed-conv,
    DCN and upsample weights (and conv biases) in ``dtype``, BatchNorm
    parameters and statistics and the DCN biases f32. ``plain_dcn=True``
    runs every deform conv through its plain PyTorch version (a
    yardstick run for the kernel)."""
    for m in detector.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                          DepthwiseUpsample)):
            m.to(dtype)
        elif isinstance(m, DeformConvBlock):
            m.weight = nn.Parameter(m.weight.detach().to(dtype))
            if plain_dcn:
                m.dcn = deform_conv2d_plain
