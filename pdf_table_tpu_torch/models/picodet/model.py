"""PicoDet: LCNet backbone + CSP-PAN neck + shared GFL head (counterpart of
pdf_table_tpu/models/picodet/model.py).

Submodule names are the flax module names, so the weight bridge maps the
tree one to one. ``PicoDet.forward`` takes NHWC images (B, H, W, 3), already
normalized, and returns per stride level sigmoid class scores (B, HW, C) and
raw GFL box distributions (B, HW, 4 * (reg_max + 1)), both f32, with HW
flattened row-major as the JAX model does. Modules run NCHW in
``config.dtype`` (layers.py::cast_model); the head casts its 1x1 output to
f32 before the sigmoid and the split, as the JAX head does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ...engine.device import compute_dtype
from ..layers import (ConvBNAct, cast_model, hardsigmoid, make_divisible,
                      upsample2x)
from .config import PicoDetConfig

# PPLCNet NET_CONFIG per stage: (kernel, in_c, out_c, stride, use_se)
LCNET_CONFIG = {
    2: [(3, 16, 32, 1, False)],
    3: [(3, 32, 64, 2, False), (3, 64, 64, 1, False)],
    4: [(3, 64, 128, 2, False), (3, 128, 128, 1, False)],
    5: [(3, 128, 256, 2, False)] + [(5, 256, 256, 1, False)] * 5,
    6: [(5, 256, 512, 2, True), (5, 512, 512, 1, True)],
}


class LCNetDWSep(nn.Module):
    """Depthwise conv (+ SE) + pointwise conv, each conv + BN + hardswish.
    The SE gate ``relu6(s + 3) / 6`` is ``F.hardsigmoid``, the same
    expression in the same order."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int,
                 use_se: bool = False):
        super().__init__()
        self.dw = ConvBNAct(in_ch, in_ch, (kernel, kernel), (stride, stride),
                            act="hardswish", groups=in_ch)
        self.use_se = use_se
        if use_se:
            self.se_fc1 = nn.Conv2d(in_ch, in_ch // 4, 1)
            self.se_fc2 = nn.Conv2d(in_ch // 4, in_ch, 1)
        self.pw = ConvBNAct(in_ch, features, (1, 1), act="hardswish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw(x)
        if self.use_se:
            s = torch.relu(self.se_fc1(x.mean((2, 3), keepdim=True)))
            x = x * hardsigmoid(self.se_fc2(s))
        return self.pw(x)


class LCNetBackbone(nn.Module):
    """PPLCNet trunk; returns the outputs of ``out_stages`` (PicoDet: the
    blocks4/5/6 maps, strides 8/16/32)."""

    def __init__(self, scale: float = 1.0,
                 out_stages: Sequence[int] = (4, 5, 6)):
        super().__init__()
        self.out_stages = tuple(out_stages)
        c = make_divisible(16 * scale)
        self.conv1 = ConvBNAct(3, c, (3, 3), (2, 2), act="hardswish")
        self.stages: List[List[str]] = []
        self.out_channels: List[int] = []
        for stage in range(2, 7):
            names = []
            for i, (k, _, out_c, st, se) in enumerate(LCNET_CONFIG[stage]):
                f = make_divisible(out_c * scale)
                name = f"blocks{stage}_{i}"
                setattr(self, name, LCNetDWSep(c, f, k, st, use_se=se))
                names.append(name)
                c = f
            self.stages.append(names)
            if stage in self.out_stages:
                self.out_channels.append(c)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.conv1(x)
        outs = []
        for stage, names in zip(range(2, 7), self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_stages:
                outs.append(x)
        return tuple(outs)


class DPModule(nn.Module):
    """Depthwise ``kernel`` x ``kernel`` + pointwise 1x1, each BN +
    hardswish (input width == ``features``)."""

    def __init__(self, features: int, kernel: int = 5, stride: int = 1):
        super().__init__()
        self.dw = ConvBNAct(features, features, (kernel, kernel),
                            (stride, stride), act="hardswish",
                            groups=features)
        self.pw = ConvBNAct(features, features, (1, 1), act="hardswish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class DarknetBottleneck(nn.Module):
    """1x1 ConvBN + DPModule, no identity add (as CSP-PAN uses it)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 5):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, features, (1, 1), act="hardswish")
        self.conv2 = DPModule(features, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class CSPLayer(nn.Module):
    """main 1x1 -> bottlenecks; short 1x1; concat [main, short]; final 1x1
    (expand ratio 0.5)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 5,
                 num_blocks: int = 1):
        super().__init__()
        mid = features // 2
        self.short_conv = ConvBNAct(in_ch, mid, (1, 1), act="hardswish")
        self.main_conv = ConvBNAct(in_ch, mid, (1, 1), act="hardswish")
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"block{i}", DarknetBottleneck(mid, mid, kernel))
        self.final_conv = ConvBNAct(2 * mid, features, (1, 1),
                                    act="hardswish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short = self.short_conv(x)
        main = self.main_conv(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"block{i}")(main)
        return self.final_conv(torch.cat([main, short], dim=1))


class CSPPAN(nn.Module):
    """n-level PAN plus, with ``extra_level``, one stride-2x top level."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 kernel: int = 5, extra_level: bool = True):
        super().__init__()
        f = out_channels
        n = self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"conv_t{i}", ConvBNAct(c, f, (1, 1),
                                                  act="hardswish"))
        for i in range(n - 1):
            setattr(self, f"top_down{i}", CSPLayer(2 * f, f, kernel))
            setattr(self, f"downsample{i}", DPModule(f, kernel, stride=2))
            setattr(self, f"bottom_up{i}", CSPLayer(2 * f, f, kernel))
        self.extra_level = extra_level
        if extra_level:
            self.first_top_conv = DPModule(f, kernel, stride=2)
            self.second_top_conv = DPModule(f, kernel, stride=2)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        n = self.n
        ins = [getattr(self, f"conv_t{i}")(x) for i, x in enumerate(feats)]
        # top-down: concat order [upsampled high, low]
        inner = [ins[-1]]
        for idx in range(n - 1, 0, -1):
            skip = ins[idx - 1]
            # stride-2 levels have ceil sizes, so 2x the upper level can
            # overshoot the skip by a row or column: crop to its grid
            up = upsample2x(inner[0])[:, :, :skip.shape[2], :skip.shape[3]]
            inner.insert(0, getattr(self, f"top_down{n - 1 - idx}")(
                torch.cat([up, skip], dim=1)))
        # bottom-up: concat order [downsampled low, high]
        outs = [inner[0]]
        for idx in range(n - 1):
            down = getattr(self, f"downsample{idx}")(outs[-1])
            outs.append(getattr(self, f"bottom_up{idx}")(
                torch.cat([down, inner[idx + 1]], dim=1)))
        if self.extra_level:
            outs.append(self.first_top_conv(ins[-1])
                        + self.second_top_conv(outs[-1]))
        return tuple(outs)


class PicoHead(nn.Module):
    """Shared cls + reg head: per level ``num_convs`` x (depthwise 5x5 +
    pointwise 1x1, hardswish after each), then a biased 1x1 ``head_cls``
    whose channels split into class logits and the GFL bins."""

    def __init__(self, channels: int, num_levels: int, num_classes: int,
                 reg_max: int = 7, num_convs: int = 4):
        super().__init__()
        self.num_classes = num_classes
        self.num_levels = num_levels
        self.num_convs = num_convs
        self.reg_ch = 4 * (reg_max + 1)
        f = channels
        for li in range(num_levels):
            for ci in range(num_convs):
                setattr(self, f"cls_conv_dw{li}_{ci}", ConvBNAct(
                    f, f, (5, 5), act="hardswish", groups=f))
                setattr(self, f"cls_conv_pw{li}_{ci}", ConvBNAct(
                    f, f, (1, 1), act="hardswish"))
            setattr(self, f"head_cls{li}",
                    nn.Conv2d(f, num_classes + self.reg_ch, 1))

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        scores, boxes = [], []
        c = self.num_classes
        for li, x in enumerate(feats):
            for ci in range(self.num_convs):
                x = getattr(self, f"cls_conv_dw{li}_{ci}")(x)
                x = getattr(self, f"cls_conv_pw{li}_{ci}")(x)
            out = getattr(self, f"head_cls{li}")(x).float()
            b, _, h, w = out.shape
            out = out.permute(0, 2, 3, 1).reshape(b, h * w, -1)
            scores.append(torch.sigmoid(out[..., :c]))
            boxes.append(out[..., c:])
        return scores, boxes


class PicoDet(nn.Module):
    def __init__(self, config: PicoDetConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = compute_dtype(cfg.dtype)
        self.backbone = LCNetBackbone(cfg.lcnet_scale)
        self.neck = CSPPAN(self.backbone.out_channels, cfg.neck_channels,
                           extra_level=len(cfg.strides) == 4)
        self.head = PicoHead(cfg.neck_channels, len(cfg.strides),
                             cfg.num_classes, cfg.reg_max, cfg.head_convs)
        cast_model(self, self.dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        # NHWC memory read as channels_last
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        scores, boxes = self.head(self.neck(self.backbone(x)))
        return {"scores": scores, "boxes": boxes}
