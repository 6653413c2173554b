"""DBNet (counterpart of pdf_table_tpu/models/dbnet/model.py), on its
three families of backbone:

- ``mobilenetv3`` (PP-OCRv4): MobileNetV3-0.5 -> RSE-FPN neck (concat at
  stride 4) -> DB binarize head (conv, two 2x2/2 transposed convs);
- ``resnet18`` / ``resnet50`` (ModelScope): ResNet -> the SegDetector
  ``FPN`` (models/layers.py) -> the same binarize head;
- ``proxylessnas``: the searched ``CompactNasBackbone`` -> the
  ``LightSegFuse`` sum of 1x1 laterals -> ``LightSegHead`` (depthwise
  separable convs, the 2x2/2 depthwise upsample a broadcast multiply).

Each gives the prob map. Modules keep the flax submodule names, so the
weight bridge maps the JAX tree one to one. ``DBNet`` takes NHWC images,
as the JAX module does, and runs them as a ``channels_last`` NCHW view,
in ``config.dtype`` (layers.py::cast_model); the prob map is f32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from ...engine.device import compute_dtype
from ..layers import (FPN, BatchNorm, ConvBNAct, InvertedResidual, ResNet,
                      SEModule, cast_model, make_divisible, sigmoid,
                      upsample2x,
                      upsample_nearest)
from ..nas_layers import build_plan, run_plan
from .config import DbNetConfig


class MobileNetV3Det(nn.Module):
    """MobileNetV3-large(0.5) detection backbone. Returns C2..C5 at strides
    4/8/16/32: a feature tap before each stride-2 block from stride 4 on,
    and the 1x1 ``last_conv`` at stride 32."""

    # (kernel, expand, out, use_se, act, stride)
    CFG = [
        (3, 16, 16, False, "relu", 1),
        (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1),    # C2 @ stride 4
        (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1),
        (5, 120, 40, True, "relu", 1),    # C3 @ stride 8
        (3, 240, 80, False, "hardswish", 2),
        (3, 200, 80, False, "hardswish", 1),
        (3, 184, 80, False, "hardswish", 1),
        (3, 184, 80, False, "hardswish", 1),
        (3, 480, 112, True, "hardswish", 1),
        (3, 672, 112, True, "hardswish", 1),  # C4 @ stride 16
        (5, 672, 160, True, "hardswish", 2),
        (5, 960, 160, True, "hardswish", 1),
        (5, 960, 160, True, "hardswish", 1),  # C5 @ stride 32
    ]

    def __init__(self, in_ch: int = 3, scale: float = 0.5,
                 disable_se: bool = True):
        super().__init__()
        s = scale
        c = make_divisible(16 * s)
        self.stem = ConvBNAct(in_ch, c, (3, 3), (2, 2), act="hardswish")
        self.taps: List[int] = []        # blocks whose input is a feature
        self.out_channels: List[int] = []
        stride_now = 2
        for i, (k, e, o, se, act, st) in enumerate(self.CFG):
            if st == 2 and stride_now >= 4:
                self.taps.append(i)
                self.out_channels.append(c)
            stride_now *= st
            out = make_divisible(o * s)
            self.add_module(f"block{i}", InvertedResidual(
                c, out, make_divisible(e * s), (k, k), (st, st),
                use_se=se and not disable_se, act=act))
            c = out
        self.last_conv = ConvBNAct(c, make_divisible(960 * s), (1, 1),
                                   act="hardswish")
        self.out_channels.append(make_divisible(960 * s))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for i in range(len(self.CFG)):
            if i in self.taps:
                feats.append(x)
            x = getattr(self, f"block{i}")(x)
        feats.append(self.last_conv(x))
        return feats


class RSELayer(nn.Module):
    """Residual squeeze-excite conv: ``y + SE(y)`` with ``y = conv(x)``."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel,
                              padding=(kernel - 1) // 2, bias=False)
        self.se = SEModule(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + self.se(y)


class RSEFPN(nn.Module):
    """RSE 1x1 laterals with top-down adds, RSE 3x3 smooths, and the
    stride-4 concat in the order o5, o4, o3, o2."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 96):
        super().__init__()
        f, q = out_channels, out_channels // 4
        for lvl, c in zip((2, 3, 4, 5), in_channels):
            self.add_module(f"in{lvl}", RSELayer(c, f, 1))
        for lvl in (5, 4, 3, 2):
            self.add_module(f"out{lvl}", RSELayer(f, q, 3))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        c2, c3, c4, c5 = feats
        p5 = self.in5(c5)
        p4 = self.in4(c4) + upsample2x(p5)
        p3 = self.in3(c3) + upsample2x(p4)
        p2 = self.in2(c2) + upsample2x(p3)
        return torch.cat([upsample_nearest(self.out5(p5), 8),
                          upsample_nearest(self.out4(p4), 4),
                          upsample2x(self.out3(p3)), self.out2(p2)], dim=1)


class BinarizeHead(nn.Module):
    """conv3x3 + BN + relu -> 2x2/2 transposed conv + BN + relu -> 2x2/2
    transposed conv -> sigmoid; (B, 1, H, W) -> prob (B, H, W) at 4x the
    input's side."""

    def __init__(self, in_ch: int, inner: int):
        super().__init__()
        q = inner // 4
        self.conv = ConvBNAct(in_ch, q, (3, 3), act="relu")
        self.up1 = nn.ConvTranspose2d(q, q, 2, stride=2)
        self.bn1 = BatchNorm(q)
        self.up2 = nn.ConvTranspose2d(q, 1, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.up1(self.conv(x))))
        return sigmoid(self.up2(x))[:, 0]


# The searched CompactDetBackbone plan: (kind, kernels, expand, stride,
# out, residual) or ("se", squeeze); the SE slots carry an identity
# shortcut and tap the stride 4, 8, 16 and 32 maps.
DBNAS_PLAN = (
    ("rep", ((3, 3), (5, 5)), 2, (2, 2), 32, False),
    ("rep", ((1, 1), (3, 3), (5, 5)), 2, (1, 1), 32, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 2, (1, 1), 32, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 2, (1, 1), 32, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 2, (1, 1), 32, True),
    ("se", 2),
    ("rep", ((3, 3), (5, 5)), 4, (2, 2), 64, False),
    ("rep", ((3, 3), (5, 5)), 4, (1, 1), 64, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 64, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 64, True),
    ("rep", ((3, 3), (5, 5)), 4, (1, 1), 64, True),
    ("se", 8),
    ("rep", ((3, 3), (5, 5)), 4, (2, 2), 96, False),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 96, True),
    ("rep", ((3, 3), (5, 5)), 4, (1, 1), 96, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 96, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 96, True),
    ("se", 8),
    ("mb", ((5, 5),), 4, (2, 2), 128, False),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 128, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 128, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 4, (1, 1), 128, True),
    ("rep", ((3, 3), (5, 5)), 4, (1, 1), 128, True),
    ("se", 8),
)


class CompactNasBackbone(nn.Module):
    """3x3/2 ReLU stem to 32 channels, then the DBNAS_PLAN blocks; the
    maps after the four SE slots (strides 4, 8, 16, 32)."""

    out_channels = (32, 64, 96, 128)

    def __init__(self):
        super().__init__()
        self.first_conv = ConvBNAct(3, 32, (3, 3), (2, 2), act="relu")
        build_plan(self, DBNAS_PLAN, 32)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return run_plan(self, DBNAS_PLAN, self.first_conv(x),
                        se_residual=True)[1]


class DwPwConv(nn.Module):
    """Depthwise k + BatchNorm + relu + pointwise 1x1, no biases."""

    def __init__(self, in_ch: int, features: int, kernel: int):
        super().__init__()
        self.depthwise = nn.Conv2d(in_ch, in_ch, kernel,
                                   padding=kernel // 2, groups=in_ch,
                                   bias=False)
        self.bn1 = BatchNorm(in_ch)
        self.pointwise = nn.Conv2d(in_ch, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(torch.relu(self.bn1(self.depthwise(x))))


class DwPwConvTranspose(nn.Module):
    """The per-channel 2x2/2 transposed conv as a broadcast multiply (each
    pixel becomes a 2x2 block weighted by its channel's kernel) plus its
    bias, BatchNorm + relu, a biased pointwise 1x1. ``depthwise_kernel``
    keeps flax's (2, 2, C) layout."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.depthwise_kernel = nn.Parameter(torch.zeros(2, 2, in_ch))
        self.depthwise_bias = nn.Parameter(torch.zeros(in_ch))
        self.bn1 = BatchNorm(in_ch)
        self.pointwise = nn.Conv2d(in_ch, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        w = self.depthwise_kernel.permute(2, 0, 1).reshape(1, C, 1, 2, 1, 2)
        y = (x[:, :, :, None, :, None] * w).reshape(B, C, 2 * H, 2 * W)
        y = y + self.depthwise_bias[None, :, None, None]
        return self.pointwise(torch.relu(self.bn1(y)))


class LightSegFuse(nn.Module):
    """Per-level 1x1 laterals, nearest upsample to stride 4, summed in the
    order p5 + p4 + p3 + p2."""

    def __init__(self, in_channels: Sequence[int], inner: int = 64):
        super().__init__()
        for lvl, c in zip((2, 3, 4, 5), in_channels):
            self.add_module(f"in{lvl}", nn.Conv2d(c, inner, 1, bias=False))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        c2, c3, c4, c5 = feats
        return upsample_nearest(self.in5(c5), 8) \
            + upsample_nearest(self.in4(c4), 4) + upsample2x(self.in3(c3)) \
            + self.in2(c2)


class LightSegHead(nn.Module):
    """DwPwConv k5 -> BatchNorm relu -> DwPwConvTranspose -> BatchNorm
    relu -> DwPwConvTranspose to 1 channel -> sigmoid: prob (B, H, W)."""

    def __init__(self, in_ch: int, inner: int, dw_kernel: int = 5):
        super().__init__()
        q = inner // 4
        self.dwpw = DwPwConv(in_ch, q, dw_kernel)
        self.bn_a = BatchNorm(q)
        self.up1 = DwPwConvTranspose(q, q)
        self.bn_b = BatchNorm(q)
        self.up2 = DwPwConvTranspose(q, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn_a(self.dwpw(x)))
        x = torch.relu(self.bn_b(self.up1(x)))
        return torch.sigmoid(self.up2(x).float())[:, 0]


BACKBONES = ("mobilenetv3", "resnet18", "resnet50", "proxylessnas")


class DBNet(nn.Module):
    """The detector. ``forward(images)`` takes NHWC float images and returns
    {"prob": (B, H, W) f32}, as the JAX module's inference call does."""

    def __init__(self, config: DbNetConfig):
        super().__init__()
        cfg = config
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown DBNet backbone {cfg.backbone!r}")
        self.config = cfg
        self.dtype = compute_dtype(cfg.dtype)
        inner = cfg.inner_channels
        if cfg.backbone == "proxylessnas":
            self.backbone = CompactNasBackbone()
            self.neck = LightSegFuse(self.backbone.out_channels, inner)
            self.binarize = LightSegHead(inner, inner)
        else:
            if cfg.backbone == "mobilenetv3":
                self.backbone = MobileNetV3Det()
                self.neck = RSEFPN(self.backbone.out_channels, inner)
            else:
                self.backbone = ResNet(int(cfg.backbone[len("resnet"):]))
                self.neck = FPN(self.backbone.out_channels, inner)
            self.binarize = BinarizeHead(inner, inner)
        cast_model(self, self.dtype)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # NHWC memory read as channels_last
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        prob = self.binarize(self.neck(self.backbone(x)))
        return {"prob": prob.float()}
