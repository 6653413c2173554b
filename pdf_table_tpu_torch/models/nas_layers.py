"""The NAS layer zoo of the proxyless-searched backbones (counterpart of
pdf_table_tpu/models/nas_layers.py): the LightweightEdge recognizer and
the ProxylessNAS DBNet both compose these MobileInvertedResidual-style
ops. Submodule names are the flax ones, so the weight bridge maps paths
one to one. Modules run NCHW.

flax's ``nn.PReLU`` has one scalar slope (``negative_slope``, 0.25 at
init); :class:`PReLU` keeps it as a 0-d parameter of that name.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from .layers import BatchNorm

Kernel = Tuple[int, int]


class PReLU(nn.Module):
    """``x`` where ``x >= 0``, else ``negative_slope * x``, one scalar
    slope for every channel (flax ``nn.PReLU``)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class ConvBNPReLU(nn.Module):
    """conv (no bias, ``k // 2`` padding, ``groups``) + BatchNorm (+
    PReLU)."""

    def __init__(self, in_ch: int, features: int, kernel: Kernel,
                 stride: Kernel = (1, 1), groups: int = 1, act: bool = True):
        super().__init__()
        kh, kw = kernel
        self.conv = nn.Conv2d(in_ch, features, tuple(kernel),
                              stride=tuple(stride),
                              padding=(kh // 2, kw // 2), groups=groups,
                              bias=False)
        self.bn = BatchNorm(features)
        self.act = PReLU() if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


def split_channels(total: int, n: int) -> List[int]:
    """Ceil split; the last chunk absorbs the remainder."""
    split = [math.ceil(total / n) for _ in range(n)]
    split[-1] += total - sum(split)
    return split


class NasMBConv(nn.Module):
    """Optional 1x1 expand + depthwise k + 1x1 project (PReLU after the
    expand and the depthwise conv only)."""

    def __init__(self, in_ch: int, out: int, kernel: Kernel, expand: int,
                 stride: Kernel):
        super().__init__()
        mid = round(in_ch * expand)
        self.inverted_bottleneck = ConvBNPReLU(in_ch, mid, (1, 1)) \
            if expand != 1 else None
        self.depth_conv = ConvBNPReLU(mid, mid, kernel, stride, groups=mid)
        self.point_conv = ConvBNPReLU(mid, out, (1, 1), act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.inverted_bottleneck is not None:
            x = self.inverted_bottleneck(x)
        return self.point_conv(self.depth_conv(x))


class NasMixConv(nn.Module):
    """Expand, split the channels over one depthwise branch per kernel,
    concat, project."""

    def __init__(self, in_ch: int, out: int, kernels: Sequence[Kernel],
                 expand: int, stride: Kernel):
        super().__init__()
        mid = round(in_ch * expand)
        self.inverted_bottleneck = ConvBNPReLU(in_ch, mid, (1, 1))
        self.splits = split_channels(mid, len(kernels))
        for j, (k, c) in enumerate(zip(kernels, self.splits)):
            setattr(self, f"mix_conv_{j}",
                    ConvBNPReLU(c, c, k, stride, groups=c))
        self.point_conv = ConvBNPReLU(mid, out, (1, 1), act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.inverted_bottleneck(x)
        parts = x.split(self.splits, dim=1)
        x = torch.cat([getattr(self, f"mix_conv_{j}")(p)
                       for j, p in enumerate(parts)], dim=1)
        return self.point_conv(x)


class NasLinMixConv(nn.Module):
    """No expansion: every depthwise branch sees the whole input; the
    concat multiplies the channels before a shared PReLU and the
    projection."""

    def __init__(self, in_ch: int, out: int, kernels: Sequence[Kernel],
                 stride: Kernel):
        super().__init__()
        self.n = len(kernels)
        for j, k in enumerate(kernels):
            setattr(self, f"mix_conv_{j}",
                    ConvBNPReLU(in_ch, in_ch, k, stride, groups=in_ch))
        self.act = PReLU()
        self.point_conv = ConvBNPReLU(in_ch * self.n, out, (1, 1), act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([getattr(self, f"mix_conv_{j}")(x)
                       for j in range(self.n)], dim=1)
        return self.point_conv(self.act(x))


class NasRepConv(nn.Module):
    """Expand, parallel depthwise branches (conv + BatchNorm, no
    activation) summed in kernel order, a shared PReLU, project."""

    def __init__(self, in_ch: int, out: int, kernels: Sequence[Kernel],
                 expand: int, stride: Kernel):
        super().__init__()
        mid = round(in_ch * expand)
        self.n = len(kernels)
        self.inverted_bottleneck = ConvBNPReLU(in_ch, mid, (1, 1))
        for j, k in enumerate(kernels):
            setattr(self, f"rep_conv_{j}",
                    ConvBNPReLU(mid, mid, k, stride, groups=mid, act=False))
        self.act = PReLU()
        self.point_conv = ConvBNPReLU(mid, out, (1, 1), act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.inverted_bottleneck(x)
        acc = self.rep_conv_0(x)
        for j in range(1, self.n):
            acc = acc + getattr(self, f"rep_conv_{j}")(x)
        return self.point_conv(self.act(acc))


class NasSE(nn.Module):
    """Mean-pool -> 1x1 fc1 + relu -> 1x1 fc2 -> ``x * sigmoid``."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // squeeze, 1)
        self.fc2 = nn.Conv2d(channels // squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s).float()).to(x.dtype)


def build_plan(module: nn.Module, plan, in_ch: int) -> int:
    """Add ``block{i}`` of a searched plan to ``module`` (entries
    ``(kind, kernels, expand, stride, out, residual)``, ``("se",
    squeeze)`` or ``("zero",)``, which adds nothing); returns the output
    channels."""
    c = in_ch
    for i, spec in enumerate(plan):
        kind = spec[0]
        if kind == "zero":
            continue
        if kind == "se":
            setattr(module, f"block{i}", NasSE(c, spec[1]))
            continue
        _, kernels, expand, stride, out, _ = spec
        if kind == "mb":
            block = NasMBConv(c, out, kernels[0], expand, stride)
        elif kind == "mix":
            block = NasMixConv(c, out, kernels, expand, stride)
        elif kind == "linmix":
            block = NasLinMixConv(c, out, kernels, stride)
        else:
            block = NasRepConv(c, out, kernels, expand, stride)
        setattr(module, f"block{i}", block)
        c = out
    return c


def run_plan(module: nn.Module, plan, x: torch.Tensor,
             se_residual: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run the blocks :func:`build_plan` added: a block's output replaces
    ``x``, or is added to it where the entry is residual; an SE slot
    scales ``x`` (``se_residual``: ``x + SE(x)``, the detector's identity
    shortcut) and, in the detector, taps a feature map. Returns ``x`` and
    the maps after each SE slot."""
    feats = []
    for i, spec in enumerate(plan):
        if spec[0] == "zero":
            continue
        block = getattr(module, f"block{i}")
        if spec[0] == "se":
            x = x + block(x) if se_residual else block(x)
            feats.append(x)
            continue
        y = block(x)
        x = x + y if spec[5] else y
    return x, feats
