"""Shared building blocks (counterpart of pdf_table_tpu/models/layers.py).

What the LORE, DBNet, recognition, classifier and LGPMA slices use:
``ConvBNAct`` (grouped for depthwise) with the torch/paddle symmetric
``k//2`` padding and BatchNorm eps 1e-5, a ``BatchNorm`` (running
statistics, or the batch's inside :func:`batch_statistics`) whose
parameter names the weight bridge maps one to one, the activation
table, ``make_divisible``, ``SEModule``, the PP-LCNet
``DepthwiseSeparable``, the MobileNetV3 ``InvertedResidual``, the nearest
``upsample2x`` and ``upsample_to``, the ResNet family (``BasicBlock``,
``Bottleneck``, ``ResNet``) and DBNet's SegDetector ``FPN``.
Modules run NCHW (the models keep activations in ``channels_last`` memory
format).

bf16 follows flax's rule (``dtype=bf16``, ``param_dtype=f32``) through
:func:`cast_model`: conv, dense and recurrent weights and biases compute in
bf16, the norms keep f32 parameters and statistics, normalize in f32 and
return the compute dtype.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """``x * relu6(x + 3) / 6``: in f32 as one kernel; in bf16 op by op,
    each result rounded to bf16, as XLA computes the JAX expression (one
    kernel puts bf16 PP-OCRv4 rec, PicoDet and SLANet 0.96-1.17 times
    JAX's own bf16-vs-f32 distance from JAX's bf16 output, against 0.14-0.79
    op by op, and PP-OCRv4 rec's greedy ids part from JAX's)."""
    if x.dtype == torch.float32:
        return F.hardswish(x)
    return x * F.relu6(x + 3.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``relu6(x + 3) / 6`` as one kernel."""
    return F.hardsigmoid(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """One kernel in f32; in bf16 ``1 / (1 + exp(-x))`` op by op, as XLA
    lowers ``jax.nn.sigmoid`` in bf16 (one kernel puts the DBNets' bf16
    prob maps 1.05-1.13 times JAX's own bf16-vs-f32 distance from JAX's,
    against 0.32-0.60)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """One kernel in f32; in bf16 ``exp(x - max) / sum`` op by op (the sum
    accumulated in f32 and rounded), as XLA lowers ``jax.nn.softmax`` (with
    one kernel a TableMaster block fed JAX's bf16 input equals JAX's output
    on 0.66 of its elements, against 0.90 or more)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


ACTS = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "hardswish": hardswish,
    "hardsigmoid": hardsigmoid,
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": sigmoid,
    None: None,
}


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with flax ``nn.BatchNorm``'s two modes.

    By default it normalizes by its running statistics
    (``use_running_average=True``). Inside :func:`batch_statistics` it
    normalizes by the batch's biased variance, ``E[x^2] - E[x]^2`` clipped
    at 0, and updates its running mean and variance (also the biased one)
    as ``0.9 * old + 0.1 * batch`` (``use_running_average=False,
    momentum=0.9``: JAX's ``train=True``). Only that switch picks the mode,
    never ``self.training``. Parameters and statistics stay f32 whatever
    the activations' dtype; a bf16 input is normalized in f32 and returned
    in bf16, as flax does with its f32 params."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.use_batch_stats = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_batch_stats:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)


@contextlib.contextmanager
def batch_statistics(model: nn.Module) -> Iterator[None]:
    """Within the block every :class:`BatchNorm` of ``model`` runs in batch
    mode (JAX's ``train=True`` with ``mutable=["batch_stats"]``)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.use_batch_stats for m in norms]
    for m in norms:
        m.use_batch_stats = True
    try:
        yield
    finally:
        for m, b in zip(norms, before):
            m.use_batch_stats = b


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: statistics, scale and bias in f32 whatever
    the input's dtype, the result in ``out_dtype`` (the compute dtype that
    :func:`cast_model` sets; f32 until then). A float64 input (a model
    cast to float64, as the gradient tests' yardstick runs it) stays
    float64."""

    out_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float64:
            return F.layer_norm(x, self.normalized_shape, self.weight,
                                self.bias, self.eps)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.out_dtype)


class _BiasAfter:
    """A biased conv or dense layer in bf16 that rounds its product to
    bf16 before it adds the bias, as flax's ``nn.Conv`` / ``nn.Dense`` do
    (PyTorch adds the bias before it rounds: that puts bf16 ConvNextViT
    1.05 and CRNN 0.98 times JAX's own bf16-vs-f32 distance from JAX's
    bf16 logits, against 0.93 and 0.39)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias
        self.bias = None
        try:
            y = super().forward(x)
        finally:
            self.bias = b
        shape = (-1,) if isinstance(self, nn.Linear) \
            else (-1,) + (1,) * (y.dim() - 2)
        return y + b.reshape(shape)


class _Conv2dBiasAfter(_BiasAfter, nn.Conv2d):
    pass


class _ConvTranspose2dBiasAfter(_BiasAfter, nn.ConvTranspose2d):
    pass


class _LinearBiasAfter(_BiasAfter, nn.Linear):
    pass


_BIAS_AFTER = {nn.Conv2d: _Conv2dBiasAfter,
               nn.ConvTranspose2d: _ConvTranspose2dBiasAfter,
               nn.Linear: _LinearBiasAfter}


def cast_model(model: nn.Module, dtype: torch.dtype,
               keep: Iterable[nn.Parameter] = ()) -> None:
    """Give ``model`` flax's mixed precision for ``dtype``: every floating
    parameter in ``dtype`` except those of the norms (:class:`BatchNorm`,
    :class:`LayerNorm`) and those in ``keep``, which stay f32 as flax
    parameters that a module uses without casting them do. Buffers are the
    norms' statistics and stay f32. In bf16 a biased conv or dense layer
    adds its bias after rounding its product (:class:`_BiasAfter`)."""
    kept = {id(p) for p in keep}
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.out_dtype = dtype
        if isinstance(m, (BatchNorm, nn.LayerNorm)):
            continue
        for p in m.parameters(recurse=False):
            if p.is_floating_point() and id(p) not in kept:
                p.data = p.data.to(dtype)
        if dtype != torch.float32 and type(m) in _BIAS_AFTER \
                and m.bias is not None:
            m.__class__ = _BIAS_AFTER[type(m)]


def as_input_of(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """``x`` in ``layer``'s weight dtype, as a flax layer casts its input
    to its own ``dtype``."""
    return x.to(layer.weight.dtype)


class ConvBNAct(nn.Module):
    """Conv2d (``groups`` for depthwise; a bias where ``bias``) + BatchNorm
    + activation. Strided convs keep the symmetric ``k//2`` padding too;
    an even kernel side gets none (CRNN's (2, 1) ``VALID`` conv)."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 act: Optional[str] = "relu", groups: int = 1,
                 bias: bool = False):
        super().__init__()
        kh, kw = kernel
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=((kh - 1) // 2, (kw - 1) // 2),
                              groups=groups, bias=bias)
        self.bn = BatchNorm(features)
        self.act = ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class SEModule(nn.Module):
    """Squeeze-excite: mean -> 1x1 fc1 -> relu -> 1x1 fc2 ->
    ``x * hardsigmoid``."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        mid = max(1, channels // reduction)
        self.fc1 = nn.Conv2d(channels, mid, 1)
        self.fc2 = nn.Conv2d(mid, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * hardsigmoid(self.fc2(s))


class DepthwiseSeparable(nn.Module):
    """PP-LCNet block: depthwise ``ConvBNAct`` -> (SE) -> 1x1 pointwise
    ``ConvBNAct``, one activation for both."""

    def __init__(self, in_ch: int, features: int,
                 dw_kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), use_se: bool = False,
                 act: str = "hardswish"):
        super().__init__()
        self.dw = ConvBNAct(in_ch, in_ch, dw_kernel, stride, act=act,
                            groups=in_ch)
        self.se = SEModule(in_ch) if use_se else None
        self.pw = ConvBNAct(in_ch, features, (1, 1), act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw(x)
        if self.se is not None:
            x = self.se(x)
        return self.pw(x)


class InvertedResidual(nn.Module):
    """MobileNetV3 block: 1x1 expand -> depthwise -> (SE) -> 1x1 project;
    the residual only at stride 1 with equal widths."""

    def __init__(self, in_ch: int, features: int, expand: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), use_se: bool = False,
                 act: str = "relu"):
        super().__init__()
        self.expand = ConvBNAct(in_ch, expand, (1, 1), act=act)
        self.dw = ConvBNAct(expand, expand, kernel, stride, act=act,
                            groups=expand)
        self.se = SEModule(expand) if use_se else None
        self.project = ConvBNAct(expand, features, (1, 1), act=None)
        self.residual = tuple(stride) == (1, 1) and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.residual else y


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest upsample of an NCHW tensor by an integer factor: every
    pixel becomes a ``factor x factor`` block."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return upsample_nearest(x, 2)


def upsample_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an NCHW tensor to ``hw``: output ``i`` reads
    input ``floor((i + 0.5) * in / out)``, as ``jax.image.resize``'s
    "nearest" does."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class BasicBlock(nn.Module):
    """ResNet-18/34 basic block: two 3x3 ``ConvBNAct`` and a 1x1 ``down``
    projection of the identity where the stride or width changes."""

    def __init__(self, in_ch: int, features: int,
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, features, (3, 3), stride)
        self.conv2 = ConvBNAct(features, features, (3, 3), act=None)
        self.down = ConvBNAct(in_ch, features, (1, 1), stride, act=None) \
            if tuple(stride) != (1, 1) or in_ch != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.down is None else self.down(x)
        return torch.relu(self.conv2(self.conv1(x)) + identity)


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck: 1x1 -> 3x3 (strided) -> 1x1 to
    ``4 * features``, with the ``down`` projection as in
    :class:`BasicBlock`."""

    expansion = 4

    def __init__(self, in_ch: int, features: int,
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        out_c = features * self.expansion
        self.conv1 = ConvBNAct(in_ch, features, (1, 1))
        self.conv2 = ConvBNAct(features, features, (3, 3), stride)
        self.conv3 = ConvBNAct(features, out_c, (1, 1), act=None)
        self.down = ConvBNAct(in_ch, out_c, (1, 1), stride, act=None) \
            if tuple(stride) != (1, 1) or in_ch != out_c else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.down is None else self.down(x)
        return torch.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


RESNET_LAYOUTS = {18: (BasicBlock, (2, 2, 2, 2)),
                  34: (BasicBlock, (3, 4, 6, 3)),
                  50: (Bottleneck, (3, 4, 6, 3))}


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, padding 1 (padded with -inf, as flax's
    ``nn.max_pool`` with explicit padding)."""
    return F.max_pool2d(x, 3, 2, 1)


class ResNet(nn.Module):
    """ResNet backbone returning the stride 4, 8, 16 and 32 maps
    (torchvision layouts: 18 and 34 of basic blocks, 50 of bottlenecks):
    a 7x7/2 ``stem``, the 3x3/2 max pool and ``layer{i}_{j}`` blocks."""

    def __init__(self, depth: int = 18):
        super().__init__()
        if depth not in RESNET_LAYOUTS:
            raise ValueError(f"unsupported resnet depth {depth}")
        block, layers = RESNET_LAYOUTS[depth]
        self.stem = ConvBNAct(3, 64, (7, 7), (2, 2))
        in_ch = 64
        self.names = []
        for i, (w, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stage = []
            for j in range(n):
                stride = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"layer{i + 1}_{j}"
                setattr(self, name, block(in_ch, w, stride))
                in_ch = w * getattr(block, "expansion", 1)
                stage.append(name)
            self.names.append(stage)
        self.out_channels = tuple(
            w * getattr(block, "expansion", 1) for w in (64, 128, 256, 512))

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2(self.stem(x))
        feats = []
        for stage in self.names:
            for name in stage:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


class FPN(nn.Module):
    """DBNet's SegDetector neck over C2..C5: 1x1 laterals ``in{2..5}`` with
    top-down nearest 2x adds, 3x3 smooths ``out{2..5}`` to a quarter of
    the width each, concatenated at stride 4 in the order o2, o3, o4, o5
    (the last three resized to o2's size). No biases."""

    def __init__(self, in_channels, out_features: int = 256):
        super().__init__()
        f, q = out_features, out_features // 4
        for lvl, c in zip((2, 3, 4, 5), in_channels):
            self.add_module(f"in{lvl}", nn.Conv2d(c, f, 1, bias=False))
        for lvl in (5, 4, 3, 2):
            self.add_module(f"out{lvl}",
                            nn.Conv2d(f, q, 3, padding=1, bias=False))

    def forward(self, feats) -> torch.Tensor:
        c2, c3, c4, c5 = feats
        p5 = self.in5(c5)
        p4 = self.in4(c4) + upsample2x(p5)
        p3 = self.in3(c3) + upsample2x(p4)
        p2 = self.in2(c2) + upsample2x(p3)
        o2 = self.out2(p2)
        hw = o2.shape[2:]
        return torch.cat([o2, upsample_to(self.out3(p3), hw),
                          upsample_to(self.out4(p4), hw),
                          upsample_to(self.out5(p5), hw)], dim=1)
