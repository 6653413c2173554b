"""The CTC text recognizers (counterpart of
pdf_table_tpu/models/rec_ctc/model.py), four backbones behind one module:

- ``svtr_lcnet`` (PP-OCRv4): MobileNetV1Enhance conv stages (strides
  (2,1) collapse the height and keep the width) -> 2x2 average pool ->
  EncoderWithSVTR (two global-mixer transformer blocks over the H x W
  tokens) -> mean over H; one time step per 8 px of input width;
- ``crnn``: RGB -> grey inside the network, a VGG-style conv stack that
  collapses a 32 px height to 1, two bidirectional LSTMs (``nn.LSTM``;
  the weight bridge fuses flax's per-gate cells into its packed weights);
  one step per 4 px;
- ``convnext_vit``: grey, a ConvNext encoder whose stage downsamples are
  (2, 1), then a 12-layer ViT over the width tokens; one step per 4 px;
- ``lightweight_edge``: grey, the searched NAS plan of
  models/nas_layers.py; one step per 4 px.

Each ends in a linear CTC head: logits (B, T, V), f32. The public input is
NHWC like the JAX model's; modules run NCHW. Submodule names are the flax
module names, so the weight bridge maps paths one to one.

In bf16 (``config.dtype``, layers.py::cast_model) the networks round where
the flax modules do: the grey conversion runs on the f32 input, SVTR's
attention softmax in f32, ConvNextViT's in bf16, ConvNext's layer scale
``gamma`` stays f32 (so its residual stream is f32, as flax promotes it),
and CRNN's BiLSTMs are ``nn.LSTM`` in bf16 (flax's ``OptimizedLSTMCell``
rounds its gates to bf16 at every step and keeps its carry f32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...engine.device import compute_dtype
from ..layers import (ConvBNAct, DepthwiseSeparable, LayerNorm, as_input_of,
                      cast_model, softmax)
from ..nas_layers import ConvBNPReLU, build_plan, run_plan
from .config import RecConfig

BACKBONES = ("svtr_lcnet", "crnn", "convnext_vit", "lightweight_edge")

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
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
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
        y = F.silu(self.fc1(self.norm2(x)))
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
        self.svtr_norm = LayerNorm(hidden, eps=1e-6)
        self.svtr_conv3 = ConvBNAct(hidden, c, (1, 1), act="swish")
        self.svtr_conv4 = ConvBNAct(2 * c, c // 8, (3, 3), act="swish")
        self.svtr_conv1x1 = ConvBNAct(c // 8, dims, (1, 1), act="swish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(as_input_of(x, self.conv1.conv))
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


def rgb_to_grey(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H, W) luma with the reference networks'
    weights, summed in this order."""
    return x[:, 0:1] * 0.2989 + x[:, 1:2] * 0.5870 + x[:, 2:3] * 0.1140


def layer_norm_nchw(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of an NCHW tensor."""
    return ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class BiLSTM(nn.Module):
    """Bidirectional LSTM + the ``embedding`` projection. flax's two
    ``OptimizedLSTMCell`` (``fwd_cell``, ``bwd_cell``: the backward one
    runs the reversed sequence, its outputs kept in input order) are the
    forward and reverse halves of ``lstm``."""

    def __init__(self, in_ch: int, hidden: int, out: int):
        super().__init__()
        self.lstm = nn.LSTM(in_ch, hidden, batch_first=True,
                            bidirectional=True)
        self.embedding = nn.Linear(2 * hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding(self.lstm(x)[0])


class CRNNBackbone(nn.Module):
    """conv0(64) + pool 2x2 -> conv1(128) + pool 2x2 -> conv2(256, 256) +
    pool (2, 1) -> conv3(512, 512) + pool (2, 1) -> conv4(512, kernel and
    stride (2, 1)); biased convs, BatchNorm, relu. A 32 px height
    collapses to 1: (B, W / 4, 512). The conv weights are channels_last,
    so that cuDNN runs the stack in NHWC: from the one-channel grey input
    it would run NCHW, where its heuristics take FFT convolutions for
    ``conv2_3`` with a 64 GiB workspace (392 ms a forward of 256 crops at
    32 x 640 on an H100, 253 ms of it in that conv; chip_smoke.py's
    ``rec_backbones``)."""

    LAYERS = (("conv0_0", 1, 64), ("conv1_0", 64, 128),
              ("conv2_0", 128, 256), ("conv2_3", 256, 256),
              ("conv3_0", 256, 512), ("conv3_3", 512, 512))

    def __init__(self):
        super().__init__()
        for name, cin, cout in self.LAYERS:
            setattr(self, name, ConvBNAct(cin, cout, bias=True))
        self.conv4_0 = ConvBNAct(512, 512, (2, 1), (2, 1), bias=True)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 3:
            x = rgb_to_grey(x)
        x = F.max_pool2d(self.conv0_0(as_input_of(x, self.conv0_0.conv)), 2)
        x = F.max_pool2d(self.conv1_0(x), 2)
        x = F.max_pool2d(self.conv2_3(self.conv2_0(x)), (2, 1))
        x = F.max_pool2d(self.conv3_3(self.conv3_0(x)), (2, 1))
        return self.conv4_0(x)[:, :, 0].transpose(1, 2)


class ConvNextBlock(nn.Module):
    """Depthwise 7x7 -> LayerNorm (eps 1e-6) -> 4x pointwise, exact GELU,
    pointwise -> ``gamma`` scale -> residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.ln = LayerNorm(dim, eps=1e-6)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln(self.dwconv(as_input_of(x, self.dwconv))
                    .permute(0, 2, 3, 1))
        y = self.pw2(F.gelu(self.pw1(y)))
        return x + (self.gamma * y).permute(0, 3, 1, 2)


class ViTLayer(nn.Module):
    """Pre-LN self-attention (biased q, k, v, ``attn_out``) + pre-LN 4x
    MLP with exact GELU; LayerNorm eps 1e-12."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNorm(dim, eps=1e-12)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.attn_out = nn.Linear(dim, dim)
        self.ln2 = LayerNorm(dim, eps=1e-12)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        dh = D // self.heads
        y = self.ln1(x)
        q, k, v = (m(y).reshape(B, T, self.heads, dh)
                   for m in (self.q, self.k, self.v))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        att = softmax(att, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, D)
        x = x + self.attn_out(ctx)
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class ConvNextViTBackbone(nn.Module):
    """Grey input -> 4x4/4 patch conv + LayerNorm -> ConvNext stages
    (before each stage after the first: LayerNorm and a (2, 1)/(2, 1)
    conv, width kept) -> the (1, W / 4) map as tokens -> ``proj`` + the
    first T rows of ``pos_embed`` -> ViT layers -> LayerNorm (eps
    1e-12): (B, W / 4, dims)."""

    def __init__(self, depths=(3, 3, 8, 3), hidden_sizes=(96, 192, 256, 512),
                 dims: int = 192, depth: int = 12, heads: int = 3,
                 pos_len: int = 75):
        super().__init__()
        self.depths = tuple(depths)
        self.depth = depth
        c = hidden_sizes[0]
        self.patch_conv = nn.Conv2d(1, c, 4, stride=4)
        self.patch_ln = LayerNorm(c, eps=1e-6)
        for si, (n, h) in enumerate(zip(depths, hidden_sizes)):
            if si > 0:
                setattr(self, f"s{si}_down_ln", LayerNorm(c, eps=1e-6))
                setattr(self, f"s{si}_down",
                        nn.Conv2d(c, h, (2, 1), stride=(2, 1)))
            for li in range(n):
                setattr(self, f"s{si}_b{li}", ConvNextBlock(h))
            c = h
        self.proj = nn.Linear(c, dims)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_len, dims))
        for i in range(depth):
            setattr(self, f"vit{i}", ViTLayer(dims, heads))
        self.vit_ln = LayerNorm(dims, eps=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 3:
            x = rgb_to_grey(x)
        x = layer_norm_nchw(self.patch_ln,
                            self.patch_conv(as_input_of(x, self.patch_conv)))
        for si, n in enumerate(self.depths):
            if si > 0:
                x = getattr(self, f"s{si}_down")(layer_norm_nchw(
                    getattr(self, f"s{si}_down_ln"), x))
            for li in range(n):
                x = getattr(self, f"s{si}_b{li}")(x)
        B, C, fh, fw = x.shape
        t = self.proj(as_input_of(x, self.proj).permute(0, 2, 3, 1)
                      .reshape(B, fh * fw, C))
        T = t.shape[1]
        if T > self.pos_embed.shape[1]:
            raise ValueError(f"{T} tokens, {self.pos_embed.shape[1]} "
                             f"positions")
        t = t + self.pos_embed[:, :T]
        for i in range(self.depth):
            t = getattr(self, f"vit{i}")(t)
        return self.vit_ln(t)


# The searched plnas_linear_mix_se plan: (kind, kernels, expand, stride,
# out, residual), ("se", squeeze) or ("zero",), which adds no block.
LWE_PLAN = (
    ("mb", ((5, 5),), 6, (2, 2), 32, False),
    ("rep", ((3, 3), (5, 5)), 6, (1, 1), 32, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 2, (1, 1), 32, True),
    ("rep", ((1, 1), (3, 3), (5, 5)), 6, (1, 1), 32, True),
    ("mb", ((5, 5),), 6, (1, 1), 32, True),
    ("se", 8),
    ("mix", ((3, 3), (5, 5)), 6, (2, 1), 64, False),
    ("zero",), ("zero",), ("zero",), ("zero",),
    ("se", 8),
    ("mb", ((5, 5),), 2, (2, 1), 96, False),
    ("mb", ((3, 5),), 6, (1, 1), 96, True),
    ("linmix", ((3, 3), (3, 5)), None, (1, 1), 96, True),
    ("mix", ((3, 3), (3, 5)), 4, (1, 1), 96, True),
    ("zero",),
    ("se", 8),
    ("mb", ((3, 5),), 6, (2, 1), 128, False),
    ("mb", ((1, 5),), 6, (1, 1), 128, True),
    ("rep", ((1, 3), (1, 5)), 4, (1, 1), 128, True),
    ("mix", ((1, 3), (1, 5)), 4, (1, 1), 128, True),
    ("zero",),
)


class LightweightEdgeBackbone(nn.Module):
    """RGB -> grey, 3x3/2 ConvBNPReLU stem to 24 channels, the LWE_PLAN
    blocks (SE slots without a shortcut), mean over the collapsed height:
    (B, W / 4, 128) at a 32 px height."""

    def __init__(self):
        super().__init__()
        self.first_conv = ConvBNPReLU(1, 24, (3, 3), (2, 2))
        self.out_channels = build_plan(self, LWE_PLAN, 24)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grey = rgb_to_grey(x)
        x, _ = run_plan(self, LWE_PLAN,
                        self.first_conv(as_input_of(grey,
                                                    self.first_conv.conv)),
                        se_residual=False)
        return x.mean(dim=2).transpose(1, 2)


class CTCRecModel(nn.Module):
    """``forward`` takes NHWC images (B, H, W, C) already normalized and
    returns f32 logits (B, T, V)."""

    def __init__(self, config: RecConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown rec backbone {cfg.backbone!r}")
        self.dtype = compute_dtype(cfg.dtype)
        self.crnn = cfg.backbone == "crnn"
        if self.crnn:
            h = cfg.hidden_size
            self.backbone = CRNNBackbone()
            self.rnn1 = BiLSTM(512, h, h)
            self.rnn2 = BiLSTM(h, h, 512)
            dims = 512
        elif cfg.backbone == "convnext_vit":
            self.backbone = ConvNextViTBackbone(
                cfg.convnext_depths, cfg.convnext_hidden, cfg.vit_dim,
                cfg.vit_layers, cfg.vit_heads, cfg.vit_pos_len)
            dims = cfg.vit_dim
        elif cfg.backbone == "lightweight_edge":
            self.backbone = LightweightEdgeBackbone()
            dims = self.backbone.out_channels
        else:
            self.backbone = SVTRLCNetBackbone(
                scale=cfg.svtr_scale, dims=cfg.svtr_dims,
                hidden=cfg.svtr_hidden, depth=cfg.svtr_depth,
                heads=cfg.svtr_heads, in_ch=cfg.img_channels)
            dims = cfg.svtr_dims
        self.ctc_head = nn.Linear(dims, cfg.vocab_size)
        cast_model(self, self.dtype, keep=[
            m.gamma for m in self.modules() if isinstance(m, ConvNextBlock)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x.permute(0, 3, 1, 2))
        if self.crnn:
            feat = self.rnn2(self.rnn1(feat))
        return self.ctc_head(feat).float()
