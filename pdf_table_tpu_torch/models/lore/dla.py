"""DLA-34 backbone + deformable-conv upsampling (DLAUp/IDAUp)
(counterpart of pdf_table_tpu/models/lore/dla.py).

Modules run NCHW on activations kept in ``channels_last`` memory format, so
the NHWC view the deform conv takes is a permute, not a copy. Submodule
names follow the flax tree (``level3.tree1.root.conv`` ...), so the weight
bridge maps paths one to one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ...ops.deform_conv import deform_conv2d
from ...parallel import spatial
from ...parallel.collectives import gather_rows_for_dcn
from ..layers import BatchNorm, ConvBNAct

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)


class Root(nn.Module):
    """Aggregation node: concat children -> 1x1 conv -> bn -> (+residual)
    relu."""

    def __init__(self, in_ch: int, features: int, residual: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn = BatchNorm(features)
        self.residual = residual

    def forward(self, children: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.bn(self.conv(torch.cat(list(children), dim=1)))
        if self.residual:
            x = x + children[0]
        return torch.relu(x)


class DlaBasicBlock(nn.Module):
    """DLA residual block; the residual is supplied by the caller."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, features, (3, 3), (stride, stride))
        self.conv2 = ConvBNAct(features, features, (3, 3), act=None)

    def forward(self, x, residual):
        return torch.relu(self.conv2(self.conv1(x)) + residual)


class Tree(nn.Module):
    """Recursive aggregation tree: maxpool downsample + 1x1 ``project`` form
    the block residual; children accumulate into ``Root``.

    ``children_ch`` is the channel count of the children a parent passes
    in (the flax module infers it from the inputs)."""

    rows = None   # the sp region (parallel/spatial.py)

    def __init__(self, levels: int, in_ch: int, features: int,
                 stride: int = 1, level_root: bool = False,
                 root_residual: bool = False, children_ch: int = 0):
        super().__init__()
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if in_ch != features:
            self.project = ConvBNAct(in_ch, features, (1, 1), act=None)
        else:
            self.project = None
        if level_root:
            children_ch += in_ch
        if levels == 1:
            self.tree1 = DlaBasicBlock(in_ch, features, stride)
            self.tree2 = DlaBasicBlock(features, features, 1)
            self.root = Root(2 * features + children_ch, features,
                             root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_ch, features, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, features, features, 1,
                              root_residual=root_residual,
                              children_ch=children_ch + features)

    def forward(self, x, children=None):
        children = list(children) if children else []
        if self.stride > 1:
            bottom = spatial.max_pool2d(x, self.stride, self.stride, 0,
                                        self.rows)
        else:
            bottom = x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            # like the reference, the residual is always recomputed from
            # project(bottom); a parent's projection is never used
            residual = self.project(bottom) if self.project is not None \
                else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1, x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        return self.tree2(x1, children=children + [x1])


class DLA34(nn.Module):
    """Returns all 6 levels (strides 1, 2, 4, 8, 16, 32)."""

    def __init__(self):
        super().__init__()
        ch = DLA34_CHANNELS
        self.base = ConvBNAct(3, ch[0], (7, 7))
        self.level0 = ConvBNAct(ch[0], ch[0], (3, 3))
        self.level1 = ConvBNAct(ch[0], ch[1], (3, 3), (2, 2))
        self.level2 = Tree(1, ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(2, ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(2, ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(1, ch[4], ch[5], 2, level_root=True)

    def forward(self, x) -> List[torch.Tensor]:
        y = []
        x = self.level0(self.base(x))
        y.append(x)
        for name in ("level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            y.append(x)
        return y


class DeformConvBlock(nn.Module):
    """offset/mask conv + modulated deform conv + bn + relu. The mask's
    sigmoid runs in the activations' dtype and the DCN bias stays f32 and
    is added to the f32 sums, as in the flax block.

    In the sp region (``rows``, parallel/spatial.py) the offset conv runs
    on this rank's rows, the input is gathered whole (the offsets reach
    anywhere) and the deform conv computes this rank's output rows over it
    (its row window). The column-parallel block of
    parallel/tensor_parallel.py overrides :meth:`deform`."""

    rows = None

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv_offset_mask = nn.Conv2d(in_ch, 27, 3, padding=1)
        self.weight = nn.Parameter(torch.empty(3, 3, in_ch, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.bn = BatchNorm(features)
        self.dcn = deform_conv2d

    def forward(self, x):
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)
        offset = om[..., :18].float().contiguous()
        mask = torch.sigmoid(om[..., 18:]).float().contiguous()
        xs = x.permute(0, 2, 3, 1).contiguous()
        h0 = 0
        if spatial.active(self.rows):
            # a 3x3/1 DCN: its output rows split as its input's
            starts = self.rows.layout(xs, 1)
            h0 = starts[self.rows.axis.rank]
            xs = gather_rows_for_dcn(xs, 1, starts, self.rows.axis)
        y = self.deform(xs, offset, mask, h0)
        y = y.to(x.dtype).permute(0, 3, 1, 2)
        return torch.relu(self.bn(y))

    def deform(self, x, offset, mask, h0: int) -> torch.Tensor:
        """The deform conv's output rows ``[h0, h0 + offset rows)`` over
        the whole ``x``, f32 NHWC."""
        return self.dcn(x, offset, mask, self.weight, self.bias, h0=h0,
                        ho=offset.shape[1])


def bilinear_up_kernel(f: int) -> torch.Tensor:
    """(2f, 2f) bilinear tap weights for a stride-f depthwise transposed
    conv (torch fill_up_weights init)."""
    k = 2 * f
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = torch.arange(k, dtype=torch.float32)
    w1 = 1.0 - torch.abs(i / f - c)
    return w1[:, None] * w1[None, :]


class DepthwiseUpsample(nn.Module):
    """Grouped ConvTranspose(k=2f, stride=f, pad=f//2, groups=C). The flax
    module writes it as an lhs-dilated conv with the flipped kernel; with
    the (C, 1, k, k) kernel un-flipped, ``conv_transpose2d`` is the same
    operator."""

    rows = None   # the sp region (parallel/spatial.py)

    def __init__(self, channels: int, factor: int):
        super().__init__()
        self.factor = factor
        if factor != 1:
            k = 2 * factor
            self.weight = nn.Parameter(
                bilinear_up_kernel(factor).expand(channels, 1, k, k).clone())

    def forward(self, x):
        f = self.factor
        if f == 1:
            return x
        return spatial.conv_transpose2d(x, self.weight, None, (f, f),
                                        (f // 2, f // 2), (0, 0),
                                        x.shape[1], (1, 1), self.rows)


class IDAUp(nn.Module):
    """Iterative deep aggregation. ``in_channels[k]`` is the channel count
    of level ``startp + k``; the forward updates levels startp+1..endp-1."""

    def __init__(self, features: int, in_channels: Sequence[int],
                 up_factors: Tuple[int, ...]):
        super().__init__()
        self.n = len(in_channels)
        for k in range(1, self.n):
            setattr(self, f"proj_{k}",
                    DeformConvBlock(in_channels[k], features))
            setattr(self, f"up_{k}",
                    DepthwiseUpsample(features, int(up_factors[k])))
            setattr(self, f"node_{k}",
                    DeformConvBlock(features, features))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int):
        out = list(layers)
        for i in range(startp + 1, endp):
            k = i - startp
            x = getattr(self, f"proj_{k}")(out[i])
            x = getattr(self, f"up_{k}")(x)
            out[i] = getattr(self, f"node_{k}")(x + out[i - 1])
        return out


class DLAUp(nn.Module):
    """Pyramid of IDAUps collapsing levels to the first level's stride.
    Input: levels[first_level:] with ``channels``; returns outs with
    outs[i] the merged feature at stride 4*2^i, channels[i]."""

    def __init__(self, channels: Tuple[int, ...]):
        super().__init__()
        n = len(channels)
        self.n = n
        scales = [2 ** i for i in range(n)]
        in_ch = list(channels)
        for i in range(n - 1):
            j = n - i - 2
            up_f = tuple(s // scales[j] for s in scales[j:])
            setattr(self, f"ida_{i}",
                    IDAUp(channels[j], in_ch[j:], up_f))
            scales[j + 1:] = [scales[j] for _ in scales[j + 1:]]
            in_ch[j + 1:] = [channels[j] for _ in in_ch[j + 1:]]

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        n = self.n
        work = list(layers)
        outs = [work[-1]]
        for i in range(n - 1):
            j = n - i - 2
            work = getattr(self, f"ida_{i}")(work, j, n)
            outs.insert(0, work[-1])
        return outs
