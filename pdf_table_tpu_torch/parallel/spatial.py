"""Row-sharded layers: the ``sp`` axis of the train step's mesh (JAX
shards image height over ``sp``, ``pdf_table_tpu/train/train_step.py``,
and GSPMD inserts the convolutions' halo exchanges; the JAX package has
no code of its own for it).

Inside the sp region (the detector) every activation is split by rows:
rank ``r`` of ``sp`` holds rows ``[floor(r H / sp), floor((r + 1) H /
sp))`` of a map of ``H`` rows, whatever ``H`` is at that level, so a
map of 3 rows splits 1 : 2 over two ranks. Each layer computes its own
output rows from the input rows that its geometry reaches, fetched by
:func:`collectives.halo_rows` with the layer's fill past the image's
edges: zeros for a convolution, ``-inf`` for ResNet's padded max pool,
none for DLA's ``max_pool(stride, stride)``. Pointwise layers (BatchNorm
on stored statistics, activations, 1x1 convs of stride 1, sums of maps
split alike) need nothing. A deform conv reads anywhere, so its input is
gathered whole (``DeformConvBlock``); the heads' maps leave the region
whole (``CenterHeads``).

Nothing demands more of ``H`` than JAX does (``H % sp == 0`` at the
image): a rank whose share of a level is no row computes one row and
keeps none of it, so every rank's graph, and the order of its
collectives, is the same.

The parameters used inside the region get partial gradients on each rank
(each from its own rows): the train step sums them over sp, once, in one
flat all-reduce (:attr:`Rows.param_names`).

:class:`Rows` is the region's switch: the layers shard only while it is
``enabled``, which the train step sets where it split the image (a batch
whose rows sp does not divide stays whole, and every sp rank computes the
same step, as JAX replicates such a leaf).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import Axis, halo_rows, row_heights, split_rows


class Rows:
    """The sp axis of a mesh as the row-sharded layers see it, and the
    switch of the region (module docstring)."""

    def __init__(self, mesh):
        self.axis = Axis(mesh, "sp")
        self.enabled = False
        self.param_names: frozenset = frozenset()

    def layout(self, x: torch.Tensor, dim: int = 2) -> Tuple[int, ...]:
        """The row starts of the map whose shard ``x`` holds along
        ``dim`` (``split_rows`` of its height), checked against every
        rank's count."""
        heights = row_heights(x.shape[dim], self.axis, x.device)
        starts = split_rows(sum(heights), self.axis.size)
        if any(starts[i + 1] - starts[i] != h
               for i, h in enumerate(heights)):
            raise RuntimeError(f"row shards {heights} are not the split "
                               f"of {sum(heights)} rows over "
                               f"{self.axis.size}")
        return starts

    @contextlib.contextmanager
    def region(self, enabled: bool) -> Iterator[None]:
        before = self.enabled
        self.enabled = enabled
        try:
            yield
        finally:
            self.enabled = before


def active(rows: Optional[Rows]) -> bool:
    return rows is not None and rows.enabled


def _computed(c0: int, c1: int, n: int) -> Tuple[int, int]:
    """The output rows a rank computes for its own ``[c0, c1)`` of ``n``:
    at least one, so that a rank that owns none still takes part."""
    if c1 > c0:
        return c0, c1
    c0 = min(c0, n - 1)
    return c0, c0 + 1


def _rows_op(x: torch.Tensor, rows: Rows, out_rows: Callable[[int], int],
             need: Callable[[int, int], Tuple[int, int]], fill: float,
             op: Callable[[torch.Tensor, int, int, int], torch.Tensor]
             ) -> torch.Tensor:
    """This rank's output rows of a layer on the row-sharded ``x`` (N, C,
    h, W). ``out_rows(H)`` is the layer's output height, ``need(c0, c1)``
    the input rows ``[a, b)`` that output rows ``[c0, c1)`` read,
    ``op(window, a, c0, c1)`` those output rows from the input rows
    ``[a, b)`` (``fill`` past the edges)."""
    starts = rows.layout(x)
    H = starts[-1]
    Ho = out_rows(H)
    size = rows.axis.size
    out = split_rows(Ho, size)
    depth = 0
    for q in range(size):
        a, b = need(*_computed(out[q], out[q + 1], Ho))
        depth = max(depth, starts[q] - max(a, 0), min(b, H) - starts[q + 1])
    o0, o1 = out[rows.axis.rank], out[rows.axis.rank + 1]
    c0, c1 = _computed(o0, o1, Ho)
    a, b = need(c0, c1)
    window = halo_rows(x, starts, a, b, depth, fill, rows.axis)
    y = op(window, a, c0, c1)
    return y.narrow(2, o0 - c0, o1 - o0)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride, padding, dilation,
           groups: int, rows: Optional[Rows]) -> torch.Tensor:
    """``F.conv2d``; in the sp region, on this rank's rows."""
    if not active(rows):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    s, p, d = stride[0], padding[0], dilation[0]
    keff = d * (weight.shape[2] - 1) + 1
    if (s, p, keff) == (1, 0, 1):
        # pointwise in rows; a shard of no rows convolves a row of zeros
        # (F.conv2d takes no empty input) and keeps none of it
        h = x.shape[2]
        if h == 0:
            x = torch.cat([x, x.new_zeros(x.shape[:2] + (1,)
                                          + x.shape[3:])], 2)
        return F.conv2d(x, weight, bias, stride, padding, dilation,
                        groups).narrow(2, 0, h)
    return _rows_op(
        x, rows, lambda H: (H + 2 * p - keff) // s + 1,
        lambda c0, c1: (c0 * s - p, (c1 - 1) * s - p + keff), 0.0,
        lambda w, a, c0, c1: F.conv2d(w, weight, bias, (s, stride[1]),
                                      (0, padding[1]), dilation, groups))


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int,
               rows: Optional[Rows]) -> torch.Tensor:
    """``F.max_pool2d`` (square, floor mode; padding is ``-inf``, as
    flax's ``nn.max_pool`` with explicit padding); in the sp region, on
    this rank's rows."""
    if not active(rows):
        return F.max_pool2d(x, kernel, stride, padding)
    k, s, p = kernel, stride, padding
    return _rows_op(
        x, rows, lambda H: (H + 2 * p - k) // s + 1,
        lambda c0, c1: (c0 * s - p, (c1 - 1) * s - p + k), float("-inf"),
        lambda w, a, c0, c1: F.max_pool2d(w, k, s, (0, p)))


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], stride, padding,
                     output_padding, groups: int, dilation,
                     rows: Optional[Rows]) -> torch.Tensor:
    """``F.conv_transpose2d``; in the sp region, on this rank's rows:
    output row ``y`` sums input rows ``i`` with ``i s - p + ky = y``."""
    if not active(rows):
        return F.conv_transpose2d(x, weight, bias, stride, padding,
                                  output_padding, groups, dilation)
    s, p, op_, d = stride[0], padding[0], output_padding[0], dilation[0]
    keff = d * (weight.shape[2] - 1) + 1

    def need(c0, c1):
        return -(-(c0 + p - keff + 1) // s), (c1 - 1 + p) // s + 1

    def op(w, a, c0, c1):
        y = F.conv_transpose2d(w, weight, bias, (s, stride[1]),
                               (0, padding[1]), (0, output_padding[1]),
                               groups, dilation)
        return y.narrow(2, c0 - a * s + p, c1 - c0)

    return _rows_op(x, rows, lambda H: (H - 1) * s - 2 * p + keff + op_,
                    need, 0.0, op)


class RowConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` that runs on its rank's rows in the sp region."""

    rows: Optional[Rows] = None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.rows)


class RowConvTranspose2d(nn.ConvTranspose2d):
    """An ``nn.ConvTranspose2d`` that runs on its rank's rows in the sp
    region."""

    rows: Optional[Rows] = None

    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride,
                                self.padding, self.output_padding,
                                self.groups, self.dilation, self.rows)


_ROW_CLASSES = {nn.Conv2d: RowConv2d, nn.ConvTranspose2d: RowConvTranspose2d}


def shard_rows(model: nn.Module, mesh, region: str = "detector"
               ) -> Optional[Rows]:
    """Make the submodule ``region`` of ``model`` the sp region: its
    convolutions become their row-sharded classes and every module there
    with a ``rows`` attribute (the pools, the upsample, the deform-conv
    blocks, the heads, BatchNorm) gets the region's :class:`Rows`. Returns
    it, or None where the mesh's sp axis is 1."""
    rows = Rows(mesh)
    if rows.axis.size == 1:
        return None
    sub = model.get_submodule(region)
    for m in sub.modules():
        if type(m) in _ROW_CLASSES:
            m.__class__ = _ROW_CLASSES[type(m)]
        if hasattr(type(m), "rows"):
            m.rows = rows
    rows.param_names = frozenset(f"{region}.{n}"
                                 for n, _ in sub.named_parameters())
    return rows
