"""Device connected components + per-component boxes for the DB detector
(counterpart of pdf_table_tpu/ops/connected_components.py).

Plain PyTorch: the JAX package computes these in XLA, not Pallas. Labels
follow the JAX contract exactly (0 = background, a component's label is
its min flat index + 1), and so do the packed box rows, slot order
included. :func:`connected_components` is the JAX op's label propagation
on one (H, W) map; the rest take a batch of maps, (N, H, W), and the
labelling of one map is the same with or without the batch dimension
(:func:`component_boxes` also takes one map, as the JAX op does).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# propagation steps between the host's looks at the labels
CHECK_EVERY = 16


def _run_min(vals: torch.Tensor, mask: torch.Tensor, dim: int, span: int
             ) -> torch.Tensor:
    """Min over each contiguous True-run of ``mask`` along ``dim``,
    broadcast back to every member; off-mask elements keep their value.

    A segment starts wherever the element or its predecessor is off the
    mask. Offsetting each segment by ``seg * span`` (``span`` above every
    value of ``vals``, which are >= 0) keeps a running ``cummin`` from
    reaching into another segment: forward it gives the prefix min within
    the segment, backward over that the segment's min."""
    first = torch.zeros_like(mask)
    first.narrow(dim, 0, 1).fill_(True)
    start = first | ~(mask & mask.roll(1, dim))
    seg = start.to(torch.int64).cumsum(dim)
    v = vals.to(torch.int64)
    off = seg * span
    fwd = (v - off).cummin(dim).values + off
    bwd = (fwd.flip(dim) + off.flip(dim)).cummin(dim).values - off.flip(dim)
    return bwd.flip(dim).to(vals.dtype)


def _neighbour_min(labels: torch.Tensor, big: int) -> torch.Tensor:
    """Min over each pixel's 8 neighbours, ``big`` outside the map."""
    p = F.pad(labels, (1, 1, 1, 1), value=big)
    nb = torch.minimum(torch.minimum(p[..., :-2, 1:-1], p[..., 2:, 1:-1]),
                       torch.minimum(p[..., 1:-1, :-2], p[..., 1:-1, 2:]))
    return torch.minimum(nb, torch.minimum(
        torch.minimum(p[..., :-2, :-2], p[..., :-2, 2:]),
        torch.minimum(p[..., 2:, :-2], p[..., 2:, 2:])))


def connected_components(mask: torch.Tensor, max_iters: int = 4096
                         ) -> torch.Tensor:
    """mask (H, W) bool -> int32 labels (H, W): 0 = background, each
    component labelled by its min flat index + 1. Label propagation, as in
    the JAX op: each iteration takes the min over every pixel's 8
    neighbours, until an iteration changes nothing or after ``max_iters``.
    The iterations run without a host sync; every ``CHECK_EVERY`` of them
    the loop ends if they changed nothing (once converged an iteration is
    the identity, so the labels are the JAX op's). The detection lane runs
    the batched :func:`connected_components_scan` instead."""
    H, W = mask.shape
    idx = (torch.arange(H * W, dtype=torch.int32, device=mask.device) + 1) \
        .reshape(H, W)
    big = H * W + 2
    labels = torch.where(mask, idx, 0)
    done = 0
    while done < max_iters:
        prev = labels
        for _ in range(min(CHECK_EVERY, max_iters - done)):
            l = torch.where(mask, labels, big)
            labels = torch.where(
                mask, torch.minimum(l, _neighbour_min(l, big)), 0)
        done += min(CHECK_EVERY, max_iters - done)
        if torch.equal(labels, prev):
            break
    return labels


def connected_components_scan(mask: torch.Tensor,
                              num_iters: int = 8) -> torch.Tensor:
    """mask (..., H, W) bool -> int32 labels: 0 = background, each
    component labelled by its min flat index + 1. Each of ``num_iters``
    rounds takes the run minima along rows, then columns, then one
    8-neighbour min (diagonal touches); k rounds resolve any shape whose
    pixels reach the component's min through <= k alternations of
    horizontal and vertical runs, as in the JAX op."""
    H, W = mask.shape[-2:]
    idx = (torch.arange(H * W, dtype=torch.int32, device=mask.device) + 1) \
        .reshape(H, W)
    big = H * W + 2
    labels = torch.where(mask, idx, big)
    for _ in range(num_iters):
        labels = _run_min(labels, mask, -1, big + 1)
        labels = _run_min(labels, mask, -2, big + 1)
        labels = torch.where(
            mask, torch.minimum(labels, _neighbour_min(labels, big)), big)
    return torch.where(mask, labels, 0)


def component_boxes(labels: torch.Tensor, scores: torch.Tensor,
                    max_components: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Per-component bbox + mean score + area for the ``max_components``
    largest label ids (not areas), in descending id order.

    labels (N, H, W) int32, scores (N, H, W) float. Returns boxes (N, K, 4)
    f32 xyxy (x1, y1 exclusive), means (N, K) f32, areas (N, K) int32 and
    valid (N, K) bool; a slot past the last component has area 0 and the
    box (W, H, 0, 0). One (H, W) map, as the JAX op takes, gives the same
    without the N axis."""
    if labels.dim() == 2:
        return tuple(t[0] for t in component_boxes(
            labels[None], scores[None], max_components))
    N, H, W = labels.shape
    dev = labels.device
    flat = labels.reshape(N, H * W)
    present = torch.clamp(flat, min=0)
    srt = present.sort(dim=1).values
    is_new = torch.cat([srt[:, :1] > 0,
                        (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] > 0)], 1)
    uniq = torch.where(is_new, srt, 0) \
        .topk(max_components, dim=1).values              # (N, K)
    ys = torch.arange(H, device=dev, dtype=torch.int32) \
        .repeat_interleave(W)
    xs = torch.arange(W, device=dev, dtype=torch.int32).repeat(H)
    m = (flat[:, None, :] == uniq[:, :, None]) & (uniq[:, :, None] > 0)
    cnt = m.sum(-1, dtype=torch.int32)
    x0 = torch.where(m, xs, W).amin(-1)
    y0 = torch.where(m, ys, H).amin(-1)
    x1 = torch.where(m, xs, -1).amax(-1)
    y1 = torch.where(m, ys, -1).amax(-1)
    sc = scores.reshape(N, 1, H * W).to(torch.float32)
    means = torch.where(m, sc, 0.0).sum(-1) / cnt.clamp(min=1)
    boxes = torch.stack([x0, y0, x1 + 1, y1 + 1], -1).to(torch.float32)
    return boxes, means, cnt, cnt > 0


def batch_component_boxes_u8(probs_u8: torch.Tensor, thresh_u8: int,
                             valid_hw: torch.Tensor,
                             max_components: int = 64,
                             num_iters: int = 8) -> torch.Tensor:
    """probs_u8 (N, H, W) uint8, valid_hw (N, 2) int per-page real extents
    -> (N, K, 6) f32 rows [x0, y0, x1, y1, mean_prob, area]; area 0 marks
    an empty slot.

    Labels on a 2x2 max-pool of the map (pixels above ``thresh_u8`` inside
    the pooled valid extent); boxes come back scaled x2 and areas x4 into
    the map's coordinates, the mean over the pooled values / 255."""
    N, H, W = probs_u8.shape
    ph, pw = H // 2, W // 2
    pooled = probs_u8[:, :ph * 2, :pw * 2].reshape(N, ph, 2, pw, 2) \
        .amax(dim=(2, 4))
    dev = probs_u8.device
    yy = torch.arange(ph, device=dev)[None, :, None]
    xx = torch.arange(pw, device=dev)[None, None, :]
    vhw = valid_hw.to(device=dev, dtype=torch.int64)
    mask = (pooled > thresh_u8) \
        & (yy < ((vhw[:, 0] + 1) // 2)[:, None, None]) \
        & (xx < ((vhw[:, 1] + 1) // 2)[:, None, None])
    labels = connected_components_scan(mask, num_iters=num_iters)
    boxes, means, areas, _valid = component_boxes(
        labels, pooled.to(torch.float32) / 255.0, max_components)
    return torch.cat([boxes * 2.0, means[..., None],
                      (areas * 4)[..., None].to(torch.float32)], dim=-1)
