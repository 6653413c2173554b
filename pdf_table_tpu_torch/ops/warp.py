"""Crops sampled on the device from a stack of resident pages (counterpart
of pdf_table_tpu/ops/warp.py).

Two samplers, both bilinear with half-pixel centers, edge clamping and
zeros outside the page, computed in f32:

- :func:`resample_axis_aligned_crops` for axis-aligned boxes (every
  detector rect of the device-box path, every table region): the vertical
  resample as two row gathers, the horizontal one as a batched matmul with
  hat-function weights;
- :func:`warp_crops_from_pages` for rotated quads: a per-pixel homography
  and four corner gathers.

The homographies and the quad bookkeeping are host-side numpy
(:func:`order_points_clockwise_batch`,
:func:`homographies_from_quads_batch`, :func:`quads_axis_aligned`).
These are plain gathers and matmuls that the JAX package computes outside
any Pallas kernel, so they are ``torch`` calls here.

:func:`warp_perspective_batch` samples N crops of one image through
homographies (:func:`order_points_clockwise`, :func:`perspective_matrices`,
the single-quad forms of the batch helpers), as the JAX package's does.

:func:`crop_rotated_boxes` crops quads out of one image: at one size on
the device through :func:`warp_perspective_batch` when ``out_hw`` is
given, else at each crop's natural size on the host, with OpenCV 5.0.0's
perspective arithmetic from ``ops/cv_host.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch


def order_points_clockwise(pts: np.ndarray) -> np.ndarray:
    """Order 4 points as [top-left, top-right, bottom-right, bottom-left]
    (image coordinates, y down): one quad of
    :func:`order_points_clockwise_batch`."""
    return order_points_clockwise_batch(np.reshape(pts, (1, 4, 2)))[0]


def _homography_from_quad(src_quad: np.ndarray, dst_w: float,
                          dst_h: float) -> np.ndarray:
    """3x3 matrix mapping the dst rect (0, 0)-(w, h) onto the src quad (for
    inverse-map sampling): the closed-form projective solve in f64."""
    dst = np.array([[0, 0], [dst_w, 0], [dst_w, dst_h], [0, dst_h]],
                   dtype=np.float64)
    src = np.asarray(src_quad, dtype=np.float64)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        xd, yd = dst[i]
        xs, ys = src[i]
        A[2 * i] = [xd, yd, 1, 0, 0, 0, -xd * xs, -yd * xs]
        b[2 * i] = xs
        A[2 * i + 1] = [0, 0, 0, xd, yd, 1, -xd * ys, -yd * ys]
        b[2 * i + 1] = ys
    try:
        h = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        h = np.linalg.lstsq(A, b, rcond=None)[0]
    return np.array([[h[0], h[1], h[2]], [h[3], h[4], h[5]],
                     [h[6], h[7], 1.0]], dtype=np.float32)


def perspective_matrices(quads: np.ndarray, out_hw: Tuple[int, int]
                         ) -> np.ndarray:
    """(N, 4, 2) clockwise quads -> (N, 3, 3) dst -> src homographies onto
    an ``out_hw`` output."""
    oh, ow = out_hw
    return np.stack([_homography_from_quad(q, ow, oh) for q in quads]) \
        if len(quads) else np.zeros((0, 3, 3), np.float32)


def order_points_clockwise_batch(pts: np.ndarray) -> np.ndarray:
    """(N, 4, 2) -> (N, 4, 2) ordered [tl, tr, br, bl] per quad (image
    coordinates, y down)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 4, 2)
    if not len(pts):
        return pts
    s = pts.sum(axis=2)
    d = pts[:, :, 0] - pts[:, :, 1]
    n = np.arange(len(pts))
    return np.stack([pts[n, np.argmin(s, axis=1)],
                     pts[n, np.argmax(d, axis=1)],
                     pts[n, np.argmax(s, axis=1)],
                     pts[n, np.argmin(d, axis=1)]], axis=1)


def homographies_from_quads_batch(src_quads: np.ndarray,
                                  dst_w: np.ndarray,
                                  dst_h: np.ndarray) -> np.ndarray:
    """Batched closed-form projective solve: (N, 4, 2) quads + per-quad
    dst sizes -> (N, 3, 3) homographies that map the dst rect (0, 0)-(w, h)
    onto the src quad (for inverse-map sampling). One batched 8x8 solve in
    f64, returned as f32."""
    src = np.asarray(src_quads, np.float64).reshape(-1, 4, 2)
    N = len(src)
    if not N:
        return np.zeros((0, 3, 3), np.float32)
    dst_w = np.broadcast_to(np.asarray(dst_w, np.float64), (N,))
    dst_h = np.broadcast_to(np.asarray(dst_h, np.float64), (N,))
    zeros = np.zeros(N)
    dst = np.stack([
        np.stack([zeros, zeros], 1), np.stack([dst_w, zeros], 1),
        np.stack([dst_w, dst_h], 1), np.stack([zeros, dst_h], 1)],
        axis=1)                                              # (N, 4, 2)
    A = np.zeros((N, 8, 8))
    b = np.zeros((N, 8))
    for i in range(4):
        xd, yd = dst[:, i, 0], dst[:, i, 1]
        xs, ys = src[:, i, 0], src[:, i, 1]
        A[:, 2 * i, 0] = xd
        A[:, 2 * i, 1] = yd
        A[:, 2 * i, 2] = 1.0
        A[:, 2 * i, 6] = -xd * xs
        A[:, 2 * i, 7] = -yd * xs
        b[:, 2 * i] = xs
        A[:, 2 * i + 1, 3] = xd
        A[:, 2 * i + 1, 4] = yd
        A[:, 2 * i + 1, 5] = 1.0
        A[:, 2 * i + 1, 6] = -xd * ys
        A[:, 2 * i + 1, 7] = -yd * ys
        b[:, 2 * i + 1] = ys
    try:
        h = np.linalg.solve(A, b[..., None])[..., 0]
    except np.linalg.LinAlgError:
        h = np.stack([np.linalg.lstsq(A[i], b[i], rcond=None)[0]
                      for i in range(N)])
    H = np.concatenate([h, np.ones((N, 1))], axis=1).reshape(N, 3, 3)
    return H.astype(np.float32)


def quads_axis_aligned(quads: np.ndarray, eps: float = 0.75) -> np.ndarray:
    """(N, 4, 2) ordered [tl, tr, br, bl] quads -> (N,) bool: True where
    the quad is an axis-aligned rectangle within ``eps`` px (eligible for
    :func:`resample_axis_aligned_crops`)."""
    q = np.asarray(quads, np.float32).reshape(-1, 4, 2)
    if not len(q):
        return np.zeros((0,), bool)
    return ((np.abs(q[:, 0, 1] - q[:, 1, 1]) <= eps)
            & (np.abs(q[:, 3, 1] - q[:, 2, 1]) <= eps)
            & (np.abs(q[:, 0, 0] - q[:, 3, 0]) <= eps)
            & (np.abs(q[:, 1, 0] - q[:, 2, 0]) <= eps))


def _sample_coords(mats: torch.Tensor, out_hw: Tuple[int, int],
                   dev: torch.device):
    """The output pixel centers ``gx`` (1, 1, ow), ``gy`` (1, oh, 1) and
    their source coordinates ``sx``, ``sy`` (N, oh, ow) through the dst ->
    src homographies ``mats`` (N, 3, 3), in f32."""
    oh, ow = out_hw
    f32 = torch.float32
    gx = (torch.arange(ow, dtype=f32, device=dev) + 0.5)[None, None, :]
    gy = (torch.arange(oh, dtype=f32, device=dev) + 0.5)[None, :, None]
    m = mats.to(device=dev, dtype=f32)[:, :, :, None, None]  # (N, 3, 3, 1, 1)
    # mat @ [gx, gy, 1] as a chain of fused multiply-adds (the second
    # product is added unrounded, through f64), which is how XLA on the CPU
    # sums this 3-term dot (warp_perspective_batch's from three crops on;
    # one crop gets plain f32 sums there); a plain f32 sum moves 4 % of the
    # coordinates by an ulp
    src = ((m[:, :, 0] * gx).double()
           + m[:, :, 1].double() * gy.double()).to(f32) + m[:, :, 2]
    den = src[:, 2].clamp_min(1e-8)
    return gx, gy, src[:, 0] / den - 0.5, src[:, 1] / den - 0.5


def warp_perspective_batch(img: torch.Tensor, mats: torch.Tensor,
                           out_hw: Tuple[int, int]) -> torch.Tensor:
    """Sample N crops from one image: img (H, W, C); mats (N, 3, 3) dst ->
    src. Returns (N, oh, ow, C) float32, zero where the sample point falls
    more than a pixel outside the image; corners outside it are clamped to
    the edge."""
    H, W = img.shape[0], img.shape[1]
    f32 = torch.float32
    _, _, sx, sy = _sample_coords(mats, out_hw, img.device)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0f, sy - y0f
    x0, y0 = x0f.long(), y0f.long()
    valid = (sx >= -1) & (sx <= W) & (sy >= -1) & (sy <= H)
    x0c, x1c = x0.clamp(0, W - 1), (x0 + 1).clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), (y0 + 1).clamp(0, H - 1)
    flat = img.reshape(H * W, -1).to(f32)

    def g(yy, xx, w):
        return flat[yy * W + xx] * w[..., None]

    out = g(y0c, x0c, (1 - wx) * (1 - wy)) + g(y0c, x1c, wx * (1 - wy)) \
        + g(y1c, x0c, (1 - wx) * wy) + g(y1c, x1c, wx * wy)
    return torch.where(valid[..., None], out,
                       torch.zeros((), device=img.device))


def warp_crops_from_pages(pages: torch.Tensor, page_idx: torch.Tensor,
                          mats: torch.Tensor, widths: torch.Tensor,
                          out_hw: Tuple[int, int],
                          heights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Sample N crops through homographies, each from its own page.

    pages (P, H, W, C) uint8 or float; page_idx (N,); mats (N, 3, 3)
    dst -> src homographies; widths (N,) valid output width per crop
    (columns beyond it are zero: the right padding of width-bucketed
    recognition); heights (N,) optional valid output height. Returns
    (N, oh, ow, C) float32."""
    P, H, W, C = pages.shape
    oh, ow = out_hw
    dev = pages.device
    f32 = torch.float32
    n = mats.shape[0]
    gx, gy, sx, sy = _sample_coords(mats, out_hw, dev)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0f, sy - y0f
    x0, y0 = x0f.long(), y0f.long()
    vw = widths.to(f32)[:, None, None]
    vh = torch.full((n, 1, 1), float(oh), dtype=f32, device=dev) \
        if heights is None else heights.to(f32)[:, None, None]
    valid = (sx >= -1) & (sx <= W) & (sy >= -1) & (sy <= H) \
        & (gx - 0.5 < vw) & (gy - 0.5 < vh)
    in_y0 = (y0 >= 0) & (y0 < H)
    in_y1 = (y0 + 1 >= 0) & (y0 + 1 < H)
    in_x0 = (x0 >= 0) & (x0 < W)
    in_x1 = (x0 + 1 >= 0) & (x0 + 1 < W)
    flat = pages.reshape(P * H * W, C)
    base = (page_idx.long() * (H * W))[:, None, None]

    def corner(yy, xx, w, inside):
        # indices wrap modulo H / W; a corner outside the page has weight 0
        g = flat[base + (yy % H) * W + (xx % W)].to(f32)
        return g * (w * inside)[..., None]

    out = corner(y0, x0, (1 - wx) * (1 - wy), in_y0 & in_x0) \
        + corner(y0, x0 + 1, wx * (1 - wy), in_y0 & in_x1) \
        + corner(y0 + 1, x0, (1 - wx) * wy, in_y1 & in_x0) \
        + corner(y0 + 1, x0 + 1, wx * wy, in_y1 & in_x1)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def resample_axis_aligned_crops(pages: torch.Tensor, page_idx: torch.Tensor,
                                boxes: torch.Tensor,
                                out_hw: Tuple[int, int],
                                dst_w: Optional[torch.Tensor] = None,
                                valid_w: Optional[torch.Tensor] = None,
                                valid_h: Optional[torch.Tensor] = None,
                                also_flipped: bool = False
                                ) -> Union[torch.Tensor,
                                           Tuple[torch.Tensor, torch.Tensor]]:
    """The sampler for axis-aligned crops: the vertical bilinear resample
    as two row gathers, the horizontal one as a batched matmul with
    hat-function weights. Same sample points, clamp and mask as
    :func:`warp_crops_from_pages` on axis-aligned quads.

    pages (P, H, W, C); page_idx (N,); boxes (N, 4) [x1, y1, x2, y2] in
    page coordinates; out_hw (oh, ow). ``dst_w`` (N,) is the horizontal
    extent of the output that the box maps onto (default ``ow``;
    recognition maps each box onto its own aspect-preserving width).
    ``valid_w``/``valid_h`` (N,) zero the output right of / below the
    content (default: nothing). Returns (N, oh, ow, C) float32.

    ``also_flipped=True`` returns ``(crops, flipped)``: the second is the
    crop rotated by 180 degrees, its content realigned to [0, valid_w). Its
    sample rows are the forward crop's rows in reverse, so it shares the
    row gathers and costs one more matmul. It assumes full-height content,
    so it is rejected together with ``valid_h``."""
    if also_flipped and valid_h is not None:
        raise ValueError(
            "also_flipped=True assumes full-height content; pass "
            "valid_h=None (the flipped realign only covers the width axis)")
    P, H, W, C = pages.shape
    oh, ow = out_hw
    n = boxes.shape[0]
    dev = pages.device
    f32 = torch.float32
    x1, y1, x2, y2 = boxes.to(f32).unbind(1)

    def coords(start, centers, step, sign=1.0):
        """``start +- centers * step - 0.5`` with the multiply-add rounded
        once (computed in f64), as a fused multiply-add gives it and as
        XLA compiles the JAX function's expression."""
        fused = start.double()[:, None] + sign * (
            centers.double()[None, :] * step.double()[:, None])
        return fused.to(f32) - 0.5

    # vertical: sy maps the full oh range onto [y1, y2]. A constant
    # divisor (oh, and ow without dst_w) is a multiplication by its f32
    # reciprocal, which is what XLA makes of it
    r = torch.arange(oh, dtype=f32, device=dev) + 0.5
    sy = coords(y1, r, (y2 - y1) * (1.0 / oh))
    y0 = torch.floor(sy).long()
    wy = sy - y0
    in_y0 = (y0 >= 0) & (y0 < H)
    in_y1 = (y0 + 1 >= 0) & (y0 + 1 < H)
    rows_tbl = pages.reshape(P * H, W * C)
    base = (page_idx.long() * H)[:, None]
    g0 = rows_tbl[base + y0.clamp(0, H - 1)].to(f32)         # (N, oh, W*C)
    g1 = rows_tbl[base + (y0 + 1).clamp(0, H - 1)].to(f32)
    w0 = ((1.0 - wy) * in_y0)[..., None]
    w1 = (wy * in_y1)[..., None]
    rows = (g0 * w0 + g1 * w1).reshape(n, oh, W, C)
    del g0, g1

    # horizontal: hat-function weights are bilinear interpolation with edge
    # clamping, as one matmul per crop
    j = torch.arange(ow, dtype=f32, device=dev) + 0.5
    step = (x2 - x1) * (1.0 / ow) if dst_w is None \
        else (x2 - x1) / dst_w.to(f32)
    s = torch.arange(W, dtype=f32, device=dev)
    vy = ((sy >= -1) & (sy <= H))[:, :, None, None]
    col = torch.arange(ow, device=dev)[None, :]
    mask = torch.ones((n, 1, ow, 1), dtype=torch.bool, device=dev) \
        if valid_w is None else (col < valid_w[:, None])[:, None, :, None]
    if valid_h is not None:
        mask = mask & (torch.arange(oh, device=dev)[None, :]
                       < valid_h[:, None])[:, :, None, None]

    def across(rows, sx, vy):
        wx = torch.clamp(1.0 - torch.abs(sx[:, None, :] - s[None, :, None]),
                         min=0.0)                            # (N, W, ow)
        out = torch.einsum("nrwc,nwj->nrjc", rows, wx)       # (N, oh, ow, C)
        vx = ((sx >= -1) & (sx <= W))[:, None, :, None]
        return torch.where(mask & vy & vx, out, torch.zeros_like(out))

    out = across(rows, coords(x1, j, step), vy)
    if not also_flipped:
        return out
    # rotated by 180 degrees: sample x runs x2 -> x1 over the same dst
    # extent, and the rows are the forward rows reversed
    return out, across(rows.flip(1), coords(x2, j, step, -1.0), vy.flip(1))


def crop_rotated_boxes(img: np.ndarray, quads: np.ndarray,
                       out_hw: Optional[Tuple[int, int]] = None,
                       device=None) -> Union[List[np.ndarray], torch.Tensor]:
    """Crops of text quads out of one page image.

    With ``out_hw`` every crop samples to that size on ``device`` (cuda
    unless ``"cpu"``) through :func:`warp_perspective_batch`: an (N, oh,
    ow, C) f32 tensor. With ``out_hw=None`` each crop keeps its natural
    size on the host: an axis-aligned quad is sliced out, a rotated one
    warped onto its own width and height with :func:`perspective_transform`
    and :func:`warp_perspective_u8` (a list of numpy arrays)."""
    if out_hw is not None:
        from ..engine.device import resolve_device

        dev = resolve_device(device)
        if len(quads) == 0:
            return torch.zeros((0, out_hw[0], out_hw[1], img.shape[-1]),
                               dtype=torch.float32, device=dev)
        ordered = np.stack([order_points_clockwise(q) for q in quads])
        mats = perspective_matrices(ordered, out_hw)
        return warp_perspective_batch(torch.as_tensor(img).to(dev),
                                      torch.as_tensor(mats).to(dev), out_hw)

    from .cv_host import perspective_transform, warp_perspective_u8

    H, W = img.shape[:2]
    q = np.asarray(quads, np.float32).reshape(-1, 4, 2)
    if not len(q):
        return []
    crops = []
    for o in order_points_clockwise_batch(q):
        w = int(round(max(np.linalg.norm(o[0] - o[1]),
                          np.linalg.norm(o[3] - o[2]))))
        h = int(round(max(np.linalg.norm(o[0] - o[3]),
                          np.linalg.norm(o[1] - o[2]))))
        w, h = max(w, 1), max(h, 1)
        xs, ys = o[:, 0], o[:, 1]
        if abs(ys[0] - ys[1]) < 1.0 and abs(xs[1] - xs[2]) < 1.0 \
                and abs(ys[2] - ys[3]) < 1.0:
            x1 = int(np.clip(np.floor(xs.min()), 0, W - 1))
            y1 = int(np.clip(np.floor(ys.min()), 0, H - 1))
            x2 = int(np.clip(np.ceil(xs.max()), x1 + 1, W))
            y2 = int(np.clip(np.ceil(ys.max()), y1 + 1, H))
            crops.append(np.ascontiguousarray(img[y1:y2, x1:x2]))
        else:
            dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1],
                            [0, h - 1]], np.float32)
            m = perspective_transform(o.astype(np.float32), dst)
            crops.append(warp_perspective_u8(img, m, (w, h)))
    return crops
