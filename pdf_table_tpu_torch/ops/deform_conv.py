"""Modulated deformable convolution v2 (counterpart of
pdf_table_tpu/ops/deform_conv.py).

``deform_conv2d`` keeps the JAX signature and layouts: x NHWC, offset
(B, Ho, Wo, 2K) in (dy, dx) pairs, mask (B, Ho, Wo, K) post-sigmoid,
weight (Kh, Kw, Cin, Cout), f32 output. On a CPU tensor it runs
:func:`deform_conv2d_plain`. On a CUDA tensor it takes the route the JAX
package takes on a TPU (:func:`flat_kc_route`). Both routes launch the
one kernel of ``ops/kernels/csrc/deform_conv.cu`` (gather, blend and
contraction in one pass), which differ only in where they round to bf16:

- where JAX runs the tap-major kernel, or leaves the back half to XLA,
  :func:`deform_conv2d_tap` runs its tap mode (K1): the blended column
  rounded once;
- where JAX chunks the taps and sends every chunk to the flat-kc kernel,
  :func:`deform_conv2d_chunked` runs its flat-kc mode (K2): each corner's
  bf16 product, as the TPU kernel rounds it; its plain twin is
  :func:`deform_conv2d_chunked_plain`.

f32 tensors take the tap mode's f32 body: the column unrounded, the
contraction on the tensor cores by the 3xTF32 split (:func:`split_tf32`);
its plain twin at those rounding points is
:func:`deform_conv2d_3xtf32_plain`.

Each kernel raises on what it does not take.

Every function here takes a row window, ``h0`` and ``ho``: it computes
output rows ``[h0, h0 + ho)`` of the DCN over the whole ``x``, the offsets
and mask holding those rows only (the default: every row). A row-sharded
caller (``parallel/spatial.py``) gives each rank its own rows this way. The
window moves the sample grid, ``(h0 + oy) * stride - pad``, in integers,
so a window's rows are bit for bit the whole call's; the origin is never
folded into the offsets, which would round where they are not integers.

On a CUDA tensor both modes run inside :class:`DeformConv2dFunction`
(which records no graph under ``no_grad``), whose backward is
:func:`deform_conv2d_backward_plain` in plain PyTorch (JAX computes the
custom VJPs of ``deform_blend.py`` in XLA too: ``_tap_bwd`` :243,
``_bwd`` :125).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.flops import hand_counted
from .blend_matmul import blend_matmul_plain
from .kernels import launch_columns, launch_counts

Pair = Tuple[int, int]
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))   # (dy, dx) of the 4 corners

# the JAX route's constants (ops/deform_conv.py:103,127 and
# ops/pallas/deform_blend.py:53,281,314,342)
GATHER_BUDGET = 1.5e9          # bytes of gathered corner rows per chunk
TILE_ROWS = 256                # flat-kc kernel row tile
VMEM_BUDGET = 12 * 1024 * 1024
FLAT_KC_MAX = 2304             # the flat-kc kernel's auto region


def _out_hw(H: int, W: int, Kh: int, Kw: int, stride: Pair, padding: Pair,
            dilation: Pair) -> Tuple[int, int]:
    Ho = (H + 2 * padding[0] - dilation[0] * (Kh - 1) - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * (Kw - 1) - 1) // stride[1] + 1
    return Ho, Wo


def _window_hw(H: int, W: int, Kh: int, Kw: int, stride: Pair,
               padding: Pair, dilation: Pair, h0: int = 0,
               ho: Optional[int] = None) -> Tuple[int, int]:
    """(rows, Wo) of the output row window ``[h0, h0 + ho)`` (``ho=None``:
    to the last row), which must lie inside the DCN's output."""
    Ho, Wo = _out_hw(H, W, Kh, Kw, stride, padding, dilation)
    if ho is None:
        ho = Ho - h0
    if h0 < 0 or ho < 0 or h0 + ho > Ho:
        raise ValueError(f"row window [{h0}, {h0 + ho}) outside the "
                         f"output's {Ho} rows")
    return ho, Wo


# ---------------------------------------------------------------------------
# the route, as pure functions of shapes (copies of the JAX predicates
# without their backend test and environment switches)
# ---------------------------------------------------------------------------


def dcn_flops(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride: Pair = (1, 1), padding: Pair = (1, 1),
              dilation: Pair = (1, 1), *_, h0: int = 0,
              ho: Optional[int] = None, **__) -> int:
    """The DCN's model FLOPs, ``2·B·Ho·Wo·K·Cin·Cout`` over the row
    window's ``Ho``: one product over ``K·Cin`` per output, whatever route
    computes it (``utils/flops.py``)."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    return 2 * B * Ho * Wo * Kh * Kw * Cin * Cout


def gather_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype corner rows are gathered in: bf16/f16 as is, else f32."""
    return dtype if dtype in (torch.bfloat16, torch.float16) \
        else torch.float32


def row_tile(hw: int, cap: int = 512) -> int:
    """Largest multiple-of-8 divisor of hw, capped; 0 when none."""
    best = 0
    for t in range(8, min(hw, cap) + 1, 8):
        if hw % t == 0:
            best = t
    return best


def _tap_vmem_fits(tile: int, c4: int, co: int) -> bool:
    need = (2 * (tile * c4 * 2) + 2 * (tile * 128 * 2) + 8 * c4 * 2
            + 2 * (c4 * co * 2) + tile * co * 4)
    return need <= VMEM_BUDGET


def blend_tap_supported(b: int, hw: int, k: int, c4: int, co: int,
                        dtype: torch.dtype) -> int:
    """Row tile of the tap-major TPU kernel where it applies, else 0."""
    if dtype != torch.bfloat16 or c4 % 128 != 0:
        return 0
    tile = row_tile(hw)
    if tile < 128 or not _tap_vmem_fits(tile, c4, co):
        return 0
    return tile


def _vmem_fits(kc: int, co: int) -> bool:
    need = (2 * (TILE_ROWS * kc * 2) + 2 * (TILE_ROWS * 128 * 2)
            + 128 * kc * 2 + kc * co * 2 + 2 * TILE_ROWS * co * 4)
    return need <= VMEM_BUDGET


def blend_matmul_supported(np_: int, kc: int, co: int,
                           dtype: torch.dtype) -> bool:
    """Whether JAX sends a tap chunk's back half to the flat-kc kernel
    (its auto mode)."""
    return (dtype == torch.bfloat16 and np_ % TILE_ROWS == 0
            and kc % 128 == 0 and co >= 1 and _vmem_fits(kc, co)
            and kc <= FLAT_KC_MAX)


def tap_chunk_size(b: int, ho: int, wo: int, cin: int, k: int,
                   dtype: torch.dtype) -> int:
    """Taps per chunk: as many as keep the gathered rows under the
    budget, at least 1."""
    bytes_per_tap = b * ho * wo * 4 * cin * gather_dtype(dtype).itemsize
    return max(1, min(k, int(GATHER_BUDGET // max(bytes_per_tap, 1))))


def flat_kc_route(b: int, ho: int, wo: int, cin: int, k: int, cout: int,
                  dtype: torch.dtype) -> bool:
    """Whether the JAX package, on a TPU, chunks this DCN's taps and sends
    every chunk's back half to the flat-kc kernel (rather than running the
    tap-major kernel or leaving the back half to XLA)."""
    gdt = gather_dtype(dtype)
    bytes_per_tap = b * ho * wo * 4 * cin * gdt.itemsize
    if bytes_per_tap * k <= GATHER_BUDGET and blend_tap_supported(
            b, ho * wo, k, 4 * cin, cout, gdt):
        return False
    chunk = tap_chunk_size(b, ho, wo, cin, k, dtype)
    np_ = b * ho * wo
    return all(blend_matmul_supported(np_,
                                      (min(t0 + chunk, k) - t0) * 4 * cin,
                                      cout, gdt)
               for t0 in range(0, k, chunk))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _sample_points(offset: torch.Tensor, Ho: int, Wo: int, Kh: int, Kw: int,
                   stride: Pair, padding: Pair, dilation: Pair,
                   dtype: torch.dtype = torch.float32, h0: int = 0):
    """Sample coordinates (sy, sx), each (B, Ho, Wo, K) in ``dtype``, of
    output rows ``[h0, h0 + Ho)``."""
    B = offset.shape[0]
    K = Kh * Kw
    dev = offset.device
    f32 = dtype
    oy = (torch.arange(Ho, device=dev, dtype=f32) + h0) * stride[0] \
        - padding[0]
    ox = torch.arange(Wo, device=dev, dtype=f32) * stride[1] - padding[1]
    ky = torch.arange(Kh, device=dev, dtype=f32) * dilation[0]
    kx = torch.arange(Kw, device=dev, dtype=f32) * dilation[1]
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]) \
        .expand(Ho, Wo, Kh, Kw).reshape(Ho, Wo, K)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]) \
        .expand(Ho, Wo, Kh, Kw).reshape(Ho, Wo, K)
    off = offset.reshape(B, Ho, Wo, K, 2).to(f32)
    return base_y + off[..., 0], base_x + off[..., 1]


def tap_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                kernel_size: Pair, stride: Pair = (1, 1),
                padding: Pair = (1, 1), dilation: Pair = (1, 1),
                h0: int = 0, ho: Optional[int] = None):
    """Each tap's blended column, (B*Ho*Wo, Cin) f32, in tap order: the four
    bilinear corners gathered with their own in-bounds masks (zero outside
    the image) and summed in f32 with weight ((lerp_y * lerp_x) *
    in_bounds) * mask. For bf16 x the column is rounded to bf16 once, as
    the tap kernel's tensor-core operand is."""
    B, H, W, Cin = x.shape
    Kh, Kw = kernel_size
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    f32 = torch.float32
    sy, sx = _sample_points(offset, Ho, Wo, Kh, Kw, stride, padding,
                            dilation, h0=h0)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    yi = y0.long()
    xi = x0.long()
    m = mask.to(f32)
    xf = x.reshape(B, H * W, Cin)
    for t in range(Kh * Kw):
        col = torch.zeros(B, Ho * Wo, Cin, device=x.device, dtype=f32)
        for dy, dx in _CORNERS:
            yy = yi[..., t] + dy
            xx = xi[..., t] + dx
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            w = (wy[..., t] if dy else 1 - wy[..., t]) \
                * (wx[..., t] if dx else 1 - wx[..., t]) * ok * m[..., t]
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)) \
                .reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, Cin)
            col += torch.gather(xf, 1, idx).to(f32) \
                * w.reshape(B, Ho * Wo, 1)
        if x.dtype == torch.bfloat16:
            col = col.to(x.dtype).to(f32)
        yield col.reshape(B * Ho * Wo, Cin)


@hand_counted(dcn_flops)
def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        stride: Pair = (1, 1), padding: Pair = (1, 1),
                        dilation: Pair = (1, 1), h0: int = 0,
                        ho: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch DCNv2: each tap's column (:func:`tap_columns`, bf16
    for bf16 x) contracted with ``W[t]`` in f32, plus the bias."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    f32 = torch.float32
    wmat = weight.to(f32).reshape(Kh * Kw, Cin, Cout)
    out = torch.zeros(B * Ho * Wo, Cout, device=x.device, dtype=f32)
    for t, col in enumerate(tap_columns(x, offset, mask, (Kh, Kw), stride,
                                        padding, dilation, h0, Ho)):
        out += col @ wmat[t]
    out = out.reshape(B, Ho, Wo, Cout)
    if bias is not None:
        out = out + bias.to(f32)
    return out


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of an f32 tensor as the f32 kernel body splits its
    operands: ``hi`` is ``t`` rounded to TF32 (10 mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` with the low 13 bits
    cleared; ``lo`` is ``t - hi`` (exact in f32) rounded the same way. On the
    bit pattern: add 0x1000, clear the low 13 bits."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    t = t.to(torch.float32)
    hi = rna(t)
    return hi, rna(t - hi)


@hand_counted(dcn_flops)
def deform_conv2d_3xtf32_plain(x: torch.Tensor, offset: torch.Tensor,
                               mask: torch.Tensor, weight: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               stride: Pair = (1, 1), padding: Pair = (1, 1),
                               dilation: Pair = (1, 1), h0: int = 0,
                               ho: Optional[int] = None) -> torch.Tensor:
    """The f32 DCN at the f32 kernel body's rounding points: each tap's f32
    column (:func:`tap_columns`) and ``W[t]`` split by :func:`split_tf32`,
    and ``col_lo @ W_hi + col_hi @ W_lo + col_hi @ W_hi`` summed in f32
    (the 3xTF32 split; ``col_lo @ W_lo`` is dropped), plus the bias."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    f32 = torch.float32
    w_hi, w_lo = split_tf32(weight.reshape(Kh * Kw, Cin, Cout))
    out = torch.zeros(B * Ho * Wo, Cout, device=x.device, dtype=f32)
    for t, col in enumerate(tap_columns(x.to(f32), offset, mask, (Kh, Kw),
                                        stride, padding, dilation, h0, Ho)):
        c_hi, c_lo = split_tf32(col)
        out += c_lo @ w_hi[t] + c_hi @ w_lo[t] + c_hi @ w_hi[t]
    out = out.reshape(B, Ho, Wo, Cout)
    if bias is not None:
        out = out + bias.to(f32)
    return out


@hand_counted(dcn_flops)
def deform_conv2d_rounded(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: Pair = (1, 1), padding: Pair = (1, 1),
                          dilation: Pair = (1, 1),
                          flat_kc: bool = False) -> torch.Tensor:
    """The DCN in x's dtype (f64 for a reference) with the kernel's bf16
    roundings written out as casts: the column in tap mode (K1); each
    corner weight and each corner's product in flat-kc mode (K2). Autograd
    of a cast rounds the gradient at the same point, so autograd of this
    function rounds where :func:`deform_conv2d_backward_plain` claims to
    (``dcol``; the corner weights' gradients in flat-kc mode). On dyadic
    inputs, whose sums at those points are exact in f32, the two agree to
    f32 round-off."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _out_hw(H, W, Kh, Kw, stride, padding, dilation)
    dt = x.dtype

    def rnd(t):
        return t.to(torch.bfloat16).to(dt)

    sy, sx = _sample_points(offset.to(dt), Ho, Wo, Kh, Kw, stride, padding,
                            dilation, dt)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    yi, xi = y0.long(), x0.long()
    bi = torch.arange(B, device=x.device).reshape(B, 1, 1)
    m = mask.to(dt)
    out = torch.zeros(B, Ho, Wo, Cout, device=x.device, dtype=dt)
    for t in range(Kh * Kw):
        col = 0
        for dy, dx in _CORNERS:
            yy, xx = yi[..., t] + dy, xi[..., t] + dx
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            w = (wy[..., t] if dy else 1 - wy[..., t]) \
                * (wx[..., t] if dx else 1 - wx[..., t]) * ok * m[..., t]
            rows = x[bi, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
            col = col + (rnd(rows * rnd(w)[..., None]) if flat_kc
                         else rows * w[..., None])
        if not flat_kc:
            col = rnd(col)
        out = out + col @ weight[t // Kw, t % Kw].to(dt)
    return out if bias is None else out + bias.to(dt)


# ---------------------------------------------------------------------------
# the tap-chunk branch (JAX ops/deform_conv.py:88-97, 161-203)
# ---------------------------------------------------------------------------


def flat_kc_chunks(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   weight: torch.Tensor, stride: Pair = (1, 1),
                   padding: Pair = (1, 1), dilation: Pair = (1, 1),
                   tap_chunk: Optional[int] = None, h0: int = 0,
                   ho: Optional[int] = None):
    """The flat-kc back half's operands, ``tap_chunk`` taps at a time
    (default: :func:`tap_chunk_size`), as JAX's chunk branch builds them:
    per chunk ``(g2, w4, wrep)`` for :func:`blend_matmul_plain`. The 2x2
    neighbourhood is stacked along the channels (``xq``, wrapping at the
    far edges; each corner carries its own in-bounds mask), each chunk's
    rows are gathered in the gather dtype, ``w4 = ((lerp_y * lerp_x) *
    in_bounds) * mask`` is rounded to it, and ``wrep`` replicates each
    tap's weights over the 4 corners."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    K = Kh * Kw
    sy, sx = _sample_points(offset, Ho, Wo, Kh, Kw, stride, padding,
                            dilation, h0=h0)
    gdt = gather_dtype(x.dtype)
    xg = x.to(gdt)
    xr = torch.roll(xg, -1, dims=2)                      # (y,   x+1)
    xq = torch.cat([xg, xr, torch.roll(xg, -1, dims=1),  # (y+1, x)
                    torch.roll(xr, -1, dims=1)],         # (y+1, x+1)
                   dim=-1).reshape(B * H * W, 4 * Cin)
    m = mask.to(torch.float32)
    wmat = weight.to(torch.float32).reshape(K, Cin, Cout)
    if tap_chunk is None:
        tap_chunk = tap_chunk_size(B, Ho, Wo, Cin, K, x.dtype)
    np_ = B * Ho * Wo
    row0 = (torch.arange(B, device=x.device) * (H * W)).reshape(B, 1, 1, 1)
    for t0 in range(0, K, tap_chunk):
        t1 = min(t0 + tap_chunk, K)
        T = t1 - t0
        syk, sxk = sy[..., t0:t1], sx[..., t0:t1]       # (B, Ho, Wo, T)
        y0 = torch.floor(syk)
        x0 = torch.floor(sxk)
        wy = syk - y0
        wx = sxk - x0
        yi = y0.long()
        xi = x0.long()
        rows = (yi % H) * W + (xi % W) + row0
        in_y0 = (yi >= 0) & (yi < H)
        in_y1 = (yi + 1 >= 0) & (yi + 1 < H)
        in_x0 = (xi >= 0) & (xi < W)
        in_x1 = (xi + 1 >= 0) & (xi + 1 < W)
        w4 = torch.stack(
            [(1 - wy) * (1 - wx) * (in_y0 & in_x0),
             (1 - wy) * wx * (in_y0 & in_x1),
             wy * (1 - wx) * (in_y1 & in_x0),
             wy * wx * (in_y1 & in_x1)], dim=-1)       # (B, Ho, Wo, T, 4)
        w4 = w4 * m[..., t0:t1, None]
        g2 = xq.index_select(0, rows.reshape(-1)).reshape(np_, T * 4 * Cin)
        w4s = w4.reshape(np_, T * 4).to(gdt)
        wrep = wmat[t0:t1].reshape(T, 1, Cin, Cout) \
            .expand(T, 4, Cin, Cout).reshape(T * 4 * Cin, Cout).to(gdt)
        yield g2, w4s, wrep


@hand_counted(dcn_flops)
def deform_conv2d_chunked_plain(x: torch.Tensor, offset: torch.Tensor,
                                mask: torch.Tensor, weight: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                stride: Pair = (1, 1), padding: Pair = (1, 1),
                                dilation: Pair = (1, 1),
                                tap_chunk: Optional[int] = None,
                                h0: int = 0, ho: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain version of the flat-kc route (the kernel's flat-kc mode): the
    chunks of :func:`flat_kc_chunks` through :func:`blend_matmul_plain`,
    summed in f32, plus the bias."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    out = torch.zeros(B * Ho * Wo, Cout, device=x.device,
                      dtype=torch.float32)
    for g2, w4s, wrep in flat_kc_chunks(x, offset, mask, weight, stride,
                                        padding, dilation, tap_chunk, h0,
                                        Ho):
        out += blend_matmul_plain(g2, w4s, wrep, Cin)
    out = out.reshape(B, Ho, Wo, Cout)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# the kernel: tap mode (K1) and flat-kc mode (K2)
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}

# the kernel's tiling (ops/kernels/csrc/deform_conv.cu): output pixels
# per warpgroup, channels per K step (bf16 body, f32 body), shared-memory
# stages and limit
ROWS_PER_WG = 64
STEP_C = 64
STEP_C_F32 = 32
A_STAGES, B_STAGES, B_STAGES_F32 = 2, 4, 2
MAX_SMEM = 232448
# K steps one f32 accumulator chain may take (9 taps x 256 channels)
MAX_CHAIN_F32 = 72


def _smem_bytes(flat_kc: bool, n_tile: int, wgs: int) -> int:
    corners = 4 if flat_kc else 1
    return (1024 + A_STAGES * wgs * corners * ROWS_PER_WG * STEP_C * 2
            + B_STAGES * n_tile * 128 + 2 * wgs * ROWS_PER_WG * 32
            + B_STAGES * 8)


def kernel_tiling(p: int, cout: int, flat_kc: bool,
                  sms: int = 132) -> Tuple[int, int, int]:
    """(channel tile, warpgroups per block, Cout splits) of the bf16 body
    for ``p`` output pixels: all of Cout in one tile (64, 128 or 256 wide)
    and two warpgroups (128 pixels) per block where that gives at least
    ``sms`` blocks and fits in shared memory; else 64-pixel blocks, and
    then Cout split in halves until the blocks cover the SMs."""
    n_tile = next(n for n in (64, 128, 256) if n >= cout)
    wgs = 2 if (-(-p // (2 * ROWS_PER_WG)) >= sms
                and _smem_bytes(flat_kc, n_tile, 2) <= MAX_SMEM) else 1
    blocks = -(-p // (wgs * ROWS_PER_WG))
    while n_tile > 64 and blocks * -(-cout // n_tile) < sms:
        n_tile //= 2
    return n_tile, wgs, -(-cout // n_tile)


def _smem_bytes_f32(n_tile: int, wgs: int) -> int:
    """The f32 body's dynamic shared memory: alignment slack, two A stages
    of hi and lo tiles per 64-pixel warpgroup, a ring of hi and lo B tiles,
    two corner tables, the barriers."""
    return (1024 + A_STAGES * wgs * 2 * ROWS_PER_WG * STEP_C_F32 * 4
            + B_STAGES_F32 * 2 * n_tile * 128 + 2 * wgs * ROWS_PER_WG * 32
            + B_STAGES_F32 * 8)


def kernel_tiling_f32(p: int, cout: int, cin: int, k: int = 9,
                      sms: int = 132) -> Tuple[int, int, int, int]:
    """(channel tile, pixel warpgroups per block, Cout splits, taps per
    group) of the f32 body for ``p`` output pixels. A warpgroup covers at
    most 128 channels (it holds two accumulators), so a 256 tile is two
    warpgroups on the same 64 pixels; a 64 or 128 tile takes two pixel
    warpgroups (128 pixels) where that gives at least ``sms`` blocks. The
    taps then run in groups (all ``k``, a third, one each), one block per
    group, from the first that gives at least ``sms`` blocks and at most
    :data:`MAX_CHAIN_F32` K steps a group: the groups' sums are added in
    a second pass, so a deep contraction is summed in shorter chains. Last,
    as in the bf16 body, the tile is halved until the blocks cover the
    SMs. A Cout over 256 is split in 256-wide tiles."""
    n_tile = next((n for n in (64, 128) if n >= cout), 256)
    wgs = 2 if n_tile < 256 and -(-p // (2 * ROWS_PER_WG)) >= sms else 1
    px_blocks = -(-p // (wgs * ROWS_PER_WG))
    steps = cin // STEP_C_F32
    tap_group = 1
    for tg in sorted({k, -(-k // 3), 1}, reverse=True):
        if (px_blocks * -(-cout // n_tile) * -(-k // tg) >= sms
                and tg * steps <= MAX_CHAIN_F32):
            tap_group = tg
            break
    while n_tile > 64 and (px_blocks * -(-k // tap_group)
                           * -(-cout // n_tile)) < sms:
        n_tile //= 2
    return n_tile, wgs, -(-cout // n_tile), tap_group


def _kernel_fn(entry: str):
    if entry not in _fns:
        from .kernels.build import load

        fn = getattr(load("deform_conv"), entry)
        fn.restype = ctypes.c_int
        n_ptr, n_int = (8, 20) if entry == "pdft_deform_conv2d_fwd" \
            else (7, 18)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        _fns[entry] = fn
    return _fns[entry]


def _check(x, offset, mask, weight, bias, Ho, Wo):
    B, H, W, Cin = x.shape
    Kh, Kw, wc, Cout = weight.shape
    K = Kh * Kw
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"deform_conv2d kernel takes f32 or bf16 x, got "
                        f"{x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(f"weight dtype {weight.dtype} != x dtype {x.dtype}")
    for name, t in (("offset", offset), ("mask", mask), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"deform_conv2d kernel takes f32 {name}, got "
                            f"{t.dtype}")
    for name, t in (("x", x), ("offset", offset), ("mask", mask),
                    ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"deform_conv2d kernel needs a contiguous "
                             f"{name}")
    if wc != Cin:
        raise ValueError(f"weight Cin {wc} != x Cin {Cin}")
    if x.dtype == torch.bfloat16:
        if Cin % STEP_C or Cout % 8 or Cout > 256:
            raise ValueError(f"the bf16 deform_conv2d kernel needs Cin % 64 "
                             f"== 0, Cout % 8 == 0 and Cout <= 256, got "
                             f"{Cin} -> {Cout}")
    elif Cin % STEP_C_F32:
        raise ValueError(f"the f32 deform_conv2d kernel needs Cin % 32 == 0, "
                         f"got {Cin}")
    if tuple(offset.shape) != (B, Ho, Wo, 2 * K) \
            or tuple(mask.shape) != (B, Ho, Wo, K):
        raise ValueError(f"offset {tuple(offset.shape)} / mask "
                         f"{tuple(mask.shape)} do not match output "
                         f"({B}, {Ho}, {Wo}) with K={K}")
    if bias is not None and tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({Cout},)")
    if B * H * W >= 2 ** 31 or B * Ho * Wo >= 2 ** 31:
        raise ValueError("deform_conv2d kernel indexes pixels in int32")
    if x.data_ptr() % 16:
        raise ValueError("deform_conv2d kernel needs 16-byte aligned x")


def _launch(flat_kc: bool, x, offset, mask, weight, bias, stride, padding,
            dilation, h0: int = 0, ho: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel's tap or flat-kc mode on CUDA tensors,
    over the output rows ``[h0, h0 + ho)``."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    _check(x, offset, mask, weight, bias, Ho, Wo)
    if flat_kc and x.dtype != torch.bfloat16:
        raise TypeError(f"the flat-kc kernel takes bf16 x, got {x.dtype}")
    out = torch.empty((B, Ho, Wo, Cout), device=x.device,
                      dtype=torch.float32)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    P, K = B * Ho * Wo, Kh * Kw
    # the tiling of the whole DCN, so that a row window sums each output in
    # the whole call's order (the f32 body's tap groups) and its rows are
    # the whole call's bit for bit
    P_all = B * _out_hw(H, W, Kh, Kw, stride, padding, dilation)[0] * Wo
    work = None
    if x.dtype == torch.bfloat16:
        n_tile, wgs, nsplit = kernel_tiling(P_all, Cout, flat_kc, sms)
        tap_group = 0
        wtile = torch.empty((K * Cin * nsplit * n_tile,), device=x.device,
                            dtype=torch.bfloat16)
    else:   # hi and lo tiles of the split weights, the tap groups' sums
        n_tile, wgs, nsplit, tap_group = kernel_tiling_f32(P_all, Cout, Cin,
                                                           K, sms)
        wtile = torch.empty((2 * K * Cin * nsplit * n_tile,),
                            device=x.device, dtype=torch.float32)
        groups = -(-K // tap_group)
        if groups > 1:
            work = torch.empty((groups * P * Cout,), device=x.device,
                               dtype=torch.float32)
    ptrs = (x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), wtile.data_ptr())
    shape = (B, H, W, Cin, Ho, Wo, Cout, Kh, Kw, stride[0], stride[1],
             padding[0], padding[1], dilation[0], dilation[1], h0, n_tile,
             wgs)
    if flat_kc:
        entry, args = "pdft_deform_conv2d_flat_kc_fwd", (*ptrs, *shape)
    else:
        entry = "pdft_deform_conv2d_fwd"
        args = (*ptrs, None if work is None else work.data_ptr(),
                _DTYPE_CODE[x.dtype], *shape, tap_group)
    with torch.cuda.device(x.device):
        err = _kernel_fn(entry)(
            *args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deform_conv2d kernel ({entry}) launch failed: "
                           f"cudaError {err}")
    name = "deform_conv2d_flat_kc" if flat_kc else "deform_conv2d"
    launch_counts[name] += 1
    launch_columns[name, Cout] += 1
    return out


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_conv2d runs on cuda or cpu, not "
                         f"{x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def deform_conv2d_backward_plain(grad_out: torch.Tensor, x: torch.Tensor,
                                 offset: torch.Tensor, mask: torch.Tensor,
                                 weight: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None,
                                 stride: Pair = (1, 1),
                                 padding: Pair = (1, 1),
                                 dilation: Pair = (1, 1),
                                 flat_kc: bool = False, h0: int = 0,
                                 ho: Optional[int] = None):
    """Gradients ``(dx, doffset, dmask, dweight, dbias)`` of the DCN for
    ``grad_out`` (B, Ho, Wo, Cout) of the output rows ``[h0, h0 + Ho)``,
    one tap at a time, in f32, each returned in its input's dtype (``dbias``
    None without a bias; ``dx`` over the whole x):

    - ``dW[t] = colᵀ @ dout`` and ``dcol = dout @ W[t]ᵀ``, as JAX's
      ``_tap_bwd`` (``deform_blend.py:243``);
    - ``dx``: the adjoint of the 4-corner gather, each corner's weighted
      ``dcol`` added at its pixel (``index_add_``), the out-of-image corners
      weighted 0 as in :func:`tap_columns`;
    - ``dmask`` and ``doffset`` from ``dcol · corner row`` and the
      derivatives of the lerp weights; the gradient through ``floor`` is
      zero, as in JAX.

    For bf16 x it rounds where the plain versions round, so that it is the
    gradient of what the kernel computes: in tap mode (K1) ``dW`` comes from
    the column rounded once (:func:`tap_columns`); in flat-kc mode (K2,
    ``flat_kc=True``) from each corner's rounded product, with the corner
    weights rounded (:func:`flat_kc_chunks`); ``dcol`` is rounded, as
    autograd of either plain version rounds it, and so is each corner
    weight's gradient in flat-kc mode."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _window_hw(H, W, Kh, Kw, stride, padding, dilation, h0, ho)
    K = Kh * Kw
    P = B * Ho * Wo
    f32 = torch.float32
    low = x.dtype == torch.bfloat16

    def rnd(t):
        return t.to(x.dtype).to(f32) if low else t

    g = grad_out.reshape(P, Cout).to(f32)
    sy, sx = _sample_points(offset, Ho, Wo, Kh, Kw, stride, padding,
                            dilation, h0=h0)
    y0 = torch.floor(sy).reshape(P, K, 1)
    x0 = torch.floor(sx).reshape(P, K, 1)
    wy = sy.reshape(P, K, 1) - y0
    wx = sx.reshape(P, K, 1) - x0
    # the 4 corners along the last axis, in _CORNERS order
    cy = torch.tensor([c[0] for c in _CORNERS], device=x.device)
    cx = torch.tensor([c[1] for c in _CORNERS], device=x.device)
    yy = y0.long() + cy
    xx = x0.long() + cx
    ok = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)).to(f32)
    ly = torch.where(cy.bool(), wy, 1 - wy)                  # (P, K, 4)
    lx = torch.where(cx.bool(), wx, 1 - wx)
    lw = ly * lx * ok
    m = mask.to(f32).reshape(P, K, 1)
    w = lw * m
    if flat_kc:
        w = rnd(w)
    row0 = (torch.arange(B, device=x.device) * (H * W)) \
        .repeat_interleave(Ho * Wo)
    idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1) + row0[:, None, None]
    # d lerp / d sample coordinate: -1 for the near corner, +1 for the far
    sign_y, sign_x = 2 * cy.to(f32) - 1, 2 * cx.to(f32) - 1
    xf = x.reshape(B * H * W, Cin)
    wmat = weight.to(f32).reshape(K, Cin, Cout)
    dx = torch.zeros(B * H * W, Cin, device=x.device, dtype=f32)
    dw = torch.empty(K, Cin, Cout, device=x.device, dtype=f32)
    dm = torch.empty(P, K, device=x.device, dtype=f32)
    doff = torch.empty(P, K, 2, device=x.device, dtype=f32)
    for t in range(K):
        dcol = rnd(g @ wmat[t].T)                              # (P, Cin)
        it = idx[:, t].reshape(P * 4)
        rows = xf.index_select(0, it).to(f32).reshape(P, 4, Cin)
        wt = w[:, t, :, None]                                  # (P, 4, 1)
        prod = rows * wt
        col = (rnd(prod) if flat_kc else prod).sum(1)
        if low and not flat_kc:
            col = rnd(col)
        dw[t] = col.T @ g
        dx.index_add_(0, it, (dcol[:, None, :] * wt).reshape(P * 4, Cin))
        dwc = (rows * dcol[:, None, :]).sum(2)   # d loss / d corner weight
        if flat_kc:
            dwc = rnd(dwc)
        dm[:, t] = (dwc * lw[:, t]).sum(1)
        dl = dwc * m[:, t] * ok[:, t]
        doff[:, t, 0] = (dl * lx[:, t] * sign_y).sum(1)
        doff[:, t, 1] = (dl * ly[:, t] * sign_x).sum(1)
    dbias = None if bias is None else g.sum(0).to(bias.dtype)
    return (dx.reshape(B, H, W, Cin).to(x.dtype),
            doff.reshape(B, Ho, Wo, 2 * K).to(offset.dtype),
            dm.reshape(B, Ho, Wo, K).to(mask.dtype),
            dw.reshape(Kh, Kw, Cin, Cout).to(weight.dtype), dbias)


class DeformConv2dFunction(torch.autograd.Function):
    """The kernel on CUDA tensors, made differentiable: ``forward`` is one
    launch of the tap mode (K1) or, with ``flat_kc``, the flat-kc mode
    (K2); ``backward`` is :func:`deform_conv2d_backward_plain` in the same
    mode (JAX's custom VJPs ``blend_matmul_tap`` / ``blend_matmul``,
    ``deform_blend.py:229,114``). Two trailing arguments, ``h0, ho``, give
    a row window (module docstring); without them, every row."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, stride, padding,
                dilation, flat_kc, *window):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        ctx.geometry = (stride, padding, dilation, flat_kc)
        ctx.window = window
        return _launch(flat_kc, x, offset, mask, weight, bias, stride,
                       padding, dilation, *window)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight, bias = ctx.saved_tensors
        stride, padding, dilation, flat_kc = ctx.geometry
        # the block permutes the output NHWC -> NCHW, so the gradient
        # arrives strided
        grads = deform_conv2d_backward_plain(
            grad_out.contiguous(), x, offset, mask, weight, bias, stride,
            padding, dilation, flat_kc, *ctx.window)
        return (*grads, None, None, None, None) + (None,) * len(ctx.window)


def _window_args(x, weight, stride, padding, dilation, h0: int,
                 ho: Optional[int]) -> Tuple[int, ...]:
    """The Function's trailing window arguments: none for every row."""
    Ho = _out_hw(x.shape[1], x.shape[2], weight.shape[0], weight.shape[1],
                 stride, padding, dilation)[0]
    return () if h0 == 0 and ho in (None, Ho) else (h0, ho)


@hand_counted(dcn_flops)
def deform_conv2d_tap(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      stride: Pair = (1, 1), padding: Pair = (1, 1),
                      dilation: Pair = (1, 1), h0: int = 0,
                      ho: Optional[int] = None) -> torch.Tensor:
    """The DCN (its row window) in the kernel's tap mode (K1) on a CUDA
    tensor, differentiable; the plain version on a CPU tensor."""
    if _device_type(x) == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, bias, stride,
                                   padding, dilation, h0=h0, ho=ho)
    return DeformConv2dFunction.apply(x, offset, mask, weight, bias,
                                      tuple(stride), tuple(padding),
                                      tuple(dilation), False,
                                      *_window_args(x, weight, stride,
                                                    padding, dilation, h0,
                                                    ho))


@hand_counted(dcn_flops)
def deform_conv2d_chunked(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: Pair = (1, 1), padding: Pair = (1, 1),
                          dilation: Pair = (1, 1), h0: int = 0,
                          ho: Optional[int] = None) -> torch.Tensor:
    """The flat-kc route: the DCN (its row window), all taps, in one launch
    of the kernel's flat-kc mode (K2) on a CUDA tensor, differentiable; on
    a CPU tensor :func:`deform_conv2d_chunked_plain` in JAX's
    tap chunks, which changes only the order of the f32 sums."""
    if _device_type(x) == "cpu":
        return deform_conv2d_chunked_plain(x, offset, mask, weight, bias,
                                           stride, padding, dilation,
                                           h0=h0, ho=ho)
    return DeformConv2dFunction.apply(x, offset, mask, weight, bias,
                                      tuple(stride), tuple(padding),
                                      tuple(dilation), True,
                                      *_window_args(x, weight, stride,
                                                    padding, dilation, h0,
                                                    ho))


@hand_counted(dcn_flops)
def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: Pair = (1, 1), padding: Pair = (1, 1),
                  dilation: Pair = (1, 1), h0: int = 0,
                  ho: Optional[int] = None) -> torch.Tensor:
    """Modulated deform conv (DCNv2), channels-last; returns f32
    (B, Ho, Wo, Cout), the rows of the window ``[h0, h0 + ho)``. CPU
    tensors go through :func:`deform_conv2d_plain`; CUDA tensors through
    the flat-kc mode where the JAX package takes its flat-kc route
    (:func:`flat_kc_route`), else through the tap mode. The route is
    decided on the whole DCN's output rows, so that a row window never
    changes where the kernel rounds."""
    if x.device.type == "cuda":
        B, H, W, Cin = x.shape
        Kh, Kw, _, Cout = weight.shape
        Ho, Wo = _out_hw(H, W, Kh, Kw, stride, padding, dilation)
        if flat_kc_route(B, Ho, Wo, Cin, Kh * Kw, Cout, x.dtype):
            return deform_conv2d_chunked(x, offset, mask, weight, bias,
                                         stride, padding, dilation, h0=h0,
                                         ho=ho)
    return deform_conv2d_tap(x, offset, mask, weight, bias, stride, padding,
                             dilation, h0=h0, ho=ho)
