"""Modulated deformable convolution v2 (counterpart of
pdf_table_tpu/ops/deform_conv.py).

``deform_conv2d`` keeps the JAX signature and layouts: x NHWC, offset
(B, Ho, Wo, 2K) in (dy, dx) pairs, mask (B, Ho, Wo, K) post-sigmoid,
weight (Kh, Kw, Cin, Cout), f32 output. On a CUDA tensor it launches the
hand-written kernel ``ops/kernels/csrc/deform_conv.cu`` (gather, blend and
contraction in one pass) and raises on what the kernel does not take; on a
CPU tensor it runs :func:`deform_conv2d_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .kernels import launch_counts

Pair = Tuple[int, int]
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))   # (dy, dx) of the 4 corners


def _out_hw(H: int, W: int, Kh: int, Kw: int, stride: Pair, padding: Pair,
            dilation: Pair) -> Tuple[int, int]:
    Ho = (H + 2 * padding[0] - dilation[0] * (Kh - 1) - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * (Kw - 1) - 1) // stride[1] + 1
    return Ho, Wo


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        stride: Pair = (1, 1), padding: Pair = (1, 1),
                        dilation: Pair = (1, 1)) -> torch.Tensor:
    """Plain PyTorch DCNv2 in f32: per tap, the four bilinear corners are
    gathered with their own in-bounds masks (zero outside the image),
    blended with the bilinear weight x modulation and contracted with
    ``W[t]``."""
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _out_hw(H, W, Kh, Kw, stride, padding, dilation)
    K = Kh * Kw
    dev = x.device
    f32 = torch.float32
    oy = torch.arange(Ho, device=dev, dtype=f32) * stride[0] - padding[0]
    ox = torch.arange(Wo, device=dev, dtype=f32) * stride[1] - padding[1]
    ky = torch.arange(Kh, device=dev, dtype=f32) * dilation[0]
    kx = torch.arange(Kw, device=dev, dtype=f32) * dilation[1]
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]) \
        .expand(Ho, Wo, Kh, Kw).reshape(Ho, Wo, K)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]) \
        .expand(Ho, Wo, Kh, Kw).reshape(Ho, Wo, K)
    off = offset.reshape(B, Ho, Wo, K, 2).to(f32)
    sy = base_y + off[..., 0]                    # (B, Ho, Wo, K)
    sx = base_x + off[..., 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    yi = y0.long()
    xi = x0.long()
    m = mask.to(f32)
    xf = x.reshape(B, H * W, Cin)
    wmat = weight.to(f32).reshape(K, Cin, Cout)
    out = torch.zeros(B * Ho * Wo, Cout, device=dev, dtype=f32)
    for t in range(K):
        col = torch.zeros(B, Ho * Wo, Cin, device=dev, dtype=f32)
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
        out += col.reshape(B * Ho * Wo, Cin) @ wmat[t]
    out = out.reshape(B, Ho, Wo, Cout)
    if bias is not None:
        out = out + bias.to(f32)
    return out


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fwd = None


def _kernel_fn():
    global _fwd
    if _fwd is None:
        from .kernels.build import load

        fn = load("deform_conv").pdft_deform_conv2d_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 \
            + [ctypes.c_void_p]
        _fwd = fn
    return _fwd


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
    if wc != Cin or Cin % 32 != 0:
        raise ValueError(f"deform_conv2d kernel needs weight Cin == x Cin "
                         f"and Cin % 32 == 0, got {wc} / {Cin}")
    if tuple(offset.shape) != (B, Ho, Wo, 2 * K) \
            or tuple(mask.shape) != (B, Ho, Wo, K):
        raise ValueError(f"offset {tuple(offset.shape)} / mask "
                         f"{tuple(mask.shape)} do not match output "
                         f"({B}, {Ho}, {Wo}) with K={K}")
    if bias is not None and tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({Cout},)")
    if B * H * W >= 2 ** 31:
        raise ValueError("deform_conv2d kernel indexes x rows in int32")
    if x.data_ptr() % 16:
        raise ValueError("deform_conv2d kernel needs 16-byte aligned x")


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: Pair = (1, 1), padding: Pair = (1, 1),
                  dilation: Pair = (1, 1)) -> torch.Tensor:
    """Modulated deform conv (DCNv2), channels-last; returns f32
    (B, Ho, Wo, Cout). CUDA tensors go through the kernel, CPU tensors
    through :func:`deform_conv2d_plain`."""
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, bias, stride,
                                   padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d runs on cuda or cpu, not "
                         f"{x.device}")
    B, H, W, Cin = x.shape
    Kh, Kw, _, Cout = weight.shape
    Ho, Wo = _out_hw(H, W, Kh, Kw, stride, padding, dilation)
    _check(x, offset, mask, weight, bias, Ho, Wo)
    out = torch.empty((B, Ho, Wo, Cout), device=x.device,
                      dtype=torch.float32)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 weight.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[x.dtype], B, H, W, Cin, Ho, Wo, Cout, Kh, Kw,
                 stride[0], stride[1], padding[0], padding[1],
                 dilation[0], dilation[1],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deform_conv2d kernel launch failed: "
                           f"cudaError {err}")
    launch_counts["deform_conv2d"] += 1
    return out
