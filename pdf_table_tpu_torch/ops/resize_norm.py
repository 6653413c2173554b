"""Fused bilinear resize + per-channel normalize of uint8 page canvases
(counterpart of pdf_table_tpu/ops/pallas/resize_norm.py).

``resize_normalize`` computes, in f32, ``(resize(u8 * scale) - mean[c]) /
std[c]`` with half-pixel, clamped bilinear sampling (``resize_matrix``),
optionally reading the channels reversed (RGB -> BGR). Input (N, H, W, 3)
uint8 NHWC, output (N, Ho, Wo, 3) f32 contiguous NHWC. On a CUDA tensor it
launches the hand-written kernel ``ops/kernels/csrc/resize_norm.cu`` (one
thread per output pixel, 2x2 byte taps, per-axis tap tables) and raises on
what the kernel does not take; on a CPU tensor it runs
:func:`resize_normalize_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .kernels import launch_counts


@functools.lru_cache(maxsize=64)
def _taps(out_size: int, in_size: int) -> Tuple[Tuple[int, int, float], ...]:
    """Per output index ``(i0, i1, f)``: half-pixel source coordinate
    clamped to [0, in - 1], ``i1 = min(i0 + 1, in - 1)``, ``f`` the weight
    of ``i1`` (``i0`` takes ``1 - f``); ``in == 1`` gives ``(0, 0, 0)``."""
    if in_size == 1:
        return ((0, 0, 0.0),) * out_size
    scale = in_size / out_size
    out = []
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1)
        i0 = int(np.floor(src))
        out.append((i0, min(i0 + 1, in_size - 1), src - i0))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation weights: the dense form of
    :func:`resize_taps`."""
    w = np.zeros((out_size, in_size), np.float32)
    for o, (i0, i1, f) in enumerate(_taps(out_size, in_size)):
        w[o, i0] += 1.0 - f
        w[o, i1] += f
    return w


def resize_taps(out_size: int, in_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzeros of :func:`resize_matrix` per output index: taps
    (out, 2) int32 ``(i0, i1)`` and the weight ``f`` (out,) f32 of ``i1``."""
    t = _taps(out_size, in_size)
    return (np.array([(i0, i1) for i0, i1, _ in t], np.int32),
            np.array([f for _, _, f in t], np.float32))


def _channel_vec(v, device) -> torch.Tensor:
    return torch.tensor(np.broadcast_to(np.asarray(v, np.float32), (3,)),
                        device=device)


def resize_normalize_plain(canvas_u8: torch.Tensor, out_hw: Tuple[int, int],
                           mean: Sequence[float], std: Sequence[float],
                           scale: float = 1.0 / 255.0,
                           reverse_channels: bool = False) -> torch.Tensor:
    """Plain PyTorch version, as ``resize_normalize_xla``: the dense
    ``resize_matrix`` pair applied with two f32 ``einsum``s."""
    N, H, W, C = canvas_u8.shape
    Ho, Wo = out_hw
    dev = canvas_u8.device
    x = canvas_u8.to(torch.float32)
    if reverse_channels:
        x = x.flip(-1)
    x = x * scale
    wy = torch.from_numpy(resize_matrix(Ho, H)).to(dev)
    wx = torch.from_numpy(resize_matrix(Wo, W)).to(dev)
    t = torch.einsum("oh,bhwc->bowc", wy, x)
    t = torch.einsum("pw,bowc->bopc", wx, t)
    return (t - _channel_vec(mean, dev)) / _channel_vec(std, dev)


_fwd = None
_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _kernel_fn():
    global _fwd
    if _fwd is None:
        from .kernels.build import load

        fn = load("resize_norm").pdft_resize_normalize
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p]
        _fwd = fn
    return _fwd


def _device_taps(out_size: int, in_size: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`resize_taps` on ``device``, uploaded once per (out, in)."""
    key = (out_size, in_size, str(device))
    if key not in _TABLES:
        taps, frac = resize_taps(out_size, in_size)
        _TABLES[key] = (torch.from_numpy(taps).to(device),
                        torch.from_numpy(frac).to(device))
    return _TABLES[key]


def resize_normalize(canvas_u8: torch.Tensor, out_hw: Tuple[int, int],
                     mean: Sequence[float], std: Sequence[float],
                     scale: float = 1.0 / 255.0,
                     reverse_channels: bool = False) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> f32 (N, Ho, Wo, 3): bilinear resize of
    ``u8 * scale``, then ``(v - mean[c]) / std[c]`` (``mean``/``std`` are
    per output channel, after the optional channel reversal). CUDA tensors
    go through the kernel, CPU tensors through
    :func:`resize_normalize_plain`."""
    if canvas_u8.dtype != torch.uint8:
        raise TypeError(f"resize_normalize takes uint8 canvases, got "
                        f"{canvas_u8.dtype}")
    if canvas_u8.device.type == "cpu":
        return resize_normalize_plain(canvas_u8, out_hw, mean, std, scale,
                                      reverse_channels)
    if canvas_u8.device.type != "cuda":
        raise ValueError(f"resize_normalize runs on cuda or cpu, not "
                         f"{canvas_u8.device}")
    if canvas_u8.dim() != 4 or canvas_u8.shape[-1] != 3:
        raise ValueError(f"resize_normalize kernel takes (N, H, W, 3), got "
                         f"{tuple(canvas_u8.shape)}")
    if not canvas_u8.is_contiguous():
        raise ValueError("resize_normalize kernel needs a contiguous canvas")
    N, H, W, _ = canvas_u8.shape
    Ho, Wo = out_hw
    if canvas_u8.numel() >= 2 ** 31 or N * Ho * Wo * 3 >= 2 ** 31:
        raise ValueError("resize_normalize kernel indexes in int32")
    dev = canvas_u8.device
    ytaps, yfrac = _device_taps(Ho, H, dev)
    xtaps, xfrac = _device_taps(Wo, W, dev)
    m = np.broadcast_to(np.asarray(mean, np.float32), (3,))
    s = np.broadcast_to(np.asarray(std, np.float32), (3,))
    out = torch.empty((N, Ho, Wo, 3), device=dev, dtype=torch.float32)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(canvas_u8.data_ptr(), out.data_ptr(), ytaps.data_ptr(),
                 yfrac.data_ptr(), xtaps.data_ptr(), xfrac.data_ptr(),
                 N, H, W, Ho, Wo, float(scale), *map(float, m),
                 *map(float, s), int(bool(reverse_channels)),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize_normalize kernel launch failed: "
                           f"cudaError {err}")
    launch_counts["resize_normalize"] += 1
    return out
