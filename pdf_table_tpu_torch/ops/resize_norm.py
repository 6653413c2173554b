"""Fused bilinear resize + per-channel normalize of uint8 page canvases
(counterpart of pdf_table_tpu/ops/pallas/resize_norm.py).

``resize_normalize`` computes, in f32, ``(resize(u8 * scale) - mean[c]) /
std[c]`` with half-pixel, clamped bilinear sampling (``resize_matrix``),
optionally reading the channels reversed (RGB -> BGR). Input (N, H, W, 3)
uint8 NHWC, output (N, Ho, Wo, 3) f32 contiguous NHWC. On a CUDA tensor it
launches the hand-written kernel ``ops/kernels/csrc/resize_norm.cu`` (2x2
byte taps from per-axis tap tables) and raises on what the kernel does not
take; on a CPU tensor it runs :func:`resize_normalize_plain`.

The kernel has two bodies, chosen by shape (:func:`kernel_route`): the
vector body stages each tile's source span in shared memory with 16-byte
copies and writes 16-byte stores; the scalar body (a thread per output
pixel, byte loads from device memory) takes every other shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

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


def _channel_floats(v) -> Tuple[float, float, float]:
    """A scalar or a 3-sequence as three Python floats."""
    a = np.broadcast_to(np.asarray(v, np.float64), (3,))
    return float(a[0]), float(a[1]), float(a[2])


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


# the vector body's tile (output rows x output pixels per block) and the
# most shared memory its source span may take; the kernel source holds the
# same three numbers (kVecRows, kVecPixels, kVecSmemMax)
VEC_ROWS = 16
VEC_PIXELS = 128
VEC_SMEM_MAX = 48 * 1024


@functools.lru_cache(maxsize=64)
def vector_tile(H: int, W: int, Ho: int, Wo: int
                ) -> Optional[Tuple[int, int]]:
    """(pitch bytes, source rows) of the vector body's shared tile for a
    (H, W) -> (Ho, Wo) resize, or None where that body does not take the
    shape: it needs whole float4s per output row (``Wo % 4 == 0``),
    16-byte aligned canvas rows (``W % 16 == 0``) and a source span per
    tile (the widest over all tiles, from the tap tables) within
    ``VEC_SMEM_MAX``."""
    if H < 1 or W < 1 or Ho < 1 or Wo < 1 or Wo % 4 or W % 16:
        return None
    ytaps, _ = resize_taps(Ho, H)
    xtaps, _ = resize_taps(Wo, W)
    o0 = np.arange(0, Ho, VEC_ROWS)
    o1 = np.minimum(o0 + VEC_ROWS, Ho) - 1
    rows = int((ytaps[o1, 1] - ytaps[o0, 0] + 1).max())
    p0 = np.arange(0, Wo, VEC_PIXELS)
    p1 = np.minimum(p0 + VEC_PIXELS, Wo) - 1
    lo = (xtaps[p0, 0] * 3) & ~15
    hi = (xtaps[p1, 1] * 3 + 3 + 15) & ~15
    pitch = int((hi - lo).max())
    if pitch * rows > VEC_SMEM_MAX:
        return None
    return pitch, rows


def kernel_route(H: int, W: int, Ho: int, Wo: int) -> str:
    """Which body of the kernel a (H, W) -> (Ho, Wo) resize takes:
    "vector" where :func:`vector_tile` gives a tile, else "scalar"."""
    return "vector" if vector_tile(H, W, Ho, Wo) is not None else "scalar"


_fns = None
_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _kernel_fns():
    """(scalar entry, vector entry) of the built library."""
    global _fns
    if _fns is None:
        from .kernels.build import load

        lib = load("resize_norm")
        tile = (ctypes.c_int * 3)()
        lib.pdft_resize_normalize_vec_tile.restype = None
        lib.pdft_resize_normalize_vec_tile.argtypes = [ctypes.c_int * 3]
        lib.pdft_resize_normalize_vec_tile(tile)
        if tuple(tile) != (VEC_ROWS, VEC_PIXELS, VEC_SMEM_MAX):
            raise RuntimeError(
                f"resize_norm.cu's vector tile {tuple(tile)} differs from "
                f"the wrapper's {(VEC_ROWS, VEC_PIXELS, VEC_SMEM_MAX)}")
        scalar = lib.pdft_resize_normalize
        scalar.restype = ctypes.c_int
        scalar.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p]
        vec = lib.pdft_resize_normalize_vec
        vec.restype = ctypes.c_int
        vec.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
        _fns = (scalar, vec)
    return _fns


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
                     reverse_channels: bool = False,
                     route: Optional[str] = None) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> f32 (N, Ho, Wo, 3): bilinear resize of
    ``u8 * scale``, then ``(v - mean[c]) / std[c]`` (``mean``/``std`` are
    per output channel, after the optional channel reversal). CUDA tensors
    go through the kernel, CPU tensors through
    :func:`resize_normalize_plain`. ``route`` names the kernel's body
    ("vector" or "scalar") for a check of one body against the plain
    version; left None, :func:`kernel_route` picks it from the shape (and
    a canvas that is not 16-byte aligned takes the scalar body). The
    vector body raises on a shape it does not take."""
    if canvas_u8.dtype != torch.uint8:
        raise TypeError(f"resize_normalize takes uint8 canvases, got "
                        f"{canvas_u8.dtype}")
    if route not in (None, "vector", "scalar"):
        raise ValueError(f"unknown resize_normalize route {route!r}")
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
    out = torch.empty((N, Ho, Wo, 3), device=dev, dtype=torch.float32)
    tile = vector_tile(H, W, Ho, Wo)
    aligned = canvas_u8.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    if route is None:
        route = "vector" if tile is not None and aligned else "scalar"
    if route == "vector" and (tile is None or not aligned):
        raise ValueError(
            f"the vector body does not take {(H, W)} -> {(Ho, Wo)} "
            f"(see vector_tile) or a tensor off 16-byte alignment")
    ytaps, yfrac = _device_taps(Ho, H, dev)
    xtaps, xfrac = _device_taps(Wo, W, dev)
    m, s = _channel_floats(mean), _channel_floats(std)
    scalar, vec = _kernel_fns()
    head = (canvas_u8.data_ptr(), out.data_ptr(), ytaps.data_ptr(),
            yfrac.data_ptr(), xtaps.data_ptr(), xfrac.data_ptr(),
            N, H, W, Ho, Wo)
    tail = (int(bool(reverse_channels)),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if route == "vector":
            # (v * scale - mean) / std as one multiply-add per value
            err = vec(*head, *tile, *(scale / si for si in s),
                      *(-mi / si for mi, si in zip(m, s)), *tail)
        else:
            err = scalar(*head, float(scale), *m, *s, *tail)
    if err != 0:
        raise RuntimeError(f"resize_normalize kernel launch failed: "
                           f"cudaError {err}")
    launch_counts["resize_normalize"] += 1
    return out
