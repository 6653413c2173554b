"""Flat-kc DCNv2 back half (counterpart of the Pallas kernel
pdf_table_tpu/ops/pallas/deform_blend.py::blend_matmul).

``blend_matmul(g2, w4, wrep, cin)`` computes ``((w4 ⊗ 1_cin) ⊙ g2) @ wrep``
with an f32 result: ``g2`` (Np, T·4·Cin) bf16 gathered corner rows,
corner-major per tap; ``w4`` (Np, T·4) bf16 lerp × mask weights; ``wrep``
(T·4·Cin, Cout) bf16. The JAX kernel expands ``w4`` with the 0/1 matrix
``expand_matrix(T*4, Cin)``; here column ``j`` of the rows takes
``w4[:, j // cin]`` directly. The blended product is rounded to bf16 before
the contraction, as the TPU kernel does.

On a CUDA tensor it launches ``ops/kernels/csrc/blend_matmul.cu`` and raises
on what the kernel does not take; on a CPU tensor it runs
:func:`blend_matmul_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import launch_counts


def blend_matmul_plain(g2: torch.Tensor, w4: torch.Tensor,
                       wrep: torch.Tensor, cin: int) -> torch.Tensor:
    """Plain PyTorch version: expand ``w4`` over the channels, multiply,
    round to ``g2``'s dtype, contract in f32."""
    w4e = torch.repeat_interleave(w4.float(), cin, dim=1)
    gm = (g2.float() * w4e).to(g2.dtype)
    return gm.float() @ wrep.float()


_fwd = None


def _kernel_fn():
    global _fwd
    if _fwd is None:
        from .kernels.build import load

        fn = load("blend_matmul").pdft_blend_matmul_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        _fwd = fn
    return _fwd


def _check(g2, w4, wrep, cin):
    for name, t in (("g2", g2), ("w4", w4), ("wrep", wrep)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"blend_matmul kernel takes bf16 {name}, got "
                            f"{t.dtype}")
        if t.device != g2.device:
            raise ValueError(f"{name} is on {t.device}, g2 on {g2.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"blend_matmul kernel needs a contiguous 2-d "
                             f"{name}")
    np_, kc = g2.shape
    cout = wrep.shape[1]
    if cin <= 0 or cin % 32 or kc % cin:
        raise ValueError(f"blend_matmul kernel needs cin % 32 == 0 and "
                         f"kc % cin == 0, got cin={cin}, kc={kc}")
    if tuple(w4.shape) != (np_, kc // cin) or wrep.shape[0] != kc:
        raise ValueError(f"w4 {tuple(w4.shape)} / wrep {tuple(wrep.shape)} "
                         f"do not match g2 {tuple(g2.shape)} with cin={cin}")
    if cout % 8:
        raise ValueError(f"blend_matmul kernel needs Cout % 8 == 0, got "
                         f"{cout}")
    if np_ >= 2 ** 31:
        raise ValueError("blend_matmul kernel indexes rows in int32")
    if g2.data_ptr() % 16 or wrep.data_ptr() % 16:
        raise ValueError("blend_matmul kernel needs 16-byte aligned g2 and "
                         "wrep")


def blend_matmul(g2: torch.Tensor, w4: torch.Tensor, wrep: torch.Tensor,
                 cin: int) -> torch.Tensor:
    """(Np, Cout) f32. CUDA tensors go through the kernel, CPU tensors
    through :func:`blend_matmul_plain`."""
    if g2.device.type == "cpu":
        return blend_matmul_plain(g2, w4, wrep, cin)
    if g2.device.type != "cuda":
        raise ValueError(f"blend_matmul runs on cuda or cpu, not "
                         f"{g2.device}")
    _check(g2, w4, wrep, cin)
    np_, kc = g2.shape
    cout = wrep.shape[1]
    out = torch.empty((np_, cout), device=g2.device, dtype=torch.float32)
    fn = _kernel_fn()
    with torch.cuda.device(g2.device):
        err = fn(g2.data_ptr(), w4.data_ptr(), wrep.data_ptr(),
                 out.data_ptr(), np_, kc, cin, cout,
                 torch.cuda.current_stream(g2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_matmul kernel launch failed: cudaError "
                           f"{err}")
    launch_counts["blend_matmul"] += 1
    return out
