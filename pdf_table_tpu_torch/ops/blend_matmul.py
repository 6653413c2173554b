"""Plain version of the flat-kc DCNv2 back half (the Pallas kernel
pdf_table_tpu/ops/pallas/deform_blend.py::blend_matmul).

``blend_matmul_plain(g2, w4, wrep, cin)`` computes
``((w4 ⊗ 1_cin) ⊙ g2) @ wrep`` with an f32 result: ``g2`` (Np, T·4·Cin)
bf16 gathered corner rows, corner-major per tap; ``w4`` (Np, T·4) bf16
lerp × mask weights; ``wrep`` (T·4·Cin, Cout) bf16. The JAX kernel expands
``w4`` with the 0/1 matrix ``expand_matrix(T*4, Cin)``; here column ``j``
of the rows takes ``w4[:, j // cin]`` directly. The blended product is
rounded to bf16 before the contraction, as the TPU kernel does.

It is the back half of :func:`..deform_conv.deform_conv2d_chunked_plain`,
the plain twin of the deform-conv kernel's flat-kc mode, which gathers the
corner rows itself and never builds ``g2``.
"""

from __future__ import annotations

import torch


def blend_matmul_plain(g2: torch.Tensor, w4: torch.Tensor,
                       wrep: torch.Tensor, cin: int) -> torch.Tensor:
    """Expand ``w4`` over the channels, multiply, round to ``g2``'s dtype,
    contract in f32."""
    w4e = torch.repeat_interleave(w4.float(), cin, dim=1)
    gm = (g2.float() * w4e).to(g2.dtype)
    return gm.float() @ wrep.float()
