"""DocXLayout: the DLA-34 CenterNet trunk (models/lore/detector.py's
``DLACenterNet``) with the layout heads, and the decode on the device
(counterpart of pdf_table_tpu/models/docx_layout/model.py and of the
device half of its post-processor): sigmoid, 3x3 peak NMS and top
``top_k`` of the 11-class ``hm`` with its 4-point ``wh`` boxes, and top
``min(top_k, 20)`` of the 2-class ``hm_sub`` (full and sub columns) with
the same ``wh`` and ``reg``. The trunk's 16 deform convs run the DCN
kernel (K1, or K2 on its flat-kc route in bf16)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...engine.device import compute_dtype
from ...ops.centernet import decode_boxes_4ps
from ..lore.detector import DLACenterNet, cast_detector
from .config import DocXLayoutConfig

PACK_WIDTH = 10     # [dets 8, score, class] per slot
SUB_TOP_K = 20


def sub_top_k(config: DocXLayoutConfig) -> int:
    return min(config.top_k, SUB_TOP_K)


class DocXLayoutModel(nn.Module):
    """``plain_dcn=True`` runs every deform conv through its plain PyTorch
    version (a yardstick run for the kernel); the dtypes follow
    ``config.dtype`` as Cycle-CenterNet's do."""

    def __init__(self, config: DocXLayoutConfig, plain_dcn: bool = False):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.dtype)
        self.dla = DLACenterNet(config.head_conv, heads=config.heads)
        cast_detector(self.dla, self.dtype, plain_dcn)

    def heads(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) normalized NHWC -> head maps, NHWC f32."""
        x = pixel_values.permute(0, 3, 1, 2).to(
            dtype=self.dtype, memory_format=torch.channels_last)
        return {k: v.permute(0, 2, 3, 1) for k, v in self.dla(x).items()}

    def decode(self, out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Head maps -> (B, top_k + sub_top_k, 10): the layout slots, then
        the column slots, each [dets 8 (feature-map px), score, class]."""
        rows = []
        for hm, k in ((out["hm"], self.config.top_k),
                      (out["hm_sub"], sub_top_k(self.config))):
            dets, scores, clses, _, _ = decode_boxes_4ps(
                torch.sigmoid(hm), out["wh"], out["reg"], k)
            rows.append(torch.cat([dets, scores[..., None],
                                   clses[..., None].float()], dim=-1))
        return torch.cat(rows, dim=1)

    def forward_packed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.decode(self.heads(pixel_values))

    forward = forward_packed


def unpack_docx(packed, k: int) -> Dict:
    """One page's (top_k + sub_top_k, 10) numpy slice -> the decode's
    named fields."""
    main, sub = packed[:k], packed[k:]
    return {"dets": main[:, :8], "scores": main[:, 8],
            "clses": main[:, 9].astype(int), "sub_dets": sub[:, :8],
            "sub_scores": sub[:, 8], "sub_clses": sub[:, 9].astype(int)}
