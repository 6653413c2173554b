"""Cycle-CenterNet: the DLA-34 trunk with heads {hm:2, v2c:8, c2v:8, reg:2}
and the decode on the device (counterpart of
pdf_table_tpu/models/center_net/model.py): cells from the heatmap's
channel 0 with their centre-to-vertex offsets, vertices from channel 1
with their vertex-to-centre offsets. The trunk's deform convs run the DCN
kernel (K1, or K2 on its flat-kc route in bf16)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...engine.device import compute_dtype
from ...ops.centernet import (decode_boxes_4ps, gather_feat, heatmap_nms,
                              topk_scores)
from ..lore.detector import DLACenterNet, cast_detector
from .config import CenterNetConfig

PACK_WIDTH = 11     # cells [dets 8, score, centre 2]; vertices [gbox 11]


class CycleCenterNet(nn.Module):
    """``plain_dcn=True`` runs every deform conv through its plain PyTorch
    version (a yardstick run for the kernel); the dtypes follow
    ``config.dtype`` as LORE's detector does."""

    def __init__(self, config: CenterNetConfig, plain_dcn: bool = False):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.dtype)
        self.trunk = DLACenterNet(config.head_conv, heads=config.heads)
        cast_detector(self.trunk, self.dtype, plain_dcn)

    def heads(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) normalized NHWC -> head maps, NHWC f32."""
        x = pixel_values.permute(0, 3, 1, 2).to(
            dtype=self.dtype, memory_format=torch.channels_last)
        return {k: v.permute(0, 2, 3, 1) for k, v in self.trunk(x).items()}

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.decode(self.heads(pixel_values))

    def decode(self, out: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Head maps -> dets (B, K, 8) and scores (B, K) of the cells,
        centers (B, K, 2), gboxes (B, MK, 11) [vertex 2, the 4 centres it
        points to 8, score], all in feature-map coordinates."""
        cfg = self.config
        hm = torch.sigmoid(out["hm"])
        dets, scores, _, centers, _ = decode_boxes_4ps(
            hm[..., 0:1], out["v2c"], out["reg"], cfg.K)
        B, H, W, _ = hm.shape
        vscores, vinds, _, vys, vxs = topk_scores(heatmap_nms(hm[..., 1:2]),
                                                  cfg.MK)
        vreg = gather_feat(out["reg"].reshape(B, H * W, 2), vinds)
        vx = vxs + vreg[:, :, 0]
        vy = vys + vreg[:, :, 1]
        c2v = gather_feat(out["c2v"].reshape(B, H * W, 8), vinds)
        cxs = vx[:, :, None] - c2v[:, :, 0::2]
        cys = vy[:, :, None] - c2v[:, :, 1::2]
        gboxes = torch.cat([vx[..., None], vy[..., None],
                            torch.stack([cxs, cys], -1).reshape(B, -1, 8),
                            vscores[..., None]], dim=-1)
        return {"dets": dets, "scores": scores, "gboxes": gboxes,
                "centers": centers}

    def forward_packed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The decode as one (B, K + MK, 11) tensor to download: cell rows
        [dets, score, centre], then vertex rows (the gboxes)."""
        o = self.forward(pixel_values)
        cells = torch.cat([o["dets"], o["scores"][..., None], o["centers"]],
                          dim=-1)
        return torch.cat([cells, o["gboxes"]], dim=1)


def unpack_centernet(packed, k: int) -> Dict:
    """A (1, K + MK, 11) numpy slice -> the decode's named fields."""
    cells, verts = packed[:, :k], packed[:, k:]
    return {"dets": cells[..., :8], "scores": cells[..., 8],
            "centers": cells[..., 9:11], "gboxes": verts}
