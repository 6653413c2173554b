"""LoreModel: detector + on-device decode + logical-location regressor
(counterpart of pdf_table_tpu/models/lore/model.py). Static K cell slots:
invalid slots carry a mask instead of being filtered, so the device never
waits for the host. Under ``wiz_rev`` (the wtw config) the corner channel is
decoded too and cell vertices snap to corner detections
(``corner_refine.py``) between :meth:`LoreModel.detect_decode` and
:meth:`LoreModel.gather_logical`; :meth:`LoreModel.forward_packed` runs
either path."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...engine.device import compute_dtype
from ...ops.centernet import decode_boxes_4ps, gather_feat
from .config import LoreConfig
from .corner_refine import refine_sort
from .detector import build_detector, cast_detector
from .processor_model import LoreProcessor

# packed output layout: (name, width) along the last axis
LORE_PACK = (("dets", 8), ("scores", 1), ("valid", 1), ("centers", 2),
             ("logi", 4), ("stacked_logi", 4))


def gather_corner_features(cr_map: torch.Tensor,
                           dets: torch.Tensor) -> torch.Tensor:
    """Sum the cr feature map at a cell's 4 predicted corners.
    cr_map (B, H, W, D); dets (B, K, 8) feature-map coords -> (B, K, D).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    B, H, W, D = cr_map.shape
    flat = cr_map.reshape(B, H * W, D)
    xs = torch.round(dets[..., 0::2]).long().clamp(0, W - 1)
    ys = torch.round(dets[..., 1::2]).long().clamp(0, H - 1)
    idx = ys * W + xs                                      # (B, K, 4)
    K = idx.shape[1]
    g = gather_feat(flat, idx.reshape(B, K * 4))
    return g.reshape(B, K, 4, D).sum(dim=2)


class LoreModel(nn.Module):
    """The detector (``config.backbone``: "dla34" or "resnet18") computes
    in ``config.dtype`` as the flax modules do: conv, transposed-conv, DCN
    and upsample weights (and conv biases) take that dtype, while BatchNorm
    parameters and statistics and the DCN biases stay f32. The regressor
    is f32. ``plain_dcn=True`` runs every deform conv through its plain
    PyTorch version (a yardstick run for the kernel)."""

    def __init__(self, config: LoreConfig, plain_dcn: bool = False):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.dtype)
        self.detector = build_detector(config)
        self.processor = LoreProcessor(config)
        cast_detector(self.detector, self.dtype, plain_dcn)

    def heads(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pixel_values (B, H, W, 3) normalized, NHWC -> the detector's
        head maps, NHWC f32."""
        x = pixel_values.permute(0, 3, 1, 2).to(
            dtype=self.dtype, memory_format=torch.channels_last)
        return {k: v.permute(0, 2, 3, 1)
                for k, v in self.detector(x).items()}

    def features(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detector + decode + corner-feature aggregation: everything before
        the regressor, without the corner refine. ``inds`` are the slots'
        flat feature-map indices. Under ``wiz_rev`` the path is
        :meth:`detect_decode` -> ``refine_sort`` -> :meth:`gather_logical`
        (:meth:`forward_packed`), so this raises."""
        cfg = self.config
        if cfg.wiz_rev:
            raise ValueError("under wiz_rev the corner refine runs between "
                             "detect_decode and gather_logical; call "
                             "forward_packed")
        out = self.heads(pixel_values)
        hm = torch.sigmoid(out["hm"])
        dets, scores, _clses, centers, inds = decode_boxes_4ps(
            hm[..., 0:1], out["wh"], out["reg"], cfg.max_objs)
        B, H, W, _ = hm.shape
        ax_feat = gather_feat(out["ax"].reshape(B, H * W, -1), inds)
        cr_feat = gather_corner_features(out["cr"], dets)
        return {"feat": ax_feat + cr_feat, "dets": dets, "scores": scores,
                "valid": scores >= cfg.vis_thresh, "centers": centers,
                "inds": inds}

    def logical(self, feat: torch.Tensor, dets: torch.Tensor):
        return self.processor(feat, dets=dets)

    def detect_decode(self, pixel_values: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Detector + both channel decodes, no refine (wiz_rev path).
        ``dc_packed`` (B, K + M, 11): cells [dets 8, score, ind, 0] padded
        to the corner width, then corners [gbox 8, center 2, score]; the
        ax and cr maps stay on the device for :meth:`gather_logical`."""
        cfg = self.config
        out = self.heads(pixel_values)
        hm = torch.sigmoid(out["hm"])
        dets, scores, _c, _centers, inds = decode_boxes_4ps(
            hm[..., 0:1], out["wh"], out["reg"], cfg.max_objs)
        gboxes, gscores, _gc, gcenters, _gi = decode_boxes_4ps(
            hm[..., 1:2], out["st"], out["reg"], cfg.max_corners)
        B, H, W, _ = hm.shape
        cells = torch.cat([dets, scores[..., None], inds.float()[..., None],
                           torch.zeros_like(scores)[..., None]], dim=-1)
        corners = torch.cat([gboxes, gcenters, gscores[..., None]], dim=-1)
        return {"dc_packed": torch.cat([cells, corners], dim=1),
                "ax_flat": out["ax"].reshape(B, H * W, -1),
                "cr_map": out["cr"]}

    def gather_logical(self, ax_flat: torch.Tensor, cr_map: torch.Tensor,
                       dets: torch.Tensor, inds: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
        """Feature gathers at the refined dets + the regressor, packed as
        LORE_PACK (B, K, 20); the centers slot holds zeros."""
        feat = gather_feat(ax_flat, inds) + gather_corner_features(cr_map,
                                                                   dets)
        logi, stacked = self.logical(feat, dets)
        if stacked is None:
            stacked = logi
        valid = scores >= self.config.vis_thresh
        return torch.cat([dets, scores[..., None], valid.float()[..., None],
                          torch.zeros_like(dets[..., :2]), logi, stacked],
                         dim=-1)

    def proc_pack(self, fo: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Regressor + pack into one (B, K, 20) array (layout LORE_PACK)."""
        logi, stacked = self.logical(fo["feat"], fo["dets"])
        if stacked is None:
            stacked = logi
        return torch.cat([fo["dets"], fo["scores"][..., None],
                          fo["valid"].float()[..., None], fo["centers"],
                          logi, stacked], dim=-1)

    def train_forward(self, pixel_values: torch.Tensor, hm_ind: torch.Tensor,
                      gt_dets: torch.Tensor, hm_mask: torch.Tensor,
                      cc_match: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """Teacher-forced training path: the regressor reads features
        gathered at the ground-truth centres ``hm_ind`` (B, M) and corners
        (``gt_dets`` (B, M, 8), rounded, or the deduplicated integer
        positions ``cc_match`` (B, M, 4) when given), masked by ``hm_mask``.
        BatchNorm runs on its stored statistics whatever ``self.training``
        says, as the JAX step does (``train=False``); gradients still reach
        its scale and bias, and no statistic crosses the ranks of a mesh's
        sp axis. There the head maps leave the detector whole
        (``CenterHeads``), so the gathers and the regressor run alike on
        every sp rank. Returns ``heads`` (NHWC f32), ``hm`` (sigmoid),
        ``logi`` and ``stacked_logi``."""
        out = self.heads(pixel_values)
        B, H, W, _ = out["hm"].shape
        ax_feat = gather_feat(out["ax"].reshape(B, H * W, -1), hm_ind)
        if cc_match is not None:
            M = cc_match.shape[1]
            cr = gather_feat(out["cr"].reshape(B, H * W, -1),
                             cc_match.reshape(B, M * 4))
            cr_feat = cr.reshape(B, M, 4, -1).sum(dim=2)
        else:
            cr_feat = gather_corner_features(out["cr"], gt_dets)
        logi, stacked = self.processor(ax_feat + cr_feat, dets=gt_dets,
                                       mask=hm_mask)
        return {"heads": out, "hm": torch.sigmoid(out["hm"]), "logi": logi,
                "stacked_logi": stacked if stacked is not None else logi}

    def forward_packed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Normalized crops -> the packed (B, K, 20) output (layout
        LORE_PACK), left on the device. Under ``wiz_rev``: detect-decode,
        the dense corner refine and stable re-sort, then the feature
        gathers and regressor at the refined slots (the JAX task's
        device-refine chain)."""
        cfg = self.config
        if not cfg.wiz_rev:
            return self.proc_pack(self.features(pixel_values))
        dd = self.detect_decode(pixel_values)
        dets, inds, scores = refine_sort(dd["dc_packed"], cfg.max_objs,
                                         cfg.vis_thresh,
                                         cfg.vis_thresh_corner)
        return self.gather_logical(dd["ax_flat"], dd["cr_map"], dets, inds,
                                   scores)


def unpack_lore(arr):
    """Packed (..., 20) numpy array -> dict of named fields."""
    out, o = {}, 0
    for k, n in LORE_PACK:
        sl = arr[..., o:o + n]
        o += n
        out[k] = sl[..., 0] if n == 1 else sl
    out["valid"] = out["valid"] > 0.5
    return out
