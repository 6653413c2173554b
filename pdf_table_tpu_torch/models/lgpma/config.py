"""LGPMA config (a copy of pdf_table_tpu/models/lgpma/config.py).

Reference: model/table/lgpma/lgpma_config.py (mmdet dict config: ResNet-50
+ FPN num_outs=5, RPN anchors scales [4,8,16] x ratios
[0.05,0.1,0.2,0.5,1,2] on strides [4,8,16,32,64], Shared2FCBBoxHead with
2 fg classes and stds [.1,.1,.2,.2], LPMA/GPMA mask heads; test cfg:
rcnn score_thr 0.05, nms 0.1). mmdet's registry machinery is replaced by
this dataclass; dynamic proposal lists become static top-k slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class LgpmaConfig:
    backbone_depth: int = 50
    fpn_channels: int = 256
    max_side: int = 800
    num_classes: int = 2              # fg classes (cell head/body)
    # RPN (lgpma_config.py rpn_head)
    anchor_scales: Tuple[float, ...] = (4.0, 8.0, 16.0)
    anchor_ratios: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0)
    anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    rpn_pre_topk: int = 256           # static per-level top-k (ref 2000
                                      # dynamic; cells are large, the top
                                      # slots saturate far earlier)
    rpn_nms_thresh: float = 0.5
    num_proposals: int = 512          # static post-NMS proposal slots
    # RoI heads
    roi_size: int = 7
    mask_roi_size: int = 14
    fc_dim: int = 1024
    finest_scale: int = 56            # SingleRoIExtractor level routing
    bbox_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    mask_top: int = 256               # static mask-branch slots
    # test cfg (lgpma_config.py test_cfg.rcnn)
    score_thresh: float = 0.05
    nms_thresh: float = 0.1
    mask_thresh: float = 0.5
    refine_bboxes: bool = True        # pyramid-mask boundary refinement
    dtype: str = "float32"
