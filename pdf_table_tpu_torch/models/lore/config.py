"""LORE table-structure-recognition config (copy of
pdf_table_tpu/models/lore/config.py).

DLA-34 CenterNet detector with heads {hm:2, st:8, wh:8, ax:256, cr:256,
reg:2}, transformer logical-location regressor (input 256, hidden 256,
4 layers, 8 heads, stacking regressor on top), input resolution 768
(wireless) / 1024 (wtw).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class LoreConfig:
    backbone: str = "dla34"          # dla34 | resnet18
    task_type: str = "wtw"           # wtw | wireless | ptn
    resolution: Tuple[int, int] = (768, 768)
    down_ratio: int = 4
    # decode
    max_objs: int = 300              # K cell slots
    max_corners: int = 600           # MK corner slots
    vis_thresh: float = 0.15
    vis_thresh_corner: float = 0.3   # corner-channel threshold (wiz_rev)
    wiz_rev: bool = False            # snap cell vertices to corner dets
    upper_left: bool = True          # corner-anchored affine (wtw/wireless)
    # processor
    hidden_size: int = 256
    tsfm_layers: int = 4
    stacking_layers: int = 4
    num_heads: int = 8
    d_ff: int = 2048                 # FeedForward width
    max_fmp_size: int = 256          # position-embedding vocab
    wiz_2dpe: bool = True
    wiz_stacking: bool = True
    # heads
    head_conv: int = 256
    num_classes: int = 2             # cell + corner-center channels
    dtype: str = "float32"

    @classmethod
    def wtw(cls, **kw) -> "LoreConfig":
        base = dict(task_type="wtw", resolution=(1024, 1024),
                    wiz_rev=True)
        base.update(kw)
        return cls(**base)

    @classmethod
    def wireless(cls, **kw) -> "LoreConfig":
        base = dict(task_type="wireless", resolution=(768, 768))
        base.update(kw)
        return cls(**base)
