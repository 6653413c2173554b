"""DBNet text-detection config (copy of pdf_table_tpu/models/dbnet/config.py).

``DbNetConfig.ppocr`` is the PaddleOCR PP-OCRv4 detector (MobileNetV3 +
RSE-FPN + DB head, limit-side resize, imagenet normalization), registered
as ``PP-OCRv4_det`` in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DbNetConfig:
    # architecture
    backbone: str = "resnet18"      # resnet18 | resnet50 | mobilenetv3
    inner_channels: int = 256
    k: float = 50.0                 # differentiable-binarization steepness
    # preprocessing: "short" = ModelScope short-side resize to /32;
    # "limit" = PaddleOCR max-side limit
    resize_mode: str = "short"
    image_short_side: int = 736
    limit_side_len: int = 960
    limit_type: str = "max"
    # ModelScope: BGR, mean-sub then /255; imagenet: /255 then mean/std
    norm_style: str = "modelscope"  # modelscope | imagenet
    # postprocess
    thresh: float = 0.2
    box_thresh: float = 0.3
    unclip_ratio: float = 1.5
    max_candidates: int = 1000
    min_size: int = 3
    return_polygon: bool = False
    # runtime
    dtype: str = "float32"

    @classmethod
    def ppocr(cls, **kw) -> "DbNetConfig":
        """PaddleOCR PP-OCRv4-style detector defaults."""
        base = dict(backbone="mobilenetv3", inner_channels=96,
                    resize_mode="limit", norm_style="imagenet",
                    thresh=0.3, box_thresh=0.6, unclip_ratio=1.5)
        base.update(kw)
        return cls(**base)
