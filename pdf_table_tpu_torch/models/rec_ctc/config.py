"""Text-recognition (CTC family) config (copy of
pdf_table_tpu/models/rec_ctc/config.py).

The default is the PP-OCRv4 recognizer (``svtr_lcnet``: PP-LCNet conv
stages + SVTR global-mixer blocks + CTC head), registered as
``PP-OCRv4_rec`` in the JAX package; ``crnn`` and ``convnext_vit`` have
their constructors, ``lightweight_edge`` is built by
tasks/recognition.py's name table as the JAX registry builds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class RecConfig:
    # crnn | svtr_lcnet | convnext_vit | lightweight_edge
    backbone: str = "svtr_lcnet"
    # input geometry: PP rec = (3, 48, W); CRNN/ConvNextViT = gray (1, 32, W)
    img_channels: int = 3
    img_height: int = 48
    img_width: int = 320
    # width buckets for aspect-ratio batching (a fixed set of shapes)
    width_buckets: Tuple[int, ...] = (80, 160, 240, 320, 480, 640)
    max_text_len: int = 80
    # head
    hidden_size: int = 64          # CRNN BiLSTM hidden
    vocab_size: int = 97           # 95 printable + blank + space handling
    charset_name: str = "en"       # en | lang key | dict file path
    use_space_char: bool = True
    blank_id: int = 0
    # SVTR-LCNet: MobileNetV1Enhance scale + EncoderWithSVTR
    # dims/depth/hidden/heads
    svtr_scale: float = 0.5
    svtr_dims: int = 64
    svtr_depth: int = 2
    svtr_hidden: int = 120
    svtr_heads: int = 8
    # ConvNextViT chunking
    chunk_width: int = 300
    chunk_overlap: int = 48
    # ConvNextViT architecture
    convnext_depths: Tuple[int, ...] = (3, 3, 8, 3)
    convnext_hidden: Tuple[int, ...] = (96, 192, 256, 512)
    vit_dim: int = 192
    vit_layers: int = 12
    vit_heads: int = 3
    vit_pos_len: int = 75
    dtype: str = "float32"

    @classmethod
    def crnn(cls, **kw) -> "RecConfig":
        base = dict(backbone="crnn", img_channels=1, img_height=32,
                    img_width=320, hidden_size=256)
        base.update(kw)
        return cls(**base)

    @classmethod
    def convnext_vit(cls, **kw) -> "RecConfig":
        # the model only ever sees chunk-width images (804 -> 3 x 300), so
        # the single width bucket is the chunk width; the ViT position
        # table is 75 = 300 / 4
        base = dict(backbone="convnext_vit", img_channels=1, img_height=32,
                    img_width=804, width_buckets=(300,))
        base.update(kw)
        return cls(**base)
