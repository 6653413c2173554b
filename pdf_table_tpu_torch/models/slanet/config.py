"""SLANet config (counterpart of pdf_table_tpu/models/slanet/config.py):
input padded to ``table_max_len`` = 488, hidden 256, PP-LCNet 1.0 trunk,
CSP-PAN neck 96, 500 decode steps."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SLANetConfig:
    table_max_len: int = 488
    hidden_size: int = 256
    loc_reg_num: int = 8          # 4-point bbox regression (normalized)
    max_structure_len: int = 500  # decode steps (all of them run)
    vocab_size: int = 0           # 0 -> derived from StructureVocab
    dict_path: str = ""           # optional structure dict file
    merge_no_span_structure: bool = True
    lcnet_scale: float = 1.0      # PPLCNet backbone width
    neck_channels: int = 96       # CSPPAN out channels (PaddleOCR SLANet)
    dtype: str = "float32"
