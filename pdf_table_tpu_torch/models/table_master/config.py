"""TableMaster / MtlTabNet config (counterpart of
pdf_table_tpu/models/table_master/config.py): TableResNetExtra encoder +
Master transformer decoder (D 512, 8 heads, ff 2024, N = 3, 500 steps);
MtlTabNet adds a cell-content branch. In the pipeline cell text comes from
the OCR matcher for both variants, so ``variant`` only switches the
checkpoint layout and the branch's parameters."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class TableMasterConfig:
    variant: str = "table_master"    # table_master | mtl_tabnet
    img_size: Tuple[int, int] = (480, 480)
    d_model: int = 512
    decoder_layers: int = 3      # N: N-1 shared + forked cls/bbox layers
    heads: int = 8
    ff_dim: int = 2024
    max_structure_len: int = 500
    vocab_size: int = 0              # 0 -> MasterStructureVocab default
    dict_path: str = ""
    loc_reg_num: int = 4             # xywh normalized bbox per token
    dtype: str = "float32"
    # MtlTabNet cell-content branch
    cell_vocab_size: int = 0         # 281 for PubTabNet textline alphabet+4
    max_cell_len: int = 150
    cell_slots: int = 0              # fixed K td-cell slots for the decode
    td_token_ids: Tuple[int, ...] = ()  # ids of '<td></td>'/'<td' (2, 8)
