"""In-tree data assets of the port (its own copy of the alphabets that
pdf_table_tpu/assets vendors; the port reads nothing of that package):

- alphabets/pubtabnet_structure_alphabet.txt — TableMaster/MtlTabNet
  structure token alphabet (published with TableMASTER-mmocr,
  Apache-2.0);
- alphabets/pubtabnet_textline_alphabet.txt — MtlTabNet cell-content
  recognition alphabet (same provenance).
"""

from __future__ import annotations

import os
from typing import List

_ROOT = os.path.dirname(os.path.abspath(__file__))


def asset_path(*parts: str) -> str:
    """Absolute path of an asset, e.g.
    ``asset_path("alphabets", "pubtabnet_structure_alphabet.txt")``."""
    p = os.path.join(_ROOT, *parts)
    if not os.path.exists(p):
        raise FileNotFoundError(f"asset not found: {p}")
    return p


def read_lines(*parts: str) -> List[str]:
    """An asset txt as its lines with the line ends stripped; every line,
    a blank one included, is kept (PaddleOCR dict convention: a bare-space
    line is a token)."""
    with open(asset_path(*parts), encoding="utf-8") as f:
        return [ln.rstrip("\r\n") for ln in f]
