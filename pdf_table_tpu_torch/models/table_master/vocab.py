"""TableMaster/MtlTabNet structure vocabulary (counterpart of
pdf_table_tpu/models/table_master/vocab.py): the PubTabNet structure
alphabet (assets/alphabets/pubtabnet_structure_alphabet.txt) with the
mmocr TableMasterConvertor specials appended at the END — ids =
[dict tokens..., <UKN>, <SOS>, <EOS>, <PAD>] (SLANet puts sos at 0).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ...assets import read_lines

TD_PREFIX_TOKENS = ("<td></td>", "<td")


class MasterStructureVocab:
    """Master-convention structure vocab: specials at the end (V = 43 for
    the PubTabNet alphabet)."""

    def __init__(self, tokens: Optional[Sequence[str]] = None):
        if tokens is None:
            tokens = load_pubtabnet_structure_alphabet()
        base = list(tokens)
        self.tokens: List[str] = base + ["<UKN>", "<SOS>", "<EOS>", "<PAD>"]
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        n = len(self.tokens)
        self.unknown_id = n - 4
        self.sos_id = n - 3
        self.eos_id = n - 2
        self.pad_id = n - 1
        self.ignored_ids = {self.unknown_id, self.sos_id,
                            self.eos_id, self.pad_id}

    def __len__(self) -> int:
        return len(self.tokens)

    def is_td(self, tok: str) -> bool:
        """Tokens that carry a bbox prediction."""
        return tok in TD_PREFIX_TOKENS or tok == "<td>"

    def decode(self, ids: Sequence[int]) -> List[str]:
        out: List[str] = []
        for i, tid in enumerate(ids):
            if i > 0 and tid == self.eos_id:
                break
            if tid in self.ignored_ids:
                continue
            out.append(self.tokens[tid])
        return out


def load_pubtabnet_structure_alphabet() -> List[str]:
    return read_lines("alphabets", "pubtabnet_structure_alphabet.txt")


def load_pubtabnet_textline_alphabet() -> List[str]:
    """MtlTabNet cell-content charset. The convertor appends the same four
    specials; the cell decoder's eos is therefore len(dict) + 2."""
    return read_lines("alphabets", "pubtabnet_textline_alphabet.txt")
