"""Structure-token vocabulary of SLANet (counterpart of
pdf_table_tpu/models/slanet/vocab.py): the PP-StructureV2 en table
structure dict, HTML tags plus span attributes, with sos at 0 and eos at
the end (the AttnLabelDecode convention).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

# PP-StructureV2 en table structure dict (merge_no_span_structure=True form)
STRUCTURE_TOKENS: List[str] = [
    "<thead>", "</thead>", "<tbody>", "</tbody>", "<tr>", "</tr>",
    "<td></td>", "<td", ">", "</td>",
] + [f' colspan="{i}"' for i in range(2, 21)] \
  + [f' rowspan="{i}"' for i in range(2, 21)]

TD_TOKENS = ("<td>", "<td", "<td></td>")


class StructureVocab:
    """sos at 0, eos at the end."""

    def __init__(self, tokens: Optional[Sequence[str]] = None):
        tokens = list(tokens if tokens is not None else STRUCTURE_TOKENS)
        self.tokens: List[str] = ["sos"] + tokens + ["eos"]
        self.token_to_id: Dict[str, int] = {t: i for i, t in
                                            enumerate(self.tokens)}
        self.sos_id = 0
        self.eos_id = len(self.tokens) - 1

    def __len__(self) -> int:
        return len(self.tokens)

    def is_td(self, tok: str) -> bool:
        return tok in TD_TOKENS

    def decode(self, ids: Sequence[int]) -> List[str]:
        """Tokens up to the first eos after step 0, sos and eos left out."""
        out = []
        for i, tid in enumerate(ids):
            if i > 0 and tid == self.eos_id:
                break
            if tid in (self.sos_id, self.eos_id):
                continue
            out.append(self.tokens[tid])
        return out

    @classmethod
    def from_dict_file(cls, path: str,
                       merge_no_span_structure: bool = True
                       ) -> "StructureVocab":
        """A PaddleOCR structure dict file; with
        ``merge_no_span_structure`` "<td></td>" is added and "<td>"
        dropped."""
        with open(path, encoding="utf-8") as f:
            toks = [ln.rstrip("\r\n") for ln in f if ln.strip()]
        if merge_no_span_structure:
            if "<td></td>" not in toks:
                toks.append("<td></td>")
            if "<td>" in toks:
                toks.remove("<td>")
        return cls(toks)
