"""Token-path table assembly: match OCR boxes to predicted td bboxes and
weave text into the structure-token stream (the port's copy of
pdf_table_tpu/tasks/table_matcher.py: plain numpy).

Reference: TableMatch (model/ocr_pdf/table/matcher.py:58) — per OCR box,
choose the td bbox minimizing (1-IoU, corner-distance); then walk the
token list appending matched text at each '</td>'. The '<td></td>' token
expands to '<td>text</td>' (get_pred_html:102-138). SLANet uses the plain
path; TableMaster/MtlTabNet set use_master=True, which routes through
get_pred_html_master (matcher.py:144-183): per-cell <b> folding, eb-token
expansion (deal_eb_token) and thead bolding (deal_bb).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .table_master_match import deal_bb, deal_eb_token


def _to_xyxy(box) -> np.ndarray:
    b = np.asarray(box, np.float32).reshape(-1)
    if b.size >= 8:
        return np.array([b[0::2].min(), b[1::2].min(),
                         b[0::2].max(), b[1::2].max()], np.float32)
    return b[:4]


def compute_iou(a, b) -> float:
    a, b = _to_xyxy(a), _to_xyxy(b)
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / ua) if ua > 0 else 0.0


def corner_distance(a, b) -> float:
    """Reference distance (matcher.py:20-26): L1 over both corners plus the
    nearer single-corner L1 — biases toward boxes sharing an edge."""
    a, b = _to_xyxy(a), _to_xyxy(b)
    d_tl = abs(b[0] - a[0]) + abs(b[1] - a[1])
    d_br = abs(b[2] - a[2]) + abs(b[3] - a[3])
    return float(d_tl + d_br + min(d_tl, d_br))


def l1_distance(a, b) -> float:
    a, b = _to_xyxy(a), _to_xyxy(b)
    return float(np.abs(a - b).sum())


def _fold_cell_texts(indices: List[int], texts: Sequence[str]) -> str:
    """Concatenate the texts matched to one td (get_pred_html:104-131 /
    get_pred_html_master:152-172): multi-box cells strip leading spaces and
    per-box <b></b>, re-space between boxes, and re-wrap the whole cell in
    <b> when the first box was bold."""
    if not indices:
        return ""
    multi = len(indices) > 1
    bold = multi and "<b>" in texts[indices[0]]
    parts: List[str] = []
    for k, i in enumerate(indices):
        content = texts[i]
        if multi:
            if not content:
                continue
            if content[0] == " ":
                content = content[1:]
            if "<b>" in content:
                content = content[3:]
            if "</b>" in content:
                content = content[:-4]
            if not content:
                continue
            if k != len(indices) - 1 and content[-1] != " ":
                content += " "
        parts.append(content)
    txt = "".join(parts)
    if bold:
        txt = f"<b>{txt}</b>"
    return txt


class TableMatch:
    def __init__(self, filter_ocr_result: bool = False,
                 use_master: bool = False):
        self.filter_ocr_result = filter_ocr_result
        self.use_master = use_master

    def match_result(self, dt_boxes: Sequence, pred_bboxes: Sequence
                     ) -> Dict[int, List[int]]:
        matched: Dict[int, List[int]] = {}
        for i, gt in enumerate(dt_boxes):
            best_j, best_key = None, None
            for j, pb in enumerate(pred_bboxes):
                key = (1.0 - compute_iou(gt, pb), corner_distance(gt, pb))
                if best_key is None or key < best_key:
                    best_key, best_j = key, j
            if best_j is not None:
                matched.setdefault(best_j, []).append(i)
        return matched

    def get_pred_html(self, tokens: Sequence[str],
                      matched: Dict[int, List[int]],
                      texts: Sequence[str]) -> str:
        out: List[str] = []
        td_index = 0
        for tag in tokens:
            if "</td>" not in tag:
                out.append(tag)
                continue
            if tag == "<td></td>":
                out.append("<td>")
            out.append(_fold_cell_texts(matched.get(td_index, []), texts))
            out.append("</td>" if tag == "<td></td>" else tag)
            td_index += 1
        return "".join(out)

    def get_pred_html_master(self, tokens: Sequence[str],
                             matched: Dict[int, List[int]],
                             texts: Sequence[str]) -> str:
        """Master token walk (matcher.py:144-183): text goes inside the
        closing token, then eb-token expansion per token and one deal_bb
        pass over the joined HTML."""
        out: List[str] = []
        td_index = 0
        for token in tokens:
            if "</td>" in token:
                txt = _fold_cell_texts(matched.get(td_index, []), texts)
                if token == "<td></td>":
                    token = f"<td>{txt}</td>"
                else:
                    token = f"{txt}</td>"
                td_index += 1
            out.append(deal_eb_token(token))
        return deal_bb("".join(out))

    def __call__(self, structure_tokens: Sequence[str],
                 pred_bboxes: Sequence, dt_boxes: Sequence,
                 texts: Sequence[str]) -> str:
        if self.filter_ocr_result and len(pred_bboxes):
            tops = min(_to_xyxy(b)[1] for b in pred_bboxes)
            keep = [i for i, b in enumerate(dt_boxes)
                    if _to_xyxy(b)[3] >= tops]
            dt_boxes = [dt_boxes[i] for i in keep]
            texts = [texts[i] for i in keep]
        matched = self.match_result(dt_boxes, pred_bboxes)
        if self.use_master:
            html = self.get_pred_html_master(structure_tokens, matched,
                                             texts)
        else:
            html = self.get_pred_html(structure_tokens, matched, texts)
        if not html.startswith("<table"):
            html = "<table>" + html + "</table>"
        return html
