"""TableMaster token post-processing + full master matcher (the port's copy
of pdf_table_tpu/tasks/table_master_match.py: plain numpy and ``re``).

Behavior-parity rewrite of the reference master matching pipeline
(model/ocr_pdf/table/table_master_match.py, itself from TableMASTER-mmocr):

- ``deal_eb_token`` (:523) — the PubTabNet training vocab encodes eleven
  empty-cell styles as ``<eb></eb>``..``<eb10></eb10>``; rewrite them to
  their real ``<td>...</td>`` HTML.
- ``deal_isolate_span`` (:587) — repair structure-prediction glitches of
  the form ``<td></td> rowspan="2"></b></td>`` into ``<td rowspan="2"></td>``.
- ``deal_duplicate_bb`` (:628) — keep exactly one <b></b> per thead cell.
- ``deal_bb`` (:664) — bold-normalize every cell inside <thead>.
- ``merge_span_token`` (:465) / ``insert_text_to_token`` (:561) — collapse
  ``<td`` + span attrs + ``>`` + ``</td>`` token runs and weave matched OCR
  text into each td.
- ``TableMasterMatcher`` (:927) — the three-rule OCR↔structure box match
  (center containment → hull IoU → center distance) with virtual master
  rows appended for unmatched OCR lines (Matcher.match:772, _format:851,
  get_merge_result:898).

The cheap active path in the page pipeline is
``TableMatch(use_master=True)`` (tasks/table_matcher.py); this module is
both its token toolbox and the standalone full matcher.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import re

import numpy as np

# ---------------------------------------------------------------------------
# Token-level fixes
# ---------------------------------------------------------------------------

# <ebN></ebN> -> real empty-cell HTML (deal_eb_token:523; the mapping is the
# PubTabNet emptyBboxTokenDict). eb3/eb10 carry U+2028 LINE SEPARATOR
# (reference table_master_match.py:545,553-556) written as backslash-u escapes
# so the invisible character is auditable in source; byte-equality vs the
# reference strings is pinned by tests/test_table_master_match.py.
EB_REWRITES: Tuple[Tuple[str, str], ...] = (
    ("<eb></eb>", "<td></td>"),
    ("<eb1></eb1>", "<td> </td>"),
    ("<eb2></eb2>", "<td><b> </b></td>"),
    ("<eb3></eb3>", "<td>\u2028\u2028</td>"),
    ("<eb4></eb4>", "<td><sup> </sup></td>"),
    ("<eb5></eb5>", "<td><b></b></td>"),
    ("<eb6></eb6>", "<td><i> </i></td>"),
    ("<eb7></eb7>", "<td><b><i></i></b></td>"),
    ("<eb8></eb8>", "<td><b><i> </i></b></td>"),
    ("<eb9></eb9>", "<td><i></i></td>"),
    ("<eb10></eb10>", "<td><b> \u2028 \u2028 </b></td>"),
)


def deal_eb_token(token: str) -> str:
    for eb, html in EB_REWRITES:
        token = token.replace(eb, html)
    return token


_SPAN_ATTRS = r'(?: rowspan="\d+"| colspan="\d+"){1,2}'

# '<td></td> rowspan="2"></b></td>' and friends (deal_isolate_span:587).
_ISOLATE_RE = re.compile(r"<td></td>(" + _SPAN_ATTRS + r")></b></td>")


def deal_isolate_span(thead_part: str) -> str:
    return _ISOLATE_RE.sub(r"<td\1></td>", thead_part)


_TD_ITEM_RE = re.compile(r"<td(?:" + _SPAN_ATTRS + r")?>.*?</td>")


def deal_duplicate_bb(thead_part: str) -> str:
    """One <b></b> pair per thead td (deal_duplicate_bb:628)."""

    def fix(m: "re.Match[str]") -> str:
        td = m.group(0)
        if td.count("<b>") <= 1 and td.count("</b>") <= 1:
            return td
        td = td.replace("<b>", "").replace("</b>", "")
        # span-attributed cells keep their opening tag; only the plain
        # '<td>' spelling is re-bolded (reference does the same literal
        # replace, :644-647)
        return td.replace("<td>", "<td><b>").replace("</td>", "</b></td>")

    return _TD_ITEM_RE.sub(fix, thead_part)


_THEAD_RE = re.compile(r"<thead>(.*?)</thead>", re.S)
_TD_OPEN_SPAN_RE = re.compile(r"<td" + _SPAN_ATTRS + r">")


def deal_bb(result_token: str) -> str:
    """Bold-normalize <thead> content (deal_bb:664): every header cell gets
    exactly one <b></b> around its text; empty cells stay bare."""
    m = _THEAD_RE.search(result_token)
    if m is None:
        return result_token
    thead = origin = m.group(0)

    span_opens = _TD_OPEN_SPAN_RE.findall(thead)
    if not span_opens:
        thead = (thead.replace("<td>", "<td><b>")
                 .replace("</td>", "</b></td>")
                 .replace("<b><b>", "<b>")
                 .replace("</b></b>", "</b>"))
    else:
        for sp in dict.fromkeys(span_opens):  # unique, order kept
            thead = thead.replace(sp, sp + "<b>")
        thead = thead.replace("</td>", "</b></td>")
        thead = re.sub(r"(<b>)+", "<b>", thead)
        thead = re.sub(r"(</b>)+", "</b>", thead)
        thead = thead.replace("<td>", "<td><b>").replace("<b><b>", "<b>")

    # empty cell has no <b></b>; the space cell keeps it (:728)
    thead = thead.replace("<td><b></b></td>", "<td></td>")
    thead = deal_duplicate_bb(thead)
    thead = deal_isolate_span(thead)
    return result_token.replace(origin, thead)


# ---------------------------------------------------------------------------
# Structure-token stream assembly
# ---------------------------------------------------------------------------


def merge_span_token(tokens: Sequence[str]) -> List[str]:
    """Collapse '<td' [span-attr]{1,2} '>' '</td>' runs into one token and
    guarantee a trailing '</tbody>' (merge_span_token:465)."""
    toks = list(tokens)
    if not toks or toks[-1] != "</tbody>":
        toks.append("</tbody>")
    out: List[str] = []
    i = 0
    while toks[i] != "</tbody>":
        t = toks[i]
        if t == "<td":
            j = i + 1
            while j < len(toks) and toks[j].startswith((" colspan=",
                                                        " rowspan=")):
                j += 1
            # expect '>' then '</td>' — take them if present
            k = j
            if k < len(toks) and toks[k] == ">":
                k += 1
            if k < len(toks) and toks[k] == "</td>":
                k += 1
            out.append("".join(toks[i:k]))
            i = k
        else:
            out.append(t)
            i += 1
        if i >= len(toks):
            break
    out.append("</tbody>")
    return out


def insert_text_to_token(tokens: Sequence[str],
                         match_text: Dict[int, str]) -> str:
    """Weave matched text into the merged td tokens; td slots count in
    order of '<td'-prefixed tokens (insert_text_to_token:561). Tokens past
    the last matched slot are dropped like the reference (:573-577)."""
    merged = merge_span_token(tokens)
    out: List[str] = []
    slot = 0
    n_texts = len(match_text)
    for tok in merged:
        if tok.startswith("<td"):
            if slot > n_texts - 1 or slot not in match_text:
                slot += 1
                continue
            tok = tok.replace("><", ">{}<".format(match_text[slot]))
            slot += 1
        out.append(deal_eb_token(tok))
    return "".join(out)


# ---------------------------------------------------------------------------
# Geometry + the three match rules
# ---------------------------------------------------------------------------


def _xyxy(box) -> np.ndarray:
    b = np.asarray(box, np.float64).reshape(-1)
    if b.size >= 8:
        return np.array([b[0::2].min(), b[1::2].min(),
                         b[0::2].max(), b[1::2].max()])
    return b[:4].astype(np.float64)


def _centers(xyxy: np.ndarray) -> np.ndarray:
    return np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2,
                     (xyxy[:, 1] + xyxy[:, 3]) / 2], axis=1)


def _hull_area(points: np.ndarray) -> float:
    """Convex-hull area (monotone chain). The reference computes the IoU
    union as MultiPoint(corners).convex_hull.area (cal_iou:118)."""
    pts = np.unique(points.reshape(-1, 2), axis=0)
    if len(pts) < 3:
        return 0.0
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        h: List[np.ndarray] = []
        for p in seq:
            while len(h) >= 2 and np.cross(h[-1] - h[-2], p - h[-2]) <= 0:
                h.pop()
            h.append(p)
        return h

    hull = half(pts)[:-1] + half(pts[::-1])[:-1]
    if len(hull) < 3:
        return 0.0
    hull_a = np.asarray(hull)
    x, y = hull_a[:, 0], hull_a[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2.0)


def _rect_corners(b: np.ndarray) -> np.ndarray:
    return np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]])


def hull_iou(a: np.ndarray, b: np.ndarray) -> float:
    """intersection / convex-hull-union IoU on axis-aligned boxes
    (cal_iou:118 with rectangle inputs)."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    if inter <= 0:
        return 0.0
    union = _hull_area(np.concatenate([_rect_corners(a), _rect_corners(b)]))
    return inter / union if union > 0 else 0.0


def match_ocr_to_master(ocr_xyxy: np.ndarray,
                        master_xyxy: np.ndarray) -> List[List[int]]:
    """Three-rule match (Matcher.match:772). Returns [ocr_i, master_j]
    pairs; an OCR box can match several masters under the center rule, and
    rule 3 guarantees every master box at least one OCR partner when any
    OCR boxes remain."""
    pairs: List[List[int]] = []
    n_ocr, n_master = len(ocr_xyxy), len(master_xyxy)
    if n_master == 0 or n_ocr == 0:
        return pairs
    oc = _centers(ocr_xyxy)

    # rule 1: OCR center inside master box (center_rule_match:310)
    inside = ((oc[:, None, 0] >= master_xyxy[None, :, 0])
              & (oc[:, None, 0] <= master_xyxy[None, :, 2])
              & (oc[:, None, 1] >= master_xyxy[None, :, 1])
              & (oc[:, None, 1] <= master_xyxy[None, :, 3]))
    for i, j in zip(*np.nonzero(inside)):
        pairs.append([int(i), int(j)])

    # rule 2: best hull-IoU for still-unmatched OCR boxes (iou_rule_match:332)
    matched_ocr = {p[0] for p in pairs}
    for i in range(n_ocr):
        if i in matched_ocr:
            continue
        best_j, best_iou = None, 0.0
        for j in range(n_master):
            iou = hull_iou(ocr_xyxy[i], master_xyxy[j])
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_j is not None:
            pairs.append([i, best_j])

    # rule 3: nearest-center OCR for still-unmatched master boxes
    # (distance_rule_match:362)
    matched_ocr = {p[0] for p in pairs}
    matched_master = {p[1] for p in pairs}
    free_ocr = [i for i in range(n_ocr) if i not in matched_ocr]
    free_master = [j for j in range(n_master) if j not in matched_master]
    if free_ocr and free_master:
        mc = _centers(master_xyxy)
        for j in free_master:
            d = np.hypot(oc[free_ocr, 0] - mc[j, 0],
                         oc[free_ocr, 1] - mc[j, 1])
            pairs.append([int(free_ocr[int(np.argmin(d))]), j])
    return pairs


def sort_rows(ocr_xyxy: np.ndarray, idxs: Sequence[int],
              y_thresh: float = 3.0) -> List[List[int]]:
    """Group leftover OCR boxes into rows by center-y proximity, sort rows
    top-down and boxes left-right (sort_bbox:225)."""
    centers = _centers(ocr_xyxy[list(idxs)]) if len(idxs) else \
        np.zeros((0, 2))
    rows: List[List[int]] = []
    row_y: List[float] = []
    for k, i in enumerate(idxs):
        cy = centers[k, 1]
        for r, y0 in enumerate(row_y):
            if abs(cy - y0) < y_thresh:
                rows[r].append(i)
                break
        else:
            rows.append([i])
            row_y.append(float(cy))
    order = np.argsort(row_y, kind="stable")
    out: List[List[int]] = []
    for r in order:
        xs = _centers(ocr_xyxy[rows[r]])[:, 0]
        out.append([rows[r][k] for k in np.argsort(xs, kind="stable")])
    return out


# ---------------------------------------------------------------------------
# Text merging
# ---------------------------------------------------------------------------


def reduce_repeat_bb(texts: List[str], break_token: str) -> List[str]:
    """['<b>A</b>', '<b>B</b>'] -> ['<b>A B</b>'] (reduce_repeat_bb:430)."""
    if texts and all(t.startswith("<b>") for t in texts):
        inner = [t.replace("<b>", "").replace("</b>", "") for t in texts]
        return ["<b>" + break_token.join(inner) + "</b>"]
    return texts


def build_match_text(pairs: Sequence[Sequence[int]],
                     texts: Sequence[str],
                     break_token: str = " ") -> Dict[int, str]:
    """master index -> joined text (get_match_dict:412 +
    get_match_text_dict:448)."""
    per_master: Dict[int, List[int]] = {}
    for i, j in pairs:
        per_master.setdefault(j, []).append(i)
    out: Dict[int, str] = {}
    for j, idx_list in per_master.items():
        t = reduce_repeat_bb([texts[i] for i in idx_list], break_token)
        out[j] = break_token.join(t)
    return out


# ---------------------------------------------------------------------------
# Full matcher
# ---------------------------------------------------------------------------


class TableMasterMatcher:
    """(structure tokens, master bboxes) × (OCR boxes, texts) -> table HTML.

    Mirrors TableMasterMatcher:927 / Matcher.match:772 / _format:851 /
    get_merge_result:898: three-rule matching, virtual master rows for
    leftover OCR lines when the token stream was truncated, text weaving,
    eb-token expansion and thead bolding.
    """

    def __call__(self, structure_tokens: Sequence[str],
                 pred_bboxes: Sequence, dt_boxes: Sequence,
                 texts: Sequence[str]) -> str:
        master_xyxy = np.array([_xyxy(b) for b in pred_bboxes]
                               ).reshape(-1, 4)
        # drop all-zero padded master boxes (remove_empty_bboxes:34)
        keep = ~np.all(master_xyxy == 0, axis=1)
        master_xyxy = master_xyxy[keep]
        ocr_xyxy = np.array([_xyxy(b) for b in dt_boxes]).reshape(-1, 4)

        pairs = match_ocr_to_master(ocr_xyxy, master_xyxy)

        # leftover OCR lines -> virtual master rows (match:846-858)
        matched_ocr = {p[0] for p in pairs}
        leftover = [i for i in range(len(ocr_xyxy)) if i not in matched_ocr]
        tokens = list(structure_tokens)
        if leftover and tokens and tokens[-1] != "</tbody>":
            rows = sort_rows(ocr_xyxy, leftover)
            j = len(master_xyxy)
            for row in rows:
                for i in row:
                    pairs.append([i, j])
                    j += 1
            # extend the truncated token stream with the virtual rows
            # (_format:869-887)
            if tokens[-1] == "<td></td>":
                tokens.append("</tr>")
            for row in rows:
                tokens.append("<tr>")
                tokens.extend(["<td></td>"] * len(row))
                tokens.append("</tr>")
            tokens.append("</tbody>")

        match_text = build_match_text(pairs, list(texts))
        html = insert_text_to_token(tokens, match_text)
        html = deal_bb(html)
        if not html.startswith("<table"):
            html = "<table>" + html + "</table>"
        return html
