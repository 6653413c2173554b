"""HTML table result comparison (counterpart of
pdf_table_tpu/tasks/result_compare.py): ``TableResultCompare`` sorts two
results into the ``HtmlTableCompareType`` buckets (same, same after the
width is stripped, text order, spans, missing words), and
``check_pred_table_html`` adds the per-cell diffs, the opcode dump and an
HTML report. The table HTML is parsed by the port's own parser
(``utils/html_tree.py``), which builds lxml's tree, not by lxml."""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from ..entity.enums import HtmlTableCompareType
from ..utils.html_tree import fromstring


def _cells_of(html: str) -> List[Tuple[str, int, int]]:
    """[(text, rowspan, colspan)] in document order."""
    try:
        doc = fromstring(html)
    except ValueError:  # no element, or an encoding declaration
        return []
    out = []
    for td in doc.iter_tags("td", "th"):
        text = "".join(td.itertext()).strip()
        out.append((text, int(td.get("rowspan", 1) or 1),
                    int(td.get("colspan", 1) or 1)))
    return out


def _strip_width(html: str) -> str:
    return re.sub(r'\s*(?:width|style)="[^"]*"', "", html)


def _norm(html: str) -> str:
    return re.sub(r">\s+<", "><", html.strip())


class TableResultCompare:
    def __call__(self, pred_html: str, label_html: str) -> Dict[str, Any]:
        result: Dict[str, Any] = {"type": HtmlTableCompareType.DIFF}
        if _norm(pred_html) == _norm(label_html):
            result["type"] = HtmlTableCompareType.SAME
            return result
        if _norm(_strip_width(pred_html)) == _norm(_strip_width(label_html)):
            result["type"] = HtmlTableCompareType.REMOVE_WIDTH_SAME
            return result

        pc = _cells_of(pred_html)
        lc = _cells_of(label_html)
        p_texts = [c[0] for c in pc]
        l_texts = [c[0] for c in lc]
        if p_texts == l_texts:
            # same text, different spans
            p_spans = [(c[1], c[2]) for c in pc]
            l_spans = [(c[1], c[2]) for c in lc]
            row_diff = any(a[0] != b[0] for a, b in zip(p_spans, l_spans))
            col_diff = any(a[1] != b[1] for a, b in zip(p_spans, l_spans))
            if row_diff and col_diff:
                result["type"] = HtmlTableCompareType.DIFF_CELL_ROW_COL_SPAN
            elif row_diff:
                result["type"] = HtmlTableCompareType.DIFF_CELL_ROW_SPAN
            elif col_diff:
                result["type"] = HtmlTableCompareType.DIFF_CELL_COL_SPAN
            else:
                result["type"] = HtmlTableCompareType.DIFF_CELL_SPAN_SAME
            return result
        if sorted(p_texts) == sorted(l_texts):
            result["type"] = HtmlTableCompareType.DIFF_TEXT_ORDER
            return result
        p_joined = " ".join(p_texts)
        l_joined = " ".join(l_texts)
        p_words = set(p_joined.split())
        l_words = set(l_joined.split())
        if p_words < l_words:
            result["type"] = HtmlTableCompareType.DIFF_TEXT_PREDICT_LESS_WORDS
        elif l_words < p_words:
            result["type"] = HtmlTableCompareType.DIFF_TEXT_LABEL_LESS_WORDS
        else:
            result["type"] = HtmlTableCompareType.DIFF_TEXT_INCONSISTENT
        result["pred_cells"] = len(pc)
        result["label_cells"] = len(lc)
        return result


# -- per-cell diff report (table_result_compare.py:28-542 depth) -----------


def _rows_of(html: str) -> List[List[Tuple[str, int, int]]]:
    """[[(text, rowspan, colspan)] per <tr>] in document order."""
    try:
        doc = fromstring(html)
    except ValueError:  # no element, or an encoding declaration
        return []
    rows = []
    for tr in doc.iter_tags("tr"):
        row = []
        for td in tr.child_tags("td", "th"):
            text = "".join(td.itertext()).strip()
            row.append((text, int(td.get("rowspan", 1) or 1),
                        int(td.get("colspan", 1) or 1)))
        rows.append(row)
    return rows


def char_count_diff(a: str, b: str) -> Dict[str, int]:
    """Per-character frequency difference |count_a - count_b| for chars
    whose counts differ (reference CommonUtils.calc_pair_sentences_diff)."""
    from collections import Counter

    ca, cb = Counter(a), Counter(b)
    out: Dict[str, int] = {}
    for ch in set(ca) | set(cb):
        d = abs(ca.get(ch, 0) - cb.get(ch, 0))
        if d:
            out[ch] = d
    return out


def per_cell_text_diff(pred_rows, label_rows) -> List[Dict[str, Any]]:
    """Per-cell text diff items with the reference bucket taxonomy
    (get_table_text_cell_diff, table_result_compare.py:318-370)."""
    diffs: List[Dict[str, Any]] = []
    for ri, (prow, lrow) in enumerate(zip(pred_rows, label_rows)):
        for ci, (pcell, lcell) in enumerate(zip(prow, lrow)):
            ptext, ltext = pcell[0], lcell[0]
            if ptext == ltext:
                continue
            dc = char_count_diff(ptext, ltext)
            diff_len = sum(dc.values())
            if diff_len == 0:
                ctype = HtmlTableCompareType.DIFF_TEXT_ORDER
            elif len(ptext) > len(ltext):
                ctype = HtmlTableCompareType.DIFF_TEXT_LABEL_LESS_WORDS
            elif len(ptext) == len(ltext):
                ctype = HtmlTableCompareType.DIFF_TEXT_INCONSISTENT
            else:
                ctype = HtmlTableCompareType.DIFF_TEXT_PREDICT_LESS_WORDS
            diffs.append({
                "compare_type": ctype.desc, "row_index": ri + 1,
                "column_index": ci + 1, "pred_text": ptext,
                "label_text": ltext, "pred_len": len(ptext),
                "label_len": len(ltext), "diff_len": diff_len,
                "diff_char": len(dc), "diff_content": dc,
            })
    return diffs


def per_cell_structure_diff(pred_rows, label_rows) -> List[Dict[str, Any]]:
    """Per-cell span diff items (get_table_structure_cell_diff,
    table_result_compare.py:372-444)."""
    diffs: List[Dict[str, Any]] = []
    totals = {
        "pred_row_total": len(pred_rows),
        "label_row_total": len(label_rows),
        "diff_row_total": len(pred_rows) - len(label_rows),
        "pred_cell_total": sum(len(r) for r in pred_rows),
        "label_cell_total": sum(len(r) for r in label_rows),
    }
    totals["diff_cell_total"] = (totals["pred_cell_total"]
                                 - totals["label_cell_total"])
    if len(pred_rows) != len(label_rows):
        totals["compare_type"] = HtmlTableCompareType.DIFF_CELL_DIFF_ROW.desc
        return [totals]
    for ri, (prow, lrow) in enumerate(zip(pred_rows, label_rows)):
        for ci in range(max(len(prow), len(lrow))):
            p = prow[ci] if ci < len(prow) else None
            la = lrow[ci] if ci < len(lrow) else None
            if p is None or la is None or (p[1], p[2]) == (la[1], la[2]):
                continue
            dr, dc = p[1] - la[1], p[2] - la[2]
            if dr == 0:
                ctype = HtmlTableCompareType.DIFF_CELL_COL_SPAN
            elif dc == 0:
                ctype = HtmlTableCompareType.DIFF_CELL_ROW_SPAN
            else:
                ctype = HtmlTableCompareType.DIFF_CELL_ROW_COL_SPAN
            diffs.append({
                "compare_type": ctype.desc, "row_index": ri + 1,
                "column_index": ci + 1,
                "pred_span": (p[1], p[2]), "label_span": (la[1], la[2]),
                "diff_row": dr, "diff_col": dc,
            })
    if not diffs and totals["diff_cell_total"]:
        totals["compare_type"] = \
            HtmlTableCompareType.DIFF_CELL_ROW_COL_SPAN.desc
        diffs.append(totals)
    return diffs


def opcode_diff(a: str, b: str, show_length: int = 50) -> List[list]:
    """SequenceMatcher opcodes over the normalized HTML strings
    (compare_diff, table_result_compare.py:180-204)."""
    import difflib

    s = difflib.SequenceMatcher(None, a, b)
    return [[tag, i1, i2, j1, j2, a[i1:i2][:show_length],
             b[j1:j2][:show_length]]
            for tag, i1, i2, j1, j2 in s.get_opcodes()]


def html_diff_report(pred_html: str, label_html: str,
                     check: Dict[str, Any]) -> str:
    """Self-contained HTML report: verdict, side-by-side rendered tables,
    per-cell diff table (the reference writes *_show blocks + opcode dump
    into its comparison html, check_pred_table_html:118-147)."""
    rows = []
    for d in check.get("cell_text_diffs", []) \
            + check.get("cell_structure_diffs", []):
        rows.append(
            "<tr>" + "".join(
                f"<td>{d.get(k, '')}</td>" for k in
                ("compare_type", "row_index", "column_index", "pred_text",
                 "label_text", "pred_span", "label_span")) + "</tr>")
    ops = "".join(f"<li><code>{op[0]} a[{op[1]}:{op[2]}] -> "
                  f"b[{op[3]}:{op[4]}] {op[5]!r} -> {op[6]!r}</code></li>"
                  for op in check.get("opcodes", [])
                  if op[0] != "equal")
    return (
        "<html><body>"
        f"<h2>verdict: {check['check_type']}</h2>"
        "<table border='1'><tr><th>prediction</th><th>label</th></tr>"
        f"<tr><td>{pred_html}</td><td>{label_html}</td></tr></table>"
        "<h3>per-cell diffs</h3>"
        "<table border='1'><tr><th>type</th><th>row</th><th>col</th>"
        "<th>pred text</th><th>label text</th><th>pred span</th>"
        "<th>label span</th></tr>" + "".join(rows) + "</table>"
        "<h3>opcode diff</h3><ul>" + ops + "</ul>"
        "</body></html>")


def check_pred_table_html(pred_html: str, label_html: str
                          ) -> Tuple[bool, Dict[str, Any]]:
    """Full check surface (check_pred_table_html,
    table_result_compare.py:33): returns (acceptable, metric dict with the
    per-cell diff buckets and an HTML diff report)."""
    compare = TableResultCompare()(pred_html, label_html)
    ctype: HtmlTableCompareType = compare["type"]
    flag = ctype in (HtmlTableCompareType.SAME,
                     HtmlTableCompareType.REMOVE_WIDTH_SAME,
                     HtmlTableCompareType.DIFF_CELL_SPAN_SAME)

    a = _norm(_strip_width(pred_html))
    b = _norm(_strip_width(label_html))
    ops = opcode_diff(a, b)
    # one-character tolerance (analysis_diff_result:208-237)
    if not flag and len(ops) == 3 and ops[0][0] == "equal" \
            and ops[2][0] == "equal":
        tag, i1, i2, j1, j2 = ops[1][:5]
        if tag == "delete" and i2 - i1 == 1:
            flag = True
            ctype = HtmlTableCompareType.SAME_LABEL_MISSING_ONE_CHARACTER
        elif tag == "replace" and i2 - i1 == 1 and j2 - j1 == 1:
            flag = True
            ctype = HtmlTableCompareType.SAME_LABEL_GARBLED_ONE_CHARACTER

    pred_rows = _rows_of(pred_html)
    label_rows = _rows_of(label_html)
    metric = {
        "flag": flag,
        "check_type": ctype.name.lower(),
        "compare": compare,
        "opcodes": ops,
        "cell_text_diffs": per_cell_text_diff(pred_rows, label_rows),
        "cell_structure_diffs": per_cell_structure_diff(pred_rows,
                                                        label_rows),
    }
    metric["diff_report_html"] = html_diff_report(pred_html, label_html,
                                                  metric)
    return flag, metric
