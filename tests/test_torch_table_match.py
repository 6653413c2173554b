"""The token path of table HTML in the port against the JAX package, byte
for byte: ``table_master_match`` (eb-token rewrites, thead fixes, span
merge, text insertion, the three-rule master matcher), ``TableMatch``
(SLANet's walk and the master route) and ``OcrTableToHtmlTask`` on token
results (SLANet texts escaped, master texts raw, page offsets), on the
cases of tests/test_table_master_match.py and tests/test_slanet.py, on
seeded random token streams and box sets, and on the golden corpus's two
token cases (tests/golden/expected/token_*.html)."""

import os
import sys

import numpy as np
import pytest

from pdf_table_tpu.entity.ocr_cell import OcrCell as JCell
from pdf_table_tpu.models.slanet.vocab import STRUCTURE_TOKENS
from pdf_table_tpu.tasks import table_master_match as jtmm
from pdf_table_tpu.tasks import table_matcher as jtm
from pdf_table_tpu.tasks import table_to_html as jt2h
from pdf_table_tpu_torch.entity.ocr_cell import OcrCell as TCell
from pdf_table_tpu_torch.models.table_master.vocab import \
    load_pubtabnet_structure_alphabet
from pdf_table_tpu_torch.tasks import table_master_match as ttmm
from pdf_table_tpu_torch.tasks import table_matcher as ttm
from pdf_table_tpu_torch.tasks import table_to_html as tt2h

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

EB = [f"<eb{i}></eb{i}>" if i else "<eb></eb>" for i in range(11)]

STRING_CASES = [
    ("deal_eb_token", "<tr><eb10></eb10><eb1></eb1></tr>"),
    ("deal_isolate_span", '<td></td> rowspan="2"></b></td>'),
    ("deal_isolate_span", '<td></td> colspan="3"></b></td>'),
    ("deal_isolate_span", '<td></td> rowspan="2" colspan="3"></b></td>'),
    ("deal_isolate_span", '<td rowspan="2">x</td>'),
    ("deal_duplicate_bb", "<td><b>A</b> <b>B</b></td>"),
    ("deal_duplicate_bb", "<td><b>A</b></td>"),
    ("deal_bb", "<thead><tr><td>h1</td><td></td></tr></thead>"
                "<tbody><tr><td>x</td></tr></tbody>"),
    ("deal_bb", '<thead><tr><td colspan="2">h</td><td>g</td></tr></thead>'),
    ("deal_bb", "<thead><tr><td><b>h</b></td></tr></thead>"),
    ("deal_bb", "<table><tbody><tr><td>no head</td></tr></tbody></table>"),
] + [("deal_eb_token", eb) for eb in EB]


@pytest.mark.parametrize("fn,arg", STRING_CASES)
def test_string_fixes_match_jax(fn, arg):
    assert getattr(ttmm, fn)(arg) == getattr(jtmm, fn)(arg)


@pytest.mark.parametrize("tokens", [
    ["<tr>", "<td", ' colspan="3"', ">", "</td>", "<td></td>", "</tr>",
     "</tbody>"],
    ["<td", ' rowspan="2"', ' colspan="3"', ">", "</td>"],
    ["<tr>", "<td></td>", "<eb></eb>", "<td></td>", "</tr>", "</tbody>"]])
def test_span_merge_and_text_insertion_match_jax(tokens):
    assert ttmm.merge_span_token(tokens) == jtmm.merge_span_token(tokens)
    texts = {0: "A", 1: "B & <i>c</i>", 5: "dropped"}
    assert ttmm.insert_text_to_token(tokens, texts) == \
        jtmm.insert_text_to_token(tokens, texts)


def _master_case():
    master = np.array([[0, 0, 50, 20], [60, 0, 110, 20]], np.float64)
    ocr = np.array([[5, 5, 45, 15], [48, 2, 72, 18], [200, 200, 220, 210]],
                   np.float64)
    return ocr, master


def test_master_match_matches_jax():
    ocr, master = _master_case()
    assert ttmm.match_ocr_to_master(ocr, master) == \
        jtmm.match_ocr_to_master(ocr, master)


@pytest.mark.parametrize("tokens,master,ocr,texts", [
    (["<tbody>", "<tr>", "<td></td>"], [[0, 0, 50, 20]],
     [[2, 2, 48, 18], [2, 30, 48, 45], [52, 30, 98, 45]],
     ["in", "left", "right"]),
    (["<tbody>", "<tr>", "<td></td>", "</tr>", "</tbody>"],
     [[0, 0, 50, 20]], [[2, 2, 48, 18], [300, 300, 340, 320]],
     ["in", "way-out"]),
    (["<tbody>", "<tr>", "<td></td>", "</tr>", "</tbody>"],
     [[0, 0, 50, 20], [0, 0, 0, 0]], [[2, 2, 48, 18]], ["t"])])
def test_master_matcher_matches_jax(tokens, master, ocr, texts):
    assert ttmm.TableMasterMatcher()(tokens, master, ocr, texts) == \
        jtmm.TableMasterMatcher()(tokens, master, ocr, texts)


@pytest.mark.parametrize("use_master,tokens,cells,boxes,texts", [
    (True, ["<tbody>", "<tr>", "<td></td>", "<eb></eb>", "</tr>",
            "</tbody>"], [[0, 0, 50, 20]], [[2, 2, 48, 18]], ["hello"]),
    (True, ["<thead>", "<tr>", "<td></td>", "</tr>", "</thead>", "<tbody>",
            "<tr>", "<td></td>", "</tr>", "</tbody>"],
     [[0, 0, 50, 20], [0, 30, 50, 50]], [[1, 1, 49, 19], [1, 31, 49, 49]],
     ["Head", "x"]),
    (True, ["<tbody>", "<tr>", "<td></td>", "</tr>", "</tbody>"],
     [[0, 0, 100, 40]], [[2, 2, 96, 18], [2, 20, 96, 38]],
     ["<b>Local</b>", "<b>unit</b>"]),
    (False, ["<tr>", "<td></td>", "</tr>"], [[0, 0, 50, 20]],
     [[1, 1, 49, 19]], ["t"]),
    (False, ["<table>", "<tr>", "<td></td>", "<td></td>", "</tr>",
             "</table>"], [[0, 0, 50, 20], [50, 0, 100, 20]],
     [[2, 2, 48, 18], [52, 2, 98, 18]], ["a", "b"]),
    (False, ["<tr>", "<td></td>", "</tr>"], [[0, 0, 100, 20]],
     [[0, 0, 40, 20], [45, 0, 90, 20]], ["a", "b"])])
def test_table_match_matches_jax(use_master, tokens, cells, boxes, texts):
    assert ttm.TableMatch(use_master=use_master)(tokens, cells, boxes,
                                                 texts) == \
        jtm.TableMatch(use_master=use_master)(tokens, cells, boxes, texts)


def _random_case(rng, master: bool):
    """A random token stream of the model's vocabulary (rows of td
    tokens, spans, eb cells for master), td boxes on a jittered grid and
    OCR boxes with texts that need escaping or carry inline tags."""
    vocab = load_pubtabnet_structure_alphabet() if master \
        else STRUCTURE_TOKENS
    spans = [t for t in vocab if "span" in t]
    tokens, boxes = ["<thead>"] if master and rng.random() < 0.5 else [], []
    n_rows, n_cols = rng.integers(1, 5), rng.integers(1, 5)
    for r in range(n_rows):
        tokens.append("<tr>")
        for c in range(n_cols):
            kind = rng.random()
            if master and kind < 0.15:
                tokens.append(str(rng.choice(EB[:3])))
                continue
            if kind < 0.3:
                tokens += ["<td", str(rng.choice(spans)), ">", "</td>"]
            else:
                tokens.append("<td></td>")
            x, y = 60.0 * c + rng.normal(0, 2), 25.0 * r + rng.normal(0, 2)
            boxes.append([x, y, x + 55 + rng.normal(0, 3),
                          y + 22 + rng.normal(0, 2)])
        tokens.append("</tr>")
        if tokens[0] == "<thead>" and r == 0:
            tokens += ["</thead>", "<tbody>"]
    if rng.random() < 0.7:
        tokens.append("</tbody>")
    words = ["a & b", "<b>bold</b>", "x<y", "'q'", "plain", "1.5",
             "\"quoted\"", "O", "<i>it</i>"]
    ocr, texts = [], []
    for _ in range(int(rng.integers(0, 2 * len(boxes) + 2))):
        x, y = rng.uniform(-10, 60.0 * n_cols), rng.uniform(-5,
                                                          25.0 * n_rows)
        ocr.append([x, y, x + rng.uniform(5, 50), y + rng.uniform(5, 20)])
        texts.append(str(rng.choice(words)))
    return tokens, boxes, ocr, texts


@pytest.mark.parametrize("seed", range(12))
def test_random_token_sets_match_jax(seed):
    rng = np.random.default_rng(seed)
    master = bool(seed % 2)
    tokens, boxes, ocr, texts = _random_case(rng, master)
    assert ttm.TableMatch(use_master=master)(tokens, boxes, ocr, texts) == \
        jtm.TableMatch(use_master=master)(tokens, boxes, ocr, texts)
    if master:
        assert ttmm.TableMasterMatcher()(tokens, boxes, ocr, texts) == \
            jtmm.TableMasterMatcher()(tokens, boxes, ocr, texts)
    # through the table HTML task, with a page offset
    off = (int(rng.integers(0, 300)), int(rng.integers(0, 300)))
    tsr = {"structure_tokens": tokens, "cells": [{"bbox": b}
                                                for b in boxes],
           "offset": off, "type": "master" if master else "slanet"}
    page = [(b[0] + off[0], b[1] + off[1], b[2] + off[0], b[3] + off[1])
            for b in ocr]
    got = tt2h.OcrTableToHtmlTask()(
        tsr, [TCell.from_bbox(b, text=t) for b, t in zip(page, texts)])
    want = jt2h.OcrTableToHtmlTask()(
        tsr, [JCell.from_bbox(b, text=t) for b, t in zip(page, texts)])
    assert got == want


def test_token_path_escapes_slanet_texts_and_not_master_ones():
    tsr = {"structure_tokens": ["<tr>", "<td></td>", "</tr>"],
           "cells": [{"bbox": [0, 0, 60, 20]}], "offset": (0, 0)}
    cell = [TCell.from_bbox((5, 2, 55, 18), text=" <b>a&b</b> ")]
    slanet = tt2h.OcrTableToHtmlTask()(dict(tsr, type="slanet"), cell)
    master = tt2h.OcrTableToHtmlTask()(dict(tsr, type="master"), cell)
    assert "<td>&lt;b&gt;a&amp;b&lt;/b&gt;</td>" in slanet
    assert "<td><b>a&b</b></td>" in master


@pytest.mark.parametrize("name", ["token_master", "token_slanet"])
def test_golden_token_cases_through_the_port(name):
    if name == "token_master":
        c = cases.TOKEN_CASE
        got = ttmm.deal_bb("<table>" + ttmm.insert_text_to_token(
            c["tokens"], c["texts"]) + "</table>")
    else:
        c = cases.SLANET_TOKEN_CASE
        got = ttm.TableMatch()(c["tokens"], c["pred_bboxes"],
                               c["dt_boxes"], c["texts"])
    assert got == cases.load_expected(name)
