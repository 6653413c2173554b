"""Page HTML and table HTML: the port's host code against the JAX package's
on the same seeded synthetic cells, byte-equal. ``OcrToHtmlTask`` (lines,
alignment, paragraphs, tables and images in reading order),
``merge_overlapping_cells``, ``OcrTableToHtmlTask`` with and without
``ocr_post_process``, ``filter_figure_tables`` and
``widen_table_regions``.

Of the golden corpus (tests/golden/cases.py), ``lore_snap`` runs through the
port's code (``LorePostProcessor`` -> ``OcrTableToHtmlTask``) and must give
tests/golden/expected/lore_snap.html byte for byte; so must the three
scanned cases (``scanned_wired``, ``scanned_deskew``, ``scanned_rot90``:
the raster grid through the port's LineCell ``extract_cells_from_image``
and ``OcrTableToHtmlTask``, as ``run_scanned_case`` runs them). The two
token cases run through the port in tests/test_torch_table_match.py, the
four flavor cases in tests/test_torch_read_pdf.py. The eight digital cases
run through the port's CLI in tests/test_torch_cli.py; their pages are
held to the JAX runner in tests/test_torch_digital_pipeline.py. The xlsx
and compare cases run through the port's ``utils/xlsx_writer.py`` and
``tasks/result_compare.py`` in tests/test_torch_aux_tasks.py."""

import os
import sys

import numpy as np
import pytest

from pdf_table_tpu.entity.enums import HtmlContentType as JType
from pdf_table_tpu.entity.ocr_cell import OcrCell as JCell
from pdf_table_tpu.pipeline import system as jsys
from pdf_table_tpu.tasks import ocr_fixes as jfix
from pdf_table_tpu.tasks import table_to_html as jt2h
from pdf_table_tpu.tasks import to_html as jhtml
from pdf_table_tpu_torch.entity.enums import HtmlContentType as TType
from pdf_table_tpu_torch.entity.ocr_cell import OcrCell as TCell
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.processor import LorePostProcessor
from pdf_table_tpu_torch.pipeline import system as tsys
from pdf_table_tpu_torch.pipeline.output import OcrSystemModelOutput
from pdf_table_tpu_torch.tasks import ocr_fixes as tfix
from pdf_table_tpu_torch.tasks import table_to_html as tt2h
from pdf_table_tpu_torch.tasks import to_html as thtml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

WORDS = ["alpha", "beta", "O", "1.234.567.89", "a<b", "&amp", "gamma",
         "delta", "", "42%", "o", "x y"]


def _boxes(seed, n=40, w=900.0):
    """Text-line boxes in rows (some overlapping, some indented, centred
    or right-aligned) with words from WORDS."""
    rng = np.random.default_rng(seed)
    out = []
    y = 40.0
    for _ in range(n):
        kind = rng.integers(0, 5)
        h = float(rng.integers(14, 24))
        if kind == 0:
            x1, x2 = 60.0, float(rng.integers(500, 840))
        elif kind == 1:
            half = float(rng.integers(80, 200))
            x1, x2 = w / 2 - half, w / 2 + half
        elif kind == 2:
            x1, x2 = float(rng.integers(500, 700)), 840.0
        elif kind == 3:
            x1 = float(rng.integers(60, 400))
            x2 = x1 + float(rng.integers(40, 200))
        else:   # a second box on the previous row, overlapping or beside
            py = out[-1][0][1] if out else y
            x1 = float(rng.integers(60, 700))
            out.append(((x1, py + 1, x1 + float(rng.integers(30, 120)),
                         py + h), str(rng.choice(WORDS))))
            continue
        out.append(((x1, y, x2, y + h), str(rng.choice(WORDS))))
        y += h + float(rng.integers(2, 40))
    return out


def _cells(boxes, cls):
    return [cls.from_bbox(b, text=t, score=0.5 + 0.01 * i)
            for i, (b, t) in enumerate(boxes)]


def _key(cells):
    return [(c.bbox, c.text, c.score, c.cell_type.name) for c in cells]


@pytest.mark.parametrize("seed", range(6))
def test_merge_overlapping_cells_matches_jax(seed):
    boxes = _boxes(seed)
    got = thtml.merge_overlapping_cells(_cells(boxes, TCell))
    want = jhtml.merge_overlapping_cells(_cells(boxes, JCell))
    assert _key(got) == _key(want)
    assert len(got) < len(boxes) or seed > 3


@pytest.mark.parametrize("seed", range(6))
def test_page_html_matches_jax(seed):
    boxes = _boxes(seed)
    rng = np.random.default_rng(100 + seed)
    ys = sorted(rng.integers(40, 900, 4).tolist())
    tables = [((60.0, float(ys[0]), 840.0, float(ys[0] + 80)),
               "<table><tr><td>t0</td></tr></table>"),
              ((100.0, float(ys[2]), 500.0, float(ys[2] + 60)),
               "<table><tr><td>t1</td></tr></table>")]
    images = [(300.0, float(ys[1]), 600.0, float(ys[1] + 50))]
    for header in (False, True):
        for width in (900.0, 1800.0):
            got = thtml.OcrToHtmlTask(add_header=header)(
                _cells(boxes, TCell), tables, images, page_width=width)
            want = jhtml.OcrToHtmlTask(add_header=header)(
                _cells(boxes, JCell), tables, images, page_width=width)
            assert got == want
            assert ("<!DOCTYPE html>" in got) == header
    assert thtml.HTML_HEADER == jhtml.HTML_HEADER
    assert thtml.HTML_FOOTER == jhtml.HTML_FOOTER


def test_lines_alignment_and_paragraphs_match_jax():
    boxes = _boxes(7)
    tl = thtml.group_lines(_cells(boxes, TCell))
    jl = jhtml.group_lines(_cells(boxes, JCell))
    assert [_key(line) for line in tl] == [_key(line) for line in jl]
    ta = thtml.classify_line_alignment(tl, 900.0)
    ja = jhtml.classify_line_alignment(jl, 900.0)
    assert [a.name for a in ta] == [a.name for a in ja]
    assert len({a.name for a in ta}) >= 3
    tb = thtml.merge_paragraphs(tl, ta, 900.0)
    jb = jhtml.merge_paragraphs(jl, ja, 900.0)
    assert [{**b, "align": b["align"].name} for b in tb] == \
        [{**b, "align": b["align"].name} for b in jb]


def _tsr(seed):
    """A random LORE-like grid result with spans, offset into the page."""
    rng = np.random.default_rng(seed)
    xs = np.cumsum(rng.integers(40, 90, 6)).astype(float)
    ys = np.cumsum(rng.integers(20, 40, 5)).astype(float)
    cells = []
    r = 0
    while r < 4:
        c = 0
        rs = int(min(rng.integers(1, 3), 4 - r))
        while c < 5:
            cs = int(min(rng.integers(1, 3), 5 - c))
            cells.append({"bbox": [xs[c], ys[r], xs[c + cs], ys[r + rs]],
                          "logic": [r, r + rs - 1, c, c + cs - 1]})
            c += cs
        r += rs
    return {"cells": cells, "offset": (30, 50)}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fix", [False, True])
def test_table_html_matches_jax(seed, fix):
    tsr = _tsr(seed)
    rng = np.random.default_rng(seed)
    boxes = []
    for c in tsr["cells"][::2]:
        x1, y1, x2, y2 = c["bbox"]
        ox, oy = tsr["offset"]
        for k in range(int(rng.integers(1, 3))):
            bx = x1 + ox + 3 + 20 * k
            boxes.append(((bx, y1 + oy + 3, bx + 18, y2 + oy - 3),
                          str(rng.choice(WORDS))))
    boxes.append(((2000.0, 2000.0, 2010.0, 2010.0), "outside"))
    got = tt2h.OcrTableToHtmlTask(ocr_post_process=fix)(
        tsr, _cells(boxes, TCell))
    want = jt2h.OcrTableToHtmlTask(ocr_post_process=fix)(
        tsr, _cells(boxes, JCell))
    assert got == want
    assert got.startswith("<table")


def test_ocr_post_process_matches_jax():
    for t in WORDS + ["Q", " o ", "1.2.3", "-1.000.5", "12.5"]:
        assert tfix.ocr_post_process(t) == jfix.ocr_post_process(t)
    assert tfix.apply_ocr_post_process(WORDS) == \
        jfix.apply_ocr_post_process(WORDS)
    for a, b in ((["中文"], ["abc"]), (["abc"], ["中文字"]), ([""], ["x"])):
        assert tfix.check_pdf_text_need_rotate(a, b) == \
            jfix.check_pdf_text_need_rotate(a, b)


def test_match_helpers_match_jax():
    rng = np.random.default_rng(3)
    cells = [list(map(float, rng.integers(0, 300, 4))) for _ in range(12)]
    cells = [[min(a, c), min(b, d), max(a, c) + 1, max(b, d) + 1]
             for a, b, c, d in cells]
    for a in cells:
        for b in cells[:4]:
            assert tt2h.bbox_iou(a, b) == jt2h.bbox_iou(a, b)
            assert tt2h.overlap_ratio(a, b) == jt2h.overlap_ratio(a, b)
    for box in cells[:6]:
        assert tt2h.find_top1_match(TCell.from_bbox(box), cells) == \
            jt2h.find_top1_match(JCell.from_bbox(box), cells)


def test_token_path_raises_naming_the_roadmap_item():
    """The token path raised, naming ROADMAP Queue 1 item 8, until SLANet
    and TableMaster were ported; it now gives JAX's HTML for the result it
    raised on, with and without text cells."""
    tsr = {"structure_tokens": ["<td></td>"]}
    assert tt2h.OcrTableToHtmlTask()(tsr, []) == \
        jt2h.OcrTableToHtmlTask()(tsr, [])
    tsr = dict(tsr, cells=[{"bbox": [0, 0, 40, 20]}], offset=(3, 4))
    got = tt2h.OcrTableToHtmlTask()(
        tsr, [TCell.from_bbox((5, 6, 40, 22), text="a<b")])
    assert got == jt2h.OcrTableToHtmlTask()(
        tsr, [JCell.from_bbox((5, 6, 40, 22), text="a<b")])
    assert "<td>a&lt;b</td>" in got


def _layout(cls, ctype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for label, kind in (("text", ctype.TXT), ("figure", ctype.TXT),
                        ("table", ctype.TABLE), ("text", ctype.TXT),
                        ("table", ctype.TABLE), ("figure", ctype.TXT)):
        x1, y1 = float(rng.integers(0, 500)), float(rng.integers(0, 800))
        c = cls.from_bbox((x1, y1, x1 + float(rng.integers(50, 400)),
                           y1 + float(rng.integers(40, 300))), text=label,
                          score=float(rng.uniform(0.6, 1.0)))
        c.cell_type, c.label = kind, label
        out.append(c)
    return out


@pytest.mark.parametrize("seed", range(5))
def test_figure_filter_and_widening_match_jax(seed):
    t_cells = _layout(TCell, TType, seed)
    j_cells = _layout(JCell, JType, seed)
    tables = [c.bbox for c in t_cells if c.label == "table"]
    # a table inside the first figure, which the filter drops when the
    # figure is confident
    fig = t_cells[1].bbox
    tables.append((fig[0] + 1, fig[1] + 1, fig[2] - 1, fig[3] - 1))
    for thr in (0.5, 0.8, 0.99):
        assert tsys.filter_figure_tables(t_cells, tables, thr) == \
            jsys.filter_figure_tables(j_cells, tables, thr)
    for width in (600, 1000):
        assert tsys.widen_table_regions(t_cells, tables, width) == \
            jsys.widen_table_regions(j_cells, tables, width)


def test_from_poly_and_output_match_jax():
    poly = np.array([[10.5, 20], [80, 18.25], [82, 40], [9, 41]], np.float32)
    t, j = TCell.from_poly(poly, "x", score=0.25), \
        JCell.from_poly(poly, "x", score=0.25)
    assert (t.bbox, t.text, t.score, t.width, t.height, t.area,
            t.poly.tolist(), t.cell_type.name, t.center.x, t.center.y) == \
        (j.bbox, j.text, j.score, j.width, j.height, j.area, j.poly.tolist(),
         j.cell_type.name, j.center.x, j.center.y)
    assert t.contains(TCell.from_bbox((20, 25, 30, 35))) and \
        j.contains(JCell.from_bbox((20, 25, 30, 35)))
    out = OcrSystemModelOutput(page=3, text_cells=[t], table_html=["<t>"])
    out.metric["x"] = 1.0
    assert out.to_metric_dict() == {"x": 1.0, "page": 3, "src_id": "",
                                    "n_text": 1, "n_tables": 1}


def test_golden_lore_snap_through_the_port():
    raw, meta = cases.make_lore_raw()
    r = LorePostProcessor(LoreConfig())(raw, meta)
    assert r["cells"]
    texts = []
    for cell in sorted(r["cells"],
                       key=lambda c: (c["logic"][0], c["logic"][2])):
        x1, y1, x2, y2 = cell["bbox"]
        texts.append(TCell.from_bbox(
            (x1 + 4, y1 + 6, min(x1 + 40, x2 - 4), y2 - 6),
            text=f"r{cell['logic'][0]}c{cell['logic'][2]}", score=0.95))
    r["offset"] = (0, 0)
    got = tt2h.OcrTableToHtmlTask()(r, texts)
    assert got == cases.load_expected("lore_snap")


@pytest.mark.parametrize("name", sorted(cases.SCANNED_CASES))
def test_golden_scanned_cases_through_the_port(name):
    from pdf_table_tpu_torch.models.line_cell import extract_cells_from_image

    r = extract_cells_from_image(
        cases.make_scanned_grid(cases.SCANNED_CASES[name]))
    assert r["cells"]
    texts = []
    for cell in sorted(r["cells"],
                       key=lambda c: (c["logic"][0], c["logic"][2])):
        x1, y1, x2, y2 = cell["bbox"]
        texts.append(TCell.from_bbox(
            (x1 + 10, y1 + 14, x1 + 74, y1 + 32),
            text=f"r{cell['logic'][0]}c{cell['logic'][2]}", score=0.99))
    r["offset"] = (0, 0)
    got = tt2h.OcrTableToHtmlTask()(r, texts)
    assert got == cases.load_expected(name)
