"""The port's standalone tasks and table tools against the JAX package's on
the CPU.

Table HTML: the port parses it with its own parser
(``utils/html_tree.py``) where JAX uses lxml: the rows, cells, spans and
texts, and the element tree TEDS walks, equal lxml's on every golden page
and table (tests/golden/expected), on table HTML the port's
``OcrTableToHtmlTask`` emits (the seeded grids of tests/test_torch_html.py
with their texts, and seeded mutations of them) and on malformed HTML
(cells and rows left open, a stray end tag, a fragment, an open
paragraph). On those tables: TEDS (full and structure only) and
``TableWtwMetric`` equal JAX's to 1e-9 (JAX's TEDS with
``python-Levenshtein`` installed, as here; the port computes the exact
distance itself, ``levenshtein`` against the package), the
``TableResultCompare`` bucket and the whole ``check_pred_table_html``
metric equal JAX's on the four pairs of tests/test_aux_tasks.py and on
the seeded mutations, the xlsx worksheet equals JAX's, and the
``xlsx_sheet`` and ``compare_report`` golden cases are byte-equal.

The debug overlay (``utils/debug_render.py``) equals JAX's cv2 overlay
on every pixel outside the label boxes (cv2's ``getTextSize`` box and
the port's PIL box, each grown by 2 px), on seeded text polygons, boxes,
layout regions and table cells; the port draws its labels in PIL's
default font.

The tasks, on the trees of tests/test_torch_system.py (the per-image
detector and the natural-size crops the port's on both sides, as there):
``OcrTextTask`` (with and without the 0/180 line classifier; an image
file read without cv2; a digital page's vector text) and its
``show_ocr_result`` frame, ``OcrTableTask`` with LineCell (TSR, HTML
with the text task's cells, xlsx, ``eval_table``) and ``OcrDocument``
(its triple, frame and saved tsv, json and overlay) equal JAX's."""

import json
import os
import sys
import zipfile

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import pdf_table_tpu.ops.warp as jwarp
from pdf_table_tpu.eval.table_metric import TableWtwMetric as JMetric
from pdf_table_tpu.eval.teds import TEDS as JTEDS
from pdf_table_tpu.pdfio import PdfWriter
from pdf_table_tpu.pdfio.reader import PdfDocument as JDoc
from pdf_table_tpu.pipeline.ocr_document import OcrDocument as JOcrDocument
from pdf_table_tpu.tasks import result_compare as jrc
from pdf_table_tpu.tasks.table_task import OcrTableTask as JTableTask
from pdf_table_tpu.tasks.text_task import OcrTextTask as JTextTask
from pdf_table_tpu.utils import debug_render as jdebug
from pdf_table_tpu.utils.xlsx_writer import html_table_to_xlsx as j_to_xlsx
from pdf_table_tpu_torch.entity.ocr_cell import OcrCell as TCell
from pdf_table_tpu_torch.eval import TEDS, TableWtwMetric
from pdf_table_tpu_torch.eval.teds import levenshtein
from pdf_table_tpu_torch.pdfio.reader import PdfDocument
from pdf_table_tpu_torch.pipeline.ocr_document import OcrDocument
from pdf_table_tpu_torch.tasks import result_compare as trc
from pdf_table_tpu_torch.tasks import table_to_html as tt2h
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
from pdf_table_tpu_torch.tasks.table_task import OcrTableTask
from pdf_table_tpu_torch.tasks.text_task import OcrTextTask
from pdf_table_tpu_torch.utils import debug_render
from pdf_table_tpu_torch.utils import html_tree
from pdf_table_tpu_torch.utils.image_io import write_png
from pdf_table_tpu_torch.utils.xlsx_writer import html_table_to_xlsx
from test_torch_html import WORDS, _cells, _tsr
from test_torch_pipeline import REC
from test_torch_system import TEXT_PAGE, jtasks, trees  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-9


# -- table HTML --------------------------------------------------------

def _table_html(seed):
    """A seeded grid with spans through the port's OcrTableToHtmlTask,
    texts in half of its cells."""
    tsr = _tsr(seed)
    rng = np.random.default_rng(seed)
    boxes = []
    ox, oy = tsr["offset"]
    for c in tsr["cells"][::2]:
        x1, y1, x2, y2 = c["bbox"]
        boxes.append(((x1 + ox + 3, y1 + oy + 3, x1 + ox + 30, y2 + oy - 3),
                      str(rng.choice(WORDS))))
    return tt2h.OcrTableToHtmlTask()(tsr, _cells(boxes, TCell))


def _rows(html):
    doc = html_tree.fromstring(html)
    return [[(td.tag, "".join(td.itertext()).strip(), td.get("rowspan"),
              td.get("colspan")) for td in tr.child_tags("td", "th")]
            for tr in doc.iter_tags("tr")]


def _rows_lxml(html):
    from lxml import html as lxml_html

    doc = lxml_html.fromstring(html)
    return [[(td.tag, "".join(td.itertext()).strip(), td.get("rowspan"),
              td.get("colspan")) for td in tr.xpath("./td|./th")]
            for tr in doc.xpath(".//tr")]


def _to_html(rows):
    out = ["<table>"]
    for row in rows:
        out.append("<tr>")
        for text, rs, cs in row:
            attrs = (f' rowspan="{rs}"' if rs > 1 else "") + \
                (f' colspan="{cs}"' if cs > 1 else "")
            out.append(f"<td{attrs}>{text}</td>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _mutate(html, seed):
    """One seeded edit of a table: a cell's text changed, a word dropped,
    two cells swapped, a span changed, a cell or a row removed."""
    rng = np.random.default_rng(seed)
    rows = [[(t, int(rs or 1), int(cs or 1)) for _, t, rs, cs in r]
            for r in _rows(html)]
    kind = int(rng.integers(0, 6))
    full = [i for i, row in enumerate(rows) if row]
    r = full[int(rng.integers(0, len(full)))]
    c = int(rng.integers(0, len(rows[r])))
    text, rs, cs = rows[r][c]
    if kind == 0:
        rows[r][c] = (text + str(rng.choice(WORDS)), rs, cs)
    elif kind == 1:
        rows[r][c] = (text[:-1], rs, cs)
    elif kind == 2 and len(rows[r]) > 1:
        rows[r][0], rows[r][-1] = rows[r][-1], rows[r][0]
    elif kind == 3:
        rows[r][c] = (text, rs + 1, cs)
    elif kind == 4:
        rows[r][c] = (text, rs, cs + 1)
    elif len(rows) > 1:
        del rows[r]
    else:
        del rows[r][c]
    return _to_html(rows)


GOLDEN_HTML = sorted(n for n in cases.all_case_names()
                     if cases.expected_path(n).endswith(".html"))
MALFORMED = [
    "<table><tr><td>a<td>b</tr><tr><td rowspan=2>c</table>",
    "<td>lone &amp; cell</td>",
    "text <table><tr><th>h</th></tr></table> tail",
    "<table><thead><tr><td>1</td></tr><tbody><tr><td>2<b>bold</b> x</td>"
    "</tr></table>",
    "<p>para<table><tr><td>q</td></tr></table>",
    '<table border="1"><tr><td colspan="2">head</td></tr>'
    "<tr><td>a<br>b</td><td></td></tr></span></table>",
]
PAIRS = [  # tests/test_aux_tasks.py's four pairs
    ("<table><tr><td>a</td></tr></table>",
     "<table><tr><td>a</td></tr></table>"),
    ('<table><tr><td colspan="2">a</td></tr></table>',
     "<table><tr><td>a</td></tr></table>"),
    ("<table><tr><td>a</td><td>b</td></tr></table>",
     "<table><tr><td>b</td><td>a</td></tr></table>"),
    ("<table><tr><td>hello</td></tr></table>",
     "<table><tr><td>hello world</td></tr></table>"),
]


def _tables():
    out = [_table_html(s) for s in range(6)]
    return out + [_mutate(out[s % 6], 100 + s) for s in range(12)]


@pytest.mark.parametrize("name", GOLDEN_HTML)
def test_html_tree_matches_lxml_on_goldens(name):
    html = cases.load_expected(name)
    assert _rows(html) == _rows_lxml(html)
    tree, want = TEDS().evaluate(html, html), JTEDS().evaluate(html, html)
    assert tree == want


def test_html_tree_matches_lxml_on_port_tables_and_malformed_html():
    from lxml import html as lxml_html

    for html in _tables() + MALFORMED:
        assert _rows(html) == _rows_lxml(html), html
        doc, want = html_tree.fromstring(html), lxml_html.fromstring(html)
        assert doc.tag == want.tag
        assert [td.tag for td in doc.iter_tags("td", "th")] == \
            [td.tag for td in want.xpath(".//td|.//th")]
    with pytest.raises(html_tree.ParserError):
        html_tree.fromstring("  \n")


def test_levenshtein_is_exact():
    import Levenshtein

    rng = np.random.default_rng(0)
    alphabet = list("abcde 12")
    for _ in range(300):
        a = "".join(rng.choice(alphabet, int(rng.integers(0, 12))))
        b = "".join(rng.choice(alphabet, int(rng.integers(0, 12))))
        assert levenshtein(a, b) == Levenshtein.distance(a, b)


@pytest.mark.parametrize("structure_only", [False, True])
def test_teds_matches_jax(structure_only):
    tables = _tables() + [cases.load_expected(n) for n in
                          ("digital_spans", "scanned_wired", "lore_snap")]
    port, jax_ = TEDS(structure_only), JTEDS(structure_only)
    scores = []
    for i, a in enumerate(tables):
        for b in tables[i:i + 4]:
            got, want = port.evaluate(a, b), jax_.evaluate(a, b)
            assert abs(got - want) <= TOL, (a, b)
            scores.append(got)
    assert min(scores) < 0.9 < max(scores)
    assert port.batch_evaluate(tables[:3], tables[1:4]) == pytest.approx(
        jax_.batch_evaluate(tables[:3], tables[1:4]), abs=TOL)


def test_table_wtw_metric_matches_jax():
    rng = np.random.default_rng(3)
    port, jax_ = TableWtwMetric(), JMetric()
    for _ in range(5):
        gt = np.sort(rng.uniform(0, 200, (12, 4)).reshape(12, 2, 2),
                     axis=1).reshape(12, 4)
        pred = gt[rng.permutation(12)[:10]] + rng.normal(0, 4, (10, 4))
        gax = rng.integers(0, 5, (12, 4))
        pax = gax[:10] * (rng.uniform(size=(10, 1)) > 0.3)
        port.update(pred, pax, gt, gax)
        jax_.update(pred, pax, gt, gax)
    got, want = port.compute(), jax_.compute()
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= TOL
    assert 0 < got["n_matched"] < got["n_gt"]


def _plain(obj):
    """A metric dict with the compare-type enums as their names."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return getattr(obj, "name", obj)


def test_result_compare_matches_jax():
    tables = _tables()
    pairs = PAIRS + [(cases.COMPARE_CASE[0], cases.COMPARE_CASE[1])] + [
        (_mutate(t, 200 + i), t) for i, t in enumerate(tables[:6])] + [
        (tables[i], tables[i + 6]) for i in range(6)]
    buckets = set()
    for pred, label in pairs:
        got = trc.TableResultCompare()(pred, label)
        want = jrc.TableResultCompare()(pred, label)
        assert _plain(got) == _plain(want)
        buckets.add(got["type"].name)
        flag, metric = trc.check_pred_table_html(pred, label)
        jflag, jmetric = jrc.check_pred_table_html(pred, label)
        assert flag == jflag and _plain(metric) == _plain(jmetric)
    assert len(buckets) >= 5, buckets


def test_xlsx_matches_jax(tmp_path):
    for i, html in enumerate(_tables()[:8] + MALFORMED[:1]):
        html_table_to_xlsx(html, str(tmp_path / f"p{i}.xlsx"))
        j_to_xlsx(html, str(tmp_path / f"j{i}.xlsx"))
        with zipfile.ZipFile(tmp_path / f"p{i}.xlsx") as p, \
                zipfile.ZipFile(tmp_path / f"j{i}.xlsx") as j:
            assert p.namelist() == j.namelist()
            for name in p.namelist():
                assert p.read(name) == j.read(name), name


def test_golden_xlsx_and_compare_cases(tmp_path):
    html = ('<table><tr><td colspan="2">head</td><td>h3</td></tr>'
            '<tr><td>a</td><td rowspan="2">tall</td><td>c</td></tr>'
            "<tr><td>d</td><td>f</td></tr></table>")
    path = str(tmp_path / "golden.xlsx")
    html_table_to_xlsx(html, path)
    with zipfile.ZipFile(path) as z:
        sheet = z.read("xl/worksheets/sheet1.xml").decode("utf-8")
    assert sheet == cases.load_expected("xlsx_sheet")
    flag, metric = trc.check_pred_table_html(*cases.COMPARE_CASE)
    report = json.dumps(
        {"flag": flag, "check_type": metric["check_type"],
         "cell_text_diffs": metric["cell_text_diffs"],
         "cell_structure_diffs": metric["cell_structure_diffs"],
         "report": metric["diff_report_html"]},
        indent=1, sort_keys=True, ensure_ascii=False) + "\n"
    assert report == cases.load_expected("compare_report")


# -- the debug overlay -------------------------------------------------

def overlay_labels(layout_cells, table_results):
    """(text, origin, font scale) of every label the overlay draws."""
    out = []
    for c in layout_cells:
        label = getattr(c, "label", None) or (c.text or "")
        if label:
            x1, y1 = int(c.bbox[0]), int(c.bbox[1])
            out.append((f"{label} {c.score:.2f}", (x1, max(y1 - 4, 10)),
                        0.45))
    for _tb, r in table_results:
        ox, oy = r.get("offset", (0, 0))
        for cell in r.get("cells", []):
            logic = cell.get("logic")
            if logic:
                x1, y1 = int(cell["bbox"][0]), int(cell["bbox"][1])
                out.append((f"{logic[0]},{logic[2]}",
                            (x1 + int(ox) + 2, y1 + int(oy) + 12), 0.35))
    return out


def outside_labels(shape, labels, margin=2):
    """True outside every label's box: cv2's (``getTextSize``) and the
    port's (``text_box``), each grown by ``margin`` px."""
    keep = np.ones(shape[:2], bool)
    for text, (x, y), scale in labels:
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                       scale, 1)
        boxes = [(x, y - h, x + w, y + base),
                 debug_render.text_box(text, (x, y), scale)]
        for x1, y1, x2, y2 in boxes:
            keep[max(y1 - margin, 0):max(y2 + margin + 1, 0),
                 max(x1 - margin, 0):max(x2 + margin + 1, 0)] = False
    return keep


def assert_overlays_match(got, want, image, labels):
    keep = outside_labels(image.shape, labels)
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(got[keep], want[keep])
    assert (got != image).any(axis=-1)[keep].sum() > 100


def _overlay_inputs(cls, seed):
    rng = np.random.default_rng(seed)
    text = []
    for k in range(12):
        cx, cy = rng.uniform(30, 570), rng.uniform(30, 370)
        w, h, a = rng.uniform(20, 120), rng.uniform(8, 30), rng.uniform(-.4,
                                                                      .4)
        d = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        text.append(cls.from_poly(d @ rot.T + [cx, cy], text="t"))
    text.append(cls.from_bbox((5.6, 6.2, 80.9, 30.1), text="box"))
    text.append(cls.from_bbox((550.0, 380.0, 640.0, 430.0), text="edge"))
    layout = []
    for k, label in enumerate(("table", "text", "figure", "")):
        x1, y1 = rng.uniform(0, 400), rng.uniform(0, 250)
        c = cls.from_bbox((x1, y1, x1 + rng.uniform(40, 200),
                           y1 + rng.uniform(30, 140)), text=label,
                          score=float(rng.uniform(0.3, 1)))
        c.label = label
        layout.append(c)
    tsr = _tsr(seed)
    return text, layout, [((0, 0, 400, 300), tsr)]


@pytest.mark.parametrize("seed", range(3))
def test_debug_overlay_matches_jax_outside_the_labels(seed):
    from pdf_table_tpu.entity.ocr_cell import OcrCell as JCell

    rng = np.random.default_rng(seed)
    image = rng.integers(150, 256, (420, 610, 3)).astype(np.uint8)
    got = debug_render.render_debug_overlay(image, *_overlay_inputs(TCell,
                                                                    seed))
    want = jdebug.render_debug_overlay(image, *_overlay_inputs(JCell, seed))
    _, layout, tables = _overlay_inputs(TCell, seed)
    assert_overlays_match(got, want, image, overlay_labels(layout, tables))


# -- the tasks ---------------------------------------------------------

@pytest.fixture()
def natural_crops_as_the_port(monkeypatch):
    """The JAX side's natural-size crops cut by the port's
    ``crop_rotated_boxes`` (tests/test_torch_system.py)."""
    from pdf_table_tpu_torch.ops import warp as twarp

    orig = jwarp.crop_rotated_boxes

    def crops(img, quads, out_hw=None):
        if out_hw is not None:
            return orig(img, quads, out_hw)
        return twarp.crop_rotated_boxes(img, quads)

    monkeypatch.setattr(jwarp, "crop_rotated_boxes", crops)


def text_tasks(trees, jtasks, **kw):
    """(port, JAX) OcrTextTask on the system tests' trees: the port's
    detector on both sides, each side's recognizer (and 0/180
    classifier)."""
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask

    port = OcrTextTask.__new__(OcrTextTask)
    jax_ = JTextTask.__new__(JTextTask)
    for task in (port, jax_):
        task.use_orientation = kw.get("use_orientation", False)
        task.deskew = False
        task.debug = False
        task.output_dir = None
        task._pdf_text = None
        task.det = jtasks["port_det"]
    port.device = torch.device("cpu")
    port.rec = OcrRecognitionTask(device="cpu", variables=trees["rec"],
                                  **REC)
    jax_.rec = jtasks["_rec"]
    port._line_cls = ClsImagePulcTask("textline_orientation", device="cpu",
                                      variables=trees["cls"])
    jax_._line_cls = jtasks["_line_cls"]
    return port, jax_


def same_text_output(got, want):
    assert got["texts"] == want["texts"]
    assert set(got["metric"]) == set(want["metric"])
    assert [c.text for c in got["cells"]] == [c.text for c in want["cells"]]
    np.testing.assert_array_equal(
        np.asarray([c.bbox for c in got["cells"]]).reshape(-1, 4),
        np.asarray([c.bbox for c in want["cells"]]).reshape(-1, 4))
    np.testing.assert_allclose([c.score for c in got["cells"]],
                               [c.score for c in want["cells"]], atol=1e-5)


@pytest.mark.parametrize("use_orientation", [False, True])
def test_text_task_matches_jax(use_orientation, trees, jtasks, tmp_path,
                               natural_crops_as_the_port):
    port, jax_ = text_tasks(trees, jtasks, use_orientation=use_orientation)
    path = str(tmp_path / "page.png")
    write_png(path, TEXT_PAGE)
    got = port(path, page=2)
    want = jax_(TEXT_PAGE.copy(), page=2)
    same_text_output(got, want)
    assert len(got["cells"]) >= 5 and got["metric"]["page"] == 2
    pd.testing.assert_frame_equal(port.show_ocr_result(got["cells"]),
                                  jax_.show_ocr_result(want["cells"]))


def test_text_task_reads_a_digital_pages_vector_text(trees, jtasks):
    w = PdfWriter()
    w.add_page(200, 100).text(10, 60, "hello vector")
    data = w.tobytes()
    port, jax_ = text_tasks(trees, jtasks)
    got = port(None, pdf_page=PdfDocument.open(data).load_page(0))
    want = jax_(None, pdf_page=JDoc.open(data).load_page(0))
    assert got["det"] is None and want["det"] is None
    assert got["texts"] == want["texts"] and "hello vector" in got["texts"]
    assert set(got["metric"]) == set(want["metric"])


def _grid():
    img = np.full((160, 240, 3), 255, np.uint8)
    for k in range(4):
        cv2.line(img, (10, 10 + 45 * k), (230, 10 + 45 * k), (0, 0, 0), 2)
    for k in range(4):
        cv2.line(img, (10 + 73 * k, 10), (10 + 73 * k, 145), (0, 0, 0), 2)
    for r in range(3):
        for c in range(3):
            img[25 + 45 * r:35 + 45 * r, 20 + 73 * c:60 + 73 * c] = 60
    return img


def test_table_task_line_cell_matches_jax(trees, jtasks, tmp_path,
                                          natural_crops_as_the_port):
    port_ocr, jax_ocr = text_tasks(trees, jtasks)
    port = OcrTableTask("LineCell", device="cpu", ocr_task=port_ocr)
    jax_ = JTableTask("LineCell", ocr_task=jax_ocr)
    img = _grid()
    got, want = port(img.copy()), jax_(img.copy())
    assert got["html"] == want["html"] and "<table" in got["html"]
    assert [c["logic"] for c in got["tsr"]["cells"]] == \
        [c["logic"] for c in want["tsr"]["cells"]]
    assert [c.text for c in got["text_cells"]] == \
        [c.text for c in want["text_cells"]]
    p = port.to_excel(got["html"], str(tmp_path / "p.xlsx"))
    j = jax_.to_excel(want["html"], str(tmp_path / "j.xlsx"))
    with zipfile.ZipFile(p) as a, zipfile.ZipFile(j) as b:
        assert a.read("xl/worksheets/sheet1.xml") == \
            b.read("xl/worksheets/sheet1.xml")
    pred = [got["html"], _table_html(0)]
    gt = [_table_html(1), _table_html(0)]
    r, jr = port.eval_table(pred, gt), jax_.eval_table(pred, gt)
    assert abs(r["teds"] - jr["teds"]) <= TOL and r["scores"][1] == 1.0


def test_ocr_document_matches_jax(trees, jtasks, tmp_path,
                                  natural_crops_as_the_port):
    port_text, jax_text = text_tasks(trees, jtasks)
    port = OcrDocument(output_dir=str(tmp_path / "p"), device="cpu")
    jax_ = JOcrDocument.__new__(JOcrDocument)
    jax_.output_dir, jax_.debug = str(tmp_path / "j"), False
    port.task, jax_.task = port_text, jax_text
    path = str(tmp_path / "page.png")
    write_png(path, TEXT_PAGE)
    det, ocr, metric = port(path)
    jdet, jocr, jmetric = jax_(path)
    np.testing.assert_array_equal(det, jdet)
    assert [r["text"] for r in ocr] == [r["text"] for r in jocr]
    assert [r["index"] for r in ocr] == [r["index"] for r in jocr]
    assert set(metric) == set(jmetric) and len(det) >= 5
    assert metric["recognition"]["total"] == jmetric["recognition"]["total"]
    pd.testing.assert_frame_equal(port.show_ocr_result(ocr),
                                  jax_.show_ocr_result(jocr))
    for ext in (".txt",):
        assert open(tmp_path / "p" / f"ocr_page{ext}").read() == \
            open(tmp_path / "j" / f"ocr_page{ext}").read()
    pj = json.load(open(tmp_path / "p" / "ocr_page.json"))
    jj = json.load(open(tmp_path / "j" / "ocr_page.json"))
    assert pj["result"] == jj["result"] and set(pj) == set(jj)
    got = cv2.imread(str(tmp_path / "p" / "ocr_page.png"))
    want = cv2.imread(str(tmp_path / "j" / "ocr_page.png"))
    np.testing.assert_array_equal(got, want)   # text boxes only: no labels
