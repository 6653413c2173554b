"""The digital page's host code: the port's ``tasks/pdf_text.py``
(``OcrPdfTextTask`` and its ``split_cell_at``, ``pdf_to_image_bbox``,
``table_bbox_is_pdf_image``, ``check_pdf_text_need_rotate90``) and
``models/line_cell/from_pdf.py`` (``pdf_page_lines``,
``extract_cells_from_pdf_page``, ``detect_table_regions``) against the JAX
package's on seeded synthetic pages written with JAX's ``PdfWriter`` and
read by each side's own reader: text runs of random sizes (on every third
page all but one written rotated by 90 degrees), a wired table of random
widths, stray rules (lines, thin filled rects, a stroked box) and a JPEG
placed on the page. Cells, logic and every returned value equal."""

import cv2
import numpy as np
import pytest

from pdf_table_tpu.models.line_cell import from_pdf as jfp
from pdf_table_tpu.pdfio import PdfDocument as JDoc
from pdf_table_tpu.pdfio import PdfWriter
from pdf_table_tpu.tasks import pdf_text as jpt
from pdf_table_tpu_torch.models.line_cell import from_pdf as tfp
from pdf_table_tpu_torch.pdfio import PdfDocument
from pdf_table_tpu_torch.tasks import pdf_text as tpt

SEEDS = range(6)


def synthetic_pdf(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    w = PdfWriter()
    p = w.add_page(612, 792)
    rotated = seed % 3 == 2
    for k in range(int(rng.integers(6, 14))):
        x = round(float(rng.uniform(30, 480)), 1)
        y = round(float(rng.uniform(40, 760)), 1)
        if rotated and k:
            p.ops.append(f"BT /F1 10 Tf 0 1 -1 0 {x:g} {y:g} Tm "
                         f"(word {k}) Tj ET")
        else:
            p.text(x, y, f"run {k} of {int(rng.integers(1000))}",
                   size=round(float(rng.uniform(7, 14)), 1))
    n_cols = int(rng.integers(2, 5))
    widths = [round(float(v), 1) for v in rng.uniform(40, 110, n_cols)]
    cells = [[f"c{r}{c}" if rng.random() < 0.8 and not rotated else ""
              for c in range(n_cols)] for r in range(int(rng.integers(2, 6)))]
    p.table(60, round(float(rng.uniform(380, 520)), 1), widths, 20, cells,
            size=9)
    p.line(40, 300, 560, 300 + float(rng.uniform(0, 1)), lw=0.6)
    p.rect(70, 260, 300, 1.5, fill=True)
    p.rect(70, 120, 250, 90, lw=1.0)
    p.rect(400, 200, 2, 80, fill=True)
    ok, jpeg = cv2.imencode(".jpg", np.full((20, 30, 3), 90, np.uint8))
    p.image(jpeg.tobytes(), 360, 40, 150, 100, 30, 20)
    return w.tobytes()


@pytest.fixture(scope="module", params=SEEDS)
def pages(request):
    data = synthetic_pdf(request.param)
    with JDoc.open(data) as jd, PdfDocument.open(data) as td:
        yield request.param, jd.load_page(0), td.load_page(0)


def _cells(cells):
    return [(c.bbox, c.text, c.cell_type.name, c.char_advances,
             c.score) for c in cells]


@pytest.mark.parametrize("scale", [1.0, 2.0, 144 / 72 * 0.97])
def test_pdf_text_task_matches_jax(pages, scale):
    _, jp, tp = pages
    want = jpt.OcrPdfTextTask()(jp, scale)
    got = tpt.OcrPdfTextTask()(tp, scale)
    assert want and _cells(got) == _cells(want)
    rng = np.random.default_rng(len(want))
    for jc, tc in zip(want, got):
        cuts = sorted(rng.uniform(jc.x1 - 5, jc.x2 + 5, 3).tolist())
        assert _cells(tpt.OcrPdfTextTask.split_cell_at(tc, cuts)) == \
            _cells(jpt.OcrPdfTextTask.split_cell_at(jc, cuts))


def test_rotation_check_matches_jax(pages):
    seed, jp, tp = pages
    got = tpt.check_pdf_text_need_rotate90(tp)
    assert got == jpt.check_pdf_text_need_rotate90(jp)
    assert got == (seed % 3 == 2)


def test_figure_check_and_bbox_transform_match_jax(pages):
    _, jp, tp = pages
    rng = np.random.default_rng(7)
    scale = 2.0
    boxes = [(730, 1310, 1010, 1500), (700, 1290, 1040, 1520),
             (100, 100, 400, 300)]
    boxes += [tuple(float(v) for v in np.sort(rng.uniform(0, 1400, 4)))
              for _ in range(20)]
    for b in boxes:
        assert tpt.table_bbox_is_pdf_image(b, tp, scale) == \
            jpt.table_bbox_is_pdf_image(b, jp, scale)
        assert tpt.pdf_to_image_bbox(b, 792, scale) == \
            jpt.pdf_to_image_bbox(b, 792, scale)
    assert tpt.table_bbox_is_pdf_image(boxes[0], tp, scale)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_from_pdf_matches_jax(pages, scale):
    _, jp, tp = pages
    assert tfp.pdf_page_lines(tp, scale) == jfp.pdf_page_lines(jp, scale)
    want = jfp.detect_table_regions(jp, scale)
    got = tfp.detect_table_regions(tp, scale)
    assert want and got == want
    assert tfp.extract_cells_from_pdf_page(tp, scale) == \
        jfp.extract_cells_from_pdf_page(jp, scale)
    for region in want:
        box = region["bbox"]
        r = tfp.extract_cells_from_pdf_page(tp, scale, bbox=box)
        assert r == jfp.extract_cells_from_pdf_page(jp, scale, bbox=box)
        assert r["cells"]


def test_line_cell_exports_match_jax():
    import pdf_table_tpu.models.line_cell as jlc
    import pdf_table_tpu_torch.models.line_cell as tlc

    assert set(jlc.__all__) <= set(tlc.__all__)
    assert tlc.detect_table_regions is tfp.detect_table_regions
