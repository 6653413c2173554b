"""Digital PDF pages through the port's ``BatchPipeline.run`` against the JAX
package's, on the CPU, with the runner-test sizes and trees of
tests/test_torch_pipeline.py (PP-OCRv4 detection at a 96-px detector
input, PicoDet at 64x64, full-width recognition, the tiny wireless LORE;
both runners get bench.py's injected line grid, the JAX one its fused
device recognition and ``upload_codec="rgb"``).

Each side reads the PDFs with its own reader and renders its digital pages
itself (``pdfio.render_page``, 144 dpi). Held per page: ``page_html``,
``table_html``, the text cells (boxes, texts, types; a raster page's
scores within 1e-5), ``pdf_scale``, ``is_pdf`` and the image equal, the layout cells' labels
equal and their boxes within 1e-2 px of the 64-px model input.

- A mixed batch, PicoDet layout and LORE, ``batch_pages=4``: a raster
  page, two golden digital PDFs (``digital_simple``,
  ``digital_multi_table``) that share a chunk with it, an A3
  digital page at 144 dpi (1684x2382 px, scaled to fit 2048x1536: a
  non-integer downscale) in a chunk with a raster page scaled by a
  non-integer factor and one scaled by exactly 2.
- The 8 digital golden PDFs (tests/golden/cases.py, written with JAX's
  writer; ten pages) with ``layout_model="none"``: every table from the
  vector lines.

Port-only: a page authored rotated by 90 degrees runs the serial per-page
system, as the JAX runner runs it (held to JAX's in
tests/test_torch_system.py), the other pages unharmed; a page whose
rendering fails is contained; ``last_stats`` carries the ``pdf_text``
lane."""

import os
import sys

import numpy as np
import pytest
import torch

from pdf_table_tpu.pdfio import PdfDocument as JDoc
from pdf_table_tpu.pdfio import PdfWriter
from pdf_table_tpu_torch.pdfio import PdfDocument
from pdf_table_tpu_torch.pipeline import batch_runner as tbr
from test_torch_pipeline import (PAGES, build_trees, jax_pipeline, jax_tasks,
                                 port_pipeline)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

torch.set_num_threads(1)

MIXED_GOLDEN = ("digital_simple", "digital_multi_table")
# PicoDet's boxes in 64-px model-input px: its stride-32 distance bins
# amplify the 1e-4 of the layout resize (tests/test_torch_layout.py) to
# some 5e-3 on the 2048x1536 canvas of the scaled pages
LAYOUT_ATOL = 1e-2


def a3_pdf() -> bytes:
    """An A3 portrait page: a wired table, paragraphs, a thick rule."""
    w = PdfWriter()
    p = w.add_page(842, 1191)
    p.text(60, 1140, "An A3 page rendered above the largest bucket.")
    p.table(60, 1080, [160, 120, 120, 120], 26,
            [["item", "qty", "unit", "total"], ["bolts", "40", "0.10", "4.0"],
             ["nuts", "40", "0.05", "2.0"], ["washers", "80", "0.01", "0.8"]])
    p.line(60, 900, 780, 900, lw=2.0)
    for k in range(6):
        p.text(60, 860 - 22 * k, f"Paragraph line {k} under the rule.")
    return w.tobytes()


def rotated_pdf() -> bytes:
    w = PdfWriter()
    p = w.add_page(612, 792)
    for k in range(8):
        p.ops.append(f"BT /F1 11 Tf 0 1 -1 0 {100 + 40 * k} 120 Tm "
                     f"(rotated line {k}) Tj ET")
    return w.tobytes()


def _downscaled(h, w, seed):
    """A raster page above the largest bucket (text strokes and rules)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(80, h - 80, 70):
        x = int(rng.integers(40, 200))
        img[y:y + 12, x:x + int(rng.integers(300, w - x - 40))] = 40
    img[h // 3:h // 3 + 600:120, 100:w - 100] = 20
    return img


def _open(data, reader):
    doc = reader.open(data)
    return doc, [doc.load_page(i) for i in range(doc.page_count)]


def _digital_pages(pdfs, reader):
    """pdfs [(name, bytes)] -> pages with pdf_page and pdf_doc (no
    image)."""
    out = []
    for name, data in pdfs:
        doc, pages = _open(data, reader)
        out += [{"pdf_page": pg, "pdf_doc": doc, "page": len(out) + k}
                for k, pg in enumerate(pages)]
    return out


def _golden_pdfs(tmp, names):
    return [(n, open(cases.DIGITAL_CASES[n](tmp), "rb").read())
            for n in names]


def _mixed(pdfs, reader):
    """Two canvas buckets: 1600x1280 (a raster page and the two golden
    pages) and 2048x1536 (the A3 page and the two scaled raster pages)."""
    raster = [PAGES[1], _downscaled(2100, 900, 0),
              _downscaled(4096, 3072, 1)]
    digital = _digital_pages(pdfs, reader)
    pages = [digital[0], {"image": raster[0]}, digital[1], digital[2],
             {"image": raster[1]}, {"image": raster[2]}]
    for i, p in enumerate(pages):
        p["page"] = i
    return pages


@pytest.fixture(scope="module")
def trees():
    return build_trees()


@pytest.fixture(scope="module")
def jtasks(trees):
    return jax_tasks(trees)


@pytest.fixture(scope="module")
def mixed_runs(trees, jtasks, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mixed"))
    pdfs = _golden_pdfs(tmp, MIXED_GOLDEN) + [("a3", a3_pdf())]
    want = jax_pipeline(jtasks, False, batch_pages=4).run(_mixed(pdfs, JDoc))
    bp = port_pipeline(trees, False)
    bp.batch_pages = 4
    return bp, bp.run(_mixed(pdfs, PdfDocument)), want


@pytest.fixture(scope="module")
def golden_runs(trees, jtasks, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden"))
    pdfs = _golden_pdfs(tmp, list(cases.DIGITAL_CASES))
    jt = {k: v for k, v in jtasks.items() if k != "_layout"}
    jbp = jax_pipeline(jt, False, batch_pages=4)
    jbp.system.config.layout_model = "none"
    want = jbp.run(_digital_pages(pdfs, JDoc))
    bp = port_pipeline(trees, False)
    bp.batch_pages = 4
    bp.system.config.layout_model = "none"
    bp.system._layout = None
    return bp, bp.run(_digital_pages(pdfs, PdfDocument)), want


def _cells(cells):
    return [(c.bbox, c.text, c.cell_type.name) for c in cells]


def _same_pages(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.metric == w.metric == {}
        assert (g.page, g.is_pdf, g.pdf_scale, g.image_shape) == \
            (w.page, w.is_pdf, w.pdf_scale, w.image_shape)
        np.testing.assert_array_equal(g.image, w.image)
        assert _cells(g.text_cells) == _cells(w.text_cells)
        # a raster page's recognition scores agree to 1e-5 (as in
        # tests/test_torch_pipeline.py); a digital page's are 1.0
        np.testing.assert_allclose([c.score for c in g.text_cells],
                                   [c.score for c in w.text_cells],
                                   atol=0 if g.is_pdf else 1e-5, rtol=0)
        assert [(c.label, c.cell_type.name) for c in g.layout_cells] == \
            [(c.label, c.cell_type.name) for c in w.layout_cells]
        canvas_px = max(tbr.pick_page_bucket(*g.image_shape)) / 64
        np.testing.assert_allclose([c.bbox for c in g.layout_cells],
                                   [c.bbox for c in w.layout_cells],
                                   atol=LAYOUT_ATOL * canvas_px, rtol=0)
        assert g.table_html == w.table_html
        assert g.page_html == w.page_html


def test_mixed_batch_matches_jax(mixed_runs):
    bp, got, want = mixed_runs
    _same_pages(got, want)
    assert [g.is_pdf for g in got] == [True, False, True, True, False,
                                       False]
    assert all(g.pdf_page is not None for g in got if g.is_pdf)
    assert all(g.table_html for g in got if g.is_pdf)
    assert any(g.table_html for g in got if not g.is_pdf), \
        "no raster table reached LORE"
    st = bp.last_stats
    assert st["pdf_text"] >= 0.0 and st["rasterize"] > 0.0
    assert st["n_pages"] == len(got)


def test_oversize_pages_are_scaled_as_jax_scales_them(mixed_runs):
    _, got, want = mixed_runs
    a3, non_int, exact = got[3], got[4], got[5]
    # A3 at 144 dpi is 1684x2382 px; 2048 / 2382 of it
    assert a3.image_shape == (2048, int(1684 * 2048 / 2382))
    assert a3.pdf_scale == 2048 / 1191
    assert non_int.image_shape == (2048, int(900 * 2048 / 2100))
    assert exact.image_shape == (2048, 1536)
    for g in (a3, non_int, exact):
        assert g.metric == {} and g.page_html


def test_digital_golden_pdfs_match_jax(golden_runs):
    bp, got, want = golden_runs
    assert bp.system.layout_task is None
    _same_pages(got, want)
    assert len(got) == 10 and all(g.is_pdf for g in got)
    assert sum(len(g.table_html) for g in got) >= 8
    assert all(g.text_cells and g.page_html for g in got)


def test_a_rotated_page_names_the_serial_system(trees):
    """A page authored rotated by 90 degrees runs the serial per-page
    system (it gave an error output naming it until that was ported): its
    raster turned, its text read by OCR, its stage times in ``metric``."""
    bp = port_pipeline(trees, False)
    bp.system.config.use_orientation_cls = False
    doc, (page,) = _open(rotated_pdf(), PdfDocument)
    out = bp.run([{"image": PAGES[2], "page": 0},
                  {"pdf_page": page, "pdf_doc": doc, "page": 1}])
    assert out[0].metric == {} and out[0].page_html
    assert out[1].is_pdf and "error" not in out[1].metric
    assert {"image_pre_process", "layout", "detection", "recognition",
            "ocr_html"} <= set(out[1].metric)
    assert out[1].page == 1 and out[1].image_shape == (1224, 1584)
    assert bp.last_stats["digital_serial"] > 0.0


def test_a_failing_render_is_contained(trees, monkeypatch):
    bp = port_pipeline(trees, False)
    doc, (page,) = _open(a3_pdf(), PdfDocument)

    def broken(*a, **k):
        raise RuntimeError("render failed")

    import pdf_table_tpu_torch.pdfio.render as render
    monkeypatch.setattr(render, "render_page", broken)
    out = bp.run([{"pdf_page": page, "pdf_doc": doc, "page": 0},
                  {"image": PAGES[2], "page": 1}])
    assert out[0].is_pdf and out[0].metric == {
        "error": "RuntimeError: render failed"}
    assert out[1].metric == {} and out[1].page_html


def test_line_cell_pdf_is_the_line_cell_task():
    """"LineCellPdf" is the "LineCell" task, as in the JAX dispatcher; the
    digital pages' vector lines are read by the runner."""
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    page = PAGES[2][None, 300:700, 40:860].copy()
    regions = [(0, (0, 0, page.shape[2], page.shape[1]))]
    got = OcrTableStructureTask(model="LineCellPdf", device="cpu")
    want = OcrTableStructureTask(model="LineCell", device="cpu")
    assert got.model_name == "LineCell"
    assert got.batch_infer_from_pages(page, regions) == \
        want.batch_infer_from_pages(page, regions)
    with pytest.raises(ValueError, match="unknown TSR model"):
        OcrTableStructureTask(model="LineCellPdfX", device="cpu")
