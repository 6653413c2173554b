"""The per-page system, ``OcrSystemTask.__call__``, against the JAX package's
on the CPU, on the trees and sizes of tests/test_torch_pipeline.py
(PP-OCRv4 detection at a 96-px detector input with bench.py's thresholds,
PicoDet at 64x64 with the table arguments, full-width PP-OCRv4 recognition
with one 80-px width bucket, the full-width 0/180 PP-LCNet, the tiny
wireless LORE) plus the full-width page-orientation PP-LCNet
(``text_image_orientation``, 224x224) of the pre-process task. The JAX
tasks load the same trees through monkeypatched ``load_or_init``.

Held on each page, against JAX's ``OcrSystemTask.__call__``: ``page_html``,
``table_html``, ``rotate_angle`` (equal), the text cells (boxes and texts
equal, scores within 1e-5), the layout cells (labels equal, boxes within
1e-3 px of the model input, scores within 1e-4), the working image equal,
and the ``metric`` keys. The JAX side runs its own pre-process and crops:
its deskew (``estimate_skew_angle``, ``rotate_image``) and its natural-size
text crops (``crop_rotated_boxes(img, quads, None)``) go through cv2, which
the port's host geometry equals bit for bit (tests/test_torch_cv_host.py,
tests/test_torch_host_paths.py). The per-image detector
(``OcrDetectionTask.__call__``, held to JAX's in
tests/test_torch_host_paths.py) is the port's on both sides: a text box
comes from the pixels over a threshold, and the 1e-5 between XLA's
convolutions and torch's moves a pixel or two of a page across it.

Pages: a raster page with a wired table (with LORE, and with LineCell), the
page skewed by 3 degrees, a page of word bars turned by a seeded 2.03
degrees (whose skew the port measured 0.023 degrees off OpenCV's before
F16's repair), the page turned by 180 degrees (with a 0/180 classifier that
reads every crop as turned), the page turned by 90 degrees (with a detector
whose boxes follow the bars, so that the aspect check turns it back), a
digital text page, a digital wired-table page and a digital page authored
rotated by 90 degrees. Then ``ocr`` and ``timing_summary`` (JAX's keys),
``debug`` (the overlay equal to JAX's outside its labels,
tests/test_torch_aux_tasks.py), and the runner: ``BatchPipeline.run`` on a
digital page authored rotated (the serial route), and its
``device_boxes=False`` (``_det_post`` with both ``fast_post`` values) and
``device_crops=False`` lanes, each per page equal to the JAX runner with
the same flag."""

import cv2
import numpy as np
import pytest
import torch

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.tasks.cls_pulc as jcls
import pdf_table_tpu.tasks.detection as jdet
from pdf_table_tpu.pdfio import PdfDocument as JDoc
from pdf_table_tpu.pdfio import PdfWriter
from pdf_table_tpu.pipeline.system import OcrSystemConfig as JConfig
from pdf_table_tpu.pipeline.system import OcrSystemTask as JSystem
from pdf_table_tpu.tasks.preprocess import \
    OcrTablePreprocessTask as JPreprocess
from pdf_table_tpu_torch.models.cls.config import ClsPulcConfig
from pdf_table_tpu_torch.pdfio import PdfDocument
from pdf_table_tpu_torch.pipeline import batch_runner as tbr
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig, OcrSystemTask
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.preprocess import OcrTablePreprocessTask
from test_torch_digital_pipeline import rotated_pdf
from test_torch_host_paths import cls_tree
from test_torch_pipeline import (PAGES, _as_np, _inject_lines, _tsr_arm,
                                 build_trees, jax_pipeline, jax_tasks,
                                 port_pipeline)

torch.set_num_threads(1)

TASKS = ("_det", "_layout", "_rec", "_tsr", "_line_cls")
# the per-page detector: the runner tests' tree at a 320-px input, its
# threshold at the 77th percentile of the first page's prob map, so that
# random weights give some twenty text boxes a page
DET = dict(inner_channels=48, limit_side_len=320, box_thresh=0.0)
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    t = build_trees()
    # a recognizer whose decisions do not hang on the 1e-5 between XLA's
    # logits and torch's: the CTC head at 2x its seed, not 0.2x
    t["rec"]["params"]["ctc_head"]["kernel"] *= 10.0
    t["orient"] = cls_tree(ClsPulcConfig.for_task("text_image_orientation"))
    flipped = {k: dict(v) for k, v in t["cls"].items()}
    flipped["params"] = dict(t["cls"]["params"])
    flipped["params"]["fc"] = {"kernel": t["cls"]["params"]["fc"]["kernel"],
                               "bias": np.array([0.0, 9.0], np.float32)}
    t["cls180"] = flipped
    return t


@pytest.fixture(scope="module")
def jtasks(trees):
    tasks = jax_tasks(trees)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "load_or_init", _as_np(trees["det"]))
        det = jdet.OcrDetectionTask(model="PP-OCRv4_det", **DET)
        batch, _ = det._preprocess(PAGES[0])
        prob = np.asarray(det._run_model(batch)["prob"][0])
    # the per-image detector is the port's on both sides (module
    # docstring)
    port_det = OcrDetectionTask(
        device="cpu", variables=trees["det"],
        **dict(DET, thresh=float(np.quantile(prob, 0.77))))
    tasks["port_det"] = port_det
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcls, "load_or_init", _as_np(trees["orient"]))
        orient = jcls.ClsImagePulcTask(task_type="text_image_orientation")
        orient.ensure_built()
        mp.setattr(jcls, "load_or_init", _as_np(trees["cls180"]))
        cls180 = jcls.ClsImagePulcTask(task_type="textline_orientation")
        cls180.ensure_built()
    tasks["_preprocess"] = JPreprocess(orientation_task=orient)
    tasks["cls180"] = cls180
    return tasks


def systems(trees, jtasks, tsr="Lore", flip_cls=False, **cfg):
    """(port system, JAX system) on the same trees."""
    bp = port_pipeline(trees, True)
    port = OcrSystemTask(OcrSystemConfig(table_structure_model=tsr, **cfg),
                         device="cpu")
    for name in TASKS:
        setattr(port, name, getattr(bp.system, name))
    port._det = jtasks["port_det"]
    port._preprocess = OcrTablePreprocessTask(
        orientation_task=ClsImagePulcTask("text_image_orientation",
                                          device="cpu",
                                          variables=trees["orient"]),
        device="cpu")
    jsys = JSystem(JConfig(table_structure_model=tsr, **cfg))
    for name in TASKS + ("_preprocess",):
        setattr(jsys, name, jtasks[name])
    jsys._det = jtasks["port_det"]
    if tsr == "LineCell":
        jsys._tsr, kw = _tsr_arm("LineCell", trees)
        port._tsr = None
        port.config.table_structure_kwargs = kw
    if flip_cls:
        jsys._line_cls = jtasks["cls180"]
        port._line_cls = ClsImagePulcTask("textline_orientation",
                                          device="cpu",
                                          variables=trees["cls180"])
    return port, jsys


def same_output(g, w, image_atol=0):
    """One page's outputs equal (module docstring)."""
    assert (g.page, g.is_pdf, g.image_shape) == (w.page, w.is_pdf,
                                                 w.image_shape)
    assert g.pdf_scale == w.pdf_scale
    assert g.rotate_angle == w.rotate_angle
    assert set(g.metric) == set(w.metric)
    assert np.abs(g.image.astype(int) - w.image).max() <= image_atol
    assert [c.text for c in g.text_cells] == [c.text for c in w.text_cells]
    np.testing.assert_array_equal(
        np.asarray([c.bbox for c in g.text_cells]).reshape(-1, 4),
        np.asarray([c.bbox for c in w.text_cells]).reshape(-1, 4))
    np.testing.assert_allclose([c.score for c in g.text_cells],
                               [c.score for c in w.text_cells], rtol=0,
                               atol=1e-5)
    assert [(c.label, c.cell_type.name) for c in g.layout_cells] == \
        [(c.label, c.cell_type.name) for c in w.layout_cells]
    px = max(g.image_shape) / 64
    np.testing.assert_allclose(
        np.asarray([c.bbox for c in g.layout_cells]).reshape(-1, 4),
        np.asarray([c.bbox for c in w.layout_cells]).reshape(-1, 4),
        rtol=0, atol=BOX_ATOL * px)
    np.testing.assert_allclose([c.score for c in g.layout_cells],
                               [c.score for c in w.layout_cells], rtol=0,
                               atol=SCORE_ATOL)
    assert len(g.table_structures) == len(w.table_structures)
    assert g.table_html == w.table_html
    assert g.page_html == w.page_html


def skewed(img, angle):
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    return cv2.warpAffine(img, m, (w, h), borderValue=(255, 255, 255))


# the first test page's ruled block with text above and below it, and a
# text strip of the third
TABLE_PAGE = np.ascontiguousarray(PAGES[0][260:760])
TEXT_PAGE = np.ascontiguousarray(PAGES[2][:420])


def bar_page(seed):
    """Word bars of dark greys on white, 300-600 px a side, turned by a
    seeded angle within 8 degrees (cv2)."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(300, 601)), int(rng.integers(300, 601))
    img = np.full((h, w, 3), 255, np.uint8)
    y = int(rng.integers(10, 40))
    while y < h - 20:
        x = int(rng.integers(10, 40))
        lh = int(rng.integers(6, 14))
        while x < w - 30:
            ww = int(rng.integers(8, 60))
            img[y:y + lh, x:min(x + ww, w - 10)] = int(rng.integers(0, 90))
            x += ww + int(rng.integers(4, 14))
        y += lh + int(rng.integers(8, 24))
    return skewed(img, float(rng.uniform(-8, 8)))


RASTER = {
    "table": lambda: TABLE_PAGE,
    "skewed": lambda: skewed(TABLE_PAGE, 3.0),
    "skewed_bars": lambda: bar_page(22),
}


@pytest.mark.parametrize("name", sorted(RASTER))
def test_raster_pages_match_jax(name, trees, jtasks):
    port, jsys = systems(trees, jtasks)
    img = RASTER[name]()
    want = jsys(image=img.copy(), page=3)
    got = port(image=img.copy(), page=3)
    same_output(got, want)
    assert "textline_orientation" in got.metric
    assert got.text_cells and got.page_html
    if name == "table":
        assert got.table_html, "no table reached LORE"
    if name.startswith("skewed"):
        assert abs(got.rotate_angle) > 0.3


def test_a_page_turned_by_180_is_turned_back(trees, jtasks):
    port, jsys = systems(trees, jtasks, flip_cls=True)
    img = np.ascontiguousarray(np.rot90(TEXT_PAGE, 2))
    want = jsys(image=img.copy())
    got = port(image=img.copy())
    same_output(got, want)
    assert got.rotate_angle % 180 == 0 and got.rotate_angle >= 180


class BarDetector:
    """A stand-in detector for both sides: a quad around each dark bar of
    the page (8-connected components of grey < 128, 40 px or more), so
    that the boxes follow the text's direction."""

    def __call__(self, image):
        from pdf_table_tpu_torch.ops import cv_host
        _, _, stats = cv_host.connected_components_with_stats(
            cv_host.rgb_to_grey(image) < 128)
        quads = [[x, y, x + w, y, x + w, y + h, x, y + h]
                 for x, y, w, h, area in stats[1:] if area >= 40]
        return {"det_polygons": np.asarray(quads, np.float32).reshape(-1, 8),
                "det_scores": np.ones(len(quads), np.float32)}


def test_a_page_authored_turned_by_90_is_turned(trees, jtasks):
    """Most boxes taller than wide: the page is turned by 90 degrees and
    detected again (the detector follows the bars, BarDetector)."""
    port, jsys = systems(trees, jtasks)
    port._det = jsys._det = BarDetector()
    page = np.full((300, 420, 3), 255, np.uint8)
    rng = np.random.default_rng(7)
    for k in range(6):
        page[30 + 44 * k:48 + 44 * k, 30:30 + int(rng.integers(150, 360))] \
            = rng.integers(10, 90, 3)
    img = np.ascontiguousarray(np.rot90(page, 1))
    want = jsys(image=img.copy())
    got = port(image=img.copy())
    same_output(got, want)
    assert got.rotate_angle == 90.0 and got.image_shape == page.shape[:2]
    assert len(got.text_cells) == 6


def test_line_cell_widens_the_table_regions(trees, jtasks):
    port, jsys = systems(trees, jtasks, tsr="LineCell")
    want = jsys(image=TABLE_PAGE.copy())
    got = port(image=TABLE_PAGE.copy())
    same_output(got, want)
    assert port.tsr_task.model_name == "LineCell"
    assert got.table_structures
    assert all(r["type"] == "line_cell" for r in got.table_structures)


def _pdf(kind) -> bytes:
    if kind == "rotated":
        return rotated_pdf()
    w = PdfWriter()
    p = w.add_page(612, 792)
    p.text(60, 740, "A digital page with vector text.")
    for k in range(6):
        p.text(60, 700 - 20 * k, f"Paragraph line {k} of the page body.")
    if kind == "table":
        p.table(60, 540, [150, 100, 100], 24,
                [["name", "qty", "price"], ["bolts", "40", "0.10"],
                 ["nuts", "12", "0.05"]])
    return w.tobytes()


def _open(data, reader):
    doc = reader.open(data)
    return doc, doc.load_page(0)


@pytest.mark.parametrize("kind", ["text", "table", "rotated"])
def test_digital_pages_match_jax(kind, trees, jtasks):
    port, jsys = systems(trees, jtasks)
    jdoc, jpage = _open(_pdf(kind), JDoc)
    tdoc, tpage = _open(_pdf(kind), PdfDocument)
    want = jsys(pdf_page=jpage, pdf_doc=jdoc, page=1)
    got = port(pdf_page=tpage, pdf_doc=tdoc, page=1)
    same_output(got, want, image_atol=0)
    assert got.is_pdf and got.page_html
    if kind == "table":
        assert got.table_html and "pdf_text_extract" in got.metric
    if kind == "rotated":
        assert "detection" in got.metric and "recognition" in got.metric


def test_ocr_timing_summary_and_debug(trees, jtasks):
    port, jsys = systems(trees, jtasks)
    pages = [{"image": TEXT_PAGE}, {"image": TEXT_PAGE[:200], "src_id": "b"}]
    want = jsys.ocr([dict(p) for p in pages])
    got = port.ocr([dict(p) for p in pages])
    assert [g.page for g in got] == [0, 1] and got[1].src_id == "b"
    for g, w in zip(got, want):
        same_output(g, w)
    ts, js = OcrSystemTask.timing_summary(got), JSystem.timing_summary(want)
    assert set(ts) == set(js)
    for k in ts:
        assert set(ts[k]) == set(js[k]) and ts[k]["count"] == 2.0
    # debug: the annotated overlay, equal to JAX's outside the labels
    from test_torch_aux_tasks import assert_overlays_match, overlay_labels
    port.config.debug = jsys.config.debug = True
    got, want = port(image=TABLE_PAGE.copy()), jsys(image=TABLE_PAGE.copy())
    same_output(got, want)
    assert got.table_structures
    assert_overlays_match(
        got.debug["render"], want.debug["render"], got.image,
        overlay_labels(got.layout_cells,
                       [(None, r) for r in got.table_structures]))


def test_entry_points_run_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcrSystemTask()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcrTablePreprocessTask()


# -- the runner ------------------------------------------------------------------

def _runner_pages(reader):
    doc, page = _open(_pdf("rotated"), reader)
    return [{"pdf_page": page, "pdf_doc": doc, "page": 1}]


def _same_runner_pages(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert "error" not in g.metric and "error" not in w.metric
        same_output(g, w, image_atol=0)


def test_the_serial_route_matches_the_jax_runner(trees, jtasks):
    jbp = jax_pipeline(jtasks, True)
    jbp.system.config.use_orientation_cls = False
    bp = port_pipeline(trees, True)
    want = jbp.run(_runner_pages(JDoc))
    got = bp.run(_runner_pages(PdfDocument))
    _same_runner_pages(got, want)
    assert got[0].is_pdf and got[0].page == 1 and "recognition" in \
        got[0].metric
    assert bp.last_stats["digital_serial"] > 0.0


@pytest.mark.parametrize("lane", ["device_boxes", "device_crops"])
def test_host_lanes_match_the_jax_runner(lane, trees, jtasks):
    cfg = JConfig(use_layout=True, use_table=True,
                  use_orientation_cls=False, use_textline_cls=True)
    jbp = jbr.BatchPipeline(cfg, batch_pages=2, upload_codec="rgb",
                            device_crops=lane != "device_crops",
                            device_boxes=lane != "device_boxes")
    for name in TASKS:
        setattr(jbp.system, name, jtasks[name])
    _inject_lines(jbp)
    bp = port_pipeline(trees, True)
    setattr(bp, lane, False)
    pages = [{"image": PAGES[2], "page": 0}]
    want = jbp.run(pages)
    got = bp.run(pages)
    _same_runner_pages(got, want)
    assert sum(len(g.text_cells) for g in got) >= len(pages)


@pytest.mark.parametrize("fast_post", [True, False],
                         ids=["components", "contours"])
def test_det_post_matches_jax(fast_post, trees, jtasks, monkeypatch):
    jbp = jax_pipeline(jtasks, False)
    bp = port_pipeline(trees, False)
    det = bp.system.det_task
    groups = tbr.pack_pages([PAGES[0], PAGES[2]])
    (bucket, g), = [(b, g) for b, g in groups.items() if len(g["shapes"]) == 2]
    probs = det.enqueue_probs(g["images"], bucket).numpy()
    thresh = float(np.quantile(probs, 0.7)) / 255.0
    monkeypatch.setattr(det.post.config, "thresh", thresh)
    monkeypatch.setattr(jbp.system.det_task.post.config, "thresh", thresh)
    want = jbp._det_post(probs, g["shapes"], bucket, None, fast_post)
    got = bp._det_post(probs, g["shapes"], bucket, fast_post)
    assert sum(len(q) for q in want) >= 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
