"""The per-image host paths of detection, classification, recognition and
layout, the natural-size crops and the deskew, each held to its JAX
counterpart on the same inputs and weights (the JAX tasks load the port's
trees through a monkeypatched ``load_or_init``; the port runs on the
CPU).

Held: DBNet's pre-processor within 1e-5 (both resize rules); its
post-processors (contours, host components, device components) equal on
the same prob map, quads and scores (the score of a quad on the map's
border within 2e-2: ``cv2.fillPoly`` draws a mask that leaves the image
within a pixel a row of the port's, ROADMAP.md Queue 3);
``OcrDetectionTask.__call__`` at full width (``limit_side_len=128``) with
its prob map within 1e-5 and its quads and scores equal, both
``use_device_postprocess`` settings; PULC's
pre-processor within 1e-5, ``__call__`` and ``batch_infer`` labels equal
and scores within 1e-5 for every task type; ``OcrRecognitionTask.__call__``
texts equal, scores within 1e-5 (PP-OCRv4 over three width buckets, and
ConvNextViT's three-chunk path); PicoDet's pre-processor within 1e-5,
``__call__`` and ``batch_infer`` layout cells equal up to the first
near-tie of the scores; DocXLayout's host pre-processor within 1e-4 grey
levels of JAX's and of the port's device warp; ``crop_rotated_boxes``
within one grey level, and bit-equal on quads whose corners order onto one
point or a line (F8); ``estimate_skew_angle`` within 1e-4 degrees,
``rotate_image`` within one grey level, ``estimate_skew_angle_fft`` on the
same angle step; ``OcrTablePreprocessTask`` the same turn and angle."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.cls_pulc as jcls
import pdf_table_tpu.tasks.detection as jdet
import pdf_table_tpu.tasks.layout as jlayout
import pdf_table_tpu.tasks.recognition as jrec
from pdf_table_tpu.models.cls import processor as jclsproc
from pdf_table_tpu.models.cls.config import ClsPulcConfig as JClsCfg
from pdf_table_tpu.models.dbnet import processor as jdbproc
from pdf_table_tpu.models.dbnet.config import DbNetConfig as JDbCfg
from pdf_table_tpu.models.docx_layout import processor as jdocxproc
from pdf_table_tpu.models.docx_layout.config import \
    DocXLayoutConfig as JDocxCfg
from pdf_table_tpu.models.picodet import processor as jpicoproc
from pdf_table_tpu.models.picodet.config import PicoDetConfig as JPicoCfg
from pdf_table_tpu.ops import warp as jwarp
from pdf_table_tpu.tasks import preprocess as jpre
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_cls, init_dbnet)
from pdf_table_tpu_torch.models.cls import processor as tclsproc
from pdf_table_tpu_torch.models.cls.config import PULC_LABELS, ClsPulcConfig
from pdf_table_tpu_torch.models.cls.model import PPLCNetClassifier
from pdf_table_tpu_torch.models.dbnet import processor as tdbproc
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.docx_layout import processor as tdocxproc
from pdf_table_tpu_torch.models.docx_layout.config import DocXLayoutConfig
from pdf_table_tpu_torch.models.picodet import processor as tpicoproc
from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
from pdf_table_tpu_torch.ops import warp as twarp
from pdf_table_tpu_torch.tasks import preprocess as tpre
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
from test_torch_detection import _page as det_page
from test_torch_docx_layout import same_cells
from test_torch_picodet import page, picodet_tree
from test_torch_rec_backbones import build as rec_backbone_tree
from test_torch_rec_model import perturb
from test_torch_pipeline import build_trees

torch.set_num_threads(1)

ATOL = 1e-5
BORDER_SCORE_TOL = 2e-2
DET = dict(limit_side_len=128, box_thresh=0.0)
LAYOUT = dict(img_height=64, img_width=64, neck_channels=32, head_convs=1,
              task_type="table", score_threshold=0.05, keep_top_k=4)


def _as_np(tree):
    return lambda *a, **k: jax.tree.map(np.asarray, tree)


def rotated_page(seed, h=300, w=420, angle=3.0):
    """Word bars on white, turned by ``angle`` degrees (cv2)."""
    import cv2
    img = det_page(seed, h, w)
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    return cv2.warpAffine(img, m, (w, h), borderValue=(255, 255, 255))


# -- DBNet ---------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(resize_mode="limit", limit_side_len=96,
                                      norm_style="imagenet"),
                                 dict(resize_mode="short",
                                      image_short_side=64)],
                         ids=["limit", "short"])
def test_dbnet_preprocessor(cfg):
    img = det_page(3, 250, 190)
    want = jdbproc.DbNetPreProcessor(JDbCfg(**cfg))(img)
    got = tdbproc.DbNetPreProcessor(DbNetConfig(**cfg))(img)
    assert got["org_shape"] == want["org_shape"]
    assert got["image"].shape == want["image"].shape
    np.testing.assert_array_equal(got["image"], want["image"])


def _prob(seed, h=96, w=128):
    import cv2
    rng = np.random.default_rng(seed)
    small = rng.random((h // 6, w // 6)).astype(np.float32)
    p = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(p, 0, 0.999).astype(np.float32)


def same_detections(got, want, prob_hw, org_hw, atol=0.0):
    """Quads equal; scores within ``atol``, except a quad's on the prob
    map's border, whose mask ``cv2.fillPoly`` may draw a few pixels off the
    port's (ROADMAP.md Queue 3): within ``BORDER_SCORE_TOL``."""
    np.testing.assert_array_equal(got["det_polygons"], want["det_polygons"])
    q = np.asarray(want["det_polygons"], np.float64).reshape(-1, 4, 2)
    (H, W), (oh, ow) = prob_hw, org_hw
    mx, my = 2.0 * ow / W, 2.0 * oh / H
    border = (q[..., 0].min(1) <= mx) | (q[..., 0].max(1) >= ow - mx) \
        | (q[..., 1].min(1) <= my) | (q[..., 1].max(1) >= oh - my)
    gs, ws = np.asarray(got["det_scores"]), np.asarray(want["det_scores"])
    np.testing.assert_allclose(gs[~border], ws[~border], rtol=0, atol=atol)
    np.testing.assert_allclose(gs[border], ws[border], rtol=0,
                               atol=BORDER_SCORE_TOL)
    return int((~border).sum())


@pytest.mark.parametrize("seed", range(3))
def test_dbnet_postprocessors_equal_on_one_prob_map(seed):
    prob = _prob(seed)
    org = (400, 530)
    kw = dict(thresh=0.55, box_thresh=0.0)
    jpost = jdbproc.DbNetPostProcessor(JDbCfg.ppocr(**kw))
    tpost = tdbproc.DbNetPostProcessor(DbNetConfig.ppocr(**kw))
    want = jpost(prob, org)
    assert len(want["det_polygons"]) >= 3
    assert same_detections(tpost(prob, org), want, prob.shape, org) >= 2
    want = jpost.fast_host_boxes(prob, org)
    got = tpost.fast_host_boxes(prob, org)
    assert len(want["det_polygons"]) >= 3
    np.testing.assert_array_equal(got["det_polygons"], want["det_polygons"])
    np.testing.assert_array_equal(got["det_scores"], want["det_scores"])
    want = jpost.fast_device_boxes(jnp.asarray(prob), org)
    got = tpost.fast_device_boxes(torch.from_numpy(prob), org)
    np.testing.assert_allclose(got["det_polygons"], want["det_polygons"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["det_scores"], want["det_scores"],
                               rtol=0, atol=ATOL)
    poly = dict(kw, return_polygon=True)
    want = jdbproc.DbNetPostProcessor(JDbCfg.ppocr(**poly))(prob, org)
    got = tdbproc.DbNetPostProcessor(DbNetConfig.ppocr(**poly))(prob, org)
    assert got["is_polygon"] and got["det_polygons"] == want["det_polygons"]
    np.testing.assert_array_equal(got["det_scores"], want["det_scores"])


@pytest.fixture(scope="module")
def det_tree():
    return init_dbnet(DbNetConfig.ppocr(**DET), seed=0)


@pytest.mark.parametrize("device_post", [False, True],
                         ids=["contours", "device_boxes"])
def test_detection_call_matches_jax(det_tree, device_post):
    img = det_page(0, 612, 475)
    port = OcrDetectionTask(device="cpu", variables=det_tree,
                            use_device_postprocess=device_post, **DET)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "load_or_init", _as_np(det_tree))
        jt = jdet.OcrDetectionTask(model="PP-OCRv4_det", **DET,
                                   use_device_postprocess=device_post)
        batch, meta = jt._preprocess(img)
        jprob = np.asarray(jt._run_model(batch)["prob"][0])
    prob = port.prob_map(port.pre(img)["image"]).numpy()
    np.testing.assert_allclose(prob, jprob, rtol=0, atol=ATOL)
    # thresholds that give a few dozen components on random weights
    thresh = float(np.quantile(jprob, 0.7))
    for t in (jt, port):
        t.post.config.thresh = thresh
        t.model_config.thresh = thresh
    want = jt(img)
    got = port(img)
    assert got["prob_shape"] == tuple(want["prob_shape"])
    assert len(want["det_polygons"]) >= 3
    if device_post:
        np.testing.assert_allclose(got["det_polygons"],
                                   want["det_polygons"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["det_scores"], want["det_scores"],
                                   rtol=0, atol=ATOL)
    else:
        # both posts on JAX's prob map, then each side's own __call__
        same_detections(port.post(jprob, img.shape[:2]),
                        jt.post(jprob, img.shape[:2]), jprob.shape,
                        img.shape[:2])
        same_detections(got, want, jprob.shape, img.shape[:2], atol=ATOL)


# -- PULC ----------------------------------------------------------------------

def _crops(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(30, 260)), int(rng.integers(40, 300))
        out.append(page(int(rng.integers(0, 99)), h, w))
    return out


def cls_tree(cfg):
    v = perturb(init_cls(cfg, seed=0), seed=1)
    pre = tclsproc.PulcPreProcessor(cfg)
    x = np.concatenate([pre(c)["image"] for c in _crops(7, 4)])
    return calibrate_batch_stats(PPLCNetClassifier(cfg), v,
                                 torch.from_numpy(x))


@pytest.mark.parametrize("task_type", sorted(PULC_LABELS))
def test_pulc_call_and_batch_infer_match_jax(task_type):
    cfg = ClsPulcConfig.for_task(task_type)
    crops = _crops(1)
    for c in crops:
        np.testing.assert_array_equal(
            tclsproc.PulcPreProcessor(cfg)(c)["image"],
            jclsproc.PulcPreProcessor(JClsCfg.for_task(task_type))(c)
            ["image"])
    v = cls_tree(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcls, "load_or_init", _as_np(v))
        jt = jcls.ClsImagePulcTask(task_type=task_type)
        want_one = jt(crops[0])
        want = jt.batch_infer(crops)
    port = ClsImagePulcTask(task_type, device="cpu", variables=v)
    got_one = port(crops[0])
    got = port.batch_infer(crops)
    assert port.batch_infer([]) == []
    for g, w in zip([got_one] + got, [want_one] + want):
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=ATOL)
        if "label" in w:
            assert g["label"] == w["label"]


# -- recognition -----------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe_trees():
    return build_trees()


def _text_crops():
    rng = np.random.default_rng(4)
    out = []
    for w in (60, 150, 230, 330, 500, 45):
        img = np.full((int(rng.integers(20, 40)), w, 3), 255, np.uint8)
        x = 3
        while x < w - 8:
            ww = int(rng.integers(4, 14))
            img[5:-5, x:x + ww] = rng.integers(0, 120, 3)
            x += ww + int(rng.integers(2, 6))
        out.append(img)
    return out


def test_recognition_call_matches_jax(pipe_trees):
    v = pipe_trees["rec"]
    crops = _text_crops()
    kw = dict(width_buckets=(80, 160, 320))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrec, "load_or_init", _as_np(v))
        jt = jrec.OcrRecognitionTask(model="PP-OCRv4_rec", **kw)
        want = jt(crops)
    port = OcrRecognitionTask(device="cpu", variables=v, **kw)
    groups = port.pre(crops)["groups"]
    assert [g["bucket"] for g in groups] == [80, 160, 320]
    got = port(crops)
    assert got["texts"] == want["texts"]
    assert any(want["texts"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ATOL)
    assert port([]) == {"texts": [], "scores": []}


def test_convnext_chunked_call_matches_jax():
    v, _ = rec_backbone_tree("ConvNextViT")
    crops = _text_crops()[:3]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrec, "load_or_init", _as_np(v))
        want = jrec.OcrRecognitionTask(model="ConvNextViT")(crops)
    port = OcrRecognitionTask(model="ConvNextViT", device="cpu",
                              variables=v)
    pre = port.pre(crops)
    assert pre["groups"][0]["chunked"] == 3
    assert pre["groups"][0]["images"].shape == (9, 32, 300, 1)
    got = port(crops)
    assert got["texts"] == want["texts"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ATOL)


# -- PicoDet and DocXLayout ------------------------------------------------------

@pytest.fixture(scope="module")
def pico():
    cfg = PicoDetConfig(**LAYOUT)
    imgs = [page(s, 150 + 20 * s, 120 + 30 * s) for s in range(3)]
    pre = tpicoproc.PicoDetPreProcessor(cfg)
    x = np.concatenate([pre(i)["image"] for i in imgs])
    v = picodet_tree(cfg, x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayout, "load_or_init", _as_np(v))
        jt = jlayout.OcrLayoutTask(model="picodet", **LAYOUT)
        jt.ensure_built()
    port = OcrLayoutTask(model="picodet", device="cpu", variables=v,
                         **LAYOUT)
    return cfg, imgs, jt, port


def test_picodet_preprocessor(pico):
    cfg, imgs, _, _ = pico
    jpre_ = jpicoproc.PicoDetPreProcessor(JPicoCfg(**LAYOUT))
    tpre_ = tpicoproc.PicoDetPreProcessor(cfg)
    for img in imgs:
        w, g = jpre_(img), tpre_(img)
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["org_shape"] == w["org_shape"]
        np.testing.assert_array_equal(tpre_.resize_u8(img)["image_u8"],
                                      jpre_.resize_u8(img)["image_u8"])


def test_picodet_call_and_batch_infer_match_jax(pico):
    _, imgs, jt, port = pico
    compared = 0
    for img in imgs:
        compared += same_cells(port(img)["layout_cells"],
                               jt(img)["layout_cells"])
    for g, w in zip(port.batch_infer(imgs), jt.batch_infer(imgs)):
        compared += same_cells(g, w)
    assert compared > 3


def test_docx_host_preprocessor_matches_jax_and_the_device_warp():
    cfg = DocXLayoutConfig(resolution=(64, 64), head_conv=16)
    img = page(5, 170, 130)
    want = jdocxproc.DocXLayoutPreProcessor(
        JDocxCfg(resolution=(64, 64), head_conv=16))(img)
    got = tdocxproc.DocXLayoutPreProcessor(cfg)(img)
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["meta"] == want["meta"]
    task = OcrLayoutTask(model="DocXLayout", device="cpu",
                         config=copy.deepcopy(cfg))
    with torch.no_grad():
        dev = task.preprocess(torch.from_numpy(img[None])).numpy()
    np.testing.assert_array_equal(dev, got["image"])


# -- crops and deskew ------------------------------------------------------------

def test_crop_rotated_boxes_within_a_grey_level():
    img = det_page(2, 300, 420)
    rng = np.random.default_rng(0)
    quads = [np.array([[20, 30], [200, 30], [200, 52], [20, 52]],
                      np.float32),
             np.array([[0, 0], [420, 0], [420, 20], [0, 20]], np.float32)]
    for _ in range(8):
        c = rng.uniform([60, 60], [360, 240])
        a = rng.uniform(-0.4, 0.4)
        w, h = rng.uniform(30, 120), rng.uniform(10, 30)
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        box = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        quads.append((box @ r.T + c).astype(np.float32))
    quads = np.stack(quads)
    want = jwarp.crop_rotated_boxes(img.copy(), quads, None)
    got = twarp.crop_rotated_boxes(img.copy(), quads)
    assert twarp.crop_rotated_boxes(img, np.zeros((0, 4, 2))) == []
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("angle", [2.0, -3.5, 4.5])
def test_skew_estimate_and_rotation(angle):
    img = rotated_page(1, angle=angle)
    want = jpre.estimate_skew_angle(img)
    got = tpre.estimate_skew_angle(img)
    assert abs(want) > 0.3
    assert got == want
    np.testing.assert_array_equal(tpre.rotate_image(img, got),
                                  jpre.rotate_image(img, want))
    assert tpre.rotate_image(img, 0.0) is img
    fw = jpre.estimate_skew_angle_fft(img, max_angle=8.0, num=4, size=256)
    fg = tpre.estimate_skew_angle_fft(img, max_angle=8.0, num=4, size=256,
                                      device="cpu")
    step = 2 * 8.0 / (8.0 * 4 * 2 - 1)
    assert abs(fg - fw) < 0.5 * step


def test_preprocess_task_matches_jax():
    cfg = ClsPulcConfig.for_task("text_image_orientation")
    v = cls_tree(cfg)
    # a bias that makes the 180 class win confidently
    v["params"]["fc"]["bias"] = np.array([0, 0, 8, 0], np.float32)
    img = rotated_page(3, angle=-2.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcls, "load_or_init", _as_np(v))
        want = jpre.OcrTablePreprocessTask()(img)
    got = tpre.OcrTablePreprocessTask(
        orientation_task=ClsImagePulcTask("text_image_orientation",
                                          device="cpu", variables=v),
        device="cpu")(img)
    assert got["quarter_turns"] == want["quarter_turns"] == 2
    assert got["rotate_angle"] == want["rotate_angle"]
    np.testing.assert_array_equal(got["image"], want["image"])
    same = tpre.OcrTablePreprocessTask(use_orientation_cls=False,
                                       device="cpu")(img, is_pdf=True)
    assert same["image"] is img and same["quarter_turns"] == 0


@pytest.mark.parametrize("kind", ["rect45", "collinear"])
def test_crops_of_degenerate_quads_match_jax(kind):
    """F8 (ROADMAP.md Queue 3): where a quad's corners order onto one
    point or a line, the host crop equals JAX's cv2 crop bit for bit.
    Before the repair 416 of these 500 rectangles and 181 of these 2,000
    quads differed, up to 255 grey levels."""
    from test_torch_cv_host import degenerate_quads

    img = np.random.default_rng(1).integers(0, 256, (520, 520, 3),
                                            dtype=np.uint8)
    quads = degenerate_quads(kind)
    got = twarp.crop_rotated_boxes(img, quads)
    want = jwarp.crop_rotated_boxes(img, quads, None)
    assert len(got) == len(want) == len(quads)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
