"""DBNet's polygon mode in the port: ``cv_host.arc_length`` and
``cv_host.approx_poly_dp`` against ``cv2.arcLength`` / ``cv2.approxPolyDP``
(OpenCV 5.0.0 on this box) point for point, on 400 random bitmaps' contours
at several tolerances, closed and open, and on the thresholded prob maps of
a seeded PP-OCRv4 detector; then the polygon-mode post-processor
(``return_polygon``) against the JAX package's on the same prob maps:
polygons equal, scores equal, ``is_polygon``."""

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from pdf_table_tpu.models.dbnet import processor as jdbproc
from pdf_table_tpu.models.dbnet.config import DbNetConfig as JDbCfg
from pdf_table_tpu_torch.engine.params import init_dbnet
from pdf_table_tpu_torch.models.dbnet import processor as tdbproc
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.ops import cv_host
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from test_torch_detection import _page as det_page

torch.set_num_threads(1)

FRACTIONS = (0.001, 0.003, 0.01, 0.02, 0.05, 0.1, 0.3)
DET = dict(inner_channels=48, limit_side_len=128)


def _bitmaps(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = rng.integers(16, 160, 2)
        bm = rng.random((h, w)) < rng.uniform(0.2, 0.7)
        size = int(rng.integers(1, 7))
        yield (ndimage.uniform_filter(bm.astype(np.float64), size)
               > 0.5).astype(np.uint8), rng


def _held_to_cv2(contour, frac, closed):
    c = np.ascontiguousarray(contour, np.int32)
    length = cv_host.arc_length(c, closed)
    assert length == cv2.arcLength(c, closed)
    eps = frac * length
    want = cv2.approxPolyDP(c, eps, closed)
    got = cv_host.approx_poly_dp(c, eps, closed)
    assert got.dtype == np.int32 and got.shape == want.shape, (frac, closed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_approx_poly_dp_matches_cv2_on_random_contours(seed):
    n = 0
    for bm, rng in _bitmaps(seed, 100):
        contours, _ = cv2.findContours(bm * 255, cv2.RETR_LIST,
                                       cv2.CHAIN_APPROX_SIMPLE)
        for c in contours[:12]:
            frac = float(rng.choice(FRACTIONS))
            for closed in (True, False):
                _held_to_cv2(c, frac, closed)
            n += 1
    assert n >= 400


def test_degenerate_curves_match_cv2():
    for pts in ([[3, 4]], [[3, 4], [3, 4]], [[0, 0], [5, 0]],
                [[0, 0], [4, 0], [4, 4], [0, 0]], [[1, 1], [1, 1], [1, 1]]):
        c = np.asarray(pts, np.int32).reshape(-1, 1, 2)
        for closed in (True, False):
            _held_to_cv2(c, 0.5, closed)
    assert cv_host.approx_poly_dp(np.zeros((0, 2), np.int32), 1.0,
                                  True).shape == (0, 1, 2)
    assert cv_host.arc_length(np.zeros((0, 2), np.int32), True) == 0.0


@pytest.fixture(scope="module")
def prob_maps():
    """The seeded detector's prob maps of two pages, and maps of smoothed
    noise, whose blobs reach past the polygon mode's 0.7 score."""
    task = OcrDetectionTask(device="cpu",
                            variables=init_dbnet(DbNetConfig.ppocr(**DET),
                                                 seed=0), **DET)
    maps = []
    for seed, (h, w) in enumerate([(612, 475), (500, 640)]):
        img = det_page(seed, h, w)
        prob = task.prob_map(task.pre(img)["image"]).numpy()
        maps.append(prob.reshape(prob.shape[-2:]))
    rng = np.random.default_rng(5)
    for _ in range(3):
        small = rng.random((16, 21)).astype(np.float32)
        p = cv2.resize(small, (128, 96), interpolation=cv2.INTER_CUBIC)
        maps.append(np.clip(p, 0, 0.999).astype(np.float32))
    return maps


def test_approx_poly_dp_matches_cv2_on_prob_map_bitmaps(prob_maps):
    n = 0
    for prob in prob_maps:
        for q in (0.6, 0.85):
            bm = (prob > np.quantile(prob, q)).astype(np.uint8)
            contours, _ = cv2.findContours(bm * 255, cv2.RETR_LIST,
                                           cv2.CHAIN_APPROX_SIMPLE)
            got = cv_host.find_contours(bm > 0)
            assert len(got) == len(contours)
            for c, g in zip(contours, got):
                np.testing.assert_array_equal(g, c)
                for frac in (0.01, 0.05):
                    _held_to_cv2(c, frac, True)
                n += 1
    assert n >= 40


@pytest.mark.parametrize("thresh", [0.5, 0.6])
def test_polygon_mode_equals_jax(prob_maps, thresh):
    kw = dict(thresh=thresh, box_thresh=0.6, return_polygon=True)
    jpost = jdbproc.DbNetPostProcessor(JDbCfg.ppocr(**kw))
    tpost = tdbproc.DbNetPostProcessor(DbNetConfig.ppocr(**kw))
    n = 0
    for prob in prob_maps:
        org = (prob.shape[0] * 3, prob.shape[1] * 3)
        want = jpost(prob, org)
        got = tpost(prob, org)
        assert got["is_polygon"] is True and want["is_polygon"] is True
        assert got["det_polygons"] == want["det_polygons"]
        np.testing.assert_array_equal(got["det_scores"],
                                      want["det_scores"])
        assert all(len(p) >= 8 and len(p) % 2 == 0
                   for p in got["det_polygons"])
        assert (np.asarray(got["det_scores"]) >= 0.7).all()
        n += len(got["det_polygons"])
    assert n >= 3


def test_detection_task_runs_polygon_mode(prob_maps):
    task = OcrDetectionTask(device="cpu",
                            variables=init_dbnet(DbNetConfig.ppocr(**DET),
                                                 seed=0),
                            return_polygon=True, box_thresh=0.0, **DET)
    out = task(det_page(0, 612, 475))
    assert out["is_polygon"] is True
    assert isinstance(out["det_polygons"], list)
