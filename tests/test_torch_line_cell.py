"""The port's LineCell (pdf_table_tpu_torch/models/line_cell), written
without cv2, against OpenCV and the JAX package on the CPU: the grey
image, the adaptive threshold and both opened masks bit-equal to cv2's on
tests/test_line_cell.py's ``make_table_image`` and noisy, thick, thin,
broken-line and tinted variants; the contour boxes equal to cv2's; lines
and cells equal to the JAX function's; ``merge_tsr_cells`` equal; the
``LineCell`` and ``LoreAndLineCell`` tasks equal to JAX's through
``batch_infer_from_pages``."""

import copy

import cv2
import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.line_cell import algo as jalgo
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.tasks.table_to_html import \
    OcrTableToHtmlTask as JTableToHtml
from pdf_table_tpu_torch.engine.params import (init_lore,
                                               perturb_conv_offset_mask)
from pdf_table_tpu_torch.models.line_cell import algo
from pdf_table_tpu_torch.models.line_cell.grid import build_grid_cells
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.tasks.table_structure import (OcrTableStructureTask,
                                                       merge_tsr_cells)
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask
from tests.test_line_cell import make_table_image

torch.set_num_threads(1)


def _variants():
    rng = np.random.default_rng(0)
    base = make_table_image(3, 3)
    noisy = np.clip(make_table_image(4, 5, cell=36).astype(np.int32)
                    + rng.integers(-40, 40, (4 * 36 + 2, 5 * 36 + 2, 3)),
                    0, 255).astype(np.uint8)
    broken = make_table_image(3, 4, cell=45)
    broken[40:50, 60:75] = 255          # gaps in a row line and a column
    broken[100:120, 88:92] = 255
    tinted = make_table_image(2, 3, cell=50, lw=2)
    tinted[..., 0] = np.where(tinted[..., 0] > 128, 230, 60)
    return {"base": base, "wide": make_table_image(2, 4),
            "noisy": noisy, "thick": make_table_image(3, 3, cell=48, lw=6),
            "thin": make_table_image(3, 4, cell=30, lw=1),
            "broken": broken, "tinted": tinted}


IMAGES = _variants()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_masks_bit_equal_to_cv2(name):
    img = IMAGES[name]
    grey = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(algo.rgb_to_grey(img), grey)
    thr = cv2.adaptiveThreshold(np.invert(grey), 255,
                                cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                cv2.THRESH_BINARY, 15, -2)
    got = algo.adaptive_threshold(grey)
    np.testing.assert_array_equal(got, thr)
    h, w = thr.shape
    for kw, kh in ((max(w // 15, 5), 1), (1, max(h // 15, 5))):
        k = cv2.getStructuringElement(cv2.MORPH_RECT, (kw, kh))
        opened = cv2.morphologyEx(thr, cv2.MORPH_OPEN, k)
        np.testing.assert_array_equal(algo.open_rect(got, kw, kh), opened)
        contours, _ = cv2.findContours(opened, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        assert sorted(algo.external_boxes(opened)) == \
            sorted(cv2.boundingRect(c) for c in contours)


def test_external_boxes_skip_nested_components():
    m = np.zeros((40, 40), np.uint8)
    m[2:30, 2:30] = 255
    m[5:25, 5:25] = 0
    m[10:15, 10:15] = 255             # inside the ring's hole
    m[0, 35:40] = 255                 # on the image border
    m[39, 0:5] = 255
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    assert sorted(algo.external_boxes(m)) == \
        sorted(cv2.boundingRect(c) for c in contours)
    assert len(algo.external_boxes(m)) == 3


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_lines_and_cells_equal_to_jax(name):
    img = IMAGES[name]
    jh, jv = jalgo.find_table_lines(img)
    th, tv = algo.find_table_lines(img)
    assert (th, tv) == (sorted(jh), sorted(jv))
    for scale in (10, 15):
        want = jalgo.extract_cells_from_image(img, scale=scale)
        assert algo.extract_cells_from_image(img, scale=scale) == want
    assert len(want["cells"]) > 0


def test_grid_cells_do_not_depend_on_line_order():
    h = [(0, 0, 100), (20, 0, 60), (20, 55, 100), (40, 0, 100)]
    v = [(0, 0, 40), (50, 20, 40), (100, 0, 40), (50, 0, 12)]
    want = build_grid_cells(h, v)
    assert build_grid_cells(h[::-1], v[::-1]) == want


def _cells(rng, n):
    xy = rng.uniform(0, 150, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    return [{"bbox": [float(a) for a in np.concatenate([p, p + s])],
             "score": 0.5} for p, s in zip(xy, wh)]


def test_merge_tsr_cells_equal():
    rng = np.random.default_rng(3)
    for _ in range(5):
        primary = {"cells": _cells(rng, 12), "type": "lore"}
        secondary = {"cells": _cells(rng, 9), "type": "line_cell"}
        secondary["cells"] += [dict(c) for c in primary["cells"][:3]]
        want = jts.merge_tsr_cells(copy.deepcopy(primary),
                                   copy.deepcopy(secondary))
        assert merge_tsr_cells(primary, secondary) == want


TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64, vis_thresh=0.1)


def _pages():
    pages = np.full((2, 170, 200, 3), 255, np.uint8)
    pages[0, 10:132, 10:172] = make_table_image(3, 4, cell=40, lw=2)
    pages[1, 20:142, 30:152] = make_table_image(3, 3)
    pages[1, 100:103, 170:198] = 0
    return pages


REGIONS = [(0, (5, 5, 195, 160)), (1, (25, 15, 160, 150)),
           (0, (60, 40, 140, 120))]


def _lore_tree():
    v = perturb_conv_offset_mask(
        init_lore(LoreConfig.wireless(**TINY), seed=0), seed=1)
    v["params"]["detector"]["heads"]["wh_out"]["bias"] = np.array(
        [1.5, 1.5, -1.5, 1.5, -1.5, -1.5, 1.5, -1.5], np.float32)
    return v


@pytest.mark.parametrize("model", ["LineCell", "LoreAndLineCell"])
def test_tasks_match_jax(model):
    pages = _pages()
    v = _lore_tree()
    kw = {} if model == "LineCell" else {"task_type": "wireless"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        jtask = jts.OcrTableStructureTask(
            model=model, res_buckets="auto",
            config=None if model == "LineCell"
            else JLoreConfig.wireless(**TINY), **kw)
        want = jtask.batch_infer_from_pages(pages, REGIONS)
    ttask = OcrTableStructureTask(
        model=model, device="cpu", res_buckets="auto", variables=v,
        config=None if model == "LineCell" else LoreConfig.wireless(**TINY),
        **kw)
    assert ttask.res_buckets == jtask.res_buckets if model != "LineCell" \
        else True
    got = ttask.batch_infer_from_pages(pages, REGIONS)
    assert len(got) == len(want) == len(REGIONS)
    for g, w in zip(got, want):
        assert g["type"] == w["type"]
        assert len(g["cells"]) == len(w["cells"]) > 0
        for gc, wc in zip(g["cells"], w["cells"]):
            assert gc["logic"] == wc["logic"]
            np.testing.assert_allclose(gc["bbox"], wc["bbox"], rtol=0,
                                       atol=1e-3)
        assert OcrTableToHtmlTask()(g, []) == JTableToHtml()(w, [])
