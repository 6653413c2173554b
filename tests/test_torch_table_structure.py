"""The slice as a whole: the same synthetic pages and table regions through
the JAX package's OcrTableStructureTask.batch_infer_from_pages and through
the port's, on the same weights (the port on the CPU). Cells must match and
the table HTML must be byte-equal."""

import copy

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.entity.ocr_cell import OcrCell
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.tasks.table_to_html import \
    OcrTableToHtmlTask as JTableToHtml
from pdf_table_tpu_torch.engine.params import (init_lore,
                                               perturb_conv_offset_mask)
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.entity.ocr_cell import OcrCell as TOcrCell
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

torch.set_num_threads(1)

TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64, vis_thresh=0.1)
REGIONS = [(0, (10, 12, 130, 100)), (1, (0, 0, 140, 160)),
           (1, (20, 30, 50, 55)), (0, (60, 70, 90, 95))]


def _weights():
    """Seeded tree with perturbed offsets. On top, for this test only:
    corner offsets of 1.5 feature-map px (cells survive the post filter's
    1 px minimum) and a 10x wider logical regressor output (the random
    grid has several columns)."""
    v = perturb_conv_offset_mask(
        init_lore(LoreConfig.wireless(**TINY), seed=0), seed=1)
    v = copy.deepcopy(v)
    p = v["params"]
    p["detector"]["heads"]["wh_out"]["bias"] = np.array(
        [1.5, 1.5, -1.5, 1.5, -1.5, -1.5, 1.5, -1.5], np.float32)
    p["processor"]["stacker"]["tsfm"]["decoder"]["linear_2"]["kernel"] *= 10
    return v


def _pages():
    pages = np.full((2, 160, 140, 3), 255, np.uint8)
    for y in range(10, 160, 18):
        pages[:, y:y + 2, :] = 30
    for x in range(10, 140, 25):
        pages[:, :, x:x + 2] = 30
    pages[1, 40:60, 30:90] = (200, 40, 90)
    return pages


@pytest.fixture(scope="module")
def tasks():
    v = _weights()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        jtask = jts.OcrTableStructureTask(
            model="Lore", task_type="wireless",
            config=JLoreConfig.wireless(**TINY))
        jtask.ensure_built()
    ttask = OcrTableStructureTask(model="Lore", task_type="wireless",
                                  config=LoreConfig.wireless(**TINY),
                                  device="cpu", variables=v)
    return jtask, ttask


@pytest.mark.parametrize("res_buckets", [(), (32,)])
def test_slice_matches_jax(tasks, res_buckets):
    jtask, ttask = tasks
    jtask.res_buckets = ttask.res_buckets = res_buckets
    pages = _pages()
    want = jtask.batch_infer_from_pages(pages, REGIONS)
    got = ttask.batch_infer_from_pages(pages, REGIONS)
    assert len(got) == len(want) == len(REGIONS)
    n_cells = 0
    for g, w in zip(got, want):
        assert len(g["cells"]) == len(w["cells"])
        for gc, wc in zip(g["cells"], w["cells"]):
            assert gc["logic"] == wc["logic"]
            # crop px from f32 fmap coords on both sides
            np.testing.assert_allclose(gc["bbox"], wc["bbox"], atol=1e-3)
            np.testing.assert_allclose(gc["score"], wc["score"], atol=1e-5)
        n_cells += len(g["cells"])
        assert OcrTableToHtmlTask()(g, []) == JTableToHtml()(w, [])
    assert n_cells > 0, "the test weights should produce cells"


def test_call_is_the_one_region_page_path(tasks):
    """``__call__`` runs the host preprocess (the float warp of JAX's
    ``__call__``), no longer the one-region page path, and gives JAX's
    cells (tests/test_torch_tsr_crops.py holds it per crop)."""
    jtask, ttask = tasks
    ttask.res_buckets = ()
    img = _pages()[0, :120, :100]
    got, want = ttask(img), jtask(img)
    assert len(got["cells"]) == len(want["cells"]) > 0
    for gc, wc in zip(got["cells"], want["cells"]):
        assert gc["logic"] == wc["logic"]
        np.testing.assert_allclose(gc["bbox"], wc["bbox"], atol=1e-3)


def test_entry_point_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcrTableStructureTask(model="Lore", task_type="wireless", **TINY)


def test_html_with_texts_matches_jax():
    """Text boxes woven into the grid: overlap >= 0.5, the nearest-centre
    fallback, a box outside every cell, two boxes of one cell on one line
    in reverse x order, a box on a second line, and escaped characters."""
    tsr = {"offset": (100, 50), "cells": [
        {"bbox": [0, 0, 40, 20], "logic": [0, 0, 0, 0]},
        {"bbox": [40, 0, 120, 20], "logic": [0, 0, 1, 2]},
        {"bbox": [0, 20, 40, 60], "logic": [1, 2, 0, 0]},
        {"bbox": [40, 20, 80, 40], "logic": [1, 1, 1, 1]},
        {"bbox": [80, 40, 120, 60], "logic": [2, 2, 2, 2]}]}
    boxes = [((102, 52, 130, 66), "a<b"), ((175, 53, 215, 67), "right"),
             ((145, 52, 170, 66), "left"), ((104, 80, 136, 92), "line 2"),
             ((102, 72, 136, 84), "line 1"), ((125, 62, 155, 82), "edge"),
             ((300, 300, 320, 310), "outside"), ((182, 92, 215, 106), "&")]
    want = JTableToHtml()(tsr, [OcrCell.from_bbox(b, t) for b, t in boxes])
    got = OcrTableToHtmlTask()(tsr, [TOcrCell.from_bbox(b, t)
                                     for b, t in boxes])
    assert got == want
    assert "a&lt;b" in got and "left right" in got
