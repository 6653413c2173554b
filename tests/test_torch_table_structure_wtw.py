"""The wtw slice as a whole: the same synthetic pages and table regions
through the JAX package's OcrTableStructureTask.batch_infer_from_pages
(on the CPU it runs the device refine chain: detect-decode, dense refine
and re-sort, gather + regressor) and through the port's, on the same
weights (the port on the CPU). Cells must match, the table HTML must be
byte-equal, and the refine must have snapped vertices."""

import copy

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.tasks.table_to_html import \
    OcrTableToHtmlTask as JTableToHtml
from pdf_table_tpu_torch.engine.params import (init_lore,
                                               perturb_conv_offset_mask)
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.corner_refine import \
    refine_vertices_by_corners
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

torch.set_num_threads(1)

TINY_WTW = dict(resolution=(64, 64), max_objs=8, max_corners=16,
                hidden_size=32, head_conv=16, tsfm_layers=1,
                stacking_layers=1, num_heads=4, max_fmp_size=64, d_ff=64,
                vis_thresh=0.1, vis_thresh_corner=0.1)
REGIONS = [(0, (10, 12, 130, 100)), (1, (0, 0, 140, 160)),
           (1, (20, 30, 50, 55)), (0, (60, 70, 90, 95))]


def _weights():
    """Seeded wtw tree with perturbed offsets. On top, for this test only:
    cell corners at 1.5 feature-map px (cells survive the post filter's
    1 px minimum), corner group boxes of +-0.75 px (cell quads hold them,
    so vertices snap), the cell heatmap near 0.5 (a cell the refine
    penalizes stays valid) and a 10x wider logical regressor output."""
    v = perturb_conv_offset_mask(
        init_lore(LoreConfig.wtw(**TINY_WTW), seed=0), seed=1)
    v = copy.deepcopy(v)
    p = v["params"]
    heads = p["detector"]["heads"]
    heads["hm_out"]["bias"] = np.array([0.0, -2.19], np.float32)
    heads["wh_out"]["bias"] = np.array(
        [1.5, 1.5, -1.5, 1.5, -1.5, -1.5, 1.5, -1.5], np.float32)
    heads["st_out"]["bias"] = np.array(
        [0.75, 0.75, -0.75, 0.75, -0.75, -0.75, 0.75, -0.75], np.float32)
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
            model="Lore", task_type="wtw",
            config=JLoreConfig.wtw(**TINY_WTW))
        jtask.ensure_built()
    assert jtask.wiz_device_refine
    ttask = OcrTableStructureTask(model="Lore", task_type="wtw",
                                  config=LoreConfig.wtw(**TINY_WTW),
                                  device="cpu", variables=v)
    return jtask, ttask


@pytest.mark.parametrize("res_buckets", [(), (32,)])
def test_wtw_slice_matches_jax(tasks, res_buckets):
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
            np.testing.assert_allclose(gc["poly"], wc["poly"], atol=1e-3)
            np.testing.assert_allclose(gc["score"], wc["score"], atol=1e-5)
        n_cells += len(g["cells"])
        assert OcrTableToHtmlTask()(g, []) == JTableToHtml()(w, [])
    assert n_cells > 0, "the test weights should produce cells"


def test_wtw_slice_snaps_vertices(tasks):
    """The refine moved at least one vertex of a cell above threshold in
    the slice's sub-batches."""
    _, ttask = tasks
    ttask.res_buckets = ()
    cfg = ttask.model_config
    k = cfg.max_objs
    snapped = 0
    with torch.inference_mode():
        for _sub, _metas, x in ttask.sub_batches(_pages(), REGIONS):
            dc = ttask.model.detect_decode(x)["dc_packed"]
            dets = dc[:, :k, :8]
            refined, _ = refine_vertices_by_corners(
                dets, dc[:, :k, 8], dc[:, k:, :8], dc[:, k:, 8:10],
                dc[:, k:, 10], cfg.vis_thresh, cfg.vis_thresh_corner)
            moved = (refined != dets).reshape(*dets.shape[:2], 4, 2).any(-1)
            snapped += int(moved[dc[:, :k, 8] >= cfg.vis_thresh].sum())
    assert snapped > 0


def test_default_task_is_wtw_and_runs():
    """OcrTableStructureTask() defaults to the wtw model (wiz_rev at
    1024^2); with the tiny overrides it runs a region on the CPU."""
    task = OcrTableStructureTask(device="cpu", resolution=(64, 64),
                                 max_objs=8, max_corners=16, hidden_size=32,
                                 head_conv=16, tsfm_layers=1,
                                 stacking_layers=1, num_heads=4,
                                 max_fmp_size=64, d_ff=64)
    cfg = task.model_config
    assert cfg.task_type == "wtw" and cfg.wiz_rev
    assert LoreConfig.wtw().resolution == (1024, 1024)
    out = task(_pages()[0, :100, :120])
    assert out["type"] == "lore" and isinstance(out["cells"], list)
    assert OcrTableToHtmlTask()(out, []).startswith("<table")
