"""The table-structure task's per-crop surface against the JAX package's:
``LorePreProcessor.warp_u8`` bit-equal to ``cv2.warpAffine`` of the uint8
crop (OpenCV 5.0 on the CPU), ``batch_infer(crops)`` equal to JAX's
``batch_infer`` per crop (LORE wireless and wtw at the tiny configs of
tests/test_torch_table_structure.py and tests/test_torch_table_structure_wtw.py,
SLANet, CenterNet and LineCell: the cells, and the table HTML byte for
byte), and ``__call__(image)`` equal to JAX's ``__call__`` for LORE: the
host preprocess equal to JAX's cv2 input, the cells equal. ``warp_u8`` is
held at LORE wireless's 768^2 and 1024^2 on random crops of 80-1400 px
too (F17)."""

import copy

import cv2
import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.center_net import CenterNetConfig as JCNConfig
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.models.lore.processor import \
    LorePreProcessor as JLorePre
from pdf_table_tpu.models.slanet import SLANetConfig as JSLANetConfig
from pdf_table_tpu.tasks.table_to_html import \
    OcrTableToHtmlTask as JTableToHtml
from pdf_table_tpu_torch.models.center_net.config import CenterNetConfig
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.processor import LorePreProcessor
from pdf_table_tpu_torch.models.slanet.config import SLANetConfig
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask
import test_torch_table_structure as wireless
import test_torch_table_structure_wtw as wtw

torch.set_num_threads(1)

# (image h, w, model input side, corner-anchored): both anchors, down- and
# upscale, odd sizes
WARPS = [(37, 53, 64, True), (300, 200, 64, True), (41, 29, 128, False),
         (513, 257, 96, False), (20, 20, 64, True), (101, 77, 64, False),
         (64, 64, 64, True), (7, 301, 160, False)]


@pytest.mark.parametrize("h,w,side,upper_left", WARPS)
def test_warp_u8_is_cv2(h, w, side, upper_left):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 3] = 128          # flat areas give exact halves
    cfg = LoreConfig.wireless(resolution=(side, side), upper_left=upper_left)
    got = LorePreProcessor(cfg).warp_u8(img)
    jcfg = JLoreConfig.wireless(resolution=(side, side),
                                upper_left=upper_left)
    want = JLorePre(jcfg).warp_u8(img)
    assert got["image_u8"].dtype == np.uint8
    np.testing.assert_array_equal(got["image_u8"], want["image_u8"])
    for k in ("s", "org_shape", "out_h", "out_w"):
        assert got["meta"][k] == want["meta"][k]
    np.testing.assert_array_equal(got["meta"]["c"], want["meta"]["c"])


@pytest.mark.parametrize("side", [768, 1024])
def test_warp_u8_is_cv2_at_lore_sizes(side):
    """F17: LORE wireless's warp at its model sizes, of ten random crops
    of 80-1400 px a side (both anchors), equal to JAX's ``warp_u8``
    (``cv2.warpAffine``)."""
    rng = np.random.default_rng(side)
    for t in range(10):
        h, w = (int(v) for v in rng.integers(80, 1401, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        kw = dict(resolution=(side, side), upper_left=bool(t % 2))
        np.testing.assert_array_equal(
            LorePreProcessor(LoreConfig.wireless(**kw)).warp_u8(img)
            ["image_u8"],
            JLorePre(JLoreConfig.wireless(**kw)).warp_u8(img)["image_u8"])


def _crops(pages, regions):
    return [np.ascontiguousarray(pages[pi, y1:y2, x1:x2])
            for pi, (x1, y1, x2, y2) in regions]


def _jax_task(v, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        task = jts.OcrTableStructureTask(**kw)
        task.ensure_built()
    return task


def _same(got, want, box_px=1e-3):
    """Cells equal (logic, boxes and scores to f32 round-off), the table
    HTML byte for byte."""
    assert got["type"] == want["type"]
    assert len(got["cells"]) == len(want["cells"])
    for g, w in zip(got["cells"], want["cells"]):
        assert g["logic"] == w["logic"]
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0,
                                   atol=box_px)
    assert OcrTableToHtmlTask()(got, []) == JTableToHtml()(want, [])
    return len(got["cells"])


LORE = {
    "wireless": (wireless, "wireless", LoreConfig.wireless,
                 JLoreConfig.wireless, wireless.TINY),
    "wtw": (wtw, "wtw", LoreConfig.wtw, JLoreConfig.wtw, wtw.TINY_WTW),
}


@pytest.fixture(scope="module", params=sorted(LORE))
def lore_tasks(request):
    mod, task_type, cfg, jcfg, tiny = LORE[request.param]
    v = mod._weights()
    jtask = _jax_task(v, model="Lore", task_type=task_type,
                      config=jcfg(**tiny))
    ttask = OcrTableStructureTask(model="Lore", task_type=task_type,
                                  config=cfg(**tiny), device="cpu",
                                  variables=v)
    return jtask, ttask, _crops(mod._pages(), mod.REGIONS)


def test_lore_batch_infer_matches_jax(lore_tasks):
    jtask, ttask, crops = lore_tasks
    ttask.batch_size = jtask.config.batch_size = 3   # two sub-batches
    want = jtask.batch_infer(crops)
    got = ttask.batch_infer(crops)
    assert len(got) == len(want) == len(crops)
    assert sum(_same(g, w) for g, w in zip(got, want)) > 0


def test_lore_call_matches_jax(lore_tasks):
    jtask, ttask, crops = lore_tasks
    n = 0
    for crop in crops:
        x, _ = ttask.host_preprocess(crop)
        want_x = jtask.pre(crop)["image"]
        np.testing.assert_array_equal(x, want_x)
        n += _same(ttask(crop), jtask(crop))
    assert n > 0


def test_slanet_batch_infer_matches_jax():
    from test_torch_slanet import PAGES, REGIONS, TINY, slanet_tree

    crops = _crops(PAGES, REGIONS)
    probe = OcrTableStructureTask(model="SLANet", device="cpu", **TINY)
    x = np.concatenate([probe.host_preprocess(c)[0] for c in crops])
    v = slanet_tree(SLANetConfig(**TINY), x)
    jtask = _jax_task(v, model="SLANet", config=JSLANetConfig(**TINY))
    ttask = OcrTableStructureTask(model="SLANet", device="cpu", variables=v,
                                  batch_size=2, **TINY)
    jtask.config.batch_size = 2
    want = jtask.batch_infer(crops)
    got = ttask.batch_infer(crops)
    for g, w in zip(got, want):
        assert g["structure_tokens"] == w["structure_tokens"]
        assert OcrTableToHtmlTask()(g, []) == JTableToHtml()(w, [])


def test_centernet_batch_infer_matches_jax():
    from test_torch_center_net import (CONFIGS, REGIONS, _pages,
                                       shaped_tree)

    kw = CONFIGS["tiny"]
    crops = _crops(_pages(), REGIONS)
    probe = OcrTableStructureTask(model="CenterNet", device="cpu", **kw)
    x = np.concatenate([probe.host_preprocess(c)[0] for c in crops])
    v = shaped_tree(CenterNetConfig(**kw), torch.from_numpy(x))
    jtask = _jax_task(v, model="CenterNet", config=JCNConfig(**kw))
    ttask = OcrTableStructureTask(model="CenterNet", device="cpu",
                                  variables=v, config=CenterNetConfig(**kw))
    want = jtask.batch_infer(crops)
    got = ttask.batch_infer(crops)
    assert sum(_same(g, w) for g, w in zip(got, want)) > 0


def test_line_cell_batch_infer_matches_jax():
    crops = _crops(wireless._pages(), wireless.REGIONS)
    want = jts.OcrTableStructureTask(model="LineCell").batch_infer(crops)
    got = OcrTableStructureTask(model="LineCell",
                                device="cpu").batch_infer(crops)
    assert sum(_same(g, w) for g, w in zip(got, want)) > 0


def test_batch_infer_of_nothing():
    task = OcrTableStructureTask(model="LineCell", device="cpu")
    assert task.batch_infer([]) == []
