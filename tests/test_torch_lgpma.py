"""The port's LGPMA (pdf_table_tpu_torch/models/lgpma, ops/roi_align.py)
against the JAX package at the tiny config of tests/test_lgpma.py, on one
seeded tree (BatchNorm statistics calibrated on the crop) moved through
the weight bridge, on the CPU: roi_align within 1e-6; the FPN and RPN maps
within 1e-5 relative; proposals equal up to the first near-tie (top-k gap
under 1e-5); the bbox, LPMA and GPMA heads on shared RoIs within 1e-5; the
post-processor equal on the same raw outputs (its f32 mask resize within
1e-5 of cv2.resize); the task's cells and logic equal per crop, boxes
within 1e-3 px; two regions of one page through the port's
batch_infer_from_pages equal to JAX's task on each crop."""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.lgpma import LGPMA as JLGPMA
from pdf_table_tpu.models.lgpma import LgpmaConfig as JLgpmaConfig
from pdf_table_tpu.models.lgpma import LgpmaPostProcessor as JPost
from pdf_table_tpu.models.lgpma import model as jm
from pdf_table_tpu.ops.roi_align import roi_align as j_roi_align
from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_lgpma,
                                               scale_batch_variances)
from pdf_table_tpu_torch.models.lgpma.config import LgpmaConfig
from pdf_table_tpu_torch.models.lgpma.model import LGPMA
from test_torch_dtype_policy import assert_bf16_rule
from pdf_table_tpu_torch.models.lgpma.processor import (LgpmaPostProcessor,
                                                        resize_linear_f32)
from pdf_table_tpu_torch.ops.roi_align import roi_align
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask

torch.set_num_threads(1)

TINY = dict(backbone_depth=18, fpn_channels=32, rpn_pre_topk=32,
            num_proposals=16, mask_top=8, fc_dim=64, max_side=64)
REL_TOL = 1e-5
GAP = 1e-5
ROI_TOL = 1e-6
BOX_PX = 1e-3


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale < tol


def _page():
    page = np.full((100, 150, 3), 255, np.uint8)
    page[5:95:15, 5:140] = 30
    page[5:95, 5:145:22] = 30
    page[40:60, 30:90] = (200, 40, 90)
    return page


REGIONS = [(0, (0, 0, 150, 100)), (0, (20, 10, 110, 90))]


def lgpma_tree(cfg, x):
    """Seeded tree, BatchNorm statistics calibrated on the backbone over
    ``x`` and three noise images of its size (the stride-32 map is 1 x 2
    at the tiny size: one image alone gives near-zero variances),
    variances doubled; the class and box-delta logits spread (x 8), so
    that scores and boxes are apart."""
    noise = np.random.default_rng(2).standard_normal(
        (3,) + tuple(x.shape[1:])).astype(np.float32)
    net = LGPMA(cfg).eval()
    net.forward = net.levels
    v = scale_batch_variances(calibrate_batch_stats(
        net, init_lgpma(cfg, seed=0),
        torch.cat([torch.as_tensor(x), torch.from_numpy(noise)])), 2.0)
    for k in ("fc_cls", "fc_reg"):
        v["params"]["bbox_head"][k]["kernel"] *= 8.0
    return v


@pytest.fixture(scope="module")
def setup():
    """The tree calibrated on the first region's input."""
    cfg = LgpmaConfig(**TINY)
    task = OcrTableStructureTask(model="Lgpma", device="cpu",
                                 config=copy.deepcopy(cfg))
    (_s, (meta,), x), = list(task.sub_batches(_page()[None], REGIONS[:1]))
    v = lgpma_tree(cfg, x)
    net = LGPMA(cfg).eval()
    load_flax_variables(net, v)
    jcfg = JLgpmaConfig(**TINY)
    return cfg, jcfg, v, net, x.numpy(), meta


def test_roi_align_matches_jax():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((40, 30, 5)).astype(np.float32)
    b = rng.uniform(-3, 35, (60, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(0, 20, (60, 2)).astype(np.float32)
    for s in (7, 14):
        want = np.asarray(j_roi_align(f, b, out_size=s))
        got = roi_align(torch.from_numpy(f), torch.from_numpy(b), s).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ROI_TOL)


def test_resize_linear_f32_matches_cv2():
    rng = np.random.default_rng(1)
    for h, w in [(5, 9), (40, 13), (14, 14), (28, 56), (3, 2)]:
        img = rng.random((28, 28, 4)).astype(np.float32)
        np.testing.assert_allclose(resize_linear_f32(img, h, w),
                                   cv2.resize(img, (w, h)), rtol=0,
                                   atol=1e-5)


def _jax_intermediates(jcfg, v, x):
    _, st = JLGPMA(jcfg).apply(v, x, train=False,
                               capture_intermediates=True,
                               mutable=["intermediates"])
    return st["intermediates"]


def test_fpn_and_rpn_maps_match(setup):
    cfg, jcfg, v, net, x, _ = setup
    inter = _jax_intermediates(jcfg, v, x)
    want_levels = inter["neck"]["__call__"][0]
    want_rpn = inter["rpn_head"]["__call__"]
    with torch.no_grad():
        levels = net.levels(torch.from_numpy(x))
        assert len(levels) == len(want_levels) == 5
        for lv, w, wr in zip(levels, want_levels, want_rpn):
            _close(lv.permute(0, 2, 3, 1).numpy(), w)
            cls, reg = net.rpn_head(lv)
            _close(cls.numpy(), wr[0])
            _close(reg.numpy(), wr[1])


def test_proposals_match_up_to_near_ties(setup):
    cfg, jcfg, v, net, x, _ = setup
    want = np.asarray(JLGPMA(jcfg).apply(v, x, train=False)["proposals"][0])
    with torch.no_grad():
        levels = net.levels(torch.from_numpy(x))
        props, scores = net.rpn(levels, x.shape[1:3])
    # slots before the first pair of neighbours closer than GAP (the
    # suppressed proposals' exact -1 ties at the end keep index order)
    s = scores.numpy()
    gaps = np.abs(np.diff(s))
    close = np.flatnonzero((gaps > 0) & (gaps < GAP))
    n = int(close[0]) if len(close) else len(s)
    assert n >= 4
    np.testing.assert_allclose(props.numpy()[:n], want[:n], rtol=0,
                               atol=1e-3)


def test_heads_on_shared_rois_match(setup):
    """The bbox, LPMA and GPMA heads of both sides on the JAX forward's
    proposals and mask boxes."""
    cfg, jcfg, v, net, x, _ = setup
    out = JLGPMA(jcfg).apply(v, x, train=False)
    inter = _jax_intermediates(jcfg, v, x)
    jlevels = inter["neck"]["__call__"][0]
    p = v["params"]

    def j_extract(rois, size):
        w = jnp.maximum(rois[:, 2] - rois[:, 0], 1e-3)
        h = jnp.maximum(rois[:, 3] - rois[:, 1], 1e-3)
        lvl = jnp.clip(jnp.floor(jnp.log2(jnp.sqrt(w * h) / 56 + 1e-6)),
                       0, 3).astype(jnp.int32)
        acc = 0.
        for li, stride in enumerate((4, 8, 16, 32)):
            r = j_roi_align(jlevels[li][0], rois / stride, size)
            acc = acc + jnp.where((lvl == li)[:, None, None, None], r, 0.)
        return acc

    props = np.array(out["proposals"][0])
    mboxes = np.array(out["mask_boxes"][0])
    wp, wd = jm.Shared2FCBBoxHead(2, 64).apply(
        {"params": p["bbox_head"]}, j_extract(props, 7))
    wl = jm.LPMAMaskHead(2).apply({"params": p["mask_head"]},
                                  j_extract(mboxes, 14))
    ws, wr = jm.GPMAMaskHead().apply({"params": p["global_seg_head"]},
                                     jlevels[0])
    with torch.no_grad():
        levels = net.levels(torch.from_numpy(x))
        gp, gd = net.bbox_head(net.extract(levels, torch.from_numpy(props),
                                           7))
        gl = net.mask_head(net.extract(levels, torch.from_numpy(mboxes), 14))
        gs, gr = net.global_seg_head(levels[0])
    for g, w in ((gp, wp), (gd, wd), (gl, wl), (gs, ws), (gr, wr)):
        _close(g.numpy(), w)
    assert float(np.asarray(wp)[:, :2].max()) > 0.5


def test_post_processor_matches(setup):
    """Both post-processors on the JAX forward's raw outputs."""
    cfg, jcfg, v, _, x, meta = setup
    raw = {k: np.asarray(a) for k, a in
           JLGPMA(jcfg).apply(v, x, train=False).items()}
    for refine in (True, False):
        want = JPost(JLgpmaConfig(**TINY, refine_bboxes=refine))(raw, meta)
        got = LgpmaPostProcessor(LgpmaConfig(**TINY, refine_bboxes=refine))(
            raw, meta)
        assert got == want
        assert len(got["cells"]) > 0


@pytest.fixture(scope="module")
def tasks(setup):
    cfg, jcfg, v, _, _, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        jtask = jts.OcrTableStructureTask(model="Lgpma",
                                          config=JLgpmaConfig(**TINY))
        jtask.ensure_built()
    ttask = OcrTableStructureTask(model="Lgpma", device="cpu",
                                  config=LgpmaConfig(**TINY), variables=v)
    return jtask, ttask


def _same_cells(got, want, box_px=BOX_PX):
    assert got["type"] == want["type"] == "lgpma"
    assert len(got["cells"]) == len(want["cells"])
    for g, w in zip(got["cells"], want["cells"]):
        assert g["logic"] == w["logic"]
        assert g["label"] == w["label"]
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0,
                                   atol=box_px)


def test_task_per_crop_matches_jax(tasks):
    jtask, ttask = tasks
    page = _page()
    for _, (x1, y1, x2, y2) in REGIONS:
        crop = np.ascontiguousarray(page[y1:y2, x1:x2])
        _same_cells(ttask(crop), jtask(crop))


def test_two_regions_of_a_page_match_jax_per_crop(tasks):
    """The port runs a page's regions one forward each; JAX's runner
    cannot (ROADMAP: faults of the reference side), so each result is held
    against JAX's task on its crop."""
    jtask, ttask = tasks
    page = _page()
    got = ttask.batch_infer_from_pages(page[None], REGIONS)
    assert len(got) == len(REGIONS)
    for g, (_, (x1, y1, x2, y2)) in zip(got, REGIONS):
        _same_cells(g, jtask(np.ascontiguousarray(page[y1:y2, x1:x2])))
    assert sum(len(g["cells"]) for g in got) > 0


def test_batch_infer_of_crops_of_other_sizes_matches_jax_per_crop(tasks):
    """``batch_infer`` on crops that plan to three sizes (64x32, 64x64,
    32x64 at ``max_side=64``), each a forward of its own, against JAX's
    ``batch_infer`` one crop at a time (JAX's fails on two or more crops:
    ROADMAP, faults of the reference side)."""
    jtask, ttask = tasks
    page = _page()
    crops = [np.ascontiguousarray(page[:, :50]),
             np.ascontiguousarray(page[10:90, 20:110]),
             np.ascontiguousarray(page)]
    sizes = {ttask.pre.plan(*c.shape[:2])[:2] for c in crops}
    assert len(sizes) == 3, sizes
    got = ttask.batch_infer(crops)
    assert len(got) == len(crops)
    for g, c in zip(got, crops):
        _same_cells(g, jtask.batch_infer([c])[0])
    assert sum(len(g["cells"]) for g in got) > 0


def test_task_rejects_bf16():
    """The LGPMA task builds in bf16 when asked (against JAX:
    tests/test_torch_bf16_tsr.py), every module with flax's weight rule,
    and stays f32 by default, as JAX builds its config directly."""
    task = OcrTableStructureTask(model="Lgpma", device="cpu",
                                 dtype="bfloat16", **TINY)
    assert_bf16_rule(task.model)
    assert OcrTableStructureTask(model="Lgpma", device="cpu", **TINY) \
        .model_config.dtype == "float32"
