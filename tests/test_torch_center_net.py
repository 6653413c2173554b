"""The port's Cycle-CenterNet (pdf_table_tpu_torch/models/center_net)
against the JAX package on one seeded tree moved through the weight
bridge, on the CPU, at tests/test_docx_centernet.py:52's config and once
at full width (head_conv 256, K 300, MK 600) at 96^2: heads within 1e-5
relative of flax; dets, scores, gboxes and centers within 1e-4 on the same
head maps; group_bbox_by_gbox and assign_logical_coords equal; the
pre-processor's input within 1e-4 grey levels of JAX's cv2.warpAffine
path; the task's cells equal per crop and through batch_infer_from_pages,
up to the first near-tie of scores."""

import copy

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import linen as jnn

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.center_net import CenterNetConfig as JConfig
from pdf_table_tpu.models.center_net import CenterNetPreProcessor as JPre
from pdf_table_tpu.models.center_net import CycleCenterNet as JNet
from pdf_table_tpu.models.center_net import processor as jproc
from pdf_table_tpu.tasks.table_to_html import \
    OcrTableToHtmlTask as JTableToHtml
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_centernet,
                                               perturb_conv_offset_mask,
                                               scale_batch_variances)
from pdf_table_tpu_torch.models.center_net import processor as tproc
from pdf_table_tpu_torch.models.center_net.config import CenterNetConfig
from pdf_table_tpu_torch.models.center_net.model import CycleCenterNet
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

torch.set_num_threads(1)

CONFIGS = {"tiny": dict(resolution=(64, 64), head_conv=16, K=8, MK=16),
           "full_width": dict(resolution=(96, 96))}
REL_TOL = 1e-5
DECODE_TOL = 1e-4
TIE_GAP = 1e-5
BOX_PX = 1e-3
REGIONS = [(0, (10, 12, 130, 100)), (1, (0, 0, 140, 160)),
           (1, (20, 30, 50, 55))]


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale < tol


def _pages():
    pages = np.full((2, 160, 140, 3), 255, np.uint8)
    for y in range(10, 160, 18):
        pages[:, y:y + 2, :] = 30
    for x in range(10, 140, 25):
        pages[:, :, x:x + 2] = 30
    pages[1, 40:60, 30:90] = (200, 40, 90)
    return pages


def shaped_tree(cfg, x):
    """init_centernet with perturbed offsets, BatchNorm statistics
    calibrated on ``x`` and variances doubled; both heatmap channels near
    0.5 (cells and vertices pass the 0.3 threshold), cell corners at
    +-1.5 feature-map px and each vertex's centres at +-1.5 px, so that
    vertices snap."""
    net = CycleCenterNet(cfg).eval()
    net.forward = net.heads
    v = perturb_conv_offset_mask(init_centernet(cfg, seed=0), seed=1)
    v = scale_batch_variances(calibrate_batch_stats(net, v, x), 2.0)
    heads = v["params"]["trunk"]["heads"]
    heads["hm_out"]["bias"] = np.zeros(2, np.float32)
    quad = np.array([1.5, 1.5, -1.5, 1.5, -1.5, -1.5, 1.5, -1.5],
                    np.float32)
    heads["v2c_out"]["bias"] = quad.copy()
    heads["c2v_out"]["bias"] = -quad
    return v


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    kw = CONFIGS[request.param]
    cfg = CenterNetConfig(**kw)
    task = OcrTableStructureTask(model="CenterNet", device="cpu",
                                 config=copy.deepcopy(cfg))
    (_s, _m, x), = list(task.sub_batches(_pages(), REGIONS))
    v = shaped_tree(cfg, x)
    net = CycleCenterNet(cfg).eval()
    load_flax_variables(net, v)
    return cfg, JConfig(**kw), v, net, x.numpy()


def test_init_centernet_has_the_flax_tree(setup):
    cfg, jcfg, v, _, x = setup
    want = jax.eval_shape(JNet(jcfg).init, jax.random.PRNGKey(0), x[:1])
    assert {p: tuple(a.shape) for p, a in tree_leaves(v)} == \
        {p: tuple(a.shape) for p, a in tree_leaves(want)}


def _jax_heads(jcfg, v, x):
    _, st = JNet(jcfg).apply(v, x, capture_intermediates=True,
                             mutable=["intermediates"])
    return st["intermediates"]["trunk"]["__call__"][0]


def test_heads_match_flax(setup):
    cfg, jcfg, v, net, x = setup
    want = _jax_heads(jcfg, v, x)
    with torch.no_grad():
        got = net.heads(torch.from_numpy(x))
    assert set(got) == set(want) == {"hm", "v2c", "c2v", "reg"}
    for k in got:
        _close(got[k].numpy(), want[k])


def test_decode_matches_on_the_same_heads(setup):
    """Both decodes on JAX's head maps: the JAX module with its trunk
    swapped for the maps."""
    cfg, jcfg, v, net, x = setup
    heads = {k: np.array(a) for k, a in _jax_heads(jcfg, v, x).items()}

    class Given(jnn.Module):
        def __call__(self, x, train=False):
            return heads

    class JDecode(JNet):
        def setup(self):
            self.trunk = Given()

    want = JDecode(jcfg).apply({}, x)
    with torch.no_grad():
        got = net.decode({k: torch.from_numpy(a) for k, a in heads.items()})
    for k in ("dets", "scores", "gboxes", "centers"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=DECODE_TOL)
    assert float(np.asarray(want["scores"]).max()) >= cfg.score_thresh


def _snap_inputs(seed, k=40, mk=90):
    """Score-sorted cells on a jittered grid and vertices near their
    corners, pointing at the neighbouring centres; scores straddle the
    threshold."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(2, 30, (k, 2)).astype(np.float32)
    off = np.array([-1.5, -1.5, 1.5, -1.5, 1.5, 1.5, -1.5, 1.5], np.float32)
    quads = np.tile(c, 4) + off + rng.normal(0, 0.3, (k, 8))
    sc = np.sort(rng.uniform(0.1, 0.9, k))[::-1]
    bboxes = np.concatenate([quads, sc[:, None]], 1).astype(np.float32)
    src = rng.integers(0, k, mk)
    corner = rng.integers(0, 4, mk)
    v = quads[src].reshape(mk, 4, 2)[np.arange(mk), corner] \
        + rng.normal(0, 0.4, (mk, 2))
    cen = v[:, None, :] + rng.choice([-1.5, 1.5], (mk, 4, 2)) \
        + rng.normal(0, 0.3, (mk, 4, 2))
    cen[:, 0] = c[src] + rng.normal(0, 0.2, (mk, 2))
    gs = np.sort(rng.uniform(0.1, 0.9, mk))[::-1]
    gboxes = np.concatenate([v, cen.reshape(mk, 8), gs[:, None]],
                            1).astype(np.float32)
    return bboxes, gboxes


@pytest.mark.parametrize("seed,k,mk", [(0, 40, 90), (1, 40, 90),
                                        (2, 40, 90), (3, 40, 90),
                                        (4, 150, 300)])
def test_group_bbox_by_gbox_equal(seed, k, mk):
    bboxes, gboxes = _snap_inputs(seed, k, mk)
    want = jproc.group_bbox_by_gbox(bboxes.copy(), gboxes, 0.3, 2.0, 0.5)
    got = tproc.group_bbox_by_gbox(bboxes.copy(), gboxes, 0.3, 2.0, 0.5)
    np.testing.assert_array_equal(got, want)
    assert (want != bboxes).any()


def test_assign_logical_coords_equal():
    rng = np.random.default_rng(5)
    for _ in range(5):
        cells = [{"bbox": list(b)} for b in
                 np.sort(rng.uniform(0, 200, (30, 4)).reshape(30, 2, 2),
                         axis=1).transpose(0, 2, 1).reshape(30, 4)]
        want = copy.deepcopy(cells)
        jproc.assign_logical_coords(want)
        tproc.assign_logical_coords(cells)
        assert cells == want


def test_pre_processor_input_matches_cv2(setup):
    cfg, jcfg, _, _, _ = setup
    pages = _pages()
    pre = tproc.CenterNetPreProcessor(cfg)
    task = OcrTableStructureTask(model="CenterNet", device="cpu",
                                 config=copy.deepcopy(cfg))
    (_s, metas, x), = list(task.sub_batches(pages, REGIONS))
    inp = cfg.resolution[0]
    for n, (pi, (x1, y1, x2, y2)) in enumerate(REGIONS):
        crop = pages[pi][y1:y2, x1:x2]
        want = JPre(jcfg)(crop)
        assert metas[n] == want["meta"]
        coef, _ = pre.plan(y2 - y1, x2 - x1)
        bgr = pre.warp_crops(torch.from_numpy(pages),
                             [(pi, x1, y1, x2, y2)], coef[None])[0]
        h, w = crop.shape[:2]
        s = max(h, w)
        mat = np.array([[inp / s, 0, inp / 2 - inp / s * w / 2],
                        [0, inp / s, inp / 2 - inp / s * h / 2]],
                       np.float32)
        np.testing.assert_array_equal(
            bgr.numpy(), cv2.warpAffine(crop[:, :, ::-1].astype(np.float32),
                                        mat, (inp, inp)))
        np.testing.assert_array_equal(x[n].numpy(), want["image"][0])


@pytest.fixture(scope="module")
def tasks(setup):
    cfg, jcfg, v, _, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        jtask = jts.OcrTableStructureTask(model="CenterNet", config=jcfg)
        jtask.ensure_built()
    ttask = OcrTableStructureTask(model="CenterNet", device="cpu",
                                  config=copy.deepcopy(cfg), variables=v)
    return jtask, ttask


def _same_cells(got, want):
    """Cells equal up to the first near-tie of their scores (the post
    emits them in score order)."""
    assert got["type"] == want["type"] == "center_net"
    ws = [c["score"] for c in want["cells"]]
    ties = [i for i in range(1, len(ws)) if ws[i - 1] - ws[i] < TIE_GAP]
    n = ties[0] - 1 if ties else len(ws)
    if n == len(ws):
        assert len(got["cells"]) == len(want["cells"])
    for g, w in zip(got["cells"][:n], want["cells"][:n]):
        assert g["logic"] == w["logic"]
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0,
                                   atol=BOX_PX)
        np.testing.assert_allclose(g["poly"], w["poly"], rtol=0,
                                   atol=BOX_PX)
    return n


def test_task_matches_jax(tasks):
    jtask, ttask = tasks
    pages = _pages()
    want = jtask.batch_infer_from_pages(pages, REGIONS)
    got = ttask.batch_infer_from_pages(pages, REGIONS)
    compared = 0
    for g, w, (pi, (x1, y1, x2, y2)) in zip(got, want, REGIONS):
        compared += _same_cells(g, w)
        if len(g["cells"]) == len(w["cells"]):
            assert OcrTableToHtmlTask()(g, []) == JTableToHtml()(w, [])
        one = ttask(np.ascontiguousarray(pages[pi][y1:y2, x1:x2]))
        _same_cells(one, w)
    assert compared > 0


@pytest.mark.parametrize("res,hw", [(96, (170, 130)), (96, (130, 170)),
                                    (1024, (170, 130)), (768, (411, 333))])
def test_warp_coordinates_round_once_as_cv2(res, hw):
    """OpenCV takes the source x as one fused multiply-add of its f32
    coefficients and y in two roundings; another rounding puts a sample a
    few 1e-6 px off, some 1e-3 grey levels on a ruled page's edges (the x
    of 170 x 130 at 96^2, the y of 130 x 170)."""
    h, w = hw
    page = np.full((1, h, w, 3), 255, np.uint8)
    page[0, 5::14, 10:-10] = 40
    page[0, 20:-20, 7::11] = (30, 90, 200)
    pre = tproc.CenterNetPreProcessor(CenterNetConfig(resolution=(res, res)))
    coef, _ = pre.plan(h, w)
    got = pre.warp_crops(torch.from_numpy(page), [(0, 0, 0, w, h)],
                         coef[None])[0].numpy()
    s = max(h, w)
    mat = np.array([[res / s, 0, res / 2 - res / s * w / 2],
                    [0, res / s, res / 2 - res / s * h / 2]], np.float32)
    want = cv2.warpAffine(page[0, :, :, ::-1].astype(np.float32), mat,
                          (res, res))
    np.testing.assert_array_equal(got, want)
