"""The port's DocXLayout (pdf_table_tpu_torch/models/docx_layout and the
DocXLayout branch of tasks/layout.py) against the JAX package on one seeded
tree moved through the weight bridge, on the CPU, at the tiny config of
tests/test_docx_centernet.py (64^2, head_conv 16) and at full channel
width (head_conv 256) at 96^2: heads within 1e-5 relative of flax; the
device warp within 1e-4 grey levels of ``cv2.warpAffine`` (the border
rows and columns included) and the normalized input within that of the
JAX pre-processor's; the decode within 1e-4 on the same head maps;
``pnms`` equal; the task's cells per canvas equal to the JAX task's
(``batch_enqueue_pages`` + ``batch_finish``, its per-page cv2 path):
labels equal, boxes within 1e-3 px, scores within 1e-5, up to the first
gap under 1e-5 between the JAX scores.

The tree: ``init_docx_layout``, offset convs perturbed, BatchNorm
statistics calibrated on the task's own inputs with the variances doubled
(a random DLA stack is chaotic at scale 1, two f32 runs then differ by
1e-3), the ``hm`` and ``hm_sub`` biases at 0 and the ``wh`` bias a
+-3 px quad, so that detections pass 0.3 and overlap."""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.layout as jlayout
from pdf_table_tpu.models.docx_layout import DocXLayoutConfig as JConfig
from pdf_table_tpu.models.docx_layout import DocXLayoutModel as JNet
from pdf_table_tpu.models.docx_layout import DocXLayoutPreProcessor as JPre
from pdf_table_tpu.models.docx_layout import processor as jproc
from pdf_table_tpu.ops.centernet import decode_boxes_4ps as jdecode
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_docx_layout,
                                               perturb_conv_offset_mask,
                                               scale_batch_variances)
from pdf_table_tpu_torch.models.center_net.processor import \
    CenterNetPreProcessor
from pdf_table_tpu_torch.models.docx_layout import processor as tproc
from pdf_table_tpu_torch.models.docx_layout.config import DocXLayoutConfig
from pdf_table_tpu_torch.models.docx_layout.model import (DocXLayoutModel,
                                                          sub_top_k)
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask

torch.set_num_threads(1)

CONFIGS = {"tiny": dict(resolution=(64, 64), head_conv=16),
           "full_width": dict(resolution=(96, 96))}
REL_TOL = 1e-5
DECODE_TOL = 1e-4
TIE_GAP = 1e-5
BOX_PX = 1e-3
SCORE_TOL = 1e-5
VAR_GAIN = 2.0
QUAD = 3.0       # feature-map px, the wh bias


def pages():
    """Two canvases, taller than wide (the warp's border columns), ruled
    like text blocks and a table."""
    out = np.full((2, 170, 130, 3), 255, np.uint8)
    for y in range(12, 170, 14):
        out[:, y:y + 3, 10:120] = 40
    out[0, 60:120, 15:110:20] = 30
    out[1, 30:90, 20:100] = (200, 60, 90)
    out[1, 100:160:6, 30:90] = (10, 120, 30)
    return out


def docx_tree(cfg, x):
    net = DocXLayoutModel(cfg).eval()
    net.forward = net.heads
    v = perturb_conv_offset_mask(init_docx_layout(cfg, seed=0), seed=1)
    v = scale_batch_variances(calibrate_batch_stats(net, v, x), VAR_GAIN)
    heads = v["params"]["dla"]["heads"]
    heads["hm_out"]["bias"] = np.zeros(11, np.float32)
    heads["hm_sub_out"]["bias"] = np.zeros(2, np.float32)
    heads["wh_out"]["bias"] = QUAD * np.array(
        [1, 1, -1, 1, -1, -1, 1, -1], np.float32)
    return v


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    kw = CONFIGS[request.param]
    cfg = DocXLayoutConfig(**kw)
    task = OcrLayoutTask(model="DocXLayout", device="cpu",
                         config=copy.deepcopy(cfg))
    with torch.no_grad():
        x = task.preprocess(torch.from_numpy(pages()))
    v = docx_tree(cfg, x)
    net = DocXLayoutModel(cfg).eval()
    load_flax_variables(net, v)
    return cfg, JConfig(**kw), v, net, x.numpy()


def test_init_docx_layout_has_the_flax_tree(setup):
    cfg, jcfg, v, _, x = setup
    want = jax.eval_shape(JNet(jcfg).init, jax.random.PRNGKey(0), x[:1])
    assert {p: tuple(a.shape) for p, a in tree_leaves(v)} == \
        {p: tuple(a.shape) for p, a in tree_leaves(want)}


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale < tol


def test_heads_match_flax(setup):
    cfg, jcfg, v, net, x = setup
    want = JNet(jcfg).apply(v, x)
    with torch.no_grad():
        got = net.heads(torch.from_numpy(x))
    assert set(got) == set(want) == {"cls", "ftype", "hm", "hm_sub", "reg",
                                     "wh"}
    for k in got:
        _close(got[k].numpy(), want[k])


def test_decode_matches_on_the_same_heads(setup):
    cfg, jcfg, v, net, x = setup
    heads = {k: np.array(a) for k, a in JNet(jcfg).apply(v, x).items()}
    with torch.no_grad():
        got = net.decode({k: torch.from_numpy(a)
                          for k, a in heads.items()}).numpy()
    k = cfg.top_k
    for hm, sl, top in (("hm", slice(0, k), k),
                        ("hm_sub", slice(k, None), sub_top_k(cfg))):
        dets, scores, clses, _, _ = jdecode(
            jax.nn.sigmoid(jnp.asarray(heads[hm])), heads["wh"],
            heads["reg"], top)
        np.testing.assert_allclose(got[:, sl, :8], np.asarray(dets),
                                   rtol=0, atol=DECODE_TOL)
        np.testing.assert_allclose(got[:, sl, 8], np.asarray(scores),
                                   rtol=0, atol=DECODE_TOL)
        np.testing.assert_array_equal(got[:, sl, 9], np.asarray(clses))
    assert float(got[:, :k, 8].max()) >= cfg.scores_thresh


def test_warp_matches_cv2(setup):
    cfg, jcfg, _, _, x = setup
    pre = CenterNetPreProcessor(cfg)
    inp = cfg.resolution[0]
    for i, page in enumerate(pages()):
        h, w = page.shape[:2]
        coef, meta = pre.plan(h, w)
        want = JPre(jcfg)(page)
        assert {k: meta[k] for k in ("c", "s", "org_shape", "out_w")} == \
            {k: want["meta"][k] for k in ("c", "s", "org_shape", "out_w")}
        bgr = pre.warp_crops(torch.from_numpy(pages()), [(i, 0, 0, w, h)],
                             coef[None])[0].numpy()
        s = max(h, w)
        mat = np.array([[inp / s, 0, inp / 2 - inp / s * w / 2],
                        [0, inp / s, inp / 2 - inp / s * h / 2]],
                       np.float32)
        ref = cv2.warpAffine(page[:, :, ::-1].astype(np.float32), mat,
                             (inp, inp))
        np.testing.assert_array_equal(bgr, ref)
        # the border: columns left and right of the page read 0, and the
        # partly covered ones blend with 0
        assert (ref[:, 0] == 0).all() and (bgr[:, 0] == 0).all()
        np.testing.assert_array_equal(x[i], want["image"][0])


def _dets(seed, n=60, ties=True):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 100, (n, 2))
    half = rng.uniform(2, 15, (n, 2))
    quad = np.concatenate([c - half, c + [1, -1] * half, c + half,
                           c + [-1, 1] * half], axis=1)
    scores = rng.uniform(0.3, 1.0, n)
    if ties:
        scores[::7] = scores[1]
    return np.concatenate([quad, scores[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_pnms_equal(seed):
    """The port's loop takes each kept row's suppressions from the pairwise
    IoU matrix at once; keep lists and IoUs equal to JAX's, tied scores
    and identical boxes included."""
    dets = _dets(seed)
    dets[5:12, :8] = dets[4, :8]
    keep = tproc.pnms(dets)
    assert keep == jproc.pnms(dets)
    assert 0 < len(keep) < len(dets)
    for t in (0.1, 0.5):
        assert tproc.pnms(dets, t) == jproc.pnms(dets, t)
    iou = tproc.pairwise_poly_iou(dets[:, :8])
    assert iou.dtype == np.float32
    for i in range(len(dets)):
        for j in range(0, len(dets), 3):
            assert iou[i, j] == jproc.poly_iou(dets[i, :8], dets[j, :8])


@pytest.fixture(scope="module")
def tasks(setup):
    cfg, jcfg, v, _, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayout, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        jtask = jlayout.OcrLayoutTask(model="DocXLayout", config=jcfg)
        jtask.ensure_built()
    ttask = OcrLayoutTask(model="DocXLayout", device="cpu",
                          config=copy.deepcopy(cfg), variables=v)
    return jtask, ttask


def same_cells(got, want) -> int:
    """Layout cells equal up to the first near-tie of the JAX scores (the
    post emits them in score order); returns how many were compared."""
    ws = [c.score for c in want]
    ties = [i for i in range(1, len(ws)) if ws[i - 1] - ws[i] < TIE_GAP]
    n = ties[0] - 1 if ties else len(ws)
    if n == len(ws):
        assert len(got) == len(want)
    for g, w in zip(got[:n], want[:n]):
        assert (g.label, g.text, g.cell_type.name) == \
            (w.label, w.text, w.cell_type.name)
        np.testing.assert_allclose(g.bbox, w.bbox, rtol=0, atol=BOX_PX)
        assert abs(g.score - w.score) <= SCORE_TOL
    return n


def test_task_matches_jax(tasks):
    jtask, ttask = tasks
    canv = pages()
    want = jtask.batch_finish(*jtask.batch_enqueue_pages(jnp.asarray(canv)))
    got = ttask.batch_infer_from_pages(canv)
    compared = 0
    for g, w in zip(got, want):
        compared += same_cells(g, w)
    assert compared > 0
    labels = {c.label for p in got for c in p}
    assert len(labels) > 2, labels
    one = ttask(canv[1])
    jone = jtask(canv[1])
    same_cells(one["layout_cells"], jone["layout_cells"])
    ss = [d["score"] for d in jone["subfield_dets"]]
    ties = [i for i in range(1, len(ss)) if ss[i - 1] - ss[i] < TIE_GAP]
    n = ties[0] - 1 if ties else len(ss)
    assert len(ss) > 0
    for a, b in zip(one["subfield_dets"][:n], jone["subfield_dets"][:n]):
        assert a["label"] == b["label"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0,
                                   atol=BOX_PX)


def test_both_names_and_the_chunk_size(setup):
    cfg, _, v, _, _ = setup
    """Ten canvases run as forwards of 8 and 2; each page's cells equal
    those of the page alone."""
    canv = np.concatenate([pages()] * 5)
    a = OcrLayoutTask(model="docx_layout", device="cpu",
                      config=copy.deepcopy(cfg), variables=v)
    b = OcrLayoutTask(model="DocXLayout", device="cpu",
                      config=copy.deepcopy(cfg), variables=v)
    assert a.model_name == b.model_name == "DocXLayout"
    assert not a.device_nms
    seen = []
    real = a.model.heads
    a.model.heads = lambda x: (seen.append(x.shape[0]), real(x))[1]
    handle, metas = a.enqueue(torch.from_numpy(canv))
    assert seen == [8, 2]
    assert tuple(handle.shape) == (10, cfg.top_k + sub_top_k(cfg), 10)
    assert metas[0]["org_shape"] == canv.shape[1:3]
    got = a.finish(handle, metas)
    for i in (0, 9):
        same_cells(got[i], b.batch_infer_from_pages(canv[i:i + 1])[0])
