"""The port's PicoDet (``picodet_lcnet_x1_0`` at full channel width) against
the JAX package's flax model on the same tree, moved through the weight
bridge, at a 160x128 input (ceil grids 20x16, 10x8, 5x4, 3x2), f32 on the
CPU; then the GFL decode + top-k, the device NMS and the host tails against
the JAX functions on the same arrays.

The tree is seeded, its BatchNorm scales set to 0.2 and its statistics
calibrated on two page-like images (``set_batch_norm_scale``: calibrated at
scale 1 the stack is chaotic and two f32 runs differ by 1e-3), and the
``head_cls`` kernels widened 4x so that scores and box bins spread.

Held: per-level scores and boxes within 1e-5 of flax; the decode within
1e-4 with the same top-k indices on the same head maps; ``device_nms_pack``
equal to JAX's and, per class, to the host ``hard_nms`` (the same survivors
in the same order), on model candidates and on candidates built with tied
scores; the host tails equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.picodet import processor as jproc
from pdf_table_tpu.models.picodet.config import PicoDetConfig as JPicoCfg
from pdf_table_tpu.models.picodet.model import PicoDet as JPicoDet
from pdf_table_tpu.ops import nms as jnms
from pdf_table_tpu_torch.convert.flax_bridge import tree_leaves
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_picodet,
                                               set_batch_norm_scale)
from pdf_table_tpu_torch.models.picodet import processor as tproc
from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
from pdf_table_tpu_torch.models.picodet.model import PicoDet
from pdf_table_tpu_torch.ops import nms as tnms
from test_torch_dtype_policy import assert_bf16_rule

torch.set_num_threads(1)

HEADS_ATOL = 1e-5
DECODE_ATOL = 1e-4
HW = (160, 128)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def page(seed, h, w):
    """Text-like strokes of random gray on white, uint8 RGB."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(8, h - 8, 10):
        x = 6
        while x < w - 20:
            ww = int(rng.integers(6, 30))
            img[y:y + 5, x:x + ww] = rng.integers(0, 160, 3)
            x += ww + int(rng.integers(3, 9))
    return img


def normalize(pages_u8):
    return ((pages_u8.astype(np.float32) / 255.0 - MEAN) / STD) \
        .astype(np.float32)


def picodet_tree(cfg, sample, seed=0):
    """Seeded tree, BatchNorm scales 0.2, statistics calibrated on
    ``sample`` (normalized NHWC), ``head_cls`` kernels x4."""
    v = set_batch_norm_scale(init_picodet(cfg, seed), 0.2)
    v = calibrate_batch_stats(PicoDet(cfg), v, torch.from_numpy(sample))
    for name, mod in v["params"]["head"].items():
        if name.startswith("head_cls"):
            mod["kernel"] = mod["kernel"] * 4.0
    return v


X = normalize(np.stack([page(0, *HW), page(1, *HW)]))


@pytest.fixture(scope="module")
def nets():
    cfg = PicoDetConfig(task_type="en", img_height=HW[0], img_width=HW[1])
    v = picodet_tree(cfg, X)
    model = PicoDet(cfg).eval()
    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    load_flax_variables(model, v)
    with torch.no_grad():
        got = model(torch.from_numpy(X))
    jcfg = JPicoCfg(task_type="en", img_height=HW[0], img_width=HW[1])
    want = JPicoDet(jcfg).apply(jax.tree.map(jnp.asarray, v), jnp.asarray(X))
    want = {k: [np.asarray(a) for a in want[k]] for k in want}
    return cfg, jcfg, v, got, want


def test_tree_matches_flax_init():
    cfg = PicoDetConfig(task_type="table")
    v = init_picodet(cfg, 0)
    jv = jax.eval_shape(lambda: JPicoDet(JPicoCfg(task_type="table")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 800, 608, 3))))
    assert {p: np.shape(a) for p, a in tree_leaves(v)} \
        == {p: tuple(a.shape) for p, a in tree_leaves(jv)}


def test_heads_match_flax(nets):
    cfg, _, _, got, want = nets
    grids = [(-(-HW[0] // s), -(-HW[1] // s)) for s in cfg.strides]
    assert grids == [(20, 16), (10, 8), (5, 4), (3, 2)]
    for key, width in (("scores", cfg.num_classes),
                       ("boxes", 4 * (cfg.reg_max + 1))):
        assert len(got[key]) == len(want[key]) == 4
        for (fh, fw), g, w in zip(grids, got[key], want[key]):
            assert g.shape == w.shape == (2, fh * fw, width)
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, atol=HEADS_ATOL, rtol=0)
    scores = np.concatenate([w.ravel() for w in want["scores"]])
    assert scores.std() > 0.05, "the test tree should spread the scores"


def test_decode_topk_matches_jax(nets):
    cfg, jcfg, _, got, want = nets
    # the same head maps on both sides: the same top-k indices
    wb, ws = jproc._decode_topk({k: [jnp.asarray(a) for a in want[k]]
                                 for k in want}, jcfg)
    raw = {k: [torch.from_numpy(np.array(a)) for a in want[k]] for k in want}
    gb, gs = tproc._decode_topk(raw, cfg)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=DECODE_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the port's own head maps, 1e-5 off flax's: a box edge moves by up
    # to that times the stride
    pb, ps = tproc._decode_topk(got, cfg, k=50)
    np.testing.assert_allclose(pb.numpy(), np.asarray(wb)[:, :50],
                               atol=HEADS_ATOL * 64 * 8, rtol=0)
    packed = tproc.device_decode_topk(raw, cfg, k=7)
    np.testing.assert_allclose(
        packed.numpy(), np.asarray(jproc.device_decode_topk(
            {k: [jnp.asarray(a) for a in want[k]] for k in want}, jcfg, k=7)),
        atol=DECODE_ATOL, rtol=0)


def test_level_centers_and_expected_distance_match_jax():
    for args in ((20, 16, 8), (13, 10, 64)):
        np.testing.assert_array_equal(tproc._level_centers(*args),
                                      jproc._level_centers(*args))
    d = np.random.default_rng(3).standard_normal((12, 32)).astype(np.float32)
    np.testing.assert_array_equal(tproc.gfl_expected_distance(d, 7),
                                  jproc.gfl_expected_distance(d, 7))


def _nms_both(b, s, cfg, jcfg):
    got = tproc.device_nms_pack(torch.from_numpy(b), torch.from_numpy(s),
                                cfg).numpy()
    want = np.asarray(jproc.device_nms_pack(jnp.asarray(b), jnp.asarray(s),
                                            jcfg))
    return got, want


def _assert_matches_hard_nms(packed, b, s, cfg):
    for bi in range(b.shape[0]):
        for ci in range(s.shape[2]):
            kb, ks, _ = tnms.hard_nms(b[bi], s[bi, :, ci],
                                      iou_threshold=cfg.nms_threshold,
                                      score_threshold=cfg.score_threshold,
                                      top_k=cfg.keep_top_k)
            rows = packed[bi, ci]
            rows = rows[rows[:, 4] > 0]
            np.testing.assert_array_equal(rows[:, :4], kb)
            np.testing.assert_array_equal(rows[:, 4], ks)


@pytest.mark.parametrize("keep_top_k", [5, 100])
def test_device_nms_matches_jax_and_hard_nms(nets, keep_top_k):
    cfg, jcfg, _, _, want = nets
    cfg.score_threshold = jcfg.score_threshold = 0.3
    cfg.keep_top_k = jcfg.keep_top_k = keep_top_k
    b, s = (np.asarray(a) for a in jproc._decode_topk(
        {k: [jnp.asarray(a) for a in want[k]] for k in want}, jcfg))
    got, want_p = _nms_both(b, s, cfg, jcfg)
    assert got.shape == (2, cfg.num_classes, keep_top_k, 5)
    np.testing.assert_array_equal(got, want_p)
    assert (got[..., 4] > 0).sum() >= 10, "too few survivors to compare"
    _assert_matches_hard_nms(got, b, s, cfg)


def _tied_candidates(seed):
    """Candidates on a coarse grid, scores drawn from four values (many
    ties, tie order decides which overlapping box survives)."""
    rng = np.random.default_rng(seed)
    n = 120
    xy = rng.integers(0, 8, (1, n, 2)).astype(np.float32) * 6.0
    wh = rng.integers(2, 5, (1, n, 2)).astype(np.float32) * 6.0
    b = np.concatenate([xy, xy + wh], axis=-1)
    s = rng.choice(np.array([0.2, 0.5, 0.7, 0.9], np.float32), (1, n, 2))
    return b, s


@pytest.mark.parametrize("rounds", [1, 4, 1000])
def test_device_nms_with_tied_scores(rounds, monkeypatch):
    """The same survivors whatever the rounds between two fixed-point
    checks."""
    monkeypatch.setattr(tproc, "NMS_ROUNDS_PER_CHECK", rounds)
    cfg = PicoDetConfig(task_type="table", score_threshold=0.3,
                        keep_top_k=30)
    jcfg = JPicoCfg(task_type="table", score_threshold=0.3, keep_top_k=30)
    b, s = _tied_candidates(7)
    got, want = _nms_both(b, s, cfg, jcfg)
    np.testing.assert_array_equal(got, want)
    _assert_matches_hard_nms(got, b, s, cfg)
    sc = s[0, :, 0]
    kept = got[0, 0][got[0, 0, :, 4] > 0]
    assert len(kept) >= 3 and len(np.unique(kept[:, 4])) < len(kept), \
        "the case should keep tied scores"
    assert (np.unique(sc, return_counts=True)[1] > 1).all()


def test_topk_breaks_ties_toward_the_lower_index():
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    v, i = tproc.topk_stable(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_fixed_point_stops_at_the_round_cap():
    """A suppression chain of length k needs k rounds; the loop stops at
    k (the JAX ``it < k``) with the greedy answer (4 rounds between two
    checks, the default)."""
    k = 6
    alive = torch.ones(1, 1, k, dtype=torch.bool)
    dom = torch.zeros(1, 1, k, k, dtype=torch.bool)
    for j in range(k - 1):
        dom[0, 0, j, j + 1] = True
    keep, rounds = tproc.nms_fixed_point(alive, dom)
    assert keep[0, 0].tolist() == [True, False, True, False, True, False]
    assert rounds <= k


def test_iou_matrix_matches_jax():
    b = _tied_candidates(1)[0][0]
    b[3] = b[3, [2, 3, 0, 1]]         # an inverted, zero-area box
    np.testing.assert_allclose(
        tnms._iou_matrix(torch.from_numpy(b)).numpy(),
        np.asarray(jnms._iou_matrix(jnp.asarray(b))), atol=1e-7, rtol=0)


def test_host_tails_match_jax(nets):
    cfg, jcfg, _, _, want = nets
    cfg.score_threshold = jcfg.score_threshold = 0.3
    cfg.keep_top_k = jcfg.keep_top_k = 100
    b, s = (np.asarray(a) for a in jproc._decode_topk(
        {k: [jnp.asarray(a) for a in want[k]] for k in want}, jcfg))
    packed = np.asarray(jproc.device_nms_pack(jnp.asarray(b), jnp.asarray(s),
                                              jcfg))
    tpost, jpost = tproc.PicoDetPostProcessor(cfg), \
        jproc.PicoDetPostProcessor(jcfg)
    org = (1224, 950)
    for i in range(2):
        for got, want_r in (
                (tpost.from_device_nms(packed[i], org),
                 jpost.from_device_nms(packed[i], org)),
                (tpost.from_candidates(b[i], s[i], org),
                 jpost.from_candidates(b[i], s[i], org))):
            assert got == want_r
            assert got["bboxs"], "no layout boxes to compare"
            cells = tpost.to_layout_cells(got)
            jcells = jpost.to_layout_cells(want_r)
            assert [(c.bbox, c.text, c.label, c.score, c.cell_type.name)
                    for c in cells] == \
                [(c.bbox, c.text, c.label, c.score, c.cell_type.name)
                 for c in jcells]


def test_bf16_raises_naming_the_roadmap_item():
    """PicoDet builds in bf16 (against JAX: tests/test_torch_bf16_tsr.py)
    with flax's weight rule; scores and box bins come out f32."""
    net = PicoDet(PicoDetConfig(dtype="bfloat16")).eval()
    assert_bf16_rule(net)
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3))
    with torch.no_grad():
        out = net(torch.from_numpy(x.astype(np.float32)))
    for t in out["scores"] + out["boxes"]:
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
