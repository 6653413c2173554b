"""The port's wtw LORE model (wiz_rev: corner-channel decode and vertex
refine) against the JAX package on one flax-initialized tree moved through
the weight bridge, at a tiny config on the CPU: detect_decode,
gather_logical, the packed wiz_rev forward, and the bf16 detector
heads."""

import copy

import jax
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.lore import LoreModel as JLoreModel
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (init_lore,
                                               perturb_conv_offset_mask)
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.corner_refine import (
    refine_sort, refine_vertices_by_corners)
from pdf_table_tpu_torch.models.lore.model import LoreModel

torch.set_num_threads(1)

# the corner threshold sits at the random corner heatmap's level so that
# corners pair with cells
TINY_WTW = dict(resolution=(64, 64), max_objs=8, max_corners=16,
                hidden_size=32, head_conv=16, tsfm_layers=1,
                stacking_layers=1, num_heads=4, max_fmp_size=64, d_ff=64,
                vis_thresh=0.1, vis_thresh_corner=0.1)
# f32 on both sides; only summation order differs. Relative to the largest
# magnitude of each output.
REL_TOL = 1e-5
# the bf16 detector against the JAX bf16 detector (test_torch_lore.py):
# activations round to bf16 after every layer, in another order
BF16_REL_TOL = 4e-2


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale < tol


def _shaped(v):
    """Cells with 1.5 feature-map px corners and corner group boxes of
    +-0.75 px, so cell quads hold corner boxes and vertices snap; the cell
    heatmap near 0.5, so a cell the refine penalizes (x 0.4) stays valid."""
    v = copy.deepcopy(v)
    heads = v["params"]["detector"]["heads"]
    heads["hm_out"]["bias"] = np.array([0.0, -2.19], np.float32)
    heads["wh_out"]["bias"] = np.array(
        [1.5, 1.5, -1.5, 1.5, -1.5, -1.5, 1.5, -1.5], np.float32)
    heads["st_out"]["bias"] = np.array(
        [0.75, 0.75, -0.75, 0.75, -0.75, -0.75, 0.75, -0.75], np.float32)
    return v


@pytest.fixture(scope="module")
def models():
    jm = JLoreModel(JLoreConfig.wtw(**TINY_WTW))
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    v = _shaped(perturb_conv_offset_mask(jax.tree.map(np.asarray, v),
                                         seed=1))
    tm = LoreModel(LoreConfig.wtw(**TINY_WTW)).eval()
    load_flax_variables(tm, v)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)) \
        .astype(np.float32)
    return jm, v, tm, x


def test_init_lore_wtw_is_the_flax_tree(models):
    """wtw needs nothing new from the seeded init or the bridge: the same
    paths and shapes as the JAX init, and every leaf loads."""
    _, v, _, _ = models
    cfg = LoreConfig.wtw(**TINY_WTW)
    got = init_lore(cfg, seed=0)
    assert {p: a.shape for p, a in tree_leaves(got)} == \
        {p: a.shape for p, a in tree_leaves(v)}
    load_flax_variables(LoreModel(cfg), got)


def test_detect_decode_matches(models):
    jm, v, tm, x = models
    want = jm.apply(v, x, method=JLoreModel.detect_decode)
    with torch.no_grad():
        got = tm.detect_decode(torch.from_numpy(x))
    assert set(got) == set(want)
    k = TINY_WTW["max_objs"]
    dc, wdc = got["dc_packed"].numpy(), np.asarray(want["dc_packed"])
    assert dc.shape == (2, k + TINY_WTW["max_corners"], 11)
    # slot order and indices exactly, values to f32 summation order
    np.testing.assert_array_equal(dc[:, :k, 9], wdc[:, :k, 9])
    np.testing.assert_array_equal(dc[:, :k, 10], 0)
    for sl in (slice(0, k), slice(k, None)):
        _close(dc[:, sl], wdc[:, sl])
    for name in ("ax_flat", "cr_map"):
        _close(got[name].numpy(), want[name])


def test_gather_logical_matches(models):
    """On the same (JAX) maps and refined slots; the centers slot is 0."""
    jm, v, tm, _ = models
    rng = np.random.default_rng(3)
    B, K, H, W, D = 2, TINY_WTW["max_objs"], 16, 16, 32
    ax = rng.standard_normal((B, H * W, D)).astype(np.float32)
    cr = rng.standard_normal((B, H, W, D)).astype(np.float32)
    dets = rng.uniform(-1, 17, (B, K, 8)).astype(np.float32)
    inds = rng.integers(0, H * W, (B, K)).astype(np.int32)
    scores = rng.uniform(0, 0.3, (B, K)).astype(np.float32)
    want = jm.apply(v, ax, cr, dets, inds, scores,
                    method=JLoreModel.gather_logical)
    with torch.no_grad():
        got = tm.gather_logical(
            torch.from_numpy(ax), torch.from_numpy(cr),
            torch.from_numpy(dets), torch.from_numpy(inds).long(),
            torch.from_numpy(scores)).numpy()
    assert got.shape == (B, K, 20)
    np.testing.assert_array_equal(got[..., 10:12], 0)
    np.testing.assert_array_equal(got[..., :10], np.asarray(want)[..., :10])
    _close(got, want)


def test_features_match_and_snap(models):
    """The wiz_rev forward (detect-decode, refine, re-sort, gathers,
    regressor) against the JAX model's fused wiz_rev forward (features with
    its in-program refine, then the regressor), and the refine moved
    vertices here. The port packs zeros in the centers slot."""
    jm, v, tm, x = models
    want = jm.apply(v, x)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = tm.forward_packed(xt).numpy()
        dd = tm.detect_decode(xt)
    valid = np.asarray(want["valid"])
    assert valid.any()
    np.testing.assert_array_equal(got[..., 9] > 0.5, valid)
    np.testing.assert_array_equal(got[..., 10:12], 0)
    for sl, name in ((slice(0, 8), "dets"), (8, "scores"),
                     (slice(12, 16), "logi"),
                     (slice(16, 20), "stacked_logi")):
        _close(got[..., sl], want[name])
    # the packed chain's slots are refine_sort's
    k = TINY_WTW["max_objs"]
    cfg = tm.config
    dc = dd["dc_packed"]
    dets, _inds, scores = refine_sort(dc, k, cfg.vis_thresh,
                                      cfg.vis_thresh_corner)
    np.testing.assert_array_equal(got[..., :8], dets.numpy())
    np.testing.assert_array_equal(got[..., 8], scores.numpy())
    refined, _ = refine_vertices_by_corners(
        dc[:, :k, :8], dc[:, :k, 8], dc[:, k:, :8], dc[:, k:, 8:10],
        dc[:, k:, 10], cfg.vis_thresh, cfg.vis_thresh_corner)
    assert (refined != dc[:, :k, :8]).any(), "no vertex snapped"


def test_features_refuse_wiz_rev(models):
    """Under wiz_rev the refine sits between detect_decode and
    gather_logical; features, which has no refine, refuses."""
    _, _, tm, x = models
    with pytest.raises(ValueError, match="forward_packed"):
        tm.features(torch.from_numpy(x))


def test_bf16_heads_match(models):
    jm, v, _, x = models
    cfg = dict(TINY_WTW, dtype="bfloat16")
    tm = LoreModel(LoreConfig.wtw(**cfg)).eval()
    load_flax_variables(tm, v)
    want = JLoreModel(JLoreConfig.wtw(**cfg)).apply(
        v, x, method=lambda m, x: m.detector(x, train=False))
    with torch.no_grad():
        got = tm.heads(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), want[k], BF16_REL_TOL)
